"""Population methods on the COW store: resampling, the population
executor, and particle filters."""

from repro_torch.smc import resampling
from repro_torch.smc.filters import FilterConfig, FilterResult, ParticleFilter, SSMDef
