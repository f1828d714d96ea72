"""Population methods on the COW store: resampling, the population
executor, particle filters, particle Gibbs, and the paper's five
programs (:mod:`repro_torch.smc.programs`)."""

from repro_torch.smc import programs, resampling
from repro_torch.smc.filters import FilterConfig, FilterResult, ParticleFilter, SSMDef
from repro_torch.smc.pgibbs import ParticleGibbs, PGResult
