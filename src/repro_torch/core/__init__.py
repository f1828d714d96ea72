"""Core platform: copy-mode config, the object-graph runtime, refcounted
block pool, particle store."""

from repro_torch.core.config import ALL_MODES, CopyMode
from repro_torch.core.graph import Runtime
