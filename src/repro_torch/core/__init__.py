"""Core platform: copy-mode config, refcounted block pool, particle store."""

from repro_torch.core.config import ALL_MODES, CopyMode
