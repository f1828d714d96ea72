"""Training runtime of the port: optimizer, train loop, checkpoints."""

from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_init, adamw_update

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update"]
