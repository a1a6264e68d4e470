"""repro_torch.optimizer — AdamW over the port's params trees."""
from .adamw import AdamWConfig, OptState, adamw_init, adamw_update, clip_by_global_norm, lr_schedule

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "lr_schedule"]
