from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    opt_state_axes, warmup_cosine)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "warmup_cosine", "opt_state_axes"]
