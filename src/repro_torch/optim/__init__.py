from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    warmup_cosine)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "warmup_cosine"]
