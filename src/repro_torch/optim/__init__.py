from .optimizers import (OptState, adamw, apply_updates, clip_by_global_norm,
                         cosine_schedule, linear_warmup_cosine, sgd, zero1)

__all__ = ["OptState", "adamw", "apply_updates", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup_cosine", "sgd", "zero1"]
