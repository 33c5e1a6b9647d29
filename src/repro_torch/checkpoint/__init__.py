from .bridge import params_from_jax
from .store import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "params_from_jax", "restore_checkpoint",
           "save_checkpoint"]
