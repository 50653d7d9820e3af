from .checkpoint import (load_checkpoint, load_fused_state, save_checkpoint,
                         save_fused_state)
from .ply import load_ply, save_ply

__all__ = ["save_ply", "load_ply", "save_checkpoint", "load_checkpoint",
           "save_fused_state", "load_fused_state"]
