from .engine import SLAMEngine, SLAMResult
from .fused import (FusedEngine, FusedStep, MappingPrimitives, RecordedDraws,
                    TorchDraws, make_fused_step, make_mapping_primitives)
from .state import SLAMState, copy_state, init_state

__all__ = ["FusedEngine", "FusedStep", "MappingPrimitives", "RecordedDraws",
           "SLAMEngine", "SLAMResult", "SLAMState", "TorchDraws",
           "copy_state", "init_state", "make_fused_step", "make_mapping_primitives"]
