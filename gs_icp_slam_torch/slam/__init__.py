from .engine import SLAMEngine, SLAMResult
from .fused import MappingPrimitives, make_mapping_primitives

__all__ = ["MappingPrimitives", "SLAMEngine", "SLAMResult",
           "make_mapping_primitives"]
