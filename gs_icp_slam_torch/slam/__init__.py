from .engine import SLAMEngine, SLAMResult

__all__ = ["SLAMEngine", "SLAMResult"]
