from .ate import align_horn, ate_rmse
from .image_metrics import SequenceMetrics, evaluate_sequence
from .lpips import lpips, lpips_available

__all__ = ["SequenceMetrics", "align_horn", "ate_rmse", "evaluate_sequence",
           "lpips", "lpips_available"]
