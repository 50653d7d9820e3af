from .ate import align_horn, ate_rmse

__all__ = ["align_horn", "ate_rmse"]
