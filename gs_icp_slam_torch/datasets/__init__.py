from .base import InMemorySequence, RGBDFrame, RGBDSequence
from .synthetic import SyntheticScene, synthetic_sequence


def open_dataset(dataset_type: str, path: str = "", **kw) -> RGBDSequence:
    """Dataset factory; this slice carries the synthetic sequence (Replica,
    TUM and scene loaders come with the I/O slice)."""
    if dataset_type == "synthetic":
        return synthetic_sequence(**kw)
    raise ValueError(f"Unknown or not yet ported dataset type: {dataset_type!r}")


__all__ = ["InMemorySequence", "RGBDFrame", "RGBDSequence", "SyntheticScene",
           "synthetic_sequence", "open_dataset"]
