from .base import InMemorySequence, RGBDFrame, RGBDSequence
from .replica import ReplicaSequence
from .scene import SceneInfo, load_scene
from .synthetic import SyntheticScene, synthetic_sequence
from .tum import TumSequence


def open_dataset(dataset_type: str, path: str = "", **kw) -> RGBDSequence:
    """Factory mirroring the reference's dataset_type switch
    (gs_icp_slam.py:135,143 via camera_parameters[8])."""
    if dataset_type == "replica":
        return ReplicaSequence(path, **kw)
    if dataset_type == "tum":
        return TumSequence(path, **kw)
    if dataset_type == "synthetic":
        return synthetic_sequence(**kw)
    raise ValueError(f"Unknown dataset type: {dataset_type!r}")


__all__ = ["InMemorySequence", "RGBDFrame", "RGBDSequence",
           "ReplicaSequence", "SceneInfo", "SyntheticScene", "TumSequence",
           "load_scene", "open_dataset", "synthetic_sequence"]
