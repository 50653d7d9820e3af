"""Dataset interface: a sequence of posed RGB-D frames (counterpart of
gs_icp_slam_tpu/datasets/base.py, numpy only).

Replaces the reference's split responsibility between TrajManager (poses,
utils/traj_utils.py:7) and Tracker.get_images (pixel data preloaded to RAM,
mp_Tracker.py:337-359) with one object.  Frames are numpy on the host; the
engine moves them to device per frame (the only host->device transfer in
the hot loop).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from ..utils.camera import Intrinsics


@dataclass(frozen=True)
class RGBDFrame:
    rgb: np.ndarray    # (H, W, 3) uint8
    depth: np.ndarray  # (H, W) raw depth units (divide by intr.depth_scale)
    gt_c2w: Optional[np.ndarray]  # (4, 4) float64 ground-truth pose or None


class RGBDSequence:
    """Base class; subclasses fill `intr` and implement __len__/frame()."""

    intr: Intrinsics

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def frame(self, i: int) -> RGBDFrame:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, i: int) -> RGBDFrame:
        if i < 0 or i >= len(self):
            raise IndexError(i)
        return self.frame(i)

    def __iter__(self) -> Iterator[RGBDFrame]:
        for i in range(len(self)):
            yield self.frame(i)

    @property
    def gt_poses(self) -> np.ndarray:
        """(N, 4, 4) ground-truth c2w poses (for ATE eval)."""
        return np.stack([self.frame(i).gt_c2w for i in range(len(self))])

    def slice(self, start: int, stop: int) -> "RGBDSequence":
        """A view of frames [start, stop) — e.g. the first-200-frames
        parity run (tests/test_replica_parity.py)."""
        return _SlicedSequence(self, start, min(stop, len(self)))


class _SlicedSequence(RGBDSequence):
    def __init__(self, parent: RGBDSequence, start: int, stop: int):
        self._parent = parent
        self._start = start
        self._stop = stop
        self.intr = parent.intr

    def __len__(self) -> int:
        return self._stop - self._start

    def frame(self, i: int) -> RGBDFrame:
        return self._parent.frame(self._start + i)


class InMemorySequence(RGBDSequence):
    """Every frame of another sequence, made once and kept in host memory
    (for timing runs: the procedural frames are costly to synthesize)."""

    def __init__(self, parent: RGBDSequence):
        self.intr = parent.intr
        self._frames = [parent[i] for i in range(len(parent))]

    def __len__(self) -> int:
        return len(self._frames)

    def frame(self, i: int) -> RGBDFrame:
        return self._frames[i]
