"""Device-busy time a frame of the traced live episode: the union of
device-activity intervals over the frames."""
from slam_bench.trace import busy_s

UNIT = "ms/frame"
MOVES = "pose_ms_p95"


def read(rec):
    if rec.trace is None or not rec.trace_frames or not rec.trace.n_dev:
        return None
    return busy_s(rec.trace) * 1e3 / rec.trace_frames
