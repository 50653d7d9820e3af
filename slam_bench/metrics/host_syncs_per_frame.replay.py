"""Host synchronisations a frame over whole run() calls
(slam_bench.trace.syncs_per_frame)."""
from slam_bench.trace import syncs_per_frame as read  # noqa: F401

UNIT = "syncs/frame"
MOVES = "fps"
