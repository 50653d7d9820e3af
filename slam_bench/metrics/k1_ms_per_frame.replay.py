"""Device time a frame of kernel K1, the compositor forward and backward
(csrc/composite_fwd.cu, csrc/composite_bwd.cu), in the traced episode;
kernels matched by the names below."""
from slam_bench.trace import kernel_ms_per_frame

UNIT = "ms/frame"
MOVES = "fps"
NAMES = ("composite_fwd_kernel", "composite_bwd_walk",
         "composite_bwd_gather")


def read(rec):
    return kernel_ms_per_frame(rec, NAMES)
