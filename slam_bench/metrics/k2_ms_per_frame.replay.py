"""Device time a frame of kernel K2, G-ICP's 1-NN (csrc/nn1.cu), in the
traced episode; kernels matched by the names below."""
from slam_bench.trace import kernel_ms_per_frame

UNIT = "ms/frame"
MOVES = "fps"
NAMES = ("nn1_search",)


def read(rec):
    return kernel_ms_per_frame(rec, NAMES)
