"""Share of the traced episode's wall time in which no operation ran on
the device: 100 x (1 - union of device-activity intervals / window)."""
from slam_bench.trace import busy_s

UNIT = "%"
MOVES = "fps"


def read(rec):
    if rec.trace is None or not rec.trace.n_dev:
        return None
    return 100.0 * (1.0 - busy_s(rec.trace) / rec.trace.window_s)
