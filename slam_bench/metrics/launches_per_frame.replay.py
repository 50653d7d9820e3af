"""Device operations (kernels, memcpys, memsets) a frame in the traced
episode, from the profiler's device activity."""
UNIT = "ops/frame"
MOVES = "fps"


def read(rec):
    if rec.trace is None or not rec.trace_frames or not rec.trace.n_dev:
        return None
    return rec.trace.n_dev / rec.trace_frames
