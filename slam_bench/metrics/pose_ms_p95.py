"""The 95th percentile, over every frame of the window, of the time from
when a live sensor's frame was due until its pose was computed (the
device synchronised in run()'s per-frame hook)."""
import numpy as np

UNIT = "ms"
MOVES = None


def read(rec):
    lat = [x for e in rec.episodes for x in (e.get("latency_ms") or [])]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 95))
