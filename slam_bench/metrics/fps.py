"""Frames per second of a closed-loop replay: every frame of every whole
episode of the window over the wall time of those episodes, the clock
read after a device synchronisation."""
UNIT = "frames/s"
MOVES = None


def read(rec):
    eps = [e for e in rec.episodes if e["seconds"] > 0]
    if not eps:
        return None
    return sum(e["frames"] for e in eps) / sum(e["seconds"] for e in eps)
