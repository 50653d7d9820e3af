"""The mapping opt step's CUDA graphs and the map's capacities in a
benchmark cell (slam/fused.py OptGraph, FusedEngine._pick_buckets): per
episode, the fused step's counters (graphs captured, replays, opt steps
run eagerly, rows the map's insert and the target's export dropped for
want of capacity), Adam's steps, the map slots used and the rows of the
last target, the episode's seconds and the peak device memory, allocated
and reserved (a graph's private pool is reserved memory); and by opt-step
bucket ("by_bucket", filed at each bucket pick; "full" is the whole map)
the graphs captured and the peak memory while the engine ran in it:

    python scripts/torch_opt_graph_counters.py \\
        --workload replica-room.replay --seed 7 --episodes 2

The cell is set up as `python -m slam_bench.run` sets it up; the first
line is its warm-up episode (set-up in a benchmark run, where each
bucket's graph is captured), then one line per closed-loop episode.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def watch_buckets(engine, dev, by_bucket: dict):
    """Wrap engine._pick_buckets so that each pick files, under the
    opt-step bucket that ran since the last one, the graphs captured and
    the peak memory in between; returns the filing function, for the end
    of the episode (`del engine._pick_buckets` unwraps)."""
    import torch

    pick = engine._pick_buckets
    counters = engine.fused.counters
    running = [None, counters["captures"]]

    def file():
        if running[0] is None:
            return
        key = "full" if running[0][0] is None else running[0][0]
        p = by_bucket.setdefault(key, {"captures": 0, "peak_allocated": 0,
                                       "peak_reserved": 0})
        p["captures"] += counters["captures"] - running[1]
        p["peak_allocated"] = max(p["peak_allocated"],
                                  torch.cuda.max_memory_allocated(dev))
        p["peak_reserved"] = max(p["peak_reserved"],
                                 torch.cuda.max_memory_reserved(dev))
        running[1] = counters["captures"]
        torch.cuda.reset_peak_memory_stats(dev)

    def picked(n_now):
        file()
        running[0] = pick(n_now)
        return running[0]

    engine._pick_buckets = picked
    return file


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--episodes", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from slam_bench import run as sb

    if not torch.cuda.is_available():
        print("no CUDA device: the opt step is graphed only on a card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    spec = sb.cell_spec(sb.load_json("BENCHMARK.json"), args.workload)
    b = sb.setup(spec, args.seed, dev)
    counters = b.engine.fused.counters
    print(json.dumps({"card": sb.card_line(), "workload": args.workload,
                      "seed": args.seed}), flush=True)
    for i in range(args.episodes + 1):
        before = dict(counters)
        by_bucket: dict = {}
        file = watch_buckets(b.engine, dev, by_bucket)
        torch.cuda.reset_peak_memory_stats(dev)
        e = sb.run_episode(b)
        file()
        del b.engine._pick_buckets
        tgt = b.engine.state.target
        print(json.dumps({
            "episode": "warm-up" if i == 0 else i, "frames": e["frames"],
            "seconds": e["seconds"], "opt_steps": e["opt_steps"],
            "keyframes": e["keyframes"], "gaussians": e["gaussians"],
            "map_slots_used": e["map_slots_used"],
            "map_capacity": e["map_capacity"],
            "target_rows": int(tgt.valid.sum()),
            "target_capacity": int(tgt.valid.shape[0]),
            **{k: v - before[k] for k, v in counters.items()},
            "memory_peak_allocated": max(
                p["peak_allocated"] for p in by_bucket.values()),
            "memory_peak_reserved": max(
                p["peak_reserved"] for p in by_bucket.values()),
            "by_bucket": by_bucket}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
