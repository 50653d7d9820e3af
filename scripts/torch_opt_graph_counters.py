"""The mapping opt step's CUDA graphs in a benchmark cell (slam/fused.py
OptGraph): per episode, the fused step's counters (graphs captured,
replays, opt steps run eagerly), Adam's steps, the episode's seconds and
the peak device memory, allocated and reserved (a graph's private pool
is reserved memory):

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
        torch.cuda.reset_peak_memory_stats(dev)
        e = sb.run_episode(b)
        print(json.dumps({
            "episode": "warm-up" if i == 0 else i, "frames": e["frames"],
            "seconds": e["seconds"], "opt_steps": e["opt_steps"],
            **{k: v - before[k] for k, v in counters.items()},
            "memory_peak_allocated": torch.cuda.max_memory_allocated(dev),
            "memory_peak_reserved": torch.cuda.max_memory_reserved(dev)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
