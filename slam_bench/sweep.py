"""The rate sweep that fixes an open-loop cell's rate (run once, on the
card; the cell's traffic file then holds the rate as a number):

    python -m slam_bench.sweep --workload tum-fr1.live-desk --seed 7 \
        --rates 8 10 12 14 16 18 20 --episodes 2

For each rate, whole episodes of the cell's frames from a live sensor at
that rate, through the same engine (set up and warmed once): per rate the
pose latency's median and 95th percentile and the backlog's growth, the
median latency of an episode's last 15 frames less that of its first 15.
A rate is sustained where that growth stays under two frame periods.

With --hook-ab N (and no --rates), what the live cell's per-frame hook
costs: N rounds of three closed-loop episodes of the cell's frames, with
no hook, with a hook that only stamps the clock (run() then builds the
viewer's render function each frame), and with the harness's PoseClock
(that and a device synchronisation each frame); the seconds of each.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", default=[])
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--hook-ab", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from slam_bench import run

    if not torch.cuda.is_available():
        print("slam_bench.sweep: no CUDA device", file=sys.stderr)
        return 2
    spec = run.cell_spec(run.load_json("BENCHMARK.json"), args.workload)
    dev = torch.device("cuda", 0)
    b = run.setup(spec, args.seed, dev)
    run.run_episode(b)                          # warm-up
    for rate in args.rates:
        eps = [run.run_episode(b, rate) for _ in range(args.episodes)]
        growth = [e["latency_last15_less_first15_ms"] for e in eps]
        allx = np.concatenate([e["latency_ms"] for e in eps])
        print(json.dumps({
            "rate": rate, "frames": int(allx.size),
            "p50_ms": float(np.median(allx)),
            "p95_ms": float(np.percentile(allx, 95)),
            "growth_ms": growth,
            "sustained": bool(max(growth) < 2e3 / rate)}), flush=True)
    hooks = {"none": lambda: None, "stamp": lambda: run.PoseClock(),
             "stamp_and_sync": lambda: run.PoseClock(
                 lambda: run.sync(dev, counted=False))}
    secs = {k: [] for k in hooks}
    for _ in range(args.hook_ab):
        for k, make in hooks.items():
            secs[k].append(run.run_episode(b, hook=make())["seconds"])
    if args.hook_ab:
        n = b.ep.n
        med = {k: float(np.median(v)) for k, v in secs.items()}
        print(json.dumps({
            "frames": n, "seconds": secs, "median_s": med,
            "ms_per_frame_over_none": {
                k: (med[k] - med["none"]) * 1e3 / n for k in hooks}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
