"""The readings that the limits of `correct` are set from (run on the
card, not by the benchmark's own runs):

    python -m slam_bench.control --workload replica-room.replay \
        --seeds 1 2 3 ... [--control-seeds 3] [--precision tf32|bf16] \
        [--fault <name>]

For each seed, in one process: the cell's set-up, one closed-loop
episode (a window episode, without the warm-up), then the checks of
slam_bench/check.py, printing the episode's numbers and the program's
(the lower readings: sound runs) and, on the first --control-seeds seeds,
the control's (the reference in TF32, or with --precision bf16 in
bfloat16, in the program's place: the upper readings).  With --fault, a
fault of slam_bench/faults.py is planted in the program for the episode
and the check (upper readings of the episode's numbers).  One JSON line
per seed.
"""
from __future__ import annotations

import argparse
import json
import sys


def readings(spec: dict, seed: int, device, control: str | None = None,
             fault: str | None = None) -> dict:
    """One seed's episode and checks, with the control's numbers where
    `control` is given, and `fault` planted for the episode and check."""
    from slam_bench import check, faults, run

    b = run.setup(spec, seed, device)
    undo = (faults.plant(fault, b.cfg.engine.mapping_iters_per_frame)
            if fault else None)
    try:
        e = run.run_episode(b)
        checks, ctl = check.run_check(b, [e], control)
    finally:
        if undo:
            undo()
    return {"seed": seed, "fault": fault,
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "episode": {k: e[k] for k in (
                "seconds", "ate_m", "keyframes", "gaussians", "opt_steps",
                "map_slots_used", "vis_cap_dropped", "tile_cap_dropped")},
            "program": {k: c["value"] for k, c in checks.items()},
            "control": ctl}


def main(argv=None) -> int:
    from slam_bench import faults

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--precision", choices=("tf32", "bf16"), default="tf32")
    ap.add_argument("--fault", choices=faults.NAMES)
    args = ap.parse_args(argv)

    import torch

    from slam_bench import run

    if not torch.cuda.is_available():
        print("slam_bench.control: no CUDA device", file=sys.stderr)
        return 2
    spec = run.cell_spec(run.load_json("BENCHMARK.json"), args.workload)
    dev = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        ctl = args.precision if i < args.control_seeds else None
        try:
            out = readings(spec, seed, dev, ctl, args.fault)
        except Exception as e:  # a fault may crash the program: a reading
            out = {"seed": seed, "fault": args.fault, "error": repr(e)}
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
