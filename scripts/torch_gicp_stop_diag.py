"""The benchmark check's frame step on one seed of a cell, with both
sides' Gauss-Newton iterations logged (slam_bench/check.py: the
program's FusedStep.step against the plain reference): per iteration the
update's largest rotation and translation components as shares of the
convergence test's epsilons, and the program's 1-NN (K2) against the
reference's brute-force 1-NN on the same queries; then the check's gaps
and both iteration counts:

    python scripts/torch_gicp_stop_diag.py \\
        --workload tum-fr1-full.replay-desk-600 --seed 3141592653

The cell is set up as `python -m slam_bench.run` sets it up, and its
warm-up and one window episode run first, as in an untraced run whose
window holds one episode.  A frame whose last update lies near an
epsilon can stop after one more iteration on one side than on the other;
the check's pose gap is then that iteration's update.  Without a card it
runs at the CPU rehearsal's size (slam_bench/tests/test_slam_bench_full.py).
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
    ap.add_argument("--episodes", type=int, default=2,
                    help="episodes before the check (warm-up included)")
    args = ap.parse_args(argv)

    import torch

    import gs_icp_slam_torch.ops.gicp as pg
    from slam_bench import check, run as sb
    from slam_bench.reference import geometry as G

    spec = sb.cell_spec(sb.load_json("BENCHMARK.json"), args.workload)
    if torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    else:
        from gs_icp_slam_torch.slam.fused import FusedEngine
        from slam_bench.tests.test_slam_bench_full import tiny_spec

        FusedEngine.MIN_BUCKET = 1 << 10
        spec, dev = tiny_spec(), torch.device("cpu")
    b = sb.setup(spec, args.seed, dev)
    for _ in range(args.episodes):
        e = sb.run_episode(b)
        print(json.dumps({"episode_s": e["seconds"],
                          "keyframes": e["keyframes"],
                          "map_slots_used": e["map_slots_used"]}),
              flush=True)
    conf = spec["config"]
    g = conf["slam_config"]["gicp"]
    logs = {"program": [], "reference": []}
    p_gn, r_gn = pg._gn_step, G.gn_step

    def shares(delta):
        d = delta.abs()
        return {"rot_share": float(d[:3].max()) / g["rotation_epsilon"],
                "trans_share": float(d[3:].max())
                / g["transformation_epsilon"]}

    def program_gn(T, source, target, tgt9, cfg):
        out = p_gn(T, source, target, tgt9, cfg)
        _, delta, idx, sqd = out
        p = source.points @ T[:3, :3].T + T[:3, 3]
        r_idx, r_sqd = G.nn1(p, target.points, target.valid)
        other = source.valid & (idx.long() != r_idx)
        logs["program"].append({
            **shares(delta), "nn_other": int(other.sum()),
            "nn_farther": int((other & (sqd > r_sqd)).sum())})
        return out

    def reference_gn(T, pts, c6, ok, tgt_pts, tgt_c6, tgt_valid, gc,
                     q=G.ident):
        out = r_gn(T, pts, c6, ok, tgt_pts, tgt_c6, tgt_valid, gc, q)
        logs["reference"].append(shares(out[1]))
        return out

    pg._gn_step, G.gn_step = program_gn, reference_gn
    n = b.ep.n
    prog, before, log, frame = check.program_step(
        b.engine, n, b.rgb[n], b.depth[n], b.draws, b.device)
    b.engine.state = None
    ref = check.reference_step(before, frame, conf, log)
    for side, rows in logs.items():
        for i, r in enumerate(rows):
            print(json.dumps({"side": side, "iteration": i, **r}),
                  flush=True)
    print(json.dumps({"gaps": check.compare(prog, ref, before, conf),
                      "iterations": {k: len(v) for k, v in logs.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
