"""Where the port's offline `render` spends a frame, on one NVIDIA GPU.

    python scripts/torch_render_times.py [--reps N]

Writes chip_smoke.py's 36-frame 1200x680 synthetic sequence in Replica's
layout (chip_smoke.write_replica_dir) under build/render_times/, runs
`python -m gs_icp_slam_torch run` on it (path G's settings, no eval) for a
scene.ply and trajectory.npy, then renders frames 0, 6, ..., 30 as
eval/offline.py's render_ply_sequence does, timing each part with a sync
after it: the PLY read, the upload, the rasterizer (kernel K1-fwd), the
copy to uint8 on the host, and the PNG encode (in memory and to a file);
and render_ply_sequence itself over the same frames.  Prints the card's
name and power limit (nvidia-smi), then one JSON line per repetition with
the seconds of each part and its milliseconds per frame.
"""
from __future__ import annotations

import argparse
import importlib.util
import io
import json
import shutil
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def chip_smoke():
    """This repository's chip_smoke.py (its inputs and helpers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    from PIL import Image

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    from gs_icp_slam_torch import cuda_build
    from gs_icp_slam_torch.datasets import InMemorySequence, open_dataset
    from gs_icp_slam_torch.eval.offline import render_ply_sequence
    from gs_icp_slam_torch.io.ply import load_ply
    from gs_icp_slam_torch.ops.rasterize import rasterize_tiled
    from gs_icp_slam_torch.utils.se3 import invert_se3

    cs = chip_smoke()
    print(cs.card_line(), flush=True)
    cuda_build.build_all()
    seq = InMemorySequence(open_dataset("synthetic", width=cs.WIDTH,
                                        height=cs.HEIGHT,
                                        num_frames=cs.FRAMES))
    root = HERE / "build" / "render_times"
    shutil.rmtree(root, ignore_errors=True)
    caminfo = cs.write_replica_dir(seq, str(root / "data"))
    rc, _, _ = cs.cli_main([
        "run", "--dataset_path", str(root / "data"), "--config", caminfo,
        "--frames", str(cs.FRAMES), "--unlimited",
        "--mapping_iters_per_frame", str(cs.MAPPING_ITERS),
        "--init_opacity", "0.5", "--feature_lr", "1e-2", "--capacity",
        str(1 << 18), "--save_results", "--no_eval", "--output_path",
        str(root / "out")])
    if rc != 0:
        raise SystemExit(f"run exited {rc}")
    ply = str(root / "out" / "scene.ply")
    traj = np.load(root / "out" / "trajectory.npy")
    intr = seq.intr
    dev = torch.device("cuda")
    frames = range(0, len(traj), 6)

    for rep in range(args.reps):
        t = {}

        def tick(key, t0):
            torch.cuda.synchronize()
            t[key] = t.get(key, 0.0) + time.perf_counter() - t0

        t0 = time.perf_counter()
        d = load_ply(ply)
        tick("load_ply", t0)
        t0 = time.perf_counter()

        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        xyz, quat = up(d["xyz"]), up(d["rotation"])
        scale = torch.exp(up(d["log_scaling"]))
        opacity = torch.sigmoid(up(d["opacity_logit"][:, 0]))
        sh = torch.cat([up(d["f_dc"]), up(d["f_rest"])], dim=1)
        n = len(d["xyz"])
        live = torch.ones(n, dtype=torch.bool, device=dev)
        bg = torch.zeros(3, device=dev)
        tick("upload", t0)
        for i in frames:
            t0 = time.perf_counter()
            w2c = invert_se3(torch.as_tensor(traj[i], dtype=torch.float32,
                                             device=dev))
            out = rasterize_tiled(
                xyz, quat, scale, opacity, sh, w2c, live, bg, intr.fx,
                intr.fy, (intr.width - 1) / 2.0, (intr.height - 1) / 2.0,
                sh_degree=0, width=intr.width, height=intr.height, tile=16,
                visible_cap=min(1 << 17, n), tile_cap=256)
            tick("rasterize", t0)
            t0 = time.perf_counter()
            img = np.clip(out.color.cpu().numpy().transpose(1, 2, 0), 0, 1)
            img8 = (img * 255).astype(np.uint8)
            tick("to_host_u8", t0)
            t0 = time.perf_counter()
            Image.fromarray(img8).save(io.BytesIO(), format="png")
            tick("png_encode", t0)
            t0 = time.perf_counter()
            Image.fromarray(img8).save(root / "frame.png")
            tick("png_save_file", t0)
        t0 = time.perf_counter()
        render_ply_sequence(ply, traj, str(root / "renders"), intr.width,
                            intr.height, intr.fx, intr.fy, stride=6)
        tick("render_ply_sequence", t0)
        print(json.dumps({"rep": rep, "frames": len(frames), "seconds": t,
                          "per_frame_ms": {k: v / len(frames) * 1e3
                                           for k, v in t.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
