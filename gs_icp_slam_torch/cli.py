"""Command-line interface (counterpart of gs_icp_slam_tpu/cli.py; the same
subcommands, flags, defaults, printed lines and files).

Mirrors the reference's three entry points with one `python -m
gs_icp_slam_torch` command:

  run     live SLAM over a dataset — gs_icp_slam.py:230-251 (argparse
          flags kept name-compatible where they exist) + the shell
          sweeps' per-dataset presets (replica.sh / tum.sh); prints
          System FPS / ATE RMSE like mp_Tracker.py:333-334 and
          PSNR/SSIM/LPIPS like mp_Mapper.py:416-420, writes scene.ply,
          trajectory and results.json under --output_path.
  render  offline re-render of a saved PLY along a saved trajectory
          (render.py parity).
  eval    metrics between two image directories (metrics.py parity).

`--unlimited` removes the 30 FPS throttle (gs_icp_slam_unlimit.py).
Everything runs on the GPU; `main(argv, device="cpu")` runs the plain
PyTorch path on the CPU instead (tests), and `draws=` hands the engine a
draw source (slam/fused.py) in place of the one seeded from --seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _build_run_parser(sub):
    p = sub.add_parser("run", help="run live SLAM on a dataset")
    # reference-compatible flags (gs_icp_slam.py:231-247)
    p.add_argument("--dataset_path", type=str, default="",
                   help="scene directory (Replica scene / TUM sequence)")
    p.add_argument("--config", type=str, default="",
                   help="caminfo.txt (reference format); overrides preset "
                        "intrinsics")
    p.add_argument("--output_path", type=str, default="output/scene")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--keyframe_th", type=float, default=None)
    p.add_argument("--knn_maxd", type=float, default=None)
    p.add_argument("--overlapped_th", type=float, default=None)
    p.add_argument("--overlapped_th2", type=float, default=None)
    p.add_argument("--downsample_rate", type=int, default=None)
    p.add_argument("--max_correspondence_distance", type=float, default=None)
    p.add_argument("--motion_model", type=str, default=None,
                   choices=["constant_position", "constant_velocity",
                            "adaptive"],
                   help="G-ICP seed model (default adaptive: CP below "
                        "~2 deg/frame predicted rotation, CV above)")
    p.add_argument("--init_opacity", type=float, default=None,
                   help="opacity of newly inserted gaussians (reference "
                        "0.1; 0.5 reaches usable in-run PSNR at small "
                        "per-frame mapping budgets)")
    p.add_argument("--feature_lr", type=float, default=None,
                   help="SH color learning rate (reference 2.5e-3)")
    p.add_argument("--trackable_opacity_th", type=float, default=None)
    p.add_argument("--save_results", action="store_true")
    p.add_argument("--rerun_viewer", action="store_true",
                   help="stream to a rerun.io viewer if the sdk is present")
    p.add_argument("--net_gui", action="store_true",
                   help="serve the SIBR remote viewer protocol on "
                        "--net_gui_port (reference network_gui, port 6009)")
    p.add_argument("--net_gui_port", type=int, default=6009)
    # ours
    p.add_argument("--dataset_type", type=str, default=None,
                   choices=["replica", "tum", "synthetic"],
                   help="inferred from --config when omitted")
    p.add_argument("--frames", type=int, default=None,
                   help="limit the number of frames")
    p.add_argument("--unlimited", action="store_true",
                   help="disable the 30 FPS tracking throttle")
    p.add_argument("--fps_cap", type=float, default=None)
    p.add_argument("--mapping_iters_per_frame", type=int, default=None)
    p.add_argument("--mapping_iters_final", type=int, default=None)
    p.add_argument("--training_stage", type=int, default=None,
                   choices=(0, 1, 2),
                   help="0 full-res mapping; 1/2 half/quarter-res "
                        "(reference gs_icp_slam.py --training_stage)")
    p.add_argument("--capacity", type=int, default=None,
                   help="gaussian map capacity (static)")
    p.add_argument("--eval_stride", type=int, default=1)
    p.add_argument("--no_eval", action="store_true")
    p.add_argument("--checkpoint_path", type=str, default="",
                   help="write a resumable checkpoint at the end")
    p.add_argument("--seed", type=int, default=0)
    return p


def _config_for(args):
    from .config import (parse_caminfo, replica_config, synthetic_config,
                         tum_config)

    intr = None
    dtype = args.dataset_type
    if args.config:
        intr, cfg_dtype = parse_caminfo(args.config)
        dtype = dtype or cfg_dtype
    if dtype is None:
        raise SystemExit("pass --dataset_type or --config (caminfo.txt)")
    if dtype == "replica":
        cfg = replica_config(intr)
    elif dtype == "tum":
        cfg = tum_config(intr)
    else:
        from .utils.camera import Intrinsics
        cfg = synthetic_config(intr or Intrinsics(
            320, 240, 160.0, 160.0, 159.5, 119.5, depth_scale=1000.0,
            depth_trunc=12.0))

    gicp = {}
    if args.max_correspondence_distance is not None:
        gicp["max_correspondence_distance"] = args.max_correspondence_distance
    if args.knn_maxd is not None:
        gicp["knn_max_distance"] = args.knn_maxd
    if args.motion_model is not None:
        gicp["motion_model"] = args.motion_model
    if gicp:
        cfg = cfg.replace(gicp=dataclasses.replace(cfg.gicp, **gicp))

    kf = {}
    for k in ("keyframe_th", "overlapped_th", "overlapped_th2"):
        v = getattr(args, k)
        if v is not None:
            kf[k] = v
    if kf:
        cfg = cfg.replace(kf=dataclasses.replace(cfg.kf, **kf))

    mp = {}
    if args.trackable_opacity_th is not None:
        mp["trackable_opacity_th"] = args.trackable_opacity_th
    if args.init_opacity is not None:
        mp["init_opacity"] = args.init_opacity
    if args.capacity is not None:
        mp["capacity"] = args.capacity
    if mp:
        cfg = cfg.replace(map=dataclasses.replace(cfg.map, **mp))

    eng = {}
    if args.unlimited:
        eng["fps_cap"] = None
    elif args.fps_cap is not None:
        eng["fps_cap"] = args.fps_cap
    if args.mapping_iters_per_frame is not None:
        eng["mapping_iters_per_frame"] = args.mapping_iters_per_frame
    if args.mapping_iters_final is not None:
        eng["mapping_iters_final"] = args.mapping_iters_final
    if eng:
        cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, **eng))
    if getattr(args, "training_stage", None) is not None:
        cfg = cfg.replace(opt=dataclasses.replace(
            cfg.opt, training_stage=args.training_stage))
    if args.feature_lr is not None:
        cfg = cfg.replace(opt=dataclasses.replace(
            cfg.opt, feature_lr=args.feature_lr))
    if args.downsample_rate is not None:
        cfg = cfg.replace(downsample_rate=args.downsample_rate)
    return cfg


def cmd_run(args, device, draws=None) -> int:
    import numpy as np

    from .datasets import open_dataset
    from .slam import FusedEngine

    cfg = _config_for(args)
    if cfg.dataset_type == "synthetic":
        kw = {"width": cfg.intr.width, "height": cfg.intr.height}
        if args.frames is not None:
            kw["num_frames"] = args.frames
    else:
        kw = {"intr": cfg.intr}
        if args.frames is not None:
            kw["max_frames"] = args.frames
    dataset = open_dataset(cfg.dataset_type, args.dataset_path, **kw)
    cfg = cfg.replace(intr=dataset.intr)

    viewer = None
    if args.rerun_viewer:
        from .viz.rerun_logger import RerunLogger
        viewer = RerunLogger(cfg.intr)
    net_gui = None
    if args.net_gui:
        from .viz.network_gui import NetworkGUI
        net_gui = NetworkGUI(port=args.net_gui_port,
                             verify=args.dataset_path or "gs_icp_slam_torch")

    eng = FusedEngine(dataset, cfg, seed=args.seed, device=device,
                      draws=draws)
    try:
        res = eng.run(eval_render=not args.no_eval,
                      eval_stride=args.eval_stride, progress=args.verbose,
                      viewer=viewer, net_gui=net_gui)
    finally:
        if net_gui is not None:
            net_gui.close()

    ate_cm = res.ate_rmse * 100 if res.ate_rmse is not None else None
    print(f"System FPS: {res.fps:.2f}")
    if ate_cm is not None:
        print(f"ATE RMSE: {ate_cm:.4f} cm")
    metrics = None
    if not args.no_eval:
        metrics = eng.evaluate(eval_stride=args.eval_stride,
                               poses=res.poses)
        print(metrics.summary())

    out = args.output_path
    if args.save_results:
        os.makedirs(out, exist_ok=True)
        n_pts = eng.save_ply(os.path.join(out, "scene.ply"))
        np.save(os.path.join(out, "trajectory.npy"), res.poses)
        if res.gt_poses is not None:
            np.save(os.path.join(out, "trajectory_gt.npy"), res.gt_poses)
        results = {
            "fps": res.fps,
            "ate_rmse_cm": ate_cm,
            "num_gaussians": res.num_gaussians,
            "frames": len(res.poses),
            "psnr": metrics.psnr if metrics else None,
            "ssim": metrics.ssim if metrics else None,
            "lpips": metrics.lpips if metrics else None,
            "config": {"dataset_type": cfg.dataset_type,
                       "downsample_rate": cfg.downsample_rate},
        }
        with open(os.path.join(out, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        with open(os.path.join(out, "results.txt"), "w") as f:
            f.write(f"System FPS: {res.fps:.2f}\n")
            if ate_cm is not None:
                f.write(f"ATE RMSE: {ate_cm:.4f} cm\n")
            if metrics:
                f.write(metrics.summary() + "\n")
        print(f"saved {n_pts} gaussians + trajectory + results to {out}")
        if args.checkpoint_path:
            eng.save_checkpoint(args.checkpoint_path)
    return 0


def cmd_render(args, device) -> int:
    """Offline re-render of a saved map along a trajectory (render.py)."""
    import numpy as np

    from .eval.offline import render_ply_sequence

    poses = np.load(args.trajectory)
    os.makedirs(args.output_path, exist_ok=True)
    n = render_ply_sequence(
        args.ply, poses, args.output_path, width=args.width,
        height=args.height, fx=args.fx, fy=args.fy, stride=args.stride,
        device=device)
    print(f"rendered {n} frames to {args.output_path}")
    return 0


def cmd_eval(args, device) -> int:
    """PSNR/SSIM/LPIPS between two image directories (metrics.py)."""
    import numpy as np
    import torch
    from PIL import Image

    from .eval.image_metrics import _masked_psnr, _ssim_val
    from .eval.lpips import lpips, lpips_available

    def load(path):
        with Image.open(path) as im:
            a = np.asarray(im.convert("RGB"), np.float32)
        return torch.from_numpy(a.transpose(2, 0, 1) / 255.0).to(device)

    renders = sorted(os.listdir(args.renders))
    gts = sorted(os.listdir(args.gt))
    if len(renders) != len(gts):
        raise SystemExit(f"{len(renders)} renders against {len(gts)} "
                         "ground-truth images")
    psnrs, ssims, lps = [], [], []
    per_view = {}
    with torch.no_grad():
        for r, g in zip(renders, gts):
            a = load(os.path.join(args.renders, r))
            b = load(os.path.join(args.gt, g))
            ones = torch.ones(a.shape[1:], device=device)
            psnrs.append(float(_masked_psnr(a, b, ones)))
            ssims.append(float(_ssim_val(a, b)))
            if lpips_available():
                lps.append(float(lpips(a, b)[0]))
            per_view[r] = {"psnr": psnrs[-1], "ssim": ssims[-1],
                           "lpips": lps[-1] if lps else None}
    out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
           "lpips": float(np.mean(lps)) if lps else None}
    print(json.dumps(out, indent=2))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump({"mean": out, "per_view": per_view}, f, indent=2)
    return 0


def main(argv=None, *, device="cuda", draws=None) -> int:
    """The command line.  `device` and `draws` are for callers such as the
    tests, not flags: the GPU unless device="cpu" (with no GPU present this
    raises, through resolve_device), and the engine's draw source."""
    from . import resolve_device

    ap = argparse.ArgumentParser(
        prog="gs_icp_slam_torch",
        description="GS-ICP SLAM on one NVIDIA GPU (PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _build_run_parser(sub)

    pr = sub.add_parser("render", help="offline render of a saved PLY")
    pr.add_argument("--ply", required=True)
    pr.add_argument("--trajectory", required=True,
                    help="npy of (N,4,4) c2w poses")
    pr.add_argument("--output_path", default="renders")
    pr.add_argument("--width", type=int, required=True)
    pr.add_argument("--height", type=int, required=True)
    pr.add_argument("--fx", type=float, required=True)
    pr.add_argument("--fy", type=float, required=True)
    pr.add_argument("--stride", type=int, default=1)

    pe = sub.add_parser("eval", help="metrics between image dirs")
    pe.add_argument("--renders", required=True)
    pe.add_argument("--gt", required=True)
    pe.add_argument("--output_json", default="")

    args = ap.parse_args(argv)
    dev = resolve_device(device)
    if args.cmd == "run":
        return cmd_run(args, dev, draws)
    if args.cmd == "render":
        return cmd_render(args, dev)
    return cmd_eval(args, dev)


if __name__ == "__main__":
    sys.exit(main())
