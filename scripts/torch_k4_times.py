"""Time the port's dense compositors (kernels K4a and K4b) on one NVIDIA GPU.

    python scripts/torch_k4_times.py --save-view FILE
    python scripts/torch_k4_times.py [--root DIR] [--view FILE] [--reps N]

With --save-view, runs chip_smoke.py's path B (SLAMEngine with bench.py's
mapping settings, 36 frames at 1200x680) with this repository's package and
saves K4_view, its frame-18 view binned at 16-pixel tiles and packed into
dense blocks of 256 (chip_smoke.k4_view_inputs), to FILE.

Otherwise imports gs_icp_slam_torch from DIR (default: this repository),
builds its kernels there, and times `composite_dense_fwd` and
`composite_dense_bwd` through CUDA events, K4a (no counts) and K4b (with
counts), on chip_smoke.py's path D inputs (3,225 tiles of 16x16, K 256,
the same seeds) and, with --view, on the saved K4_view.  Beside each time
it reports the difference from the plain version (forward: bit-equal, and
the largest |difference|; backward: the largest share of a row's largest
|gradient|).  Only the entry points that every version of the package has
are called, so pointing --root at two trees in turn (parent, change,
change, parent) compares two versions of the kernels in one run on
one card.  Prints the card's name and power limit (nvidia-smi), then one
JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def chip_smoke():
    """This repository's chip_smoke.py (its inputs and helpers), whatever
    tree --root names."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def save_view(path: str) -> None:
    import torch

    sys.path.insert(0, str(HERE))
    cs = chip_smoke()
    from gs_icp_slam_torch.config import synthetic_config
    from gs_icp_slam_torch.datasets import InMemorySequence, open_dataset
    from gs_icp_slam_torch.ops.rasterize import bin_splats
    from gs_icp_slam_torch.slam import SLAMEngine

    seq = InMemorySequence(open_dataset("synthetic", width=cs.WIDTH,
                                        height=cs.HEIGHT,
                                        num_frames=cs.FRAMES))
    _, cfg_b = cs.path_configs(seq, synthetic_config)
    eng = SLAMEngine(seq, cfg_b, device="cuda")
    res = eng.run(eval_render=False)
    counts, attrs, ntx, clipped, longest = cs.k4_view_inputs(eng, res, cfg_b,
                                                             bin_splats)
    torch.save(dict(counts=counts.cpu(), attrs=attrs.cpu(), ntx=ntx,
                    clipped=clipped, longest=longest), path)
    print(json.dumps({"saved": path, "tiles": attrs.shape[0],
                      "K": attrs.shape[2], "runs_clipped": clipped,
                      "longest_run": longest}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--view", default=None)
    ap.add_argument("--save-view", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: K4 runs only on the GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.save_view:
        save_view(args.save_view)
        return
    sys.path.insert(0, str(Path(args.root).resolve()))
    from gs_icp_slam_torch import cuda_build
    from gs_icp_slam_torch.ops import composite_cuda as cc

    cs = chip_smoke()
    cuda_build.build_all()
    dev = torch.device("cuda")
    cases = {}
    for key in ("K4a_ablation", "K4b_ablation"):
        counts_np, attrs_np, g = cs.dense_case(key)
        cases[key] = (torch.as_tensor(counts_np).to(dev),
                      torch.as_tensor(attrs_np).to(dev), g.to(dev),
                      cs.DENSE_GEOMETRIES[key][1])
    if args.view:
        v = torch.load(args.view)
        T = v["attrs"].shape[0]
        g = torch.randn((T, 8, cs.DENSE_TILE ** 2),
                        generator=torch.Generator().manual_seed(4))
        g[:, 5:] = 0.0
        cases["K4_view"] = (v["counts"].to(dev), v["attrs"].to(dev),
                            g.to(dev), v["ntx"])

    def time_ms(fn):
        return cs.time_ms(fn, reps=args.reps)

    out = {"root": str(Path(args.root).resolve()), "card": card}
    for key, (counts, attrs, g, ntx) in cases.items():
        for kind in ("dense", "dyn"):
            if key == "K4a_ablation" and kind == "dyn" or (
                    key == "K4b_ablation" and kind == "dense"):
                continue
            c = counts if kind == "dyn" else None
            fa = (c, attrs, ntx, cs.DENSE_TILE)
            o, nc = cc.composite_dense_fwd(*fa)
            o0, nc0 = cc.composite_dense_fwd_plain(*fa)
            ba = (c, attrs, o, nc, g, ntx, cs.DENSE_TILE)
            d1 = cc.composite_dense_bwd(*ba)
            d0 = cc.composite_dense_bwd_plain(*ba)
            torch.cuda.synchronize()
            scale = d0.abs().amax((0, 2), keepdim=True).clamp(min=1e-30)
            out[f"{key}/{kind}"] = dict(
                fwd_ms=time_ms(lambda: cc.composite_dense_fwd(*fa)),
                bwd_ms=time_ms(lambda: cc.composite_dense_bwd(*ba)),
                fwd_exact=bool(torch.equal(o, o0) and torch.equal(nc, nc0)),
                fwd_max_abs_err=float((o - o0).abs().max()),
                bwd_row_err=float(((d1 - d0).abs() / scale).max()))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
