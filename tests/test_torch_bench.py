"""PyTorch port: the port's bench (gs_icp_slam_torch/bench.py) on the CPU
at a tiny size, and the draw stream of a copied state.

  * the bench prints exactly bench.py's JSON keys, in its order (read from
    bench.py's source);
  * its state as tracking ends equals a plain FusedEngine run's on the same
    recorded draws, bit for bit: the warm-ups on copies and the fps_live
    loop moved no draw of the main run (the JAX state carries its PRNG key,
    the port's engine its draw stream);
  * a step on a copy of the state, with the stream's position saved and
    restored, leaves the main run's draws and state as they were; without
    the restore it shifts them (the fault this repairs).
Sizes: 160x120, 2 warm-up + 6 timed frames, 16-pixel tiles with K <= 256
(bench.py's GS_BENCH_TILE / GS_BENCH_K knobs), so that the CPU runs stay
short.
"""
import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gs_icp_slam_torch.bench import bench_config, bench_line, run_bench
from gs_icp_slam_torch.datasets import open_dataset
from gs_icp_slam_torch.slam import (FusedEngine, RecordedDraws, TorchDraws,
                                    copy_state, init_state)
from gs_icp_slam_torch.slam.fused import to_chw

W, H, WARMUP, TIMED = 160, 120, 2, 6
ENV = {"GS_BENCH_TILE": "16", "GS_BENCH_K": "256"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recording:
    """A draw source that records what another one gives."""

    def __init__(self, inner):
        self.inner, self.pairs = inner, []

    def __call__(self, maxval):
        v = self.inner(maxval)
        self.pairs.append([maxval, v])
        return v


def _bench_py_keys():
    """The keys of the dict bench.py prints, in order."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "fps_live"
                     for k in n.keys)]
    assert len(dicts) == 1
    return [k.value for k in dicts[0].keys]


def _plain_run(draws):
    """FusedEngine.run on the bench's sequence and configuration."""
    seq = open_dataset("synthetic", width=W, height=H,
                       num_frames=WARMUP + TIMED)
    cfg = bench_config(seq.intr, ENV)
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, fps_cap=None))
    return FusedEngine(seq, cfg, device="cpu", draws=draws).run(
        eval_render=True)


def test_bench_pre_refine_state_equals_plain_run():
    rec = Recording(TorchDraws(3))
    res = _plain_run(rec)
    draws = RecordedDraws(rec.pairs)
    # GS_BENCH_REFINE_S 0: no refine call (the warm-ups on copies run one)
    run = run_bench(draws=draws, device="cpu", width=W, height=H,
                    warmup=WARMUP, timed=TIMED,
                    env=dict(ENV, GS_BENCH_REFINE_S="0"))
    pre = run.pre_refine
    assert draws.used == len(rec.pairs)
    np.testing.assert_array_equal(pre["poses"], res.poses)
    np.testing.assert_array_equal(pre["per_frame_psnr"], res.per_frame_psnr)
    assert pre["ate_rmse_m"] == res.ate_rmse
    assert (pre["num_gaussians"], pre["kf_total"], pre["kf_count"]) == (
        res.num_gaussians, res.kf_total, res.kf_stored)
    assert (pre["vis_cap_dropped"], pre["tile_cap_dropped"]) == (
        res.vis_cap_dropped, res.tile_cap_dropped)
    f = run.fields
    assert f["refine_iters"] == 0 and f["psnr_pre_refine_db"] == float(
        np.mean(res.per_frame_psnr)) == f["psnr_db"]

    line = bench_line(f)
    assert list(line) == _bench_py_keys()
    assert line["lpips"] is None and line["unit"] == "frames/s"
    assert line["value"] > 0 and line["fps_live"] > 0
    assert line["vs_baseline"] == round(f["value"] / 30.0, 4)
    assert np.isfinite([line[k] for k in ("psnr_db", "ssim", "ate_rmse_m",
                                          "ssim_pre_refine")]).all()
    assert json.loads(json.dumps(line)) == line


def _copy_setup():
    seq = open_dataset("synthetic", width=W, height=H, num_frames=4)
    cfg = bench_config(seq.intr, ENV)
    frames = [(torch.as_tensor(seq[i].depth), to_chw(seq[i].rgb, "cpu"))
              for i in range(3)]

    def engine(draws):
        eng = FusedEngine(seq, cfg, device="cpu", draws=draws)
        st = init_state(cfg, 4, np.asarray(seq[0].gt_c2w, np.float32), "cpu")
        return eng, st

    return frames, engine


@pytest.fixture(scope="module")
def three_frames():
    """Three frames alone: the draws after two and after three frames, and
    the state after three."""
    frames, engine = _copy_setup()
    ref = Recording(TorchDraws(1))
    eng, st = engine(ref)
    for i in range(3):
        st = eng.fused.step(st, *frames[i], False)
        if i == 1:
            n_before = len(ref.pairs)
    return ref.pairs, n_before, st


@pytest.mark.parametrize("source", ["torch", "recorded"])
@pytest.mark.parametrize("restore", [True, False])
def test_step_on_a_copy_leaves_the_draw_stream(three_frames, source,
                                               restore):
    """Three frames on the main state, with a step of frame 2 on a copy
    between frames 1 and 2, with (or without) the draw position restored,
    against the three frames alone."""
    want, n_before, st = three_frames
    k = len(want) - n_before  # the draws frame 2 takes
    frames, engine = _copy_setup()
    # a recording holds the main run's draws, and frame 2's again for a
    # stream that the copy moved
    rec = Recording(TorchDraws(1) if source == "torch"
                    else RecordedDraws(want + want[n_before:]))
    eng, main = engine(rec)
    for i in range(2):
        main = eng.fused.step(main, *frames[i], False)
    before = copy_state(main)
    pos = rec.inner.position()
    eng.fused.step(copy_state(main), *frames[2], False)
    assert len(rec.pairs) == n_before + k
    # the copy shares no tensor with the state it came from
    np.testing.assert_array_equal(main.poses.numpy(), before.poses.numpy())
    np.testing.assert_array_equal(main.gmap.xyz.numpy(),
                                  before.gmap.xyz.numpy())
    np.testing.assert_array_equal(main.kf_rgb.numpy(), before.kf_rgb.numpy())
    assert main.frame_idx == before.frame_idx == 2
    if restore:
        rec.inner.restore(pos)
    main = eng.fused.step(main, *frames[2], False)
    got = rec.pairs[:n_before] + rec.pairs[n_before + k:]
    if restore:
        assert got == want
        np.testing.assert_array_equal(main.poses.numpy()[:3],
                                      st.poses.numpy()[:3])
        np.testing.assert_array_equal(main.gmap.xyz.numpy(),
                                      st.gmap.xyz.numpy())
    elif source == "torch":
        assert got != want  # the main run drew what the copy left over
    else:
        assert rec.inner.used == len(want) + k  # past the main run's draws
