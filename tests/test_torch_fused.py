"""PyTorch port: the fused per-frame step and FusedEngine against the JAX
package's, on the synthetic sequence at tests/test_fused.py's size (128x96,
downsample 4, map capacity 2^14, 6 frames, 2 mapping iterations per frame)
with 64 final iterations, so that one `refine` call runs.

Both engines take the same random draws: the port's step is handed a draw
source that replays JAX's split/randint sequence from the same
PRNGKey(seed), called where the JAX step draws (the keyframe index of
every mapping iteration, the reservoir victim of every keyframe store).
The minimum map bucket is lowered on both engines, so that the capacity
bucket engages (the map's first 2,048 slots) for the whole run.  The
renders use 16-pixel tiles, K <= 256 per tile, and one 12-tile chunk of
the JAX XLA compositor, so that both CPU sides stay cheap.

Tolerances, and why: poses atol 1e-4 m and per-frame PSNR within 0.05 dB
(near-tie neighbour picks of the JAX CPU distance form, float32 sums in
another order); Gaussian and keyframe counts, the live mask, the counters
and the cap-drop stats exact (a difference would be another keyframe or
pruning decision).  FusedEngine.evaluate on both finished runs: per-frame
PSNR within 0.05 dB, SSIM within 1e-3 and LPIPS-alex (random weights)
within 2e-3, the maps' drift rather than the metrics'.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.config import synthetic_config as j_synthetic_config
from gs_icp_slam_tpu.datasets import open_dataset as j_open_dataset
from gs_icp_slam_tpu.eval.lpips import make_random_weights
from gs_icp_slam_tpu.slam import FusedEngine as JFused
from gs_icp_slam_tpu.slam.fused import to_chw as j_to_chw
from gs_icp_slam_tpu.slam.state import init_state as j_init_state
from gs_icp_slam_torch import convert
from gs_icp_slam_torch.datasets import open_dataset as t_open_dataset
from gs_icp_slam_torch.slam import FusedEngine as TFused
from gs_icp_slam_torch.slam import RecordedDraws, TorchDraws
from gs_icp_slam_torch.slam.fused import to_chw as t_to_chw

W, H, FRAMES = 128, 96, 6
ITERS, FINAL = 2, 64
MIN_BUCKET = 1024


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxDraws:
    """JAX's draw sequence: one split of the key and one randint per draw,
    as the JAX fused step takes them."""

    def __init__(self, key):
        self.key = jnp.asarray(key)

    def __call__(self, maxval: int) -> int:
        self.key, sub = jax.random.split(self.key)
        return int(jax.random.randint(sub, (), 0, jnp.int32(maxval)))


def _cfg():
    seq = j_open_dataset("synthetic", width=W, height=H, num_frames=FRAMES)
    cfg = j_synthetic_config(seq.intr, downsample_rate=4, capacity=1 << 14,
                             target_capacity=1 << 12,
                             visible_capacity=1 << 12)
    return seq, cfg.replace(
        engine=dataclasses.replace(
            cfg.engine, mapping_iters_per_frame=ITERS,
            mapping_iters_final=FINAL, keyframe_capacity=16, fps_cap=None),
        render=dataclasses.replace(cfg.render, tile_size=16,
                                   composite_chunk=12, max_per_tile=256))


def _run():
    """Both engines' runs."""
    jseq, jcfg = _cfg()
    jeng = JFused(jseq, jcfg, seed=0)
    jeng.MIN_BUCKET = MIN_BUCKET
    jres = jeng.run(eval_render=True)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    tseq = t_open_dataset("synthetic", width=W, height=H, num_frames=FRAMES)
    teng = TFused(tseq, tcfg, device="cpu",
                  draws=JaxDraws(jax.random.PRNGKey(0)))
    teng.MIN_BUCKET = MIN_BUCKET
    tres = teng.run(eval_render=True)
    return jeng, jres, teng, tres


@pytest.mark.time_limit(420)  # 160-209 s in tier-1's six workers, 8-core CPU
def test_fused_engine_matches_jax():
    """The slice as a whole, in one test so that a test worker runs the
    engine pair once: the run, then one step from an identical state."""
    jeng, jres, teng, tres = _run()
    js, ts = jeng.state, teng.state
    # poses
    assert tres.poses.shape == (FRAMES, 4, 4)
    np.testing.assert_allclose(tres.poses, jres.poses, atol=1e-4)
    np.testing.assert_allclose(tres.poses[0], tres.gt_poses[0], atol=1e-6)
    assert abs(tres.ate_rmse - jres.ate_rmse) < 1e-4
    # counts, counters, masks, cap drops
    assert tres.num_gaussians == jres.num_gaussians
    assert (tres.kf_total, tres.kf_stored) == (jres.kf_total, jres.kf_stored)
    assert 1 <= tres.kf_stored < FRAMES
    assert ts.gmap.n == int(js.gmap.n)
    assert ts.train_iter == int(js.train_iter) == FRAMES * ITERS + FINAL
    assert ts.adam.step == int(js.adam.step) == ts.train_iter
    assert (ts.frame_idx, ts.new_kf, ts.from_last_kf) == (
        int(js.frame_idx), int(js.new_kf), int(js.from_last_kf))
    np.testing.assert_array_equal(ts.gmap.live.numpy(),
                                  np.asarray(js.gmap.live))
    np.testing.assert_array_equal(ts.gmap.trackable.numpy(),
                                  np.asarray(js.gmap.trackable))
    assert (tres.vis_cap_dropped, tres.tile_cap_dropped) == (
        jres.vis_cap_dropped, jres.tile_cap_dropped)
    # render quality
    assert np.isfinite(tres.per_frame_psnr).all()
    np.testing.assert_allclose(tres.per_frame_psnr, jres.per_frame_psnr,
                               atol=0.05)
    # the port called its draw source exactly where the JAX step drew:
    # the replayed key chain ends where the JAX state's does
    np.testing.assert_array_equal(np.asarray(teng.draws.key),
                                  np.asarray(js.rng))
    # the keyframe store
    kc = ts.kf_count
    np.testing.assert_array_equal(ts.kf_rgb[:kc].numpy(),
                                  np.asarray(js.kf_rgb)[:kc])
    np.testing.assert_array_equal(ts.kf_depth[:kc].numpy(),
                                  np.asarray(js.kf_depth)[:kc])
    np.testing.assert_allclose(ts.kf_w2c[:kc].numpy(),
                               np.asarray(js.kf_w2c)[:kc], atol=1e-4)
    _check_step_from_identical_state(jeng)
    _check_evaluate(jeng, teng)


def _check_evaluate(jeng, teng):
    """FusedEngine.evaluate on both finished runs: per-frame PSNR within
    0.05 dB (the runs' tolerance) and SSIM within 1e-3 (the two maps
    differ by the runs' float32 drift, not by the metric), LPIPS-alex on
    random weights within rtol 1e-2 (chip_smoke.py's TOL_LPIPS_REL; the
    values are ~2e-3 and were seen to differ by at most 2e-5 of
    themselves); then at the JAX run's poses on the port's map, stride
    2, with the comparison PNGs written."""
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/alex.npz"
        make_random_weights(path, seed=0, net="alex")
        mp = pytest.MonkeyPatch()
        mp.setenv("GS_LPIPS_WEIGHTS", path)
        try:
            jm, tm = jeng.evaluate(), teng.evaluate()
        finally:
            mp.undo()
        assert tm.per_frame_psnr.shape == (FRAMES,) and tm.lpips is not None
        np.testing.assert_allclose(tm.per_frame_psnr, jm.per_frame_psnr,
                                   atol=0.05)
        np.testing.assert_allclose(tm.per_frame_ssim, jm.per_frame_ssim,
                                   atol=1e-3)
        np.testing.assert_allclose(tm.per_frame_lpips, jm.per_frame_lpips,
                                   rtol=1e-2)
        tm2 = teng.evaluate(eval_stride=2, poses=np.asarray(jeng.state.poses),
                            dump_dir=f"{d}/dump")
        assert tm2.lpips is None and tm2.per_frame_psnr.shape == (3,)
        np.testing.assert_allclose(tm2.per_frame_psnr, tm.per_frame_psnr[::2],
                                   atol=0.05)
        assert len(os.listdir(f"{d}/dump")) == 1  # frame 0


def _check_step_from_identical_state(jeng):
    """convert.state_from_numpy: the JAX state after two frames, carried
    across; one more frame on both sides from it (the JAX engine's step is
    compiled already)."""
    jseq, jcfg = _cfg()
    nb, tb = jeng._pick_buckets(0)
    state = j_init_state(jcfg, FRAMES,
                         np.asarray(jseq[0].gt_c2w, np.float32))
    for i in range(2):
        fr = jseq[i]
        state = jeng.fused.step(state, jnp.asarray(fr.depth),
                                j_to_chw(fr.rgb), jnp.bool_(False), nb, tb)
    snap = jax.device_get(state)
    tstate = convert.state_from_numpy(snap, device="cpu")
    assert (tstate.frame_idx, tstate.kf_count, tstate.train_iter) == (
        2, int(snap.kf_count), 2 * ITERS)
    teng = TFused(t_open_dataset("synthetic", width=W, height=H,
                                 num_frames=FRAMES),
                  convert.config_from_dict(dataclasses.asdict(jcfg)),
                  device="cpu", draws=JaxDraws(snap.rng))
    fr = jseq[2]
    jnext = jax.device_get(jeng.fused.step(
        state, jnp.asarray(fr.depth), j_to_chw(fr.rgb), jnp.bool_(False),
        nb, tb))
    tnext = teng.fused.step(tstate, torch.as_tensor(fr.depth),
                            t_to_chw(fr.rgb, "cpu"), False, nb, tb)
    np.testing.assert_allclose(tnext.poses.numpy(), jnext.poses, atol=1e-4)
    assert tnext.gmap.n == int(jnext.gmap.n)
    assert (tnext.kf_count, tnext.kf_total, tnext.train_iter) == (
        int(jnext.kf_count), int(jnext.kf_total), int(jnext.train_iter))
    np.testing.assert_array_equal(tnext.gmap.live.numpy(),
                                  np.asarray(jnext.gmap.live))
    np.testing.assert_allclose(tnext.gmap.xyz.numpy(),
                               np.asarray(jnext.gmap.xyz), atol=1e-4)


@pytest.mark.parametrize("n_now", [0, 5000, (1 << 16) - 3000, 1 << 16])
def test_pick_buckets_match_jax(n_now):
    """Bucket engage / disengage, at tests/test_quick.py:66-78's geometry."""
    jseq = j_open_dataset("synthetic", width=64, height=48, num_frames=2)
    jcfg = j_synthetic_config(jseq.intr, downsample_rate=4,
                              capacity=1 << 16, target_capacity=1 << 13,
                              visible_capacity=1 << 11)
    tseq = t_open_dataset("synthetic", width=64, height=48, num_frames=2)
    teng = TFused(tseq, convert.config_from_dict(dataclasses.asdict(jcfg)),
                  device="cpu")
    nb, tb = teng._pick_buckets(n_now)
    assert (nb, tb) == JFused(jseq, jcfg)._pick_buckets(n_now)
    if n_now == 0:
        assert nb is not None and nb < jcfg.map.capacity
        assert tb is not None and tb < jcfg.engine.target_capacity
    if n_now == 1 << 16:  # near capacity the buckets disengage
        assert nb is None and tb is None


def test_chunked_dispatch_matches_per_frame():
    """frames_per_dispatch = 3 (step_chunk) gives the per-frame run."""
    _, jcfg = _cfg()
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    seq = t_open_dataset("synthetic", width=W, height=H, num_frames=3)
    runs = []
    for chunk in (1, 3):
        cfg = tcfg.replace(engine=dataclasses.replace(
            tcfg.engine, frames_per_dispatch=chunk, mapping_iters_final=0))
        eng = TFused(seq, cfg, device="cpu", draws=TorchDraws(5))
        runs.append((eng.run(eval_render=False), eng.state))
    (r1, s1), (r3, s3) = runs
    np.testing.assert_array_equal(r3.poses, r1.poses)
    assert (r3.num_gaussians, r3.kf_total, s3.train_iter) == (
        r1.num_gaussians, r1.kf_total, s1.train_iter)
    np.testing.assert_array_equal(s3.gmap.xyz.numpy(), s1.gmap.xyz.numpy())


def test_draw_sources():
    t1, t2 = TorchDraws(3), TorchDraws(3)
    seq = [t1(m) for m in (64, 1, 2, 5, 5, 5)]
    assert seq == [t2(m) for m in (64, 1, 2, 5, 5, 5)]
    assert all(0 <= v < m for v, m in zip(seq, (64, 1, 2, 5, 5, 5)))
    rec = RecordedDraws([[64, 7], [3, 2]])
    assert rec(64) == 7
    with pytest.raises(RuntimeError):
        rec(4)  # another maxval than recorded: another keyframe decision


def test_fused_engine_at_stage_1():
    """Training stage 1: the engine is built, its opt step renders at half
    resolution with K = max_per_tile, and a 2-frame run maps (evaluation
    stays at full resolution)."""
    _, jcfg = _cfg()
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    tcfg = tcfg.replace(opt=dataclasses.replace(tcfg.opt, training_stage=1),
                        engine=dataclasses.replace(tcfg.engine,
                                                   mapping_iters_final=0))
    tseq = t_open_dataset("synthetic", width=W, height=H, num_frames=2)
    eng = TFused(tseq, tcfg, device="cpu", draws=TorchDraws(2))
    res = eng.run(eval_render=True)
    assert eng.state.train_iter == 2 * ITERS
    assert np.isfinite(res.poses).all() and np.isfinite(res.psnr)
    assert res.tile_cap_dropped == 0 and res.vis_cap_dropped == 0
