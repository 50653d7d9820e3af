"""PyTorch port: the first slice — the staged SLAMEngine with no mapping
iterations (tracking, covariance-shared map building, target export,
render/eval) — against the JAX SLAMEngine on a 6-frame 128x96 synthetic
run, plus the map operations it uses (mapping runs: test_torch_mapping).

Tolerances: poses atol 1e-4 m and per-frame PSNR within 0.05 dB.  The JAX
engine on the CPU takes its XLA nearest-neighbour paths, whose
|q|^2 - 2 q.r + |r|^2 distance rounds differently from the kernels' direct
form, so a near tie can pick another neighbour and move a covariance or a
correspondence slightly; counts (Gaussians, keyframes) are exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.config import synthetic_config as j_synthetic_config
from gs_icp_slam_tpu.datasets import open_dataset as j_open_dataset
from gs_icp_slam_tpu.models import gaussian_map as jgm
from gs_icp_slam_tpu.slam import SLAMEngine as JEngine
from gs_icp_slam_torch import convert
from gs_icp_slam_torch.datasets import open_dataset as t_open_dataset
from gs_icp_slam_torch.models import gaussian_map as tgm
from gs_icp_slam_torch.slam import FusedEngine as TFused
from gs_icp_slam_torch.slam import SLAMEngine as TEngine
from gs_icp_slam_torch.slam import TorchDraws

W, H, FRAMES = 128, 96, 6


def _cfg():
    seq = j_open_dataset("synthetic", width=W, height=H, num_frames=FRAMES)
    cfg = j_synthetic_config(seq.intr, downsample_rate=4, capacity=1 << 14,
                             target_capacity=1 << 12,
                             visible_capacity=1 << 12)
    return seq, cfg.replace(engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=0, mapping_iters_final=0))


@pytest.fixture(scope="module")
def runs():
    jseq, jcfg = _cfg()
    jeng = JEngine(jseq, jcfg)
    jres = jeng.run(eval_render=True)
    tseq = t_open_dataset("synthetic", width=W, height=H, num_frames=FRAMES)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    teng = TEngine(tseq, tcfg, device="cpu")
    tres = teng.run(eval_render=True)
    return jeng, jres, teng, tres


def test_synthetic_sequence_same_pixels():
    jseq = j_open_dataset("synthetic", width=W, height=H, num_frames=3)
    tseq = t_open_dataset("synthetic", width=W, height=H, num_frames=3)
    assert dataclasses.asdict(jseq.intr) == dataclasses.asdict(tseq.intr)
    for i in range(3):
        a, b = jseq[i], tseq[i]
        np.testing.assert_array_equal(a.rgb, b.rgb)
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(a.gt_c2w, b.gt_c2w)


def test_poses_and_ate(runs):
    _, jres, _, tres = runs
    assert tres.poses.shape == (FRAMES, 4, 4)
    np.testing.assert_allclose(tres.poses, jres.poses, atol=1e-4)
    assert abs(tres.ate_rmse - jres.ate_rmse) < 1e-4
    assert tres.ate_rmse < 5e-3


def test_map_and_keyframes(runs):
    jeng, jres, teng, tres = runs
    assert tres.num_gaussians == jres.num_gaussians
    assert (tres.kf_total, tres.kf_stored) == (jres.kf_total, jres.kf_stored)
    assert teng.gmap.n == int(jeng.gmap.n)
    n = teng.gmap.n
    np.testing.assert_array_equal(teng.gmap.live.numpy(),
                                  np.asarray(jeng.gmap.live))
    np.testing.assert_array_equal(teng.gmap.trackable.numpy(),
                                  np.asarray(jeng.gmap.trackable))
    np.testing.assert_allclose(teng.gmap.xyz.numpy()[:n],
                               np.asarray(jeng.gmap.xyz)[:n], atol=2e-4)
    np.testing.assert_allclose(teng.gmap.f_dc.numpy(),
                               np.asarray(jeng.gmap.f_dc), atol=1e-5)
    np.testing.assert_array_equal(teng.kf_w2c[:teng.kf_count] != 0,
                                  jeng.kf_w2c[:jeng.kf_count] != 0)
    assert tres.vis_cap_dropped == 0 and tres.tile_cap_dropped == 0


def test_render_psnr(runs):
    _, jres, _, tres = runs
    assert np.isfinite(tres.per_frame_psnr).all()
    np.testing.assert_allclose(tres.per_frame_psnr, jres.per_frame_psnr,
                               atol=0.05)


def test_same_map_renders_the_same(runs):
    """The JAX map, carried across with convert.map_from_numpy, renders
    through the port's rasterizer to the JAX render_eval's PSNR."""
    jeng, jres, teng, _ = runs
    m = convert.map_from_numpy(
        {f: np.asarray(getattr(jeng.gmap, f)) for f in jeng.gmap._fields},
        device="cpu")
    eng = TEngine(teng.dataset, teng.cfg, device="cpu")
    eng.gmap = m
    w2c = torch.linalg.inv(torch.as_tensor(jres.poses[2], dtype=torch.float32))
    _, p, _ = eng.render_eval(w2c, teng.dataset[2])
    assert abs(float(p) - jres.per_frame_psnr[2]) < 0.01


def test_add_gaussians_and_trackable_export():
    rng = np.random.default_rng(0)
    C, P = 64, 40
    pts = rng.normal(size=(P, 3)).astype(np.float32)
    cols = rng.uniform(size=(P, 3)).astype(np.float32)
    q = rng.normal(size=(P, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.1, (P, 3)).astype(np.float32)
    z = rng.uniform(0.5, 4.0, P).astype(np.float32)
    trk = rng.random(P) > 0.3
    val = rng.random(P) > 0.2
    jm = jgm.empty_map(C)
    tm = tgm.empty_map(C, device="cpu")
    for _ in range(3):  # the third insert overflows the capacity
        jm = jgm.add_gaussians(jm, *[jnp.asarray(a) for a in
                                     (pts, cols, q, s, z, trk, val)],
                               init_opacity=0.3)
        tm = tgm.add_gaussians(tm, *[torch.as_tensor(a) for a in
                                     (pts, cols, q, s, z, trk, val)],
                               init_opacity=0.3)
    assert tm.n == int(jm.n) == C
    for f in ("xyz", "f_dc", "log_scaling", "rotation", "opacity_logit",
              "trackable", "live"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    # opacity pushes some below the export threshold
    tm.opacity_logit[::3] = -5.0
    jm = jm._replace(opacity_logit=jnp.asarray(tm.opacity_logit.numpy()))
    je = jgm.trackable_export(jm, 0.05, 48)
    te = tgm.trackable_export(tm, 0.05, 48)
    np.testing.assert_array_equal(te[3].numpy(), np.asarray(je[3]))
    ok = te[3].numpy()
    for a, b in zip(te[:3], je[:3]):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok],
                                   rtol=1e-6, atol=1e-6)


def test_staged_engine_at_stage_1():
    """Training stage 1: the staged engine is built from the shared
    mapping primitives, its opt step renders at half resolution, its
    evaluation renders at full resolution, and a 2-frame run maps."""
    _, jcfg = _cfg()
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    seq = t_open_dataset("synthetic", width=W, height=H, num_frames=2)
    cfg = cfg.replace(
        opt=dataclasses.replace(cfg.opt, training_stage=1),
        engine=dataclasses.replace(cfg.engine, mapping_iters_per_frame=1),
        render=dataclasses.replace(cfg.render, tile_size=16,
                                   max_per_tile=256))
    eng = TEngine(seq, cfg, device="cpu")
    assert eng.prim.raster.keywords["width"] == W
    res = eng.run(eval_render=True)
    assert eng.train_iter == 2
    assert np.isfinite(res.poses).all() and np.isfinite(res.psnr)


def test_densify_flag_is_read_by_nothing():
    """`densify_enabled` is accepted and changes nothing, as in the JAX
    engines (which define it but never call densify): SLAMEngine and
    FusedEngine give the flag-off run's results exactly on 2 frames (the
    flag-off runs are held against JAX by the other tests)."""
    _, jcfg = _cfg()
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine, fps_cap=None))
    seq = t_open_dataset("synthetic", width=W, height=H, num_frames=2)
    on = cfg.replace(map=dataclasses.replace(cfg.map, densify_enabled=True))
    for make in (lambda c: TEngine(seq, c, device="cpu"),
                 lambda c: TFused(seq, c, device="cpu",
                                  draws=TorchDraws(1))):
        (r0, m0), (r1, m1) = [(e.run(eval_render=False), e) for e in
                              (make(cfg), make(on))]
        np.testing.assert_array_equal(r1.poses, r0.poses)
        assert (r1.num_gaussians, r1.kf_total, r1.kf_stored) == (
            r0.num_gaussians, r0.kf_total, r0.kf_stored)
        g0 = m0.gmap if isinstance(m0, TEngine) else m0.state.gmap
        g1 = m1.gmap if isinstance(m1, TEngine) else m1.state.gmap
        for f in g0._fields:
            a, b = getattr(g0, f), getattr(g1, f)
            if torch.is_tensor(a):
                assert torch.equal(a, b), f
