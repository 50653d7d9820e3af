"""PyTorch port: the mapping half (losses, masked Adam, map pruning, one
opt step, and the staged SLAMEngine with mapping iterations) against the
JAX package.  Inputs are made with numpy from a seed and fed to both.

Tolerances, and why:
  * losses: values rtol 1e-5, gradients atol 1e-5 of the largest |JAX
    gradient|: the SSIM blur is a depthwise conv2d here and shifted adds
    there, the same products summed in another order;
  * adam_step: rtol 1e-6 (the same float32 operations; pow may differ by
    an ulp in the bias corrections); masked slots exactly unchanged;
  * one opt step from the same map and Adam state at 128x96: loss rtol
    1e-5, gradients atol 1e-4 of each parameter's largest |JAX gradient|
    (the rasterizer's tolerance), and every parameter after the step
    within 1e-3 of its learning rate.  This is the tight check: Adam with
    eps 1e-15 would turn a near-zero gradient of another sign into a full
    learning-rate step (measured: at most 2.4e-4 of the rate);
  * the 6-frame 128x96 engine runs: poses atol 1e-4 m and per-frame PSNR
    within 0.05 dB (the first slice's tolerances: near-tie neighbour picks
    of the JAX CPU distance form move a covariance slightly); Gaussian
    and keyframe counts, the live mask and the cap-drop stats exact.
The JAX runs use one unpadded chunk of its XLA compositor (12 tiles) and
K = 256 per tile, so that the JAX CPU side stays cheap.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.config import OptConfig as JOptConfig
from gs_icp_slam_tpu.config import synthetic_config as j_synthetic_config
from gs_icp_slam_tpu.datasets import open_dataset as j_open_dataset
from gs_icp_slam_tpu.models import gaussian_map as jgm
from gs_icp_slam_tpu.models import optimizer as jopt
from gs_icp_slam_tpu.slam import SLAMEngine as JEngine
from gs_icp_slam_tpu.slam.fused import \
    make_mapping_primitives as j_make_prims
from gs_icp_slam_tpu.utils import losses as jl
from gs_icp_slam_torch import convert
from gs_icp_slam_torch.config import OptConfig as TOptConfig
from gs_icp_slam_torch.datasets import open_dataset as t_open_dataset
from gs_icp_slam_torch.models import gaussian_map as tgm
from gs_icp_slam_torch.models import optimizer as topt
from gs_icp_slam_torch.slam import SLAMEngine as TEngine
from gs_icp_slam_torch.slam.fused import \
    make_mapping_primitives as t_make_prims
from gs_icp_slam_torch.utils import losses as tl

W, H, FRAMES = 128, 96, 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU runs here are small and made of many short ops:
    intra-op threads only contend with JAX's own pool and with the other
    test workers (an 8-thread run measured 10x slower beside them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ losses -----

def _images(seed=0, C=3, h=40, w=56):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (C, h, w)).astype(np.float32)
    gt = rng.uniform(0, 1, (C, h, w)).astype(np.float32)
    gt[:, rng.random((h, w)) < 0.2] = 0.0      # pixels without depth
    gt[0, rng.random((h, w)) < 0.1] = 0.0      # black channel values
    depth = rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
    gt_depth = np.where(rng.random((h, w)) < 0.15, 0.0,
                        rng.uniform(0.5, 4.0, (h, w))).astype(np.float32)
    return pred, gt, depth, gt_depth


def _close_grad(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)


@pytest.mark.parametrize("name", ["l1_masked", "l2_masked", "ssim", "psnr",
                                  "mse_to_psnr"])
def test_loss_matches_jax(name):
    pred, gt, _, _ = _images()
    jf, tf = getattr(jl, name), getattr(tl, name)
    if name == "mse_to_psnr":
        args = (np.float32(0.0123),)
        pick = (lambda r: r)
    else:
        args = (pred, gt)
        pick = (lambda r: r[1] if isinstance(r, tuple) else r)
    jv = jax.jit(jf)(*[jnp.asarray(a) for a in args])
    tv = tf(*[torch.as_tensor(a) for a in args])
    np.testing.assert_allclose(float(pick(tv)), float(pick(jv)), rtol=1e-5)
    if isinstance(jv, tuple):  # the per-element map too
        np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv[0]),
                                   rtol=1e-5, atol=1e-6)
    if name != "mse_to_psnr":
        jg = jax.jit(jax.grad(lambda p, q: pick(jf(p, q))))(
            jnp.asarray(pred), jnp.asarray(gt))
        p = torch.tensor(pred, requires_grad=True)
        pick(tf(p, torch.as_tensor(gt))).backward()
        _close_grad(p.grad.numpy(), np.asarray(jg))


def test_mapping_loss_matches_jax():
    pred, gt, depth, gt_depth = _images(1)
    kw = dict(lambda_dssim=0.2, depth_weight=0.1, d_max=10.0)
    j_loss = jax.jit(functools.partial(jl.mapping_loss, **kw))
    jv, jaux = j_loss(*[jnp.asarray(a) for a in (pred, depth, gt, gt_depth)])
    ts = [torch.tensor(pred, requires_grad=True),
          torch.tensor(depth, requires_grad=True)]
    tv, taux = tl.mapping_loss(ts[0], ts[1], torch.as_tensor(gt),
                               torch.as_tensor(gt_depth), **kw)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    for k in ("l1", "ssim", "l1_depth"):
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=1e-5)
    jg = jax.jit(jax.grad(lambda *a: j_loss(*a)[0], argnums=(0, 1)))(
        *[jnp.asarray(a) for a in (pred, depth, gt, gt_depth)])
    tv.backward()
    for t, j in zip(ts, jg):
        _close_grad(t.grad.numpy(), np.asarray(j))


# ------------------------------------------------------- Adam, map -------

_SHAPES = dict(xyz=(3,), f_dc=(3,), f_rest=(3, 3), log_scaling=(3,),
               rotation=(4,), opacity_logit=(1,))


def test_map_lr_tree_matches_jax():
    for kw in ({}, dict(feature_lr=1e-2, position_lr=3e-6, opacity_lr=0.1)):
        assert (topt.map_lr_tree(TOptConfig(**kw))
                == jopt.map_lr_tree(JOptConfig(**kw)))


def test_adam_step_masked_matches_jax():
    rng = np.random.default_rng(3)
    C = 64
    params = {k: rng.normal(size=(C,) + s).astype(np.float32)
              for k, s in _SHAPES.items()}
    mask = rng.random(C) > 0.3
    lrs = jopt.map_lr_tree(JOptConfig())
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.adam_init(jp)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    ts = topt.adam_init(tp)
    for _ in range(5):
        grads = {k: (rng.normal(size=(C,) + s)
                     * 10.0 ** rng.uniform(-7, 1, (C,) + s)).astype(np.float32)
                 for k, s in _SHAPES.items()}
        grads["xyz"][::7] = 0.0
        jp, js = jopt.adam_step(jp, {k: jnp.asarray(g) for k, g in
                                     grads.items()}, js, lrs,
                                jnp.asarray(mask))
        tp, ts = topt.adam_step(tp, {k: torch.as_tensor(g) for k, g in
                                     grads.items()}, ts, lrs,
                                torch.as_tensor(mask))
    assert ts.step == int(js.step) == 5
    for k in params:
        for t, j in ((tp[k], jp[k]), (ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-12, err_msg=k)
        np.testing.assert_array_equal(tp[k].numpy()[~mask], params[k][~mask])
        assert (ts.m[k].numpy()[~mask] == 0).all()


def _random_map(seed=4, C=96):
    rng = np.random.default_rng(seed)
    d = {k: rng.normal(size=(C,) + s).astype(np.float32)
         for k, s in _SHAPES.items()}
    d["log_scaling"] = rng.uniform(-5, -1, (C, 3)).astype(np.float32)
    d["opacity_logit"] = rng.uniform(-7, 2, (C, 1)).astype(np.float32)
    d.update(trackable=rng.random(C) > 0.5, live=rng.random(C) > 0.2,
             n=np.int32(C - 5))
    return d


def test_prune_and_with_params_match_jax():
    d = _random_map()
    jm = jgm.GaussianMap(**{k: jnp.asarray(v) for k, v in d.items()})
    tm = convert.map_from_numpy(d, device="cpu")
    for extent in (None, 2.5, 0.5):
        jp = jgm.prune_large_and_transparent(jm, 0.05, extent)
        tp = tgm.prune_large_and_transparent(tm, 0.05, extent)
        np.testing.assert_array_equal(tp.live.numpy(), np.asarray(jp.live))
        assert tp.live.sum() < tm.live.sum()
    new = _random_map(seed=5)
    jw = jgm.with_params(jm, {k: jnp.asarray(new[k]) for k in _SHAPES})
    tw = tgm.with_params(tm, {k: torch.as_tensor(new[k]) for k in _SHAPES})
    for k in jgm.GaussianMap._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tw, k)),
                                      np.asarray(getattr(jw, k)), err_msg=k)


# ------------------------------------------------------ engine runs ------

def _cfg(case: str):
    seq = j_open_dataset("synthetic", width=W, height=H, num_frames=FRAMES)
    cfg = j_synthetic_config(seq.intr, downsample_rate=4, capacity=1 << 14,
                             target_capacity=1 << 12,
                             visible_capacity=1 << 12)
    render = dict(composite_chunk=12, max_per_tile=256)
    engine = dict(mapping_iters_per_frame=2, mapping_iters_final=0)
    mapc = {}
    if case == "prune_final":
        # pruning every 3rd iteration with an extent that removes the
        # largest splats, 4 final iterations, and a visible cap below the
        # map size, so that the cap-drop stats are non-zero
        engine["mapping_iters_final"] = 4
        mapc = dict(prune_interval=3, prune_extent=0.35)
        render["visible_capacity"] = 1 << 10
    return seq, cfg.replace(
        render=dataclasses.replace(cfg.render, **render),
        engine=dataclasses.replace(cfg.engine, **engine),
        map=dataclasses.replace(cfg.map, **mapc))


@functools.lru_cache(maxsize=None)
def _run(case: str):
    """Both engines' runs of one case, once per test process."""
    jseq, jcfg = _cfg(case)
    jeng = JEngine(jseq, jcfg)
    jres = jeng.run(eval_render=True)
    tseq = t_open_dataset("synthetic", width=W, height=H, num_frames=FRAMES)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    teng = TEngine(tseq, tcfg, device="cpu")
    tres = teng.run(eval_render=True)
    return case, jeng, jres, teng, tres


@pytest.mark.parametrize("case", ["per_frame", "prune_final"])
def test_mapping_run_matches_jax(case):
    """The slice as a whole: one test per run, so that a test worker runs
    each engine pair once."""
    _, jeng, jres, teng, tres = _run(case)
    np.testing.assert_allclose(tres.poses, jres.poses, atol=1e-4)
    assert abs(tres.ate_rmse - jres.ate_rmse) < 1e-4
    assert tres.num_gaussians == jres.num_gaussians
    assert (tres.kf_total, tres.kf_stored) == (jres.kf_total, jres.kf_stored)
    assert teng.gmap.n == int(jeng.gmap.n)
    assert teng.train_iter == jeng.train_iter == (
        FRAMES * 2 + (4 if case == "prune_final" else 0))
    assert teng.adam.step == int(jeng.adam.step) == teng.train_iter
    live = teng.gmap.live.numpy()
    np.testing.assert_array_equal(live, np.asarray(jeng.gmap.live))
    if case == "prune_final":  # pruning removed some splats
        assert 0 < live.sum() < teng.gmap.n
    assert np.isfinite(tres.per_frame_psnr).all()
    np.testing.assert_allclose(tres.per_frame_psnr, jres.per_frame_psnr,
                               atol=0.05)
    # the cap-drop stats come from the mapping steps on both sides (not
    # the evaluation renders): equal, and non-zero where the visible cap
    # is below the map size
    assert (tres.vis_cap_dropped, tres.tile_cap_dropped) == (
        jres.vis_cap_dropped, jres.tile_cap_dropped)
    assert (tres.vis_cap_dropped > 0) == (case == "prune_final")


def test_opt_step_from_identical_state():
    """One opt step on both sides from the same map, Adam state and
    keyframe (the JAX per-frame run's final state, carried across with
    convert)."""
    _, jeng, _, teng, _ = _run("per_frame")
    jcfg, tcfg = jeng.cfg, teng.cfg
    jparams = jgm.map_params(jeng.gmap)
    live = jeng.gmap.live
    kf = jeng.kf_count - 1
    view = (jnp.asarray(jeng.kf_w2c[kf]), jnp.asarray(jeng.kf_rgb[kf]),
            jnp.asarray(jeng.kf_depth[kf]))
    jprim = j_make_prims(jcfg, None)
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jprim.opt_loss(p, live, *view), has_aux=True))(jparams)
    jnew, jadam = jopt.adam_step(jparams, jgrads, jeng.adam,
                                 jopt.map_lr_tree(jcfg.opt), live)

    tm = convert.map_from_numpy(
        {f: np.asarray(getattr(jeng.gmap, f)) for f in jeng.gmap._fields},
        device="cpu")
    tadam = convert.adam_from_numpy(
        {"m": {k: np.asarray(v) for k, v in jeng.adam.m.items()},
         "v": {k: np.asarray(v) for k, v in jeng.adam.v.items()},
         "step": np.asarray(jeng.adam.step)}, device="cpu")
    assert tadam.step == int(jeng.adam.step) > 0
    tview = [torch.as_tensor(np.array(a)) for a in view]
    tprim = t_make_prims(tcfg, device="cpu")
    leaves = {k: p.clone().requires_grad_(True)
              for k, p in tgm.map_params(tm).items()}
    tloss, tstats = tprim.opt_loss(leaves, tm.live, *tview)
    tloss.backward()
    tnew, tadam2, tloss2, _ = tprim.opt_step(tgm.map_params(tm), tadam,
                                             tm.live, *tview)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(tloss2) == float(tloss)
    np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats))
    assert tadam2.step == int(jadam.step)
    lrs = jopt.map_lr_tree(jcfg.opt)
    for k in jparams:
        jg = np.asarray(jgrads[k])
        tg = leaves[k].grad
        tg = np.zeros_like(jg) if tg is None else tg.numpy()
        if jg.size == 0:  # f_rest at SH degree 0
            continue
        gmax = np.abs(jg).max()
        np.testing.assert_allclose(tg / gmax, jg / gmax, atol=1e-4,
                                   err_msg=k)
        dp = np.abs(tnew[k].numpy() - np.asarray(jnew[k]))
        assert dp.max() <= 1e-3 * lrs[k], (k, dp.max() / lrs[k])
