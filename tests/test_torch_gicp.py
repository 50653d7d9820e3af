"""PyTorch port: G-ICP target/source construction and alignment against
the JAX package on a synthetic 128x96 frame pair.

The JAX side runs its Pallas 1-NN/k-NN in interpret mode (use_pallas=True),
which computes the same direct (q - r)^2 distance as the port's kernels, so
both sides see the same correspondences.  Given the same source and target,
the pose agrees to atol 1e-5 (float32 Gauss-Newton sums taken in another
order) and the iteration count exactly; the frames are away from the
convergence-epsilon edge.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.config import synthetic_config as j_synthetic_config
from gs_icp_slam_tpu.datasets import open_dataset as j_open_dataset
from gs_icp_slam_tpu.ops import gicp as jg
from gs_icp_slam_tpu.utils import pointcloud as jpc
from gs_icp_slam_torch import convert
from gs_icp_slam_torch.ops import gicp as tg

W, H, DS, TCAP = 128, 96, 4, 1 << 12


def _frame_cloud(seq, i, filt):
    fr = seq[i]
    pc = jpc.downsample_pointcloud(filt, jnp.asarray(fr.depth),
                                   jnp.asarray(fr.rgb),
                                   seq.intr.depth_scale, seq.intr.depth_trunc)
    return {k: np.asarray(v) for k, v in pc.items()}, fr.gt_c2w


def _np_target(t):
    return {f: np.asarray(getattr(t, f)) for f in t._fields}


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module", params=["cp", "cv"])
def case(request):
    """Frame 0 -> target; frame 1 (cp: constant-position seed) or frame 2
    (cv: a 4x faster orbit whose constant-velocity seed trips the adaptive
    switch) -> source; JAX results for each stage."""
    step = 0.02 if request.param == "cp" else 0.08
    seq = j_open_dataset("synthetic", width=W, height=H, num_frames=3,
                         angular_step=step)
    cfg = j_synthetic_config(seq.intr, downsample_rate=DS)
    filt = jpc.make_downsample_filter(W, H, seq.intr.fx, seq.intr.fy,
                                      seq.intr.cx, seq.intr.cy, DS)
    pc0, pose0 = _frame_cloud(seq, 0, filt)
    pts_w = (pc0["points"] @ pose0[:3, :3].T + pose0[:3, 3]).astype(np.float32)
    target, quat, scales = jg.target_from_points(
        jnp.asarray(pts_w), jnp.asarray(pc0["trackable"]), cfg.gicp,
        capacity=TCAP, use_pallas=True)
    i = 1 if request.param == "cp" else 2
    pc1, _ = _frame_cloud(seq, i, filt)
    source = jg.make_source(jnp.asarray(pc1["points"]),
                            jnp.asarray(pc1["valid"]), cfg.gicp,
                            trackable=jnp.asarray(pc1["trackable"]),
                            use_pallas=True)
    init = np.asarray(seq[i - 1].gt_c2w, np.float32)
    init2 = None
    if request.param == "cv":
        p0, p1 = seq[0].gt_c2w, seq[1].gt_c2w
        init2 = (p1 @ np.linalg.inv(p0) @ p1).astype(np.float32)
    T, n_it, idx, sqd = jg.gicp_align(
        source, target, jnp.asarray(init), cfg.gicp, use_pallas=True,
        init_T2=None if init2 is None else jnp.asarray(init2))
    return dict(cfg=cfg, pc0=pc0, pts_w=pts_w, pc1=pc1, init=init,
                init2=init2, target=_np_target(target), quat=np.asarray(quat),
                scales=np.asarray(scales),
                source={f: np.asarray(getattr(source, f))
                        for f in source._fields},
                T=np.asarray(T), n_iters=int(n_it), idx=np.asarray(idx),
                sqd=np.asarray(sqd), seq=seq, grid=(filt.gh, filt.gw))


def _same_raw_cov(tq, ts, jq, js):
    """The (quat, scale) pairs that seed Gaussians describe the same raw
    covariance.  Compared as R diag(s^2) R^T: on a near-planar or
    near-isotropic neighbourhood the eigenvectors of the nearly equal
    eigenvalues, and sqrt of the ~0 one, are ill-conditioned; the
    covariance (entries ~1e-3..1e-2 m^2) is not.  atol 1e-6 is 1e-4 of
    the entries: the closed-form eigenvalues carry ~1e-4 relative error
    near a repeated eigenvalue (tests/test_ops.py holds them at 2e-4)."""
    from gs_icp_slam_torch.ops.covariance import quat_scale_to_cov
    got = quat_scale_to_cov(_t(tq), _t(ts)).numpy()
    ref = quat_scale_to_cov(_t(jq), _t(js)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _tcfg(case):
    return convert.config_from_dict(dataclasses.asdict(case["cfg"])).gicp


def test_target_from_points(case):
    t, quat, scales = tg.target_from_points(
        _t(case["pts_w"]), _t(case["pc0"]["trackable"]), _tcfg(case),
        capacity=TCAP)
    jt = case["target"]
    np.testing.assert_array_equal(t.points.numpy(), jt["points"])
    np.testing.assert_array_equal(t.valid.numpy(), jt["valid"])
    np.testing.assert_array_equal(t.nn_bias.numpy(), jt["nn_bias"])
    np.testing.assert_allclose(t.cov6.numpy(), jt["cov6"], atol=2e-4)
    _same_raw_cov(quat, scales, case["quat"], case["scales"])


@pytest.mark.parametrize("knn", ["exact", "grid"])
def test_make_source(case, knn):
    pc = case["pc1"]
    jcfg = dataclasses.replace(case["cfg"].gicp, source_knn=knn)
    grid = case["grid"] if knn == "grid" else None
    js = jg.make_source(jnp.asarray(pc["points"]), jnp.asarray(pc["valid"]),
                        jcfg, trackable=jnp.asarray(pc["trackable"]),
                        grid=grid, use_pallas=True)
    ts = tg.make_source(_t(pc["points"]), _t(pc["valid"]),
                        dataclasses.replace(_tcfg(case), source_knn=knn),
                        trackable=_t(pc["trackable"]), grid=grid)
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_allclose(ts.cov6.numpy(), np.asarray(js.cov6),
                               atol=2e-4)
    _same_raw_cov(ts.quat, ts.scales, js.quat, js.scales)


def test_gicp_align(case):
    src = case["source"]
    source = tg.GICPSource(**{k: _t(v) for k, v in src.items()})
    target = convert.target_from_numpy(case["target"], device="cpu")
    T, n_iters, idx, sqd = tg.gicp_align(
        source, target, _t(case["init"]), _tcfg(case),
        init_T2=None if case["init2"] is None else _t(case["init2"]))
    assert n_iters == case["n_iters"]
    np.testing.assert_allclose(T.numpy(), case["T"], atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), case["idx"])
    np.testing.assert_allclose(sqd.numpy(), case["sqd"], rtol=1e-4,
                               atol=1e-9)
    # and the pose is the right one: within 5 mm of the truth
    gt = case["seq"][2 if case["init2"] is not None else 1].gt_c2w
    assert np.abs(T.numpy()[:3, 3] - gt[:3, 3]).max() < 5e-3


def test_seed_switch(case):
    if case["init2"] is None:
        pytest.skip("the constant-position case has no second seed")
    deg = tg.predicted_rotation_deg(_t(case["init"]), _t(case["init2"]))
    assert float(deg) > case["cfg"].gicp.adaptive_trigger_deg


def test_source_correspondences(case):
    target = convert.target_from_numpy(case["target"], device="cpu")
    pts = case["source"]["points"]
    ji, jd = jg.source_correspondences(jnp.asarray(case["T"]),
                                       jnp.asarray(pts),
                                       jg.GICPTarget(**{
                                           k: jnp.asarray(v) for k, v in
                                           case["target"].items()}),
                                       use_pallas=True)
    ti, td = tg.source_correspondences(_t(case["T"]), _t(pts), target)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-10)


def test_target_from_gaussians_and_empty(case):
    rng = np.random.default_rng(0)
    n = 500
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = rng.uniform(0.01, 0.1, (n, 3)).astype(np.float32)
    v = rng.random(n) > 0.2
    jt = jg.target_from_gaussians(jnp.asarray(xyz), jnp.asarray(q),
                                  jnp.asarray(s), jnp.asarray(v),
                                  case["cfg"].gicp, capacity=TCAP)
    tt = tg.target_from_gaussians(_t(xyz), _t(q), _t(s), _t(v),
                                  _tcfg(case), capacity=TCAP)
    for f in ("points", "valid", "nn_bias"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    np.testing.assert_allclose(tt.cov6.numpy(), np.asarray(jt.cov6),
                               rtol=1e-5, atol=1e-6)
    je, te = jg.empty_target(TCAP), tg.empty_target(TCAP, device="cpu")
    for f in je._fields:  # the port's target adds nn_order, K2's order
        np.testing.assert_array_equal(getattr(te, f).numpy(),
                                      np.asarray(getattr(je, f)))
    assert te.nn_order is None
    # a built target's order: a permutation, valid slots first
    o = tt.nn_order.long()
    assert torch.equal(torch.sort(o).values, torch.arange(TCAP))
    assert tt.valid[o[:int(v.sum())]].all()
