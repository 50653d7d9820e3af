"""PyTorch port: math utilities, covariances and the nearest-neighbour
kernels K2/K3, held against the JAX package on the same numpy inputs.

Tolerances: float32 elementwise math that follows the JAX code op for op is
held at rtol/atol 1e-5 (1e-4 after a transcendental or a 3x3 solve, where
the two libraries' libm results and summation orders differ by a few ulp).
The K2/K3 plain versions and the Pallas kernels compute the same direct
(q - r)^2 distance, so indices are exact and distances agree to rtol 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.ops import covariance as jcov
from gs_icp_slam_tpu.ops import eigh3 as jeig
from gs_icp_slam_tpu.ops import knn as jknn
from gs_icp_slam_tpu.ops import nn_pallas as jnn
from gs_icp_slam_tpu.utils import pointcloud as jpc
from gs_icp_slam_tpu.utils import quat as jq
from gs_icp_slam_tpu.utils import se3 as jse3
from gs_icp_slam_tpu.utils import sh as jsh
from gs_icp_slam_torch.ops import covariance as tcov
from gs_icp_slam_torch.ops import eigh3 as teig
from gs_icp_slam_torch.ops import knn as tknn
from gs_icp_slam_torch.ops import nn_cuda
from gs_icp_slam_torch.utils import pointcloud as tpc
from gs_icp_slam_torch.utils import quat as tq
from gs_icp_slam_torch.utils import se3 as tse3
from gs_icp_slam_torch.utils import sh as tsh


def J(fn, *a):
    return np.asarray(fn(*[jnp.asarray(x) for x in a]))


def T(fn, *a):
    out = fn(*[torch.as_tensor(np.array(x)) for x in a])
    return out.numpy() if isinstance(out, torch.Tensor) else out


def random_spd(n, seed=0, aniso=10.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = rng.uniform(0.1, aniso, size=(n, 3))
    return np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)


def planar_cov(n, seed=3):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = np.stack([rng.uniform(0.5, 1.5, n), rng.uniform(0.5, 1.5, n),
                    rng.uniform(1e-4, 1e-2, n)], axis=-1)
    return np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)


# ------------------------------------------------------------- utils -----

@pytest.mark.parametrize("fn", ["quat_normalize", "quat_to_rotmat",
                                "quat_multiply", "rotmat_to_quat"])
def test_quat(fn):
    rng = np.random.default_rng(1)
    q1 = rng.normal(size=(64, 4)).astype(np.float32)
    q2 = rng.normal(size=(64, 4)).astype(np.float32)
    if fn == "quat_multiply":
        args = (q1, q2)
    elif fn == "rotmat_to_quat":
        args = (J(jq.quat_to_rotmat, q1),)
    else:
        args = (q1,)
    np.testing.assert_allclose(T(getattr(tq, fn), *args),
                               J(getattr(jq, fn), *args),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", ["skew", "so3_exp", "se3_exp",
                                "invert_se3", "transform_points"])
def test_se3(fn):
    rng = np.random.default_rng(2)
    xi = rng.normal(scale=0.3, size=(6,)).astype(np.float32)
    Tm = J(jse3.se3_exp, xi)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    args = {"skew": (xi[:3],), "so3_exp": (xi[:3],), "se3_exp": (xi,),
            "invert_se3": (Tm,), "transform_points": (Tm, pts)}[fn]
    np.testing.assert_allclose(T(getattr(tse3, fn), *args),
                               J(getattr(jse3, fn), *args),
                               rtol=1e-5, atol=1e-6)


def test_se3_small_angle_branch():
    xi = np.array([1e-8, -2e-8, 0.0, 0.1, 0.2, -0.3], np.float32)
    np.testing.assert_allclose(T(tse3.se3_exp, xi), J(jse3.se3_exp, xi),
                               atol=1e-7)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(40, 3, (deg + 1) ** 2)).astype(np.float32)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(tsh.eval_sh(deg, torch.as_tensor(sh),
                                           torch.as_tensor(d)).numpy(),
                               np.asarray(jsh.eval_sh(deg, jnp.asarray(sh),
                                                      jnp.asarray(d))),
                               rtol=1e-5, atol=1e-5)


def test_rgb_sh_roundtrip():
    rgb = np.random.default_rng(0).uniform(size=(20, 3)).astype(np.float32)
    np.testing.assert_allclose(T(tsh.rgb_to_sh, rgb), J(jsh.rgb_to_sh, rgb),
                               rtol=1e-6)
    np.testing.assert_allclose(T(tsh.sh_to_rgb, T(tsh.rgb_to_sh, rgb)), rgb,
                               atol=1e-6)


def test_pointcloud():
    W, H, rate = 64, 48, 4
    jf = jpc.make_downsample_filter(W, H, 40.0, 41.0, 31.5, 23.5, rate)
    tf = tpc.make_downsample_filter(W, H, 40.0, 41.0, 31.5, 23.5, rate)
    for f in ("flat_idxs", "x_pre", "y_pre"):
        np.testing.assert_array_equal(getattr(jf, f), getattr(tf, f))
    assert (jf.gh, jf.gw) == (tf.gh, tf.gw)
    rng = np.random.default_rng(0)
    depth = rng.uniform(0, 9000, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.2] = 0.0
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    jo = jpc.downsample_pointcloud(jf, jnp.asarray(depth), jnp.asarray(rgb),
                                   1000.0, 8.0)
    to = tpc.downsample_pointcloud(tf, torch.as_tensor(depth),
                                   torch.as_tensor(rgb), 1000.0, 8.0)
    for k in jo:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   rtol=1e-6, atol=1e-7)


# ------------------------------------------------------ eigh3, cov -------

@pytest.mark.parametrize("kind", ["random", "planar", "isotropic"])
def test_eigh3(kind):
    C = {"random": random_spd(200), "planar": planar_cov(200),
         "isotropic": np.broadcast_to(2.5 * np.eye(3, dtype=np.float32),
                                      (4, 3, 3)).copy()}[kind]
    jv, jV = (np.asarray(x) for x in jeig.eigh3x3(jnp.asarray(C)))
    tv, tV = (x.numpy() for x in teig.eigh3x3(torch.as_tensor(C)))
    # eigenvalues as tests/test_ops.py holds them against LAPACK
    np.testing.assert_allclose(tv, jv, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(T(teig.eigvals3x3, C), J(jeig.eigvals3x3, C),
                               rtol=2e-4, atol=2e-4)
    # eigenvectors: a right-handed basis that reconstructs C (as
    # tests/test_ops.py holds the JAX one), equal to the JAX columns,
    # order and sign (they seed the map's quaternions) in >= 99% of the
    # matrices.  The rest sit at a near tie that last-ulp differences
    # between the two libraries decide: the cross-product selection in
    # _null_vector, or two nearly equal eigenvalues whose eigenvectors
    # are ill-conditioned.
    rec = np.einsum("nij,nj,nkj->nik", tV, tv, tV)
    np.testing.assert_allclose(rec, C, rtol=5e-3, atol=5e-3)
    assert (np.linalg.det(tV) > 0.9).all()
    same = np.abs(tV - jV).max(axis=(1, 2)) < 2e-3
    assert same.mean() >= 0.99, same.mean()


def _cloud(n=400, seed=0):
    """A noisy two-plane corner: neighbourhoods with a clear normal."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (n // 2, 2))
    p1 = np.stack([a[:, 0], a[:, 1], 0.01 * rng.normal(size=n // 2)], 1)
    p2 = np.stack([a[:, 0], 0.01 * rng.normal(size=n // 2), a[:, 1] + 1.2], 1)
    return np.concatenate([p1, p2]).astype(np.float32)


@pytest.mark.parametrize("max_dist", [None, 0.3])
def test_estimate_covariances(max_dist):
    pts = _cloud()
    valid = np.ones(len(pts), bool)
    valid[::9] = False
    idx, sqd = jknn.knn_search(jnp.asarray(pts), jnp.asarray(pts),
                               jnp.asarray(valid), k=10)
    idx, sqd = np.asarray(idx), np.asarray(sqd)
    jc = np.asarray(jcov.estimate_covariances(
        jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(valid),
        jnp.asarray(sqd), max_dist))
    tc = tcov.estimate_covariances(
        torch.as_tensor(pts), torch.as_tensor(idx), torch.as_tensor(valid),
        torch.as_tensor(sqd), max_dist).numpy()
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-7)


def test_covariance_bridge():
    C = planar_cov(300, seed=5)
    jq_, js = (np.asarray(x) for x in jcov.cov_to_quat_scale(jnp.asarray(C)))
    tq_, ts = (x.numpy() for x in tcov.cov_to_quat_scale(torch.as_tensor(C)))
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tq_, jq_, atol=2e-3)
    np.testing.assert_allclose(T(tcov.regularize_plane, C),
                               J(jcov.regularize_plane, C), atol=2e-4)
    np.testing.assert_allclose(T(tcov.quat_scale_to_cov, jq_, js),
                               J(jcov.quat_scale_to_cov, jq_, js),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(T(tcov.quat_scale_to_reg_cov6, jq_, js),
                               J(jcov.quat_scale_to_reg_cov6, jq_, js),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------- K2 and K3 (plain) ----

@pytest.fixture(scope="module")
def nn_case():
    """~300 queries x 4096 refs with 30% invalid refs, exact ties planted."""
    rng = np.random.default_rng(11)
    R = 4096
    ref = rng.normal(size=(R, 3)).astype(np.float32)
    ref[100] = ref[50]          # duplicate points: equal distances
    ref[3000] = ref[50]
    valid = rng.random(R) > 0.3
    valid[[50, 100, 3000]] = True
    q = rng.normal(size=(300, 3)).astype(np.float32)
    q[:5] = ref[50] + 1e-3
    return q, ref, valid


def test_nn1_plain_matches_pallas(nn_case):
    q, ref, valid = nn_case
    rT = np.ascontiguousarray(ref.T)
    bias = np.where(valid, 0.0, 3.4e38).astype(np.float32)[None]
    ji, jd = (np.asarray(x) for x in jnn.nn_search_pre(
        jnp.asarray(q), jnp.asarray(rT), jnp.asarray(bias), interpret=True))
    ti, td = nn_cuda.nn_search_pre(torch.as_tensor(q), torch.as_tensor(rT),
                                   torch.as_tensor(bias))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6)
    assert (ti.numpy()[:5] == 50).all()  # lowest index of the tie


def test_nn1_plain_no_valid_ref():
    q = np.ones((4, 3), np.float32)
    rT = np.zeros((3, 64), np.float32)
    bias = np.full((1, 64), 3.4e38, np.float32)
    ji, jd = jnn.nn_search_pre(jnp.asarray(q), jnp.asarray(rT),
                               jnp.asarray(bias), br=64, interpret=True)
    ti, td = nn_cuda.nn_search_pre(torch.as_tensor(q), torch.as_tensor(rT),
                                   torch.as_tensor(bias))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("k", [4, 20])
def test_knn_plain_matches_pallas(nn_case, k):
    q, ref, valid = nn_case
    ji, jd = (np.asarray(x) for x in jnn.knn_search_pallas(
        jnp.asarray(q), jnp.asarray(ref), jnp.asarray(valid), k=k,
        interpret=True))
    ti, td = nn_cuda.knn_search_kernel(torch.as_tensor(q),
                                       torch.as_tensor(ref),
                                       torch.as_tensor(valid), k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6)


def test_knn_plain_missing_neighbours():
    """Fewer valid refs than k: distances 3.4e38; indices compared only
    where a neighbour exists (elsewhere unspecified)."""
    rng = np.random.default_rng(4)
    ref = rng.normal(size=(64, 3)).astype(np.float32)
    valid = np.zeros(64, bool)
    valid[[3, 9, 40]] = True
    q = ref[:10].copy()
    ji, jd = (np.asarray(x) for x in jnn.knn_search_pallas(
        jnp.asarray(q), jnp.asarray(ref), jnp.asarray(valid), k=6,
        interpret=True))
    ti, td = (x.numpy() for x in nn_cuda.knn_search_kernel(
        torch.as_tensor(q), torch.as_tensor(ref), torch.as_tensor(valid), 6))
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    have = jd < 1e37
    np.testing.assert_array_equal(ti[have], ji[have])
    assert (td[:, 3:] == np.float32(3.4e38)).all()


def test_knn_k40_matches_jax_knn_search(nn_case):
    """k above 32 (K3 on the card runs it in passes of 32): the plain path
    against the JAX knn_search, which on the CPU takes its XLA path, the
    |q|^2 - 2 q.r + |r|^2 form.  That form rounds otherwise, so distances
    agree to atol 1e-5 (|q|^2 ~ 10 at float32), and each column's
    neighbours to that tolerance in their float64 distance (a near tie may
    swap two indices)."""
    q, ref, valid = nn_case
    ji, jd = (np.asarray(x) for x in jknn.knn_search(
        jnp.asarray(q), jnp.asarray(ref), jnp.asarray(valid), k=40))
    ti, td = (x.numpy() for x in nn_cuda.knn_search_kernel(
        torch.as_tensor(q), torch.as_tensor(ref), torch.as_tensor(valid),
        40))
    assert ti.shape == ji.shape == (300, 40)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)
    d64 = ((q[:, None].astype(np.float64) - ref[None]) ** 2).sum(-1)
    rows = np.arange(300)[:, None]
    np.testing.assert_allclose(d64[rows, ti], d64[rows, ji], rtol=0,
                               atol=1e-5)
    assert valid[ti].all()
    assert (ti == ji).mean() > 0.99


def test_knn_k100_matches_float64():
    """k = 100 on the plain path: the 100 nearest valid references by a
    float64 sort, distances to rtol 1e-5, indices exact off near ties."""
    rng = np.random.default_rng(12)
    ref = rng.normal(size=(1500, 3)).astype(np.float32)
    valid = rng.random(1500) > 0.3
    q = rng.normal(size=(64, 3)).astype(np.float32)
    ti, td = (x.numpy() for x in nn_cuda.knn_search_kernel(
        torch.as_tensor(q), torch.as_tensor(ref), torch.as_tensor(valid),
        100))
    d64 = ((q[:, None].astype(np.float64) - ref[None]) ** 2).sum(-1)
    d64[:, ~valid] = np.inf
    want = np.sort(d64, 1)[:, :100]
    np.testing.assert_allclose(td, want, rtol=1e-5)
    np.testing.assert_allclose(d64[np.arange(64)[:, None], ti], want,
                               rtol=1e-5)


def test_nn_and_knn_search_entry_points(nn_case):
    q, ref, valid = nn_case
    d2 = ((q[:, None].astype(np.float64) - ref[None]) ** 2).sum(-1)
    d2[:, ~valid] = np.inf
    ti, td = tknn.nn_search(torch.as_tensor(q), torch.as_tensor(ref),
                            torch.as_tensor(valid))
    np.testing.assert_array_equal(ti.numpy(), d2.argmin(1))
    np.testing.assert_allclose(td.numpy(), d2.min(1), rtol=1e-5)
    ki, kd = tknn.knn_search(torch.as_tensor(q), torch.as_tensor(ref),
                             torch.as_tensor(valid), k=8)
    np.testing.assert_allclose(kd.numpy(), np.sort(d2, 1)[:, :8], rtol=1e-5)


def test_mean_sq_dist_3nn():
    pts = _cloud(300, seed=2)
    valid = np.ones(300, bool)
    valid[::7] = False
    np.testing.assert_allclose(T(tknn.mean_sq_dist_3nn, pts, valid),
                               J(jknn.mean_sq_dist_3nn, pts, valid),
                               rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("k,span", [(20, 0), (8, 2)])
def test_knn_search_grid(k, span):
    gh, gw = 12, 16
    rng = np.random.default_rng(k)
    u, v = np.meshgrid(np.arange(gw), np.arange(gh))
    z = 2.0 + 0.05 * rng.normal(size=(gh, gw))
    pts = np.stack([(u - 8) * 0.05 * z, (v - 6) * 0.05 * z, z], -1)
    pts = pts.reshape(-1, 3).astype(np.float32)
    valid = rng.random(gh * gw) > 0.1
    assert tknn.resolve_grid_span(k, span) == jknn.resolve_grid_span(k, span)
    ji, jd = (np.asarray(x) for x in jknn.knn_search_grid(
        jnp.asarray(pts), jnp.asarray(valid), gh, gw, k=k, span=span))
    ti, td = (x.numpy() for x in tknn.knn_search_grid(
        torch.as_tensor(pts), torch.as_tensor(valid), gh, gw, k=k,
        span=span))
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    np.testing.assert_array_equal(ti, ji)
