"""PyTorch port: map maintenance (`compact`, `densify_clone_split`,
`covariance_3d`) against the JAX package, on tests/test_densify_knn3.py's
maps (64 Gaussians in a 256-slot map, scales 0.001 / 0.01 / 0.5), and the
synthetic sequence's noisy depth.

The split noise is JAX's: `jax.random.normal(key, (2, max_new, 3))`, the
draw the JAX function makes, handed to the port's
`densify_clone_split_with_noise`.  Tolerances: compact and clone exact
(permutations and copies); split within 1e-6 (a Cholesky factor and a
3x3 product in float32); covariance_3d within 1e-6 of the largest entry
(a few float32 ulps: the einsum's products summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.datasets import open_dataset as j_open_dataset
from gs_icp_slam_tpu.models import gaussian_map as jgm
from gs_icp_slam_tpu.ops.projection import covariance_3d as j_cov3d
from gs_icp_slam_torch import convert
from gs_icp_slam_torch.datasets import open_dataset as t_open_dataset
from gs_icp_slam_torch.models import gaussian_map as tgm
from gs_icp_slam_torch.ops.projection import covariance_3d as t_cov3d


def _populated(n=64, cap=256, seed=0, scale=0.01):
    """tests/test_densify_knn3.py's map."""
    rng = np.random.default_rng(seed)
    m = jgm.empty_map(cap, 0)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    quat = np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1))
    scl = np.full((n, 3), scale, np.float32)
    z = np.ones((n,), np.float32)
    ones = jnp.ones((n,), bool)
    return jgm.add_gaussians(m, jnp.asarray(pts), jnp.asarray(cols),
                             jnp.asarray(quat), jnp.asarray(scl),
                             jnp.asarray(z), ones, ones)


def _to_torch(m):
    return convert.map_from_numpy(
        {f: np.asarray(getattr(m, f)) for f in m._fields}, device="cpu")


def _assert_maps_equal(t, j, atol=0.0):
    assert t.n == int(j.n)
    for f in j._fields:
        if f == "n":
            continue
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=0,
                                   atol=atol, err_msg=f)


@pytest.mark.parametrize("scale", [0.001, 0.01, 0.5])
def test_compact_with_adam_trees_matches_jax(scale):
    m = _populated(scale=scale)
    rng = np.random.default_rng(3)
    kill = rng.uniform(size=m.capacity) < 0.3
    m = m._replace(live=m.live & ~jnp.asarray(kill))
    moments = [{k: rng.normal(size=v.shape).astype(np.float32)
                for k, v in jgm.map_params(m).items()} for _ in range(2)]
    j_out, (j_m, j_v) = jgm.compact(m, extra_trees=[(
        {k: jnp.asarray(v) for k, v in moments[0].items()},
        {k: jnp.asarray(v) for k, v in moments[1].items()})])
    t_out, (t_m, t_v) = tgm.compact(_to_torch(m), extra_trees=[(
        {k: torch.as_tensor(v) for k, v in moments[0].items()},
        {k: torch.as_tensor(v) for k, v in moments[1].items()})])
    _assert_maps_equal(t_out, j_out)
    assert t_out.n == int(m.num_live) < int(m.n)
    for t_tree, j_tree in ((t_m, j_m), (t_v, j_v)):
        for k in j_tree:
            np.testing.assert_array_equal(t_tree[k].numpy(),
                                          np.asarray(j_tree[k]))
    assert tgm.compact(_to_torch(m)).n == t_out.n  # no extra trees


@pytest.mark.parametrize("case", ["clone", "split", "no_trigger"])
def test_densify_clone_split_matches_jax(case):
    """tests/test_densify_knn3.py's three cases, with JAX's noise."""
    scale, hot, seed, max_new = {"clone": (0.001, 8, 0, 32),
                                 "split": (0.5, 4, 1, 32),
                                 "no_trigger": (0.01, 0, 2, 4096)}[case]
    m = _populated(scale=scale)
    grad = jnp.zeros((m.capacity,)).at[:hot].set(1.0)
    key = jax.random.PRNGKey(seed)
    j_out = jgm.densify_clone_split(m, grad, extent=1.0, rng=key,
                                    max_new=max_new)
    eps = jax.random.normal(key, (2, min(max_new, m.capacity), 3))
    t_in = _to_torch(m)
    t_out = tgm.densify_clone_split_with_noise(
        t_in, torch.as_tensor(np.array(grad)), 1.0,
        torch.as_tensor(np.array(eps)), max_new=max_new)
    _assert_maps_equal(t_out, j_out, atol=1e-6 if case == "split" else 0.0)
    assert t_out.num_live == int(j_out.num_live) == {
        "clone": 72, "split": 68, "no_trigger": 64}[case]
    _assert_maps_equal(t_in, m)  # the input map is left as it was


def test_densify_clone_split_draws_its_noise():
    """The public function draws its noise from the generator given: the
    same generator seed, the same map; a split moves the samples."""
    m = _to_torch(_populated(scale=0.5))
    grad = torch.zeros(m.capacity)
    grad[:4] = 1.0
    outs = [tgm.densify_clone_split(m, grad, 1.0,
                                    torch.Generator().manual_seed(s),
                                    max_new=32) for s in (5, 5, 6)]
    np.testing.assert_array_equal(outs[0].xyz.numpy(), outs[1].xyz.numpy())
    assert not np.array_equal(outs[0].xyz.numpy(), outs[2].xyz.numpy())
    assert outs[0].num_live == 68 and not bool(outs[0].live[0])


def test_covariance_3d_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(100, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.5, (100, 3)).astype(np.float32)
    want = np.asarray(j_cov3d(jnp.asarray(q), jnp.asarray(s)))
    got = t_cov3d(torch.as_tensor(q), torch.as_tensor(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(got, got.transpose(0, 2, 1), atol=1e-8)


def test_inverse_sigmoid():
    x = torch.tensor([0.1, 0.5, 0.9])
    np.testing.assert_allclose(torch.sigmoid(tgm.inverse_sigmoid(x)).numpy(),
                               x.numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        tgm.inverse_sigmoid(x).numpy(),
        np.asarray(jgm.inverse_sigmoid(jnp.asarray(x.numpy()))), rtol=1e-6)


def test_synthetic_noisy_depth_same_bits():
    """The stress tier's depth noise (noise_depth 0.01): the port's frames
    equal the JAX dataset's bit for bit."""
    kw = dict(width=96, height=72, num_frames=3, noise_depth=0.01,
              angular_step=0.08)
    jseq = j_open_dataset("synthetic", **kw)
    tseq = t_open_dataset("synthetic", **kw)
    for i in range(3):
        a, b = jseq[i], tseq[i]
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(a.rgb, b.rgb)
        np.testing.assert_array_equal(a.gt_c2w, b.gt_c2w)
    assert not np.array_equal(tseq[0].depth, t_open_dataset(
        "synthetic", width=96, height=72, num_frames=1)[0].depth)
