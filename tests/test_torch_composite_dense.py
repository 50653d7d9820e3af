"""PyTorch port: the dense tile compositors K4a (`make_composite`) and K4b
(`make_composite_dyn`) against the JAX package's Pallas kernels, run in
interpret mode on the CPU as the JAX package's own tests run them.

Inputs are made with numpy from a seed as scripts/tpu_kernel_smoke.py
makes them (T = 6 tiles of 16x16, K = 128), plus a zero-opacity tile and
counts 0, K and non-multiples of 32.  Tolerances, and why:
  * outputs atol 1e-5 (rgb and transmittance in [0, 1]; depth relative to
    its largest value): the Pallas kernels take the transmittance as
    exp(cumsum(log1p(-alpha))), the port as a running product;
  * gradients: each attribute row within 2e-4 of the row's largest
    |JAX gradient| (the same terms, the suffix sums in another order).
The K4b contract: splats past counts[t] are ignored and get zero gradient
(`make_composite_dyn`'s docstring).  The Pallas kernel runs whole 32-splat
blocks, so it also blends slots [counts[t], ceil(counts[t] / 32) * 32);
the port follows the docstring, and agrees with the Pallas kernel where
that tail is zero.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.ops import composite_pallas as jcp
from gs_icp_slam_torch.ops import composite_cuda as tcc

T, NTX, TILE, K = 6, 3, 16, 128
P = TILE * TILE
COUNTS = np.array([0, K, 5, 33, 100, 64], np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attrs(seed=1, zero_tail=False):
    rng = np.random.default_rng(seed)
    a = np.zeros((T, 16, K), np.float32)
    a[:, 0] = rng.uniform(0, NTX * TILE, (T, K))
    a[:, 1] = rng.uniform(0, (T // NTX) * TILE, (T, K))
    a[:, 2] = 0.05
    a[:, 4] = 0.05
    a[:, 5:8] = rng.uniform(0, 1, (T, 3, K))
    a[:, 8] = rng.uniform(0.1, 0.9, (T, K))
    a[:, 9] = rng.uniform(0.5, 5.0, (T, K))
    a[1, 8, ::3] = 0.0  # zero-opacity splats in the full tile
    if zero_tail:
        for t, c in enumerate(COUNTS):
            a[t, :, c:] = 0.0
    return a


def _cotangent(seed=2):
    g = np.random.default_rng(seed).normal(size=(T, 8, P)).astype(np.float32)
    g[:, 5:] = 0.0
    return g


@functools.lru_cache(maxsize=None)
def _jax(kind: str, zero_tail: bool):
    """(out, grad of sum(out * g)) of the Pallas kernel, interpret mode."""
    attrs, g = jnp.asarray(_attrs(zero_tail=zero_tail)), jnp.asarray(
        _cotangent())
    if kind == "dense":
        comp = jcp.make_composite(T, NTX, TILE, K, interpret=True)
        f = comp
    else:
        comp = jcp.make_composite_dyn(T, NTX, TILE, K, interpret=True)
        counts = jnp.asarray(COUNTS)

        def f(a):
            return comp(counts, a)

    out, vjp = jax.vjp(f, attrs)
    return np.asarray(out), np.asarray(vjp(g)[0])


def _torch(kind: str, zero_tail: bool):
    attrs = torch.tensor(_attrs(zero_tail=zero_tail), requires_grad=True)
    if kind == "dense":
        out = tcc.make_composite(T, NTX, TILE, K)(attrs)
    else:
        out = tcc.make_composite_dyn(T, NTX, TILE, K)(
            torch.as_tensor(COUNTS), attrs)
    (out * torch.as_tensor(_cotangent())).sum().backward()
    return out.detach().numpy(), attrs.grad.numpy()


def _close_out(got, want):
    for rows in ([0, 1, 2, 4], [3]):
        scale = max(np.abs(want[:, rows]).max(), 1.0)
        np.testing.assert_allclose(got[:, rows] / scale, want[:, rows] / scale,
                                   atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[:, 5:], 0.0)


def _close_grad(got, want):
    assert np.abs(want[:, :10]).max() > 0
    for c in range(10):
        scale = max(np.abs(want[:, c]).max(), 1e-30)
        err = np.abs(got[:, c] - want[:, c]).max() / scale
        assert err <= 2e-4, (c, err)
    np.testing.assert_array_equal(got[:, 10:], 0.0)


@pytest.mark.parametrize("kind", ["dense", "dyn"])
def test_composite_matches_jax(kind):
    """K4a on random blocks; K4b where the data past counts[t] is zero
    (there the Pallas kernel computes the documented function)."""
    zero_tail = kind == "dyn"
    jout, jgrad = _jax(kind, zero_tail)
    tout, tgrad = _torch(kind, zero_tail)
    _close_out(tout, jout)
    _close_grad(tgrad, jgrad)


def test_dyn_ignores_the_tail():
    """K4b: the data past counts[t] changes no output and gets no
    gradient; with counts = K the tile is K4a's."""
    out_r, grad_r = _torch("dyn", zero_tail=False)
    out_z, grad_z = _torch("dyn", zero_tail=True)
    np.testing.assert_array_equal(out_r, out_z)
    np.testing.assert_array_equal(grad_r, grad_z)
    for t, c in enumerate(COUNTS):
        assert (grad_r[t, :, c:] == 0).all()
    np.testing.assert_array_equal(out_r[0, 4], 1.0)   # counts 0: empty tile
    np.testing.assert_array_equal(out_r[0, :4], 0.0)
    out_d, grad_d = _torch("dense", zero_tail=False)
    np.testing.assert_array_equal(out_r[1], out_d[1])
    np.testing.assert_array_equal(grad_r[1], grad_d[1])


def test_pallas_dyn_blends_its_block_tail():
    """The reference's difference, pinned: with data past counts[t], the
    Pallas K4b output moves on the tiles whose counts are not multiples of
    32 (5, 33, 100), and no other."""
    out_r, _ = _jax("dyn", zero_tail=False)
    out_z, _ = _jax("dyn", zero_tail=True)
    moved = np.abs(out_r - out_z).reshape(T, -1).max(1)
    assert (moved[COUNTS % 32 != 0] > 1e-3).all()
    np.testing.assert_array_equal(moved[COUNTS % 32 == 0], 0.0)


def test_work_counts():
    attrs = torch.as_tensor(_attrs(zero_tail=True))
    counts = torch.as_tensor(COUNTS)
    ex_dyn = tcc.composite_dense_work(counts, attrs, NTX, TILE)
    ex_dense = tcc.composite_dense_work(None, attrs, NTX, TILE)
    # every pixel of a non-empty tile examines at least one splat
    assert 5 * P <= ex_dyn <= ex_dense <= T * P * K
    out, nc = tcc.composite_dense_fwd(counts, attrs, NTX, TILE)
    walked, blended = tcc.composite_dense_bwd_work(
        counts, attrs, out, nc, torch.as_tensor(_cotangent()), NTX, TILE)
    assert walked == int(nc.sum()) and 0 < blended <= walked


@pytest.mark.parametrize("bad", ["shape", "dtype", "tile"])
def test_entry_points_check_their_inputs(bad):
    attrs = torch.as_tensor(_attrs())
    if bad == "shape":
        with pytest.raises(ValueError):
            tcc.make_composite(T, NTX, TILE, K // 2)(attrs)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            tcc.make_composite_dyn(T, NTX, TILE, K)(
                torch.as_tensor(COUNTS, dtype=torch.int64), attrs)
    else:
        with pytest.raises(ValueError):
            tcc.composite_dense_fwd(None, attrs, NTX, 64)
