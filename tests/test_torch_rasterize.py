"""PyTorch port: projection, the compositor K1-fwd / K1-bwd and the tiled
rasterizer, forward and gradients, held against the JAX package.

The JAX rasterizer runs its XLA path (use_pallas=False); the compositor's
plain versions are also held against the Pallas kernel and its VJP in
interpret mode.  Tolerances:
  * forward: atol 1e-5 on colour, depth and transmittance: the two sides
    compute the same per-splat terms, but the XLA path takes transmittance
    as a cumprod and colour as a dot product, the port a sequential loop,
    so sums differ in the last ulps (depth ~3 m: 1e-5 is ~3 ulp there);
  * K1-bwd against the Pallas VJP: each attribute row within 2e-4 of that
    row's largest |gradient|.  The port recovers the transmittance before
    a splat by division and sums pixels in another order than the Pallas
    block cumprod and block sums: float32 rounding, ~1e-6 of the row's
    scale measured;
  * rasterize_tiled gradients against jax.grad, the XLA compositor on
    every scene and the Pallas one on the first (its VJP is also held
    against the plain backward above): atol 1e-4 after dividing by the largest |JAX gradient| of the
    parameter (the JAX suite holds Pallas against XLA at 1e-3);
  * the float64 gradcheck of the plain backward: torch's defaults
    (eps 1e-6, atol 1e-5, rtol 1e-3) on splats away from every gate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.ops import projection as jproj
from gs_icp_slam_tpu.ops.composite_pallas import (build_cell_idx_np,
                                                  make_composite_win)
from gs_icp_slam_tpu.ops.rasterize import rasterize_tiled as j_rasterize
from gs_icp_slam_torch.ops import composite_cuda
from gs_icp_slam_torch.ops import projection as tproj
from gs_icp_slam_torch.ops.rasterize import rasterize_tiled as t_rasterize
from gs_icp_slam_torch.ops.rasterize import tile_capacity

W, H = 64, 48
FX = FY = 60.0
CX, CY = (W - 1) / 2.0, (H - 1) / 2.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's plain loops here are many short ops on small tensors:
    intra-op threads only contend with JAX's pool and the other test
    workers (this file ran in 57 s with the default threads, 34 s with
    one, on an 8-core CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(n=64, seed=0, spread=0.8, sh_deg=0):
    """tests/test_rasterize.py's random scene."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 0] = rng.uniform(-spread, spread, n)
    xyz[:, 1] = rng.uniform(-spread * 0.7, spread * 0.7, n)
    xyz[:, 2] = rng.uniform(1.2, 3.0, n)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    scale = rng.uniform(0.02, 0.08, size=(n, 3)).astype(np.float32)
    opacity = rng.uniform(0.3, 0.95, size=(n,)).astype(np.float32)
    sh = rng.uniform(-0.4, 0.4, size=(n, (sh_deg + 1) ** 2, 3)).astype(np.float32)
    live = np.ones((n,), bool)
    return [xyz, quat, scale, opacity, sh, live]


def _pose(kind):
    w2c = np.eye(4, dtype=np.float32)
    if kind == "rotated":
        ang = 0.3
        w2c[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]]
        w2c[:3, 3] = [0.1, -0.05, 0.2]
    return w2c


def _both(scene, w2c, bg=(0.0, 0.0, 0.0), **kw):
    kw.setdefault("tile_span", 7)
    kw.setdefault("tile_cap", 128)
    kw.setdefault("visible_cap", 128)
    bg = np.asarray(bg, np.float32)
    jo = j_rasterize(*[jnp.asarray(a) for a in scene[:5]], jnp.asarray(w2c),
                     jnp.asarray(scene[5]), jnp.asarray(bg), FX, FY, CX, CY,
                     sh_degree=0, width=W, height=H, use_pallas=False,
                     want_used=False, **kw)
    to = t_rasterize(*[torch.as_tensor(a) for a in scene[:5]],
                     torch.as_tensor(w2c), torch.as_tensor(scene[5]),
                     torch.as_tensor(bg), FX, FY, CX, CY, sh_degree=0,
                     width=W, height=H, **kw)
    return jo, to


def _assert_same(jo, to, atol=1e-5):
    np.testing.assert_allclose(to.color.numpy(), np.asarray(jo.color),
                               atol=atol)
    np.testing.assert_allclose(to.depth.numpy(), np.asarray(jo.depth),
                               atol=atol)
    np.testing.assert_allclose(to.t_final.numpy(), np.asarray(jo.t_final),
                               atol=atol)
    np.testing.assert_array_equal(to.radii.numpy(), np.asarray(jo.radii))
    np.testing.assert_array_equal(to.stats.numpy(), np.asarray(jo.stats))


# --------------------------------------------------------- projection ----

@pytest.mark.parametrize("sh_deg,pose", [(0, "identity"), (0, "rotated"),
                                         (2, "rotated")])
def test_project_gaussians_packed(sh_deg, pose):
    xyz, quat, scale, opacity, sh, live = _scene(96, seed=1, sh_deg=sh_deg)
    live[::5] = False
    w2c = _pose(pose)
    args = (xyz, quat, scale, opacity, sh)
    ja, jr, jv = jproj.project_gaussians_packed(
        *[jnp.asarray(a) for a in args], sh_deg, jnp.asarray(w2c), FX, FY,
        CX, CY, W, H, jnp.asarray(live))
    ta, tr, tv = tproj.project_gaussians_packed(
        *[torch.as_tensor(a) for a in args], sh_deg, torch.as_tensor(w2c),
        FX, FY, CX, CY, W, H, torch.as_tensor(live))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-5)


def test_tile_rect():
    rng = np.random.default_rng(3)
    mx = rng.uniform(-40, 140, 500).astype(np.float32)
    my = rng.uniform(-40, 100, 500).astype(np.float32)
    rad = rng.integers(0, 60, 500).astype(np.float32)
    for span in (2, 3, 7):
        j = jproj.tile_rect(jnp.asarray(mx), jnp.asarray(my),
                            jnp.asarray(rad), 4, 3, 32, span)
        t = tproj.tile_rect(torch.as_tensor(mx), torch.as_tensor(my),
                            torch.as_tensor(rad), 4, 3, 32, span)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_constants():
    assert (tproj.ALPHA_MIN, tproj.ALPHA_MAX, tproj.T_EPS) == (
        jproj.ALPHA_MIN, jproj.ALPHA_MAX, jproj.T_EPS)


# ------------------------------------------------------- K1-fwd ----------

@pytest.fixture(scope="module", params=["quick", "saturated"])
def composite_case(request):
    """tests/test_quick.py's compositor inputs (tile 32, 3x2 tiles, K=128,
    V=256) with the JAX Pallas kernel's output in interpret mode; the
    "saturated" variant has wider, more opaque splats, so that most pixels
    stop at the done rule."""
    sat = request.param == "saturated"
    tile, ntx, nty, K, V = 32, 3, 2, 128, 256
    T = ntx * nty
    rng = np.random.default_rng(7)
    counts = rng.integers(8, K, size=(T,)).astype(np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    Np = int(counts.sum()) + K
    pair_slot = rng.integers(0, V, size=(Np,)).astype(np.int32)
    attr = np.zeros((16, V + 1), np.float32)
    attr[0] = rng.uniform(0, ntx * tile, V + 1)
    attr[1] = rng.uniform(0, nty * tile, V + 1)
    lo, hi = (0.001, 0.01) if sat else (0.01, 0.1)
    attr[2] = rng.uniform(lo, hi, V + 1)
    attr[4] = rng.uniform(lo, hi, V + 1)
    attr[3] = 0.2 * np.sqrt(attr[2] * attr[4])
    attr[5:8] = rng.uniform(0, 1, (3, V + 1))
    attr[8] = rng.uniform(0.8, 0.99, V + 1) if sat else rng.uniform(
        0.2, 0.95, V + 1)
    attr[9] = rng.uniform(0.5, 5.0, V + 1)
    attr[:, V] = 0.0
    comp = make_composite_win(T, ntx, tile, K, interpret=True)
    cell_idx = build_cell_idx_np(counts, starts, pair_slot, T, K, V)
    out, vjp = jax.vjp(lambda a: comp(
        jnp.asarray(counts), jnp.asarray(starts), jnp.asarray(pair_slot),
        jnp.asarray(cell_idx), a), jnp.asarray(attr))
    g = np.zeros((T, 8, tile * tile), np.float32)
    g[:, :5] = rng.normal(size=(T, 5, tile * tile))
    return dict(counts=counts, starts=starts, pair_slot=pair_slot,
                attr=attr, ntx=ntx, tile=tile, out=np.asarray(out),
                g=g, d_attr=np.asarray(vjp(jnp.asarray(g))[0]),
                saturated=sat)


def test_composite_plain_matches_pallas(composite_case):
    c = composite_case
    got = composite_cuda.composite_fwd(
        torch.as_tensor(c["counts"]), torch.as_tensor(c["starts"]),
        torch.as_tensor(c["pair_slot"]), torch.as_tensor(c["attr"][:10]),
        c["ntx"], c["tile"])[0].numpy()
    np.testing.assert_allclose(got[:, 0:3], c["out"][:, 0:3], atol=1e-5)
    np.testing.assert_allclose(got[:, 3], c["out"][:, 3], atol=2e-5)
    np.testing.assert_allclose(got[:, 4], c["out"][:, 4], atol=1e-5)
    if c["saturated"]:  # most pixels stop at the done rule
        assert (got[:, 4] < 1e-3).mean() > 0.5


def test_composite_work_count(composite_case):
    c = composite_case
    args = (torch.as_tensor(c["counts"]), torch.as_tensor(c["starts"]),
            torch.as_tensor(c["pair_slot"]), torch.as_tensor(c["attr"]),
            c["ntx"], c["tile"])
    n = composite_cuda.composite_work(*args)
    assert 0 < n <= int(c["counts"].sum()) * c["tile"] ** 2


def test_composite_empty_tiles():
    counts = torch.zeros(4, dtype=torch.int32)
    out, n_contrib = composite_cuda.composite_fwd(
        counts, counts.clone(), torch.zeros(1, dtype=torch.int32),
        torch.zeros((10, 1)), 2, 16)
    assert out.shape == (4, 8, 256)
    assert (out[:, 4] == 1).all() and (out[:, :4] == 0).all()
    assert (n_contrib == 0).all()
    d = composite_cuda.composite_bwd(
        counts, counts.clone(), torch.zeros(1, dtype=torch.int32),
        torch.zeros((10, 1)), out, n_contrib, torch.ones_like(out), 2, 16)
    assert d.shape == (10, 1) and (d == 0).all()


def test_wrappers_check_inputs():
    with pytest.raises(TypeError):
        composite_cuda.composite_fwd(torch.zeros(2), torch.zeros(2),
                                     torch.zeros(1, dtype=torch.int32),
                                     torch.zeros((10, 1)), 2, 16)
    with pytest.raises(ValueError):
        composite_cuda.composite_fwd(torch.zeros(2, dtype=torch.int32),
                                     torch.zeros(2, dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.int32),
                                     torch.zeros((9, 1)), 2, 16)
    z = torch.zeros(2, dtype=torch.int32)
    out = torch.zeros((2, 8, 256))
    with pytest.raises(ValueError):  # n_contrib of the wrong shape
        composite_cuda.composite_bwd(z, z, torch.zeros(1, dtype=torch.int32),
                                     torch.zeros((10, 1)), out,
                                     torch.zeros((2, 100), dtype=torch.int32),
                                     out, 2, 16)


# ------------------------------------------------------- K1-bwd ----------

def test_composite_bwd_plain_matches_pallas_vjp(composite_case):
    c = composite_case
    args = [torch.as_tensor(c[k]) for k in ("counts", "starts", "pair_slot")]
    attr = torch.as_tensor(c["attr"][:10].copy())
    out, n_contrib = composite_cuda.composite_fwd(*args, attr, c["ntx"],
                                                  c["tile"])
    got = composite_cuda.composite_bwd(*args, attr, out, n_contrib,
                                       torch.as_tensor(c["g"]), c["ntx"],
                                       c["tile"]).numpy()
    want = c["d_attr"][:10]
    for r in range(10):
        scale = np.abs(want[r]).max()
        assert scale > 0, r
        np.testing.assert_allclose(got[r] / scale, want[r] / scale,
                                   atol=2e-4, err_msg=f"row {r}")
    if c["saturated"]:  # the stop rule cut most runs short
        assert float((n_contrib < torch.as_tensor(c["counts"])[:, None]
                      .int()).float().mean()) > 0.5


def _tiny_composite(dtype):
    """Two 4x4 tiles, six splats of moderate opacity: no pixel reaches
    the stop rule or the alpha clamp, and the splats are wide enough that
    every pixel is far from the 1/255 gate."""
    rng = np.random.default_rng(11)
    counts = np.array([4, 3], np.int32)
    starts = np.array([0, 4], np.int32)
    pair_slot = np.array([0, 1, 2, 3, 2, 4, 5], np.int32)
    attr = np.zeros((10, 7))
    attr[0] = rng.uniform(0, 8, 7)
    attr[1] = rng.uniform(0, 4, 7)
    attr[2] = rng.uniform(0.02, 0.05, 7)
    attr[4] = rng.uniform(0.02, 0.05, 7)
    attr[3] = 0.3 * np.sqrt(attr[2] * attr[4])
    attr[5:8] = rng.uniform(0, 1, (3, 7))
    attr[8] = rng.uniform(0.2, 0.5, 7)
    attr[9] = rng.uniform(0.5, 5, 7)
    attr[:, 6] = 0.0
    ints = [torch.as_tensor(a) for a in (counts, starts, pair_slot)]
    return ints, torch.as_tensor(attr, dtype=dtype), rng


class _PlainComposite(torch.autograd.Function):
    """The plain forward with the plain backward as its gradient."""

    @staticmethod
    def forward(ctx, attr, counts, starts, pair_slot):
        out, n_contrib = composite_cuda.composite_fwd_plain(
            counts, starts, pair_slot, attr, 2, 4)
        ctx.save_for_backward(counts, starts, pair_slot, attr, out,
                              n_contrib)
        return out

    @staticmethod
    def backward(ctx, g):
        counts, starts, pair_slot, attr, out, n_contrib = ctx.saved_tensors
        return (composite_cuda.composite_bwd_plain(
            counts, starts, pair_slot, attr, out, n_contrib, g, 2, 4),
            None, None, None)


def test_composite_bwd_plain_gradcheck_float64():
    ints, attr, rng = _tiny_composite(torch.float64)
    out, _ = composite_cuda.composite_fwd_plain(*ints, attr, 2, 4)
    assert float(out[:, 4].min()) > 0.05  # far from the stop rule
    attr.requires_grad_(True)

    def rows(a):  # the rows the backward differentiates
        return _PlainComposite.apply(a, *ints)[:, :5]

    assert torch.autograd.gradcheck(rows, (attr,))
    # and against autograd through the plain forward loop itself
    g = torch.as_tensor(rng.normal(size=(2, 8, 16)))
    g[:, 5:] = 0.0
    ref, = torch.autograd.grad(
        composite_cuda.composite_fwd_plain(*ints, attr, 2, 4)[0], attr, g)
    got, = torch.autograd.grad(_PlainComposite.apply(attr, *ints), attr, g)
    torch.testing.assert_close(got, ref, rtol=1e-9, atol=1e-9)


def test_composite_function_backward_is_k1_bwd():
    """The port's autograd Function: its attr gradient is composite_bwd's
    output on the forward's saved state, and the integer inputs take
    none."""
    ints, attr, rng = _tiny_composite(torch.float32)
    attr.requires_grad_(True)
    out = composite_cuda.composite(*ints, attr, 2, 4)
    g = torch.as_tensor(rng.normal(size=(2, 8, 16)), dtype=torch.float32)
    out.backward(g)
    with torch.no_grad():
        o, n_contrib = composite_cuda.composite_fwd(*ints, attr, 2, 4)
        want = composite_cuda.composite_bwd(*ints, attr, o, n_contrib, g, 2,
                                            4)
    assert (attr.grad != 0).any()
    torch.testing.assert_close(attr.grad, want, rtol=0, atol=0)
    assert all(t.grad is None for t in ints)


# ------------------------------------------------- rasterize_tiled -------

@pytest.mark.parametrize("name,seed,n,pose,kw", [
    ("tiled", 1, 96, "identity", {}),
    ("nontrivial_pose", 2, 96, "rotated", {}),
    ("production_caps", 11, 192, "identity",
     dict(tile_span=3, tile_cap=256, visible_cap=256)),
    ("tile32_span2", 5, 192, "rotated",
     dict(tile=32, tile_span=2, tile_cap=256, visible_cap=256)),
])
def test_rasterize_matches_jax(name, seed, n, pose, kw):
    scene = _scene(n, seed=seed, spread=0.9 if n > 96 else 0.8)
    jo, to = _both(scene, _pose(pose), **kw)
    _assert_same(jo, to)
    assert float(to.color.max()) > 0.05


def test_rasterize_dead_slots_and_background():
    scene = _scene(64, seed=3)
    scene[5][::2] = False
    jo, to = _both(scene, _pose("identity"), bg=(0.2, 0.4, 0.6))
    _assert_same(jo, to)
    np.testing.assert_allclose(to.color[:, 0, 0].numpy(), [0.2, 0.4, 0.6],
                               atol=1e-5)


@pytest.mark.parametrize("kw", [dict(visible_cap=8), dict(tile_cap=8)])
def test_rasterize_cap_overflow_reported(kw):
    """Overflowing the visible cap drops the farthest splats and the tile
    cap the farthest of a tile; both report the loss, as in JAX."""
    n = 48
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 2] = np.random.default_rng(3).permutation(np.linspace(1.0, 2.0, n))
    quat = np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1))
    scale = np.full((n, 3), 0.03, np.float32)
    opacity = np.full((n,), 0.5, np.float32)
    sh = np.random.default_rng(4).uniform(-0.4, 0.4, (n, 1, 3)).astype(
        np.float32)
    scene = [xyz, quat, scale, opacity, sh, np.ones(n, bool)]
    jo, to = _both(scene, _pose("identity"), **kw)
    _assert_same(jo, to)
    assert int(to.stats[1] + to.stats[2]) > 0


def test_rasterize_depth_ties_fronto_parallel_wall():
    """A fronto-parallel wall: every splat at the same depth, overlapping.
    The port orders equal depths by slot (a stable sort); the JAX sort
    (jax.lax.sort, one key) must agree for the images to match."""
    gy, gx = np.mgrid[0:12, 0:16]
    n = gx.size
    xyz = np.stack([(gx.ravel() - 7.5) * 0.08, (gy.ravel() - 5.5) * 0.08,
                    np.full(n, 2.0)], 1).astype(np.float32)
    quat = np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1))
    scale = np.tile(np.array([0.06, 0.06, 0.001], np.float32), (n, 1))
    rng = np.random.default_rng(8)
    opacity = rng.uniform(0.4, 0.9, n).astype(np.float32)
    sh = rng.uniform(-0.5, 0.5, (n, 1, 3)).astype(np.float32)
    scene = [xyz, quat, scale, opacity, sh, np.ones(n, bool)]
    jo, to = _both(scene, _pose("identity"), tile_span=3, tile_cap=256,
                   visible_cap=256)
    _assert_same(jo, to)


@pytest.mark.parametrize("seed,n,sh_deg,use_pallas,behind", [
    (5, 32, 0, False, False),   # tests/test_rasterize.py:120-142's scene
    (5, 32, 0, True, False),
    (8, 48, 0, False, False),   # tests/test_rasterize.py:236-257's scene
    (9, 48, 1, False, False),   # view-dependent colour
    (10, 48, 0, False, True),   # splats behind the near plane
])
def test_rasterize_gradients_match_jax(seed, n, sh_deg, use_pallas, behind):
    """d(loss)/d(xyz, quat, scale, opacity, sh) through the whole
    rasterizer, the loss reading colour, depth and final transmittance."""
    scene = _scene(n, seed=seed, sh_deg=sh_deg)
    if behind:
        scene[0][:4, 2] = [0.1, 0.15, -0.5, 0.19]
    w2c = _pose("rotated" if sh_deg else "identity")
    rng = np.random.default_rng(seed + 100)
    wc = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    wd = rng.uniform(0, 1, (H, W)).astype(np.float32)
    wt = rng.uniform(0, 1, (H, W)).astype(np.float32)
    kw = dict(sh_degree=sh_deg, width=W, height=H, tile_span=7,
              tile_cap=128, visible_cap=128)

    def j_loss(*p):
        o = j_rasterize(*p, jnp.asarray(w2c), jnp.asarray(scene[5]),
                        jnp.zeros(3), FX, FY, CX, CY, use_pallas=use_pallas,
                        want_used=False, **kw)
        return (jnp.sum(o.color * wc) + jnp.sum(o.depth * wd)
                + jnp.sum(o.t_final * wt))

    jg = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in scene[:5]])
    leaves = [torch.tensor(a, requires_grad=True) for a in scene[:5]]
    o = t_rasterize(*leaves, torch.as_tensor(w2c), torch.as_tensor(scene[5]),
                    torch.zeros(3), FX, FY, CX, CY, **kw)
    loss = ((o.color * torch.as_tensor(wc)).sum()
            + (o.depth * torch.as_tensor(wd)).sum()
            + (o.t_final * torch.as_tensor(wt)).sum())
    loss.backward()
    for name, a, t in zip(("xyz", "quat", "scale", "opacity", "sh"), jg,
                          leaves):
        a, b = np.asarray(a), t.grad.numpy()
        assert np.isfinite(b).all(), name
        scale = np.abs(a).max()
        assert scale > 0, name
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-4,
                                   err_msg=name)
    if behind:  # culled splats take no gradient
        assert (leaves[0].grad[:4] == 0).all()


def test_tile_capacity_at_bench_geometry():
    """K is 384 at 1200x680 (32-px tiles, span 2) with V = 65,536."""
    assert tile_capacity(1200, 680, 32, 2, 1 << 16, 4096) == 384
    assert tile_capacity(128, 96, 32, 2, 1 << 12, 4096) == 1408
    assert tile_capacity(128, 96, 32, 2, 1 << 16, 4096) == 4096
