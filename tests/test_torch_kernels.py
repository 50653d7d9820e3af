"""PyTorch port: each hand-written CUDA kernel against its plain PyTorch
version on the card.  These need a CUDA device and skip without one; the
file imports neither JAX nor the JAX package, so it runs on a machine
with the card but without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances: K2 and K3 are exact (the kernels round each operation of the
distance as PyTorch does, and keep the lowest-index tie rule; K3's
indices where a neighbour exists, its distances everywhere); K1-fwd
exact, out and n_contrib (the same operation order, and the pairs its
warps skip are ones the gate refuses); K1-bwd each attribute row within
1e-4 of the row's largest |gradient| (the same per-pair arithmetic, but
the pixel sums are taken by warp shuffles, per-warp partials and
per-splat cell sums in another order), and equal bits on two runs (no
atomics); K4a/K4b (K1's kernels on the dense layout) forward exact,
out and n_contrib, backward each row within 1e-4 of the row's largest
|gradient| (no atomics: the kernel's warp sums are added in a fixed
order, so two runs give the same bits).  K3 above k = 32 (passes of 32
neighbours) and K2/K3 above 2^20 references (the chunks sorted a segment
at a time) exact as well.
"""
import numpy as np
import pytest
import torch

from gs_icp_slam_torch.ops import composite_cuda, nn_cuda
from gs_icp_slam_torch.ops.gicp import grid_block_order, spatial_order
from gs_icp_slam_torch.ops.rasterize import bin_splats, rasterize_tiled

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("Q,R", [(300, 4096), (1000, 20000), (7, 100)])
def test_nn1_kernel_matches_plain(dev, Q, R):
    rng = np.random.default_rng(Q)
    q = torch.as_tensor(rng.normal(size=(Q, 3)).astype(np.float32)).to(dev)
    ref = rng.normal(size=(3, R)).astype(np.float32)
    ref[:, 7] = ref[:, 3]  # an exact tie
    rT = torch.as_tensor(ref).to(dev)
    valid = torch.as_tensor(rng.random(R) > 0.3).to(dev)
    valid[[3, 7]] = True
    bias = torch.where(valid, 0.0, 3.4e38).float()[None].contiguous()
    i1, d1 = nn_cuda.nn_search_pre(q, rT, bias)
    i0, d0 = nn_cuda.nn1_plain(q, rT, bias)
    assert torch.equal(i1, i0)
    assert torch.equal(d1, d0)


def test_nn1_kernel_no_valid_ref(dev):
    q = torch.ones((5, 3), device=dev)
    rT = torch.zeros((3, 64), device=dev)
    bias = torch.full((1, 64), 3.4e38, device=dev)
    i1, d1 = nn_cuda.nn_search_pre(q, rT, bias)
    assert (i1 == 0).all() and (d1 == np.float32(3.4e38)).all()


def _surface(gh, gw, seed):
    """A pixel-grid cloud of a wavy surface (row-major, like the
    downsampled frame) and a target of two shifted copies of it with ~20%
    invalid slots."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.linspace(-1.5, 1.5, gw), np.linspace(-1, 1, gh))
    z = 2.0 + 0.2 * np.sin(2 * u) * np.cos(3 * v)
    src = np.stack([u * z / 2, v * z / 2, z], -1).reshape(-1, 3)
    tgt = np.concatenate([src + 0.004, src - 0.003]).astype(np.float32)
    valid = rng.random(tgt.shape[0]) > 0.2
    return src.astype(np.float32), tgt, valid


@pytest.mark.parametrize("gh,gw", [(69, 120), (13, 37)])
def test_nn1_kernel_on_an_ordered_surface(dev, gh, gw):
    """The G-ICP call: target in Morton order, queries in 8x8 pixel
    blocks; ties planted across chunks (a slot duplicated far away in the
    order); Q = gh * gw not a multiple of the 64-query group."""
    src, tgt, valid = _surface(gh, gw, gh)
    n = tgt.shape[0]
    tgt[n - 1] = tgt[5]
    tgt[n // 2 + 3] = tgt[5]
    valid[[5, n // 2 + 3, n - 1]] = True
    src[7] = tgt[5]  # distance 0 to three slots: the lowest wins
    rT = torch.as_tensor(tgt.T.copy()).to(dev)
    v = torch.as_tensor(valid).to(dev)
    bias = torch.where(v, 0.0, 3.4e38).float()[None].contiguous()
    q = torch.as_tensor(src).to(dev)
    ro, qo = spatial_order(rT, v), grid_block_order(gh, gw, dev)
    i0, d0 = nn_cuda.nn1_plain(q, rT, bias)
    for args in ((ro, qo), (ro, None), (None, qo), (None, None)):
        i1, d1 = nn_cuda.nn_search_pre(q, rT, bias, *args)
        assert torch.equal(i1, i0) and torch.equal(d1, d0)
    assert int(i0[7]) == 5 and float(d0[7]) == 0.0
    # a sliced target: the full order, references past the slice skipped
    Tp = n // 2 + 10
    i1, d1 = nn_cuda.nn_search_pre(q, rT[:, :Tp].contiguous(),
                                   bias[:, :Tp].contiguous(), ro, qo)
    i0, d0 = nn_cuda.nn1_plain(q, rT[:, :Tp].contiguous(),
                               bias[:, :Tp].contiguous())
    assert torch.equal(i1, i0) and torch.equal(d1, d0)
    _, _, st = nn_cuda.nn1_chunked_plain(q, rT, bias, ro, qo)
    if gh == 69:  # the tracking geometry culls most chunks
        assert st["culled"] > 0.5


def test_nn1_kernel_no_valid_ref_ordered(dev):
    src, tgt, _ = _surface(13, 37, 1)
    rT = torch.as_tensor(tgt.T.copy()).to(dev)
    v = torch.zeros(tgt.shape[0], dtype=torch.bool, device=dev)
    bias = torch.full((1, tgt.shape[0]), 3.4e38, device=dev)
    i1, d1 = nn_cuda.nn_search_pre(torch.as_tensor(src).to(dev), rT, bias,
                                   spatial_order(rT, v),
                                   grid_block_order(13, 37, dev))
    assert (i1 == 0).all() and (d1 == np.float32(3.4e38)).all()


def _knn_case(case, rng):
    """(query, ref, valid) numpy arrays and whether query is ref."""
    if case == "duplicates":  # every point four times: exact ties
        base = rng.normal(size=(700, 3)).astype(np.float32)
        pts = np.concatenate([base, base, base[::-1], base])
        return pts, pts, rng.random(pts.shape[0]) > 0.2, True
    if case == "query_not_ref":  # Q, R not multiples of 32 or 128
        ref = rng.normal(size=(1777, 3)).astype(np.float32)
        q = rng.normal(size=(1001, 3)).astype(np.float32)
        q[:5] = ref[:5]
        return q, ref, rng.random(1777) > 0.3, False
    if case == "few_valid":  # fewer than k valid references
        pts = rng.normal(size=(500, 3)).astype(np.float32)
        valid = np.zeros(500, bool)
        valid[[3, 77, 400]] = True
        return pts, pts, valid, True
    if case == "no_refs":
        return (rng.normal(size=(37, 3)).astype(np.float32),
                np.zeros((0, 3), np.float32), np.zeros(0, bool), False)
    # "surface": a pixel-grid cloud, invalid points at the camera centre
    src, _, _ = _surface(69, 120, 5)
    valid = rng.random(src.shape[0]) > 0.1
    src[~valid] = 0.0
    return src, src, valid, True


@pytest.mark.parametrize("k", [1, 4, 20, 32])
@pytest.mark.parametrize("case", ["duplicates", "query_not_ref",
                                  "few_valid", "no_refs", "surface"])
def test_knn_kernel_cases(dev, k, case):
    """K3 (chunks in Morton order, lists merged across warps) against
    knn_plain: indices where a neighbour exists, distances everywhere;
    the counting entry point gives the same results."""
    q, ref, valid, same = _knn_case(case, np.random.default_rng(k))
    r = torch.as_tensor(ref).to(dev)
    v = torch.as_tensor(valid).to(dev)
    qt = r if same else torch.as_tensor(q).to(dev)
    i0, d0 = nn_cuda.knn_plain(qt, r, v, k)
    i1, d1 = nn_cuda.knn_search_kernel(qt, r, v, k)
    i2, d2, st = nn_cuda.knn_search_counts(qt, r, v, k)
    have = d0 < 1e37
    for i, d in ((i1, d1), (i2, d2)):
        assert torch.equal(d, d0)
        assert torch.equal(i[have], i0[have])
    if case == "surface" and k == 20:  # a compact cloud culls chunks
        assert st["culled"] > 0.5
    if case == "few_valid":
        assert (d1[:, 3:] == np.float32(3.4e38)).all()


def test_new_entry_points_count_their_launches(dev):
    """composite_fwd_counts and knn_search_counts launch their kernels
    once a call, and their counts add up as the plain model's do."""
    from gs_icp_slam_torch import cuda_build

    counts, starts, pair_slot, attr, ntx, tile = _composite_inputs(False)
    args = [torch.as_tensor(a).to(dev) for a in (counts, starts, pair_slot,
                                                 attr)]
    pts = torch.randn((300, 3), device=dev)
    valid = torch.ones(300, dtype=torch.bool, device=dev)
    fwd, knn = (cuda_build.KERNELS[n] for n in ("composite_fwd", "knn"))
    n0 = (fwd.launches, knn.launches)
    _, _, st = composite_cuda.composite_fwd_counts(*args, ntx, tile)
    assert (fwd.launches, knn.launches) == (n0[0] + 1, n0[1])
    nn_cuda.knn_search_counts(pts, pts, valid, 4)
    assert (fwd.launches, knn.launches) == (n0[0] + 1, n0[1] + 1)
    want = composite_cuda.composite_fwd_cull_plain(
        *[a.cpu() for a in args], ntx, tile)[2]
    assert st["evaluated"] + st["culled"] == want["examined"]
    assert st == {k: want[k] for k in ("evaluated", "culled")}


@pytest.mark.parametrize("k", [1, 4, 20, 32])
def test_knn_kernel_matches_plain(dev, k):
    rng = np.random.default_rng(k)
    pts = rng.normal(size=(3000, 3)).astype(np.float32)
    pts[10] = pts[20]  # an exact tie
    ref = torch.as_tensor(pts).to(dev)
    valid = torch.as_tensor(rng.random(3000) > 0.2).to(dev)
    i1, d1 = nn_cuda.knn_search_kernel(ref, ref, valid, k)
    i0, d0 = nn_cuda.knn_plain(ref, ref, valid, k)
    assert torch.equal(d1, d0)
    have = d0 < 1e37
    assert torch.equal(i1[have], i0[have])


@pytest.mark.parametrize("k", [33, 40, 64, 100])
@pytest.mark.parametrize("case", ["duplicates", "query_not_ref", "few_valid",
                                  "surface"])
def test_knn_kernel_above_32(dev, case, k):
    """k > 32: the kernel searches in passes of 32 neighbours, each above
    the last pass's farthest (distance, index) word; exact against
    knn_plain, ties across passes included (duplicates)."""
    q, ref, valid, same = _knn_case(case, np.random.default_rng(k))
    r = torch.as_tensor(ref).to(dev)
    v = torch.as_tensor(valid).to(dev)
    qt = r if same else torch.as_tensor(q).to(dev)
    i0, d0 = nn_cuda.knn_plain(qt, r, v, k)
    i1, d1 = nn_cuda.knn_search_kernel(qt, r, v, k)
    i2, d2, _ = nn_cuda.knn_search_counts(qt, r, v, k)
    have = d0 < 1e37
    for i, d in ((i1, d1), (i2, d2)):
        assert torch.equal(d, d0)
        assert torch.equal(i[have], i0[have])


def _big_cloud(dev, Q, R=(1 << 20) + (1 << 17), seed=8):
    """R references in a unit cube, 20% invalid, one duplicated far along
    the index order (a tie across segments), and Q queries in the cube."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ref = torch.rand((R, 3), generator=g)
    ref[R - 5] = ref[7]
    valid = torch.rand(R, generator=g) > 0.2
    valid[[7, R - 5]] = True
    q = torch.rand((Q, 3), generator=g)
    q[:3] = ref[7]
    return q.to(dev), ref.to(dev), valid.to(dev)


def test_nn1_kernel_above_2_20_references(dev):
    """K2 on 1,179,648 references (two sort segments), in Morton order and
    in index order: exact against nn1_plain."""
    q, ref, valid = _big_cloud(dev, 3000)
    rT, bias = nn_cuda.prepare_refs(ref, valid)
    i0, d0 = nn_cuda.nn1_plain(q, rT, bias, q_chunk=256)
    for order in (None, spatial_order(rT, valid)):
        i1, d1 = nn_cuda.nn_search_pre(q, rT, bias, order)
        assert torch.equal(i1, i0) and torch.equal(d1, d0)
    assert (i0[:3] == 7).all()


@pytest.mark.parametrize("k", [4, 40])
def test_knn_kernel_above_2_20_references(dev, k):
    """K3 on 1,179,648 references: the order over several blocks, the
    chunks sorted a segment at a time; exact against knn_plain."""
    q, ref, valid = _big_cloud(dev, 2000)
    i0, d0 = nn_cuda.knn_plain(q, ref, valid, k, q_chunk=64)
    i1, d1 = nn_cuda.knn_search_kernel(q, ref, valid, k)
    assert torch.equal(d1, d0) and torch.equal(i1, i0)


def test_knn_kernel_missing_neighbours(dev):
    ref = torch.randn((50, 3), device=dev)
    valid = torch.zeros(50, dtype=torch.bool, device=dev)
    valid[[4, 9]] = True
    _, d = nn_cuda.knn_search_kernel(ref, ref, valid, 5)
    assert (d[:, 2:] == np.float32(3.4e38)).all()


def _composite_inputs(saturated: bool, tile=32, ntx=3, nty=2, K=128, V=256,
                      empty=()):
    T = ntx * nty
    rng = np.random.default_rng(7)
    counts = rng.integers(8, K, size=(T,)).astype(np.int32)
    counts[list(empty)] = 0
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    pair_slot = rng.integers(0, V, size=(int(counts.sum()),)).astype(np.int32)
    attr = np.zeros((10, V + 1), np.float32)
    lo, hi = (0.001, 0.01) if saturated else (0.01, 0.1)
    attr[0] = rng.uniform(0, ntx * tile, V + 1)
    attr[1] = rng.uniform(0, nty * tile, V + 1)
    attr[2] = rng.uniform(lo, hi, V + 1)
    attr[4] = rng.uniform(lo, hi, V + 1)
    attr[3] = 0.2 * np.sqrt(attr[2] * attr[4])
    attr[5:8] = rng.uniform(0, 1, (3, V + 1))
    attr[8] = rng.uniform(0.8 if saturated else 0.2, 0.99, V + 1)
    attr[9] = rng.uniform(0.5, 5.0, V + 1)
    attr[:, V] = 0.0
    return counts, starts, pair_slot, attr, ntx, tile


@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("tile", [16, 32])
def test_composite_kernel_matches_plain(dev, saturated, tile):
    counts, starts, pair_slot, attr, ntx, tile = _composite_inputs(
        saturated, tile=tile)
    args = [torch.as_tensor(a).to(dev) for a in (counts, starts, pair_slot,
                                                 attr)]
    got, nc = composite_cuda.composite_fwd(*args, ntx, tile)
    ref, nc0 = composite_cuda.composite_fwd_plain(*args, ntx, tile)
    assert torch.equal(got, ref)
    assert torch.equal(nc, nc0)


def _odd_splats(attr, tile, ntx):
    """attr with columns appended for splats the warp cull must leave to
    the gate, centred on tiles 1 and 2: conics that are not positive
    definite, singular, ill-conditioned (condition ~1e6 and just under
    1e4) or NaN; opacity 0, negative or NaN.  Returns (attr, the new
    columns of tile 1, of tile 2)."""
    cx = lambda t: (t % ntx) * tile + tile / 2  # noqa: E731
    cy = lambda t: (t // ntx) * tile + tile / 2  # noqa: E731
    conics = [(-0.05, 0.0, 0.05), (0.02, 0.05, 0.02), (0.0, 0.0, 0.0),
              (0.05, 0.05 * (1 - 1e-6), 0.05), (0.05, 0.0498, 0.05),
              (float("nan"), 0.0, 0.05), (0.01, 0.0, 1e-7)]
    cols = []
    for i, (a, b, c) in enumerate(conics):
        cols.append([cx(1) + i, cy(1) - i, a, b, c, 0.9, 0.2, 0.4, 0.6,
                     2.0])
    for op in (0.0, -0.5, float("nan"), 1e-30):
        cols.append([cx(2), cy(2), 0.01, 0.0, 0.01, 0.3, 0.6, 0.9, op, 1.5])
    extra = np.asarray(cols, np.float32).T
    V = attr.shape[1]
    attr = np.concatenate([attr, extra], 1)
    return attr, np.arange(V, V + len(conics)), np.arange(
        V + len(conics), V + extra.shape[1])


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("case", ["K4096", "odd_splats", "ragged"])
def test_composite_kernel_is_bit_equal(dev, tile, case):
    """K1-fwd (a block per 16x16 corner, 8x4 warp patches culling splats
    before the exp) gives composite_fwd_plain's bits: runs up to K =
    4096; splats whose conic or opacity the cull must not judge, beside an
    empty tile; and a binned view whose last tile row and column hang over
    the image."""
    if case == "ragged":
        rng = np.random.default_rng(tile)
        n = 500
        xyz = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.6, 0.6, n),
                        rng.uniform(1.2, 3.0, n)], 1).astype(np.float32)
        t = [torch.as_tensor(a).to(dev) for a in (
            xyz, rng.normal(size=(n, 4)).astype(np.float32),
            rng.uniform(0.02, 0.08, (n, 3)).astype(np.float32),
            rng.uniform(0.3, 0.95, n).astype(np.float32),
            rng.uniform(-0.4, 0.4, (n, 1, 3)).astype(np.float32))]
        b = bin_splats(*t, torch.eye(4, device=dev),
                       torch.ones(n, dtype=torch.bool, device=dev), 60.0,
                       60.0, 59.5, 44.5, sh_degree=0, width=120, height=90,
                       tile=tile, visible_cap=1024, tile_span=3,
                       tile_cap=512)
        args = [b.counts, b.starts, b.pair_slot, b.attr_v.detach()]
        ntx = -(-120 // tile)
    else:
        kw = dict(tile=tile, empty=(0,))
        if case == "K4096":
            kw.update(K=4096, V=2048)
        counts, starts, pair_slot, attr, ntx, tile = _composite_inputs(
            False, **kw)
        if case == "odd_splats":
            attr, c1, c2 = _odd_splats(attr, tile, ntx)
            for t_, cols in ((1, c1), (2, c2)):
                rows = starts[t_] + np.arange(0, len(cols) * 3, 3)
                keep = rows < starts[t_] + counts[t_]
                assert keep.sum() >= 4
                pair_slot[rows[keep]] = cols[keep]
        args = [torch.as_tensor(a).to(dev) for a in (counts, starts,
                                                     pair_slot, attr)]
    got, nc = composite_cuda.composite_fwd(*args, ntx, tile)
    ref, nc0 = composite_cuda.composite_fwd_plain(*args, ntx, tile)
    assert torch.equal(got, ref)
    assert torch.equal(nc, nc0)
    if case != "ragged":
        assert (nc[0] == 0).all() and (got[0, 4] == 1).all()  # empty tile


@pytest.mark.parametrize("case", ["K128", "K128_saturated", "K4096",
                                  "empty_tiles", "all_stop_early"])
def test_composite_bwd_kernel_matches_plain(dev, case):
    kw = dict(saturated=case in ("K128_saturated", "all_stop_early"))
    if case == "K4096":
        kw.update(K=4096, V=2048)
    if case == "empty_tiles":
        kw.update(empty=(1, 4))
    counts, starts, pair_slot, attr, ntx, tile = _composite_inputs(**kw)
    if case == "all_stop_early":  # wide, nearly opaque splats
        attr[2:5] *= 0.05
        attr[8] = 0.98
    args = [torch.as_tensor(a).to(dev) for a in (counts, starts, pair_slot,
                                                 attr)]
    out, nc = composite_cuda.composite_fwd(*args, ntx, tile)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    g[:, 5:] = 0.0
    g = g.to(dev)
    got = composite_cuda.composite_bwd(*args, out, nc, g, ntx, tile)
    again = composite_cuda.composite_bwd(*args, out, nc, g, ntx, tile)
    ref = composite_cuda.composite_bwd_plain(*args, out, nc, g, ntx, tile)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # deterministic
    scale = ref.abs().amax(1, keepdim=True).clamp(min=1e-30)
    assert float(((got - ref).abs() / scale).max()) <= 1e-4
    assert float(ref.abs().max()) > 0
    if case == "empty_tiles":
        assert (nc[[1, 4]] == 0).all()
    if case == "all_stop_early":  # every pixel stopped before its run ended
        assert (out[:, 4] < 1e-2).all()
        assert (nc < torch.as_tensor(counts, device=dev)[:, None]).all()


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("case", ["K128", "K128_saturated", "K4096"])
def test_composite_bwd_kernel_deterministic(dev, tile, case):
    """K1-bwd at both tile sizes (one block per 16x16 corner): equal bits
    on two launches, within 1e-4 of the plain version row by row."""
    kw = dict(saturated=case == "K128_saturated", tile=tile)
    if case == "K4096":
        kw.update(K=4096, V=2048)
    counts, starts, pair_slot, attr, ntx, tile = _composite_inputs(**kw)
    args = [torch.as_tensor(a).to(dev) for a in (counts, starts, pair_slot,
                                                 attr)]
    out, nc = composite_cuda.composite_fwd(*args, ntx, tile)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    g[:, 5:] = 0.0
    g = g.to(dev)
    rows = composite_cuda.splat_pair_rows(*args[:3], attr.shape[1])
    runs = [composite_cuda.composite_bwd(*args, out, nc, g, ntx, tile, rows)
            for _ in range(2)]
    ref = composite_cuda.composite_bwd_plain(*args, out, nc, g, ntx, tile)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    scale = ref.abs().amax(1, keepdim=True).clamp(min=1e-30)
    assert float(((runs[0] - ref).abs() / scale).max()) <= 1e-4


def test_composite_bwd_kernel_with_the_binning_map(dev):
    """Through the rasterizer's binning: its splat -> pair-row map (tile
    cap drops included) gives the plain version's gradient."""
    rng = np.random.default_rng(9)
    n = 400
    xyz = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.6, 0.6, n),
                    rng.uniform(1.2, 3.0, n)], 1).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    scale = rng.uniform(0.02, 0.08, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.3, 0.95, n).astype(np.float32)
    sh = rng.uniform(-0.4, 0.4, (n, 1, 3)).astype(np.float32)
    t = [torch.as_tensor(a).to(dev) for a in (xyz, quat, scale, opacity, sh)]
    b = bin_splats(*t, torch.eye(4, device=dev),
                   torch.ones(n, dtype=torch.bool, device=dev), 60.0, 60.0,
                   63.5, 47.5, sh_degree=0, width=128, height=96, tile=32,
                   visible_cap=512, tile_span=2, tile_cap=64)
    assert int(b.stats[2]) > 0  # some pairs past the tile cap
    args = (b.counts, b.starts, b.pair_slot, b.attr_v.detach())
    out, nc = composite_cuda.composite_fwd(*args, 4, 32)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    g[:, 5:] = 0.0
    g = g.to(dev)
    got = composite_cuda.composite_bwd(*args, out, nc, g, 4, 32,
                                       b.splat_rows)
    ref = composite_cuda.composite_bwd_plain(*args, out, nc, g, 4, 32)
    torch.cuda.synchronize()
    scale = ref.abs().amax(1, keepdim=True).clamp(min=1e-30)
    assert float(((got - ref).abs() / scale).max()) <= 1e-4


def _dense_inputs(T, ntx, tile, K, seed=1):
    """K4 inputs as scripts/tpu_kernel_smoke.py makes them, plus a
    zero-opacity tile and an empty one."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 1, size=(T,)).astype(np.int32)
    counts[[0, 1]] = (0, K)
    a = np.zeros((T, 16, K), np.float32)
    a[:, 0] = rng.uniform(0, ntx * tile, (T, K))
    a[:, 1] = rng.uniform(0, (T // ntx) * tile, (T, K))
    a[:, 2] = 0.05
    a[:, 4] = 0.05
    a[:, 5:8] = rng.uniform(0, 1, (T, 3, K))
    a[:, 8] = rng.uniform(0.1, 0.9, (T, K))
    a[:, 9] = rng.uniform(0.5, 5.0, (T, K))
    a[2, 8] = 0.0
    return counts, a


@pytest.mark.parametrize("dyn", [False, True])
@pytest.mark.parametrize("T,ntx,K", [(48, 8, 128), (12, 4, 256),
                                     (6, 3, 300)])
def test_composite_dense_kernels_match_plain(dev, dyn, T, ntx, K):
    tile = 16
    counts, a = _dense_inputs(T, ntx, tile, K)
    c = torch.as_tensor(counts).to(dev) if dyn else None
    attrs = torch.as_tensor(a).to(dev)
    out, nc = composite_cuda.composite_dense_fwd(c, attrs, ntx, tile)
    ref, nc0 = composite_cuda.composite_dense_fwd_plain(c, attrs, ntx, tile)
    assert torch.equal(out, ref)
    assert torch.equal(nc, nc0)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    g[:, 5:] = 0.0
    g = g.to(dev)
    got = composite_cuda.composite_dense_bwd(c, attrs, out, nc, g, ntx, tile)
    again = composite_cuda.composite_dense_bwd(c, attrs, out, nc, g, ntx,
                                               tile)
    want = composite_cuda.composite_dense_bwd_plain(c, attrs, out, nc, g, ntx,
                                                    tile)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # deterministic
    scale = want.abs().amax((0, 2), keepdim=True).clamp(min=1e-30)
    assert float(((got - want).abs() / scale).max()) <= 1e-4
    assert float(want.abs().max()) > 0
    assert (got[:, 10:] == 0).all()
    assert (out[0, 4] == 1).all() == dyn  # counts 0 only with counts


def _dense_case(T, ntx, tile, K, saturated):
    """_dense_inputs at any tile; saturated: large opaque splats whose
    pixels stop early."""
    counts, a = _dense_inputs(T, ntx, tile, K)
    if saturated:
        rng = np.random.default_rng(K + tile)
        a[:, 2] = rng.uniform(0.002, 0.01, (T, K))
        a[:, 4] = rng.uniform(0.002, 0.01, (T, K))
        a[:, 3] = rng.uniform(-0.9, 0.9, (T, K)) * np.sqrt(a[:, 2] * a[:, 4])
        a[:, 8] = rng.uniform(0.8, 0.99, (T, K))
        a[2, 8] = 0.0
    return counts, a


@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_composite_dense_kernels_at_every_tile(dev, tile, K, saturated):
    """K4a and K4b at tiles 8, 16, 32 (the backward one block per tile:
    1,024 threads at 32), an empty tile (0) and a zero-opacity one (2):
    forward bits equal to the plain version, backward within 1e-4 of each
    row's largest |gradient| and equal bits on two launches, the whole
    gradient written; the counting entry points give the same results
    and the plain models' counts."""
    T, ntx = 12, 4
    counts, a = _dense_case(T, ntx, tile, K, saturated)
    attrs = torch.as_tensor(a).to(dev)
    g = torch.randn((T, 8, tile * tile),
                    generator=torch.Generator().manual_seed(tile))
    g[:, 5:] = 0.0
    g = g.to(dev)
    for c in (None, torch.as_tensor(counts).to(dev)):
        out, nc = composite_cuda.composite_dense_fwd(c, attrs, ntx, tile)
        ref, nc0 = composite_cuda.composite_dense_fwd_plain(c, attrs, ntx,
                                                            tile)
        assert torch.equal(out, ref) and torch.equal(nc, nc0)
        oc, ncc, st = composite_cuda.composite_dense_fwd_counts(c, attrs, ntx,
                                                                tile)
        assert torch.equal(oc, ref) and torch.equal(ncc, nc0)
        want = composite_cuda.composite_dense_fwd_cull_plain(
            None if c is None else c.cpu(), attrs.cpu(), ntx, tile)[2]
        assert st == {k: want[k] for k in ("evaluated", "culled")}
        # a freed block of NaN, which the next gradient most likely takes:
        # every cell must be written
        junk = torch.full_like(attrs, float("nan"))
        del junk
        got = composite_cuda.composite_dense_bwd(c, attrs, out, nc, g, ntx,
                                                 tile)
        again, bst = composite_cuda.composite_dense_bwd_counts(
            c, attrs, out, nc, g, ntx, tile)
        want = composite_cuda.composite_dense_bwd_plain(c, attrs, out, nc, g,
                                                        ntx, tile)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert torch.equal(got, again)
        scale = want.abs().amax((0, 2), keepdim=True).clamp(min=1e-30)
        assert float(((got - want).abs() / scale).max()) <= 1e-4
        assert float(want.abs().max()) > 0
        assert (got[:, 10:] == 0).all() and (got[2] == 0).all()
        assert bst == composite_cuda.composite_dense_bwd_ranks_plain(
            None if c is None else c.cpu(), attrs.cpu(), nc.cpu(), ntx, tile)
        if c is not None:
            assert (out[0, 4] == 1).all() and (got[0] == 0).all()


def test_composite_dense_entry_points_launch_their_kernels(dev):
    from gs_icp_slam_torch import cuda_build

    T, ntx, tile, K = 48, 8, 16, 128
    counts, a = _dense_inputs(T, ntx, tile, K)
    cuda_build.reset_launch_counts()
    for dyn in (False, True):
        attrs = torch.as_tensor(a).to(dev).requires_grad_(True)
        if dyn:
            out = composite_cuda.make_composite_dyn(T, ntx, tile, K)(
                torch.as_tensor(counts).to(dev), attrs)
        else:
            out = composite_cuda.make_composite(T, ntx, tile, K)(attrs)
        out[:, :5].sum().backward()
        assert torch.isfinite(attrs.grad).all()
    n = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    assert all(n[k] == 1 for k in ("composite_dense_fwd",
                                   "composite_dense_bwd",
                                   "composite_dyn_fwd", "composite_dyn_bwd"))


def test_rasterize_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(5)
    n = 300
    xyz = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.6, 0.6, n),
                    rng.uniform(1.2, 3.0, n)], 1).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    scale = rng.uniform(0.02, 0.08, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.3, 0.95, n).astype(np.float32)
    sh = rng.uniform(-0.4, 0.4, (n, 1, 3)).astype(np.float32)
    live = np.ones(n, bool)
    w2c = np.eye(4, dtype=np.float32)
    outs = []
    for d in ("cpu", dev):
        t = [torch.as_tensor(a).to(d) for a in
             (xyz, quat, scale, opacity, sh, w2c, live)]
        o = rasterize_tiled(*t, torch.zeros(3, device=d), 60.0, 60.0, 63.5,
                            47.5, sh_degree=0, width=128, height=96, tile=32,
                            visible_cap=512, tile_span=2, tile_cap=256)
        outs.append(o)
    # CUDA's expf and the CPU's exp may differ by an ulp, which can flip a
    # splat across the 1/255 alpha gate at a rare pixel: at most ~4e-3 of
    # a colour there (x depth, < 3 m here, in the depth channel)
    for name, lim in (("color", 5e-3), ("depth", 1.5e-2), ("t_final", 5e-3)):
        diff = (getattr(outs[1], name).cpu() - getattr(outs[0], name)).abs()
        assert float(diff.max()) <= lim, name
        assert float((diff > 1e-5).float().mean()) <= 1e-3, name
    assert torch.equal(outs[1].stats.cpu(), outs[0].stats)


@pytest.mark.parametrize("mapping_iters", [0, 2])
def test_engine_on_the_card_matches_the_cpu(dev, mapping_iters):
    """The staged engine, 6 frames at 128x96, with and without mapping
    iterations: the CUDA kernels' run against the plain versions' run on
    the CPU.  Poses atol 1e-4 m and PSNR within 0.05 dB (matrix products
    round differently on the two devices, and K1-bwd sums by atomics);
    counts exact."""
    import dataclasses

    from gs_icp_slam_torch.config import synthetic_config
    from gs_icp_slam_torch.datasets import InMemorySequence, open_dataset
    from gs_icp_slam_torch.slam import SLAMEngine

    seq = InMemorySequence(open_dataset("synthetic", width=128, height=96,
                                        num_frames=6))
    cfg = synthetic_config(seq.intr, downsample_rate=4, capacity=1 << 14,
                           target_capacity=1 << 12, visible_capacity=1 << 12)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=mapping_iters,
        mapping_iters_final=0))
    gpu = SLAMEngine(seq, cfg, device=dev).run()
    cpu = SLAMEngine(seq, cfg, device="cpu").run()
    np.testing.assert_allclose(gpu.poses, cpu.poses, atol=1e-4)
    assert gpu.num_gaussians == cpu.num_gaussians
    assert gpu.kf_total == cpu.kf_total
    np.testing.assert_allclose(gpu.per_frame_psnr, cpu.per_frame_psnr,
                               atol=0.05)
