"""PyTorch port: the plain versions of the K1-bwd, K2, K1-fwd and K3
designs, on the CPU at small sizes.

K1-bwd sums each (tile, rank) cell into a cell buffer indexed by pair row,
then each splat's cells through the binning's splat -> pair-row map.  Here
the map that bin_splats builds from its sort, and the plain cell-buffer
reduction on it, are held against composite_bwd_plain (index_add_ into the
splat's column): each attribute row within 1e-6 of its largest |gradient|
(the same sums, added in another order).

K2 searches reference chunks nearest first and skips a chunk when a box
bound rules it out.  The bound's mirror (chunk_lower_bound) must never
exceed the rounded distance of any pair it covers, and the plain model of
the whole search (nn1_chunked_plain) must equal nn1_plain exactly, indices
and distances, on planted cases: ties across chunks, queries on box
faces, coordinates of 1e3 m, chunks with no valid reference.

K1-fwd's warps skip a splat when a rectangle test proves that no pixel of
their 8x4 patch can pass the gate, and a pixel skips its exp below the
splat's gate power.  The plain model of both (composite_fwd_cull_plain)
must never skip a pair that the plain compositor blends or stops at, and
so give its bits, on random and binned splats and on conics and
opacities the test must leave alone (degenerate, ill-conditioned, NaN,
opacity <= 0).

K4a/K4b run K1's kernels on a dense (16, K) block per tile.  The plain
model of their forward cull (composite_dense_fwd_cull_plain) must give
composite_dense_fwd_plain's bits with evaluated + culled = examined, and
no rank their backward's warps cull (composite_dense_bwd_ranks_plain) may
blend at a pixel of the warp, at tiles 8, 16 and 32, on path D's kind of
data (chip_smoke.py dense_inputs) and on large, opaque splats.

K3 sorts both clouds by Morton cell and keeps a (distance, index) list
per query over chunks visited nearest first; its plain model
(knn_chunked_plain) must equal knn_plain exactly: on the synthetic
frame-0 cloud, a random cube with invalid references, duplicates (exact
ties), queries that are not the references, fewer than k valid
references and no references.
"""
import numpy as np
import pytest
import torch

from gs_icp_slam_torch.ops import composite_cuda as cc
from gs_icp_slam_torch.ops import nn_cuda
from gs_icp_slam_torch.ops.gicp import grid_block_order, spatial_order
from gs_icp_slam_torch.ops.rasterize import bin_splats
from gs_icp_slam_torch.utils.pointcloud import (downsample_pointcloud,
                                                make_downsample_filter)

_BIG = np.float32(3.4e38)
CH = nn_cuda.NN_CHUNK


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: intra-op threads only contend with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ K1-bwd ----

def _binning(tile, tile_span, tile_cap, n=300, seed=3):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.6, 0.6, n),
                    rng.uniform(1.2, 3.0, n)], 1).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    scale = rng.uniform(0.02, 0.08, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.3, 0.95, n).astype(np.float32)
    sh = rng.uniform(-0.4, 0.4, (n, 1, 3)).astype(np.float32)
    t = [torch.as_tensor(a) for a in (xyz, quat, scale, opacity, sh)]
    return bin_splats(*t, torch.eye(4), torch.ones(n, dtype=torch.bool),
                      60.0, 60.0, 63.5, 47.5, sh_degree=0, width=128,
                      height=96, tile=tile, visible_cap=512,
                      tile_span=tile_span, tile_cap=tile_cap)


@pytest.mark.parametrize("tile,tile_span,tile_cap", [(16, 3, 64),
                                                      (32, 2, 256)])
def test_splat_rows_and_cell_reduction_equal_plain_bwd(tile, tile_span,
                                                       tile_cap):
    b = _binning(tile, tile_span, tile_cap)
    ntx = -(-128 // tile)
    Vp = b.attr_v.shape[1]
    rows = b.splat_rows
    assert rows.shape == (tile_span ** 2, Vp) and rows.dtype == torch.int32
    # every row of every run appears once, and only those
    c, s = b.counts.long(), b.starts.long()
    want = torch.cat([torch.arange(int(s[t]), int(s[t] + c[t]))
                      for t in range(c.shape[0])])
    got = rows[rows >= 0].long()
    assert torch.equal(torch.sort(got).values, want)
    # ... in the column of the row's splat
    col = torch.arange(Vp).expand_as(rows)[rows >= 0]
    assert torch.equal(b.pair_slot[got].long(), col)
    # splat_pair_rows, for any pair table, finds the same rows
    gen = cc.splat_pair_rows(b.counts, b.starts, b.pair_slot, Vp)
    assert torch.equal(torch.sort(gen[gen >= 0].long()).values, want)
    if tile_cap == 64:  # the tile cap dropped pairs: their rows are -1
        assert int(b.stats[2]) > 0

    args = (b.counts, b.starts, b.pair_slot, b.attr_v)
    out, n_contrib = cc.composite_fwd(*args, ntx, tile)
    g = torch.as_tensor(np.random.default_rng(1).normal(
        size=out.shape).astype(np.float32))
    g[:, 5:] = 0.0
    ref = cc.composite_bwd_plain(*args, out, n_contrib, g, ntx, tile)
    cell = cc.composite_bwd_cells_plain(*args, out, n_contrib, g, ntx, tile)
    got = cc.gather_cells_plain(cell, rows, ref.shape[0])
    scale = ref[:10].abs().amax(1, keepdim=True)
    assert (scale > 0).all()
    assert float(((got - ref)[:10].abs() / scale).max()) <= 1e-6
    assert (got[:, -1] == 0).all()  # the zero column has no pairs


# ---------------------------------------------------------------- K2 ----

def _chunk_cases():
    """(name, query (Q, 3), refs (R, 3), valid (R,), ref_order or None)
    float32 numpy; R spans several chunks of NN_CHUNK references."""
    rng = np.random.default_rng(0)
    cases = []
    # duplicates at equal distance in different chunks, listed so that
    # the higher index comes first; and mirror-image pairs about queries
    R = 1200
    refs = rng.normal(size=(R, 3)).astype(np.float32)
    valid = rng.random(R) > 0.2
    refs[900] = refs[40]
    refs[1100] = refs[300]
    valid[[40, 900, 300, 1100]] = True
    q = rng.normal(size=(130, 3)).astype(np.float32)
    q[:2] = refs[[40, 300]]  # distance 0, twice
    q[2] = 0.0
    refs[700], refs[20] = (0.01, 0.0, 0.0), (-0.01, 0.0, 0.0)
    valid[[700, 20]] = True
    # highest index first, and entries past the references (skipped)
    order = np.arange(R + 6)[::-1].astype(np.int32)
    cases.append(("ties_across_chunks", q, refs, valid, order))
    # queries on the faces and corners of the chunks' boxes
    refs = rng.uniform(0, 1, (3 * CH, 3)).astype(np.float32)
    valid = np.ones(3 * CH, bool)
    lo = refs.reshape(3, CH, 3).min(1)
    hi = refs.reshape(3, CH, 3).max(1)
    q = np.concatenate([lo, hi, np.stack([lo[:, 0], hi[:, 1], lo[:, 2]], 1),
                        rng.uniform(-0.5, 1.5, (70, 3))]).astype(np.float32)
    cases.append(("box_faces", q, refs, valid, None))
    # a metre-spaced surface 1e3 m out, queries a few cm off it, in
    # Morton order
    g = np.stack(np.meshgrid(np.arange(40), np.arange(20)), -1).reshape(-1, 2)
    refs = np.concatenate([1000.0 + 0.05 * g, np.full((800, 1), 1000.0)],
                          1).astype(np.float32)
    valid = rng.random(800) > 0.1
    q = (refs[:200] + rng.normal(0, 0.02, (200, 3))).astype(np.float32)
    cases.append(("far_1e3", q, refs, valid, "spatial"))
    # whole chunks with no valid reference, and an order longer than the
    # references (a sliced target)
    refs = rng.normal(size=(1000, 3)).astype(np.float32)
    valid = np.zeros(1000, bool)
    valid[300:420] = True
    valid[900:] = True
    order = rng.permutation(1100).astype(np.int32)
    cases.append(("invalid_chunks", q[:77], refs, valid, order))
    cases.append(("no_valid_ref", q[:70], refs, np.zeros(1000, bool),
                  None))
    return cases


CASES = {c[0]: c[1:] for c in _chunk_cases()}


def _tensors(name):
    q, refs, valid, order = CASES[name]
    rT = torch.as_tensor(refs.T.copy())
    v = torch.as_tensor(valid)
    bias = torch.where(v, 0.0, float(_BIG)).to(torch.float32)[None]
    if isinstance(order, str):
        order = spatial_order(rT, v)
    elif order is not None:
        order = torch.as_tensor(order)
    return torch.as_tensor(q), rT, bias, order


@pytest.mark.parametrize("name", list(CASES))
def test_chunk_lower_bound_never_exceeds_a_pair(name):
    q, rT, bias, order = _tensors(name)
    R = rT.shape[1]
    L = R if order is None else order.shape[0]
    pos = torch.arange(-(-L // CH) * CH)
    slot = pos if order is None else torch.cat(
        [order.long(), torch.full((pos.shape[0] - order.shape[0],), -1)])
    slot = torch.where((slot >= 0) & (slot < R), slot, -1)
    for c in range(pos.shape[0] // CH):
        s = slot[c * CH:(c + 1) * CH]
        s = s[s >= 0]
        s = s[bias[0, s] == 0]
        if s.numel() == 0:
            continue
        r = rT[:, s].T
        lo, hi = r.amin(0), r.amax(0)
        d = ((q[:, None, 0] - r[None, :, 0]) ** 2
             + (q[:, None, 1] - r[None, :, 1]) ** 2) + (
                 q[:, None, 2] - r[None, :, 2]) ** 2
        own = nn_cuda.chunk_lower_bound(q, q, lo, hi)
        assert (own <= d.amin(1)).all(), (name, c)
        for sel in (slice(0, 64), slice(None)):  # a group's box
            qq = q[sel]
            box = nn_cuda.chunk_lower_bound(qq.amin(0), qq.amax(0), lo, hi)
            assert float(box) <= float(d[sel].min()), (name, c)
            assert float(box) <= float(own[sel].min())


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_search_equals_plain(name):
    q, rT, bias, order = _tensors(name)
    want_i, want_d = nn_cuda.nn1_plain(q, rT, bias)
    qorder = torch.as_tensor(np.random.default_rng(2).permutation(
        q.shape[0]).astype(np.int32))
    stats = []
    for ro, qo in ((order, None), (None, qorder), (order, qorder)):
        i, d, st = nn_cuda.nn1_chunked_plain(q, rT, bias, ro, qo)
        assert torch.equal(i, want_i) and torch.equal(d, want_d), name
        stats.append(st)
    if name == "ties_across_chunks":
        assert want_i[0] == 40 and want_i[1] == 300
        assert want_i[2] == 20
        assert want_d[2] == np.float32(0.01) * np.float32(0.01)
    if name == "far_1e3":  # a surface in Morton order culls
        assert stats[0]["culled"] > 0.3
    if name == "no_valid_ref":
        assert (want_i == 0).all() and (want_d == _BIG).all()
        assert stats[0]["chunks"] == 0 and stats[0]["visits"] == 0


def test_orders_are_permutations():
    o = grid_block_order(11, 20, "cpu")
    assert torch.equal(torch.sort(o.long()).values, torch.arange(220))
    # the first group of 64 is the top-left 8x8 pixel block
    r, c = o[:64] // 20, o[:64] % 20
    assert int(r.max()) == 7 and int(c.max()) == 7
    rng = np.random.default_rng(4)
    pts = torch.as_tensor(rng.normal(size=(3, 500)).astype(np.float32))
    v = torch.as_tensor(rng.random(500) > 0.3)
    s = spatial_order(pts, v).long()
    assert torch.equal(torch.sort(s).values, torch.arange(500))
    nv = int(v.sum())
    assert v[s[:nv]].all() and torch.equal(
        s[nv:], torch.nonzero(~v).squeeze(1))


# ------------------------------------------------------------ K1-fwd ----

def _fwd_case(name):
    """(counts, starts, pair_slot, attr) tensors, ntx, tile."""
    if name.startswith("binned"):
        tile = int(name.split("_")[1])
        b = _binning(tile, 3 if tile == 16 else 2, 256)
        return (b.counts, b.starts, b.pair_slot, b.attr_v), -(-128 // tile), \
            tile
    rng = np.random.default_rng(7)
    tile = 32 if name.endswith("32") else 16
    ntx, nty, V, K = 3, 2, 256, 160
    T = ntx * nty
    counts = rng.integers(40, K, size=(T,)).astype(np.int32)
    counts[5] = 0  # an empty tile
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    pair_slot = rng.integers(0, V, size=(int(counts.sum()),)).astype(np.int32)
    attr = np.zeros((10, V), np.float32)
    attr[0] = rng.uniform(-8, ntx * tile + 8, V)
    attr[1] = rng.uniform(-8, nty * tile + 8, V)
    sat = name.startswith("saturated")
    lo, hi = (0.001, 0.01) if sat else (0.01, 0.2)
    attr[2] = rng.uniform(lo, hi, V)
    attr[4] = rng.uniform(lo, hi, V)
    attr[3] = rng.uniform(-0.9, 0.9, V) * np.sqrt(attr[2] * attr[4])
    attr[5:8] = rng.uniform(0, 1, (3, V))
    attr[8] = rng.uniform(0.8 if sat else 0.05, 0.99, V)
    attr[9] = rng.uniform(0.5, 5.0, V)
    if name.startswith("odd"):
        # conics and opacities the rectangle test must leave to the gate:
        # not positive definite, singular, condition ~1e6 and just under
        # 1e4, NaN, nearly zero; opacity 0, negative, NaN, tiny
        odd = [(-0.05, 0.0, 0.05, 0.6), (0.02, 0.05, 0.02, 0.6),
               (0.0, 0.0, 0.0, 0.6), (0.05, 0.05 * (1 - 1e-6), 0.05, 0.6),
               (0.05, 0.0498, 0.05, 0.6), (np.nan, 0.0, 0.05, 0.6),
               (0.01, 0.0, 1e-7, 0.6), (0.05, 0.0, 0.05, 0.0),
               (0.05, 0.0, 0.05, -0.5), (0.05, 0.0, 0.05, np.nan),
               (0.05, 0.0, 0.05, 1e-30)]
        for i, (a, b, c, op) in enumerate(odd):
            attr[2:5, i], attr[8, i] = (a, b, c), op
        pair_slot[::3] = rng.integers(0, len(odd), pair_slot[::3].shape)
    return [torch.as_tensor(a) for a in (counts, starts, pair_slot,
                                         attr)], ntx, tile


@pytest.mark.parametrize("name", ["random_16", "random_32", "saturated_32",
                                  "odd_16", "odd_32", "binned_16",
                                  "binned_32"])
def test_fwd_warp_cull_is_exact(name):
    """No pair the plain compositor blends or stops at is culled by a
    warp's rectangle or skipped below its gate power; the culled model
    gives the plain version's bits, and evaluated + culled = examined."""
    args, ntx, tile = _fwd_case(name)
    out0, nc0 = cc.composite_fwd_plain(*args, ntx, tile)
    out1, nc1, st = cc.composite_fwd_cull_plain(*args, ntx, tile)
    assert st["lost"] == 0
    assert torch.equal(out1, out0) and torch.equal(nc1, nc0)
    assert st["evaluated"] + st["culled"] == st["examined"]
    assert st["examined"] == cc.composite_work(*args, ntx, tile)
    if not name.startswith("saturated"):
        assert st["culled"] > 0.3 * st["examined"]


@pytest.mark.parametrize("tile", [4, 8, 16, 20, 32])
def test_fwd_warp_patches(tile):
    """Every pixel of a tile belongs to one warp, a warp holds at most 32
    pixels, and where the corner allows it a warp's pixels are an 8x4
    patch."""
    patch = cc.fwd_warp_patches(tile)
    assert (patch >= 0).all()
    n = torch.bincount(patch)
    assert int(n.max()) <= 32
    if tile % 8 == 0:
        pid = torch.arange(tile * tile)
        for w in range(int(patch.max()) + 1):
            x, y = pid[patch == w] % tile, pid[patch == w] // tile
            assert int(x.max() - x.min()) == 7 and int(y.max() - y.min()) == 3


def test_patch_culled_plain_bound():
    """On random conics and rectangles the test never culls a splat that
    reaches its gate power at one of the rectangle's pixels."""
    rng = np.random.default_rng(3)
    n = 4000
    a = np.zeros((10, n), np.float32)
    a[0], a[1] = rng.uniform(-20, 40, n), rng.uniform(-20, 40, n)
    a[2], a[4] = rng.uniform(1e-3, 1.0, n), rng.uniform(1e-3, 1.0, n)
    a[3] = rng.uniform(-0.999, 0.999, n) * np.sqrt(a[2] * a[4])
    a[8] = rng.uniform(0.0, 1.0, n)
    t = torch.as_tensor(a)
    xs, ys = torch.arange(8.0), torch.arange(4.0)  # an 8x4 patch at 0, 0
    culled = cc.patch_culled_plain(t, 0.0, 7.0, 0.0, 3.0)
    dx = xs[:, None, None] - t[0]
    dy = ys[None, :, None] - t[1]
    power = -0.5 * (t[2] * dx * dx + t[4] * dy * dy) - t[3] * dx * dy
    reach = (power >= cc.gate_power_plain(t[8])).any(1).any(0)
    assert not (culled & reach).any()
    assert culled.float().mean() > 0.3


# ---------------------------------------------------------------- K4 ----

def _dense_case(name, tile, dyn):
    """(counts or None, attrs (T, 16, K)), ntx: 6 tiles in rows of 3,
    K 128; tile 0 empty and tile 1 full (with counts), tile 2 at opacity
    0.  "path_d": chip_smoke.py's dense_inputs (conic 0.05, opacity
    0.1-0.9, centres over the image); "saturated": large opaque splats
    whose pixels stop early."""
    rng = np.random.default_rng(tile)
    T, ntx, K = 6, 3, 128
    counts = rng.integers(0, K + 1, size=(T,)).astype(np.int32)
    counts[[0, 1]] = (0, K)
    a = np.zeros((T, 16, K), np.float32)
    a[:, 0] = rng.uniform(0, ntx * tile, (T, K))
    a[:, 1] = rng.uniform(0, (T // ntx) * tile, (T, K))
    if name == "path_d":
        a[:, 2] = a[:, 4] = 0.05
        a[:, 8] = rng.uniform(0.1, 0.9, (T, K))
    else:
        a[:, 2] = rng.uniform(0.002, 0.01, (T, K))
        a[:, 4] = rng.uniform(0.002, 0.01, (T, K))
        a[:, 3] = rng.uniform(-0.9, 0.9, (T, K)) * np.sqrt(a[:, 2] * a[:, 4])
        a[:, 8] = rng.uniform(0.8, 0.99, (T, K))
    a[:, 5:8] = rng.uniform(0, 1, (T, 3, K))
    a[:, 9] = rng.uniform(0.5, 5.0, (T, K))
    a[2, 8] = 0.0
    return (torch.as_tensor(counts) if dyn else None), torch.as_tensor(a), ntx


@pytest.mark.parametrize("dyn", [False, True])
@pytest.mark.parametrize("name", ["path_d", "saturated"])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_dense_fwd_warp_cull_is_exact(tile, name, dyn):
    """K4's forward cull skips no pair the plain compositor blends or
    stops at: the culled model gives the plain version's bits, and
    evaluated + culled = examined (composite_dense_work)."""
    counts, attrs, ntx = _dense_case(name, tile, dyn)
    out0, nc0 = cc.composite_dense_fwd_plain(counts, attrs, ntx, tile)
    out1, nc1, st = cc.composite_dense_fwd_cull_plain(counts, attrs, ntx,
                                                      tile)
    assert st["lost"] == 0
    assert torch.equal(out1, out0) and torch.equal(nc1, nc0)
    assert st["evaluated"] + st["culled"] == st["examined"]
    assert st["examined"] == cc.composite_dense_work(counts, attrs, ntx,
                                                     tile)
    assert 0 < st["gated"] <= st["evaluated"]
    assert st["culled"] > 0


@pytest.mark.parametrize("name", ["path_d", "saturated"])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_dense_bwd_ranks_are_exact(tile, name):
    """K4's backward: a warp (one block per tile, 8x4 patches) walks the
    ranks below its pixels' largest n_contrib, and no rank it culls
    blends at one of its pixels; walked + culled is that bound summed
    over the warps."""
    counts, attrs, ntx = _dense_case(name, tile, True)
    _, nc = cc.composite_dense_fwd_plain(counts, attrs, ntx, tile)
    st = cc.composite_dense_bwd_ranks_plain(counts, attrs, nc, ntx, tile)
    patch = cc.fwd_warp_patches(tile, tile)
    T = attrs.shape[0]
    wwalk = torch.zeros((T, int(patch.max()) + 1), dtype=torch.long)
    wwalk = wwalk.scatter_reduce(1, patch.expand(T, -1), nc.long(), "amax")
    assert st["walked"] + st["culled"] == int(wwalk.sum())
    if name == "path_d":  # small splats miss some warps' patches
        assert st["culled"] > 0
    # every (pixel, rank) pair that blends in the backward's walk
    px, py, _, a = cc._dense_runs(counts, attrs, ntx, tile)
    rank = torch.arange(a.shape[2])
    blends = cc._geometry(a[:, :, None, :], px[..., None], py[..., None])[5] \
        & (rank < nc[..., None].long())                          # (T, P, K)
    rect = cc._warp_rects(px, py, patch)
    culled = cc.patch_culled_plain(a[:, :, None, :], *rect)      # (T, n, K)
    assert not (culled[:, patch] & blends).any()


# ---------------------------------------------------------------- K3 ----

@pytest.fixture(scope="module")
def frame0_knn():
    """The synthetic sequence's first downsampled cloud (1200x680,
    downsample 10) and knn_plain's k = 20 answer for every fourth point
    (rows are independent: the cost is in the reference, not the
    search)."""
    from gs_icp_slam_torch.config import synthetic_config
    from gs_icp_slam_torch.datasets import open_dataset

    seq = open_dataset("synthetic", width=1200, height=680, num_frames=1)
    intr = synthetic_config(seq.intr, downsample_rate=10).intr
    filt = make_downsample_filter(intr.width, intr.height, intr.fx, intr.fy,
                                  intr.cx, intr.cy, 10)
    fr = seq[0]
    pc = downsample_pointcloud(filt, torch.from_numpy(fr.depth),
                               torch.from_numpy(fr.rgb), intr.depth_scale,
                               intr.depth_trunc)
    pts, valid = pc["points"].contiguous(), pc["trackable"].contiguous()
    return pts, valid, nn_cuda.knn_plain(pts[::4].contiguous(), pts, valid,
                                         20)


def _knn_cases():
    rng = np.random.default_rng(1)
    cube = rng.uniform(-2, 2, (2000, 3)).astype(np.float32)
    base = rng.normal(size=(400, 3)).astype(np.float32)
    dup = np.concatenate([base, base[::-1], base])
    few = np.zeros(500, bool)
    few[[3, 77, 400]] = True
    return {
        "cube": (cube, cube, rng.random(2000) > 0.3, True),
        "duplicates": (dup, dup, rng.random(1200) > 0.2, True),
        "query_not_ref": (rng.normal(size=(301, 3)).astype(np.float32),
                          cube[:1777], rng.random(1777) > 0.3, False),
        "few_valid": (cube[:500], cube[:500], few, True),
        "no_refs": (cube[:40], np.zeros((0, 3), np.float32),
                    np.zeros(0, bool), False),
    }


KNN_CASES = _knn_cases()


def _knn_equal(q, r, v, k, want, unordered=True):
    i0, d0 = want
    have = d0 < 1e37
    for orders in (nn_cuda.knn_orders(q, r, v), (None, None))[
            :2 if unordered else 1]:
        i1, d1, st = nn_cuda.knn_chunked_plain(q, r, v, k, *orders)
        assert torch.equal(d1, d0)
        assert torch.equal(i1[have], i0[have])
    return st


@pytest.mark.parametrize("k", [20, 4])
def test_knn_chunked_search_on_frame0(frame0_knn, k):
    pts, valid, (i20, d20) = frame0_knn
    # knn_plain's first k columns are its k-NN (a stable sort)
    ro, qo = nn_cuda.knn_orders(pts, pts, valid)
    i1, d1, st = nn_cuda.knn_chunked_plain(pts, pts, valid, k, ro, qo)
    assert torch.equal(d1[::4], d20[:, :k]) and torch.equal(i1[::4],
                                                            i20[:, :k])
    assert st["culled"] > 0.8  # a surface in Morton cells culls


@pytest.mark.parametrize("k", [1, 4, 20, 32])
@pytest.mark.parametrize("name", list(KNN_CASES))
def test_knn_chunked_search_equals_plain(name, k):
    q, r, v, same = KNN_CASES[name]
    r, v = torch.as_tensor(r), torch.as_tensor(v)
    q = r if same else torch.as_tensor(q)
    st = _knn_equal(q, r, v, k, nn_cuda.knn_plain(q, r, v, k),
                    unordered=name != "cube")
    if name == "few_valid":
        assert st["culled"] == 0.0  # no threshold below 3.4e38: no cull


def test_knn_order_plain():
    """morton_order (K3's order at 5 bits, K2's at 10): a permutation, the
    valid points by Morton cell, the invalid ones after them in index
    order."""
    rng = np.random.default_rng(6)
    pts = torch.as_tensor(rng.normal(size=(900, 3)).astype(np.float32))
    pts[5] = float("nan")
    v = torch.as_tensor(rng.random(900) > 0.25)
    nv = int(v.sum())
    for bits in (5, 10):
        o = nn_cuda.morton_order(pts, v, bits).long()
        assert torch.equal(torch.sort(o).values, torch.arange(900))
        assert v[o[:nv]].all()
        assert torch.equal(o[nv:], torch.nonzero(~v).squeeze(1))
    # K2's target order is the same function on a (3, T) cloud
    assert torch.equal(spatial_order(pts.T.contiguous(), v),
                       nn_cuda.morton_order(pts, v, 10))
    # the 32^3 cells of the valid points ascend along the order
    p = pts[nn_cuda.morton_order(pts, v).long()[:nv]]
    lo = p.nan_to_num(nan=float("inf")).amin(0)
    hi = p.nan_to_num(nan=-float("inf")).amax(0)
    c = ((p - lo) / (hi - lo) * 32).nan_to_num(nan=0.0).clamp(0, 31).long()
    code = sum(((c[:, a] >> b) & 1) << (3 * b + a) for b in range(5)
               for a in range(3))
    assert (code[1:] >= code[:-1]).all()
    assert nn_cuda.morton_order(torch.zeros((0, 3))).shape == (0,)
