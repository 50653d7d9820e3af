"""Nearest-neighbour kernels K2 (masked 1-NN) and K3 (exact k-NN).

Counterpart of gs_icp_slam_tpu/ops/nn_pallas.py.  Each wrapper launches
its hand-written CUDA kernel (csrc/nn1.cu, csrc/knn.cu) for CUDA tensors
and runs the plain PyTorch version beside it for CPU tensors; nothing
falls back from one to the other.

The distance is the Pallas kernels' direct form ((q-r)^2 summed over
x, y, z, plus an additive bias of 0 on valid and +3.4e38 on invalid
references), not the |q|^2 - 2 q.r + |r|^2 form of the JAX package's XLA
fallbacks: the two round differently and can pick different neighbours on
a near tie.

Both kernels search chunks of references in a spatial order, nearest
first, and skip the chunks a box bound rules out (csrc/nn_common.cuh):
K2 takes the Morton order its G-ICP target carries (ops.gicp
spatial_order), K3 sorts both clouds by Morton cell on the card in its
own launch; `morton_order` is both orders in plain PyTorch.
`chunk_lower_bound` mirrors that bound, and `nn1_chunked_plain` /
`knn_chunked_plain` the two searches in plain PyTorch, one chunk at a
time: the tests hold them to nn1_plain and knn_plain exactly.
`nn1_search_counts` and `knn_search_counts` read the kernels' own counts
of the chunks they compared, for chip_smoke.py.
"""
from __future__ import annotations

import ctypes

import torch

from ..cuda_build import CudaKernel, check_tensor, on_cuda, stream_ptr

_BIG = 3.4e38
_P = ctypes.c_void_p
_I = ctypes.c_int

NN1 = CudaKernel("nn1", "nn1.cu", "nn1_launch",
                 [_P, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P])
KNN = CudaKernel("knn", "knn.cu", "knn_launch",
                 [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P])

# csrc/nn_common.cuh's geometry: references per chunk; queries per group
# of K2 (nn1.cu) and of K3 (knn.cu)
NN_CHUNK = 128
NN_GROUP = 64
KNN_GROUP = 32
# csrc/knn.cu's order: Morton cells on a grid of 2^KNN_CELL_BITS a side
KNN_CELL_BITS = 5
# the relative margin the chunk bound is shrunk by
_SHRINK = 1.0 - 2.0 ** -20


# ------------------------------------ the chunked searches, plain models -----

def _plain_chunks(pts: torch.Tensor, ok: torch.Tensor, order, L: int):
    """The kernels' chunks (nn_common.cuh nn_chunks) of the points (n, 3)
    with validity ok (n,), taken in `order` (L positions, None: index
    order): points (nch, NN_CHUNK, 3), in-chunk mask, slots, boxes lo and
    hi (nch, 3) over the valid non-NaN coordinates, and whether each chunk
    holds a valid reference."""
    dev = pts.device
    n = pts.shape[0]
    nch = -(-L // NN_CHUNK)
    slot = _pad_order(order, L, nch * NN_CHUNK, dev)
    slot = torch.where(slot < n, slot, -1)
    sc = slot.clamp(min=0)
    inc = (slot >= 0) & ok[sc] if n else slot >= 0
    refs = (pts[sc] if n else torch.zeros((sc.shape[0], 3), device=dev)
            ).reshape(nch, NN_CHUNK, 3)
    inc = inc.reshape(nch, NN_CHUNK)
    okx = inc[..., None] & ~torch.isnan(refs)
    inf = float("inf")
    lo = torch.where(okx, refs, inf).amin(1)
    hi = torch.where(okx, refs, -inf).amax(1)
    return refs, inc, sc.reshape(nch, NN_CHUNK), lo, hi, inc.sum(1) > 0


def _plain_groups(query: torch.Tensor, order, G: int):
    """The kernels' query groups of G, taken in `order`: the query of each
    place (-1 past Q), its point (ngr, G, 3), whether it is a query and
    whether it is live (finite), and the groups' boxes over the live
    ones."""
    dev = query.device
    Q = query.shape[0]
    ngr = -(-Q // G)
    qid = _pad_order(order, Q, ngr * G, dev)
    active = (qid >= 0).reshape(ngr, G)
    qs = query[qid.clamp(min=0)].reshape(ngr, G, 3) if Q else \
        torch.zeros((0, G, 3), device=dev)
    live = active & torch.isfinite(qs).all(-1)
    inf = float("inf")
    glo = torch.where(live[..., None], qs, inf).amin(1)
    ghi = torch.where(live[..., None], qs, -inf).amax(1)
    return qid, active, qs, live, glo, ghi


def _search_stats(ngr: int, filled: int, visits: int, pairs: int):
    """The chunked searches' stats (see nn1_chunked_plain)."""
    cand = ngr * filled
    return dict(groups=ngr, chunks=filled, visits=visits,
                culled=1.0 - visits / cand if cand else 0.0, pairs=pairs)


# ---------------------------------------------------------------- K2 -----

def nn1_plain(query: torch.Tensor, rT: torch.Tensor, bias: torch.Tensor,
              q_chunk: int = 1024):
    """Plain PyTorch K2: the same function, in query chunks of (q_chunk,
    Tp) distance blocks."""
    Q = query.shape[0]
    b = bias.reshape(1, -1)
    idx = torch.zeros(Q, dtype=torch.int32, device=query.device)
    sqd = torch.full((Q,), _BIG, dtype=torch.float32, device=query.device)
    if rT.shape[1] == 0:
        return idx, sqd
    for s in range(0, Q, q_chunk):
        q = query[s:s + q_chunk]
        dx = q[:, 0:1] - rT[0:1]
        dy = q[:, 1:2] - rT[1:2]
        dz = q[:, 2:3] - rT[2:3]
        m = dx * dx + dy * dy + dz * dz + b
        d, i = torch.min(m, dim=1)  # first (lowest) index among ties
        found = d < _BIG
        idx[s:s + q_chunk] = torch.where(found, i.to(torch.int32), 0)
        sqd[s:s + q_chunk] = torch.where(found, d, _BIG)
    return idx, sqd


def chunk_lower_bound(qlo: torch.Tensor, qhi: torch.Tensor,
                      lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """K2's lower bound on the rounded squared distance between any point
    of box [qlo, qhi] and any point of box [lo, hi] ((..., 3) float32
    corners, broadcast): per axis the gap max(qlo - hi, lo - qhi, 0) (a
    NaN gap counts as 0), then ((gx*gx + gy*gy) + gz*gz) * (1 - 2^-20),
    each operation rounded on its own as in the kernel."""
    zero = torch.zeros((), dtype=qlo.dtype, device=qlo.device)
    g = torch.fmax(torch.fmax(qlo - hi, lo - qhi), zero)
    s = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]
    return s * _SHRINK


def _pad_order(order, n, m, dev):
    """positions 0..m-1 of an order over n items (identity when None),
    -1 past its end."""
    pos = torch.arange(m, device=dev)
    if order is None:
        return torch.where(pos < n, pos, -1)
    out = torch.full((m,), -1, dtype=torch.long, device=dev)
    out[:order.shape[0]] = order.long()
    return out


def nn1_chunked_plain(query: torch.Tensor, rT: torch.Tensor,
                      bias: torch.Tensor, ref_order=None, query_order=None):
    """Plain PyTorch model of K2's chunked search, all query groups at
    once: the same chunks, bounds, skip and stop rules and tie rule as
    csrc/nn1.cu, with the chunks of a group compared one at a time,
    nearest first (the kernel does so for its first few, then lets its
    warps take the rest in parallel), so the same results as nn1_plain.
    Returns (idx, sqd, stats) with stats = {"groups", "chunks" (non-empty
    ones), "visits" (group-chunk pairs compared), "culled" (the share of
    group-chunk pairs with a non-empty chunk that were not compared),
    "pairs" (query-reference pairs compared, NN_GROUP per reference of a
    compared chunk)}: the one-at-a-time schedule's counts, at most the
    kernel's."""
    dev = query.device
    Tp = rT.shape[1]
    L = Tp if ref_order is None else ref_order.shape[0]
    big_i = torch.iinfo(torch.int64).max
    refs, ok, slots, lo, hi, filled = _plain_chunks(rT.T, bias[0] == 0,
                                                    ref_order, L)
    nch = refs.shape[0]
    qid, active, qs, live, glo, ghi = _plain_groups(query, query_order,
                                                    NN_GROUP)
    ngr = qs.shape[0]
    Q = query.shape[0]
    inf = float("inf")
    lb = chunk_lower_bound(glo[:, None], ghi[:, None], lo[None], hi[None])
    lb = torch.where(filled[None], lb, inf)
    order = torch.sort(lb, dim=1, stable=True).indices       # (ngr, nch)
    best_d = torch.full((ngr, NN_GROUP), _BIG, dtype=torch.float32,
                        device=dev)
    best_i = torch.zeros((ngr, NN_GROUP), dtype=torch.int64, device=dev)
    going = torch.ones(ngr, dtype=torch.bool, device=dev)
    visits = pairs = 0
    for k in range(nch):
        c = order[:, k]
        worst = torch.where(live, best_d, 0.0).amax(1)
        going = going & ~(lb.gather(1, c[:, None])[:, 0] > worst)
        if not bool(going.any()):
            break
        qlb = chunk_lower_bound(qs, qs, lo[c][:, None], hi[c][:, None])
        need = going & (live & (qlb <= best_d)).any(1)
        gsel = torch.nonzero(need).squeeze(1)
        if gsel.numel() == 0:
            continue
        cs = c[gsel]
        r, okc, sl, q = refs[cs], ok[cs], slots[cs], qs[gsel]
        dx = q[:, :, None, 0] - r[:, None, :, 0]
        dy = q[:, :, None, 1] - r[:, None, :, 1]
        dz = q[:, :, None, 2] - r[:, None, :, 2]
        d = (dx * dx + dy * dy) + dz * dz
        # the kernel never takes a NaN distance (a reference with a NaN
        # coordinate)
        d = torch.where(okc[:, None] & ~torch.isnan(d), d, inf)
        dmin = d.amin(2)
        imin = torch.where(d == dmin[..., None], sl[:, None], big_i).amin(2)
        bd, bi = best_d[gsel], best_i[gsel]
        take = live[gsel] & ((dmin < bd) | ((dmin == bd) & (imin < bi)))
        best_d[gsel] = torch.where(take, dmin, bd)
        best_i[gsel] = torch.where(take, imin, bi)
        visits += int(gsel.numel())
        pairs += int(okc.sum()) * NN_GROUP
    idx = torch.zeros(Q, dtype=torch.int32, device=dev)
    sqd = torch.full((Q,), _BIG, dtype=torch.float32, device=dev)
    a = active.reshape(-1)
    idx[qid[a]] = best_i.reshape(-1)[a].to(torch.int32)
    sqd[qid[a]] = best_d.reshape(-1)[a]
    return idx, sqd, _search_stats(ngr, int(filled.sum()), visits, pairs)


def _chunk_scratch(nch: int, dev) -> torch.Tensor:
    """The chunked searches' scratch (gs::chunk_scratch): per chunk the
    packed references (16 bytes each), two box corners and a count; two
    64-bit counters."""
    m = max(nch, 1)
    return torch.empty(m * (NN_CHUNK * 16 + 36) + 16, dtype=torch.uint8,
                       device=dev)


def _kernel_stats(scratch: torch.Tensor, nch: int, groups: int, G: int):
    """What a chunked search did, from its scratch (a host sync): the
    counters of (group, chunk) visits and references compared, and the
    chunks holding a valid reference."""
    m = max(nch, 1)
    off = m * (NN_CHUNK * 16 + 32)
    visits, refs = scratch[off:off + 16].view(torch.int64).tolist()
    filled = int((scratch[off + 16:off + 16 + 4 * nch].view(torch.int32)
                  > 0).sum())
    return _search_stats(groups, filled, visits, refs * G)


def _nn1(query, rT, bias, ref_order, query_order):
    """Launch K2: (idx, sqd, its scratch buffer, chunk count)."""
    dev = query.device
    Tp = rT.shape[1]
    Q = query.shape[0]
    L = Tp if ref_order is None else ref_order.shape[0]
    nch = -(-L // NN_CHUNK)
    idx = torch.empty(Q, dtype=torch.int32, device=dev)
    sqd = torch.empty(Q, dtype=torch.float32, device=dev)
    scratch = _chunk_scratch(nch, dev)
    NN1(query.data_ptr(),
        None if query_order is None else query_order.data_ptr(), Q,
        rT.data_ptr(), bias.data_ptr(), Tp,
        None if ref_order is None else ref_order.data_ptr(), L,
        scratch.data_ptr(), idx.data_ptr(), sqd.data_ptr(), stream_ptr(dev))
    return idx, sqd, scratch, nch


def _check_nn(query, rT, bias, ref_order, query_order):
    dev = query.device
    Tp = rT.shape[1] if rT.dim() == 2 else -1
    check_tensor("query", query, torch.float32, (None, 3), dev)
    check_tensor("rT", rT, torch.float32, (3, None), dev)
    check_tensor("bias", bias, torch.float32, (1, Tp), dev)
    if ref_order is not None:
        check_tensor("ref_order", ref_order, torch.int32, (None,), dev)
        if ref_order.shape[0] < Tp:
            raise ValueError(f"ref_order lists {ref_order.shape[0]} of {Tp} "
                             "references")
    if query_order is not None:
        check_tensor("query_order", query_order, torch.int32,
                     (query.shape[0],), dev)


def nn_search_pre(query: torch.Tensor, rT: torch.Tensor, bias: torch.Tensor,
                  ref_order: torch.Tensor | None = None,
                  query_order: torch.Tensor | None = None):
    """Masked 1-NN against a prepared reference (kernel K2): query (Q, 3),
    rT (3, Tp) channel-first points, bias (1, Tp) additive validity bias
    (0 valid, +3.4e38 invalid).  Returns idx (Q,) int32 and sqd (Q,)
    float32; ties go to the lowest index, and a query with no valid
    reference gets (0, 3.4e38).  This is the G-ICP inner-loop entry: the
    target keeps this layout (ops.gicp.GICPTarget).

    ref_order (L,) int32, a permutation of [0, L) with L >= Tp (entries
    >= Tp are skipped), and query_order (Q,) int32, a permutation of
    [0, Q), list the points so that neighbours in space are near each
    other in them; they make the kernel's chunk bounds tight and never
    change the result."""
    _check_nn(query, rT, bias, ref_order, query_order)
    if not on_cuda(query.device):
        return nn1_plain(query, rT, bias)
    return _nn1(query, rT, bias, ref_order, query_order)[:2]


def nn1_search_counts(query: torch.Tensor, rT: torch.Tensor,
                      bias: torch.Tensor, ref_order=None, query_order=None):
    """K2 on the card as nn_search_pre, also reading what its search did
    (a host sync; for measurement): (idx, sqd, stats), stats with
    nn1_chunked_plain's keys, counted by the kernel.  Its warps visit
    chunks in parallel, so the counts can differ from the plain model's
    and from one call to the next; the results cannot."""
    _check_nn(query, rT, bias, ref_order, query_order)
    if not on_cuda(query.device):
        raise ValueError("nn1_search_counts reads the kernel's counters: "
                         "CUDA tensors only")
    idx, sqd, scratch, nch = _nn1(query, rT, bias, ref_order, query_order)
    return idx, sqd, _kernel_stats(scratch, nch,
                                   -(-query.shape[0] // NN_GROUP), NN_GROUP)


def prepare_refs(ref: torch.Tensor, ref_valid: torch.Tensor):
    """(R, 3) points and (R,) validity -> K2's (3, R) rT and (1, R) bias."""
    rT = ref.T.contiguous()
    bias = torch.where(ref_valid, 0.0, _BIG).to(torch.float32).reshape(1, -1)
    return rT, bias.contiguous()


# ---------------------------------------------------------------- K3 -----

def knn_plain(query: torch.Tensor, ref: torch.Tensor,
              ref_valid: torch.Tensor, k: int, q_chunk: int = 512):
    """Plain PyTorch K3: distance rows in query chunks, ordered by a stable
    sort, which is the (distance, index) order of the kernel."""
    Q, R = query.shape[0], ref.shape[0]
    dev = query.device
    bias = torch.where(ref_valid, 0.0, _BIG).to(torch.float32)[None]
    idx = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    sqd = torch.full((Q, k), _BIG, dtype=torch.float32, device=dev)
    kk = min(k, R)
    if kk == 0:
        return idx, sqd
    for s in range(0, Q, q_chunk):
        q = query[s:s + q_chunk]
        dx = q[:, 0:1] - ref[:, 0][None]
        dy = q[:, 1:2] - ref[:, 1][None]
        dz = q[:, 2:3] - ref[:, 2][None]
        m = dx * dx + dy * dy + dz * dz + bias
        vals, order = torch.sort(m, dim=1, stable=True)
        idx[s:s + q_chunk, :kk] = order[:, :kk].to(torch.int32)
        sqd[s:s + q_chunk, :kk] = torch.clamp(vals[:, :kk], max=_BIG)
    return idx, sqd


def knn_chunked_plain(query: torch.Tensor, ref: torch.Tensor,
                      ref_valid: torch.Tensor, k: int, ref_order=None,
                      query_order=None):
    """Plain PyTorch model of K3's chunked search, all query groups at
    once: the same chunks, group boxes, bounds, skip and strict stop rules
    and (distance, index) order as csrc/knn.cu, with the chunks of a group
    compared one at a time, nearest first, into one list per query (the
    kernel keeps one list per warp, bounds a short one by its first chunk
    and merges them), so the same results
    as knn_plain: indices where a neighbour exists, distances everywhere
    (missing neighbours report (0, 3.4e38)).  Returns (idx, sqd, stats),
    stats with nn1_chunked_plain's keys, pairs counting KNN_GROUP per
    reference of a compared chunk."""
    dev = query.device
    R = ref.shape[0]
    L = R if ref_order is None else ref_order.shape[0]
    refs, ok, slots, lo, hi, filled = _plain_chunks(ref, ref_valid,
                                                    ref_order, L)
    nch = refs.shape[0]
    qid, active, qs, live, glo, ghi = _plain_groups(query, query_order,
                                                    KNN_GROUP)
    ngr = qs.shape[0]
    inf = float("inf")
    lb = chunk_lower_bound(glo[:, None], ghi[:, None], lo[None], hi[None])
    lb = torch.where(filled[None], lb, inf)
    order = torch.sort(lb, dim=1, stable=True).indices       # (ngr, nch)
    # each list entry is the word (distance bits << 32 | index): for
    # distances >= +0 the words order as (distance, index) pairs do
    empty = int(torch.tensor(_BIG, dtype=torch.float32).view(
        torch.int32)) << 32
    lists = torch.full((ngr, KNN_GROUP, k), empty, dtype=torch.int64,
                       device=dev)
    going = torch.ones(ngr, dtype=torch.bool, device=dev)
    visits = pairs = 0
    for j in range(nch):
        c = order[:, j]
        thr = (lists[..., k - 1] >> 32).to(torch.int32).view(torch.float32)
        worst = torch.where(live, thr, 0.0).amax(1)
        going = going & ~(lb.gather(1, c[:, None])[:, 0] > worst)
        if not bool(going.any()):
            break
        qlb = chunk_lower_bound(qs, qs, lo[c][:, None], hi[c][:, None])
        need = going & (live & (qlb <= thr)).any(1)
        gsel = torch.nonzero(need).squeeze(1)
        if gsel.numel() == 0:
            continue
        cs = c[gsel]
        r, okc, sl, q = refs[cs], ok[cs], slots[cs], qs[gsel]
        dx = q[:, :, None, 0] - r[:, None, :, 0]
        dy = q[:, :, None, 1] - r[:, None, :, 1]
        dz = q[:, :, None, 2] - r[:, None, :, 2]
        d = (dx * dx + dy * dy) + dz * dz
        # the kernel takes a reference at a distance of at most the
        # threshold (never a NaN one) into a live query's list
        take = (okc[:, None] & (d <= thr[gsel][..., None])
                & live[gsel][..., None])
        words = torch.where(
            take, (d.view(torch.int32).to(torch.int64) << 32) | sl[:, None],
            torch.iinfo(torch.int64).max)
        lists[gsel] = torch.cat([lists[gsel], words], -1).sort(-1).values[
            ..., :k]
        visits += int(gsel.numel())
        pairs += int(okc.sum()) * KNN_GROUP
    idx = torch.zeros((query.shape[0], k), dtype=torch.int32, device=dev)
    sqd = torch.full((query.shape[0], k), _BIG, dtype=torch.float32,
                     device=dev)
    a = active.reshape(-1)
    w = lists.reshape(-1, k)[a]
    idx[qid[a]] = (w & 0xFFFFFFFF).to(torch.int32)
    sqd[qid[a]] = (w >> 32).to(torch.int32).view(torch.float32)
    return idx, sqd, _search_stats(ngr, int(filled.sum()), visits, pairs)


def _check_knn(query, ref, ref_valid, k):
    dev = query.device
    check_tensor("query", query, torch.float32, (None, 3), dev)
    check_tensor("ref", ref, torch.float32, (None, 3), dev)
    check_tensor("ref_valid", ref_valid, torch.bool, (ref.shape[0],), dev)
    if k < 1:
        raise ValueError(f"k={k}: needs k >= 1")


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """The low 10 bits of x (int64) moved to bits 0, 3, 6, ..., 27."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_order(points: torch.Tensor, valid: torch.Tensor | None = None,
                 bits: int = KNN_CELL_BITS) -> torch.Tensor:
    """The port's spatial order of a (n, 3) cloud (any strides): the valid
    points by the Morton code of their cell on a grid of 2^bits cells a
    side (bits <= 10) over the valid points' bounding box (NaN coordinates
    left out of the box, and in cell 0), then the invalid ones in
    increasing index (valid None: all valid), so that a run of the order
    is a compact piece of space.  (n,) int32, a permutation of [0, n);
    one sort, no host sync.  K3 builds it on the card at bits 5
    (csrc/knn.cu knn_order, which lists the points of one cell in any
    order; here in index order); K2's targets take it at bits 10
    (ops.gicp.spatial_order)."""
    n = points.shape[0]
    dev = points.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    v = torch.ones(n, dtype=torch.bool, device=dev) if valid is None \
        else valid
    inf = float("inf")  # Python scalars: no upload, no host sync
    lo = torch.where(v[:, None], points.nan_to_num(nan=inf), inf).amin(0)
    hi = torch.where(v[:, None], points.nan_to_num(nan=-inf), -inf).amax(0)
    # (a NaN span, inf - inf, gives the cells the kernel's 1e-12 gives)
    span = torch.clamp(hi - lo, min=1e-12)
    side = 1 << bits
    cell = ((points - lo) / span * float(side)).nan_to_num(nan=0.0).clamp(
        0, side - 1).to(torch.int64)
    s = _spread3(cell)  # all three axes at once
    code = s[:, 0] | (s[:, 1] << 1) | (s[:, 2] << 2)
    key = torch.where(v, code, 1 << (3 * bits)) * n + torch.arange(
        n, device=dev)
    return torch.sort(key).indices.to(torch.int32)


def knn_orders(query: torch.Tensor, ref: torch.Tensor,
               ref_valid: torch.Tensor):
    """K3's orders in plain PyTorch: the references' (morton_order), and
    the queries' (the same one when query is ref, as in every caller; else
    the order of the queries as a cloud of valid points)."""
    ro = morton_order(ref, ref_valid)
    return ro, ro if query is ref else morton_order(query)


def _knn_scratch_bytes(Q: int, R: int) -> int:
    """csrc/knn.cu scratch_bytes: the chunk scratch, 16-byte aligned, the
    order's work (its box and histogram), then the two orders."""
    m = max(-(-R // NN_CHUNK), 1)
    work = 4 * (8 + (1 << (3 * KNN_CELL_BITS)) + 1)
    return (-(-(m * (NN_CHUNK * 16 + 36) + 16) // 16) * 16 + work + 4 * R
            + 4 * Q)


def _knn(query, ref, ref_valid, k, count):
    """Launch K3 (it orders both clouds itself): (idx, sqd, its scratch
    buffer, chunk count)."""
    dev = query.device
    Q, R = query.shape[0], ref.shape[0]
    nch = -(-R // NN_CHUNK)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    sqd = torch.empty((Q, k), dtype=torch.float32, device=dev)
    scratch = torch.empty(_knn_scratch_bytes(Q, R), dtype=torch.uint8,
                          device=dev)
    KNN(query.data_ptr(), Q, ref.data_ptr(), ref_valid.data_ptr(), R, k,
        int(query is ref), int(count), scratch.data_ptr(), idx.data_ptr(),
        sqd.data_ptr(), stream_ptr(dev))
    return idx, sqd, scratch, nch


def knn_search_kernel(query: torch.Tensor, ref: torch.Tensor,
                      ref_valid: torch.Tensor, k: int = 20):
    """Exact k-NN (kernel K3), any k >= 1: idx (Q, k) int32 nearest
    first (self included when query is ref) and sqd (Q, k) float32; ties
    to the lowest index; missing neighbours report 3.4e38 with an
    unspecified index.  On the card the kernel orders both clouds in
    space itself (morton_order's up to the points of a cell; one
    order when query is ref), one call, no host sync, and reports in the
    caller's order; any number of references (its chunks sorted 8,192 at
    a time).  Above k = 32 it searches once per 32 neighbours, each pass
    above the last one's farthest (distance, index)."""
    _check_knn(query, ref, ref_valid, k)
    if not on_cuda(query.device):
        return knn_plain(query, ref, ref_valid, k)
    return _knn(query, ref, ref_valid, k, False)[:2]


def knn_search_counts(query: torch.Tensor, ref: torch.Tensor,
                      ref_valid: torch.Tensor, k: int = 20):
    """K3 on the card as knn_search_kernel, also reading what its search
    did (a host sync; for measurement): (idx, sqd, stats), stats with
    knn_chunked_plain's keys, counted by the kernel (over all its passes,
    above k = 32).  Its warps visit chunks in parallel, so the
    counts can differ from the plain model's and from one call to the
    next; the results cannot."""
    _check_knn(query, ref, ref_valid, k)
    if not on_cuda(query.device):
        raise ValueError("knn_search_counts reads the kernel's counters: "
                         "CUDA tensors only")
    idx, sqd, scratch, nch = _knn(query, ref, ref_valid, k, True)
    return idx, sqd, _kernel_stats(scratch, nch,
                                   -(-query.shape[0] // KNN_GROUP),
                                   KNN_GROUP)
