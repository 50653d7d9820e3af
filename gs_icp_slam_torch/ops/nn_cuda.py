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

K2 searches reference chunks nearest first and skips the chunks a box
bound rules out (csrc/nn1.cu).  `chunk_lower_bound` mirrors that bound and
`nn1_chunked_plain` the search in plain PyTorch, one chunk at a time: the
tests hold it to nn1_plain exactly.  `nn1_search_counts` reads the
kernel's own count of the chunks it compared, for chip_smoke.py.
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
                 [_P, _P, _P, _I, _I, _I, _P, _P, _P])

# csrc/nn1.cu's geometry: references per chunk, queries per group, and the
# most chunks one call takes (its sort buffer)
NN_CHUNK = 128
NN_GROUP = 64
NN_MAX_CHUNKS = 8192
# the relative margin the chunk bound is shrunk by
_SHRINK = 1.0 - 2.0 ** -20


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
    Q, Tp = query.shape[0], rT.shape[1]
    L = Tp if ref_order is None else ref_order.shape[0]
    nch = -(-L // NN_CHUNK)
    inf = float("inf")
    big_i = torch.iinfo(torch.int64).max
    # the chunks: positions of the order, invalid references dropped
    slot = _pad_order(ref_order, L, nch * NN_CHUNK, dev)
    slot = torch.where(slot < Tp, slot, -1)
    sc = slot.clamp(min=0)
    ok = (slot >= 0) & (bias[0, sc] == 0) if Tp else slot >= 0
    refs = (rT[:, sc].T if Tp else torch.zeros((sc.shape[0], 3),
                                              device=dev)).reshape(
                                                  nch, NN_CHUNK, 3)
    ok = ok.reshape(nch, NN_CHUNK)
    slots = sc.reshape(nch, NN_CHUNK)
    okx = ok[..., None] & ~torch.isnan(refs)
    lo = torch.where(okx, refs, inf).amin(1)
    hi = torch.where(okx, refs, -inf).amax(1)
    filled = ok.sum(1) > 0
    # the query groups, and their boxes over the live (finite) queries
    ngr = -(-Q // NN_GROUP)
    qid = _pad_order(query_order, Q, ngr * NN_GROUP, dev)
    active = (qid >= 0).reshape(ngr, NN_GROUP)
    qs = query[qid.clamp(min=0)].reshape(ngr, NN_GROUP, 3) if Q else \
        torch.zeros((0, NN_GROUP, 3), device=dev)
    live = active & torch.isfinite(qs).all(-1)
    glo = torch.where(live[..., None], qs, inf).amin(1)
    ghi = torch.where(live[..., None], qs, -inf).amax(1)
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
    n_filled = int(filled.sum())
    cand = ngr * n_filled
    stats = dict(groups=ngr, chunks=n_filled, visits=visits,
                 culled=1.0 - visits / cand if cand else 0.0, pairs=pairs)
    return idx, sqd, stats


def _nn1(query, rT, bias, ref_order, query_order):
    """Launch K2: (idx, sqd, its scratch buffer, chunk count)."""
    dev = query.device
    Tp = rT.shape[1]
    Q = query.shape[0]
    L = Tp if ref_order is None else ref_order.shape[0]
    nch = -(-L // NN_CHUNK)
    if nch > NN_MAX_CHUNKS:
        raise ValueError(f"{L} references: K2 takes at most "
                         f"{NN_MAX_CHUNKS * NN_CHUNK}")
    idx = torch.empty(Q, dtype=torch.int32, device=dev)
    sqd = torch.empty(Q, dtype=torch.float32, device=dev)
    # per chunk: packed references (16 bytes each), two box corners and a
    # count; two 64-bit counters
    m = max(nch, 1)
    scratch = torch.empty(m * (NN_CHUNK * 16 + 36) + 16, dtype=torch.uint8,
                          device=dev)
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
    m = max(nch, 1)
    off = m * (NN_CHUNK * 16 + 32)
    visits, refs = scratch[off:off + 16].view(torch.int64).tolist()
    filled = int((scratch[off + 16:off + 16 + 4 * nch].view(torch.int32)
                  > 0).sum())
    groups = -(-query.shape[0] // NN_GROUP)
    cand = groups * filled
    stats = dict(groups=groups, chunks=filled, visits=visits,
                 culled=1.0 - visits / cand if cand else 0.0,
                 pairs=refs * NN_GROUP)
    return idx, sqd, stats


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


def knn_search_kernel(query: torch.Tensor, ref: torch.Tensor,
                      ref_valid: torch.Tensor, k: int = 20):
    """Exact k-NN (kernel K3), 1 <= k <= 32: idx (Q, k) int32 nearest
    first (self included when query is ref) and sqd (Q, k) float32; ties
    to the lowest index; missing neighbours report 3.4e38 with an
    unspecified index."""
    dev = query.device
    R = ref.shape[0]
    check_tensor("query", query, torch.float32, (None, 3), dev)
    check_tensor("ref", ref, torch.float32, (None, 3), dev)
    check_tensor("ref_valid", ref_valid, torch.bool, (R,), dev)
    if not 1 <= k <= 32:
        raise ValueError(f"k={k} outside 1..32")
    if not on_cuda(dev):
        return knn_plain(query, ref, ref_valid, k)
    Q = query.shape[0]
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    sqd = torch.empty((Q, k), dtype=torch.float32, device=dev)
    KNN(query.data_ptr(), ref.data_ptr(), ref_valid.data_ptr(), Q, R, k, idx.data_ptr(), sqd.data_ptr(),
        stream_ptr(dev))
    return idx, sqd
