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
"""
from __future__ import annotations

import ctypes

import torch

from ..cuda_build import CudaKernel, check_tensor, on_cuda, stream_ptr

_BIG = 3.4e38
_P = ctypes.c_void_p
_I = ctypes.c_int

NN1 = CudaKernel("nn1", "nn1.cu", "nn1_launch",
                 [_P, _P, _P, _I, _I, _P, _P, _P, _P])
KNN = CudaKernel("knn", "knn.cu", "knn_launch",
                 [_P, _P, _P, _I, _I, _I, _P, _P, _P])


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


def nn_search_pre(query: torch.Tensor, rT: torch.Tensor, bias: torch.Tensor):
    """Masked 1-NN against a prepared reference (kernel K2): query (Q, 3),
    rT (3, Tp) channel-first points, bias (1, Tp) additive validity bias
    (0 valid, +3.4e38 invalid).  Returns idx (Q,) int32 and sqd (Q,)
    float32; ties go to the lowest index, and a query with no valid
    reference gets (0, 3.4e38).  This is the G-ICP inner-loop entry: the
    target keeps this layout (ops.gicp.GICPTarget)."""
    dev = query.device
    Tp = rT.shape[1] if rT.dim() == 2 else -1
    check_tensor("query", query, torch.float32, (None, 3), dev)
    check_tensor("rT", rT, torch.float32, (3, None), dev)
    check_tensor("bias", bias, torch.float32, (1, Tp), dev)
    if not on_cuda(dev):
        return nn1_plain(query, rT, bias)
    Q = query.shape[0]
    idx = torch.empty(Q, dtype=torch.int32, device=dev)
    sqd = torch.empty(Q, dtype=torch.float32, device=dev)
    scratch = torch.empty(Q, dtype=torch.int64, device=dev)
    NN1(query.data_ptr(), rT.data_ptr(), bias.data_ptr(), Q, Tp, scratch.data_ptr(), idx.data_ptr(),
        sqd.data_ptr(), stream_ptr(dev))
    return idx, sqd


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
