// K2: exact masked 1-nearest-neighbour search (the G-ICP correspondence
// search, run once per Gauss-Newton iteration).
//
// Replaces: gs_icp_slam_tpu/ops/nn_pallas.py `_nn_kernel` (built by
// `_make_nn`, entered through `nn_search_pre`).
//
// Contract: for each query q (Q, 3) the index and squared distance of the
// nearest reference among rT (3, Tp) channel-first, where the distance is
// (q - r)^2 summed in the order x, y, z plus bias[r] (0 on a valid
// reference, +3.4e38 on an invalid one).  Ties go to the lowest index.  A
// query with no valid reference gets index 0 and 3.4e38.
//
// What bounds it on the H100: arithmetic.  Q x Tp pairs at ~9 fp32
// operations each (8.2k x 65.5k at tracking geometry: 4.8 GFLOP, 72 us at
// the 67 TFLOP/s fp32 rate), against ~1.2 MB of input (0.4 us at
// 3.35 TB/s).
//
// Design: one thread per query keeps its running (distance, index); the
// block stages reference tiles of (x, y, z, bias) as float4 in shared
// memory, so every reference is read from device memory once per block
// and broadcast to all its threads.  8.2k queries alone fill only 64
// blocks of 128 threads, half the card's 132 SMs, so the reference axis
// is split across blockIdx.y as well (about 8 blocks per SM).  Each
// split's winner is merged with one 64-bit atomicMin of
// (distance bits << 32 | index): distances are non-negative, so their bit
// patterns order like the floats, and the low word then breaks a tie
// toward the lower index.  Inside a split the update is strictly-less in
// increasing index order, so the tie rule holds there too.  The merged
// word starts at (3.4e38, 0), the Pallas kernel's initial state.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // references per shared-memory stage (16 KB)
constexpr int kTargetBlocks = 132 * 8;

__device__ __forceinline__ unsigned long long pack(float d, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned int>(i);
}

__global__ void nn1_init(unsigned long long* best, int Q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q) best[i] = pack(GS_BIG, 0);
}

__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ query, const float* __restrict__ rT,
           const float* __restrict__ bias, int Q, int Tp, int chunk,
           unsigned long long* __restrict__ best) {
  __shared__ float4 sref[kTile];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[3 * qi + 0];
    qy = query[3 * qi + 1];
    qz = query[3 * qi + 2];
  }
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(r0 + chunk, Tp);
  float bd = GS_BIG;
  int bi = 0;
  bool found = false;
  for (int base = r0; base < r1; base += kTile) {
    const int n = min(kTile, r1 - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      sref[j] = make_float4(rT[base + j], rT[Tp + base + j],
                            rT[2 * Tp + base + j], bias[base + j]);
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float d = gs_sqdist_bias(qx, qy, qz, sref[j]);
        if (d < bd) {
          bd = d;
          bi = base + j;
          found = true;
        }
      }
    }
  }
  if (active && found) atomicMin(&best[qi], pack(bd, bi));
}

__global__ void nn1_finish(const unsigned long long* __restrict__ best, int Q,
                           int* __restrict__ idx, float* __restrict__ sqd) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q) {
    const unsigned long long b = best[i];
    idx[i] = static_cast<int>(b & 0xffffffffull);
    sqd[i] = __uint_as_float(static_cast<unsigned int>(b >> 32));
  }
}

}  // namespace

GS_EXPORT_ERROR_STRING

// query (Q, 3), rT (3, Tp), bias (Tp,) float32; scratch (Q,) 64-bit;
// idx (Q,) int32, sqd (Q,) float32.
extern "C" int nn1_launch(const float* query, const float* rT,
                          const float* bias, int Q, int Tp,
                          unsigned long long* scratch, int* idx, float* sqd,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (Q <= 0) return static_cast<int>(cudaGetLastError());
  const int qblocks = (Q + kThreads - 1) / kThreads;
  nn1_init<<<qblocks, kThreads, 0, stream>>>(scratch, Q);
  if (Tp > 0) {
    // split the references so that ~kTargetBlocks blocks are in flight
    int nsplit = (kTargetBlocks + qblocks - 1) / qblocks;
    nsplit = std::max(1, std::min(nsplit, (Tp + kTile - 1) / kTile));
    const int chunk = ((Tp + nsplit - 1) / nsplit + kTile - 1) / kTile * kTile;
    nsplit = (Tp + chunk - 1) / chunk;
    nn1_kernel<<<dim3(qblocks, nsplit), kThreads, 0, stream>>>(
        query, rT, bias, Q, Tp, chunk, scratch);
  }
  nn1_finish<<<qblocks, kThreads, 0, stream>>>(scratch, Q, idx, sqd);
  return static_cast<int>(cudaGetLastError());
}
