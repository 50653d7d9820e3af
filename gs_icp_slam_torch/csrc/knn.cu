// K3: exact k-nearest-neighbour search (the frame-0 target covariances,
// k = 20, and mean_sq_dist_3nn, k = 4).
//
// Replaces: gs_icp_slam_tpu/ops/nn_pallas.py `_knn_kernel` (built by
// `_make_knn`, entered through `knn_search_pallas`).
//
// Contract: for each query (Q, 3) the k nearest references of ref (R, 3),
// nearest first, the query itself included when it is a reference.  The
// distance is (q - r)^2 summed in the order x, y, z plus a bias of 0 on a
// valid reference and +3.4e38 on an invalid one; ties go to the lowest
// index.  Missing neighbours (fewer than k valid references) report
// 3.4e38, and their index is unspecified (here 0).  There is no cap on R:
// the Pallas kernel's R <= 32k was a VMEM limit.
//
// What bounds it on the H100: arithmetic, Q x R pairs at ~9 fp32
// operations each plus a compare (8.3k^2 at tracking geometry: 0.62 GFLOP,
// 9 us at 67 TFLOP/s); input and output are under 2 MB.
//
// Design: one thread per query keeps a sorted list of (distance, index) in
// registers: the list length KMAX is a template parameter, so every index
// into it is a compile-time constant after unrolling.  A runtime k is
// served by the smallest instantiated KMAX >= k: the first k entries of an
// exact top-KMAX are the exact top-k.  References stream through shared
// memory in tiles as in K2, in increasing index order; a candidate enters
// only when strictly nearer than the current last entry and bubbles
// forward past strictly larger entries only, so equal distances keep index
// order — the Pallas kernel's lowest-index tie rule.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 1024;

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ ref,
           const unsigned char* __restrict__ valid, int Q, int R, int k,
           int* __restrict__ out_idx, float* __restrict__ out_sqd) {
  __shared__ float4 sref[kTile];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[3 * qi + 0];
    qy = query[3 * qi + 1];
    qz = query[3 * qi + 2];
  }
  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    bd[j] = GS_BIG;
    bi[j] = 0;
  }
  for (int base = 0; base < R; base += kTile) {
    const int n = min(kTile, R - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int r = base + j;
      sref[j] = make_float4(ref[3 * r + 0], ref[3 * r + 1], ref[3 * r + 2],
                            valid[r] ? 0.f : GS_BIG);
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      const float d = gs_sqdist_bias(qx, qy, qz, sref[j]);
      if (d < bd[KMAX - 1]) {
        bd[KMAX - 1] = d;
        bi[KMAX - 1] = base + j;
#pragma unroll
        for (int m = KMAX - 1; m > 0; --m) {
          if (bd[m] < bd[m - 1]) {
            const float td = bd[m];
            bd[m] = bd[m - 1];
            bd[m - 1] = td;
            const int ti = bi[m];
            bi[m] = bi[m - 1];
            bi[m - 1] = ti;
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        out_idx[qi * k + j] = bi[j];
        out_sqd[qi * k + j] = bd[j];
      }
    }
  }
}

template <int KMAX>
void launch(const float* query, const float* ref, const unsigned char* valid,
            int Q, int R, int k, int* idx, float* sqd, cudaStream_t stream) {
  const int blocks = (Q + kThreads - 1) / kThreads;
  knn_kernel<KMAX><<<blocks, kThreads, 0, stream>>>(query, ref, valid, Q, R,
                                                    k, idx, sqd);
}

}  // namespace

GS_EXPORT_ERROR_STRING

// query (Q, 3), ref (R, 3) float32; valid (R,) bool bytes; 1 <= k <= 32;
// idx (Q, k) int32, sqd (Q, k) float32.
extern "C" int knn_launch(const float* query, const float* ref,
                          const unsigned char* valid, int Q, int R, int k,
                          int* idx, float* sqd, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || k > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (Q <= 0) return static_cast<int>(cudaGetLastError());
  if (k <= 4) {
    launch<4>(query, ref, valid, Q, R, k, idx, sqd, stream);
  } else if (k <= 8) {
    launch<8>(query, ref, valid, Q, R, k, idx, sqd, stream);
  } else if (k <= 16) {
    launch<16>(query, ref, valid, Q, R, k, idx, sqd, stream);
  } else if (k <= 20) {
    launch<20>(query, ref, valid, Q, R, k, idx, sqd, stream);
  } else {
    launch<32>(query, ref, valid, Q, R, k, idx, sqd, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
