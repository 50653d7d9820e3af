// K4a and K4b: the alpha compositor on a dense per-tile block of splats,
// forward and backward.
//
// Replaces: gs_icp_slam_tpu/ops/composite_pallas.py
//   K4a `_fwd_kernel` / `_bwd_kernel` (built by `make_composite`): every
//       tile composites all K slots of its block;
//   K4b `_fwd_kernel_dyn` / `_bwd_kernel_dyn` (`make_composite_dyn`): tile
//       t composites its first counts[t] slots and ignores the rest, as that
//       function's docstring states.  (The Pallas kernel runs whole 32-splat
//       blocks without a row mask, so it also blends slots
//       [counts[t], ceil(counts[t] / 32) * 32); this port does not.)
//
// Contract: attrs (T, 16, K) float32, rows 0 mx, 1 my, 2-4 conic a/b/c,
// 5-7 rgb, 8 opacity, 9 depth (rows 10-15 unused); slot k of tile t is its
// run rank k, front to back.  Tiles are row-major with ntx per row, tile x
// tile pixels each (tile^2 <= 1024).  The forward writes out (T, 8, P):
// rows 0-2 rgb (no background), 3 depth (sum of w * depth), 4 final
// transmittance, 5-7 zero, and n_contrib (T, P) int32 as K1-fwd does.  The
// backward takes those and g (T, 8, P), the gradient of out (rows 0-4
// read), and writes the whole of d_attrs (T, 16, K): rows 0-9 the gradient
// of attrs' rows, rows 10-15 and every slot no pixel reached zero.  The
// function is K1's (composite_fwd.cu, composite_bwd.cu), with the same
// exclusion rule (a splat that would take a pixel's transmittance below
// 1e-4 stops the pixel) and the same per-pair arithmetic
// (composite_common.cuh, built with -fmad=false).
//
// What bounds it on the H100: arithmetic on the (pixel, splat) pairs each
// pixel examines (forward, ~30 fp32 operations each) or walks (backward,
// ~12 each plus ~45 for each pair that blended); the bytes are the dense
// blocks, 64 K bytes a tile each way.  chip_smoke.py counts both from the
// inputs it times.
//
// Design: one block per tile, one thread per pixel.  The block addresses
// its (16, K) slice directly: no pair_slot indirection and no permuted
// copy.  The forward streams rows 0-9 through shared memory kBatchF slots
// at a time and leaves once every pixel has stopped (__syncthreads_count).
// The backward walks from the block's largest n_contrib down to slot 0 in
// batches of kBatchB, every thread on the same slot in lockstep (a pixel
// past its own n_contrib contributes zeros), recovering the transmittance
// before each blended splat by division as K1-bwd does.  Because each
// (tile, slot) cell belongs to this block alone, the sum over the tile's
// pixels needs no global atomics: a warp-shuffle sum per warp, the warps'
// sums stored in shared memory, then added in warp order by one thread per
// (slot, row), which makes one plain store.  The result is deterministic.
#include "common.cuh"
#include "composite_common.cuh"

namespace {

constexpr int kBatchF = 256;
constexpr int kBatchB = 32;
constexpr int kMaxWarps = 32;
using gs::kTerms;

__device__ __forceinline__ int tile_count(const int* counts, int t, int K) {
  return counts == nullptr ? K : min(max(counts[t], 0), K);
}

__global__ void __launch_bounds__(1024)
composite_dense_fwd_kernel(const int* __restrict__ counts,
                           const float* __restrict__ attrs, int K, int ntx,
                           int tile, float* __restrict__ out,
                           int* __restrict__ n_contrib) {
  __shared__ float s_attr[10][kBatchF];
  const int t = blockIdx.x;
  const int P = tile * tile;
  const int pid = threadIdx.x;
  const float px = static_cast<float>((t % ntx) * tile + pid % tile);
  const float py = static_cast<float>((t / ntx) * tile + pid / tile);
  const int count = tile_count(counts, t, K);
  const float* a = attrs + static_cast<size_t>(t) * 16 * K;

  gs::FwdPixel p;
  for (int b0 = 0; b0 < count; b0 += kBatchF) {
    // also the barrier that keeps the previous batch until all have read it
    if (__syncthreads_count(!p.done) == 0) break;
    const int n = min(kBatchF, count - b0);
    for (int i = pid; i < 10 * n; i += blockDim.x) {
      const int c = i / n;
      const int j = i - c * n;
      s_attr[c][j] = a[c * K + b0 + j];
    }
    __syncthreads();
    if (p.done) continue;
    for (int j = 0; j < n; ++j) {
      gs::fwd_blend(p, px, py, gs::splat_at(s_attr, j), b0 + j);
      if (p.done) break;
    }
  }
  float* o = out + static_cast<size_t>(t) * 8 * P + pid;
  o[0 * P] = p.cr;
  o[1 * P] = p.cg;
  o[2 * P] = p.cb;
  o[3 * P] = p.cd;
  o[4 * P] = p.tr;
  o[5 * P] = 0.f;
  o[6 * P] = 0.f;
  o[7 * P] = 0.f;
  n_contrib[static_cast<size_t>(t) * P + pid] = p.last;
}

__global__ void __launch_bounds__(1024)
composite_dense_bwd_kernel(const int* __restrict__ counts,
                           const float* __restrict__ attrs, int K, int ntx,
                           int tile, const float* __restrict__ out,
                           const int* __restrict__ n_contrib,
                           const float* __restrict__ g,
                           float* __restrict__ d_attrs) {
  __shared__ float s_attr[10][kBatchB];
  __shared__ float s_part[kMaxWarps][kTerms][kBatchB];
  __shared__ int s_walk;
  const int t = blockIdx.x;
  const int P = tile * tile;
  const int pid = threadIdx.x;
  const bool pixel = pid < P;
  const int lane = pid & 31;
  const int warp = pid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float px = static_cast<float>((t % ntx) * tile + pid % tile);
  const float py = static_cast<float>((t / ntx) * tile + pid / tile);
  const int count = tile_count(counts, t, K);
  const float* a = attrs + static_cast<size_t>(t) * 16 * K;
  float* d = d_attrs + static_cast<size_t>(t) * 16 * K;
  const size_t base = static_cast<size_t>(t) * 8 * P + pid;

  const int nc = pixel ? n_contrib[static_cast<size_t>(t) * P + pid] : 0;
  gs::BwdPixel p{1.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (pixel) {
    p.tr = out[base + 4 * P];
    p.g_r = g[base];
    p.g_g = g[base + 1 * P];
    p.g_b = g[base + 2 * P];
    p.g_d = g[base + 3 * P];
    p.gtf_tf = g[base + 4 * P] * p.tr;
  }
  if (pid == 0) s_walk = 0;
  __syncthreads();
  if (nc > 0) atomicMax(&s_walk, nc);
  __syncthreads();
  const int walk = min(s_walk, count);

  for (int b0 = ((walk - 1) / kBatchB) * kBatchB; walk > 0 && b0 >= 0;
       b0 -= kBatchB) {
    const int n = min(kBatchB, walk - b0);
    __syncthreads();  // the previous batch's sums have been read
    for (int i = pid; i < 10 * n; i += blockDim.x) {
      const int c = i / n;
      const int j = i - c * n;
      s_attr[c][j] = a[c * K + b0 + j];
    }
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      float v[kTerms];
#pragma unroll
      for (int c = 0; c < kTerms; ++c) v[c] = 0.f;
      bool blended = false;
      if (b0 + j < nc)
        blended = gs::bwd_pair(p, px, py, gs::splat_at(s_attr, j), v);
      // v is zero on every lane of a warp where no lane blended
      if (__any_sync(0xffffffffu, blended)) {
#pragma unroll
        for (int c = 0; c < kTerms; ++c) v[c] = gs::warp_sum(v[c]);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kTerms; ++c) s_part[warp][c][j] = v[c];
      }
    }
    __syncthreads();
    for (int i = pid; i < kTerms * n; i += blockDim.x) {
      const int c = i / n;
      const int j = i - c * n;
      float sum = 0.f;
      for (int w = 0; w < nwarps; ++w) sum = sum + s_part[w][c][j];
      d[c * K + b0 + j] = sum;
    }
  }
  // every other cell of the tile's slice: rows 10-15, and slots past the
  // walk (no pixel blended them)
  for (int i = pid; i < 16 * K; i += blockDim.x) {
    const int c = i / K;
    if (c >= kTerms || i - c * K >= walk) d[i] = 0.f;
  }
}

int launch_fwd(const int* counts, const float* attrs, int T, int K, int ntx,
               int tile, float* out, int* n_contrib, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int P = tile * tile;
  if (P < 1 || P > 1024 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  composite_dense_fwd_kernel<<<T, P, 0, stream>>>(counts, attrs, K, ntx, tile,
                                                  out, n_contrib);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const int* counts, const float* attrs, int T, int K, int ntx,
               int tile, const float* out, const int* n_contrib,
               const float* g, float* d_attrs, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int P = tile * tile;
  if (P < 1 || P > 1024 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = (P + 31) / 32 * 32;
  composite_dense_bwd_kernel<<<T, threads, 0, stream>>>(
      counts, attrs, K, ntx, tile, out, n_contrib, g, d_attrs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

GS_EXPORT_ERROR_STRING

// K4a: attrs (T, 16, K) float32; out (T, 8, tile*tile) float32; n_contrib
// (T, tile*tile) int32; tile*tile <= 1024.
extern "C" int composite_dense_fwd_launch(const float* attrs, int T, int K,
                                          int ntx, int tile, float* out,
                                          int* n_contrib, void* stream_ptr) {
  return launch_fwd(nullptr, attrs, T, K, ntx, tile, out, n_contrib,
                    stream_ptr);
}

// K4a backward: out, n_contrib from the forward; g (T, 8, tile*tile)
// float32; d_attrs (T, 16, K) float32, written whole.
extern "C" int composite_dense_bwd_launch(const float* attrs, int T, int K,
                                          int ntx, int tile, const float* out,
                                          const int* n_contrib,
                                          const float* g, float* d_attrs,
                                          void* stream_ptr) {
  return launch_bwd(nullptr, attrs, T, K, ntx, tile, out, n_contrib, g,
                    d_attrs, stream_ptr);
}

// K4b: as K4a, with counts (T,) int32 (clamped to [0, K] here).
extern "C" int composite_dyn_fwd_launch(const int* counts, const float* attrs,
                                        int T, int K, int ntx, int tile,
                                        float* out, int* n_contrib,
                                        void* stream_ptr) {
  if (counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd(counts, attrs, T, K, ntx, tile, out, n_contrib,
                    stream_ptr);
}

extern "C" int composite_dyn_bwd_launch(const int* counts, const float* attrs,
                                        int T, int K, int ntx, int tile,
                                        const float* out, const int* n_contrib,
                                        const float* g, float* d_attrs,
                                        void* stream_ptr) {
  if (counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd(counts, attrs, T, K, ntx, tile, out, n_contrib, g,
                    d_attrs, stream_ptr);
}
