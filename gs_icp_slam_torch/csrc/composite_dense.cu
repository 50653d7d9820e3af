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
// What bounds it on the H100: the forward needs the whole arithmetic only
// for the pairs that blend or stop (~40 fp32 operations each); every
// other pair a pixel meets lies outside the splat's footprint, where a
// cull can skip it.  The backward needs ~57 operations for each pair that
// blended.  Against that, the bytes: rows 0-9 of the composited slots in,
// the output out (forward), the whole (T, 16, K) gradient out (backward).
// chip_smoke.py counts all of them from the inputs it times.
//
// Design: K1's kernels on the dense layout, one code (composite_tile.cuh)
// that differs only in where rank j of tile t lives: column j of the
// tile's (16, K) block, no pair_slot indirection.
//  * Forward, gs::fwd_tile: one block per 16 x 16 corner of a tile (the
//    whole tile when tile <= 16), a warp on an 8x4 patch; the tile's first
//    counts[t] slots (all K for K4a) are staged packed with their gate
//    power; each warp tests 32 slots at once against its patch's rectangle
//    and walks the survivors in rank order, a lane below the gate power
//    skips its exp, warps and blocks leave when their pixels have stopped.
//    out and n_contrib are bit-equal to the plain version.
//  * Backward, gs::bwd_tile: one block per tile (side = tile: 1,024
//    threads at tile 32), so that each (tile, slot) cell belongs to one
//    block and no cell buffer or gather is needed.  Each warp walks down
//    from its own largest n_contrib, skips the ranks its rectangle cannot
//    reach, sums a rank over its lanes by ballot (none, one, or a
//    reduce-scatter) into per-warp partials, which one thread per (rank,
//    row) adds in warp order and stores, consecutive threads on
//    consecutive slots.  Then rows 0-9 past the walk and rows 10-15 are
//    zero-filled with 16-byte stores.  No atomics: two launches give equal
//    bits.
// With counters, the forward counts the pairs it evaluated and those its
// warps culled (together the pairs the plain version examines), the
// backward the (warp, rank) pairs below each warp's bound that it walked
// and those it culled.
#include "composite_tile.cuh"

namespace {

using gs::kTerms;

__device__ __forceinline__ int tile_count(const int* counts, int t, int K) {
  return counts == nullptr ? K : min(max(counts[t], 0), K);
}

template <bool kCount>
__global__ void __launch_bounds__(gs::kFwdThreads)
composite_dense_fwd_kernel(const int* __restrict__ counts,
                           const float* __restrict__ attrs, int K, int ntx,
                           int tile, int side, float* __restrict__ out,
                           int* __restrict__ n_contrib,
                           unsigned long long* __restrict__ counters) {
  __shared__ gs::PackedSplat s_splat[gs::kFwdThreads];
  const int nsx = (tile + side - 1) / side;
  const int nsub = nsx * nsx;
  const int t = blockIdx.x / nsub;
  const int sub = blockIdx.x - t * nsub;
  gs::fwd_tile<kCount>(
      gs::DenseRun{attrs + static_cast<size_t>(t) * 16 * K, K,
                   tile_count(counts, t, K)},
      t, sub, nsx, ntx, tile, side, out, n_contrib, counters, s_splat);
}

// K4's sums: row c, slot j of the tile's (16, K) gradient block.
struct DenseSink {
  float* d;
  int K;
  static constexpr bool kTermMajor = true;
  __device__ __forceinline__ void operator()(int j, int c, float v) const {
    d[c * K + j] = v;
  }
};

// Zero the floats [p, p + n) with every thread of the block: 16-byte
// stores from the first 16-byte boundary, single floats around them.
__device__ __forceinline__ void zero_fill(float* p, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int head = min(
      n, static_cast<int>((16 - (reinterpret_cast<size_t>(p) & 15)) & 15) / 4);
  const int n4 = (n - head) / 4;
  float4* q = reinterpret_cast<float4*>(p + head);
  for (int i = tid; i < n4; i += nt) q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < head; i += nt) p[i] = 0.f;
  for (int i = head + 4 * n4 + tid; i < n; i += nt) p[i] = 0.f;
}

template <bool kCount>
__global__ void __launch_bounds__(1024)
composite_dense_bwd_kernel(const int* __restrict__ counts,
                           const float* __restrict__ attrs, int K, int ntx,
                           int tile, const float* __restrict__ out,
                           const int* __restrict__ n_contrib,
                           const float* __restrict__ g,
                           float* __restrict__ d_attrs,
                           unsigned long long* __restrict__ counters) {
  extern __shared__ float4 s_dyn[];
  const int t = blockIdx.x;
  float* d = d_attrs + static_cast<size_t>(t) * 16 * K;
  const int walk = gs::bwd_tile<kCount>(
      gs::DenseRun{attrs + static_cast<size_t>(t) * 16 * K, K,
                   tile_count(counts, t, K)},
      DenseSink{d, K}, t, 0, 1, ntx, tile, tile, out, n_contrib, g, s_dyn,
      counters);
  // every other cell of the tile's block: slots past the walk (no pixel
  // blended them) and rows 10-15
  for (int c = 0; c < kTerms; ++c) zero_fill(d + c * K + walk, K - walk);
  zero_fill(d + kTerms * K, (16 - kTerms) * K);
}

int launch_fwd(const int* counts, const float* attrs, int T, int K, int ntx,
               int tile, float* out, int* n_contrib,
               unsigned long long* counters, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int P = tile * tile;
  if (P < 1 || P > 1024 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  const gs::FwdGrid gr = gs::fwd_grid(tile);
  const int blocks = T * gr.nsx * gr.nsx;
  if (counters != nullptr) {
    composite_dense_fwd_kernel<true><<<blocks, gr.threads, 0, stream>>>(
        counts, attrs, K, ntx, tile, gr.side, out, n_contrib, counters);
  } else {
    composite_dense_fwd_kernel<false><<<blocks, gr.threads, 0, stream>>>(
        counts, attrs, K, ntx, tile, gr.side, out, n_contrib, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kCount>
int launch_bwd_as(const int* counts, const float* attrs, int T, int K,
                  int ntx, int tile, const float* out, const int* n_contrib,
                  const float* g, float* d_attrs,
                  unsigned long long* counters, cudaStream_t stream) {
  const int threads = (tile * tile + 31) / 32 * 32;
  const int smem = gs::bwd_smem(threads);
  if (smem > 48 * 1024) {  // above the default: blocks of more than 8 warps
    const cudaError_t err = cudaFuncSetAttribute(
        composite_dense_bwd_kernel<kCount>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  composite_dense_bwd_kernel<kCount><<<T, threads, smem, stream>>>(
      counts, attrs, K, ntx, tile, out, n_contrib, g, d_attrs, counters);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const int* counts, const float* attrs, int T, int K, int ntx,
               int tile, const float* out, const int* n_contrib,
               const float* g, float* d_attrs, unsigned long long* counters,
               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int P = tile * tile;
  if (P < 1 || P > 1024 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  return counters != nullptr
             ? launch_bwd_as<true>(counts, attrs, T, K, ntx, tile, out,
                                   n_contrib, g, d_attrs, counters, stream)
             : launch_bwd_as<false>(counts, attrs, T, K, ntx, tile, out,
                                    n_contrib, g, d_attrs, nullptr, stream);
}

}  // namespace

GS_EXPORT_ERROR_STRING

// K4a: attrs (T, 16, K) float32; out (T, 8, tile*tile) float32; n_contrib
// (T, tile*tile) int32; tile*tile <= 1024.  counters: null, or two zeroed
// 64-bit words that receive the pairs evaluated and the pairs culled.
extern "C" int composite_dense_fwd_launch(const float* attrs, int T, int K,
                                          int ntx, int tile, float* out,
                                          int* n_contrib,
                                          unsigned long long* counters,
                                          void* stream_ptr) {
  return launch_fwd(nullptr, attrs, T, K, ntx, tile, out, n_contrib,
                    counters, stream_ptr);
}

// K4a backward: out, n_contrib from the forward; g (T, 8, tile*tile)
// float32; d_attrs (T, 16, K) float32, written whole.  counters: null, or
// two zeroed 64-bit words that receive the (warp, rank) pairs walked and
// culled.
extern "C" int composite_dense_bwd_launch(const float* attrs, int T, int K,
                                          int ntx, int tile, const float* out,
                                          const int* n_contrib,
                                          const float* g, float* d_attrs,
                                          unsigned long long* counters,
                                          void* stream_ptr) {
  return launch_bwd(nullptr, attrs, T, K, ntx, tile, out, n_contrib, g,
                    d_attrs, counters, stream_ptr);
}

// K4b: as K4a, with counts (T,) int32 (clamped to [0, K] here).
extern "C" int composite_dyn_fwd_launch(const int* counts, const float* attrs,
                                        int T, int K, int ntx, int tile,
                                        float* out, int* n_contrib,
                                        unsigned long long* counters,
                                        void* stream_ptr) {
  if (counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd(counts, attrs, T, K, ntx, tile, out, n_contrib, counters,
                    stream_ptr);
}

extern "C" int composite_dyn_bwd_launch(const int* counts, const float* attrs,
                                        int T, int K, int ntx, int tile,
                                        const float* out, const int* n_contrib,
                                        const float* g, float* d_attrs,
                                        unsigned long long* counters,
                                        void* stream_ptr) {
  if (counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd(counts, attrs, T, K, ntx, tile, out, n_contrib, g,
                    d_attrs, counters, stream_ptr);
}
