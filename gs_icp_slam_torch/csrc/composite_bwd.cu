// K1-bwd: gradient of the per-tile alpha compositor with respect to the
// compacted splat attributes.
//
// Replaces: gs_icp_slam_tpu/ops/composite_pallas.py `_bwd_kernel_win`
// (the VJP of `make_composite_win`) together with its per-splat reduction
// through `cell_idx` (composite_pallas.py:742-759).
//
// Contract: the inputs of composite_fwd.cu (counts, starts, pair_slot,
// attr (R >= 10, Vp) channel-first), its outputs out (T, 8, P) and
// n_contrib (T, P), and g (T, 8, P), the gradient of out (rows 0-2 rgb,
// 3 depth, 4 final transmittance are read); splat_rows (M, Vp) int32, the
// pair rows of each column of attr (entries past a tile's counts[t], and
// padding, are -1).  d_attr (R, Vp) is written whole; rows 0-9 receive,
// summed over every pixel of every tile whose run holds the splat:
//   dL/dw     = g_rgb . rgb + g_depth * depth
//   dL/dalpha = T_before * dL/dw - (S + g_tf * t_final) / (1 - alpha)
// with S the sum of w * dL/dw over the pixel's later blended splats, and
// the chain through alpha = opacity * exp(power) (zero where alpha was
// clamped at 0.99) to the mean, the conic and the opacity; rgb and depth
// get w * g.  Ranks at or past the pixel's n_contrib get nothing: that is
// the forward's `done` rule and the Pallas kernel's exclusion.  Rows >= 10
// are zero.
//
// What bounds it on the H100: arithmetic on the (pixel, splat) pairs each
// pixel walks (about 12 fp32 operations for every walked pair, about 45
// more for a blended one, one exp), against a few MB of inputs, the cell
// buffer and the gradient: chip_smoke.py counts both from a real view.
//
// Design, two launches:
//  1. composite_bwd_walk, gs::bwd_tile (composite_tile.cuh, shared with
//     K4's backward): one block per side x side corner of a tile
//     (side = 16 at the 32-pixel tiles of the mapping path, so four blocks
//     a tile and four times as many blocks as tiles for the 132 SMs; the
//     whole tile when tile <= 16), one thread per pixel, a warp on an 8x4
//     patch of pixels (its pixels stop near the same rank and blend the
//     same splats more often than a row of 16x2 does).  The tile's run is
//     streamed backwards through shared memory in batches of kBwdBatch
//     splats, from the block's largest n_contrib down to rank 0, with
//     barriers only at batch boundaries.  Inside a batch each warp starts
//     at its own largest n_contrib (__reduce_max_sync) and skips every
//     rank no lane of it needs: above that bound, and splats whose
//     footprint provably misses the warp's pixel rectangle (patch_culled:
//     most ranks a warp reaches blend on none of its lanes).  Inside a
//     walked rank, a pixel whose power falls below the splat's pmin skips
//     the exp (see PackedSplat in composite_common.cuh).  For each rank a
//     warp walks, __ballot_sync tells how many lanes blended: none (ten
//     zeros), one (that lane's terms are the sums, no shuffle) or more (a
//     transposing reduce-scatter: each
//     halving step sends half of what a lane still holds, 12 shuffles for
//     the ten terms instead of 50 for ten butterflies).  The warp's ten
//     sums go to per-warp partials, s_part[warp][term][rank], with plain
//     stores; after the batch one thread per (rank, term) adds them in
//     warp order (only warps that walked the rank: s_wmask) and stores
//     the sum, the block's share of cell (starts[t] + rank, corner, term).
//     Ranks in [walk, counts[t]) get zeros, so every row of every run is
//     written.  The transmittance before each blended splat is recovered
//     by division, T_before = T_after / (1 - alpha), from the saved final
//     transmittance (alpha <= 0.99 and T >= 1e-4 keep this within a few
//     ulp per splat; no per-splat checkpoints are stored).
//  2. composite_bwd_gather: one thread per column of attr sums the cells
//     of the splat's pair rows (splat_rows, at most tile_span^2 from the
//     binning) and the tile corners, in a fixed order.
// No atomics anywhere: two launches on the same inputs give equal bits,
// as the Pallas VJP's (16, T*K) cell grid and cell_idx gather do.  Built
// without fused multiply-add, like the forward, so that the recomputed
// power and alpha round as they did there and every gate decision
// repeats; the per-pair arithmetic is shared with K1-fwd and K4
// (composite_common.cuh).
#include "composite_tile.cuh"

namespace {

using gs::kTerms;

// K1's sums: cell (row, corner, term) at ((row * nsub + sub) * 10 + term),
// row = start + rank; cell_t is the corner's cell of row start.
struct CellSink {
  float* cell_t;
  int nsub;
  static constexpr bool kTermMajor = false;
  __device__ __forceinline__ void operator()(int j, int c, float v) const {
    cell_t[static_cast<size_t>(j) * nsub * kTerms + c] = v;
  }
};

__global__ void __launch_bounds__(1024)
composite_bwd_walk(const int* __restrict__ counts,
                   const int* __restrict__ starts,
                   const int* __restrict__ pair_slot,
                   const float* __restrict__ attr, int Vp, int ntx, int tile,
                   int side, const float* __restrict__ out,
                   const int* __restrict__ n_contrib,
                   const float* __restrict__ g, float* __restrict__ cell) {
  extern __shared__ float4 s_dyn[];
  const int nsx = (tile + side - 1) / side;
  const int nsub = nsx * nsx;
  const int t = blockIdx.x / nsub;
  const int sub = blockIdx.x - t * nsub;
  const int count = counts[t];
  const int start = starts[t];
  float* cell_t = cell + (static_cast<size_t>(start) * nsub + sub) * kTerms;
  const int walk = gs::bwd_tile<false>(
      gs::PairRun{pair_slot, attr, Vp, start, count}, CellSink{cell_t, nsub},
      t, sub, nsx, ntx, tile, side, out, n_contrib, g, s_dyn, nullptr);
  // ranks [walk, count): no pixel of this corner reached them
  const int rest = count - walk;
  for (int i = threadIdx.x; i < kTerms * rest; i += blockDim.x) {
    const int j = i / kTerms;
    cell_t[static_cast<size_t>(walk + j) * nsub * kTerms + (i - j * kTerms)] =
        0.f;
  }
}

__global__ void composite_bwd_gather(const int* __restrict__ splat_rows,
                                     int M, int Vp, int R, int nsub,
                                     const float* __restrict__ cell,
                                     float* __restrict__ d_attr) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= Vp) return;
  float acc[kTerms];
#pragma unroll
  for (int c = 0; c < kTerms; ++c) acc[c] = 0.f;
  for (int m = 0; m < M; ++m) {
    const int r = splat_rows[static_cast<size_t>(m) * Vp + v];
    if (r < 0) continue;
    const float* cr = cell + static_cast<size_t>(r) * nsub * kTerms;
    for (int s = 0; s < nsub; ++s) {
#pragma unroll
      for (int c = 0; c < kTerms; ++c) acc[c] = acc[c] + cr[s * kTerms + c];
    }
  }
#pragma unroll
  for (int c = 0; c < kTerms; ++c)
    d_attr[static_cast<size_t>(c) * Vp + v] = acc[c];
  for (int c = kTerms; c < R; ++c)
    d_attr[static_cast<size_t>(c) * Vp + v] = 0.f;
}

}  // namespace

GS_EXPORT_ERROR_STRING

// counts, starts (T,) int32; pair_slot (Np,) int32; attr (R >= 10, Vp)
// float32 channel-first; out, g (T, 8, tile*tile) float32; n_contrib
// (T, tile*tile) int32; splat_rows (M, Vp) int32; cell scratch of
// Np * nsub * 10 floats, nsub = ceil(tile / side)^2; d_attr (R, Vp)
// float32.  tile*tile <= 1024, 1 <= side <= tile.
extern "C" int composite_bwd_launch(const int* counts, const int* starts,
                                    const int* pair_slot, const float* attr,
                                    int T, int R, int Vp, int ntx, int tile,
                                    int side, const float* out,
                                    const int* n_contrib, const float* g,
                                    const int* splat_rows, int M, float* cell,
                                    float* d_attr, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int P = tile * tile;
  if (P < 1 || P > 1024 || side < 1 || side > tile || R < kTerms || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (side * side + 31) / 32 * 32;
  const int nsx = (tile + side - 1) / side;
  const int smem = gs::bwd_smem(threads);
  if (T > 0) {
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024)  // above the default: blocks of more than 8 warps
      err = cudaFuncSetAttribute(
          composite_bwd_walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    composite_bwd_walk<<<T * nsx * nsx, threads, smem, stream>>>(
        counts, starts, pair_slot, attr, Vp, ntx, tile, side, out, n_contrib,
        g, cell);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (Vp > 0) {
    composite_bwd_gather<<<(Vp + 255) / 256, 256, 0, stream>>>(
        splat_rows, M, Vp, R, nsx * nsx, cell, d_attr);
  }
  return static_cast<int>(cudaGetLastError());
}
