// K1-fwd: per-tile front-to-back alpha compositing of depth-sorted splats.
//
// Replaces: gs_icp_slam_tpu/ops/composite_pallas.py `_fwd_kernel_win`
// (built by `make_composite_win`, called from ops/rasterize.py).
//
// Contract: tile t owns rows [starts[t], starts[t] + counts[t]) of the
// tile-sorted pair table, front to back; pair_slot[row] is a column of the
// channel-first splat table attr (R >= 10 rows, Vp columns; rows 0 mx,
// 1 my, 2-4 conic a/b/c, 5-7 rgb, 8 opacity, 9 depth).  For each pixel
// (px, py) of the tile:
//   power = -0.5 * (a*dx*dx + c*dy*dy) - b*dx*dy,  dx = px - mx, dy = py - my
//   alpha = min(opacity * exp(power), 0.99), used where power <= 0 and
//           opacity * exp(power) >= 1/255
// and a splat counts only while the transmittance after it stays >= 1e-4;
// the first splat that would take it below stops the pixel (the CUDA
// rasterizer's `done` rule, equal to the Pallas kernel's exclusion of
// every later splat).  out (T, 8, P): rows 0-2 rgb (no background),
// 3 depth (sum of w * depth, not normalised), 4 final transmittance,
// 5-7 zero.  n_contrib (T, P) int32: one more than the run rank of the
// last splat the pixel blended (0 for none), where the backward
// (composite_bwd.cu) starts its reverse walk.
//
// What bounds it on the H100: arithmetic on (pixel, splat) pairs, against
// a few MB of inputs.  A pixel examines every splat of its run until it
// stops (~30 fp32 operations each, one exp), but most of those pairs lie
// outside the splat's footprint and are gated out: only the pairs that
// blend or stop need the whole arithmetic.  chip_smoke.py counts both
// from a real view.
//
// Design: gs::fwd_tile (composite_tile.cuh, shared with K4's forward):
// one block per side x side corner of a tile (side = 16: four 256-thread
// blocks per 32-pixel tile; the whole tile when tile <= 16), one thread
// per pixel, a warp on an 8x4 patch.  Every block streams the tile's
// whole run front to back through shared memory, packed with its gate
// power pmin (gs::PackedSplat).  In each batch a warp tests 32 splats at
// once against its patch's rectangle (gs::patch_culled) and walks the
// survivors in rank order; a lane whose power falls below pmin skips its
// exp.  A culled pair or a skipped exp is one the forward's own gate would
// refuse: it neither blends nor stops the pixel.  Every other pair is
// computed as before, in the same order, with the shared per-pair
// arithmetic and without fused multiply-add, so out and n_contrib are
// bit-equal to the plain PyTorch version.  Warps and blocks leave as soon
// as their pixels have stopped: the per-tile early exit of the Pallas
// kernel, per warp and per block.  With counters, the kernel also counts
// the pairs it evaluated and those the rectangle test culled, over the
// pixels still running; together they are the pairs the plain version
// examines.
#include "composite_tile.cuh"

namespace {

template <bool kCount>
__global__ void __launch_bounds__(gs::kFwdThreads)
composite_fwd_kernel(const int* __restrict__ counts,
                     const int* __restrict__ starts,
                     const int* __restrict__ pair_slot,
                     const float* __restrict__ attr, int Vp, int ntx,
                     int tile, int side, float* __restrict__ out,
                     int* __restrict__ n_contrib,
                     unsigned long long* __restrict__ counters) {
  __shared__ gs::PackedSplat s_splat[gs::kFwdThreads];
  const int nsx = (tile + side - 1) / side;
  const int nsub = nsx * nsx;
  const int t = blockIdx.x / nsub;
  const int sub = blockIdx.x - t * nsub;
  gs::fwd_tile<kCount>(gs::PairRun{pair_slot, attr, Vp, starts[t], counts[t]},
                       t, sub, nsx, ntx, tile, side, out, n_contrib, counters,
                       s_splat);
}

}  // namespace

GS_EXPORT_ERROR_STRING

// counts, starts (T,) int32; pair_slot (Np,) int32; attr (>= 10, Vp)
// float32 channel-first; out (T, 8, tile*tile) float32; n_contrib
// (T, tile*tile) int32; tile*tile <= 1024.  counters: null, or two zeroed
// 64-bit words that receive the pairs evaluated and the pairs culled.
extern "C" int composite_fwd_launch(const int* counts, const int* starts,
                                    const int* pair_slot, const float* attr,
                                    int T, int Vp, int ntx, int tile,
                                    float* out, int* n_contrib,
                                    unsigned long long* counters,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int P = tile * tile;
  if (P < 1 || P > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  const gs::FwdGrid gr = gs::fwd_grid(tile);
  const int blocks = T * gr.nsx * gr.nsx;
  if (counters != nullptr) {
    composite_fwd_kernel<true><<<blocks, gr.threads, 0, stream>>>(
        counts, starts, pair_slot, attr, Vp, ntx, tile, gr.side, out,
        n_contrib, counters);
  } else {
    composite_fwd_kernel<false><<<blocks, gr.threads, 0, stream>>>(
        counts, starts, pair_slot, attr, Vp, ntx, tile, gr.side, out,
        n_contrib, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
