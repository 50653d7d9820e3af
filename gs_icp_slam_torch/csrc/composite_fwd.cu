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
// What bounds it on the H100: arithmetic on the (pixel, splat) pairs each
// pixel examines before it stops, ~30 fp32 operations each (one exp);
// the inputs read are a few MB.  The count depends on the data:
// chip_smoke.py counts it from the run's own view.
//
// Design: one block per tile, one thread per pixel (P = tile^2 <= 1024).
// The block streams its run through shared memory in batches of kBatch
// splats, each thread gathering one splat's 10 attributes through
// pair_slot: no dense (T, 16, K) gather, no payload window and no buffer
// of size K (K reaches max_per_tile = 4096).  Each thread composites front
// to back and stops at the done rule; the block leaves as soon as no
// thread is left (__syncthreads_count), the per-tile early exit of the
// Pallas kernel.  Built without fused multiply-add so that the plain
// PyTorch version rounds the same way; the per-pair arithmetic is shared
// with K1-bwd and K4 (composite_common.cuh).
#include "common.cuh"
#include "composite_common.cuh"

namespace {

constexpr int kBatch = 256;

__global__ void __launch_bounds__(1024)
composite_fwd_kernel(const int* __restrict__ counts,
                     const int* __restrict__ starts,
                     const int* __restrict__ pair_slot,
                     const float* __restrict__ attr, int Vp, int ntx,
                     int tile, float* __restrict__ out,
                     int* __restrict__ n_contrib) {
  __shared__ float s_attr[10][kBatch];
  const int t = blockIdx.x;
  const int P = tile * tile;
  const int pid = threadIdx.x;
  const float px = static_cast<float>((t % ntx) * tile + pid % tile);
  const float py = static_cast<float>((t / ntx) * tile + pid / tile);
  const int count = counts[t];
  const int start = starts[t];

  gs::FwdPixel p;
  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // also the barrier that keeps the previous batch until all have read it
    if (__syncthreads_count(!p.done) == 0) break;
    const int n = min(kBatch, count - b0);
    for (int j = pid; j < n; j += blockDim.x) {
      const int s = pair_slot[start + b0 + j];
#pragma unroll
      for (int c = 0; c < 10; ++c) s_attr[c][j] = attr[c * Vp + s];
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

}  // namespace

GS_EXPORT_ERROR_STRING

// counts, starts (T,) int32; pair_slot (Np,) int32; attr (>= 10, Vp)
// float32 channel-first; out (T, 8, tile*tile) float32; n_contrib
// (T, tile*tile) int32; tile*tile <= 1024.
extern "C" int composite_fwd_launch(const int* counts, const int* starts,
                                    const int* pair_slot, const float* attr,
                                    int T, int Vp, int ntx, int tile,
                                    float* out, int* n_contrib,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int P = tile * tile;
  if (P < 1 || P > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  composite_fwd_kernel<<<T, P, 0, stream>>>(counts, starts, pair_slot, attr,
                                            Vp, ntx, tile, out, n_contrib);
  return static_cast<int>(cudaGetLastError());
}
