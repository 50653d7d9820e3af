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
// 3 depth, 4 final transmittance are read).  d_attr (R, Vp) must be zero
// on entry; rows 0-9 receive, summed over every pixel of every tile whose
// run holds the splat:
//   dL/dw     = g_rgb . rgb + g_depth * depth
//   dL/dalpha = T_before * dL/dw - (S + g_tf * t_final) / (1 - alpha)
// with S the sum of w * dL/dw over the pixel's later blended splats, and
// the chain through alpha = opacity * exp(power) (zero where alpha was
// clamped at 0.99) to the mean, the conic and the opacity; rgb and depth
// get w * g.  Ranks at or past the pixel's n_contrib get nothing: that is
// the forward's `done` rule and the Pallas kernel's exclusion.
//
// What bounds it on the H100: arithmetic on the (pixel, splat) pairs each
// pixel walks (about 50 fp32 operations for a blended pair, one exp), and
// the per-splat reductions: chip_smoke.py counts both from a real view.
//
// Design: one block per tile and one thread per pixel (the block rounded
// up to whole warps).  The run is streamed backwards through shared memory
// in batches of kBatch splats, from the block's largest n_contrib down to
// rank 0; every thread walks the same rank in lockstep, and a pixel whose
// own n_contrib is lower contributes zeros there, so warp reductions stay
// valid.  The transmittance before each blended splat is recovered by
// division, T_before = T_after / (1 - alpha), starting from the saved
// final transmittance (alpha <= 0.99 and T >= 1e-4 keep this within a few
// ulp per splat; no per-splat checkpoints are stored).  Each splat's ten
// gradient terms are summed across the warp with __shfl_xor_sync (skipped
// when no lane of the warp blended it), the warp sums are added into
// s_grad with shared-memory atomics, and after each batch one global
// atomicAdd per (splat, attribute) and tile goes to d_attr.  This takes
// the place of the Pallas kernel's (16, T*K) cell grid and the cell_idx
// gather.  Global atomics make the low bits vary from run to run.  Built
// without fused multiply-add, like the forward, so that the recomputed
// power and alpha round as they did there and every gate decision repeats;
// the per-pair arithmetic is shared with K1-fwd and K4
// (composite_common.cuh).
#include "common.cuh"
#include "composite_common.cuh"

namespace {

constexpr int kBatch = 256;
using gs::kTerms;

__global__ void __launch_bounds__(1024)
composite_bwd_kernel(const int* __restrict__ counts,
                     const int* __restrict__ starts,
                     const int* __restrict__ pair_slot,
                     const float* __restrict__ attr, int Vp, int ntx,
                     int tile, const float* __restrict__ out,
                     const int* __restrict__ n_contrib,
                     const float* __restrict__ g,
                     float* __restrict__ d_attr) {
  __shared__ float s_attr[10][kBatch];
  __shared__ float s_grad[kTerms][kBatch];
  __shared__ int s_walk;
  const int t = blockIdx.x;
  const int P = tile * tile;
  const int pid = threadIdx.x;
  const bool pixel = pid < P;
  const int lane = pid & 31;
  const float px = static_cast<float>((t % ntx) * tile + pid % tile);
  const float py = static_cast<float>((t / ntx) * tile + pid / tile);
  const int start = starts[t];
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
  const int walk = min(s_walk, counts[t]);

  for (int b0 = ((walk - 1) / kBatch) * kBatch; walk > 0 && b0 >= 0;
       b0 -= kBatch) {
    const int n = min(kBatch, walk - b0);
    __syncthreads();  // the previous batch's flush has read s_grad
    for (int j = pid; j < n; j += blockDim.x) {
      const int s = pair_slot[start + b0 + j];
#pragma unroll
      for (int c = 0; c < 10; ++c) {
        s_attr[c][j] = attr[c * Vp + s];
        s_grad[c][j] = 0.f;
      }
    }
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      float v[kTerms];
#pragma unroll
      for (int c = 0; c < kTerms; ++c) v[c] = 0.f;
      bool blended = false;
      if (b0 + j < nc)
        blended = gs::bwd_pair(p, px, py, gs::splat_at(s_attr, j), v);
      if (__any_sync(0xffffffffu, blended)) {
#pragma unroll
        for (int c = 0; c < kTerms; ++c) v[c] = gs::warp_sum(v[c]);
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < kTerms; ++c) atomicAdd(&s_grad[c][j], v[c]);
        }
      }
    }
    __syncthreads();
    for (int j = pid; j < n; j += blockDim.x) {
      const int s = pair_slot[start + b0 + j];
#pragma unroll
      for (int c = 0; c < kTerms; ++c) {
        const float d = s_grad[c][j];
        if (d != 0.f) atomicAdd(&d_attr[c * Vp + s], d);
      }
    }
  }
}

}  // namespace

GS_EXPORT_ERROR_STRING

// counts, starts (T,) int32; pair_slot (Np,) int32; attr (>= 10, Vp)
// float32 channel-first; out, g (T, 8, tile*tile) float32; n_contrib
// (T, tile*tile) int32; d_attr (>= 10, Vp) float32, zero on entry;
// tile*tile <= 1024.
extern "C" int composite_bwd_launch(const int* counts, const int* starts,
                                    const int* pair_slot, const float* attr,
                                    int T, int Vp, int ntx, int tile,
                                    const float* out, const int* n_contrib,
                                    const float* g, float* d_attr,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int P = tile * tile;
  if (P < 1 || P > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = (P + 31) / 32 * 32;
  composite_bwd_kernel<<<T, threads, 0, stream>>>(
      counts, starts, pair_slot, attr, Vp, ntx, tile, out, n_contrib, g,
      d_attr);
  return static_cast<int>(cudaGetLastError());
}
