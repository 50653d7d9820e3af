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
// Design: one block per side x side corner of a tile (side = 16: four
// 256-thread blocks per 32-pixel tile; the whole tile when tile <= 16),
// one thread per pixel, a warp on an 8x4 patch (gs::corner_pixel, as in
// K1-bwd).  Every block streams the tile's whole run front to back through
// shared memory, one splat per thread per batch, packed with its gate
// power pmin (gs::PackedSplat).  In each batch a warp tests 32 splats at
// once, a lane each, against its patch's rectangle (gs::patch_culled) and
// walks the survivors in rank order; a lane whose power falls below pmin
// skips its exp.  A culled pair or a skipped exp is one the forward's own
// gate would refuse (opacity * exp(power) < 1/255): it neither blends nor
// stops the pixel.  Every other pair is computed as before, in the same
// order, with the shared per-pair arithmetic (gs::fwd_blend) and without
// fused multiply-add, so out and n_contrib are bit-equal to the plain
// PyTorch version.  A warp leaves a batch as soon as all its lanes have
// stopped (__all_sync), the block leaves the run as soon as no lane is
// left (__syncthreads_count): the per-tile early exit of the Pallas
// kernel, per warp and per block.  With counters, the kernel also counts
// the pairs it evaluated and those the rectangle test culled, over the
// pixels still running; together they are the pairs the plain version
// examines.
#include "common.cuh"
#include "composite_common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // a 16 x 16 corner
constexpr int kSide = 16;         // composite_cuda.BWD_SIDE
constexpr unsigned kAll = 0xffffffffu;

template <bool kCount>
__global__ void __launch_bounds__(kMaxThreads)
composite_fwd_kernel(const int* __restrict__ counts,
                     const int* __restrict__ starts,
                     const int* __restrict__ pair_slot,
                     const float* __restrict__ attr, int Vp, int ntx,
                     int tile, int side, float* __restrict__ out,
                     int* __restrict__ n_contrib,
                     unsigned long long* __restrict__ counters) {
  __shared__ gs::PackedSplat s_splat[kMaxThreads];
  const int nsx = (tile + side - 1) / side;
  const int nsub = nsx * nsx;
  const int t = blockIdx.x / nsub;
  const int sub = blockIdx.x - t * nsub;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int2 xy = gs::corner_pixel(tid, side, sub, nsx);
  const bool pixel = tid < side * side && xy.x < tile && xy.y < tile;
  const int P = tile * tile;
  const int pid = xy.y * tile + xy.x;
  const float px = static_cast<float>((t % ntx) * tile + xy.x);
  const float py = static_cast<float>((t / ntx) * tile + xy.y);
  const int count = counts[t];
  const int start = starts[t];
  // the warp's pixel rectangle, for the per-splat cull
  const float xlo = gs::warp_min(pixel ? px : INFINITY);
  const float xhi = gs::warp_max(pixel ? px : -INFINITY);
  const float ylo = gs::warp_min(pixel ? py : INFINITY);
  const float yhi = gs::warp_max(pixel ? py : -INFINITY);
  unsigned long long evaluated = 0ull, culled = 0ull;  // with kCount

  gs::FwdPixel p;
  const int nb = blockDim.x;  // splats per batch: one per thread
  for (int b0 = 0; b0 < count; b0 += nb) {
    // also the barrier that keeps the previous batch until all have read it
    if (__syncthreads_count(pixel && !p.done) == 0) break;
    const int n = min(nb, count - b0);
    if (tid < n)
      s_splat[tid] = gs::load_packed(attr, Vp, pair_slot[start + b0 + tid]);
    __syncthreads();
    for (int q0 = 0; q0 < n; q0 += 32) {
      const bool live = pixel && !p.done;
      if (!__any_sync(kAll, live)) break;
      const int j = q0 + lane;
      unsigned bits = __ballot_sync(
          kAll,
          j < n && !gs::patch_culled(s_splat[j], xlo, xhi, ylo, yhi));
      int prev = -1;  // the last survivor walked
      while (bits != 0u) {
        const int jb = __ffs(bits) - 1;  // ranks in increasing order
        bits &= bits - 1u;
        const bool on = pixel && !p.done;
        if (kCount) {  // warp-uniform sums; lane 0 adds them at the end
          // the ranks culled since the last survivor met the same pixels
          const unsigned long long a = __popc(__ballot_sync(kAll, on));
          evaluated += a;
          culled += a * static_cast<unsigned long long>(jb - prev - 1);
        }
        prev = jb;
        if (on) {
          const gs::PackedSplat& ps = s_splat[q0 + jb];
          const gs::Splat sp = gs::unpack(ps);
          if (!(gs::splat_power(sp, px - sp.mx, py - sp.my) < ps.c.z))
            gs::fwd_blend(p, px, py, sp, b0 + q0 + jb);
        }
        if (__all_sync(kAll, !pixel || p.done)) break;
      }
      if (kCount) {  // the culled ranks after the last survivor
        const unsigned long long a =
            __popc(__ballot_sync(kAll, pixel && !p.done));
        culled += a * static_cast<unsigned long long>(min(32, n - q0) -
                                                      prev - 1);
      }
    }
  }
  if (kCount && lane == 0) {
    atomicAdd(&counters[0], evaluated);
    atomicAdd(&counters[1], culled);
  }
  if (!pixel) return;
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
  const int side = min(tile, kSide);
  const int nsx = (tile + side - 1) / side;
  const int threads = (side * side + 31) / 32 * 32;
  if (counters != nullptr) {
    composite_fwd_kernel<true><<<T * nsx * nsx, threads, 0, stream>>>(
        counts, starts, pair_slot, attr, Vp, ntx, tile, side, out, n_contrib,
        counters);
  } else {
    composite_fwd_kernel<false><<<T * nsx * nsx, threads, 0, stream>>>(
        counts, starts, pair_slot, attr, Vp, ntx, tile, side, out, n_contrib,
        nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
