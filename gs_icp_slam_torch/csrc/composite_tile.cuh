// The per-tile bodies of the compositor kernels, shared by K1 (the
// tile-sorted pair table: composite_fwd.cu, composite_bwd.cu) and K4 (a
// dense (16, K) block per tile: composite_dense.cu).  The two layouts
// differ only in where rank j of tile t's run lives (a Run: PairRun,
// DenseRun) and, in the backward, where the tile's per-rank sums go (a
// Sink); the walks, culls and per-pair arithmetic are one code.
#pragma once

#include "common.cuh"
#include "composite_common.cuh"

namespace gs {

constexpr int kFwdSide = 16;  // the forward's block: a 16 x 16 corner
constexpr int kFwdThreads = kFwdSide * kFwdSide;
constexpr int kBwdBatch = 128;            // ranks the backward stages
constexpr int kBwdStride = kBwdBatch + 1;  // a partials row, padded: lanes
                                           // of one rank store to distinct
                                           // banks
constexpr int kMaxWarps = 32;

// Tile t's run in K1's layout: rows [start, start + count) of the pair
// table, each a column of the channel-first attribute table attr (rows
// >= 10, Vp columns).
struct PairRun {
  const int* __restrict__ pair_slot;
  const float* __restrict__ attr;
  int Vp, start, count;
  __device__ __forceinline__ PackedSplat load(int j) const {
    return load_packed(attr, Vp, pair_slot[start + j]);
  }
};

// Tile t's run in K4's layout: slot j of its (16, K) block a (rows 0-9
// read), the first count slots.
struct DenseRun {
  const float* __restrict__ a;
  int K, count;
  __device__ __forceinline__ PackedSplat load(int j) const {
    return load_packed(a, K, j);
  }
};

// The forward of one side x side corner `sub` of tile t (nsx corners
// across), one thread per pixel, a warp on an 8x4 patch (corner_pixel).
// Every block streams the tile's whole run front to back through shared
// memory (s_splat, one splat per thread per batch), packed with its gate
// power pmin.  In each batch a warp tests 32 splats at once, a lane each,
// against its patch's rectangle (patch_culled) and walks the survivors in
// rank order; a lane whose power falls below pmin skips its exp.  A culled
// pair or a skipped exp is one the forward's own gate would refuse
// (opacity * exp(power) < 1/255): it neither blends nor stops the pixel.
// Every other pair is computed as before, in the same order, with the
// shared per-pair arithmetic (fwd_blend) and without fused multiply-add,
// so out and n_contrib are bit-equal to the plain PyTorch version.  A warp
// leaves a batch as soon as all its lanes have stopped (__all_sync), the
// block leaves the run as soon as no lane is left (__syncthreads_count).
// With kCount, counters[0..1] receive the pairs evaluated and those the
// rectangle test culled, over the pixels still running; together they are
// the pairs the plain version examines.
template <bool kCount, class Run>
__device__ __forceinline__ void fwd_tile(
    const Run& run, int t, int sub, int nsx, int ntx, int tile, int side,
    float* __restrict__ out, int* __restrict__ n_contrib,
    unsigned long long* __restrict__ counters, PackedSplat* s_splat) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int2 xy = corner_pixel(tid, side, sub, nsx);
  const bool pixel = tid < side * side && xy.x < tile && xy.y < tile;
  const int P = tile * tile;
  const int pid = xy.y * tile + xy.x;
  const float px = static_cast<float>((t % ntx) * tile + xy.x);
  const float py = static_cast<float>((t / ntx) * tile + xy.y);
  const int count = run.count;
  // the warp's pixel rectangle, for the per-splat cull
  const float xlo = warp_min(pixel ? px : INFINITY);
  const float xhi = warp_max(pixel ? px : -INFINITY);
  const float ylo = warp_min(pixel ? py : INFINITY);
  const float yhi = warp_max(pixel ? py : -INFINITY);
  unsigned long long evaluated = 0ull, culled = 0ull;  // with kCount

  FwdPixel p;
  const int nb = blockDim.x;  // splats per batch: one per thread
  for (int b0 = 0; b0 < count; b0 += nb) {
    // also the barrier that keeps the previous batch until all have read it
    if (__syncthreads_count(pixel && !p.done) == 0) break;
    const int n = min(nb, count - b0);
    if (tid < n) s_splat[tid] = run.load(b0 + tid);
    __syncthreads();
    for (int q0 = 0; q0 < n; q0 += 32) {
      const bool live = pixel && !p.done;
      if (!__any_sync(kAllLanes, live)) break;
      const int j = q0 + lane;
      unsigned bits = __ballot_sync(
          kAllLanes, j < n && !patch_culled(s_splat[j], xlo, xhi, ylo, yhi));
      int prev = -1;  // the last survivor walked
      while (bits != 0u) {
        const int jb = __ffs(bits) - 1;  // ranks in increasing order
        bits &= bits - 1u;
        const bool on = pixel && !p.done;
        if (kCount) {  // warp-uniform sums; lane 0 adds them at the end
          // the ranks culled since the last survivor met the same pixels
          const unsigned long long a = __popc(__ballot_sync(kAllLanes, on));
          evaluated += a;
          culled += a * static_cast<unsigned long long>(jb - prev - 1);
        }
        prev = jb;
        if (on) {
          const PackedSplat& ps = s_splat[q0 + jb];
          const Splat sp = unpack(ps);
          if (!(splat_power(sp, px - sp.mx, py - sp.my) < ps.c.z))
            fwd_blend(p, px, py, sp, b0 + q0 + jb);
        }
        if (__all_sync(kAllLanes, !pixel || p.done)) break;
      }
      if (kCount) {  // the culled ranks after the last survivor
        const unsigned long long a =
            __popc(__ballot_sync(kAllLanes, pixel && !p.done));
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

// The forward's grid: blocks of a side x side corner (side = kFwdSide,
// or the whole tile when it is smaller), nsx corners across a tile.
struct FwdGrid {
  int side, nsx, threads;
};

__host__ __forceinline__ FwdGrid fwd_grid(int tile) {
  const int side = tile < kFwdSide ? tile : kFwdSide;
  return FwdGrid{side, (tile + side - 1) / side, (side * side + 31) / 32 * 32};
}

// The warp's sum of each of the ten terms v[0..9], scattered over the
// lanes: lane l gets the sum of term scatter_term(l) (the lanes of an
// even/odd pair get the same bits).  Step 1 (xor 16) keeps terms
// 5*b4 + [0, 5), step 2 (xor 8) 3*b3 + [0, 3) of those, step 3 (xor 4)
// 2*b2 + [0, 2), step 4 (xor 2) one, step 5 (xor 1) adds the pair;
// odd counts are padded with a zero.  5 + 3 + 2 + 1 + 1 = 12 shuffles.
__device__ __forceinline__ float reduce_scatter10(const float (&v)[kTerms],
                                                  int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float lo = v[i], hi = v[i + 5];
    a[i] = (b4 ? hi : lo) + __shfl_xor_sync(kAllLanes, b4 ? lo : hi, 16);
  }
  float b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float lo = a[i], hi = i + 3 < 5 ? a[i + 3] : 0.f;
    b[i] = (b3 ? hi : lo) + __shfl_xor_sync(kAllLanes, b3 ? lo : hi, 8);
  }
  float c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lo = b[i], hi = i + 2 < 3 ? b[i + 2] : 0.f;
    c[i] = (b2 ? hi : lo) + __shfl_xor_sync(kAllLanes, b2 ? lo : hi, 4);
  }
  const float d =
      (b1 ? c[1] : c[0]) + __shfl_xor_sync(kAllLanes, b1 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(kAllLanes, d, 1);
}

// The term whose sum reduce_scatter10 leaves on this lane; -1 for odd
// lanes (their even neighbour stores) and for lanes that hold padding.
__device__ __forceinline__ int scatter_term(int lane) {
  const int ib = 2 * ((lane >> 2) & 1) + ((lane >> 1) & 1);  // in step 2's 3
  const int ia = 3 * ((lane >> 3) & 1) + ib;                 // in step 1's 5
  return ((lane & 1) || ib >= 3 || ia >= 5) ? -1
                                            : 5 * ((lane >> 4) & 1) + ia;
}

// The backward's shared memory for blocks of `threads` threads: the
// staged batch (kBwdBatch packed splats), then the per-warp partials
// (warps x kTerms x kBwdStride floats).
__host__ __forceinline__ int bwd_smem(int threads) {
  return static_cast<int>(kBwdBatch * sizeof(PackedSplat)) +
         threads / 32 * kTerms * kBwdStride * static_cast<int>(sizeof(float));
}

// The backward's reverse walk of one side x side corner `sub` of tile t:
// one thread per pixel, a warp on an 8x4 patch.  The run is streamed
// backwards through shared memory in batches of kBwdBatch splats, from
// the block's largest n_contrib (walk) down to rank 0, with barriers only
// at batch boundaries.  Inside a batch each warp starts at its own largest
// n_contrib (__reduce_max_sync) and skips every rank no lane of it needs:
// above that bound, and splats whose footprint provably misses the warp's
// pixel rectangle (patch_culled).  Inside a walked rank, a pixel whose
// power falls below the splat's pmin skips the exp.  For each rank a warp
// walks, __ballot_sync tells how many lanes blended: none (ten zeros), one
// (that lane's terms are the sums, no shuffle) or more (reduce_scatter10).
// The warp's ten sums go to per-warp partials with plain stores; after the
// batch one thread per (rank, term) adds them in warp order (only warps
// that walked the rank) and hands the sum to sink(rank, term, sum), term
// by term for consecutive threads when Sink::kTermMajor, else rank by
// rank.  Every rank in [0, walk) is handed over; returns walk.  No
// atomics: the same inputs give the same bits.  With kCount,
// counters[0..1] receive the (warp, rank) pairs below the warp's own
// bound that it walked, and those its rectangle test culled.
// s_dyn: bwd_smem(blockDim.x) bytes.
template <bool kCount, class Run, class Sink>
__device__ __forceinline__ int bwd_tile(
    const Run& run, const Sink& sink, int t, int sub, int nsx, int ntx,
    int tile, int side, const float* __restrict__ out,
    const int* __restrict__ n_contrib, const float* __restrict__ g,
    float4* s_dyn, unsigned long long* __restrict__ counters) {
  PackedSplat* s_splat = reinterpret_cast<PackedSplat*>(s_dyn);
  float* s_part = reinterpret_cast<float*>(s_splat + kBwdBatch);
  __shared__ int s_wwalk[kMaxWarps];
  __shared__ unsigned s_wmask[kMaxWarps][kBwdBatch / 32];  // ranks walked
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int2 xy = corner_pixel(tid, side, sub, nsx);
  const int x = xy.x, y = xy.y;
  const bool pixel = tid < side * side && x < tile && y < tile;
  const int P = tile * tile;
  const int pid = y * tile + x;
  const float px = static_cast<float>((t % ntx) * tile + x);
  const float py = static_cast<float>((t / ntx) * tile + y);
  const int count = run.count;
  const size_t base = static_cast<size_t>(t) * 8 * P + pid;

  const int nc = pixel ? n_contrib[static_cast<size_t>(t) * P + pid] : 0;
  BwdPixel p{1.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (pixel) {
    p.tr = out[base + 4 * P];
    p.g_r = g[base];
    p.g_g = g[base + 1 * P];
    p.g_b = g[base + 2 * P];
    p.g_d = g[base + 3 * P];
    p.gtf_tf = g[base + 4 * P] * p.tr;
  }
  // the warp's pixel rectangle, for the per-splat cull
  const float xlo = warp_min(pixel ? px : INFINITY);
  const float xhi = warp_max(pixel ? px : -INFINITY);
  const float ylo = warp_min(pixel ? py : INFINITY);
  const float yhi = warp_max(pixel ? py : -INFINITY);
  const int wwalk = __reduce_max_sync(kAllLanes, nc);
  if (lane == 0) s_wwalk[warp] = wwalk;
  __syncthreads();
  int walk = 0;
  for (int w = 0; w < nwarps; ++w) walk = max(walk, s_wwalk[w]);
  walk = min(walk, count);
  float* part = s_part + warp * kTerms * kBwdStride;
  unsigned long long n_walked = 0ull, n_below = 0ull;  // with kCount

  for (int b0 = ((walk - 1) / kBwdBatch) * kBwdBatch; walk > 0 && b0 >= 0;
       b0 -= kBwdBatch) {
    const int n = min(kBwdBatch, walk - b0);
    __syncthreads();  // the previous batch's partials have been read
    for (int j = tid; j < n; j += blockDim.x) s_splat[j] = run.load(b0 + j);
    __syncthreads();
    // the ranks this warp walks: below its own largest n_contrib, and not
    // culled for its rectangle (one bit each, kept for the sum below)
    const int top = min(n, wwalk - b0);
    unsigned walked[kBwdBatch / 32];
#pragma unroll
    for (int q = 0; q < kBwdBatch / 32; ++q) {
      const int j = q * 32 + lane;
      walked[q] = __ballot_sync(
          kAllLanes,
          j < top && !patch_culled(s_splat[j], xlo, xhi, ylo, yhi));
      if (lane == 0) s_wmask[warp][q] = walked[q];
      if (kCount) n_walked += __popc(walked[q]);
    }
    if (kCount) n_below += max(top, 0);
#pragma unroll
    for (int q = kBwdBatch / 32 - 1; q >= 0; --q) {
      for (unsigned bits = walked[q]; bits != 0u;) {
        const int jb = 31 - __clz(bits);
        bits &= ~(1u << jb);
        const int j = q * 32 + jb;  // ranks in decreasing order
        float v[kTerms];
#pragma unroll
        for (int c = 0; c < kTerms; ++c) v[c] = 0.f;
        bool blended = false;
        if (b0 + j < nc) {
          const Splat sp = unpack(s_splat[j]);
          if (!(splat_power(sp, px - sp.mx, py - sp.my) < s_splat[j].c.z))
            blended = bwd_pair(p, px, py, sp, v);
        }
        const unsigned m = __ballot_sync(kAllLanes, blended);
        if (m == 0u) {
          if (lane < kTerms) part[lane * kBwdStride + j] = 0.f;
        } else if ((m & (m - 1u)) == 0u) {
          if (blended) {
#pragma unroll
            for (int c = 0; c < kTerms; ++c) part[c * kBwdStride + j] = v[c];
          }
        } else {
          const float s = reduce_scatter10(v, lane);
          const int c = scatter_term(lane);
          if (c >= 0) part[c * kBwdStride + j] = s;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < kTerms * n; i += blockDim.x) {
      int j, c;
      if (Sink::kTermMajor) {
        c = i / n;
        j = i - c * n;
      } else {
        j = i / kTerms;
        c = i - j * kTerms;
      }
      float sum = 0.f;
      for (int w = 0; w < nwarps; ++w) {
        if ((s_wmask[w][j >> 5] >> (j & 31)) & 1u)
          sum = sum + s_part[(w * kTerms + c) * kBwdStride + j];
      }
      sink(b0 + j, c, sum);
    }
  }
  if (kCount && lane == 0) {
    atomicAdd(&counters[0], n_walked);
    atomicAdd(&counters[1], n_below - n_walked);
  }
  return walk;
}

}  // namespace gs
