// The chunked nearest-neighbour search shared by K2 (nn1.cu, 1-NN) and K3
// (knn.cu, k-NN): references packed into chunks of kChunk positions of a
// spatial order, each with its axis-aligned box; a lower bound between a
// box of queries and a chunk's box; the block's chunk list sorted by it,
// nearest first, kSortChunks chunks at a time (a segment of the order, its
// keys in shared memory).  A search walks the segments in turn (K2 one
// launch a segment, K3 a loop in its launch), each nearest first, so it
// takes any number of references; the skip and stop rules below hold
// inside each segment's sorted list.
//
// The lower bound.  For boxes [qlo, qhi] (queries) and [lo, hi] (a
// chunk), per axis g = max(qlo - hi, lo - qhi, 0) and
// lb = ((gx*gx + gy*gy) + gz*gz) * (1 - 2^-20), each operation rounded to
// nearest on its own (built with -fmad=false).  For a query q and a
// reference r in the boxes, q.x - r.x >= qlo.x - hi.x and r.x - q.x >=
// lo.x - qhi.x hold exactly, and rounding to nearest is monotone, so
// |fl(q.x - r.x)| >= fl(gap) >= 0, and every later operation (a square of
// a larger non-negative number, a sum of larger addends) rounds to a
// value at least as large: lb before the shrink is already <= the rounded
// distance of every pair of the two boxes.  The shrink by 2^-20 is a
// margin on top of that argument; a NaN gap counts as 0.  A search may
// therefore pass over a chunk whose bound is strictly greater than a
// distance it has already got: every reference in it is strictly farther.
#pragma once

#include "common.cuh"

namespace gs {

constexpr int kChunk = 128;       // references per chunk
constexpr int kSortChunks = 8192;  // a segment: 64 KB of sort keys
constexpr float kShrink = 1.0f - 1.0f / 1048576.0f;

// (distance bits, index) as one 64-bit word: for distances >= +0 the
// words order as (distance, index) pairs do, lexicographically.
__device__ __forceinline__ unsigned long long pack(float d, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned int>(i);
}

__device__ __forceinline__ float packed_dist(unsigned long long w) {
  return __uint_as_float(static_cast<unsigned int>(w >> 32));
}

__device__ __forceinline__ int packed_index(unsigned long long w) {
  return static_cast<int>(w & 0xffffffffull);
}

// The squared distance of a valid reference (bias 0, its add left out):
// gs_sqdist_bias's rounding.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        float4 r) {
  const float dx = __fsub_rn(qx, r.x);
  const float dy = __fsub_rn(qy, r.y);
  const float dz = __fsub_rn(qz, r.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float gap(float qlo, float qhi, float lo,
                                     float hi) {
  return fmaxf(fmaxf(__fsub_rn(qlo, hi), __fsub_rn(lo, qhi)), 0.f);
}

// The lower bound above, between [qlo, qhi] and [lo, hi] (.xyz).
__device__ __forceinline__ float box_lb(float3 qlo, float3 qhi, float4 lo,
                                        float4 hi) {
  const float gx = gap(qlo.x, qhi.x, lo.x, hi.x);
  const float gy = gap(qlo.y, qhi.y, lo.y, hi.y);
  const float gz = gap(qlo.z, qhi.z, lo.z, hi.z);
  return __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                __fmul_rn(gz, gz)),
      kShrink);
}

// One block per chunk of kChunk positions of the reference order.  It
// drops the invalid references (a valid bias is 0, so leaving out its add
// changes no bit), packs the rest in order as (x, y, z, original index),
// and writes their count and their axis-aligned box.  Reference `slot` is
// (pts[slot * ps], pts[as + slot * ps], pts[2 * as + slot * ps]): as = Tp,
// ps = 1 for K2's channel-first (3, Tp); as = 1, ps = 3 for K3's (R, 3).
// It is valid where bias[slot] == 0 (bias non-null) or valid[slot] != 0.
// rorder null: the index order.  Zeroes the two counters.
__global__ void __launch_bounds__(kChunk)
nn_chunks(const float* __restrict__ pts, int as, int ps,
          const float* __restrict__ bias,
          const unsigned char* __restrict__ valid,
          const int* __restrict__ rorder, int L, int Tp,
          float4* __restrict__ cref, float4* __restrict__ cbox,
          int* __restrict__ ccount,
          unsigned long long* __restrict__ counters) {
  __shared__ int s_n[kChunk / 32];
  __shared__ float s_box[6][kChunk / 32];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j = c * kChunk + tid;
  if (j == 0) counters[0] = counters[1] = 0ull;
  int slot = -1;
  if (j < L) slot = rorder == nullptr ? j : rorder[j];
  const bool in = slot >= 0 && slot < Tp &&
                  (bias != nullptr ? bias[slot] == 0.f : valid[slot] != 0);
  float x = 0.f, y = 0.f, z = 0.f;
  if (in) {
    const size_t o = static_cast<size_t>(slot) * ps;
    x = pts[o];
    y = pts[as + o];
    z = pts[2 * static_cast<size_t>(as) + o];
  }
  const unsigned m = __ballot_sync(kAllLanes, in);
  float b[6] = {in ? x : INFINITY,  in ? y : INFINITY,  in ? z : INFINITY,
                in ? x : -INFINITY, in ? y : -INFINITY, in ? z : -INFINITY};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b[k] = warp_min(b[k]);
    b[k + 3] = warp_max(b[k + 3]);
  }
  if (lane == 0) {
    s_n[warp] = __popc(m);
#pragma unroll
    for (int k = 0; k < 6; ++k) s_box[k][warp] = b[k];
  }
  __syncthreads();
  int off = 0, total = 0;
  for (int w = 0; w < kChunk / 32; ++w) {
    off += w < warp ? s_n[w] : 0;
    total += s_n[w];
  }
  if (in) {
    cref[static_cast<size_t>(c) * kChunk + off +
         __popc(m & ((1u << lane) - 1u))] =
        make_float4(x, y, z, __int_as_float(slot));
  }
  if (tid == 0) {
    float4 lo = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    float4 hi = make_float4(-INFINITY, -INFINITY, -INFINITY, 0.f);
    for (int w = 0; w < kChunk / 32; ++w) {
      lo.x = fminf(lo.x, s_box[0][w]);
      lo.y = fminf(lo.y, s_box[1][w]);
      lo.z = fminf(lo.z, s_box[2][w]);
      hi.x = fmaxf(hi.x, s_box[3][w]);
      hi.y = fmaxf(hi.y, s_box[4][w]);
      hi.z = fmaxf(hi.z, s_box[5][w]);
    }
    cbox[2 * c] = lo;
    cbox[2 * c + 1] = hi;
    ccount[c] = total;
  }
}

// The scratch both searches take, for nch chunks (m = max(nch, 1)): the
// packed references (m * kChunk float4), the boxes (2m float4), two
// 64-bit counters (chunk visits, references compared) and the counts (m
// int): m * (kChunk * 16 + 36) + 16 bytes, 16-byte aligned.
struct ChunkScratch {
  float4* cref;
  float4* cbox;
  unsigned long long* counters;
  int* ccount;
};

__host__ __forceinline__ ChunkScratch chunk_scratch(void* scratch, int nch) {
  const int m = nch > 0 ? nch : 1;
  ChunkScratch s;
  s.cref = static_cast<float4*>(scratch);
  s.cbox = s.cref + static_cast<size_t>(m) * kChunk;
  s.counters = reinterpret_cast<unsigned long long*>(s.cbox + 2 * m);
  s.ccount = reinterpret_cast<int*>(s.counters + 2);
  return s;
}

// A query of a group: its index (-1 past Q), point, and whether it is
// live, i.e. finite (a query with an inf or NaN coordinate is at no finite
// distance from anything, keeps the empty answer, and neither widens the
// group's box nor asks for a chunk).
struct QueryPoint {
  int q;
  bool live;
  float x, y, z;
};

__device__ __forceinline__ QueryPoint load_query_point(
    const float* __restrict__ query, const int* __restrict__ qorder, int Q,
    int k) {
  QueryPoint a{-1, false, 0.f, 0.f, 0.f};
  if (k < Q) {
    a.q = qorder == nullptr ? k : qorder[k];
    a.x = query[3 * a.q + 0];
    a.y = query[3 * a.q + 1];
    a.z = query[3 * a.q + 2];
    a.live = isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
  }
  return a;
}

// Does a live query at (x, y, z) need chunk [lo, hi]: its own bound is at
// most thr, the distance it must beat.
__device__ __forceinline__ bool point_needs(const QueryPoint& a, float4 lo,
                                            float4 hi, float thr) {
  const float3 p = make_float3(a.x, a.y, a.z);
  return a.live && box_lb(p, p, lo, hi) <= thr;
}

// The block's chunk list for one segment, chunks [c0, c0 + nseg): (bound
// bits, chunk) keys for the group's box [glo, ghi] against every chunk's
// (an empty chunk: +inf), sorted ascending in s_key (nsort, a power of two
// >= nseg; keys past nseg are all ones) by a bitonic sort with every
// thread of the block.  Ends with a barrier.
__device__ __forceinline__ void sort_chunks(
    float3 glo, float3 ghi, const float4* __restrict__ cbox,
    const int* __restrict__ ccount, int c0, int nseg, int nsort,
    unsigned long long* s_key) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < nsort; i += nt) {
    unsigned long long key = ~0ull;
    if (i < nseg) {
      const int c = c0 + i;
      const float lb = ccount[c] > 0
                           ? box_lb(glo, ghi, cbox[2 * c], cbox[2 * c + 1])
                           : INFINITY;
      key = pack(lb, c);
    }
    s_key[i] = key;
  }
  __syncthreads();
  for (int k = 2; k <= nsort; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < nsort; i += nt) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long u = s_key[i], w = s_key[ixj];
          if ((u > w) == ((i & k) == 0)) {
            s_key[i] = w;
            s_key[ixj] = u;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The sort size of a segment of n chunks: a power of two >= n.
__host__ __device__ __forceinline__ int sort_size(int n) {
  int nsort = 1;
  while (nsort < n) nsort <<= 1;
  return nsort;
}

}  // namespace gs
