// K2: exact masked 1-nearest-neighbour search (the G-ICP correspondence
// search, run once per Gauss-Newton iteration).
//
// Replaces: gs_icp_slam_tpu/ops/nn_pallas.py `_nn_kernel` (built by
// `_make_nn`, entered through `nn_search_pre`).
//
// Contract: for each query q (Q, 3) the index and squared distance of the
// nearest reference among rT (3, Tp) channel-first, where the distance is
// ((dx*dx + dy*dy) + dz*dz) + bias[r], each operation rounded on its own
// (bias 0 on a valid reference, +3.4e38 on an invalid one; a reference
// with any other bias is taken as invalid).  Ties go to the lowest index.
// A query with no valid reference gets index 0 and 3.4e38.  Two optional
// orders change the speed and never the result: rorder (L,) int32, a
// permutation of [0, L) with L >= Tp (entries >= Tp are skipped), lists
// the references so that neighbours in space are neighbours in it;
// qorder (Q,) int32, a permutation of [0, Q), does the same for the
// queries.  Without them the index order is used.
//
// What bounds it on the H100: the pairs it must compare.  A brute-force
// scan compares Q x Tp (8.2k x 65.5k at tracking geometry, 9 fp32
// operations each: 72 us at the 67 TFLOP/s fp32 rate) and is bound by the
// instructions it issues on pairs that cannot win.  The G-ICP distances
// are centimetres in a scene metres across, so most pairs can be ruled
// out by a bound on whole chunks.
//
// Design, two launches:
//  1. gs::nn_chunks: one block per chunk of kChunk positions of the
//     reference order.  It drops the invalid references (a valid bias is
//     0, so leaving out its add changes no bit), packs the rest in order
//     as (x, y, z, original index), and writes their count and their
//     axis-aligned box.
//  2. nn1_search: one block per group of kGroup queries (taken in qorder),
//     which fills the card with groups rather than with reference splits:
//     a split whose chunks all lie far away would hold no tight best and
//     could never cull.  Each of the block's 16 warps holds all 64
//     queries (two a lane, register-blocked: one reference read feeds two
//     pairs).  The block computes a lower bound (below) between its
//     queries' box and every chunk's box and sorts the chunks by it
//     (bitonic, in shared memory).  Above gs::kSortChunks chunks (2^20
//     references) the launcher runs this kernel once per segment of
//     kSortChunks chunks, each launch starting from the bests the last
//     one wrote.  The nearest kCoop chunks are compared
//     one at a time by all warps together, which gives every query a
//     close best; then each warp walks its own share of the rest of the
//     sorted list (chunks kCoop + warp, + 16, ...) with no barrier,
//     staging each chunk through its own shared buffer (all loads in
//     flight at once) and comparing four references at a time (eight
//     independent distances, then one test of each query's nearest of
//     the four against its best).  A warp stops at the first chunk whose
//     bound is strictly greater than the largest best of its queries (all
//     later ones are at least as far), and skips a chunk when no query's
//     own bound to it is at most its best.  "Strictly" keeps the tie rule:
//     a reference at an equal distance and a lower index is never skipped.
//     A lane keeps (distance, index) and takes a reference when it is
//     nearer, or as near with a lower index (chunks arrive out of index
//     order).  Warps share their bests through a 64-bit (distance bits <<
//     32 | index) word per query in shared memory: atomicMin to merge, an
//     atomic read before each chunk (distances are >= +0, so their bits
//     order like the floats).  A best read before another warp's merge is
//     only larger, so every skip and stop stays safe.  The best starts at
//     (3.4e38, 0), the Pallas kernel's initial state.  Two counters in the
//     scratch buffer count the (group, chunk) visits and the references
//     compared.
//
// Why this schedule: a barrier after every chunk leaves a block waiting
// on each chunk's loads, which costs most where nothing culls; warps on
// their own from the first chunk compare many far chunks before any best
// is tight; warps reading references from device memory one at a time
// wait on every load.
//
// The lower bound, its proof and the chunk packing are shared with K3
// (nn_common.cuh).
#include "nn_common.cuh"

namespace {

using gs::kChunk;
using gs::pack;
using gs::sqdist;
constexpr int kGroup = 64;        // queries per block, two a lane
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kCoop = 4;          // nearest chunks compared by all warps
constexpr unsigned kAll = 0xffffffffu;

// One query slot of a lane: its point and best.  The best starts at
// (3.4e38, 0), the Pallas kernel's initial state.
struct Query : gs::QueryPoint {
  float bd;
  int bi;
};

// With kCarry, the best starts from the one idx/sqd hold (a previous
// segment's).
template <bool kCarry>
__device__ __forceinline__ Query load_query(const float* __restrict__ query,
                                            const int* __restrict__ qorder,
                                            int Q, int k,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ sqd) {
  Query a;
  static_cast<gs::QueryPoint&>(a) = gs::load_query_point(query, qorder, Q, k);
  a.bd = GS_BIG;
  a.bi = 0;
  if (kCarry && a.q >= 0) {
    a.bd = sqd[a.q];
    a.bi = idx[a.q];
  }
  return a;
}

// Take a reference at squared distance d (original index in the bits of
// rw) if it is nearer than the best, or as near with a lower index;
// returns whether it was taken.
__device__ __forceinline__ bool offer(Query& a, float d, float rw) {
  if (d <= a.bd) {
    const int ri = __float_as_int(rw);
    if (d < a.bd || ri < a.bi) {
      a.bd = d;
      a.bi = ri;
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ bool offer(Query& a, float4 r) {
  return offer(a, sqdist(a.x, a.y, a.z, r), r.w);
}

// Take the merged best m when it beats the lane's own.
__device__ __forceinline__ void take(Query& a, unsigned long long m) {
  if (m < pack(a.bd, a.bi)) {
    a.bd = __uint_as_float(static_cast<unsigned int>(m >> 32));
    a.bi = static_cast<int>(m & 0xffffffffull);
  }
}

// Does this query still need chunk [lo, hi]: its own bound is at most its
// best.
__device__ __forceinline__ bool needs(const Query& a, float4 lo, float4 hi) {
  return gs::point_needs(a, lo, hi, a.bd);
}

template <bool kCarry>
__global__ void __launch_bounds__(kThreads)
nn1_search(const float* __restrict__ query, const int* __restrict__ qorder,
           int Q, const float4* __restrict__ cref,
           const float4* __restrict__ cbox, const int* __restrict__ ccount,
           int c0, int nch, int nsort, int* __restrict__ idx,
           float* __restrict__ sqd, unsigned long long* __restrict__ counters) {
  // chunks [c0, c0 + nch), one segment (kCarry: not the first); dynamic
  // shared memory: the warps' chunk buffers (kWarps x kChunk float4), then
  // the nsort (bound bits, chunk) keys
  extern __shared__ float4 s_dyn[];
  float4* s_ref = s_dyn;
  auto* s_key = reinterpret_cast<unsigned long long*>(s_dyn + kWarps * kChunk);
  __shared__ unsigned long long s_best[kGroup];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g0 = blockIdx.x * kGroup;
  Query a = load_query<kCarry>(query, qorder, Q, g0 + lane, idx, sqd);
  Query b = load_query<kCarry>(query, qorder, Q, g0 + 32 + lane, idx, sqd);

  // the group's box (every warp computes the same one)
  float3 glo, ghi;
  {
    float bx[6];
    bx[0] = fminf(a.live ? a.x : INFINITY, b.live ? b.x : INFINITY);
    bx[1] = fminf(a.live ? a.y : INFINITY, b.live ? b.y : INFINITY);
    bx[2] = fminf(a.live ? a.z : INFINITY, b.live ? b.z : INFINITY);
    bx[3] = fmaxf(a.live ? a.x : -INFINITY, b.live ? b.x : -INFINITY);
    bx[4] = fmaxf(a.live ? a.y : -INFINITY, b.live ? b.y : -INFINITY);
    bx[5] = fmaxf(a.live ? a.z : -INFINITY, b.live ? b.z : -INFINITY);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      bx[k] = gs::warp_min(bx[k]);
      bx[k + 3] = gs::warp_max(bx[k + 3]);
    }
    glo = make_float3(bx[0], bx[1], bx[2]);
    ghi = make_float3(bx[3], bx[4], bx[5]);
  }
  if (!kCarry && tid < kGroup) s_best[tid] = pack(GS_BIG, 0);
  if (kCarry && tid < 32) {
    s_best[tid] = pack(a.bd, a.bi);
    s_best[tid + 32] = pack(b.bd, b.bi);
  }
  gs::sort_chunks(glo, ghi, cbox, ccount, c0, nch, nsort, s_key);

  // The nearest kCoop chunks first, one at a time, every warp on a share
  // of each chunk's references: the queries get close bests before the
  // warps go their own ways.  The decisions are the same in every warp
  // (the same queries, bests and chunk); two barriers a chunk keep the
  // bests read back equal.
  int k0 = 0;
  for (; k0 < min(nch, kCoop); ++k0) {
    const unsigned long long key = s_key[k0];
    const float lb = __uint_as_float(static_cast<unsigned int>(key >> 32));
    const int c = static_cast<int>(key & 0xffffffffull);
    const float worst = gs::warp_max(fmaxf(a.live ? a.bd : 0.f,
                                           b.live ? b.bd : 0.f));
    if (lb > worst) {  // every later chunk is at least as far
      k0 = nch;
      break;
    }
    const float4 lo = cbox[2 * c];
    const float4 hi = cbox[2 * c + 1];
    if (!__any_sync(kAll, needs(a, lo, hi) || needs(b, lo, hi))) continue;
    const int n = ccount[c];
    if (tid == 0) {
      atomicAdd(&counters[0], 1ull);
      atomicAdd(&counters[1], static_cast<unsigned long long>(n));
    }
    const float4* cr = cref + static_cast<size_t>(c) * kChunk;
    for (int j = tid; j < n; j += kThreads) s_ref[j] = cr[j];
    __syncthreads();
    bool ta = false, tb = false;
    for (int j = warp; j < n; j += kWarps) {
      const float4 r = s_ref[j];
      ta |= offer(a, r);
      tb |= offer(b, r);
    }
    if (ta) atomicMin(&s_best[lane], pack(a.bd, a.bi));
    if (tb) atomicMin(&s_best[lane + 32], pack(b.bd, b.bi));
    __syncthreads();
    take(a, s_best[lane]);
    take(b, s_best[lane + 32]);
    __syncthreads();
  }
  // Then each warp walks its own share of the rest (k = k0 + warp, + kWarps,
  // ...) without a barrier.  Before a chunk it takes the block's merged
  // bests (an atomic 64-bit read), after it merges its own with atomicMin.
  // A best read before another warp's merge is only larger, so every skip
  // and stop it decides stays safe.
  for (int k = k0 + warp; k < nch; k += kWarps) {
    const unsigned long long key = s_key[k];
    const float lb = __uint_as_float(static_cast<unsigned int>(key >> 32));
    const int c = static_cast<int>(key & 0xffffffffull);
    take(a, atomicOr(&s_best[lane], 0ull));
    take(b, atomicOr(&s_best[lane + 32], 0ull));
    const float worst = gs::warp_max(fmaxf(a.live ? a.bd : 0.f,
                                           b.live ? b.bd : 0.f));
    if (lb > worst) break;  // every later chunk is at least as far
    const float4 lo = cbox[2 * c];
    const float4 hi = cbox[2 * c + 1];
    if (!__any_sync(kAll, needs(a, lo, hi) || needs(b, lo, hi))) continue;
    const int n = ccount[c];
    if (lane == 0) {  // (group, chunk) visits and references compared
      atomicAdd(&counters[0], 1ull);
      atomicAdd(&counters[1], static_cast<unsigned long long>(n));
    }
    // staged through the warp's own buffer: all loads in flight at once
    const float4* cr = cref + static_cast<size_t>(c) * kChunk;
    float4* wref = s_ref + warp * kChunk;
    __syncwarp();  // the previous chunk has been read
    for (int j = lane; j < n; j += 32) wref[j] = cr[j];
    __syncwarp();
    // four references at a time: eight independent distances, then one
    // test of each query's nearest of the four against its best
    bool ta = false, tb = false;
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      const float4 r0 = wref[j], r1 = wref[j + 1], r2 = wref[j + 2],
                   r3 = wref[j + 3];  // one address for the warp: broadcasts
      const float a0 = sqdist(a.x, a.y, a.z, r0);
      const float a1 = sqdist(a.x, a.y, a.z, r1);
      const float a2 = sqdist(a.x, a.y, a.z, r2);
      const float a3 = sqdist(a.x, a.y, a.z, r3);
      const float b0 = sqdist(b.x, b.y, b.z, r0);
      const float b1 = sqdist(b.x, b.y, b.z, r1);
      const float b2 = sqdist(b.x, b.y, b.z, r2);
      const float b3 = sqdist(b.x, b.y, b.z, r3);
      if (fminf(fminf(a0, a1), fminf(a2, a3)) <= a.bd) {
        ta |= offer(a, a0, r0.w);
        ta |= offer(a, a1, r1.w);
        ta |= offer(a, a2, r2.w);
        ta |= offer(a, a3, r3.w);
      }
      if (fminf(fminf(b0, b1), fminf(b2, b3)) <= b.bd) {
        tb |= offer(b, b0, r0.w);
        tb |= offer(b, b1, r1.w);
        tb |= offer(b, b2, r2.w);
        tb |= offer(b, b3, r3.w);
      }
    }
    for (; j < n; ++j) {
      ta |= offer(a, wref[j]);
      tb |= offer(b, wref[j]);
    }
    if (ta) atomicMin(&s_best[lane], pack(a.bd, a.bi));
    if (tb) atomicMin(&s_best[lane + 32], pack(b.bd, b.bi));
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned long long ma = s_best[lane], mb = s_best[lane + 32];
    if (a.q >= 0) {
      idx[a.q] = static_cast<int>(ma & 0xffffffffull);
      sqd[a.q] = __uint_as_float(static_cast<unsigned int>(ma >> 32));
    }
    if (b.q >= 0) {
      idx[b.q] = static_cast<int>(mb & 0xffffffffull);
      sqd[b.q] = __uint_as_float(static_cast<unsigned int>(mb >> 32));
    }
  }
}

}  // namespace

GS_EXPORT_ERROR_STRING

// query (Q, 3), rT (3, Tp), bias (Tp,) float32; qorder (Q,) and rorder
// (L,) int32 or null (rorder null: L = Tp); scratch of m * (128 * 16 + 36)
// + 16 bytes, m = max(ceil(L / 128), 1), 16-byte aligned, laid out as
// the packed references (m * 128 float4), the boxes (2m float4), two
// 64-bit counters (visits, references compared) and the counts (m int);
// idx (Q,) int32, sqd (Q,) float32.  Any L: one launch of the search per
// gs::kSortChunks chunks.
extern "C" int nn1_launch(const float* query, const int* qorder, int Q,
                          const float* rT, const float* bias, int Tp,
                          const int* rorder, int L, void* scratch, int* idx,
                          float* sqd, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rorder == nullptr) L = Tp;
  const int nch = (L + kChunk - 1) / kChunk;
  if (Q < 0 || Tp < 0 || L < Tp)
    return static_cast<int>(cudaErrorInvalidValue);
  const gs::ChunkScratch cs = gs::chunk_scratch(scratch, nch);
  gs::nn_chunks<<<nch > 0 ? nch : 1, kChunk, 0, stream>>>(
      rT, Tp, 1, bias, nullptr, rorder, L, Tp, cs.cref, cs.cbox, cs.ccount,
      cs.counters);
  if (Q == 0) return static_cast<int>(cudaGetLastError());
  const int nsort = gs::sort_size(min(nch, gs::kSortChunks));
  const int smem =
      kWarps * kChunk * static_cast<int>(sizeof(float4)) +
      nsort * static_cast<int>(sizeof(unsigned long long));
  cudaError_t err = cudaSuccess;
  if (smem > 47 * 1024) {  // with the static 512 B, above the 48 KB default
    err = cudaFuncSetAttribute(
        nn1_search<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(nn1_search<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (Q + kGroup - 1) / kGroup;
  const int nseg = min(nch, gs::kSortChunks);
  nn1_search<false><<<grid, kThreads, smem, stream>>>(
      query, qorder, Q, cs.cref, cs.cbox, cs.ccount, 0, nseg,
      gs::sort_size(nseg), idx, sqd, cs.counters);
  for (int c0 = nseg; c0 < nch; c0 += gs::kSortChunks) {
    const int n = min(gs::kSortChunks, nch - c0);
    nn1_search<true><<<grid, kThreads, smem, stream>>>(
        query, qorder, Q, cs.cref, cs.cbox, cs.ccount, c0, n,
        gs::sort_size(n), idx, sqd, cs.counters);
  }
  return static_cast<int>(cudaGetLastError());
}
