// K3: exact k-nearest-neighbour search (the frame-0 target covariances,
// k = 20, and mean_sq_dist_3nn, k = 4).
//
// Replaces: gs_icp_slam_tpu/ops/nn_pallas.py `_knn_kernel` (built by
// `_make_knn`, entered through `knn_search_pallas`).
//
// Contract: for each query (Q, 3) the k nearest references of ref (R, 3),
// nearest first, the query itself included when it is a reference.  The
// distance is (q - r)^2 summed in the order x, y, z (each operation
// rounded on its own, gs_sqdist_bias) plus a bias of 0 on a valid
// reference and +3.4e38 on an invalid one; ties go to the lowest index.
// Missing neighbours (fewer than k valid references) report 3.4e38, and
// their index is unspecified (here 0).  Any k >= 1, any R.
//
// What bounds it on the H100: the pairs it must compare.  A brute-force
// scan compares Q x R pairs (8.3k^2 at tracking geometry, ~10 fp32
// operations each: 10 us at 67 TFLOP/s) and is bound by the instructions
// it issues on pairs that cannot win: on the frame-0 cloud the 20 nearest
// of 8,280 points lie within centimetres, and a bound on whole chunks of
// references rules out almost all the rest.
//
// Design, three or four launches in one call, sharing K2's chunks, bound
// and chunk sort (nn_common.cuh):
//  1. knn_order (once for the references, once more for the queries
//     unless they are the references): one block sorts the cloud's points
//     by the Morton code of their cell on a 32^3 grid over the bounding box
//     of its valid points (a counting sort in shared memory; invalid
//     references last), so that a run of the order is a compact piece of
//     space.  Above kOrderOneBlock points the same counting sort runs over
//     several blocks (order_box, order_hist, order_scan, order_scatter:
//     the box and the histogram by global atomics, one block's scan).  The
//     order changes the speed, never the result.  (Built here rather than
//     by the tracker's Morton sort, whose ~20 small tensor operations took
//     the host longer than this whole search.)
//  2. gs::nn_chunks packs the valid references of each kChunk positions
//     of the order with their box.
//  3. knn_search: one block per group of kGroup = 32 queries (taken in
//     their order, so a group is compact in space), a query per lane,
//     kWarps warps per block, each holding all 32 queries.  The block
//     sorts the chunks by their bound to the group's box, nearest first
//     (gs::kSortChunks at a time: above 2^20 references one segment after
//     another, the lists and thresholds carried over), and each warp walks
//     its own share of the sorted list (chunks warp, + kWarps, ...) with
//     no barrier, each chunk staged through the warp's own shared
//     buffer.  Every lane keeps its own sorted list of KMAX
//     (distance bits << 32 | index) words in registers (KMAX a template
//     parameter, so every index into the list is a compile-time constant
//     after unrolling; a runtime k is served by the smallest instantiated
//     KMAX >= k).  The words order as (distance, index) pairs do, so an
//     insertion by word order keeps the lowest-index tie rule although
//     chunks arrive out of index order.  At the end the warps' lists are
//     merged in shared memory by (distance, index).
//  4. Above k = 32, the search runs again for each further 32 neighbours
//     (a pass; the last takes the rest): pass p takes only references whose
//     word is above the floor, the word of neighbour 32p - 1 that the
//     previous pass wrote, so it finds neighbours 32p, 32p + 1, ... in
//     order.  The lists stay in registers (a list longer than 32 words
//     would go to local memory, and the merge's heads, 6 bits a warp, hold
//     entries below 64); each pass is exact on its own, so the k
//     neighbours are too.
//
// The thresholds.  Each query's threshold is the smallest upper bound on
// its k-th distance that any of its lanes has found, shared through a
// word per query in shared memory (atomicMin on the float bits: every
// distance is >= +0).  A lane's bound is the k-th distance of its full
// list or, while its list is short (k = KMAX), the largest of KMAX bucket
// minima over its first chunk (bucket_bound); either way k distinct real
// references lie within it, so the true k-th distance is never above it,
// and a reference strictly farther can never be among the k nearest.  So
// a lane takes a reference only when its distance is at most the
// threshold, a warp skips a chunk when no query's own bound to it is at
// most its threshold, and stops at the first chunk whose bound is
// strictly greater than the largest threshold of its queries (every later
// chunk is at least as far).  "Strictly" keeps every equal-distance,
// lower-index reference in reach; with fewer than k valid references
// every threshold stays 3.4e38 and nothing is culled.  A threshold read
// before another warp's merge is only larger, so every skip and stop
// stays safe.  The bucket bound matters for speed: a warp runs an
// insertion whenever any of its lanes takes a reference, and a lane with
// no bound takes every reference of its first chunk.  With counting on,
// two counters in the scratch buffer count the (group, chunk) visits and
// the references compared.
#include "nn_common.cuh"

namespace {

using gs::kChunk;
using gs::pack;
constexpr int kGroup = 32;  // queries per block, one a lane
constexpr int kWarps = 8;   // lists per query
constexpr int kThreads = kWarps * 32;
// The merge keeps each warp's next list entry in 6 bits of one 64-bit word
// (an entry below k <= 32), and a group is one query a lane.
static_assert(kWarps * 6 <= 64, "the merge's heads must fit one word");
static_assert(kGroup == 32, "a group is one warp's lanes");
constexpr unsigned kAll = 0xffffffffu;
constexpr int kCellBits = 5;  // per axis: a 32^3 grid of cells
constexpr int kCells = 1 << (3 * kCellBits);
constexpr int kOrderThreads = 1024;
constexpr int kOrderOneBlock = 1 << 17;  // more points: several blocks
constexpr int kPass = 32;                // neighbours per pass (k > 32)

// A float's bits as an unsigned that orders as the floats do.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The cell of one coordinate: floor((v - lo) / span * 32) in [0, 31].
__device__ __forceinline__ unsigned cell_of(float v, float lo, float span) {
  const float c = fminf(fmaxf((v - lo) / span * (1 << kCellBits), 0.f),
                        static_cast<float>((1 << kCellBits) - 1));
  return static_cast<unsigned>(c);  // a NaN coordinate: cell 0
}

__device__ __forceinline__ unsigned spread5(unsigned v) {
  unsigned s = 0u;
#pragma unroll
  for (int b = 0; b < kCellBits; ++b) s |= ((v >> b) & 1u) << (3 * b);
  return s;
}

// The sort key of point i: the Morton code of its cell, or kCells for an
// invalid point (all of them after the valid ones).
__device__ __forceinline__ int order_key(
    const float* __restrict__ pts, const unsigned char* __restrict__ valid,
    int i, const float* lo, const float* span) {
  if (valid != nullptr && !valid[i]) return kCells;
  const float* p = pts + 3 * static_cast<size_t>(i);
  return static_cast<int>(spread5(cell_of(p[0], lo[0], span[0])) |
                          (spread5(cell_of(p[1], lo[1], span[1])) << 1) |
                          (spread5(cell_of(p[2], lo[2], span[2])) << 2));
}

// Exclusive prefix sum, in place, of the kCells + 1 counts in hist
// (shared or device memory), by all kOrderThreads threads of the block,
// each on a run of cells; s_part holds a partial per warp.  Ends with a
// barrier.
__device__ __forceinline__ void exclusive_scan_cells(int* hist, int* s_part) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int kRun = (kCells + 1 + kOrderThreads - 1) / kOrderThreads;
  const int c0 = tid * kRun;
  int sum = 0;
  for (int c = c0; c < min(c0 + kRun, kCells + 1); ++c) sum += hist[c];
  int incl = sum;  // inclusive scan over the threads: in each warp, then
                   // across the warps
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kAll, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_part[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += s_part[w];
  int place = base + incl - sum;  // each thread rewrites its own run
  for (int c = c0; c < min(c0 + kRun, kCells + 1); ++c) {
    const int cnt = hist[c];
    hist[c] = place;
    place += cnt;
  }
  __syncthreads();
}

// The frame of the cells: lo and span per axis from the box's ordered
// bits (lo xyz, hi xyz).
__device__ __forceinline__ void cell_frame(const unsigned* box, float* lo,
                                           float* span) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = unordered(box[a]);
    span[a] = fmaxf(unordered(box[a + 3]) - lo[a], 1e-12f);
  }
}

// The box of the valid points, reduced over the calling thread's points
// (from i0 in steps of di) and its warp, into b (lo xyz, hi xyz).
__device__ __forceinline__ void point_box(
    const float* __restrict__ pts, const unsigned char* __restrict__ valid,
    int n, int i0, int di, float (&b)[6]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b[a] = INFINITY;
    b[a + 3] = -INFINITY;
  }
  for (int i = i0; i < n; i += di) {
    if (valid != nullptr && !valid[i]) continue;
    const float* p = pts + 3 * static_cast<size_t>(i);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      b[a] = fminf(b[a], p[a]);
      b[a + 3] = fmaxf(b[a + 3], p[a]);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b[a] = gs::warp_min(b[a]);
    b[a + 3] = gs::warp_max(b[a + 3]);
  }
}

// One block: order (n,) int32 lists the points of pts (n, 3) by the key
// above (a counting sort: a histogram of the keys in shared memory, its
// exclusive prefix sum, then each point to the next free place of its
// key; points of one cell land in any order).  valid null: all valid.
__global__ void __launch_bounds__(kOrderThreads)
knn_order(const float* __restrict__ pts,
          const unsigned char* __restrict__ valid, int n,
          int* __restrict__ order) {
  extern __shared__ int s_hist[];  // kCells + 1 counts, then the places
  __shared__ unsigned s_box[6];    // ordered bits: lo xyz, hi xyz
  __shared__ float s_lo[3], s_span[3];
  __shared__ int s_part[kOrderThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < 3) {
    s_box[tid] = ordered(INFINITY);
    s_box[tid + 3] = ordered(-INFINITY);
  }
  for (int c = tid; c <= kCells; c += kOrderThreads) s_hist[c] = 0;
  __syncthreads();
  float b[6];
  point_box(pts, valid, n, tid, kOrderThreads, b);
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      atomicMin(&s_box[a], ordered(b[a]));
      atomicMax(&s_box[a + 3], ordered(b[a + 3]));
    }
  }
  __syncthreads();
  if (tid == 0) cell_frame(s_box, s_lo, s_span);
  __syncthreads();
  for (int i = tid; i < n; i += kOrderThreads)
    atomicAdd(&s_hist[order_key(pts, valid, i, s_lo, s_span)], 1);
  __syncthreads();
  exclusive_scan_cells(s_hist, s_part);
  for (int i = tid; i < n; i += kOrderThreads)
    order[atomicAdd(&s_hist[order_key(pts, valid, i, s_lo, s_span)], 1)] = i;
}

// The same order over several blocks, for more than kOrderOneBlock points:
// work (8 + kCells + 1 words) holds the box's ordered bits (lo xyz, hi
// xyz, 2 unused) and the histogram.  order_init resets both; order_box
// reduces the box, order_hist counts the keys, order_scan (one block)
// turns the counts into places, order_scatter puts each point at the next
// free place of its key.  Every launch strides over the points.
__global__ void order_init(unsigned* __restrict__ work) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 3) {
    work[i] = ordered(INFINITY);
    work[i + 3] = ordered(-INFINITY);
  }
  if (i <= kCells) work[8 + i] = 0u;
}

__global__ void __launch_bounds__(kOrderThreads)
order_box(const float* __restrict__ pts,
          const unsigned char* __restrict__ valid, int n,
          unsigned* __restrict__ work) {
  float b[6];
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  point_box(pts, valid, n, tid, gridDim.x * blockDim.x, b);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      atomicMin(&work[a], ordered(b[a]));
      atomicMax(&work[a + 3], ordered(b[a + 3]));
    }
  }
}

__global__ void __launch_bounds__(kOrderThreads)
order_hist(const float* __restrict__ pts,
           const unsigned char* __restrict__ valid, int n,
           unsigned* __restrict__ work) {
  float lo[3], span[3];
  cell_frame(work, lo, span);
  int* hist = reinterpret_cast<int*>(work + 8);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    atomicAdd(&hist[order_key(pts, valid, i, lo, span)], 1);
}

__global__ void __launch_bounds__(kOrderThreads)
order_scan(unsigned* __restrict__ work) {
  __shared__ int s_part[kOrderThreads / 32];
  exclusive_scan_cells(reinterpret_cast<int*>(work + 8), s_part);
}

__global__ void __launch_bounds__(kOrderThreads)
order_scatter(const float* __restrict__ pts,
              const unsigned char* __restrict__ valid, int n,
              unsigned* __restrict__ work, int* __restrict__ order) {
  float lo[3], span[3];
  cell_frame(work, lo, span);
  int* hist = reinterpret_cast<int*>(work + 8);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    order[atomicAdd(&hist[order_key(pts, valid, i, lo, span)], 1)] = i;
}

// Put word w into the ascending list if it is below its last entry.  Every
// new entry is picked from the old list and w by two compares with w,
// all independent of each other: no chain of compare-exchanges.
template <int KMAX>
__device__ __forceinline__ void insert(unsigned long long (&list)[KMAX],
                                       unsigned long long w) {
  if (w < list[KMAX - 1]) {
    bool before = w < list[0];  // w goes in front of entry m - 1
    unsigned long long next[KMAX];
    next[0] = before ? w : list[0];
#pragma unroll
    for (int m = 1; m < KMAX; ++m) {
      const bool here = w < list[m];
      next[m] = before ? list[m - 1] : (here ? w : list[m]);
      before = here;
    }
#pragma unroll
    for (int m = 0; m < KMAX; ++m) list[m] = next[m];
  }
}

// An upper bound on the k-th distance of the query, for k = KMAX, from a
// chunk (wref, n references) alone: deal the references round-robin into
// KMAX buckets and take the largest of the buckets' nearest distances.
// Those are KMAX distinct references, so the k-th distance is at most
// that; with fewer than KMAX references (or a bucket of NaN distances)
// some bucket stays +inf, and so does the bound.  With kFloor, only the
// references whose word is above `floor` count.
template <int KMAX, bool kFloor>
__device__ __forceinline__ float bucket_bound(const gs::QueryPoint& a,
                                              const float4* wref, int n,
                                              unsigned long long floor) {
  float near[KMAX];
#pragma unroll
  for (int m = 0; m < KMAX; ++m) near[m] = INFINITY;
  for (int j0 = 0; j0 < n; j0 += KMAX) {
#pragma unroll
    for (int m = 0; m < KMAX; ++m) {
      if (j0 + m < n) {
        const float4 r = wref[j0 + m];
        const float d = gs::sqdist(a.x, a.y, a.z, r);
        if (!kFloor || pack(d, __float_as_int(r.w)) > floor)
          near[m] = fminf(near[m], d);
      }
    }
  }
  float t = near[0];
#pragma unroll
  for (int m = 1; m < KMAX; ++m) t = fmaxf(t, near[m]);
  return t;
}

// Compare the lane's query with the chunk staged in the warp's buffer
// (wref, n references) and take every reference at a distance of at most
// the threshold thr (and its own k-th distance) into its list (with
// kFloor, only if its word is above `floor`).  Returns the lane's new k-th
// distance.
template <int KMAX, bool kFloor>
__device__ __forceinline__ float compare_chunk(
    const gs::QueryPoint& a, unsigned long long (&list)[KMAX], float own,
    float thr, const float4* wref, int n, unsigned long long floor) {
  float t = fminf(own, thr);
  for (int j = 0; j < n; ++j) {
    const float4 r = wref[j];  // one address for the warp: a broadcast
    const float d = gs::sqdist(a.x, a.y, a.z, r);
    if (d <= t) {
      const unsigned long long w = pack(d, __float_as_int(r.w));
      if (kFloor && !(w > floor)) continue;
      insert(list, w);
      own = gs::packed_dist(list[KMAX - 1]);
      t = fminf(t, own);
    }
  }
  return own;
}

// One pass: the k (<= KMAX) nearest references of each query of the
// block's group, written to idx/sqd[q * ldo + m], m < k.  With kFloor,
// those whose word is above the query's floor, the word at idx/sqd[q * ldo
// - 1] (the previous pass's last neighbour).
template <int KMAX, bool kCount, bool kFloor>
__global__ void __launch_bounds__(kThreads)
knn_search(const float* __restrict__ query, const int* __restrict__ qorder,
           int Q, const float4* __restrict__ cref,
           const float4* __restrict__ cbox, const int* __restrict__ ccount,
           int nch, int k, int ldo, int* __restrict__ idx,
           float* __restrict__ sqd,
           unsigned long long* __restrict__ counters) {
  // dynamic: while searching, the warps' chunk buffers (kWarps x kChunk
  // float4) and one segment's (bound bits, chunk) keys; then, for the
  // merge, the lists (kWarps x k x kGroup words) over the same bytes
  extern __shared__ float4 s_dyn[];
  float4* s_ref = s_dyn;
  auto* s_key = reinterpret_cast<unsigned long long*>(s_dyn + kWarps * kChunk);
  auto* s_list = reinterpret_cast<unsigned long long*>(s_dyn);
  __shared__ unsigned s_thr[kGroup];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const gs::QueryPoint a =
      gs::load_query_point(query, qorder, Q, blockIdx.x * kGroup + lane);
  unsigned long long floor = 0ull;
  if (kFloor && a.q >= 0) {
    const long long o = static_cast<long long>(a.q) * ldo - 1;
    floor = pack(sqd[o], idx[o]);
  }

  // the group's box (every warp computes the same one)
  float bx[6] = {a.live ? a.x : INFINITY,  a.live ? a.y : INFINITY,
                 a.live ? a.z : INFINITY,  a.live ? a.x : -INFINITY,
                 a.live ? a.y : -INFINITY, a.live ? a.z : -INFINITY};
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    bx[m] = gs::warp_min(bx[m]);
    bx[m + 3] = gs::warp_max(bx[m + 3]);
  }
  const float3 glo = make_float3(bx[0], bx[1], bx[2]);
  const float3 ghi = make_float3(bx[3], bx[4], bx[5]);
  if (tid < kGroup) s_thr[tid] = __float_as_uint(GS_BIG);

  // The list's first KMAX - k entries hold 0, below every word a
  // reference can make but (+0, index 0), which is equal to it: the last
  // k entries are then the k smallest words taken, and the last one is
  // the k-th distance.  (Every index into the list stays a constant: an
  // entry picked by the runtime k would put the list in local memory.)
  unsigned long long list[KMAX];
#pragma unroll
  for (int m = 0; m < KMAX; ++m)
    list[m] = m < KMAX - k ? 0ull : pack(GS_BIG, 0);
  float own = GS_BIG;  // the k-th distance of this lane's list
  float4* wref = s_ref + warp * kChunk;
  // The chunks kSortChunks at a time (one segment when R <= 2^20), each
  // segment sorted nearest first; lists and thresholds carry over.
  for (int c0 = 0; c0 < nch; c0 += gs::kSortChunks) {
    const int nseg = min(gs::kSortChunks, nch - c0);
    if (c0 > 0) __syncthreads();  // every warp is done with the keys
    gs::sort_chunks(glo, ghi, cbox, ccount, c0, nseg, gs::sort_size(nseg),
                    s_key);
    // Every warp walks its share of the sorted chunks (warp, + kWarps,
    // ...).
    for (int kk = warp; kk < nseg; kk += kWarps) {
      const unsigned long long key = s_key[kk];
      const float lb = gs::packed_dist(key);
      const int c = gs::packed_index(key);
      const float thr = fminf(
          own, __uint_as_float(
                   *reinterpret_cast<volatile unsigned*>(&s_thr[lane])));
      if (lb > gs::warp_max(a.live ? thr : 0.f)) break;  // all later too
      const float4 lo = cbox[2 * c];
      const float4 hi = cbox[2 * c + 1];
      if (!__any_sync(kAll, gs::point_needs(a, lo, hi, thr))) continue;
      const int n = ccount[c];
      if (kCount && lane == 0) {  // (group, chunk) visits, refs compared
        atomicAdd(&counters[0], 1ull);
        atomicAdd(&counters[1], static_cast<unsigned long long>(n));
      }
      const float4* cr = cref + static_cast<size_t>(c) * kChunk;
      __syncwarp();  // the previous chunk has been read
      for (int j = lane; j < n; j += 32) wref[j] = cr[j];
      __syncwarp();
      if (!a.live) continue;
      float t = thr;
      if (own == GS_BIG && k == KMAX) {
        // the list is short: bound the k-th distance by this chunk first,
        // and share the bound with the other warps
        t = fminf(t, bucket_bound<KMAX, kFloor>(a, wref, n, floor));
        if (t < thr) atomicMin(&s_thr[lane], __float_as_uint(t));
      }
      const float before = own;
      own = compare_chunk<KMAX, kFloor>(a, list, own, t, wref, n, floor);
      if (own < before) atomicMin(&s_thr[lane], __float_as_uint(own));
    }
  }
  __syncthreads();

  // every warp is done with its buffer and the keys: merge the lists
#pragma unroll
  for (int m = 0; m < KMAX; ++m) {
    if (m >= KMAX - k)
      s_list[(warp * k + m - (KMAX - k)) * kGroup + lane] = list[m];
  }
  __syncthreads();
  if (warp != 0 || a.q < 0) return;
  // the next entry of each warp's list, 6 bits a warp (k <= 32): one
  // register, where an array indexed by the winning warp would go to
  // local memory
  unsigned long long heads = 0ull;
  for (int m = 0; m < k; ++m) {
    unsigned long long best = ~0ull;
    int wb = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // sum of the heads = m < k, so every head is < k
      const int h = static_cast<int>((heads >> (6 * w)) & 63ull);
      const unsigned long long v = s_list[(w * k + h) * kGroup + lane];
      if (v < best) {
        best = v;
        wb = w;
      }
    }
    heads += 1ull << (6 * wb);
    idx[static_cast<size_t>(a.q) * ldo + m] = gs::packed_index(best);
    sqd[static_cast<size_t>(a.q) * ldo + m] = gs::packed_dist(best);
  }
}

template <int KMAX, bool kCount, bool kFloor>
int launch(const float* query, const int* qorder, int Q,
           const gs::ChunkScratch& cs, int nch, int k, int ldo, int* idx,
           float* sqd, cudaStream_t stream) {
  const int nsort = gs::sort_size(min(nch, gs::kSortChunks));
  const int search = kWarps * kChunk * static_cast<int>(sizeof(float4)) +
                     nsort * static_cast<int>(sizeof(unsigned long long));
  const int merge =
      kWarps * k * kGroup * static_cast<int>(sizeof(unsigned long long));
  const int smem = max(search, merge);
  static int allowed = 47 * 1024;  // with the static bytes, the 48 KB default
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_search<KMAX, kCount, kFloor>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  knn_search<KMAX, kCount, kFloor>
      <<<(Q + kGroup - 1) / kGroup, kThreads, smem, stream>>>(
          query, qorder, Q, cs.cref, cs.cbox, cs.ccount, nch, k, ldo, idx,
          sqd, cs.counters);
  return static_cast<int>(cudaGetLastError());
}

// k <= 32: one pass, with the smallest list that holds k; more: passes of
// kPass neighbours, each above the last one's floor.
template <bool kCount>
int search(const float* query, const int* qorder, int Q,
           const gs::ChunkScratch& cs, int nch, int k, int* idx, float* sqd,
           cudaStream_t stream) {
  if (k <= kPass) {
    auto* run = k <= 4    ? launch<4, kCount, false>
                : k <= 8  ? launch<8, kCount, false>
                : k <= 16 ? launch<16, kCount, false>
                : k <= 20 ? launch<20, kCount, false>
                          : launch<32, kCount, false>;
    return run(query, qorder, Q, cs, nch, k, k, idx, sqd, stream);
  }
  int err = launch<kPass, kCount, false>(query, qorder, Q, cs, nch, kPass, k,
                                         idx, sqd, stream);
  for (int m0 = kPass; err == 0 && m0 < k; m0 += kPass) {
    err = launch<kPass, kCount, true>(query, qorder, Q, cs, nch,
                                      min(kPass, k - m0), k, idx + m0,
                                      sqd + m0, stream);
  }
  return err;
}

// The order of pts (n, 3) into out (n,): one block up to kOrderOneBlock
// points, else several (work: 8 + kCells + 1 words of scratch).
int order(const float* pts, const unsigned char* valid, int n, int* out,
          unsigned* work, cudaStream_t stream) {
  if (n > kOrderOneBlock) {
    const int blocks = min((n + kOrderThreads - 1) / kOrderThreads, 1024);
    order_init<<<(kCells + 1 + 1023) / 1024, 1024, 0, stream>>>(work);
    order_box<<<blocks, kOrderThreads, 0, stream>>>(pts, valid, n, work);
    order_hist<<<blocks, kOrderThreads, 0, stream>>>(pts, valid, n, work);
    order_scan<<<1, kOrderThreads, 0, stream>>>(work);
    order_scatter<<<blocks, kOrderThreads, 0, stream>>>(pts, valid, n, work,
                                                         out);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = (kCells + 1) * static_cast<int>(sizeof(int));
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_order, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  knn_order<<<1, kOrderThreads, smem, stream>>>(pts, valid, n, out);
  return static_cast<int>(cudaGetLastError());
}

// The scratch of one call: gs::chunk_scratch for ceil(R / 128) chunks,
// padded to 16 bytes, the order's work (8 + kCells + 1 words), then the
// references' order (R int) and the queries' (Q int).
constexpr long long kOrderWork = 4ll * (8 + kCells + 1);

long long scratch_bytes(int Q, int R) {
  const long long m = R > 0 ? (R + kChunk - 1) / kChunk : 1;
  const long long chunks = (m * (kChunk * 16 + 36) + 16 + 15) / 16 * 16;
  return chunks + kOrderWork + 4ll * R + 4ll * Q;
}

}  // namespace

GS_EXPORT_ERROR_STRING

// query (Q, 3), ref (R, 3) float32; valid (R,) bool bytes; k >= 1; same
// != 0 when query is ref (one order serves both); count != 0 to fill the
// two counters; scratch of scratch_bytes(Q, R) bytes, 16-byte aligned;
// idx (Q, k) int32, sqd (Q, k) float32.  Any R.
extern "C" int knn_launch(const float* query, int Q, const float* ref,
                          const unsigned char* valid, int R, int k, int same,
                          int count, void* scratch, int* idx, float* sqd,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nch = (R + kChunk - 1) / kChunk;
  if (k < 1 || Q < 0 || R < 0 || (same && Q != R))
    return static_cast<int>(cudaErrorInvalidValue);
  const gs::ChunkScratch cs = gs::chunk_scratch(scratch, nch);
  const long long orders = scratch_bytes(Q, R) - 4ll * R - 4ll * Q;
  unsigned* work = reinterpret_cast<unsigned*>(static_cast<char*>(scratch) +
                                               orders - kOrderWork);
  int* rorder = reinterpret_cast<int*>(static_cast<char*>(scratch) + orders);
  int* qorder = same ? rorder : rorder + R;
  int err = 0;
  if (R > 0) err = order(ref, valid, R, rorder, work, stream);
  if (err == 0 && !same && Q > 0)
    err = order(query, nullptr, Q, qorder, work, stream);
  if (err != 0) return err;
  gs::nn_chunks<<<nch > 0 ? nch : 1, kChunk, 0, stream>>>(
      ref, 1, 3, nullptr, valid, R > 0 ? rorder : nullptr, R, R, cs.cref,
      cs.cbox, cs.ccount, cs.counters);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || Q == 0) return err;
  return count ? search<true>(query, qorder, Q, cs, nch, k, idx, sqd, stream)
               : search<false>(query, qorder, Q, cs, nch, k, idx, sqd, stream);
}
