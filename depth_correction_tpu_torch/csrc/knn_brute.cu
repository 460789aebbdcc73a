// Brute-force neighbour search (X3) for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces depth_correction_tpu/ops/knn.py:_knn_tiled (:51-97) and
// _counts_tiled (:269), plain XLA loops reached through nearest_neighbors,
// radius_neighbors and neighbor_counts: the online corrector's brute
// engine, the sizing of K in prep (suggest_k_max below 65,536 points),
// scan establishment below 65,536 points and the shadow filter's search
// over view directions. Their plain torch versions are _knn_plain and
// _counts_plain in depth_correction_tpu_torch/ops/knn.py. Its warp-per-query
// body (every query against every point) is knn_warp.cu.
//
// What it computes, per query q:
//   top-k (k > 0): the k smallest keys (d2, point index) over the valid
//     points with d2 <= r2 (r2 = inf when the caller gives no radius), in
//     ascending order; among equal d2 the lower index first, as lax.top_k
//     keeps it. Missing slots, and every slot of an invalid query, are
//     index -1 at d2 = inf.
//   counts (k = 0): the number of valid points with d2 <= r2, for every
//     query.
// d2 = dx*dx + dy*dy + dz*dz with d = q - p, each operation rounded on its
// own (no fused multiply-add), the plain version's order.
//
// What bounds it on this card: the pair tests, 8 float operations each.
// Without FMA each is one instruction, so the instruction floor is about
// twice the FLOP bound (which counts an FMA as two). The warp-per-query
// body (knn_warp.cu) runs ~15 instructions and 4 shared loads per pair
// test and tests every query against every point; this body cuts both.
//
// Design, in launches on the caller's stream:
// 1. Order (finite radius; step 4 orders the nearest search its own way;
//    otherwise nothing is ordered or culled).
//    knn_bounds_kernel takes the box of the rows keyed (a part per block),
//    knn_keys_kernel gives each row the Morton key of its cell (side
//    max(r, extent / 128), 7 bits an axis: with the invalid rows' key the
//    keys fit 22 bits, which CUB's device radix sort orders in 3 passes),
//    and the stable sort puts valid points and active queries first, so
//    that consecutive rows lie close together. Up to kOrderMax = 16,384
//    rows, knn_order_block_kernel does all three in one block and one
//    launch, with the same order: CUB's device sort costs the host several
//    launches and device queries per call, which on small inputs (the
//    shadow filter's ~12,000 view directions) took longer than the search.
//    When the queries are the points, one order serves both: keyed by every row when every row queries
//    (the counts, or a top-k without query validity; an invalid point is
//    still folded out as NaN), by the valid rows when the active queries
//    are the valid points.
//    The order changes no result: every key carries the point's original
//    index, d2 is computed from the same float32 values in the same
//    operation order, and each query's row is written back at its original
//    position.
// 2. knn_pack_kernel writes the points in that order as one float4 each
//    (x, y, z, original index as int bits), in tiles of kTile = 4 chunks of
//    32, and each chunk's and tile's box over its valid points. An invalid
//    point is folded in as NaN coordinates, so its d2 is NaN and
//    `d2 <= r2` is false with no separate test; the tail of the last tile
//    is NaN too.
// 3. knn_tiles_kernel: a block is one warp and each lane owns one query in
//    registers; a staged point feeds the warp's 32 pair tests, read by all
//    lanes as one broadcast 16-byte load. (Two queries a lane, which share
//    each load, ran slower on the small scan, on an H100 80GB HBM3 at
//    700 W: 0.149 against 0.095 ms for the top-32, 0.090 against 0.051 ms
//    for the counts; fewer, larger warps hide less latency and their boxes
//    are larger.) An inactive query
//    (invalid, or past the last row) holds NaN coordinates and finds
//    nothing.
//    - Cull, in two steps: the box of the warp's active queries against
//      each tile's box, then, for each chunk of a tile that passed, the
//      warp's box and each active query against the chunk's box (a ballot:
//      the warp reads a chunk if any of its queries may hold a member
//      there). Both distances are the gap per axis
//      in float32, then the pair test's own sum of squares; float32
//      rounding is monotone, so a box distance is at most the d2 of any
//      pair in the two boxes and no member is culled, with no margin (as
//      csrc/cellwin_fwd.cuh's warp box test). The per-query step bounds the
//      work of a warp whose queries spread over a large box (sparse regions
//      far from the sensor, jumps of the Morton curve). Kept tiles and their
//      chunk masks go to a list in shared memory, kChunk tiles at a time.
//    - Staging: lane 0 copies each kept tile into shared memory with a bulk
//      asynchronous copy (cp.async.bulk, completion on an mbarrier), in a
//      ring of kStages buffers: the next tiles are in flight while the warp
//      tests one.
//    - Pair tests, 8 points at a time with no branch; a lane whose query
//      has a candidate among them (d2 at most its limit) adds those after
//      the 8.
//    - Top-k: each query keeps its list of keys in shared memory (element e
//      of lane l at lists[e * 33 + l], so the lanes' accesses at one e, and
//      one lane's elements read across the lanes, fall in different
//      banks). Below k keys a member is appended; at k the list is sorted
//      once, its last key is held in a register and its d2 is the pair
//      test's limit, and a key below it is inserted by rank, dropping the
//      last. Keys are distinct (the index is in them), so ties cannot occur.
//      The radius searches of the main paths size k by the counts, so their
//      lists never fill and each member costs one store; a list that did not
//      fill is ordered at the end (by its lane when short, else by rank as
//      the warp writes it out).
//    - Counts add up the compares.
//    The warp writes each query's row of the tables coalesced.
// 4. The nearest search (k = 1, r2 = inf: SLAM's ICP, eval_icp, the ICP
//    loss, mapping_accuracy) takes its bound from the data. Without a
//    radius nothing bounds the top-k's search but the list's own last key,
//    so the radius cull above has nothing to cull by; this body gives the
//    same keys, min (d2, index) over the valid points, reading a few tiles.
//    - Order: knn_bounds_kernel takes the valid points' box; the points
//      and the queries are both keyed on that box's grid (side extent /
//      128, no radius floor; a query outside the box falls in an edge
//      cell), so a query's key says where it falls in the point order. An
//      invalid row, or one with a NaN coordinate (no neighbour, and a query
//      that finds none), takes kInvalidKey. One stable sort orders both
//      sides, a query's key flagged above the key bits (one block up to
//      kOrderMax rows, else CUB's device sort: one call's launches where
//      two sorts took twice as many), and the sorted keys are kept: a
//      tile's first key is the key of its first point.
//    - Seed: each active query finds the tile where its key falls among
//      the tiles' first keys (a binary search), and the warp reads the
//      union of those tiles and one on either side of each (its queries are
//      consecutive in the order, so mostly three or four tiles); each lane
//      then holds its query's best key (d2, index) in registers. Seeding
//      from the warp's median query alone left the lanes past a jump of
//      the Morton curve with limits of metres, and their warps walked
//      most of a street map's tiles.
//    - Cull: the warp walks the tile boxes in rounds of kChunk tiles as
//      step 3 does, with the largest limit (best d2) of its active lanes in
//      place of r2 for the warp's box and each lane's own limit for the
//      chunk ballot, both as they stand at the round's start (limits only
//      fall). A tile or chunk is skipped only when its box distance is
//      strictly greater than the limit, or when its box is empty: a point
//      at exactly the limit with a lower index may still win. The seed's
//      tiles (kept in shared memory, in the place of the top-k's lists)
//      are not read again.
//    - Sweeps: a query whose key falls past a jump of the Morton curve
//      seeds from points metres away while its nearest point lies in the
//      next cell, and one such limit made its warp read every chunk within
//      metres (40-70 times a typical warp's work in SLAM's slowest calls,
//      which took 0.8-1.0 ms against ~0.2). So a warp
//      whose largest limit lies beyond kSweepCells cells walks in sweeps:
//      the first caps each limit at kReachCells cells, each later one at
//      kGrowth times the squared reach before it, the last (or the one that
//      caps nothing) at the limit itself. Such a warp keeps a bitmap of the
//      chunks it has read (global scratch, 4 bits a tile), and no chunk is
//      read twice: its every query was tested on it. The cell side comes
//      from the order's kernel. Other warps walk once, as above. The walk
//      is compiled once (on a street map where no warp sweeps, the search
//      took 0.219 ms with a second copy for the sweeps, 0.201 with one,
//      0.177 with no sweeps; H100 80GB HBM3, 700 W); a lower cut a query
//      in place of the bitmap read again the chunks one query's cap had
//      reached for another.
//    The box distance is at most the d2 of every pair it covers (step 3),
//    so no key below a limit is ever skipped and the result is the
//    all-pairs search's, bit for bit. An optional tally counts the tiles
//    each warp read (tests and chip_smoke.py; no path passes one).
// Shared memory per block: the ring of tiles and its mbarriers, the kept
// list, the queries and (top-k) 33 * k keys. A k whose lists do not fit
// (dc_knn_brute_max_k gives the limit, 839 on an H100) is refused here;
// the launcher (ops/_kernels.py:launch_knn_brute) sends such a k to the
// warp-per-query body, knn_warp.cu, which holds two
// lists of k keys per warp and serves k up to about 13,680 on an H100.
// Clusters sharing a tile
// through distributed shared memory or TMA multicast are not used: with
// the cull each warp reads its own few kept tiles, a few MB to a few tens
// of MB per launch through L2 at the shapes of the main paths.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <limits>
#include <unordered_map>

#include <cub/block/block_radix_sort.cuh>
#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 128;    // points per staged tile (2,048 bytes)
constexpr int kChunks = 4;    // chunks of 32 points per tile
constexpr int kChunk = 512;   // tiles whose boxes a warp tests per round
constexpr int kBatch = 8;     // points per branch-free batch of pair tests
constexpr int kStages = 4;    // tiles in flight per warp
constexpr int kCellBits = 7;  // bits of each cell coordinate
constexpr float kMaxCell = static_cast<float>((1 << kCellBits) - 1);
constexpr int kKeyBits = 3 * kCellBits + 1;  // the bits the sort orders by
constexpr unsigned kInvalidKey = (1u << kKeyBits) - 1;  // sorts after every cell key
constexpr int kListStride = 33;  // keys between a query's list elements (32 lanes + 1)
constexpr int kSortByLane = 32;  // the longest unfilled list its lane sorts at the end
constexpr int kOrderThreads = 512;  // threads of the one-block cell order
constexpr int kOrderItems = 32;     // rows per thread there
constexpr int kOrderMax = kOrderThreads * kOrderItems;  // rows one block orders (16,384)
constexpr int kOrderRadixBits = 6;  // bits per pass of its sort (4 passes)
constexpr int kSeedMax = 3 * 32;    // the nearest search's seed tiles, at most, per warp
// The nearest search's sweeps, for a warp whose largest limit lies beyond
// kSweepCells cells: the first reaches kReachCells cells (a squared reach
// of kReachCells^2 cell sides squared), each later one kGrowth times the
// squared reach of the one before, and sweep kSweeps - 1 takes every
// query's own limit.
constexpr float kSweepCells = 16.f;
constexpr float kReachCells = 4.f;
constexpr float kGrowth = 4.f;
constexpr int kSweeps = 4;
constexpr size_t kFixedSmem = kStages * kTile * sizeof(float4) +
                              kStages * sizeof(unsigned long long) + kChunk * sizeof(int) +
                              32 * sizeof(float4);

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float pinf() { return __int_as_float(0x7f800000); }

// The pair test's squared distance, each operation rounded on its own.
__device__ __forceinline__ float pair_d2(float qx, float qy, float qz, const float4& p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The gap between [qlo, qhi] and [plo, phi] along one axis: at most
// |fl(q - p)| for every q and p in them (rounding is monotone); fmaxf takes
// the number over a NaN, so an undefined difference leaves a gap of 0.
__device__ __forceinline__ float box_gap(float qlo, float qhi, float plo, float phi) {
  return fmaxf(fmaxf(__fsub_rn(plo, qhi), __fsub_rn(qlo, phi)), 0.f);
}

// The box distance: the pair test's sum of squares over the three gaps.
__device__ __forceinline__ float box_d2(const float lo[3], const float hi[3], const float4& plo,
                                        const float4& phi) {
  const float gx = box_gap(lo[0], hi[0], plo.x, phi.x);
  const float gy = box_gap(lo[1], hi[1], plo.y, phi.y);
  const float gz = box_gap(lo[2], hi[2], plo.z, phi.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
}

// The low 10 bits of c moved to every third bit (cells use kCellBits).
__device__ __forceinline__ unsigned spread3(unsigned c) {
  unsigned x = c & 0x3ffu;
  x = (x | (x << 16)) & 0x030000ffu;
  x = (x | (x << 8)) & 0x0300f00fu;
  x = (x | (x << 4)) & 0x030c30c3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1) : "memory");
}

// Lane 0 of the warp: expect `bytes` on `bar` and copy them from global
// `src` into shared `dst` (both 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  // The warp's earlier reads of dst are ordered before the copy's writes.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// The cell side over the box [lo, hi] (box[0..2], box[3..5]): max(side_r,
// extent / 128), extent the box's largest side.
__device__ __forceinline__ float grid_side(const float* box, float side_r) {
  const float ext = fmaxf(fmaxf(__fsub_rn(box[3], box[0]), __fsub_rn(box[4], box[1])),
                          __fsub_rn(box[5], box[2]));
  return fmaxf(side_r, __fdiv_rn(ext, static_cast<float>(1 << kCellBits)));
}

// Row i's cell key over the box [lo, hi] (box[0..2], box[3..5]): the
// Morton key of floor((x - lo) / side) per axis, clamped to [0, 127], with
// side = max(side_r, extent / 128) (extent: the box's largest side);
// kInvalidKey for a row that valid (or null: none) marks invalid and, for
// the nearest search (NEAREST), for a row with a NaN coordinate.
template <bool NEAREST = false>
__device__ __forceinline__ unsigned cell_key(const float* __restrict__ pts,
                                             const unsigned char* __restrict__ valid, int i,
                                             const float* box, float side_r) {
  if (valid != nullptr && !valid[i]) return kInvalidKey;
  if constexpr (NEAREST) {
    if (isnan(pts[3ll * i]) || isnan(pts[3ll * i + 1]) || isnan(pts[3ll * i + 2]))
      return kInvalidKey;
  }
  const float side = grid_side(box, side_r);
  unsigned key = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float f = floorf(__fdiv_rn(__fsub_rn(pts[3ll * i + a], box[a]), side));
    key |= spread3(static_cast<unsigned>(fminf(fmaxf(f, 0.f), kMaxCell))) << a;
  }
  return key;
}

// Each block: part[6 * blockIdx.x + 0..2] the least and + 3..5 the largest
// coordinate over its rows (a grid-stride share) that valid (or null: every
// row) marks, NaN left out (inf and -inf when there is none).
__global__ void __launch_bounds__(256) knn_bounds_kernel(const float* __restrict__ pts,
                                                         const unsigned char* __restrict__ valid,
                                                         int n, float* __restrict__ part) {
  __shared__ float warps[8][6];
  float b[6] = {pinf(), pinf(), pinf(), -pinf(), -pinf(), -pinf()};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    if (valid != nullptr && !valid[i]) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float x = pts[3ll * i + a];
      b[a] = fminf(b[a], x);
      b[a + 3] = fmaxf(b[a + 3], x);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      b[a] = fminf(b[a], __shfl_xor_sync(kFull, b[a], off));
      b[a + 3] = fmaxf(b[a + 3], __shfl_xor_sync(kFull, b[a + 3], off));
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) warps[threadIdx.x >> 5][a] = b[a];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int a = threadIdx.x;
    float v = warps[0][a];
    for (int w = 1; w < 8; ++w) v = a < 3 ? fminf(v, warps[w][a]) : fmaxf(v, warps[w][a]);
    part[6 * blockIdx.x + a] = v;
  }
}

// The box of the nb blocks' parts (knn_bounds_kernel) into box[6], by the
// first six threads (the caller syncs).
__device__ __forceinline__ void parts_box(const float* __restrict__ part, int nb, float* box) {
  if (threadIdx.x < 6) {
    const int a = threadIdx.x;
    float v = a < 3 ? pinf() : -pinf();
    for (int j = 0; j < nb; ++j) v = a < 3 ? fminf(v, part[6 * j + a]) : fmaxf(v, part[6 * j + a]);
    box[a] = v;
  }
}

// Cell keys (cell_key) over the box of the nb blocks' parts; vals[i] = i.
__global__ void __launch_bounds__(256) knn_keys_kernel(const float* __restrict__ pts,
                                                       const unsigned char* __restrict__ valid,
                                                       int n, const float* __restrict__ part,
                                                       int nb, float side_r,
                                                       unsigned* __restrict__ keys,
                                                       int* __restrict__ vals) {
  __shared__ float box[6];
  parts_box(part, nb, box);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  vals[i] = i;
  keys[i] = cell_key(pts, valid, i, box, side_r);
}

// The cell order of n <= kOrderMax rows in one block and one launch (the
// bounds, the keys and a stable block radix sort): the same order as
// knn_bounds_kernel, knn_keys_kernel and the device radix sort give, at
// the cost of one launch on the host where CUB's device sort issues
// several and queries the device first. Rows are held blocked (thread t
// the rows t * kOrderItems + j), rows past n keyed kInvalidKey: the sort
// is stable, so they follow every row.
using OrderSort = cub::BlockRadixSort<unsigned, kOrderThreads, kOrderItems, int,
                                      kOrderRadixBits>;

__global__ void __launch_bounds__(kOrderThreads) knn_order_block_kernel(
    const float* __restrict__ pts, const unsigned char* __restrict__ valid, int n,
    float side_r, int* __restrict__ order) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float warps[kOrderThreads / 32][6];
  __shared__ float box[6];
  float b[6] = {pinf(), pinf(), pinf(), -pinf(), -pinf(), -pinf()};
  for (int i = threadIdx.x; i < n; i += kOrderThreads) {
    if (valid != nullptr && !valid[i]) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float x = pts[3ll * i + a];
      b[a] = fminf(b[a], x);
      b[a + 3] = fmaxf(b[a + 3], x);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      b[a] = fminf(b[a], __shfl_xor_sync(kFull, b[a], off));
      b[a + 3] = fmaxf(b[a + 3], __shfl_xor_sync(kFull, b[a + 3], off));
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) warps[threadIdx.x >> 5][a] = b[a];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int a = threadIdx.x;
    float v = warps[0][a];
    for (int w = 1; w < kOrderThreads / 32; ++w)
      v = a < 3 ? fminf(v, warps[w][a]) : fmaxf(v, warps[w][a]);
    box[a] = v;
  }
  __syncthreads();
  unsigned keys[kOrderItems];
  int vals[kOrderItems];
#pragma unroll
  for (int j = 0; j < kOrderItems; ++j) {
    const int i = threadIdx.x * kOrderItems + j;
    vals[j] = i;
    keys[j] = i < n ? cell_key(pts, valid, i, box, side_r) : kInvalidKey;
  }
  OrderSort(*reinterpret_cast<OrderSort::TempStorage*>(smem)).Sort(keys, vals, 0, kKeyBits);
#pragma unroll
  for (int j = 0; j < kOrderItems; ++j) {
    const int at = threadIdx.x * kOrderItems + j;
    if (at < n) order[at] = vals[j];
  }
}

// The nearest search orders points and queries with one sort: row i of
// the joined rows is point i (i < n) or query i - n, keyed on the points'
// box, a query with kQueryFlag set. A stable sort then puts the points
// first, in key order, then the queries, in key order: the orders that
// two sorts would give, in one.
constexpr unsigned kQueryFlag = 1u << kKeyBits;
constexpr int kJoinedBits = kKeyBits + 1;

__device__ __forceinline__ unsigned joined_key(const float* __restrict__ pts,
                                               const unsigned char* __restrict__ p_valid, int n,
                                               const float* __restrict__ q_pts,
                                               const unsigned char* __restrict__ q_valid, int i,
                                               const float* box) {
  return i < n ? cell_key<true>(pts, p_valid, i, box, 0.f)
               : kQueryFlag | cell_key<true>(q_pts, q_valid, i - n, box, 0.f);
}

// The joined keys of the n + nq rows and their values: the row's index on
// its own side; block 0 writes the grid's cell side to *side.
__global__ void __launch_bounds__(256) knn_nearest_keys_kernel(
    const float* __restrict__ pts, const unsigned char* __restrict__ p_valid, int n,
    const float* __restrict__ q_pts, const unsigned char* __restrict__ q_valid, int nq,
    const float* __restrict__ part, int nb, unsigned* __restrict__ keys,
    int* __restrict__ vals, float* __restrict__ side) {
  __shared__ float box[6];
  parts_box(part, nb, box);
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) *side = grid_side(box, 0.f);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n + nq) return;
  vals[i] = i < n ? i : i - n;
  keys[i] = joined_key(pts, p_valid, n, q_pts, q_valid, i, box);
}

// The joined order of n + nq <= kOrderMax rows in one block and one launch
// (as knn_order_block_kernel): order[0, n) the points', order[n, n + nq)
// the queries', the sorted keys and the cell side.
__global__ void __launch_bounds__(kOrderThreads) knn_nearest_order_block_kernel(
    const float* __restrict__ pts, const unsigned char* __restrict__ p_valid, int n,
    const float* __restrict__ q_pts, const unsigned char* __restrict__ q_valid, int nq,
    const float* __restrict__ part, int nb, int* __restrict__ order,
    unsigned* __restrict__ keys_out, float* __restrict__ side) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float box[6];
  parts_box(part, nb, box);
  __syncthreads();
  if (threadIdx.x == 0) *side = grid_side(box, 0.f);
  unsigned keys[kOrderItems];
  int vals[kOrderItems];
#pragma unroll
  for (int j = 0; j < kOrderItems; ++j) {
    const int i = threadIdx.x * kOrderItems + j;
    vals[j] = i < n ? i : i - n;
    keys[j] = i < n + nq ? joined_key(pts, p_valid, n, q_pts, q_valid, i, box)
                         : (1u << kJoinedBits) - 1;
  }
  OrderSort(*reinterpret_cast<OrderSort::TempStorage*>(smem)).Sort(keys, vals, 0, kJoinedBits);
#pragma unroll
  for (int j = 0; j < kOrderItems; ++j) {
    const int at = threadIdx.x * kOrderItems + j;
    if (at < n + nq) {
      order[at] = vals[j];
      keys_out[at] = keys[j];
    }
  }
}

// One block of kTile threads (a warp per chunk) per tile: the points in
// `order` (or index order) as float4 (x, y, z, index bits), NaN coordinates
// for an invalid point or the tail, and the boxes over the valid points of
// each chunk (cboxes) and of the tile (tboxes): (inf, -inf) when there is
// none, NaN coordinates left out.
__global__ void __launch_bounds__(kTile) knn_pack_kernel(
    const float* __restrict__ pts, const unsigned char* __restrict__ valid, int n,
    const int* __restrict__ order, float4* __restrict__ pts4,
    float4* __restrict__ tboxes, float4* __restrict__ cboxes) {
  __shared__ float part[kChunks][6];
  const int i = blockIdx.x * kTile + threadIdx.x;
  float4 v = make_float4(qnan(), qnan(), qnan(), __int_as_float(-1));
  float b[6] = {pinf(), pinf(), pinf(), -pinf(), -pinf(), -pinf()};
  if (i < n) {
    const long long j = order != nullptr ? order[i] : i;
    v.w = __int_as_float(static_cast<int>(j));
    if (valid[j]) {
      v.x = pts[3 * j];
      v.y = pts[3 * j + 1];
      v.z = pts[3 * j + 2];
      b[0] = fminf(b[0], v.x);
      b[1] = fminf(b[1], v.y);
      b[2] = fminf(b[2], v.z);
      b[3] = fmaxf(b[3], v.x);
      b[4] = fmaxf(b[4], v.y);
      b[5] = fmaxf(b[5], v.z);
    }
  }
  pts4[i] = v;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      b[a] = fminf(b[a], __shfl_xor_sync(kFull, b[a], off));
      b[a + 3] = fmaxf(b[a + 3], __shfl_xor_sync(kFull, b[a + 3], off));
    }
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    const size_t c = static_cast<size_t>(blockIdx.x) * kChunks + w;
    cboxes[2 * c] = make_float4(b[0], b[1], b[2], 0.f);
    cboxes[2 * c + 1] = make_float4(b[3], b[4], b[5], 0.f);
#pragma unroll
    for (int a = 0; a < 6; ++a) part[w][a] = b[a];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int u = 1; u < kChunks; ++u) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        b[a] = fminf(b[a], part[u][a]);
        b[a + 3] = fmaxf(b[a + 3], part[u][a + 3]);
      }
    }
    tboxes[2 * blockIdx.x] = make_float4(b[0], b[1], b[2], 0.f);
    tboxes[2 * blockIdx.x + 1] = make_float4(b[3], b[4], b[5], 0.f);
  }
}

// Element i of a query's list (stride kListStride) moved down into the
// sorted elements before it.
__device__ __forceinline__ void sink(unsigned long long* list, int i) {
  const unsigned long long key = list[i * kListStride];
  while (i > 0) {
    const unsigned long long prev = list[(i - 1) * kListStride];
    if (prev < key) break;
    list[i * kListStride] = prev;
    --i;
  }
  list[i * kListStride] = key;
}

// One candidate key into a query's list: below k keys it is appended; at
// k the list is sorted (insertion sort); then a key below the last takes
// the last's place and sinks to its rank. thr and lim follow the full
// list's last key.
__device__ __forceinline__ void add_key(unsigned long long* list, int k, int& m,
                                        unsigned long long& thr, float& lim,
                                        unsigned long long key) {
  if (key >= thr) return;
  if (m < k) {
    list[m * kListStride] = key;
    if (++m < k) return;
    for (int i = 1; i < k; ++i) sink(list, i);
  } else {
    list[(k - 1) * kListStride] = key;
    sink(list, k - 1);
  }
  thr = list[(k - 1) * kListStride];
  lim = __uint_as_float(static_cast<unsigned>(thr >> 32));
}

// The nearest search's seed (NEAREST): the tile where `key` falls among
// the tiles' first keys (p_keys, the points' sorted keys, at every kTile-th
// row): the last tile whose first key is at most key, or the first tile.
__device__ __forceinline__ int seed_tile(const unsigned* __restrict__ p_keys, int n_tiles,
                                         unsigned key) {
  int lo = 0, hi = n_tiles;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (p_keys[static_cast<size_t>(mid) * kTile] <= key)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// Whether tile t is among the n ascending seed tiles.
__device__ __forceinline__ bool is_seed(const int* seeds, int n, int t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (seeds[mid] < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && seeds[lo] == t;
}

// Whether a box (lo, hi) holds a point: fminf / fmaxf leave NaN
// coordinates out, so a chunk whose points are invalid or have a NaN
// coordinate has an empty box along some axis, and none of its points can
// be a neighbour.
__device__ __forceinline__ bool has_points(const float4& lo, const float4& hi) {
  return lo.x <= hi.x && lo.y <= hi.y && lo.z <= hi.z;
}

// NEAREST (k = 1, r2 = inf): the nearest search of design step 4. The
// queries come in their order with their sorted keys (q_keys); p_keys are
// the points' sorted keys; tally (or null) takes the tiles each warp read;
// *side is the grid's cell side; done holds done_words words of scratch a
// warp, for a sweeping warp's bitmap of the chunks it read.
template <bool COUNTS, bool NEAREST = false>
__global__ void __launch_bounds__(32) knn_tiles_kernel(
    const float* __restrict__ q_pts,            // (Q, 3)
    const unsigned char* __restrict__ q_valid,  // (Q,) bool, or null: every query active
    const int* __restrict__ q_order,            // (Q,) the queries' order, or null
    int nq,
    const float4* __restrict__ pts4,            // (n_tiles * kTile,) packed points
    const float4* __restrict__ tboxes,          // (n_tiles, 2) tile boxes
    const float4* __restrict__ cboxes,          // (n_tiles * kChunks, 2) chunk boxes
    int n_tiles, float r2, int cull, int k,
    int* __restrict__ out_idx,                  // (Q, k), or (Q,) counts
    float* __restrict__ out_d2,                 // (Q, k)
    const unsigned* __restrict__ q_keys = nullptr,  // NEAREST: (Q,) in the queries' order
    const unsigned* __restrict__ p_keys = nullptr,  // NEAREST: (N,) in the points' order
    int* __restrict__ tally = nullptr,              // NEAREST: (blocks,), or null
    const float* __restrict__ side = nullptr,       // NEAREST: the cell side
    unsigned* __restrict__ done = nullptr,          // NEAREST: (blocks, done_words)
    int done_words = 0) {
  extern __shared__ __align__(128) unsigned char smem[];
  float4* buf = reinterpret_cast<float4*>(smem);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(buf + kStages * kTile);
  int* kept = reinterpret_cast<int*>(bar + kStages);
  float4* qbuf = reinterpret_cast<float4*>(kept + kChunk);
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(qbuf + 32);
  const int lane = threadIdx.x;

  // The lane's query: its original row (or -1 past the last), and its
  // coordinates if it is active (NaN otherwise: it finds nothing). The
  // nearest search's active queries are those with a valid key, a prefix
  // of the warp.
  const long long slot = static_cast<long long>(blockIdx.x) * 32 + lane;
  int row = -1;
  bool act = false;
  unsigned qkey = kInvalidKey;
  float qx = qnan(), qy = qnan(), qz = qnan();
  if (slot < nq) {
    const long long qi = q_order != nullptr ? q_order[slot] : slot;
    row = static_cast<int>(qi);
    if constexpr (NEAREST) {
      qkey = q_keys[slot] & kInvalidKey;  // without kQueryFlag
      act = qkey != kInvalidKey;
    } else {
      act = q_valid == nullptr || q_valid[qi];
    }
    if (act) {
      qx = q_pts[3 * qi];
      qy = q_pts[3 * qi + 1];
      qz = q_pts[3 * qi + 2];
    }
  }
  // The warp's box over its active queries (NaN coordinates left out).
  float lo[3] = {act ? qx : pinf(), act ? qy : pinf(), act ? qz : pinf()};
  float hi[3] = {act ? qx : -pinf(), act ? qy : -pinf(), act ? qz : -pinf()};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], off));
    }
  }
  // The queries for the chunk test; an inactive one at +inf, where every
  // box is infinitely far. The nearest search keeps each query's limit in
  // w (set at each round).
  qbuf[lane] = act ? make_float4(qx, qy, qz, 0.f) : make_float4(pinf(), pinf(), pinf(), 0.f);

  int count = 0;
  int m = 0;                       // keys held
  unsigned long long thr = ~0ull;  // the full list's last key (~0 until it is full)
  float lim = r2;                  // r2, then the full list's last d2
  unsigned long long best = ~0ull;  // NEAREST: the lane's best key (~0: none yet)
  unsigned long long* list = lists + lane;  // element e at list[e * kListStride]
  if (lane == 0) {
    for (int b = 0; b < kStages; ++b) mbar_init(&bar[b]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  unsigned it = 0;  // tiles staged so far: buffer it % kStages, parity (it / kStages) & 1
  // The kept tiles kept[0, nk) (tile | chunk mask << 24) through the ring
  // of kStages buffers: the first kStages go in flight now, and each buffer
  // is refilled once the warp is done with it; every lane tests its query
  // against each point of the masked chunks.
  auto read_tiles = [&](int nk) {
    if (lane == 0) {
      for (int j = 0; j < min(kStages, nk); ++j) {
        const unsigned g = it + j;
        bulk_load(buf + (g % kStages) * kTile,
                  pts4 + static_cast<size_t>(kept[j] & 0xffffff) * kTile,
                  kTile * sizeof(float4), &bar[g % kStages]);
      }
    }
    for (int i = 0; i < nk; ++i, ++it) {
      const int b = it % kStages;
      const unsigned mask = static_cast<unsigned>(kept[i]) >> 24;
      mbar_wait(&bar[b], (it / kStages) & 1);
      for (int c = 0; c < kChunks; ++c) {
        if (!((mask >> c) & 1u)) continue;
        const float4* chunk = buf + b * kTile + 32 * c;
        for (int j0 = 0; j0 < 32; j0 += kBatch) {
          unsigned hits = 0;  // bit u: point j0 + u is a candidate
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const float d2 = pair_d2(qx, qy, qz, chunk[j0 + u]);
            if constexpr (COUNTS) {
              count += d2 <= r2 ? 1 : 0;
            } else {
              hits |= (d2 <= lim ? 1u : 0u) << u;
            }
          }
          if constexpr (!COUNTS) {
            while (hits) {
              const int u = __ffs(hits) - 1;
              hits &= hits - 1;
              const float4 p = chunk[j0 + u];
              const float d2 = pair_d2(qx, qy, qz, p);
              const unsigned long long key =
                  (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
                  static_cast<unsigned long long>(__float_as_uint(p.w));
              if constexpr (NEAREST) {
                if (key < best) {
                  best = key;
                  lim = d2;
                }
              } else {
                add_key(list, k, m, thr, lim, key);
              }
            }
          }
        }
      }
      __syncwarp();  // every lane is done with buffer b
      if (lane == 0 && i + kStages < nk) {
        bulk_load(buf + b * kTile,
                  pts4 + static_cast<size_t>(kept[i + kStages] & 0xffffff) * kTile,
                  kTile * sizeof(float4), &bar[b]);
      }
    }
  };

  // A warp whose box is empty (no active query with numbers for
  // coordinates) has no member in any tile.
  const bool empty = !(lo[0] <= hi[0] && lo[1] <= hi[1] && lo[2] <= hi[2]);
  const int tiles = cull && empty ? 0 : n_tiles;
  // NEAREST: the seed's tiles, ascending (seeds[0, ns)), and the tiles read.
  int* seeds = reinterpret_cast<int*>(lists);
  int ns = 0, staged = 0;
  if constexpr (NEAREST) {
    lim = pinf();
    if (tiles > 0) {
      // Lane l's tiles [b, e] are those of [t - 1, t + 1] past the lanes
      // before it: their tiles ascend with their keys, so the tiles before
      // lane l's end at lane l - 1's last.
      const int t = act ? seed_tile(p_keys, n_tiles, qkey) : 0;
      const int e = min(t + 1, n_tiles - 1);
      const int before = __shfl_up_sync(kFull, e, 1);
      const int b = max(t - 1, lane > 0 ? before + 1 : 0);
      const int c = act ? max(e - b + 1, 0) : 0;
      int at = c;  // inclusive sum over the lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, at, off);
        if (lane >= off) at += v;
      }
      ns = __shfl_sync(kFull, at, 31);
      for (int j = 0; j < c; ++j) {
        seeds[at - c + j] = b + j;
        kept[at - c + j] = (b + j) | static_cast<int>(0xfu << 24);
      }
      __syncwarp();
      read_tiles(ns);
      staged = ns;
    }
  }
  // NEAREST: whether the warp walks in sweeps, and then its bitmap of the
  // chunks it has read (4 bits a tile; see below).
  [[maybe_unused]] bool sweeps = false;
  [[maybe_unused]] unsigned* read =
      done != nullptr ? done + static_cast<size_t>(blockIdx.x) * done_words : nullptr;
  // The walk: rounds of kChunk tiles, each query's limit capped at
  // cap_reach (NEAREST; inf: no cap); a sweeping warp skips the chunks it
  // read in an earlier sweep and marks those it reads.
  auto walk = [&](float cap_reach) {
    for (int c0 = 0; c0 < tiles; c0 += kChunk) {
      const int cn = min(kChunk, tiles - c0);
      // The bound of this round: r2, or (NEAREST) the largest cap of the
      // warp's active queries, and each one's own cap in qbuf[].w.
      float reach = r2;
      if constexpr (NEAREST) {
        const float cap = fminf(lim, cap_reach);
        reach = act ? cap : -pinf();
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          reach = fmaxf(reach, __shfl_xor_sync(kFull, reach, off));
        qbuf[lane].w = act ? cap : -pinf();
        __syncwarp();
      }
      // Step 1: the warp's box against the tile boxes, 4 tiles a lane per
      // pass (their loads in flight together); the tiles that pass, in order.
      int nc = 0;
      for (int t0 = 0; t0 < cn; t0 += 4 * 32) {
        float4 blo[4], bhi[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + 32 * u + lane;
          if (cull && t < cn) {
            blo[u] = tboxes[2 * (c0 + t)];
            bhi[u] = tboxes[2 * (c0 + t) + 1];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + 32 * u + lane;
          const bool keep = t < cn && (!cull || box_d2(lo, hi, blo[u], bhi[u]) <= reach);
          const unsigned ballot = __ballot_sync(kFull, keep);
          if (keep) kept[nc + __popc(ballot & ((1u << lane) - 1u))] = c0 + t;
          nc += __popc(ballot);
        }
      }
      __syncwarp();
      // Step 2: each chunk of those tiles against every active query of the
      // warp (lane i takes chunk i: 8 tiles a pass); a tile stays with the
      // mask of its chunks that some query may reach. The list is rewritten
      // in place: a pass writes entries below those it has read.
      int nk = 0;
      for (int i0 = 0; i0 < kChunks * nc; i0 += 32) {
        const int i = i0 + lane;
        const int j = i0 / kChunks + lane;  // lanes < 8: their candidate tile
        const int tj = lane < 32 / kChunks && j < nc ? kept[j] : 0;
        bool need = i < kChunks * nc && !cull;
        if (cull && i < kChunks * nc) {
          const size_t cb = static_cast<size_t>(kept[i / kChunks]) * kChunks + i % kChunks;
          const float4 clo = cboxes[2 * cb];
          const float4 chi = cboxes[2 * cb + 1];
          // A chunk a sweeping warp has read (every query tested on it) is
          // not read again.
          const bool fresh =
              !NEAREST || !sweeps ||
              !((__ldcg(read + (cb >> 5)) >> (cb & 31u)) & 1u);  // bit cb of the bitmap
          // The warp's box first: a chunk far from it is far from every query.
          if ((!NEAREST || (fresh && has_points(clo, chi))) &&
              box_d2(lo, hi, clo, chi) <= reach) {
            for (int s = 0; s < 32 && !need; s += 4) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float4 q = qbuf[s + u];
                const float qa[3] = {q.x, q.y, q.z};
                const float d = box_d2(qa, qa, clo, chi);
                need |= d <= (NEAREST ? q.w : r2);
              }
            }
          }
        }
        const unsigned bits = __ballot_sync(kFull, need);
        const unsigned mask = lane < 32 / kChunks ? (bits >> (kChunks * lane)) & 0xfu : 0u;
        const bool has = lane < 32 / kChunks && j < nc && mask != 0 &&
                         (!NEAREST || !is_seed(seeds, ns, tj));
        const unsigned hb = __ballot_sync(kFull, has);
        __syncwarp();  // every lane has read this pass's entries of kept[]
        if (has) kept[nk + __popc(hb & ((1u << lane) - 1u))] = tj | static_cast<int>(mask << 24);
        if (NEAREST && sweeps && has) atomicOr(read + (tj >> 3), mask << ((tj & 7) << 2));
        nk += __popc(hb);
        __syncwarp();
      }
      if (nk == 0) continue;
      read_tiles(nk);
      staged += nk;
    }
  };
  if constexpr (NEAREST) {
    // The sweeps (design step 4). A warp whose limits all lie within
    // kSweepCells cells walks once, at its limits. Else sweep w caps each
    // query's limit at the squared reach of kReachCells cells times
    // kGrowth^w, and a sweep that caps no limit, or sweep kSweeps - 1,
    // takes the limits themselves and is the last; the warp's bitmap keeps
    // any chunk from being read twice.
    auto most = [&]() {
      float m = act ? lim : -pinf();
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
      return m;
    };
    const float s2 = __fmul_rn(*side, *side);
    float cap_reach = __fmul_rn(s2, kReachCells * kReachCells);
    sweeps = tiles > 0 && __fmul_rn(s2, kSweepCells * kSweepCells) < most();
    if (sweeps) {
      for (int i = lane; i < done_words; i += 32) read[i] = 0u;
      __syncwarp();
    }
    // One call of the walk, so that it is compiled once.
    bool last = !sweeps;
    for (int sweep = 0;; ++sweep) {
      walk(last ? pinf() : cap_reach);
      if (last) break;
      cap_reach = __fmul_rn(cap_reach, kGrowth);
      last = sweep + 1 == kSweeps - 1 || cap_reach >= most();
    }
  } else {
    walk(pinf());
  }

  if constexpr (COUNTS) {
    if (row >= 0) out_idx[row] = count;
  } else if constexpr (NEAREST) {
    if (row >= 0) {
      out_idx[row] = best == ~0ull ? -1 : static_cast<int>(static_cast<unsigned>(best));
      out_d2[row] = best == ~0ull ? pinf() : __uint_as_float(static_cast<unsigned>(best >> 32));
    }
    if (tally != nullptr && lane == 0) tally[blockIdx.x] = staged;
  } else {
    // A list that did not fill is ordered now: a short one (up to
    // kSortByLane keys) by its lane, an insertion sort whose dependent
    // steps grow as the square of its length; a longer one while it is
    // written out, each key at its rank among the row's, the warp's lanes
    // reading the row's keys as broadcasts.
    if (m < k && m <= kSortByLane)
      for (int i = 1; i < m; ++i) sink(list, i);
    __syncwarp();
    for (int o = 0; o < 32; ++o) {
      const int r = __shfl_sync(kFull, row, o);
      const int mo = __shfl_sync(kFull, m, o);
      if (r < 0) continue;
      const unsigned long long* row_list = lists + o;
      const bool ranked = mo < k && mo > kSortByLane;
      int* oi = out_idx + static_cast<size_t>(r) * k;
      float* od = out_d2 + static_cast<size_t>(r) * k;
      for (int e = lane; e < k; e += 32) {
        if (e >= mo) {
          oi[e] = -1;
          od[e] = pinf();
          continue;
        }
        const unsigned long long key = row_list[e * kListStride];
        int at = e;
        if (ranked) {
          at = 0;
          for (int j = 0; j < mo; ++j) at += row_list[j * kListStride] < key ? 1 : 0;
        }
        oi[at] = static_cast<int>(static_cast<unsigned>(key & 0xffffffffull));
        od[at] = __uint_as_float(static_cast<unsigned>(key >> 32));
      }
    }
  }
}

size_t tiles_smem(int k) {
  return kFixedSmem + static_cast<size_t>(kListStride) * k * sizeof(unsigned long long);
}

// The opt-in shared memory per block of the current card (cached per
// device: the launcher asks on every call).
int max_smem(int* out) {
  thread_local std::unordered_map<int, int> cache;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto hit = cache.find(device);
  if (hit != cache.end()) {
    *out = hit->second;
    return 0;
  }
  err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) cache.emplace(device, *out);
  return static_cast<int>(err);
}

int bounds_blocks(int n) { return n <= 0 ? 1 : std::min((n + 1023) / 1024, 64); }

size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

// The radix sort's temporary storage for n keys of `bits` bits (cached per
// device, n and bits: CUB's size query does host work the launcher would
// repeat every call).
size_t sort_temp(int n, int bits = kKeyBits) {
  thread_local std::unordered_map<long long, size_t> cache;
  int device = 0;
  cudaGetDevice(&device);
  const long long key = (static_cast<long long>(device) << 40) |
                        (static_cast<long long>(bits) << 32) | static_cast<unsigned>(n);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  size_t temp = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, temp, static_cast<const unsigned*>(nullptr),
                                  static_cast<unsigned*>(nullptr),
                                  static_cast<const int*>(nullptr), static_cast<int*>(nullptr),
                                  n, 0, bits);
  cache.emplace(key, temp);
  return temp;
}

// Scratch of one cell order of n rows: the bounds' parts, keys in and out,
// index values in, and the radix sort's temporary storage.
size_t order_scratch(int n) {
  if (n <= kOrderMax) return 0;  // knn_order_block_kernel needs none
  return align256(6 * sizeof(float) * bounds_blocks(n)) +
         3 * align256(static_cast<size_t>(n) * sizeof(int)) + align256(sort_temp(n));
}

// order (n,) int32: the rows of pts by cell key, those valid (or null:
// every row) marks first, equal keys in index order (a stable radix sort).
cudaError_t cell_order(const float* pts, const unsigned char* valid, int n, float side_r,
                       unsigned char* scratch, int* order, cudaStream_t st) {
  if (n == 0) return cudaGetLastError();
  if (n <= kOrderMax) {
    // The sort's shared memory passes the default 48 KB: opt in once per
    // device.
    constexpr int smem = static_cast<int>(sizeof(OrderSort::TempStorage));
    thread_local std::unordered_map<int, bool> opted;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && !opted[device]) {
      err = cudaFuncSetAttribute(knn_order_block_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      opted[device] = err == cudaSuccess;
    }
    if (err != cudaSuccess) return err;
    knn_order_block_kernel<<<1, kOrderThreads, smem, st>>>(pts, valid, n, side_r, order);
    return cudaGetLastError();
  }
  const int nb = bounds_blocks(n);
  float* part = reinterpret_cast<float*>(scratch);
  scratch += align256(6 * sizeof(float) * nb);
  unsigned* keys_in = reinterpret_cast<unsigned*>(scratch);
  scratch += align256(static_cast<size_t>(n) * sizeof(int));
  unsigned* keys_out = reinterpret_cast<unsigned*>(scratch);
  scratch += align256(static_cast<size_t>(n) * sizeof(int));
  int* vals = reinterpret_cast<int*>(scratch);
  scratch += align256(static_cast<size_t>(n) * sizeof(int));
  knn_bounds_kernel<<<nb, 256, 0, st>>>(pts, valid, n, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_keys_kernel<<<(n + 255) / 256, 256, 0, st>>>(pts, valid, n, part, nb, side_r, keys_in,
                                                   vals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  size_t temp = sort_temp(n);
  return cub::DeviceRadixSort::SortPairs(scratch, temp, keys_in, keys_out, vals, order, n, 0,
                                         kKeyBits, st);
}

// Scratch of nearest_order over n joined rows: keys in, values in, and the
// radix sort's temporary storage.
size_t nearest_order_scratch(int n) {
  if (n <= kOrderMax) return 0;
  return 2 * align256(static_cast<size_t>(n) * sizeof(int)) +
         align256(sort_temp(n, kJoinedBits));
}

// The nearest search's order: the valid points' box (part, nb parts of
// knn_bounds_kernel), then order (n + nq,) and the sorted joined keys
// (n + nq,), points first; rows with kInvalidKey (invalid, or a NaN
// coordinate) last on their side, equal keys in index order.
cudaError_t nearest_order(const float* pts, const unsigned char* p_valid, int n,
                          const float* q_pts, const unsigned char* q_valid, int nq,
                          const float* part, int nb, unsigned char* scratch, int* order,
                          unsigned* keys, float* side, cudaStream_t st) {
  const int rows = n + nq;
  if (rows <= kOrderMax) {
    constexpr int smem = static_cast<int>(sizeof(OrderSort::TempStorage));
    thread_local std::unordered_map<int, bool> opted;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && !opted[device]) {
      err = cudaFuncSetAttribute(knn_nearest_order_block_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      opted[device] = err == cudaSuccess;
    }
    if (err != cudaSuccess) return err;
    knn_nearest_order_block_kernel<<<1, kOrderThreads, smem, st>>>(pts, p_valid, n, q_pts,
                                                                   q_valid, nq, part, nb, order,
                                                                   keys, side);
    return cudaGetLastError();
  }
  unsigned* keys_in = reinterpret_cast<unsigned*>(scratch);
  scratch += align256(static_cast<size_t>(rows) * sizeof(int));
  int* vals = reinterpret_cast<int*>(scratch);
  scratch += align256(static_cast<size_t>(rows) * sizeof(int));
  knn_nearest_keys_kernel<<<(rows + 255) / 256, 256, 0, st>>>(pts, p_valid, n, q_pts, q_valid,
                                                              nq, part, nb, keys_in, vals, side);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  size_t temp = sort_temp(rows, kJoinedBits);
  return cub::DeviceRadixSort::SortPairs(scratch, temp, keys_in, keys, vals, order, rows, 0,
                                         kJoinedBits, st);
}

template <bool COUNTS, bool NEAREST = false>
cudaError_t launch_tiles(int blocks, size_t smem, cudaStream_t st, const float* qp,
                         const unsigned char* qv, const int* qo, int nq, const float4* p4,
                         const float4* tb, const float4* cb, int n_tiles, float r2, int cull,
                         int k, int* oi, float* od, const unsigned* q_keys = nullptr,
                         const unsigned* p_keys = nullptr, int* tally = nullptr,
                         const float* side = nullptr, unsigned* done = nullptr,
                         int done_words = 0) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_tiles_kernel<COUNTS, NEAREST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  knn_tiles_kernel<COUNTS, NEAREST><<<blocks, 32, smem, st>>>(
      qp, qv, qo, nq, p4, tb, cb, n_tiles, r2, cull, k, oi, od, q_keys, p_keys, tally, side,
      done, done_words);
  return cudaGetLastError();
}

// How dc_knn_brute culls: not at all, by the radius, or by each query's
// nearest distance so far (k = 1, no radius).
enum Cull { kNoCull = 0, kRadius = 1, kNearest = 2 };

// The scratch layout of dc_knn_brute: packed points, tile and chunk boxes,
// and with the radius cull the points' order (and the queries', unless
// shared) and the larger of the two orders' own scratch; the nearest
// search's joined order and sorted keys, the points' bounds and the cell
// side, the sweeping warps' bitmaps and its sort's scratch.
struct Layout {
  size_t pts4, tboxes, cboxes, p_order, q_order, p_keys, q_keys, part, done, order_scratch,
      total;
};

// Words of a sweeping warp's bitmap of read chunks (4 bits a tile).
int done_words(int n_tiles) { return (n_tiles + 7) / 8; }

Layout layout(int nq, int n, int cull, int share) {
  const size_t n_tiles = (static_cast<size_t>(n) + kTile - 1) / kTile;
  Layout l{};
  size_t at = 0;
  l.pts4 = at;
  at += align256(n_tiles * kTile * sizeof(float4));
  l.tboxes = at;
  at += align256(n_tiles * 2 * sizeof(float4));
  l.cboxes = at;
  at += align256(n_tiles * kChunks * 2 * sizeof(float4));
  l.p_order = l.q_order = l.p_keys = l.q_keys = l.part = l.done = l.order_scratch = at;
  if (cull == kRadius) {
    l.p_order = at;
    at += align256(static_cast<size_t>(n) * sizeof(int));
    l.q_order = l.p_order;
    if (!share) {
      l.q_order = at;
      at += align256(static_cast<size_t>(nq) * sizeof(int));
    }
    l.order_scratch = at;
    at += std::max(order_scratch(n), share ? size_t{0} : order_scratch(nq));
  } else if (cull == kNearest) {
    // The joined order and keys: the points' at [0, n), the queries' after.
    const size_t rows = static_cast<size_t>(n) + static_cast<size_t>(nq);
    l.p_order = at;
    l.q_order = at + static_cast<size_t>(n) * sizeof(int);
    at += align256(rows * sizeof(int));
    l.p_keys = at;
    l.q_keys = at + static_cast<size_t>(n) * sizeof(int);
    at += align256(rows * sizeof(int));
    l.part = at;
    at += align256(6 * sizeof(float) * bounds_blocks(n) + sizeof(float));  // + the cell side
    l.done = at;
    at += align256(static_cast<size_t>((nq + 31) / 32) *
                   done_words(static_cast<int>(n_tiles)) * sizeof(unsigned));
    l.order_scratch = at;
    at += nearest_order_scratch(n + nq);
  }
  l.total = at;
  return l;
}

}  // namespace

extern "C" {

// The largest k whose one-warp list (one query a lane) fits the card's
// shared memory per block (into *out); returns a CUDA error code.
int dc_knn_brute_max_k(int* out) {
  int smem = 0;
  const int err = max_smem(&smem);
  if (err != 0) return err;
  const long long room = static_cast<long long>(smem) - static_cast<long long>(kFixedSmem);
  *out = room <= 0 ? 0 : static_cast<int>(room / (kListStride * sizeof(unsigned long long)));
  return 0;
}

// Bytes of scratch dc_knn_order takes for n rows.
long long dc_knn_order_scratch(int n) { return static_cast<long long>(order_scratch(n)); }

// order (N,) int32: the rows of pts (N, 3) float32 by the Morton key of
// their cell (side max(side_r, extent / 128) over the valid rows' box),
// valid (or null: every row) rows first, equal keys in index order;
// scratch of dc_knn_order_scratch(n) bytes. Launches on the caller's stream.
// No path calls it: it lets a test hold the card's order to the host model
// (scripts/knn_cull.py).
int dc_knn_order(const void* pts, const void* valid, int n, float side_r, void* scratch,
                 void* order, void* stream) {
  if (n < 0 || !(side_r > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cell_order(static_cast<const float*>(pts),
                                     static_cast<const unsigned char*>(valid), n, side_r,
                                     static_cast<unsigned char*>(scratch),
                                     static_cast<int*>(order),
                                     static_cast<cudaStream_t>(stream)));
}

// Bytes of scratch dc_knn_brute takes.
long long dc_knn_brute_scratch(int nq, int n, int cull, int share) {
  return static_cast<long long>(layout(nq, n, cull, share).total);
}

// k = 0: counts into out_idx (Q,) int32 for every query (q_valid must be
// null); k > 0: the k nearest within r2 into out_idx (Q, k) int32 and
// out_d2 (Q, k) float32 (q_valid may be null: every query is valid).
// cull 1 (a finite r2): the points and the queries are ordered by cell
// (side_r the cell side, at least sqrt(r2)) and each warp reads only the
// tiles and chunks within r2 of its queries; share != 0: the queries are
// the points, and every row is a query (q_valid null) or the active
// queries are the valid points (q_valid the points' validity), so one
// order serves both. cull 2 (k = 1, r2 = inf, share 0): the nearest search
// of design step 4 (side_r unused); tally, if not null, takes (nq + 31) /
// 32 int32, the tiles each warp of ordered queries read (null otherwise).
// scratch holds dc_knn_brute_scratch(nq, n, cull, share) bytes.
// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for bad arguments or a k that
// does not fit).
int dc_knn_brute(const void* q_pts, const void* q_valid, int nq, const void* pts,
                 const void* p_valid, int n, float r2, float side_r, int cull, int share, int k,
                 void* scratch, void* out_idx, void* out_d2, void* tally, void* stream) {
  const bool nearest = cull == kNearest;
  if (nq < 0 || n < 0 || k < 0 || (k == 0 && q_valid != nullptr) || cull < kNoCull ||
      cull > kNearest || (cull == kRadius && !(side_r > 0.f)) ||
      (nearest && (k != 1 || r2 != std::numeric_limits<float>::infinity() || share)) ||
      (tally != nullptr && !nearest))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = k == 0 ? kFixedSmem : tiles_smem(k);
  int limit = 0;
  const int err = max_smem(&limit);
  if (err != 0) return err;
  if (smem > static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) cull = kNoCull;
  const Layout l = layout(nq, n, cull, share);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const float* qp = static_cast<const float*>(q_pts);
  const float* pp = static_cast<const float*>(pts);
  const unsigned char* qv = static_cast<const unsigned char*>(q_valid);
  const unsigned char* pv = static_cast<const unsigned char*>(p_valid);
  int* p_order = nullptr;
  int* q_order = nullptr;
  unsigned* p_keys = nullptr;
  unsigned* q_keys = nullptr;
  float* side = nullptr;
  cudaError_t e = cudaSuccess;
  if (cull == kNearest) {
    // Both sides keyed on the valid points' box.
    p_order = reinterpret_cast<int*>(base + l.p_order);
    q_order = reinterpret_cast<int*>(base + l.q_order);
    p_keys = reinterpret_cast<unsigned*>(base + l.p_keys);
    q_keys = reinterpret_cast<unsigned*>(base + l.q_keys);
    float* part = reinterpret_cast<float*>(base + l.part);
    const int nb = bounds_blocks(n);
    side = part + 6 * nb;
    knn_bounds_kernel<<<nb, 256, 0, st>>>(pp, pv, n, part);
    e = cudaGetLastError();
    if (e == cudaSuccess)
      e = nearest_order(pp, pv, n, qp, qv, nq, part, nb, base + l.order_scratch, p_order, p_keys,
                        side, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else if (cull == kRadius) {
    p_order = reinterpret_cast<int*>(base + l.p_order);
    q_order = reinterpret_cast<int*>(base + l.q_order);
    // A shared order keys the active queries: every row without q_valid,
    // else the valid points (q_valid).
    e = cell_order(pp, share ? qv : pv, n, side_r, base + l.order_scratch, p_order, st);
    if (e == cudaSuccess && !share)
      e = cell_order(qp, qv, nq, side_r, base + l.order_scratch, q_order, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_tiles = (n + kTile - 1) / kTile;
  float4* p4 = reinterpret_cast<float4*>(base + l.pts4);
  float4* tb = reinterpret_cast<float4*>(base + l.tboxes);
  float4* cb = reinterpret_cast<float4*>(base + l.cboxes);
  if (n_tiles > 0) {
    knn_pack_kernel<<<n_tiles, kTile, 0, st>>>(pp, pv, n, p_order, p4, tb, cb);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int* oi = static_cast<int*>(out_idx);
  float* od = static_cast<float*>(out_d2);
  const int blocks = (nq + 31) / 32;
  if (cull == kNearest)
    e = launch_tiles<false, true>(blocks, kFixedSmem + kSeedMax * sizeof(int), st, qp, nullptr,
                                  q_order, nq, p4, tb, cb, n_tiles, r2, 1, 1, oi, od, q_keys,
                                  p_keys, static_cast<int*>(tally), side,
                                  reinterpret_cast<unsigned*>(base + l.done),
                                  done_words(n_tiles));
  else if (k == 0)
    e = launch_tiles<true>(blocks, smem, st, qp, nullptr, q_order, nq, p4, tb, cb, n_tiles, r2,
                           cull, 0, oi, nullptr);
  else
    e = launch_tiles<false>(blocks, smem, st, qp, qv, q_order, nq, p4, tb, cb, n_tiles, r2, cull,
                            k, oi, od);
  return static_cast<int>(e);
}

}  // extern "C"
