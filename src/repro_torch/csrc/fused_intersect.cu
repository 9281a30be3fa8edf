// Fused gather + AND/ANDNOT + popcount + min-support threshold, and the
// survivor compaction behind it: the level-expansion hot loop of the miner.
//
// Replaces the TPU kernels of src/repro/kernels/fused_intersect/fused_intersect.py:
//   fused_pairs_kernel      <- _kernel, launched by _fused_pairs_call
//                              (fused_intersect_pairs)
//   compact_pairs_kernel    <- fused_intersect_compact_pairs: _kernel plus
//                              the compact_epilogue it appends
//   partial_pairs_kernel    <- _kernel_partial, launched by
//                              fused_intersect_partial_pairs
//
// For each pair q: rows a = frontier[left[q]], b = frontier[right[q]];
//   mode 0: x = a & b     sup = popcount(x)
//   mode 1: x = a & ~b    sup = sup_left[q] - popcount(x)
//   mode 2: x = b & ~a    sup = sup_left[q] - popcount(x)
//   mask = sup >= min_sup
// Words are 32-bit; the caller's int32 tensors hold the same bits and are
// read here as unsigned.
//
// Bound on the H100: bytes.  One pair costs W popcounts but moves 8W bytes
// in (two gathered rows) and 4W bytes out, so the work is memory traffic:
// the (Q, W) output goes to HBM once, and the frontier (P, W) is read from
// HBM once and then, row after row, from the 50 MB L2, since each frontier
// row is gathered by many pairs.
//
// fused_pairs_kernel (K1) and partial_pairs_kernel (K3) are one device
// template, window_pairs, with an epilogue flag: K3 stops at the raw
// popcount of its rows (a rank's word slice in the tidsharded and grid
// backends: the support and the threshold need the count summed over the
// ranks, after the all-reduce); K1 adds the support (sup_left minus the
// count for diffsets) and the threshold.  Both may store the (Q, W)
// intersections (streaming stores) or not.
//
// The miner's pair lists are class-ordered (core/equivalence.py
// segment_pairs): a class's rows are contiguous and its pairs consecutive,
// so 256 consecutive pairs touch one short run of rows (chess level 5: at
// most 201 rows).  A block therefore takes a tile of TP consecutive pairs,
// loads all the tile's indices into shared memory first, and stages the
// window of rows [lo, hi] in shared memory, lo the tile's first left row
// and hi the largest operand row below lo + R (R = 2 TP, at most 256).
// Operand rows inside the window are read from shared memory, rows outside
// it are gathered from the frontier: the (0, 0) pad pairs of the last
// tile, a class wider than R.  So any pair list is right, and a
// class-ordered one reads each row about once per tile instead of twice
// per pair (chess level 5: 75,805 rows staged against 739,232 gathered).
// A tile with fewer operands inside its window than pairs (random pair
// lists) stages nothing.  Where a thread takes a pair alone, such a tile,
// and every tile whose intersections are stored, is counted a warp per
// pair instead, four pairs at a time, so its gathers and its stores
// coalesce.
//
// The window is copied by the TMA engine without a tensor map (a 2-d map
// needs a row stride that is a multiple of 16 bytes, and W = 25, 782, 1,563
// and 3,125 words are not): whole rows are one contiguous byte range of the
// frontier, landing at word (address / 4) % 4 of shared memory, so its
// 16-byte aligned interior is one cp.async.bulk counted on an mbarrier, and
// the 0-3 words before and after it are 4-byte cp.asyncs.  Rows too wide
// for R whole rows in 100 KB (T10I4D100K's 1,563 and 3,125 words) go in
// chunks of C words per row, a bulk copy per row, two 48 KB stages in
// flight: chunk c + 1 is copied while chunk c is counted.  A row's pitch is
// C + 4 words, skewed past a multiple of 32 by the lanes per pair so the
// rows a warp reads at once start in different banks.
//
// Lanes fit the row: rows of at most 128 words take a thread per pair
// (256-pair tiles: no shuffles, and lanes reading one left row broadcast),
// wider rows 16 lanes per pair (16-pair tiles, 256 of them at T10I4D100K's
// Q = 4,096); tiles are halved, down to a warp per pair, while they are
// fewer than the card's SMs.  Each lane sums its share of the words over
// the chunks in a register; the pair's lanes add them with shuffles once.
// Staged rows are read with ld.shared from 32-bit addresses (16 bytes at a
// time where W is a multiple of 4).  The grid is persistent (the SMs x the
// blocks of the plan's shared memory that fit on one, counted at each
// launch), each block walking tiles, and a tile's indices are loaded while
// the tile before it is counted.  The plan (TP, R, C) is a launch argument:
// all zeros takes window_plan below, the rule; a given plan is checked on
// the host (given_plan) and refused with a negative code where the kernel
// cannot run it.  Both are mirrored in Python beside the binding, and the
// caller picks a plan from a table measured on the card
// (kernels/autotune.py); every plan gives the same bits.  Nothing returns
// to the host and no memset runs.
//
// The compacting path is one launch of compact_pairs_kernel (K2): it
// gathers each pair's rows once and writes each output row once.  One
// block per tile of consecutive pairs computes the tile's supports and
// flags (mask & q < n_valid), finds its first output slot with a decoupled
// look-back over the tiles before it (each tile publishes its count, then
// its inclusive prefix), and writes its survivors' intersections to
// consecutive rows from there: from shared memory where the tile's rows fit
// (chess, W = 100: 128 pairs x 400 B; T10I4D100K, W = 3125: 8 x 12.5 KB),
// else recomputed from the frontier.  The same block writes its
// non-survivors' share of the pad rows [S, Q) (pair 0's intersection, the
// reference's rung padding), counted from the end, so no second launch has
// to wait for S.  A second front end takes the mask from the caller instead
// (the word-sharded backends threshold after their all-reduce) and computes
// only the rows it writes.  Rows are read 16 bytes at a time where W is a
// multiple of 4.  The lanes per pair G are a launch argument: 8 (a tile of
// 128 pairs, 4 a group), 16 (64 pairs, 4 a group) or 32 (8 pairs, a warp
// each); 0 keeps the rule, 8 where a row has at most 64 such elements,
// else 32.  The caller picks G from a table measured on the card
// (kernels/autotune.py); every G gives the same bits.  Nothing returns to
// the host and no memset runs: the look-back state is tagged with a
// per-launch epoch and its counters are reset by the kernel.
//
// Row offsets are 64-bit: q * W passes 2^31 at Q ~ 700k for W = 3125.
// left[q] and right[q] must lie in [0, P): the engine checks its pair lists
// on the host before upload.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kWarp = 32;

template <int MODE>
__device__ __forceinline__ unsigned combine(unsigned a, unsigned b) {
  if (MODE == 0) return a & b;
  if (MODE == 1) return a & ~b;
  return b & ~a;
}

// ---------------------------------------------------------------------------
// K2: one pass that intersects, thresholds and compacts (compact_pairs_kernel)
// ---------------------------------------------------------------------------

// A row is read as `units` elements of V words: V = 4 (16-byte loads and
// stores) when W is a multiple of 4 and the frontier and output are 16-byte
// aligned, else V = 1.
template <int V> struct Vec;
template <> struct Vec<1> {
  using T = unsigned;
  static __device__ __forceinline__ T zero() { return 0u; }
  static __device__ __forceinline__ int popc(T x) { return __popc(x); }
  template <int MODE>
  static __device__ __forceinline__ T combine(T a, T b) { return ::combine<MODE>(a, b); }
};
template <> struct Vec<4> {
  using T = uint4;
  static __device__ __forceinline__ T zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ int popc(T x) {
    return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
  }
  template <int MODE>
  static __device__ __forceinline__ T combine(T a, T b) {
    return make_uint4(::combine<MODE>(a.x, b.x), ::combine<MODE>(a.y, b.y),
                      ::combine<MODE>(a.z, b.z), ::combine<MODE>(a.w, b.w));
  }
};

// Look-back state, int64 words kept per (device, stream) by the binding:
// state[0] hands out tiles in launch order, state[1] counts the tiles whose
// look-back is done, state[2 + t] is tile t's status,
//   (epoch << 34) | (flag << 32) | count
// with flag 1 = the tile's own survivor count, 2 = survivors up to and
// including the tile.  A status of another launch's epoch reads as not yet
// published, so the statuses are never cleared; the block that finishes
// the last look-back zeroes state[0] and state[1] for the next launch.
constexpr int kEpochShift = 34;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / kWarp;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// G lanes per pair (a launch argument, rule_lanes below by default): tiles
// of 128, 64 or 8 pairs (4, 4 or 1 per group of lanes).  kMinBlocks* are the
// __launch_bounds__ occupancy of each front end, in blocks of 256 threads
// per SM: for G = 8, 3 (fused) and 4 (given mask), the register caps that
// ran fastest at chess's shape; for G = 16, K2_G16_MIN_BLOCKS_*, 4 and 4,
// the fastest of (2, 2), (3, 4) and (4, 4) at chess level 5 and within 3%
// elsewhere (launch/k2_occupancy.py builds the library with other values
// to time them); none for a warp per pair.  The look-back state has a status per
// tile of the smallest tile, kStateTilePairs pairs, so every G's tiles fit
// it.
#ifndef K2_G16_MIN_BLOCKS_FUSED
#define K2_G16_MIN_BLOCKS_FUSED 4
#endif
#ifndef K2_G16_MIN_BLOCKS_GIVEN
#define K2_G16_MIN_BLOCKS_GIVEN 4
#endif
constexpr int kStateTilePairs = 8;

template <int G> struct Shape {
  static_assert(G == 8 || G == 16 || G == 32, "lanes per pair: 8, 16 or 32");
  static constexpr int kGroups = kCompactThreads / G;
  static constexpr int kPairsPerGroup = G == 32 ? 1 : 4;
  static constexpr int kTilePairs = kGroups * kPairsPerGroup;
  static constexpr int kUnroll = G == 32 ? 8 : 4;  // elements in flight per lane
  static constexpr int kMinBlocksFused = G == 32 ? 1 : G == 16 ? K2_G16_MIN_BLOCKS_FUSED : 3;
  static constexpr int kMinBlocksGiven = G == 32 ? 1 : G == 16 ? K2_G16_MIN_BLOCKS_GIVEN : 4;
  static_assert(kTilePairs >= kStateTilePairs, "a tile smaller than the state's");
};

// Words of look-back state for Q pairs: the two counters and a status per
// tile of kStateTilePairs pairs.
long long state_words(long long Q) { return 2 + (Q + kStateTilePairs - 1) / kStateTilePairs; }

// The lanes per pair of the rule: 8 for rows of at most 64 elements, else 32.
int rule_lanes(int units) { return units <= 64 ? 8 : 32; }

// Shape<G>'s geometry as six ints (compact_shape_of below).
template <int G> void shape_of(int* out) {
  out[0] = G;
  out[1] = Shape<G>::kTilePairs;
  out[2] = Shape<G>::kPairsPerGroup;
  out[3] = Shape<G>::kUnroll;
  out[4] = Shape<G>::kMinBlocksFused;
  out[5] = Shape<G>::kMinBlocksGiven;
}

// Lane lg of a group of G intersects rows a and b (units elements of V
// words) at elements lg, lg + G, ...; stores the result to dst unless it is
// null (to shared memory, or with STREAM to global memory as streaming
// stores that L2 evicts first, so the output does not push the frontier
// out); returns this lane's share of the popcount.
template <int MODE, int V, int G, bool STREAM>
__device__ __forceinline__ int group_row(const typename Vec<V>::T* __restrict__ a,
                                         const typename Vec<V>::T* __restrict__ b,
                                         typename Vec<V>::T* dst, int units, int lg) {
  using T = typename Vec<V>::T;
  constexpr int U = Shape<G>::kUnroll;
  int pop = 0;
  for (int base = lg; base < units; base += G * U) {
    T av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * G;
      av[u] = i < units ? __ldg(a + i) : Vec<V>::zero();
      bv[u] = i < units ? __ldg(b + i) : Vec<V>::zero();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * G;
      if (i < units) {
        const T x = Vec<V>::template combine<MODE>(av[u], bv[u]);
        if (dst != nullptr) {
          if (STREAM) __stcs(dst + i, x); else dst[i] = x;
        }
        pop += Vec<V>::popc(x);
      }
    }
  }
  return pop;
}

// One tile of consecutive pairs per block, taken from state[0]; one launch
// computes, thresholds and compacts.
// 1. Flags.  Fused (FUSED): each group of G lanes intersects its
//    pairs' rows (the pairs' indices loaded first), sums the popcount with
//    shuffles, writes sup and the valid-masked mask; with `stage` the
//    intersections are kept in shared memory.  Given mask: the flag is
//    mask[q] & (q < n_valid), written back to mask.
// 2. The block counts its flags and ranks them (ballots), publishes the
//    count, and warp 0 looks back over the preceding tiles' statuses, 32 at
//    a time, summing counts until it meets an inclusive prefix; then it
//    publishes its own.  Tiles are taken in launch order, so every tile it
//    waits for belongs to a block that is already running.
// 3. The tile writes one output row per pair it holds: its count survivors
//    at rows E .. E + count (E its exclusive prefix), in pair order, copied
//    from shared memory when staged, else recomputed from the frontier; and
//    its n - count others as pad rows, pair 0's intersection, filling
//    [S, Q) from the end: Q - (q0 - E) - (n - count) .. Q - (q0 - E), where
//    q0 - E counts the non-survivors of the tiles before it.  Every row of
//    out is written once, by the pass itself.
// FUSED: the fused front end; else the given-mask one, which computes no
// row before its look-back.  Occupancy: Shape<G>::kMinBlocks*.
template <int MODE, int V, int G, bool FUSED>
__global__ void __launch_bounds__(kCompactThreads,
                                  FUSED ? Shape<G>::kMinBlocksFused : Shape<G>::kMinBlocksGiven)
compact_pairs_kernel(const unsigned* __restrict__ frontier, const int* __restrict__ left,
                     const int* __restrict__ right, const int* __restrict__ sup_left,
                     int* __restrict__ sup, int* __restrict__ mask, int stage,
                     unsigned long long* __restrict__ state, unsigned long long epoch,
                     unsigned* __restrict__ out, int* __restrict__ n_surv, long long Q, int W,
                     long long n_valid, int min_sup) {
  using T = typename Vec<V>::T;
  using Sh = Shape<G>;
  constexpr int TP = Sh::kTilePairs;
  extern __shared__ uint4 stage_raw[];
  T* rows_s = reinterpret_cast<T*>(stage_raw);
  __shared__ int s_flag[TP];
  __shared__ int s_sel[TP];
  __shared__ int s_warp[kCompactWarps];
  __shared__ long long s_tile, s_base;

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int g = tid / G;
  const int lg = tid % G;
  const int units = W / V;
  if (tid == 0) s_tile = static_cast<long long>(atomicAdd(&state[0], 1ull));
  __syncthreads();
  const long long tile = s_tile;
  const long long q0 = tile * TP;
  const long long n_tiles = (Q + TP - 1) / TP;
  const int n = static_cast<int>(Q - q0 < TP ? Q - q0 : TP);   // pairs in this tile
  const T* fv = reinterpret_cast<const T*>(frontier);
  unsigned long long* status = state + 2;
  const unsigned long long tag = epoch << kEpochShift;

  // 1. flags
  if (FUSED) {
    int la[Sh::kPairsPerGroup], ra[Sh::kPairsPerGroup], sl[Sh::kPairsPerGroup];
#pragma unroll
    for (int k = 0; k < Sh::kPairsPerGroup; ++k) {
      const long long q = q0 + g * Sh::kPairsPerGroup + k;
      const bool live = q < Q;
      la[k] = live ? __ldg(left + q) : 0;
      ra[k] = live ? __ldg(right + q) : 0;
      sl[k] = (live && MODE != 0) ? __ldg(sup_left + q) : 0;
    }
#pragma unroll
    for (int k = 0; k < Sh::kPairsPerGroup; ++k) {
      const int p = g * Sh::kPairsPerGroup + k;
      const long long q = q0 + p;
      const bool live = q < Q;   // uniform over the group
      int pop = 0;
      if (live)
        pop = group_row<MODE, V, G, false>(fv + static_cast<long long>(la[k]) * units,
                                           fv + static_cast<long long>(ra[k]) * units,
                                           stage ? rows_s + p * units : nullptr, units, lg);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) pop += __shfl_xor_sync(0xffffffffu, pop, off);
      if (lg == 0) {
        int f = 0;
        if (live) {
          const int s = MODE == 0 ? pop : sl[k] - pop;
          f = (s >= min_sup && q < n_valid) ? 1 : 0;
          sup[q] = s;
          mask[q] = f;
        }
        s_flag[p] = f;
      }
    }
  } else if (tid < TP) {
    const long long q = q0 + tid;
    int f = 0;
    if (q < Q) {
      f = (q < n_valid && mask[q] != 0) ? 1 : 0;
      mask[q] = f;
    }
    s_flag[tid] = f;
  }
  __syncthreads();

  // 2. rank the flags, then the tile's first output slot by look-back
  const int f = tid < TP ? s_flag[tid] : 0;
  const unsigned bal = __ballot_sync(0xffffffffu, f);
  if (lane == 0) s_warp[warp] = __popc(bal);
  __syncthreads();
  int before = 0, count = 0;
#pragma unroll
  for (int w = 0; w < kCompactWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    count += s_warp[w];
  }
  if (f) s_sel[before + __popc(bal & ((1u << lane) - 1u))] = tid;
  if (warp == 0) {
    long long exclusive = 0;
    if (tile == 0) {
      if (lane == 0) store_status(&status[0], tag | kInclusive | static_cast<unsigned>(count));
    } else {
      if (lane == 0) store_status(&status[tile], tag | kAggregate | static_cast<unsigned>(count));
      long long j = tile - 1;   // the tile lane 0 reads
      while (true) {
        const long long t = j - lane;
        unsigned long long st = t >= 0 ? load_status(&status[t]) : tag | kInclusive;
        if ((st >> kEpochShift) != epoch) st = 0;   // another launch's: not yet published
        const unsigned flag = static_cast<unsigned>(st >> 32) & 3u;
        const unsigned inc = __ballot_sync(0xffffffffu, flag == 2u);
        const unsigned inv = __ballot_sync(0xffffffffu, flag == 0u);
        // lanes up to the nearest inclusive prefix must all have published
        const unsigned upto = inc ? ((inc & (0u - inc)) << 1) - 1u : 0xffffffffu;
        if (inv & upto) continue;
        long long v = ((upto >> lane) & 1u) ? static_cast<long long>(st & 0xffffffffull) : 0;
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        exclusive += v;
        if (inc) break;
        j -= kWarp;
      }
      if (lane == 0)
        store_status(&status[tile],
                     tag | kInclusive | static_cast<unsigned>(exclusive + count));
    }
    if (lane == 0) {
      s_base = exclusive;
      if (tile == n_tiles - 1) *n_surv = static_cast<int>(exclusive + count);
      // the last look-back to finish: every tile is taken and no block
      // reads state[0] or state[1] again in this launch
      if (atomicAdd(&state[1], 1ull) == static_cast<unsigned long long>(n_tiles - 1)) {
        state[0] = 0ull;
        state[1] = 0ull;
      }
    }
  }
  __syncthreads();

  // 3. one output row per pair of the tile: survivors, then pad rows
  const long long base = s_base;
  const long long pad0 = Q - (q0 - base) - (n - count);
  T* ov = reinterpret_cast<T*>(out);
  const T* a0 = fv + static_cast<long long>(__ldg(left)) * units;
  const T* b0 = fv + static_cast<long long>(__ldg(right)) * units;
  for (int i = g; i < n; i += Sh::kGroups) {
    if (i < count) {
      const int p = s_sel[i];
      T* dst = ov + (base + i) * units;
      if (FUSED && stage) {
        const T* src = rows_s + p * units;
        for (int e = lg; e < units; e += G) __stcs(dst + e, src[e]);
      } else {
        const long long q = q0 + p;
        group_row<MODE, V, G, true>(fv + static_cast<long long>(__ldg(left + q)) * units,
                                    fv + static_cast<long long>(__ldg(right + q)) * units,
                                    dst, units, lg);
      }
    } else {
      group_row<MODE, V, G, true>(a0, b0, ov + (pad0 + i - count) * units, units, lg);
    }
  }
}

constexpr int kStageLimit = 100 * 1024;   // shared memory for staged rows

template <int MODE, int V, int G, bool FUSED>
cudaError_t launch_compact(const unsigned* f, const int* l, const int* r, const int* sl,
                           int* sup, int* mask, unsigned long long* state,
                           unsigned long long epoch, unsigned* out, int* n_surv, long long Q,
                           int W, long long n_valid, int min_sup, cudaStream_t st) {
  constexpr int TP = Shape<G>::kTilePairs;
  const long long n_tiles = (Q + TP - 1) / TP;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // every tile's status lies inside the state sized by state_words(Q)
  if (2 + n_tiles > state_words(Q)) return cudaErrorInvalidValue;
  const long long bytes = static_cast<long long>(TP) * W * 4;
  const int stage = (FUSED && bytes <= kStageLimit) ? 1 : 0;
  const int smem = stage ? static_cast<int>(bytes) : 0;
  cudaError_t err = cudaFuncSetAttribute(compact_pairs_kernel<MODE, V, G, FUSED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kStageLimit);
  if (err != cudaSuccess) return err;
  compact_pairs_kernel<MODE, V, G, FUSED>
      <<<static_cast<unsigned>(n_tiles), kCompactThreads, smem, st>>>(
          f, l, r, sl, sup, mask, stage, state, epoch, out, n_surv, Q, W, n_valid, min_sup);
  return cudaGetLastError();
}

template <int MODE, int V, int G>
cudaError_t launch_front(const unsigned* f, const int* l, const int* r, const int* sl,
                         int* sup, int* mask, int fused, unsigned long long* state,
                         unsigned long long epoch, unsigned* out, int* n_surv, long long Q,
                         int W, long long n_valid, int min_sup, cudaStream_t st) {
  if (fused)
    return launch_compact<MODE, V, G, true>(f, l, r, sl, sup, mask, state, epoch, out, n_surv,
                                            Q, W, n_valid, min_sup, st);
  return launch_compact<MODE, V, G, false>(f, l, r, sl, sup, mask, state, epoch, out, n_surv,
                                           Q, W, n_valid, min_sup, st);
}

template <int MODE, int V>
cudaError_t dispatch_lanes(const unsigned* f, const int* l, const int* r, const int* sl,
                           int* sup, int* mask, int fused, unsigned long long* state,
                           unsigned long long epoch, unsigned* out, int* n_surv, long long Q,
                           int W, long long n_valid, int min_sup, int lanes, cudaStream_t st) {
  switch (lanes) {
    case 8: return launch_front<MODE, V, 8>(f, l, r, sl, sup, mask, fused, state, epoch, out, n_surv, Q, W, n_valid, min_sup, st);
    case 16: return launch_front<MODE, V, 16>(f, l, r, sl, sup, mask, fused, state, epoch, out, n_surv, Q, W, n_valid, min_sup, st);
    case 32: return launch_front<MODE, V, 32>(f, l, r, sl, sup, mask, fused, state, epoch, out, n_surv, Q, W, n_valid, min_sup, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
cudaError_t dispatch_compact(const unsigned* f, const int* l, const int* r, const int* sl,
                             int* sup, int* mask, int fused, unsigned long long* state,
                             unsigned long long epoch, unsigned* out, int* n_surv, long long Q,
                             int W, long long n_valid, int min_sup, int lanes, cudaStream_t st) {
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int units = vec ? W / 4 : W;
  const int g = lanes ? lanes : rule_lanes(units);
  if (vec)
    return dispatch_lanes<MODE, 4>(f, l, r, sl, sup, mask, fused, state, epoch, out, n_surv, Q, W, n_valid, min_sup, g, st);
  return dispatch_lanes<MODE, 1>(f, l, r, sl, sup, mask, fused, state, epoch, out, n_surv, Q, W, n_valid, min_sup, g, st);
}

// ---------------------------------------------------------------------------
// K1 and K3: a tile of consecutive pairs per block, from a staged window
// (fused_pairs_kernel, partial_pairs_kernel)
// ---------------------------------------------------------------------------

constexpr int kWinThreads = 256;
constexpr int kWinWarps = kWinThreads / kWarp;
constexpr int kWinTileNarrow = 256;               // pairs of a tile of narrow rows: a thread each
constexpr int kWinTileWide = 16;                  // of wide rows: 16 lanes each
constexpr int kWinTileMin = kWinThreads / kWarp;  // a warp per pair at most
constexpr int kWinNarrow = 128;                   // widest row a thread takes alone
constexpr int kWinRowsMax = 256;                  // window rows
constexpr int kWinSms = 132;                      // SMs of an H100 SXM
constexpr long long kWinWholeLimit = 100 * 1024;  // bytes of whole rows staged
constexpr int kWinStageBytes = 48 * 1024;         // bytes of a stage of row chunks
constexpr int kWinUnroll = 4;                     // elements in flight per lane and row
// dynamic shared memory a given plan may take: the 227 KB a block of 256
// threads may have on the H100, less room for the static arrays
constexpr long long kWinSmemMax = 223 * 1024;

// A given plan the kernel cannot run is refused with one of these codes
// (negative, so never a cudaError_t; cuda_error_string names them).
constexpr int kPlanBadTile = -1;    // not a power of two from 8 to 256 pairs
constexpr int kPlanBadRows = -2;    // not 1 to 256 window rows
constexpr int kPlanBadChunk = -3;   // breaks the pitch skew (or is not positive)
constexpr int kPlanBadSmem = -4;    // more shared memory than a block may take

// TP pairs a tile (the block's 256 threads in groups of G = 256 / TP lanes,
// a pair per group), the window's capacity R in rows, C words of each row
// staged at once (W: whole rows), the stages in flight and the dynamic
// shared memory.  Mirrored by kernels/fused_intersect/fused_intersect.py
// window_plan.
struct WindowPlan {
  int tile, rows, chunk, stages, smem;
};

// A staged row's pitch C + 4 is G words (4 at least) past a multiple of 32,
// G = 256 / TP the lanes per pair, so the 32 / G rows a warp reads at once
// start in different banks.
int window_skew(int tile) {
  const int lanes = kWinThreads / tile;
  return (lanes < 4 ? 4 : lanes) & 31;
}

// The rule: a thread per pair for rows of at most 128 words, 16 lanes per
// pair for wider ones, tiles halved while they are fewer than the SMs; a
// window of twice the tile in rows; whole rows while they fit 100 KB, else
// two 48 KB stages of skewed chunks.
WindowPlan window_plan(long long Q, int W) {
  WindowPlan p;
  int tile = W <= kWinNarrow ? kWinTileNarrow : kWinTileWide;
  while (tile > kWinTileMin && (Q + tile - 1) / tile < kWinSms) tile >>= 1;
  p.tile = tile;
  p.rows = 2 * tile < kWinRowsMax ? 2 * tile : kWinRowsMax;
  if (static_cast<long long>(p.rows) * W * 4 <= kWinWholeLimit) {
    p.chunk = W;
    p.stages = 1;
    p.smem = p.rows * W * 4 + 16;   // the window starts 0-3 words into its slot
  } else {
    const int pitch = kWinStageBytes / (p.rows * 4);
    p.chunk = pitch - 4 - ((pitch - window_skew(tile)) & 31);
    p.stages = 2;
    p.smem = p.stages * p.rows * (p.chunk + 4) * 4;
  }
  return p;
}

// The plan of a launch: all zeros, the rule; else the given (tile, rows,
// chunk), a chunk of at least W words staging whole rows (reported as W).
// Returns 0, or the code of the first thing the kernel cannot run: a tile
// outside 8-256 pairs or not a power of two (lanes per pair stay at most a
// warp), window rows outside 1-256 (each of the block's 256 threads
// starts one row's copies), a chunk whose pitch breaks the skew (every skew
// is a multiple of 4 words, so a chunk that keeps it keeps the staged rows'
// 16-byte loads where W is a multiple of 4), or more dynamic shared memory
// than kWinSmemMax.  Nothing depends on Q:
// a plan that holds for one pair count holds for every one.
int given_plan(long long Q, int W, int tile, int rows, int chunk, WindowPlan* out) {
  if (tile == 0 && rows == 0 && chunk == 0) {
    *out = window_plan(Q, W);
    return 0;
  }
  if (tile < kWinTileMin || tile > kWinTileNarrow || (tile & (tile - 1)) != 0) return kPlanBadTile;
  if (rows < 1 || rows > kWinRowsMax) return kPlanBadRows;
  if (chunk < 1) return kPlanBadChunk;
  WindowPlan p;
  p.tile = tile;
  p.rows = rows;
  long long smem;
  if (chunk >= W) {
    p.chunk = W;
    p.stages = 1;
    smem = static_cast<long long>(rows) * W * 4 + 16;
  } else {
    if ((chunk + 4) % 32 != window_skew(tile)) return kPlanBadChunk;
    p.chunk = chunk;
    p.stages = 2;
    smem = 2LL * rows * (chunk + 4) * 4;
  }
  if (smem > kWinSmemMax) return kPlanBadSmem;
  p.smem = static_cast<int>(smem);
  *out = p;
  return 0;
}

struct WindowArgs {
  const unsigned* frontier;
  const int* left;
  const int* right;
  const int* sup_left;   // K1 in modes 1 and 2
  unsigned* inter;       // (Q, W) intersections, or null
  int* out;              // K1: supports; K3: raw popcounts
  int* mask;             // K1
  long long Q;
  int W, min_sup, tile, rows, chunk;
};

__device__ __forceinline__ void cp_async_4(uint32_t dst, const unsigned* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A bulk copy (the TMA engine, no tensor map): bytes (a multiple of 16)
// from 16-byte aligned src to 16-byte aligned shared address dst, counted
// on the barrier at shared address bar.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const unsigned* src, unsigned bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One staged segment: the frontier's words [g0, g0 + n) land at shared
// words base + o + j, o = (g0's address / 4) % 4, so the 16-byte aligned
// interior [head, head + body) is aligned on both sides and goes by bulk
// copy; the 0-3 words before it and after it go one by one.
struct Segment {
  long long g0;
  int n, base, o, head, body;
  __device__ __forceinline__ Segment(long long g0_, int n_, int base_, unsigned mis)
      : g0(g0_), n(n_), base(base_) {
    o = static_cast<int>((mis + g0) & 3);
    head = min((4 - o) & 3, n);
    body = (n - head) & ~3;
  }
};

// Issue the copies of chunk c of window rows [lo, lo + n_rows) into the
// stage at shared address buf, counted on the barrier at shared address
// bar: whole rows are one segment of n_rows * W words; chunks are one
// segment of up to C words per row, row i at buf + 4 i (C + 4).  Each warp
// posts the bytes of its segments' bulk copies on the barrier (one arrival
// per warp) and issues them, a lane per segment; every thread copies a
// share of the segments' edge words with cp.async and commits them as one
// group.  mis = (frontier's address / 4) % 4.
__device__ __forceinline__ void stage_window(uint32_t buf, uint32_t bar,
                                             const unsigned* frontier, unsigned mis, int lo,
                                             int n_rows, int W, int C, int c, bool whole) {
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int n_seg = whole ? 1 : n_rows;
  const int c0 = whole ? 0 : c * C;
  const int cw = whole ? n_rows * W : min(C, W - c0);
  auto segment = [&](int i) {
    return whole ? Segment(static_cast<long long>(lo) * W, cw, 0, mis)
                 : Segment(static_cast<long long>(lo + i) * W + c0, cw, i * (C + 4), mis);
  };
  // segments warp, warp + 8, ...: lane j takes segment warp + 8 j
  const int i = warp + kWinWarps * lane;
  const Segment seg = segment(i < n_seg ? i : 0);
  const unsigned bytes = i < n_seg ? 4u * seg.body : 0u;
  const unsigned total = __reduce_add_sync(0xffffffffu, bytes);
  hopper::fence_proxy_async_smem();   // the block's reads of the stage come first
  if (lane == 0) mbar_arrive_expect_tx(bar, total);
  __syncwarp();
  if (bytes > 0)
    bulk_copy(buf + 4u * (seg.base + seg.o + seg.head), frontier + seg.g0 + seg.head, bytes, bar);
  for (int f = tid; f < 8 * n_seg; f += kWinThreads) {
    const Segment s = segment(f / 8);
    const int k = f % 8;
    const int j = k < 4 ? k : s.head + s.body + k - 4;
    if (k < 4 ? j < s.head : j < s.n) cp_async_4(buf + 4u * (s.base + s.o + j), frontier + s.g0 + j);
  }
  cp_async_commit();
}

// Lane lg of a pair's G lanes combines elements lg, lg + G, ... of rows a
// and b (n elements of V words), read by load(row, i), stores them to dst
// with STORE (streaming stores), and returns its share of the popcount.
// The loop's body takes kWinUnroll elements with no bound check, so their
// loads issue together; the last few go one at a time.
template <int MODE, int V, bool STORE, typename Row, typename Load>
__device__ __forceinline__ int lane_units(Row a, Row b, Load load,
                                          typename Vec<V>::T* __restrict__ dst, int n,
                                          int lg, int G) {
  using T = typename Vec<V>::T;
  int pop = 0;
  int i = lg;
  for (; i + (kWinUnroll - 1) * G < n; i += kWinUnroll * G) {
    T av[kWinUnroll], bv[kWinUnroll];
#pragma unroll
    for (int u = 0; u < kWinUnroll; ++u) {
      av[u] = load(a, i + u * G);
      bv[u] = load(b, i + u * G);
    }
#pragma unroll
    for (int u = 0; u < kWinUnroll; ++u) {
      const T x = Vec<V>::template combine<MODE>(av[u], bv[u]);
      if (STORE) __stcs(dst + i + u * G, x);
      pop += Vec<V>::popc(x);
    }
  }
  for (; i < n; i += G) {
    const T x = Vec<V>::template combine<MODE>(load(a, i), load(b, i));
    if (STORE) __stcs(dst + i, x);
    pop += Vec<V>::popc(x);
  }
  return pop;
}

// A load from a 32-bit shared-memory address.
template <int V> __device__ __forceinline__ typename Vec<V>::T lds(uint32_t addr);
template <> __device__ __forceinline__ unsigned lds<1>(uint32_t addr) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
template <> __device__ __forceinline__ uint4 lds<4>(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// The body of K1 (FUSED: support and threshold) and K3 (raw popcount).
// Per tile of TP consecutive pairs:
// 1. The tile's indices, loaded while the tile before was counted, go to
//    shared memory.  The window is rows [lo, hi], lo the first pair's left
//    row and hi the largest operand row below lo + R; it is staged only if
//    at least as many operands as pairs lie in it (a class-ordered tile has
//    nearly all of them there, a random one nearly none).
// 2. Per chunk of words (one for whole rows): the next chunk's copies are
//    issued, the block waits for this one's (its cp.async group, then its
//    barrier's phase), and the G = 256 / TP lanes of each pair count its
//    chunk, reading an operand row from the window where it lies inside,
//    else from the frontier.  Each lane keeps its sum over the chunks in a
//    register; after the last chunk the pair's lanes sum with shuffles (none
//    when a thread takes a pair alone) and the first writes the outputs.
// 3. A tile of whole rows with a thread per pair is counted a warp per pair
//    instead, 4 pairs at a time, where its window is not staged (so the
//    gathers from the frontier coalesce) or its intersections are stored
//    (so the stores coalesce).
// V = 4 (16-byte elements) where W is a multiple of 4 and the frontier (and
// the intersections) 16-byte aligned: then every row, staged or not, is.
template <int MODE, int V, bool FUSED, bool STORE>
__device__ __forceinline__ void window_pairs(const WindowArgs& a) {
  using T = typename Vec<V>::T;
  extern __shared__ uint4 window_raw[];
  unsigned* win = reinterpret_cast<unsigned*>(window_raw);
  __shared__ int s_left[kWinTileNarrow], s_right[kWinTileNarrow], s_supl[kWinTileNarrow];
  __shared__ int s_top[kWinWarps], s_in[kWinWarps];
  __shared__ __align__(8) uint64_t s_bar[2];
  // the shared addresses of the window and the barriers, kept in registers:
  // left to itself the compiler rebuilds them from the cluster CTA id (the
  // bulk copies make the kernel cluster-aware) before every load
  uint32_t win_s, bar_s;
  asm volatile("mov.u32 %0, %1;\n" : "=r"(win_s) : "r"(hopper::smem_u32(win)));
  asm volatile("mov.u32 %0, %1;\n" : "=r"(bar_s) : "r"(hopper::smem_u32(s_bar)));

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const long long Q = a.Q;
  const int W = a.W, tp = a.tile, R = a.rows, C = a.chunk;
  const int G = kWinThreads / tp;   // lanes per pair
  const int p = tid / G;            // this lane's pair in the tile
  const int lg = tid % G;
  const bool whole = C >= W;
  const int n_chunks = whole ? 1 : (W + C - 1) / C;
  const int pitch = C + 4;
  const int stage_words = whole ? 0 : R * pitch;
  const unsigned mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(a.frontier) >> 2) & 3u;
  const long long n_tiles = (Q + tp - 1) / tp;
  constexpr bool kSupLeft = FUSED && MODE != 0;

  if (tid == 0) {
    hopper::mbar_init(&s_bar[0], kWinWarps);
    hopper::mbar_init(&s_bar[1], kWinWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  unsigned phases = 0;   // the parity each stage's barrier completes next

  int next_l = 0, next_r = 0, next_s = 0, next_lo = 0;
  auto fetch = [&](long long t) {
    const long long q = t * tp + tid;
    const bool has = tid < tp && q < Q;
    next_l = has ? __ldg(a.left + q) : 0;
    next_r = has ? __ldg(a.right + q) : 0;
    if (kSupLeft) next_s = has ? __ldg(a.sup_left + q) : 0;
    next_lo = __ldg(a.left + t * tp);
  };
  if (blockIdx.x < n_tiles) fetch(blockIdx.x);

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long q0 = tile * tp;
    const int n = static_cast<int>(Q - q0 < tp ? Q - q0 : tp);   // pairs in this tile
    const int l = next_l, r = next_r, sl = next_s, lo = next_lo;
    if (tile + gridDim.x < n_tiles) fetch(tile + gridDim.x);
    auto epilogue = [&](int pair, int pop) {
      const long long q = q0 + pair;
      if (FUSED) {
        const int s = MODE == 0 ? pop : s_supl[pair] - pop;
        a.out[q] = s;
        a.mask[q] = s >= a.min_sup ? 1 : 0;
      } else {
        a.out[q] = pop;
      }
    };

    // 1. indices and window
    int top = lo, in = 0;
    if (tid < n) {
      if (static_cast<unsigned>(l - lo) < static_cast<unsigned>(R)) top = max(top, l), ++in;
      if (static_cast<unsigned>(r - lo) < static_cast<unsigned>(R)) top = max(top, r), ++in;
    }
    top = __reduce_max_sync(0xffffffffu, top);
    in = __reduce_add_sync(0xffffffffu, in);
    __syncthreads();   // the tile before is done with the indices and the window
    if (tid < tp) {
      s_left[tid] = l;
      s_right[tid] = r;
      if (kSupLeft) s_supl[tid] = sl;
    }
    if (lane == 0) {
      s_top[warp] = top;
      s_in[warp] = in;
    }
    __syncthreads();
    int hi = s_top[0], in_all = s_in[0];
#pragma unroll
    for (int w = 1; w < kWinWarps; ++w) {
      hi = max(hi, s_top[w]);
      in_all += s_in[w];
    }
    const int n_rows = in_all >= n ? hi - lo + 1 : 0;

    const int o_whole = static_cast<int>((mis + static_cast<long long>(lo) * W) & 3);
    auto inside = [&](int x) {
      return static_cast<unsigned>(x - lo) < static_cast<unsigned>(n_rows);
    };

    // 3. whole rows with a thread per pair: a warp per pair instead where
    //    the window is not staged (so the gathers coalesce) or the
    //    intersections are stored (so the stores do), four pairs at a time
    if (whole && G == 1 && (STORE || n_rows == 0)) {
      // kStaged: the window is staged and an operand may come from it
      auto warp_pairs = [&](auto staged) {
        constexpr bool kStaged = decltype(staged)::value;
        constexpr int kB = 4;
        const int per_warp = tp / kWinWarps;
        const int units = W / V;
        for (int k0 = 0; k0 < per_warp; k0 += kB) {
          const T* ga[kB];
          const T* gb[kB];
          uint32_t sa[kB], sb[kB];
          bool st[kB];
          int pw[kB];
#pragma unroll
          for (int j = 0; j < kB; ++j) {
            const int pp = warp * per_warp + k0 + j;
            const int xa = pp < n ? s_left[pp] : lo;
            const int xb = pp < n ? s_right[pp] : lo;
            ga[j] = reinterpret_cast<const T*>(a.frontier + static_cast<long long>(xa) * W);
            gb[j] = reinterpret_cast<const T*>(a.frontier + static_cast<long long>(xb) * W);
            if constexpr (kStaged) {
              st[j] = inside(xa) && inside(xb);   // the same for the warp's lanes
              sa[j] = win_s + 4u * (o_whole + (xa - lo) * W);
              sb[j] = win_s + 4u * (o_whole + (xb - lo) * W);
            }
            pw[j] = 0;
          }
          for (int i = lane; i < units; i += kWarp) {
            T av[kB], bv[kB];
#pragma unroll
            for (int j = 0; j < kB; ++j) {
              if constexpr (kStaged) {
                av[j] = st[j] ? lds<V>(sa[j] + 4 * V * i) : __ldg(ga[j] + i);
                bv[j] = st[j] ? lds<V>(sb[j] + 4 * V * i) : __ldg(gb[j] + i);
              } else {
                av[j] = __ldg(ga[j] + i);
                bv[j] = __ldg(gb[j] + i);
              }
            }
#pragma unroll
            for (int j = 0; j < kB; ++j) {
              const int pp = warp * per_warp + k0 + j;
              const T x = Vec<V>::template combine<MODE>(av[j], bv[j]);
              if (STORE && pp < n) __stcs(reinterpret_cast<T*>(a.inter + (q0 + pp) * W) + i, x);
              pw[j] += Vec<V>::popc(x);
            }
          }
#pragma unroll
          for (int j = 0; j < kB; ++j) {
            pw[j] = __reduce_add_sync(0xffffffffu, pw[j]);
            const int pp = warp * per_warp + k0 + j;
            if (lane == j && pp < n) epilogue(pp, pw[j]);
          }
        }
      };
      if constexpr (STORE) {   // (only a stored tile takes this path staged)
        if (n_rows) {
          stage_window(win_s, bar_s, a.frontier, mis, lo, n_rows, W, C, 0, true);
          cp_async_wait<0>();
          hopper::mbar_wait(&s_bar[0], phases & 1);
          phases ^= 1u;
          __syncthreads();
          warp_pairs(std::true_type{});
          continue;
        }
      }
      warp_pairs(std::false_type{});
      continue;
    }

    // 2. chunks
    const bool live = p < n;
    const int pl = live ? s_left[p] : lo;
    const int pr = live ? s_right[p] : lo;
    int pop = 0;
    if (n_rows) stage_window(win_s, bar_s, a.frontier, mis, lo, n_rows, W, C, 0, whole);
    for (int c = 0; c < n_chunks; ++c) {
      if (n_rows) {
        if (c + 1 < n_chunks) {
          stage_window(win_s + 4u * ((c + 1) & 1) * stage_words, bar_s + 8u * ((c + 1) & 1),
                       a.frontier, mis, lo, n_rows, W, C, c + 1, whole);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        hopper::mbar_wait(&s_bar[c & 1], (phases >> (c & 1)) & 1);
        phases ^= 1u << (c & 1);
        __syncthreads();
      }
      if (live) {
        const int c0 = whole ? 0 : c * C;
        const int cw = whole ? W : min(C, W - c0);
        const int buf = (c & 1) * stage_words;
        // a window row's first word, as a word offset into the window
        auto staged = [&](int x) {
          const int i = x - lo;
          return whole ? buf + o_whole + i * W
                       : buf + i * pitch + static_cast<int>((mis + static_cast<long long>(x) * W + c0) & 3);
        };
        T* dst = STORE ? reinterpret_cast<T*>(a.inter + (q0 + p) * W + c0) : nullptr;
        if (inside(pl) && inside(pr)) {
          // both operands staged: shared-memory loads from 32-bit addresses
          auto load = [](uint32_t row, int i) { return lds<V>(row + 4 * V * i); };
          pop += lane_units<MODE, V, STORE>(win_s + 4u * staged(pl), win_s + 4u * staged(pr),
                                            load, dst, cw / V, lg, G);
        } else {
          auto row = [&](int x) -> const T* {
            return reinterpret_cast<const T*>(
                inside(x) ? win + staged(x) : a.frontier + static_cast<long long>(x) * W + c0);
          };
          auto load = [](const T* row, int i) { return row[i]; };
          pop += lane_units<MODE, V, STORE>(row(pl), row(pr), load, dst, cw / V, lg, G);
        }
      }
      if (n_rows && c + 1 < n_chunks) __syncthreads();   // chunk c + 2 is copied into this buffer
    }
    for (int off = G >> 1; off > 0; off >>= 1) pop += __shfl_xor_sync(0xffffffffu, pop, off);
    if (live && lg == 0) epilogue(p, pop);
  }
}

template <int MODE, int V, bool STORE>
__global__ void __launch_bounds__(kWinThreads) fused_pairs_kernel(WindowArgs a) {
  window_pairs<MODE, V, true, STORE>(a);
}

template <int MODE, int V, bool STORE>
__global__ void __launch_bounds__(kWinThreads) partial_pairs_kernel(WindowArgs a) {
  window_pairs<MODE, V, false, STORE>(a);
}

using WindowKernel = void (*)(WindowArgs);

template <int MODE, int V>
WindowKernel window_kernel(bool fused, bool store) {
  if (fused)
    return store ? fused_pairs_kernel<MODE, V, true> : fused_pairs_kernel<MODE, V, false>;
  return store ? partial_pairs_kernel<MODE, V, true> : partial_pairs_kernel<MODE, V, false>;
}

template <int MODE>
WindowKernel window_kernel(bool fused, bool store, bool vec) {
  return vec ? window_kernel<MODE, 4>(fused, store) : window_kernel<MODE, 1>(fused, store);
}

// One launch of K1 (fused) or K3 on the persistent grid: the SMs times the
// blocks of the plan's shared memory that fit on one (counted for this
// plan), at most one per tile.  args.tile, rows and chunk hold the given
// plan (all zeros: the rule); a cudaError_t, or a refusal code.
int launch_window(bool fused, int mode, WindowArgs args, int device, cudaStream_t st) {
  if (mode < 0 || mode > 2 || args.W < 0) return cudaErrorInvalidValue;
  WindowPlan p;
  const int refused = given_plan(args.Q, args.W, args.tile, args.rows, args.chunk, &p);
  if (refused != 0) return refused;
  args.tile = p.tile;
  args.rows = p.rows;
  args.chunk = p.chunk;
  const bool store = args.inter != nullptr;
  const bool vec = args.W % 4 == 0 && reinterpret_cast<uintptr_t>(args.frontier) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(args.inter) % 16 == 0;
  const WindowKernel kernel = mode == 0 ? window_kernel<0>(fused, store, vec)
                            : mode == 1 ? window_kernel<1>(fused, store, vec)
                                        : window_kernel<2>(fused, store, vec);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWinThreads, p.smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (args.Q + p.tile - 1) / p.tile;
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > n_tiles) grid = n_tiles;
  kernel<<<static_cast<unsigned>(grid), kWinThreads, p.smem, st>>>(args);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: inter may be null (supports and mask only); (tile, rows, chunk) the
// plan, all zeros for the rule.  Returns a cudaError_t, or a negative code
// for a plan the kernel cannot run (window_plan_check), checked before any
// launch.
int fused_pairs_launch(const void* frontier, const void* left,
                       const void* right, const void* sup_left, void* inter,
                       void* sup, void* mask, long long Q, int W, int mode,
                       int min_sup, int tile, int rows, int chunk, int device,
                       void* stream) {
  if (Q <= 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  WindowArgs a{static_cast<const unsigned*>(frontier), static_cast<const int*>(left),
               static_cast<const int*>(right), static_cast<const int*>(sup_left),
               static_cast<unsigned*>(inter), static_cast<int*>(sup), static_cast<int*>(mask),
               Q, W, min_sup, tile, rows, chunk};
  return launch_window(true, mode, a, device, static_cast<cudaStream_t>(stream));
}

// The rule's plan of a K1 or K3 launch for Q pairs of W-word rows:
// out = {TP, R, C, stages, dynamic shared memory bytes}.
void window_plan_of(long long Q, int W, int* out) {
  const WindowPlan p = window_plan(Q, W);
  out[0] = p.tile;
  out[1] = p.rows;
  out[2] = p.chunk;
  out[3] = p.stages;
  out[4] = p.smem;
}

// The plan a launch with (tile, rows, chunk) runs, as window_plan_of
// reports it; returns 0, or the negative code a launch would return for a
// plan the kernel cannot run (out untouched).
int window_plan_check(long long Q, int W, int tile, int rows, int chunk, int* out) {
  WindowPlan p;
  const int refused = given_plan(Q, W, tile, rows, chunk, &p);
  if (refused != 0) return refused;
  out[0] = p.tile;
  out[1] = p.rows;
  out[2] = p.chunk;
  out[3] = p.stages;
  out[4] = p.smem;
  return 0;
}

// Words of look-back state compact_pairs_launch needs for Q pairs: the tile
// counter, the finished-look-back counter, one status per tile of the
// smallest tile (8 pairs, G = 32), so the state fits every G.  Zero before
// the first launch; every launch leaves the two counters zero, and the
// statuses need no clearing while the epoch changes.
long long compact_state_words(long long Q) { return state_words(Q); }

// The geometry of compact_pairs_kernel with G lanes per pair (0: the rule's
// G for W-word rows of 16-byte elements), six ints: G, pairs a tile, pairs
// a group, elements in flight per lane, and the blocks per SM of the fused
// and the given-mask front ends.  Returns 0, or -1 for a G it does not take.
int compact_shape_of(int lanes, int W, int* out) {
  switch (lanes ? lanes : rule_lanes(W % 4 == 0 ? W / 4 : W)) {
    case 8: shape_of<8>(out); return 0;
    case 16: shape_of<16>(out); return 0;
    case 32: shape_of<32>(out); return 0;
    default: return -1;
  }
}

// Largest epoch a launch may be given; the caller zeroes the state and
// starts again at 1 after it.
unsigned long long compact_max_epoch() { return (1ull << (64 - kEpochShift)) - 1; }

// The survivor compaction in one launch of compact_pairs_kernel.  Fused when
// mask_in is 0: sup_left (modes 1 and 2) is read, sup and mask are written
// (mask valid-masked).  Otherwise mask holds the flags computed elsewhere and
// is rewritten in place to the valid-masked flags; sup_left and sup are not
// touched.  state holds compact_state_words(Q) words as above; epoch differs
// from the epoch of every earlier launch on this state (1, 2, ...); n_surv
// one int; out (Q, W); lanes the lanes per pair, 8, 16 or 32, or 0 for the
// rule.  Returns a cudaError_t.
int compact_pairs_launch(const void* frontier, const void* left, const void* right,
                         const void* sup_left, void* sup, void* mask, int mask_in,
                         void* state, unsigned long long epoch, void* n_surv, void* out,
                         long long Q, int W, long long n_valid, int min_sup, int mode,
                         int lanes, int device, void* stream) {
  if (Q <= 0) return cudaSuccess;
  if (mode < 0 || mode > 2 || W < 0 || epoch == 0 || epoch > compact_max_epoch() ||
      (lanes != 0 && lanes != 8 && lanes != 16 && lanes != 32))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto* f = static_cast<const unsigned*>(frontier);
  const auto* l = static_cast<const int*>(left);
  const auto* r = static_cast<const int*>(right);
  const auto* sl = static_cast<const int*>(sup_left);
  auto* o_sup = static_cast<int*>(sup);
  auto* m = static_cast<int*>(mask);
  auto* s = static_cast<unsigned long long*>(state);
  auto* o = static_cast<unsigned*>(out);
  auto* n = static_cast<int*>(n_surv);
  const int fused = mask_in ? 0 : 1;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return dispatch_compact<0>(f, l, r, sl, o_sup, m, fused, s, epoch, o, n, Q, W, n_valid, min_sup, lanes, st);
    case 1: return dispatch_compact<1>(f, l, r, sl, o_sup, m, fused, s, epoch, o, n, Q, W, n_valid, min_sup, lanes, st);
    default: return dispatch_compact<2>(f, l, r, sl, o_sup, m, fused, s, epoch, o, n, Q, W, n_valid, min_sup, lanes, st);
  }
}


// K3: inter may be null (partial popcounts only); the plan as for K1.
// Returns a cudaError_t, or a negative code for a refused plan.
int partial_pairs_launch(const void* frontier, const void* left,
                         const void* right, void* inter, void* pop,
                         long long Q, int W, int mode, int tile, int rows,
                         int chunk, int device, void* stream) {
  if (Q <= 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  WindowArgs a{static_cast<const unsigned*>(frontier), static_cast<const int*>(left),
               static_cast<const int*>(right), nullptr, static_cast<unsigned*>(inter),
               static_cast<int*>(pop), nullptr, Q, W, 0, tile, rows, chunk};
  return launch_window(false, mode, a, device, static_cast<cudaStream_t>(stream));
}

// The text of a launch's return code: a CUDA error, or a refused plan.
const char* cuda_error_string(int code) {
  switch (code) {
    case kPlanBadTile: return "plan refused: the tile is not a power of two from 8 to 256 pairs";
    case kPlanBadRows: return "plan refused: the window's rows are not from 1 to 256";
    case kPlanBadChunk:
      return "plan refused: the chunk is not a positive word count whose row pitch "
             "(chunk + 4) lies the tile's bank skew past a multiple of 32 words "
             "(which keeps the staged rows' 16-byte loads)";
    case kPlanBadSmem:
      return "plan refused: the plan's shared memory passes the 223 KB a block of 256 "
             "threads may take";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
