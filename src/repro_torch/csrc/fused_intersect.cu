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
// fused_pairs_kernel: one warp per pair (8 pairs per 256-thread block).  Lanes stride
// the row word by word, so each load and store instruction of a warp touches
// 128 contiguous bytes whatever the row alignment (W = 3125 rows are not
// 16-byte aligned, so no vector loads), and four words per lane are loaded
// before any is used to keep eight loads in flight per lane.  The popcount
// is reduced with warp shuffles; no shared memory, no atomics.  The
// threshold is a runtime argument, so sweeping min_sup builds nothing new.
//
// The compacting path is one launch of compact_pairs_kernel: it gathers
// each pair's rows once and writes each output row once.  One block per
// tile of consecutive pairs computes the tile's supports and flags
// (mask & q < n_valid), finds its first output slot with a decoupled
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
// multiple of 4; a group of 8 lanes takes a pair when a row has at most 64
// such elements, a warp otherwise.  Nothing returns to the host and no
// memset runs: the look-back state is tagged with a per-launch epoch and
// its counters are reset by the kernel.
//
// partial_pairs_kernel is the shard-local half of fused_pairs_kernel for a
// frontier whose word axis is split over ranks (the tidsharded and grid
// backends): the same warp per pair over this rank's Ws words, stopping at
// the raw popcount.  The support (sup_left minus the count for diffsets) and
// the threshold need the total count, which exists only after the
// all-reduce over the ranks' partial counts, so they are not done here.  The
// (Q, Ws) store is skipped when inter is null: the compacting backends
// compute the survivor rows from the frontier with compact_pairs_kernel
// once the reduced mask is known.  At chess's Ws = 25 a warp idles 7 of its
// 32 lanes.
//
// Row offsets are 64-bit: q * W passes 2^31 at Q ~ 700k for W = 3125.
// left[q] and right[q] must lie in [0, P): the engine checks its pair lists
// on the host before upload.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPairsPerBlock = 8;
constexpr int kThreads = kPairsPerBlock * kWarp;
constexpr int kUnroll = 4;

template <int MODE>
__device__ __forceinline__ unsigned combine(unsigned a, unsigned b) {
  if (MODE == 0) return a & b;
  if (MODE == 1) return a & ~b;
  return b & ~a;
}

// Intersect two rows of W words; lane `lane` of the warp handles words
// lane, lane + 32, ...  Writes the result to `out` unless it is null and
// returns this lane's share of the popcount.
template <int MODE>
__device__ __forceinline__ int intersect_row(const unsigned* __restrict__ a,
                                             const unsigned* __restrict__ b,
                                             unsigned* __restrict__ out,
                                             int W, int lane) {
  int pop = 0;
  for (int base = lane; base < W; base += kWarp * kUnroll) {
    unsigned av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = base + u * kWarp;
      av[u] = w < W ? __ldg(a + w) : 0u;
      bv[u] = w < W ? __ldg(b + w) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = base + u * kWarp;
      if (w < W) {
        const unsigned x = combine<MODE>(av[u], bv[u]);
        if (out != nullptr) out[w] = x;
        pop += __popc(x);
      }
    }
  }
  return pop;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
fused_pairs_kernel(const unsigned* __restrict__ frontier,
                   const int* __restrict__ left,
                   const int* __restrict__ right,
                   const int* __restrict__ sup_left,
                   unsigned* __restrict__ inter,
                   int* __restrict__ sup,
                   int* __restrict__ mask,
                   long long Q, int W, int min_sup) {
  const long long q = static_cast<long long>(blockIdx.x) * kPairsPerBlock +
                      threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (q >= Q) return;  // q is uniform across the warp: it leaves whole
  const unsigned* a = frontier + static_cast<long long>(left[q]) * W;
  const unsigned* b = frontier + static_cast<long long>(right[q]) * W;
  unsigned* out = inter != nullptr ? inter + q * W : nullptr;
  int pop = intersect_row<MODE>(a, b, out, W, lane);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    pop += __shfl_down_sync(0xffffffffu, pop, off);
  if (lane == 0) {
    const int s = MODE == 0 ? pop : sup_left[q] - pop;
    sup[q] = s;
    mask[q] = s >= min_sup ? 1 : 0;
  }
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

// G lanes per pair: 8 for rows of at most 64 elements, else 32; tiles of
// 128 or 8 pairs (4 or 1 per group of lanes)
template <int G> struct Shape {
  static constexpr int kGroups = kCompactThreads / G;
  static constexpr int kPairsPerGroup = G == 8 ? 4 : 1;
  static constexpr int kTilePairs = kGroups * kPairsPerGroup;
  static constexpr int kUnroll = G == 8 ? 4 : 8;  // elements in flight per lane
};

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
// row before its look-back.  With 8-lane groups, 3 (fused) or 4 blocks of
// 256 threads per SM: the register caps that ran fastest at chess's shape.
template <int MODE, int V, int G, bool FUSED>
__global__ void __launch_bounds__(kCompactThreads, G == 8 ? (FUSED ? 3 : 4) : 1)
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

template <int MODE>
cudaError_t dispatch_compact(const unsigned* f, const int* l, const int* r, const int* sl,
                             int* sup, int* mask, int fused, unsigned long long* state,
                             unsigned long long epoch, unsigned* out, int* n_surv, long long Q,
                             int W, long long n_valid, int min_sup, cudaStream_t st) {
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int units = vec ? W / 4 : W;
  if (vec && units <= 64)
    return launch_front<MODE, 4, 8>(f, l, r, sl, sup, mask, fused, state, epoch, out, n_surv, Q, W, n_valid, min_sup, st);
  if (vec)
    return launch_front<MODE, 4, 32>(f, l, r, sl, sup, mask, fused, state, epoch, out, n_surv, Q, W, n_valid, min_sup, st);
  if (units <= 64)
    return launch_front<MODE, 1, 8>(f, l, r, sl, sup, mask, fused, state, epoch, out, n_surv, Q, W, n_valid, min_sup, st);
  return launch_front<MODE, 1, 32>(f, l, r, sl, sup, mask, fused, state, epoch, out, n_surv, Q, W, n_valid, min_sup, st);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
partial_pairs_kernel(const unsigned* __restrict__ frontier,
                     const int* __restrict__ left,
                     const int* __restrict__ right,
                     unsigned* __restrict__ inter,
                     int* __restrict__ pop,
                     long long Q, int W) {
  const long long q = static_cast<long long>(blockIdx.x) * kPairsPerBlock +
                      threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (q >= Q) return;
  const unsigned* a = frontier + static_cast<long long>(left[q]) * W;
  const unsigned* b = frontier + static_cast<long long>(right[q]) * W;
  unsigned* out = inter != nullptr ? inter + q * W : nullptr;
  int p = intersect_row<MODE>(a, b, out, W, lane);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    p += __shfl_down_sync(0xffffffffu, p, off);
  if (lane == 0) pop[q] = p;
}

unsigned pair_blocks(long long Q) {
  return static_cast<unsigned>((Q + kPairsPerBlock - 1) / kPairsPerBlock);
}

}  // namespace

extern "C" {

// inter may be null (popcount and threshold only).  Returns a cudaError_t.
int fused_pairs_launch(const void* frontier, const void* left,
                       const void* right, const void* sup_left, void* inter,
                       void* sup, void* mask, long long Q, int W, int mode,
                       int min_sup, int device, void* stream) {
  if (Q <= 0) return cudaSuccess;
  if (mode < 0 || mode > 2) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto* f = static_cast<const unsigned*>(frontier);
  const auto* l = static_cast<const int*>(left);
  const auto* r = static_cast<const int*>(right);
  const auto* s = static_cast<const int*>(sup_left);
  auto* x = static_cast<unsigned*>(inter);
  auto* o_sup = static_cast<int*>(sup);
  auto* o_mask = static_cast<int*>(mask);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = pair_blocks(Q);
  switch (mode) {
    case 0:
      fused_pairs_kernel<0><<<grid, kThreads, 0, st>>>(f, l, r, s, x, o_sup, o_mask, Q, W, min_sup);
      break;
    case 1:
      fused_pairs_kernel<1><<<grid, kThreads, 0, st>>>(f, l, r, s, x, o_sup, o_mask, Q, W, min_sup);
      break;
    default:
      fused_pairs_kernel<2><<<grid, kThreads, 0, st>>>(f, l, r, s, x, o_sup, o_mask, Q, W, min_sup);
      break;
  }
  return cudaGetLastError();
}

// Words of look-back state compact_pairs_launch needs for Q pairs: the tile
// counter, the finished-look-back counter, one status per tile of the
// smallest tile.  Zero before the first launch; every launch leaves the two
// counters zero, and the statuses need no clearing while the epoch changes.
long long compact_state_words(long long Q) { return 2 + (Q + 7) / 8; }

// Largest epoch a launch may be given; the caller zeroes the state and
// starts again at 1 after it.
unsigned long long compact_max_epoch() { return (1ull << (64 - kEpochShift)) - 1; }

// The survivor compaction in one launch of compact_pairs_kernel.  Fused when
// mask_in is 0: sup_left (modes 1 and 2) is read, sup and mask are written
// (mask valid-masked).  Otherwise mask holds the flags computed elsewhere and
// is rewritten in place to the valid-masked flags; sup_left and sup are not
// touched.  state holds compact_state_words(Q) words as above; epoch differs
// from the epoch of every earlier launch on this state (1, 2, ...); n_surv
// one int; out (Q, W).  Returns a cudaError_t.
int compact_pairs_launch(const void* frontier, const void* left, const void* right,
                         const void* sup_left, void* sup, void* mask, int mask_in,
                         void* state, unsigned long long epoch, void* n_surv, void* out,
                         long long Q, int W, long long n_valid, int min_sup, int mode,
                         int device, void* stream) {
  if (Q <= 0) return cudaSuccess;
  if (mode < 0 || mode > 2 || W < 0 || epoch == 0 || epoch > compact_max_epoch())
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
    case 0: return dispatch_compact<0>(f, l, r, sl, o_sup, m, fused, s, epoch, o, n, Q, W, n_valid, min_sup, st);
    case 1: return dispatch_compact<1>(f, l, r, sl, o_sup, m, fused, s, epoch, o, n, Q, W, n_valid, min_sup, st);
    default: return dispatch_compact<2>(f, l, r, sl, o_sup, m, fused, s, epoch, o, n, Q, W, n_valid, min_sup, st);
  }
}

// inter may be null (partial popcounts only).  Returns a cudaError_t.
int partial_pairs_launch(const void* frontier, const void* left,
                         const void* right, void* inter, void* pop,
                         long long Q, int W, int mode, int device,
                         void* stream) {
  if (Q <= 0) return cudaSuccess;
  if (mode < 0 || mode > 2) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto* f = static_cast<const unsigned*>(frontier);
  const auto* l = static_cast<const int*>(left);
  const auto* r = static_cast<const int*>(right);
  auto* x = static_cast<unsigned*>(inter);
  auto* p = static_cast<int*>(pop);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = pair_blocks(Q);
  switch (mode) {
    case 0:
      partial_pairs_kernel<0><<<grid, kThreads, 0, st>>>(f, l, r, x, p, Q, W);
      break;
    case 1:
      partial_pairs_kernel<1><<<grid, kThreads, 0, st>>>(f, l, r, x, p, Q, W);
      break;
    default:
      partial_pairs_kernel<2><<<grid, kThreads, 0, st>>>(f, l, r, x, p, Q, W);
      break;
  }
  return cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
