// Fused gather + AND/ANDNOT + popcount + min-support threshold, and the
// survivor compaction behind it: the level-expansion hot loop of the miner.
//
// Replaces the TPU kernels of src/repro/kernels/fused_intersect/fused_intersect.py:
//   fused_pairs_kernel      <- _kernel, launched by _fused_pairs_call
//                              (fused_intersect_pairs)
//   survivor_count_kernel,  <- the compact_epilogue that
//   survivor_scatter_kernel,   fused_intersect_compact_pairs appends
//   gather_survivors_kernel
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
// Design: one warp per pair (8 pairs per 256-thread block).  Lanes stride
// the row word by word, so each load and store instruction of a warp touches
// 128 contiguous bytes whatever the row alignment (W = 3125 rows are not
// 16-byte aligned, so no vector loads), and four words per lane are loaded
// before any is used to keep eight loads in flight per lane.  The popcount
// is reduced with warp shuffles; no shared memory, no atomics.  The
// threshold is a runtime argument, so sweeping min_sup builds nothing new.
//
// The compacting path never writes the (Q, W) intersection of pairs that do
// not survive.  fused_pairs_kernel runs with inter == nullptr and produces
// only sup and mask; survivor_count_kernel and survivor_scatter_kernel (a
// two-pass scan, one block per tile of 4,096 flags) turn the mask into
// ascending survivor indices and their count S on the device; and
// gather_survivors_kernel recomputes row r from pair sel[r] (r < S) or from
// pair 0 (r >= S: the pad rows duplicate the intersection of pair 0, as in
// the reference).  Nothing returns to the host in between, so the caller
// reads the mask once, after all four launches.
//
// Row offsets are 64-bit: q * W passes 2^31 at Q ~ 700k for W = 3125.
// left[q] and right[q] must lie in [0, P): the engine checks its pair lists
// on the host before upload.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPairsPerBlock = 8;
constexpr int kThreads = kPairsPerBlock * kWarp;
constexpr int kUnroll = 4;
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / kWarp;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;

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

// The survivor scan runs in two passes over tiles of kScanTile flags, one
// block per tile.  A flag is mask[q] & (q < n_valid).
//   survivor_count_kernel:   count[b] = number of flags set in tile b
//   survivor_scatter_kernel: offset = count[0] + ... + count[b-1]; thread t
//     owns kScanItems consecutive flags of the tile, and a block-wide
//     exclusive scan of the per-thread counts (warp shuffles, then one warp
//     over the warp totals) gives each thread its first output slot.  It
//     rewrites mask[q] to the flag, writes sel[offset ..] and, in the last
//     block, S.
__device__ __forceinline__ int survivor_flags(const int* __restrict__ mask,
                                              long long start, long long Q,
                                              long long n_valid,
                                              unsigned* flags) {
  int count = 0;
  unsigned f = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const long long q = start + i;
    const int m = (q < Q && q < n_valid && mask[q] != 0) ? 1 : 0;
    f |= static_cast<unsigned>(m) << i;
    count += m;
  }
  *flags = f;
  return count;
}

__global__ void __launch_bounds__(kScanThreads)
survivor_count_kernel(const int* __restrict__ mask, long long Q,
                      long long n_valid, int* __restrict__ tile_count) {
  __shared__ int warp_sum[kScanWarps];
  const int tid = threadIdx.x;
  const long long start = static_cast<long long>(blockIdx.x) * kScanTile +
                          static_cast<long long>(tid) * kScanItems;
  unsigned flags;
  int c = survivor_flags(mask, start, Q, n_valid, &flags);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  if (tid % kWarp == 0) warp_sum[tid / kWarp] = c;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kScanWarps; ++w) total += warp_sum[w];
    tile_count[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kScanThreads)
survivor_scatter_kernel(int* __restrict__ mask, long long Q, long long n_valid,
                        const int* __restrict__ tile_count,
                        int* __restrict__ sel, int* __restrict__ n_surv) {
  __shared__ int warp_base[kScanWarps];
  __shared__ int tile_offset;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  // survivors in the tiles before this one
  if (warp == 0) {
    int s = 0;
    for (int b = lane; b < static_cast<int>(blockIdx.x); b += kWarp) s += tile_count[b];
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) tile_offset = s;
  }
  const long long start = static_cast<long long>(blockIdx.x) * kScanTile +
                          static_cast<long long>(tid) * kScanItems;
  unsigned flags;
  const int count = survivor_flags(mask, start, Q, n_valid, &flags);
  int incl = count;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == kWarp - 1) warp_base[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int total = lane < kScanWarps ? warp_base[lane] : 0;
    int s = total;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    if (lane < kScanWarps) warp_base[lane] = s - total;
    if (lane == kWarp - 1 && blockIdx.x == gridDim.x - 1) *n_surv = tile_offset + s;
  }
  __syncthreads();
  int pos = tile_offset + warp_base[warp] + incl - count;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const long long q = start + i;
    if (q < Q) {
      const int m = (flags >> i) & 1u;
      mask[q] = m;
      if (m) sel[pos++] = static_cast<int>(q);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gather_survivors_kernel(const unsigned* __restrict__ frontier,
                        const int* __restrict__ left,
                        const int* __restrict__ right,
                        const int* __restrict__ sel,
                        const int* __restrict__ n_surv,
                        unsigned* __restrict__ out,
                        long long Q, int W) {
  const long long r = static_cast<long long>(blockIdx.x) * kPairsPerBlock +
                      threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (r >= Q) return;
  const long long q = r < *n_surv ? sel[r] : 0;
  const unsigned* a = frontier + static_cast<long long>(left[q]) * W;
  const unsigned* b = frontier + static_cast<long long>(right[q]) * W;
  intersect_row<MODE>(a, b, out + r * W, W, lane);
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

// Ints of scratch survivor_compact_launch needs: Q survivor slots plus one
// count per scan tile.
long long survivor_scratch_ints(long long Q) {
  return Q + (Q + kScanTile - 1) / kScanTile;
}

// mask (from fused_pairs_launch) is rewritten in place to the valid-masked
// survivor flags; scratch holds survivor_scratch_ints(Q) ints; n_surv one
// int; out (Q, W).  Returns a cudaError_t.
int survivor_compact_launch(const void* frontier, const void* left,
                            const void* right, void* mask, void* scratch,
                            void* n_surv, void* out, long long Q, int W,
                            long long n_valid, int mode, int device,
                            void* stream) {
  if (Q <= 0) return cudaSuccess;
  if (mode < 0 || mode > 2) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<int*>(mask);
  auto* sel = static_cast<int*>(scratch);
  auto* tile_count = sel + Q;
  auto* n_i = static_cast<int*>(n_surv);
  const auto tiles = static_cast<unsigned>((Q + kScanTile - 1) / kScanTile);
  survivor_count_kernel<<<tiles, kScanThreads, 0, st>>>(m, Q, n_valid, tile_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  survivor_scatter_kernel<<<tiles, kScanThreads, 0, st>>>(m, Q, n_valid, tile_count,
                                                          sel, n_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto* f = static_cast<const unsigned*>(frontier);
  const auto* l = static_cast<const int*>(left);
  const auto* r = static_cast<const int*>(right);
  auto* o = static_cast<unsigned*>(out);
  const unsigned grid = pair_blocks(Q);
  switch (mode) {
    case 0:
      gather_survivors_kernel<0><<<grid, kThreads, 0, st>>>(f, l, r, sel, n_i, o, Q, W);
      break;
    case 1:
      gather_survivors_kernel<1><<<grid, kThreads, 0, st>>>(f, l, r, sel, n_i, o, Q, W);
      break;
    default:
      gather_survivors_kernel<2><<<grid, kThreads, 0, st>>>(f, l, r, sel, n_i, o, Q, W);
      break;
  }
  return cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
