// Co-occurrence counts of the packed vertical DB (the paper's Phase-2
// triangular matrix):
//
//   C[i, j] = sum_w popcount(B[i, w] & B[j, w])      B: (N, W) 32-bit words
//
// The diagonal holds the item supports; C is symmetric.
//
// Replaces the TPU kernel of src/repro/kernels/trimatrix/trimatrix.py:
// trimatrix_wgmma_kernel <- _kernel, launched by trimatrix().
//
// Bound on the H100: operations.  The input is N*W*4 bytes and the output
// N*N*4, but the function holds N(N+1)/2 * W * 32 bit products (one per
// distinct (i, j) entry, word and bit): at N = 4096, W = 3125 that is
// 8.4e11 products against 118 MB of traffic.  The fastest route the card has
// for them is the int8 tensor-core product of the 0/1 indicator
// (1,979 TOP/s dense on the data sheet, two per product): about 0.85 ms at
// that shape.  The popcount route (one AND + __popc per (i, j, word)) is
// capped by the SM's popcount pipe, 16 results per clock, some 8x slower.
//
// Design: the product runs on the tensor cores as
//   C_tile = D_rows . D_cols^T,   D[i, 32 w + b] = bit b of B[i, w] (0 or 1)
// with wgmma.m64n128k32.s32.u8.u8, int32 accumulators in registers: the
// result is exact (an entry is at most 32 W).  The indicator never exists in
// HBM (it would be 8x the packed input): each block loads the packed words
// of its 128 rows and 128 columns, 8 words (256 K values) of each row per
// stage, into registers and expands them in shared memory, 4 bits at a time
// ((nibble * 0x00204081) & 0x01010101 gives the 4 bytes), straight into the
// K-major, 128-byte-swizzled layout the wgmma descriptors read.  The
// expansion's ordinary stores are handed to wgmma's async proxy with
// fence.proxy.async before the barrier.  Two stages: while the wgmmas of
// stage s run asynchronously on the tensor cores, the same threads expand
// stage s+1 and load the words of stage s+2.  One block of two warpgroups
// per 128 x 128 output tile on or above the diagonal (64 rows each,
// m64n128: 64 accumulators a thread); a diagonal tile expands its rows once
// and reads them as both operands.  Rows past N and words past the block's
// range are expanded as zeros.
//
// Split-K: at small N the triangle has few tiles (N = 187: 3), so the word
// axis is split over blocks (grid.y) as trimatrix.split_plan chooses, to fill
// the 132 SMs; the splits are summed with int32 atomic adds into a zeroed C
// (integer addition is associative, so every order gives the same bits).
// With one split the tile is stored.  Either way the tile goes through
// shared memory, so the store of C[i, j] and of its mirror C[j, i] are both
// coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 128;                       // output tile edge
constexpr int kThreads = 256;                    // two warpgroups of 64 rows
constexpr int kStageWords = 8;                   // words per row per stage
constexpr int kPanelWords = 4;                   // a 128-byte swizzled row
constexpr int kPanels = kStageWords / kPanelWords;
constexpr int kPanelBytes = kTile * 128;         // 128 rows x 128 bytes
constexpr int kOperandBytes = kPanels * kPanelBytes;
constexpr int kStageBytes = 2 * kOperandBytes;   // rows, then columns
constexpr int kSmemBytes = 2 * kStageBytes + 1024;  // + alignment slack
constexpr int kLd = kTile + 1;                   // epilogue tile row stride
constexpr int kLoads = 2 * kTile / (kThreads / kStageWords);  // rows per thread: 8

static_assert(kTile * kLd * 4 <= 2 * kStageBytes, "epilogue tile must fit");

// d (64 x 128, s32) += A (64 x 32 u8, shared, K-major) . B (128 x 32 u8,
// shared, K-major)^T
__device__ __forceinline__ void wgmma_u8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// bits 4k .. 4k+3 of w as four bytes of 0 or 1, bit 4k in the lowest
__device__ __forceinline__ uint32_t expand_nibble(uint32_t w, int k) {
  return (((w >> (4 * k)) & 0xFu) * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads, 1)
trimatrix_wgmma_kernel(const unsigned* __restrict__ B, int* __restrict__ C, int N,
                       int W, int T, int split_words, int accumulate) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  // tile (ti, tj), ti <= tj: blockIdx.x counts the upper triangle row by row
  int t = blockIdx.x, ti = 0;
  while (t >= T - ti) {
    t -= T - ti;
    ++ti;
  }
  const int tj = ti + t;
  const bool diag = ti == tj;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const int w_begin = blockIdx.y * split_words;
  const int w_end = min(W, w_begin + split_words);
  const int n_stages = (w_end - w_begin + kStageWords - 1) / kStageWords;

  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  // this thread loads word kw of each stage for rows rsub + 32 i of the row
  // tile (i < 4) and of the column tile (i >= 4)
  const int kw = tid % kStageWords;
  const int rsub = tid / kStageWords;
  const int n_load = diag ? kLoads / 2 : kLoads;
  // the expanded word's two 16-byte chunks in its 128-byte swizzled row;
  // threads of the second panel store their halves in the other order, so
  // the 8 threads of a quarter warp hit 8 distinct chunks
  const int panel = kw / kPanelWords;
  const int chunk = (2 * (kw % kPanelWords) + panel) ^ (rsub % 8);

  unsigned words[kLoads];
  auto load = [&](int s) {
    const int w = w_begin + s * kStageWords + kw;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      if (i < n_load) {
        const int g = (i < kLoads / 2 ? i0 : j0) + rsub + 32 * (i % (kLoads / 2));
        words[i] = (w < w_end && g < N) ? __ldg(B + static_cast<long long>(g) * W + w) : 0u;
      }
    }
  };
  auto expand = [&](int stage) {
    uint8_t* base = smem + stage * kStageBytes + panel * kPanelBytes;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      if (i < n_load) {
        const int r = rsub + 32 * (i % (kLoads / 2));
        uint8_t* row = base + (i < kLoads / 2 ? 0 : kOperandBytes) + r * 128;
        const uint32_t w = words[i];
        const uint4 lo = make_uint4(expand_nibble(w, 0), expand_nibble(w, 1),
                                    expand_nibble(w, 2), expand_nibble(w, 3));
        const uint4 hi = make_uint4(expand_nibble(w, 4), expand_nibble(w, 5),
                                    expand_nibble(w, 6), expand_nibble(w, 7));
        *reinterpret_cast<uint4*>(row + chunk * 16) = panel ? hi : lo;
        *reinterpret_cast<uint4*>(row + (chunk ^ 1) * 16) = panel ? lo : hi;
      }
    }
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  load(0);
  expand(0);
  fence_proxy_async_smem();
  if (n_stages > 1) load(1);
  __syncthreads();

  for (int s = 0; s < n_stages; ++s) {
    const uint8_t* st = smem + (s % 2) * kStageBytes;
    const uint8_t* a = st + wgi * 64 * 128;  // this warpgroup's 64 rows
    const uint8_t* b = diag ? st : st + kOperandBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int off = p * kPanelBytes + kk * 32;
        wgmma_u8_n128(acc, desc(a + off, 16, 1024), desc(b + off, 16, 1024));
      }
    wgmma_commit();
    if (s + 1 < n_stages) {
      expand((s + 1) % 2);
      fence_proxy_async_smem();
      if (s + 2 < n_stages) load(s + 2);
    }
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();
  }

  // the tile through shared memory: the stage buffers are free now
  int* S = reinterpret_cast<int*>(smem);
  const int lane = tid % 32;
  const int row0 = 64 * wgi + 16 * ((tid % 128) / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    S[row0 * kLd + col] = acc[4 * j];
    S[row0 * kLd + col + 1] = acc[4 * j + 1];
    S[(row0 + 8) * kLd + col] = acc[4 * j + 2];
    S[(row0 + 8) * kLd + col + 1] = acc[4 * j + 3];
  }
  __syncthreads();
  // C[i0 + r, j0 + c], consecutive threads on consecutive columns
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, c = e % kTile;
    const int gi = i0 + r, gj = j0 + c;
    if (gi < N && gj < N) {
      int* dst = C + static_cast<long long>(gi) * N + gj;
      const int v = S[r * kLd + c];
      if (accumulate) atomicAdd(dst, v); else *dst = v;
    }
  }
  if (diag) return;
  // the mirror C[j0 + c, i0 + r], consecutive threads on consecutive r
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int c = e / kTile, r = e % kTile;
    const int gi = j0 + c, gj = i0 + r;
    if (gi < N && gj < N) {
      int* dst = C + static_cast<long long>(gi) * N + gj;
      const int v = S[r * kLd + c];
      if (accumulate) atomicAdd(dst, v); else *dst = v;
    }
  }
}

}  // namespace

extern "C" {

// Output tile edge and words per stage, for the binding's split plan.
int trimatrix_tile() { return kTile; }
int trimatrix_stage_words() { return kStageWords; }

// B: (N, W) words, C: (N, N) int32.  The word axis is cut into `splits`
// ranges of `split_words` words (the last may be shorter, none empty); with
// splits > 1 the caller passes C zeroed and the ranges' counts are added
// into it.  Returns a cudaError_t.
int trimatrix_launch(const void* B, void* C, int N, int W, int splits, int split_words,
                     int device, void* stream) {
  if (N <= 0) return cudaSuccess;
  if (W < 0 || splits < 1 || splits > 65535 || split_words < 1 ||
      static_cast<long long>(splits - 1) * split_words >= (W > 0 ? W : 1) ||
      static_cast<long long>(splits) * split_words < W)
    return cudaErrorInvalidValue;
  const long long T = (N + kTile - 1) / kTile;
  const long long tiles = T * (T + 1) / 2;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(trimatrix_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(splits));
  trimatrix_wgmma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(B), static_cast<int*>(C), N, W, static_cast<int>(T),
      split_words, splits > 1 ? 1 : 0);
  return cudaGetLastError();
}

}  // extern "C"
