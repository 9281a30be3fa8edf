// Co-occurrence counts of the packed vertical DB (the paper's Phase-2
// triangular matrix):
//
//   C[i, j] = sum_w popcount(B[i, w] & B[j, w])      B: (N, W) 32-bit words
//
// The diagonal holds the item supports; C is symmetric.
//
// Replaces the TPU kernel of src/repro/kernels/trimatrix/trimatrix.py:
// trimatrix_kernel <- _kernel, launched by trimatrix().
//
// Bound on the H100: operations.  The input is N*W*4 bytes and the output
// N*N*4, but the function holds N(N+1)/2 * W * 32 bit products (one per
// distinct (i, j) entry, word and bit): at N = 4096, W = 3125 that is
// 8.4e11 products against 118 MB of traffic.  The fastest route the card has
// for them is the dense int8 tensor-core product of the unpacked 0/1
// indicator (1,979 TOP/s on the data sheet, two per product): about 0.85 ms
// at that shape.  This kernel takes the packed route instead, one AND and one
// popcount per (i, j, w), and its own ceiling is the SM's integer popcount
// pipe (16 results per clock per SM on compute capability 9.0, a quarter of
// the AND/ADD rate), some 7x slower than the tensor-core bound: the packed
// words keep the input 8x smaller than the indicator and need no unpack, and
// a tensor-core version is later work.
//
// Design: a grid of 64 x 64 output tiles; blocks below the diagonal return
// at once and each block above it also writes its transpose, so every
// distinct entry is computed once.  A block stages 16 words of its 64 rows
// and of its 64 columns in shared memory per step (row-major loads of 64
// contiguous bytes per row), then each of its 256 threads accumulates a
// 4 x 4 block of C in registers: per word, 8 shared-memory loads feed 16
// AND + popcount + add, so the popcount pipe, not shared memory, sets the
// pace.  The TPU kernel's sequential W grid axis with a VMEM accumulator
// becomes this loop over W inside the block.  At small N the grid is short
// of the card (N = 187 gives 6 tiles on or above the diagonal for 132 SMs):
// the kernel is simple and right first, and Phase 2 is a small share of the
// mine's wall time.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kChunk = 16;
constexpr int kSide = 16;                  // threads per tile edge
constexpr int kThreads = kSide * kSide;    // 256
constexpr int kPer = kTile / kSide;        // 4 x 4 outputs per thread

__global__ void __launch_bounds__(kThreads)
trimatrix_kernel(const unsigned* __restrict__ B, int* __restrict__ C, int N,
                 int W) {
  const int ti = blockIdx.y;
  const int tj = blockIdx.x;
  if (tj < ti) return;  // mirrored from block (tj, ti)
  __shared__ unsigned As[kChunk][kTile + 1];
  __shared__ unsigned Bs[kChunk][kTile + 1];
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  int acc[kPer][kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int b = 0; b < kPer; ++b) acc[a][b] = 0;

  for (int k0 = 0; k0 < W; k0 += kChunk) {
#pragma unroll
    for (int l = 0; l < (kTile * kChunk) / kThreads; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      const int r = idx / kChunk;
      const int c = idx % kChunk;
      const int w = k0 + c;
      const int gi = i0 + r;
      const int gj = j0 + r;
      As[c][r] = (gi < N && w < W) ? __ldg(B + static_cast<long long>(gi) * W + w) : 0u;
      Bs[c][r] = (gj < N && w < W) ? __ldg(B + static_cast<long long>(gj) * W + w) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      unsigned av[kPer], bv[kPer];
#pragma unroll
      for (int a = 0; a < kPer; ++a) av[a] = As[c][ty + a * kSide];
#pragma unroll
      for (int b = 0; b < kPer; ++b) bv[b] = Bs[c][tx + b * kSide];
#pragma unroll
      for (int a = 0; a < kPer; ++a)
#pragma unroll
        for (int b = 0; b < kPer; ++b) acc[a][b] += __popc(av[a] & bv[b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int i = i0 + ty + a * kSide;
#pragma unroll
    for (int b = 0; b < kPer; ++b) {
      const int j = j0 + tx + b * kSide;
      if (i < N && j < N) {
        C[static_cast<long long>(i) * N + j] = acc[a][b];
        if (ti != tj) C[static_cast<long long>(j) * N + i] = acc[a][b];
      }
    }
  }
}

}  // namespace

extern "C" {

// B: (N, W) words, C: (N, N) int32.  Returns a cudaError_t.
int trimatrix_launch(const void* B, void* C, int N, int W, int device,
                     void* stream) {
  if (N <= 0) return cudaSuccess;
  const int tiles = (N + kTile - 1) / kTile;
  if (tiles > 65535) return cudaErrorInvalidValue;  // grid.y limit
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, tiles);
  trimatrix_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(B), static_cast<int*>(C), N, W);
  return cudaGetLastError();
}

}  // extern "C"
