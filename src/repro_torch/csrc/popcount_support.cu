// Batched tidset intersection and support counting over rows that are
// already gathered: the paper's Algorithm-1 inner loop.
//
// Replaces the TPU kernel of src/repro/kernels/popcount_support/popcount_support.py:
//   popcount_support_kernel <- _kernel, launched by popcount_support
//
// For each row m of two (M, W) word arrays a and b:
//   inter[m, w] = a[m, w] & b[m, w]
//   support[m]  = sum_w popcount(inter[m, w])
// Words are 32-bit; the caller's int32 tensors hold the same bits and are
// read here as unsigned.
//
// Bound on the H100: bytes.  A row reads 8W bytes and writes 4W + 4, and
// does W popcounts, so the work is the memory traffic (3 M W + M) * 4 bytes.
//
// Design: one warp per row (8 rows per 256-thread block), as the fused
// pair kernel.  Lanes stride the row word by word, so each load and store
// instruction of a warp touches 128 contiguous bytes whatever the row
// alignment, with four words per lane loaded before any is used.  The row's
// popcount is reduced with warp shuffles; no shared memory, no atomics.
// Row offsets are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kRowsPerBlock * kWarp;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
popcount_support_kernel(const unsigned* __restrict__ a,
                        const unsigned* __restrict__ b,
                        unsigned* __restrict__ inter,
                        int* __restrict__ support,
                        long long M, int W) {
  const long long m = static_cast<long long>(blockIdx.x) * kRowsPerBlock +
                      threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (m >= M) return;  // m is uniform across the warp: it leaves whole
  const unsigned* ra = a + m * W;
  const unsigned* rb = b + m * W;
  unsigned* out = inter + m * W;
  int pop = 0;
  for (int base = lane; base < W; base += kWarp * kUnroll) {
    unsigned av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = base + u * kWarp;
      av[u] = w < W ? __ldg(ra + w) : 0u;
      bv[u] = w < W ? __ldg(rb + w) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = base + u * kWarp;
      if (w < W) {
        const unsigned x = av[u] & bv[u];
        out[w] = x;
        pop += __popc(x);
      }
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    pop += __shfl_down_sync(0xffffffffu, pop, off);
  if (lane == 0) support[m] = pop;
}

}  // namespace

extern "C" {

// a, b, inter: (M, W) words; support: (M,).  Returns a cudaError_t.
int popcount_support_launch(const void* a, const void* b, void* inter,
                            void* support, long long M, int W, int device,
                            void* stream) {
  if (M <= 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto grid =
      static_cast<unsigned>((M + kRowsPerBlock - 1) / kRowsPerBlock);
  popcount_support_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(a), static_cast<const unsigned*>(b),
      static_cast<unsigned*>(inter), static_cast<int*>(support), M, W);
  return cudaGetLastError();
}

}  // extern "C"
