// Pieces shared by K6's float32 kernels on the CUDA cores, the forward
// (flash_attention.cu, namespace f32) and the backward
// (flash_attention_bwd.cu, the FMA path of namespace bwd): the swizzle of
// their shared-memory tiles, the k tiles a q tile keeps, the tile copies by
// cp.async and the once-per-device grant of dynamic shared memory.  Header
// only; every function is inlined into its caller.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace f32attn {

// Position of 16-byte chunk c of row `row` in a tile of kCpr chunks a row:
// c XOR (row / 4), over as many bits as a 128-byte bank line holds chunks.
// The kernels' threads own runs of 4 rows (or keys); a warp's 16-byte loads
// then touch 8 different bank groups where they do not broadcast.
template <int kCpr>
__device__ __forceinline__ int swz(int row, int c) {
  constexpr int kMask = (kCpr < 8 ? kCpr : 8) - 1;
  return c ^ ((row >> 2) & kMask);
}

// The instance for head size D: the next of 16, 32, 64, 128, 256 at or
// above it
__host__ __device__ __forceinline__ int instance_d(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// The k tiles of bk keys that q tile qt (rows qt * bq ... + bq - 1, those
// < S) keeps some pair of: [tile_lo, tile_hi].  Causal: keys <= the tile's
// last row; window: keys > the tile's first row - window.  Both bounds are
// non-decreasing in qt, so the q tiles that keep one k tile are a range.
__host__ __device__ __forceinline__ int tile_lo(int qt, int bq, int bk, int window) {
  const int first = qt * bq - window + 1;
  return window > 0 && first > 0 ? first / bk : 0;
}

__host__ __device__ __forceinline__ int tile_hi(int qt, int bq, int bk, int S, int Sk,
                                                int causal) {
  const int last_tile = (Sk + bk - 1) / bk - 1;
  if (!causal) return last_tile;
  const int last_row = qt * bq + bq - 1 < S - 1 ? qt * bq + bq - 1 : S - 1;
  return last_row / bk < last_tile ? last_row / bk : last_tile;
}

// kept 64 x 64 (q, k) tiles of one head before q tile qt, in q-tile order:
// the backward's float32 scratch holds one P and one dS tile for each
__host__ __device__ __forceinline__ long long tiles_before(int qt, int S, int Sk, int causal,
                                                           int window) {
  long long n = 0;
  for (int t = 0; t < qt; ++t)
    n += tile_hi(t, 64, 64, S, Sk, causal) - tile_lo(t, 64, 64, window) + 1;
  return n;
}

// kRows rows x kCols float32 columns, from row row0 and column col0 of a
// (rows, D) source with row stride `stride` (elements), into a tile of kCols
// floats a row, swizzled (kSwz) or not; rows >= rows and columns >= D are
// zero-filled by the copy itself.  kThreads threads share the copies.
template <int kRows, int kCols, int kThreads, bool kSwz>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride,
                                          int row0, int rows, int col0, int D) {
  constexpr int kCpr = kCols / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < kRows * kCpr; i += kThreads) {
    const int r = i / kCpr;
    const int c = i % kCpr;
    const bool ok = row0 + r < rows && col0 + 4 * c < D;
    const float* s = ok ? src + static_cast<long long>(row0 + r) * stride + col0 + 4 * c : src;
    hopper::cp_async16_zfill(dst + r * kCols + 4 * (kSwz ? swz<kCpr>(r, c) : c), s, ok);
  }
}

// cudaFuncSetAttribute(kKernel, max dynamic shared memory, bytes) once per
// device (devices 0-63; above, at every call); a cheap runtime call, kept off
// the launch path all the same
template <auto kKernel>
inline cudaError_t allow_smem(int bytes) {
  static std::atomic<uint64_t> granted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (granted.load(std::memory_order_acquire) & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && bit != 0) granted.fetch_or(bit, std::memory_order_release);
  return err;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float s, float4 x, float4& y) {
  y.x = fmaf(s, x.x, y.x);
  y.y = fmaf(s, x.y, y.y);
  y.z = fmaf(s, x.z, y.z);
  y.w = fmaf(s, x.w, y.w);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ bool kept(int i, int j, int S, int Sk, int causal, int window) {
  return i < S && j < Sk && (!causal || j <= i) && (window <= 0 || j > i - window);
}

}  // namespace f32attn
