// Grouped-query decode attention over a KV cache: one new token per
// sequence, all G query heads of a KV head against the valid rows of the
// cache,
//
//   out[b, kh, g] = sum_s softmax_s(c(q[b, kh, g] . k[b, s, kh] * scale)) v[b, s, kh]
//
// over the rows s < length[b] (and s > length[b] - 1 - window when
// window > 0), fp32 arithmetic, the output in the query's type.  c is the
// identity, or with a soft-cap > 0 the logit soft-cap c(x) = cap tanh(x /
// cap) of the reference model's _decode_attend, applied to each score
// before the mask.  G, the query heads of a KV head, is any of 1 to 8.  The cache
// is (B, S, KV, D), addressed by strides with D contiguous, and length
// stays on the card: the kernel reads it.
//
// Replaces the TPU kernel of src/repro/kernels/decode_attention/
// decode_attention.py: _kernel, launched by decode_attention().
//
// Bound on the H100: bytes.  At gemma3-4b's decode (B = 2, KV = 4, G = 2,
// D = 256, bf16) every valid cache row of k and v is read once per step,
// 2 (k and v) B len KV D 2 bytes: 17 MB at len = 2,079, 5.1 us at
// 3.35 TB/s, against 4 B KV G D len = 17 MFLOP of arithmetic.  Reaching
// the bound takes many loads in flight on every SM.
//
// Design: the cache is split over blocks.  The grid is (B KV, n_split),
// n_split = ceil(S / 64) from the cache's capacity, never from length, so
// the launch needs no host round trip: 264 blocks at B = 2, KV = 4,
// S = 2,080, two per SM.  Block (b kh, i) holds all G query heads of its KV
// head, so each cache byte is read once per group (the point of the Pallas
// kernel), and takes the rows of [64 i, 64 i + 64) that lie in
// [start, length).  Its k and v rows arrive as 16-byte cp.async copies in
// two groups, so the v rows are in flight while the scores are computed
// from the k rows: a score is a warp-wide dot product (each lane 8 elements
// of D) and a shuffle reduction, the softmax of each head over the chunk is
// one warp's, and p v is one thread per column of D over the chunk's rows
// in order.  p stays in fp32 into the PV sum (bytes bound this kernel, not
// operations).  The block writes an fp32 partial (m, l, acc[G, D]) to
// scratch; a chunk that lies wholly past length or before the window
// writes m = -inf, l = 0 and reads nothing.  Then it takes a ticket
// (atomicAdd after __threadfence); the last block of its (b, kh) to finish
// merges the n_split partials in split order with a running max (online
// softmax), one thread per column of D; a chunk with l = 0 (no rows) is
// passed over, so no exp(-inf - -inf) is formed.  It writes num / den and
// resets the ticket to 0 for the next launch.  One launch per layer and
// step, and the merge order is fixed, so the result is the same bit for
// bit from run to run.  At the serving shape the kernel is held back by
// that tail after the slowest block (fence, ticket, merge), not by its
// bytes: batching the merge's loads did not change its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kChunk = kWarps * kRowsPerWarp;  // 64 cache rows per block
constexpr int kMaxD = 256;                     // 32 lanes x 8 elements

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// n rows of D elements, row r at src + r * stride, into dst rows of D
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long stride, int n,
                                          int D) {
  constexpr int kPer = 16 / sizeof(T);   // elements per 16-byte copy
  const int per_row = D / kPer;
  for (int c = threadIdx.x; c < n * per_row; c += kThreads) {
    const int r = c / per_row;
    const int col = (c % per_row) * kPer;
    cp_async16(dst + r * D + col, src + r * stride + col);
  }
}

template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ length,
                              T* __restrict__ out, float* __restrict__ part_acc,
                              float* __restrict__ part_ml, int* __restrict__ ticket,
                              int KV, int S, int D, long long ksb, long long kss,
                              long long ksh, long long vsb, long long vss, long long vsh,
                              float sm_scale, float softcap, int window) {
  static_assert(kG >= 1 && kG <= kWarps, "one warp per query head in the softmax");
  extern __shared__ uint4 smem_dyn[];   // k rows, then v rows: kChunk x D each
  T* ks = reinterpret_cast<T*>(smem_dyn);
  T* vs = ks + kChunk * D;
  __shared__ float s_p[kG][kChunk];     // scores, then probabilities
  __shared__ float s_m[kG], s_l[kG];
  __shared__ int s_last;

  const int bk = blockIdx.x;            // b * KV + kh
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int b = bk / KV;
  const int kh = bk % KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane * 8;
  const bool active = d0 < D;           // D is a multiple of 8

  int len = length[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int start = (window > 0 && len - window > 0) ? len - window : 0;
  const int r0 = max(start, split * kChunk);
  const int n = min(len, split * kChunk + kChunk) - r0;   // rows of this chunk

  float* pacc = part_acc + (static_cast<long long>(bk) * n_split + split) * kG * D;
  float* pml = part_ml + (static_cast<long long>(bk) * n_split + split) * kG * 2;
  if (n > 0) {
    copy_rows(ks, k + b * ksb + kh * ksh + r0 * kss, kss, n, D);
    cp_async_commit();
    copy_rows(vs, v + b * vsb + kh * vsh + r0 * vss, vss, n, D);
    cp_async_commit();

    float qf[kG][8];
    const T* qb = q + static_cast<long long>(bk) * kG * D;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (active) {
        load8(qb + g * D + d0, qf[g]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qf[g][e] = 0.f;
      }
    }
    cp_async_wait<1>();                 // the k rows have landed
    __syncthreads();

    // scores of this warp's rows
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      if (r < n) {                      // warp-uniform
        float kf[8];
        if (active) {
          load8(ks + r * D + d0, kf);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qf[g][e], kf[e], dot);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (lane == 0) s_p[g][r] = dot * sm_scale;
        }
      }
    }
    __syncthreads();

    // softmax over the chunk, one warp per query head; the soft-cap is
    // formed here, two rows a lane, rather than by the lane that reduced
    // each score
    for (int g = warp; g < kG; g += kWarps) {
      const bool ok0 = lane < n, ok1 = lane + 32 < n;
      float s0 = ok0 ? s_p[g][lane] : -INFINITY;
      float s1 = ok1 ? s_p[g][lane + 32] : -INFINITY;
      if (softcap > 0.f) {
        if (ok0) s0 = tanhf(s0 / softcap) * softcap;
        if (ok1) s1 = tanhf(s1 / softcap) * softcap;
      }
      float m = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float p0 = ok0 ? expf(s0 - m) : 0.f;   // n > 0: m is finite
      const float p1 = ok1 ? expf(s1 - m) : 0.f;
      float l = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      s_p[g][lane] = p0;
      s_p[g][lane + 32] = p1;
      if (lane == 0) {
        s_m[g] = m;
        s_l[g] = l;
      }
    }
    cp_async_wait<0>();                 // the v rows have landed
    __syncthreads();

    // p v: one thread per column of D, the chunk's rows in order
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float acc[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[g] = 0.f;
      for (int r = 0; r < n; ++r) {
        const float vv = to_float(vs[r * D + d]);
#pragma unroll
        for (int g = 0; g < kG; ++g) acc[g] = fmaf(s_p[g][r], vv, acc[g]);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) pacc[g * D + d] = acc[g];
    }
    if (threadIdx.x < kG) {
      pml[2 * threadIdx.x] = s_m[threadIdx.x];
      pml[2 * threadIdx.x + 1] = s_l[threadIdx.x];
    }
  } else if (threadIdx.x < kG) {
    pml[2 * threadIdx.x] = -INFINITY;
    pml[2 * threadIdx.x + 1] = 0.f;
  }

  // the last block of this (b, kh) to finish merges the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&ticket[bk], 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the (m, l, acc) loads of kBatch chunks are in flight together, 16 / kG
  // rounded down (at most 16 values of each kind a thread, at least one
  // chunk); the last batch is cut at n_split by `in`, so any kBatch >= 1
  // visits every chunk once, in split order.  The acc of a chunk with no
  // rows was never written and is not used
  const float* accb = part_acc + static_cast<long long>(bk) * n_split * kG * D;
  const float* mlb = part_ml + static_cast<long long>(bk) * n_split * kG * 2;
  const int d = threadIdx.x;
  if (d < D) {
    constexpr int kBatch = 16 / kG;     // kG <= 8: 2 to 16
    static_assert(kBatch >= 1, "the merge takes at least one chunk a batch");
    float M[kG], num[kG], den[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      M[g] = -INFINITY;
      num[g] = den[g] = 0.f;
    }
    for (int i0 = 0; i0 < n_split; i0 += kBatch) {
      float mm[kBatch][kG], ll[kBatch][kG], a[kBatch][kG];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const long long i = i0 + u;
          const bool in = i0 + u < n_split;
          mm[u][g] = in ? __ldcg(mlb + (i * kG + g) * 2) : -INFINITY;
          ll[u][g] = in ? __ldcg(mlb + (i * kG + g) * 2 + 1) : 0.f;
          a[u][g] = in ? __ldcg(accb + (i * kG + g) * D + d) : 0.f;
        }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (ll[u][g] > 0.f) {           // then mm is finite
            const float m_new = fmaxf(M[g], mm[u][g]);
            const float c_old = expf(M[g] - m_new);   // 0 while M is -inf
            const float c_new = expf(mm[u][g] - m_new);
            num[g] = fmaf(num[g], c_old, c_new * a[u][g]);
            den[g] = fmaf(den[g], c_old, c_new * ll[u][g]);
            M[g] = m_new;
          }
    }
    T* ob = out + static_cast<long long>(bk) * kG * D;
#pragma unroll
    for (int g = 0; g < kG; ++g) store1(ob + g * D + d, num[g] / fmaxf(den[g], 1e-30f));
  }
  if (threadIdx.x == 0) ticket[bk] = 0;
}

template <typename T, int kG>
cudaError_t launch(const void* q, const void* k, const void* v, const int* length,
                   void* out, float* part_acc, float* part_ml, int* ticket, int B, int KV,
                   int S, int D, const long long* st, float sm_scale, float softcap,
                   int window, cudaStream_t stream) {
  const int bytes = 2 * kChunk * D * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(decode_attention_split_kernel<T, kG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KV, (S + kChunk - 1) / kChunk);
  decode_attention_split_kernel<T, kG><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
      static_cast<T*>(out), part_acc, part_ml, ticket, KV, S, D, st[0], st[1], st[2], st[3],
      st[4], st[5], sm_scale, softcap, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_g(const void* q, const void* k, const void* v, const int* length,
                       void* out, float* pa, float* pm, int* ticket, int B, int KV, int G,
                       int S, int D, const long long* st, float sm_scale, float softcap,
                       int window, cudaStream_t stream) {
#define DECODE_G(g)                                                                          \
  case g:                                                                                    \
    return launch<T, g>(q, k, v, length, out, pa, pm, ticket, B, KV, S, D, st, sm_scale,    \
                        softcap, window, stream);
  switch (G) {
    DECODE_G(1) DECODE_G(2) DECODE_G(3) DECODE_G(4)
    DECODE_G(5) DECODE_G(6) DECODE_G(7) DECODE_G(8)
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_G
}

}  // namespace

extern "C" {

// Cache rows per block (the split of S).
int decode_attention_chunk() { return kChunk; }

// q, out: (B, KV, G, D) contiguous; k, v: (B, S, KV, D) addressed by
// `strides` (elements; b, s, kv for k then v) with D contiguous; length:
// (B,) int32 on the card.  part_acc: (B KV, n_split, G, D) and part_ml:
// (B KV, n_split, G, 2) fp32 scratch, n_split = ceil(S / chunk); ticket:
// (B KV,) int32, zero before the launch and zero after it.  dtype 0 =
// float32, 1 = bfloat16.  G from 1 to 8; D a multiple of 8 up to 256;
// window 0 = no window; softcap 0 = none.  Returns a cudaError_t.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* length, void* out, void* part_acc,
                            void* part_ml, void* ticket, int dtype, int B,
                            int KV, int G, int S, int D,
                            const long long* strides, float sm_scale,
                            float softcap, int window, int device, void* stream) {
  if (B <= 0 || KV <= 0) return cudaSuccess;
  if (D <= 0 || D > kMaxD || D % 8 != 0 || S <= 0 || (S + kChunk - 1) / kChunk > 65535 ||
      !(softcap >= 0.f))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* t = static_cast<int*>(ticket);
  if (dtype == 0)
    return dispatch_g<float>(q, k, v, len, out, pa, pm, t, B, KV, G, S, D, strides, sm_scale,
                             softcap, window, s);
  if (dtype == 1)
    return dispatch_g<__nv_bfloat16>(q, k, v, len, out, pa, pm, t, B, KV, G, S, D, strides,
                                     sm_scale, softcap, window, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
