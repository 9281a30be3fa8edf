// Grouped-query decode attention over a KV cache: one new token per
// sequence, all G query heads of a KV head against the valid rows of the
// cache,
//
//   out[b, kh, g] = sum_s softmax_s(q[b, kh, g] . k[b, s, kh] * scale) v[b, s, kh]
//
// over the rows s < length[b] (and s > length[b] - 1 - window when
// window > 0), fp32 arithmetic, the output in the query's type.  The cache
// is (B, S, KV, D), addressed by strides with D contiguous, and length
// stays on the card: the kernel reads it.
//
// Replaces the TPU kernel of src/repro/kernels/decode_attention/
// decode_attention.py: _kernel, launched by decode_attention().
//
// Bound on the H100: bytes.  At gemma3-4b's decode (B = 2, KV = 4, G = 2,
// D = 256, bf16) every valid cache row of k and v is read once per step,
// 2 B len KV D 2 bytes: 8.5 MB at len = 2,080, 2.5 us at 3.35 TB/s, against
// 4 B KV G D len = 17 MFLOP of arithmetic.  In practice a launch costs more
// than that bound.
//
// Design: one block of 256 threads per (b, KV head), holding all G query
// heads of the group, so each cache byte is read once per group, which is
// the point of the Pallas kernel.  The block streams the valid rows
// [start, length) in tiles of 64, eight rows per warp, each lane loading
// 16 bytes of a row along D: a score is a warp-wide dot product and a
// shuffle reduction, the online-softmax update of each head is done by one
// warp over the tile's 64 scores, and each warp accumulates its rows' share
// of p V in registers, rescaled once per tile.  The eight warps' partial
// sums are combined in a fixed order, so the result is the same from run to
// run.  Rows past length (the Pallas kernel reads the whole padded cache)
// and rows before the window are never read: they add nothing.  At B = 2,
// KV = 4 the grid has 8 blocks for 132 SMs: right, and far from its bound;
// a split over S with a combine pass is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTile = kWarps * kRowsPerWarp;  // 64 cache rows per tile
constexpr int kMaxD = 256;                    // 32 lanes x 8 elements
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ length,
                        T* __restrict__ out, int KV, int S, int D,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh,
                        float sm_scale, int window) {
  __shared__ float s_p[kG][kTile];     // scores, then probabilities
  __shared__ float s_m[kG], s_l[kG], s_alpha[kG];
  __shared__ float s_acc[kG][kMaxD];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane * 8;
  const bool active = d0 < D;          // D is a multiple of 8

  int len = length[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int start = (window > 0 && len - window > 0) ? len - window : 0;

  for (int i = threadIdx.x; i < kG * kMaxD; i += kThreads)
    (&s_acc[0][0])[i] = 0.f;
  if (threadIdx.x < kG) {
    s_m[threadIdx.x] = kNegInf;
    s_l[threadIdx.x] = 0.f;
  }

  float qf[kG][8];
  const T* qb = q + (static_cast<long long>(b) * KV + kh) * kG * D;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (active) {
      load8(qb + g * D + d0, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[g][e] = 0.f;
    }
  }
  float acc[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;

  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;
  __syncthreads();

  for (int t0 = start; t0 < len; t0 += kTile) {
    const int r0 = t0 + warp * kRowsPerWarp;
    // scores of this warp's eight rows, all loads issued first
    float kf[kRowsPerWarp][8];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (active && r0 + i < len) {
        load8(kb + static_cast<long long>(r0 + i) * kss + d0, kf[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[i][e] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qf[g][e], kf[i][e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (lane == 0)
          s_p[g][warp * kRowsPerWarp + i] = r0 + i < len ? dot * sm_scale : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax update, one warp per query head
    for (int g = warp; g < kG; g += kWarps) {
      const bool ok0 = t0 + lane < len;
      const bool ok1 = t0 + lane + 32 < len;
      const float s0 = s_p[g][lane];
      const float s1 = s_p[g][lane + 32];
      float tmax = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, tmax);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      float psum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      s_p[g][lane] = p0;
      s_p[g][lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + psum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // this warp's rows of p V
    float vf[kRowsPerWarp][8];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (active && r0 + i < len) {
        load8(vb + static_cast<long long>(r0 + i) * vss + d0, vf[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) vf[i][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float alpha = s_alpha[g];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = s_p[g][warp * kRowsPerWarp + i];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[i][e], acc[g][e]);
      }
    }
    __syncthreads();  // s_p and s_alpha are rewritten by the next tile
  }

  // combine the warps' partial sums in a fixed order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && active) {
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) s_acc[g][d0 + e] += acc[g][e];
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<long long>(b) * KV + kh) * kG * D;
  for (int i = threadIdx.x; i < kG * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    store1(ob + i, s_acc[g][d] / fmaxf(s_l[g], 1e-30f));
  }
}

template <typename T, int kG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* length, void* out, int B, int KV, int S, int D,
                   const long long* st, float sm_scale, int window,
                   cudaStream_t stream) {
  const dim3 grid(KV, B);
  decode_attention_kernel<T, kG><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, static_cast<T*>(out), KV, S, D,
      st[0], st[1], st[2], st[3], st[4], st[5], sm_scale, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_g(const void* q, const void* k, const void* v,
                       const int* length, void* out, int B, int KV, int G,
                       int S, int D, const long long* st, float sm_scale,
                       int window, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, 1>(q, k, v, length, out, B, KV, S, D, st, sm_scale, window, stream);
    case 2: return launch<T, 2>(q, k, v, length, out, B, KV, S, D, st, sm_scale, window, stream);
    case 4: return launch<T, 4>(q, k, v, length, out, B, KV, S, D, st, sm_scale, window, stream);
    case 8: return launch<T, 8>(q, k, v, length, out, B, KV, S, D, st, sm_scale, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out: (B, KV, G, D) contiguous; k, v: (B, S, KV, D) addressed by
// `strides` (elements; b, s, kv for k then v) with D contiguous; length:
// (B,) int32 on the card.  dtype 0 = float32, 1 = bfloat16.  G in
// {1, 2, 4, 8}; D a multiple of 8 up to 256; window 0 = no window.
// Returns a cudaError_t.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* length, void* out, int dtype, int B,
                            int KV, int G, int S, int D,
                            const long long* strides, float sm_scale,
                            int window, int device, void* stream) {
  if (B <= 0 || KV <= 0) return cudaSuccess;
  if (D <= 0 || D > kMaxD || D % 8 != 0 || B > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  if (dtype == 0)
    return dispatch_g<float>(q, k, v, len, out, B, KV, G, S, D, strides, sm_scale, window, s);
  if (dtype == 1)
    return dispatch_g<__nv_bfloat16>(q, k, v, len, out, B, KV, G, S, D, strides, sm_scale, window, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
