// Online-softmax (flash) attention forward, causal and/or sliding window,
// GQA by head map:
//
//   out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] * scale) v[b, h / G, j]
//
// over the columns j < S that the masks keep (j <= i when causal,
// j > i - window when window > 0), fp32 arithmetic throughout, the output
// written in the inputs' type.  q, k, v and out are addressed by strides
// (the head dimension contiguous), so the model's (B, S, H, D) activations
// are read and written in place, without a transpose.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention/
// flash_attention.py: _kernel, launched by flash_attention().
//
// Bound on the H100 at gemma3-4b's prefill (B = 2, H = 8, Hkv = 4,
// D = 256, S = 2,048): operations.  A causal global layer holds
// 4 B H D S (S + 1) / 2 = 34 GFLOP, 0.035 ms at the dense bf16 tensor-core
// rate (989 TFLOP/s); its q, k, v and out are 25 MB, 0.0075 ms at
// 3.35 TB/s.  This kernel computes in fp32 on the CUDA cores, as the
// reference computes in fp32 (q, k and v cast to f32, the probabilities kept
// in f32 into the PV product): its own ceiling is the fp32 FMA rate
// (67 TFLOP/s on the data sheet), some 15x above the tensor-core bound.
// A bf16 tensor-core (wgmma) version is later work.
//
// Design: one block of 256 threads per (b, h, 64-row q tile); the TPU's
// sequential k-tile grid axis becomes a loop inside the block over 32-row
// k tiles, with the running max, normaliser and the 64 x D fp32 accumulator
// per query row.  At D = 256 the accumulator is 64 KB: it lives in
// registers, 64 floats per thread (2 rows x 32 columns), and the q tile and
// the k and v tiles (converted to fp32) in 140 KB of dynamic shared memory,
// one block per SM.  k tiles that every row of the q tile masks out (above
// the diagonal, or wholly before the window) are skipped: they add nothing.
// Score reads of k and value reads of v are float4 loads that are free of
// bank conflicts (rows padded by 4 floats).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // key rows per k tile
constexpr int kThreads = 256;  // 32 row groups x 8 column lanes
constexpr int kPLd = kBK + 8;  // P tile row stride: conflict-free writes
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

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// rows x kD elements (strided rows, D valid columns) -> fp32 shared tile
// with row stride kD + 4; rows at or past S and columns at or past D are 0.
template <typename T, int kD, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int S, int D) {
  constexpr int kLd = kD + 4;
  constexpr int kChunks = kRows * kD / 8;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (kD / 8);
    const int col = (c % (kD / 8)) * 8;
    float vals[8];
    if (row0 + r < S && col < D) {
      load8(src + static_cast<long long>(row0 + r) * row_stride + col, vals);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = 0.f;
    }
    float* d = dst + r * kLd + col;
    *reinterpret_cast<float4*>(d) = make_float4(vals[0], vals[1], vals[2], vals[3]);
    *reinterpret_cast<float4*>(d + 4) = make_float4(vals[4], vals[5], vals[6], vals[7]);
  }
}

template <int kD>
constexpr int smem_bytes() {
  return ((kBQ + 2 * kBK) * (kD + 4) + kBQ * kPLd) * static_cast<int>(sizeof(float));
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int group, int S, int D, long long qsb, long long qsh,
                       long long qss, long long ksb, long long ksh,
                       long long kss, long long vsb, long long vsh,
                       long long vss, long long osb, long long osh,
                       long long oss, float sm_scale, int causal, int window) {
  constexpr int kLd = kD + 4;
  constexpr int kChunksPerRow = kD / 32;  // float4 output chunks per thread row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kLd;
  float* Vs = Ks + kBK * kLd;
  float* Ps = Vs + kBK * kLd;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  T* ob = o + b * osb + h * osh;

  const int tx = threadIdx.x % 8;   // column lane
  const int ty = threadIdx.x / 8;   // rows ty and ty + 32

  load_tile<T, kD, kBQ>(Qs, qb, qss, q0, S, D);

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float4 acc[2][kChunksPerRow];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < kChunksPerRow; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // k tiles that some row of this q tile can see
  int k_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;   // first column row q0 keeps
    k_begin = lo > 0 ? (lo / kBK) * kBK : 0;
  }
  int k_end = S;
  if (causal) k_end = min(S, q0 + kBQ);

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, kD, kBK>(Ks, kb, kss, k0, S, D);
    load_tile<T, kD, kBK>(Vs, vb, vss, k0, S, D);
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      float4 qa[2], kv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 32 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + ty + 32 * i;
      bool keep[4];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 8 * j;
        keep[j] = col < S && (!causal || col <= row) &&
                  (window <= 0 || col > row - window);
        s[i][j] = keep[j] ? s[i][j] * sm_scale : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 8 lanes of one row are consecutive: reduce within them
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        Ps[(ty + 32 * i) * kPLd + tx + 8 * j] = p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kChunksPerRow; ++c) {
        acc[i][c].x *= alpha; acc[i][c].y *= alpha;
        acc[i][c].z *= alpha; acc[i][c].w *= alpha;
      }
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float p0 = Ps[ty * kPLd + kk];
      const float p1 = Ps[(ty + 32) * kPLd + kk];
#pragma unroll
      for (int c = 0; c < kChunksPerRow; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + kk * kLd + tx * 4 + 32 * c);
        acc[0][c].x = fmaf(p0, vv.x, acc[0][c].x);
        acc[0][c].y = fmaf(p0, vv.y, acc[0][c].y);
        acc[0][c].z = fmaf(p0, vv.z, acc[0][c].z);
        acc[0][c].w = fmaf(p0, vv.w, acc[0][c].w);
        acc[1][c].x = fmaf(p1, vv.x, acc[1][c].x);
        acc[1][c].y = fmaf(p1, vv.y, acc[1][c].y);
        acc[1][c].z = fmaf(p1, vv.z, acc[1][c].z);
        acc[1][c].w = fmaf(p1, vv.w, acc[1][c].w);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 32 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kChunksPerRow; ++c) {
      const int col = tx * 4 + 32 * c;
      if (col < D) {
        store4(ob + static_cast<long long>(row) * oss + col,
               make_float4(acc[i][c].x * inv, acc[i][c].y * inv,
                           acc[i][c].z * inv, acc[i][c].w * inv));
      }
    }
  }
}

template <typename T, int kD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int group, int S, int D,
                   const long long* st, float sm_scale, int causal,
                   int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<kD>();
  // above 48 KB, dynamic shared memory must be granted per kernel (and
  // per device, so it is set at every launch: a cheap driver call)
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, kD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, group, S, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], sm_scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int group, int S, int D,
                       const long long* st, float sm_scale, int causal,
                       int window, cudaStream_t stream) {
  // the ported configs' head sizes: 16 (reduced) and 256 (gemma3-4b,
  // gemma-2b); any other D runs zero-padded in the next size up
  if (D <= 32) return launch<T, 32>(q, k, v, o, B, H, group, S, D, st, sm_scale, causal, window, stream);
  return launch<T, 256>(q, k, v, o, B, H, group, S, D, st, sm_scale, causal, window, stream);
}

}  // namespace

extern "C" {

// q, out: (B, H, S, D) and k, v: (B, Hkv, S, D), each addressed by the
// strides in `strides` (elements; b, h, s for q, k, v, out in that order)
// with D contiguous.  dtype 0 = float32, 1 = bfloat16.  D a multiple of 8
// up to 256; window 0 = no window.  Returns a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int Hkv, int S,
                           int D, const long long* strides, float sm_scale,
                           int causal, int window, int device, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = H / Hkv;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, H, group, S, D, strides, sm_scale, causal, window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, group, S, D, strides, sm_scale, causal, window, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
