// Backward of the flash-attention forward (flash_attention.cu), causal
// and/or sliding window, GQA by head map.  Given q, k, v, the forward's
// output o, the output's gradient do and the forward's row log-sum-exp lse
// (natural log, float32), it computes, over the pairs (i, j) the masks keep
// (as in the forward: j <= i when causal, j > i - window when window > 0),
//
//   P[i, j]  = exp(q_i . k_j * scale - lse_i)        (recomputed, not stored)
//   dV[j]    = sum_{h in group, i} P[i, j] do_i
//   dP[i, j] = do_i . v_j
//   dS[i, j] = P[i, j] (dP[i, j] - delta_i),  delta_i = do_i . o_i
//   dQ[i]    = scale sum_j dS[i, j] k_j
//   dK[j]    = scale sum_{h in group, i} dS[i, j] q_i
//
// in float32 from the inputs' values, the gradients written in the inputs'
// type.  Tensors are addressed by strides (the head dimension contiguous),
// as in the forward; lse and delta are (B, H, S) float32 contiguous.
//
// The reference package has no Pallas backward: it differentiates the plain
// flash_chunked (src/repro/models/attention.py) with XLA
// (jax.value_and_grad in src/repro/training/train_step.py).  These kernels
// compute that gradient on the card behind the forward kernel of
// src/repro/kernels/flash_attention/flash_attention.py (_kernel).
//
// Three kernels, one launch each, in order on the caller's stream:
//
// flash_attention_bwd_delta_kernel: delta = rowsum(do * o), one warp per
//   row.
// flash_attention_bwd_dkdv_kernel: one block per (64-row k tile, KV head,
//   b).  K and V of the tile stay in shared memory; the block loops over
//   the G query heads of its KV head and, for each, over the 32-row q tiles
//   the masks keep, so GQA's (MQA's G = 8) sum over the group is taken
//   inside the block, in registers, in a fixed order.
// flash_attention_bwd_dq_kernel: one block per (64-row q tile, head, b),
//   looping over the 32-row k tiles the masks keep (the forward's tiles).
//
// No atomics: every gradient element is written once by one thread after a
// fixed-order sum, so two runs give the same bits.
//
// This is the simple version: fp32 FMA on the CUDA cores, every tile
// converted to float32 in shared memory.  Bound on the H100 at gemma-2b's
// training layer (B = 4, H = 8, Hkv = 1, S = 1,024, D = 256, causal):
// operations.  Five products of 2 D per kept pair (S recomputed, dV, dP,
// dQ, dK): 10 D x 16.8 M pairs = 43 GFLOP, 0.044 ms at the dense bf16
// tensor-core rate (989 TFLOP/s), against 0.64 ms at the fp32 rate
// (67 TFLOP/s) that bounds these kernels.  Their inputs and outputs are
// 44 MB, 0.013 ms at 3.35 TB/s.  The dK/dV kernel's grid has only
// B x Hkv x S / 64 = 64 blocks at that shape (one wave on 132 SMs), each
// looping over 8 heads: the tensor-core redesign (wgmma, TMA) is later work.
//
// Threads: 256 per block, as 32 row groups x 8 column lanes.  A thread owns
// two rows (ty, ty + 32) of its block's 64-row tile and the float4 columns
// 4 tx + 32 c of each.
//
// Shared memory per block at D = 256 (float32, rows padded to D + 4 floats,
// so the 8 column lanes of a warp read 8 different rows in distinct banks):
//   dK/dV: K, V 2 x 64 x 260 x 4 = 133,120 B; Q, dO 2 x 32 x 260 x 4 =
//          66,560 B; P, dS 2 x 32 x 72 x 4 = 18,432 B; lse, delta 256 B:
//          218,368 B (of 232,448), one block per SM.
//   dQ:    Q, dO 2 x 64 x 260 x 4 = 133,120 B; K, V 2 x 32 x 260 x 4 =
//          66,560 B; dS 64 x 40 x 4 = 10,240 B; lse, delta 512 B:
//          210,432 B, one block per SM.
// Registers per thread (ptxas, sm_90a, D = 256, no spills): dK/dV 252
// (bf16) and 254 (float32), its two 64 x D fp32 accumulators holding 128
// of them, which fits 256 threads at one block per SM; dQ 168; delta 34.
// chip_smoke.py prints the build log's counts for every kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

namespace bwd {

constexpr int kThreads = 256;
constexpr int kKvBK = 64;          // dK/dV: k rows per block
constexpr int kKvBQ = 32;          // dK/dV: q rows per step
constexpr int kPLd = kKvBK + 8;    // dK/dV: P and dS tile row stride
constexpr int kQBQ = 64;           // dQ: q rows per block
constexpr int kQBK = 32;           // dQ: k rows per step
constexpr int kSLd = kQBK + 8;     // dQ: dS tile row stride

struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];  // (b, h, s)
};

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // a bf16 is the top half of its float32
    out[2 * e] = __uint_as_float(w[e] << 16);
    out[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
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

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// kRows x kD elements (strided rows, D valid columns) -> float32 shared
// tile with row stride kD + 4; rows at or past S and columns at or past D
// are 0.
template <int kD, int kRows, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int row0, int S, int D) {
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

// n entries of a (S,) row vector from row0 on; 0 past S
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = row0 + i < S ? src[row0 + i] : 0.f;
}

__device__ __forceinline__ bool kept(int i, int j, int S, int causal, int window) {
  return i < S && j < S && (!causal || j <= i) && (window <= 0 || j > i - window);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                                 float* __restrict__ delta, int H, int S, int D,
                                 long long rows, Strides st) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % H);
  const int b = static_cast<int>(bh / H);
  const T* orow = o + b * st.o[0] + h * st.o[1] + i * st.o[2];
  const T* grow = g + b * st.g[0] + h * st.g[1] + i * st.g[2];
  float acc = 0.f;
  for (int col = lane * 8; col < D; col += 256) {
    float a[8], d[8];
    load8(orow + col, a);
    load8(grow + col, d);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(a[e], d[e], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int kD>
constexpr int dkdv_smem_bytes() {
  return ((2 * kKvBK + 2 * kKvBQ) * (kD + 4) + 2 * kKvBQ * kPLd + 2 * kKvBQ) *
         static_cast<int>(sizeof(float));
}

template <int kD, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ g,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv, int H, int group, int S,
                                int D, Strides st, float sm_scale, int causal, int window) {
  constexpr int kLd = kD + 4;
  constexpr int kChunks = kD / 32;  // float4 columns per thread row
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kKvBK * kLd;
  float* Qs = Vs + kKvBK * kLd;
  float* Gs = Qs + kKvBQ * kLd;
  float* Ps = Gs + kKvBQ * kLd;
  float* dSs = Ps + kKvBQ * kPLd;
  float* lse_s = dSs + kKvBQ * kPLd;
  float* delta_s = lse_s + kKvBQ;

  const int k0 = blockIdx.x * kKvBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 8;
  const int ty = threadIdx.x / 8;

  load_tile<kD, kKvBK>(Ks, k + b * st.k[0] + hk * st.k[1], st.k[2], k0, S, D);
  load_tile<kD, kKvBK>(Vs, v + b * st.v[0] + hk * st.v[1], st.v[2], k0, S, D);

  float4 dk_acc[2][kChunks], dv_acc[2][kChunks];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      dk_acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv_acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  // q rows that keep some column of [k0, k0 + 64): i >= k0 when causal,
  // i < k_last + window with a window
  const int q_begin = causal ? (k0 / kKvBQ) * kKvBQ : 0;
  const int q_end = window > 0 ? min(S, k0 + kKvBK - 1 + window) : S;

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const T* qb = q + b * st.q[0] + h * st.q[1];
    const T* gb = g + b * st.g[0] + h * st.g[1];
    const float* lb = lse + (static_cast<long long>(b) * H + h) * S;
    const float* db = delta + (static_cast<long long>(b) * H + h) * S;
    for (int q0 = q_begin; q0 < q_end; q0 += kKvBQ) {
      __syncthreads();  // the previous step's Q, dO, P and dS are consumed
      load_tile<kD, kKvBQ>(Qs, qb, st.q[2], q0, S, D);
      load_tile<kD, kKvBQ>(Gs, gb, st.g[2], q0, S, D);
      load_rows(lse_s, lb, q0, kKvBQ, S);
      load_rows(delta_s, db, q0, kKvBQ, S);
      __syncthreads();

      // S = Q K^T and dP = dO V^T at q row ty, k columns tx + 8 j
      float s[8], dp[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < kD; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(Qs + ty * kLd + d);
        const float4 ga = *reinterpret_cast<const float4*>(Gs + ty * kLd + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j] = dot4(qa, *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * kLd + d), s[j]);
          dp[j] = dot4(ga, *reinterpret_cast<const float4*>(Vs + (tx + 8 * j) * kLd + d), dp[j]);
        }
      }
      const int i = q0 + ty;
      const float li = lse_s[ty], di = delta_s[ty];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 8 * j;
        const float p = kept(i, k0 + col, S, causal, window) ? expf(s[j] * sm_scale - li) : 0.f;
        Ps[ty * kPLd + col] = p;
        dSs[ty * kPLd + col] = p * (dp[j] - di);
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q at k rows ty, ty + 32
#pragma unroll 2
      for (int r = 0; r < kKvBQ; ++r) {
        const float p0 = Ps[r * kPLd + ty], p1 = Ps[r * kPLd + ty + 32];
        const float s0 = dSs[r * kPLd + ty], s1 = dSs[r * kPLd + ty + 32];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 gr = *reinterpret_cast<const float4*>(Gs + r * kLd + tx * 4 + 32 * c);
          const float4 qr = *reinterpret_cast<const float4*>(Qs + r * kLd + tx * 4 + 32 * c);
          axpy4(p0, gr, dv_acc[0][c]);
          axpy4(p1, gr, dv_acc[1][c]);
          axpy4(s0, qr, dk_acc[0][c]);
          axpy4(s1, qr, dk_acc[1][c]);
        }
      }
    }
  }

  T* dkb = dk + b * st.dk[0] + hk * st.dk[1];
  T* dvb = dv + b * st.dv[0] + hk * st.dv[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + ty + 32 * r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = tx * 4 + 32 * c;
      if (col < D) {
        store4(dkb + row * st.dk[2] + col, scale4(dk_acc[r][c], sm_scale));
        store4(dvb + row * st.dv[2] + col, dv_acc[r][c]);
      }
    }
  }
}

template <int kD>
constexpr int dq_smem_bytes() {
  return ((2 * kQBQ + 2 * kQBK) * (kD + 4) + kQBQ * kSLd + 2 * kQBQ) *
         static_cast<int>(sizeof(float));
}

template <int kD, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dq, int group, int S, int D, Strides st,
                              float sm_scale, int causal, int window) {
  constexpr int kLd = kD + 4;
  constexpr int kChunks = kD / 32;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kQBQ * kLd;
  float* Ks = Gs + kQBQ * kLd;
  float* Vs = Ks + kQBK * kLd;
  float* dSs = Vs + kQBK * kLd;
  float* lse_s = dSs + kQBQ * kSLd;
  float* delta_s = lse_s + kQBQ;

  const int q0 = blockIdx.x * kQBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tx = threadIdx.x % 8;
  const int ty = threadIdx.x / 8;
  const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * S;

  load_tile<kD, kQBQ>(Qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, S, D);
  load_tile<kD, kQBQ>(Gs, g + b * st.g[0] + h * st.g[1], st.g[2], q0, S, D);
  load_rows(lse_s, lse + row_base, q0, kQBQ, S);
  load_rows(delta_s, delta + row_base, q0, kQBQ, S);
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];

  float4 acc[2][kChunks];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // k tiles that some row of this q tile keeps (the forward's range)
  int k_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // first column row q0 keeps
    k_begin = lo > 0 ? (lo / kQBK) * kQBK : 0;
  }
  const int k_end = causal ? min(S, q0 + kQBQ) : S;

  for (int k0 = k_begin; k0 < k_end; k0 += kQBK) {
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_tile<kD, kQBK>(Ks, kb, st.k[2], k0, S, D);
    load_tile<kD, kQBK>(Vs, vb, st.v[2], k0, S, D);
    __syncthreads();

    // S and dP at q rows ty, ty + 32 and k columns tx + 8 j
    float s[2][4], dp[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kD; d += 4) {
      float4 qa[2], ga[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        qa[r] = *reinterpret_cast<const float4*>(Qs + (ty + 32 * r) * kLd + d);
        ga[r] = *reinterpret_cast<const float4*>(Gs + (ty + 32 * r) * kLd + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * kLd + d);
        const float4 vv = *reinterpret_cast<const float4*>(Vs + (tx + 8 * j) * kLd + d);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          s[r][j] = dot4(qa[r], kk, s[r][j]);
          dp[r][j] = dot4(ga[r], vv, dp[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lrow = ty + 32 * r;
      const float li = lse_s[lrow], di = delta_s[lrow];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 8 * j;
        const float p =
            kept(q0 + lrow, k0 + col, S, causal, window) ? expf(s[r][j] * sm_scale - li) : 0.f;
        dSs[lrow * kSLd + col] = p * (dp[r][j] - di);
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int kk = 0; kk < kQBK; ++kk) {
      const float d0 = dSs[ty * kSLd + kk], d1 = dSs[(ty + 32) * kSLd + kk];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kr = *reinterpret_cast<const float4*>(Ks + kk * kLd + tx * 4 + 32 * c);
        axpy4(d0, kr, acc[0][c]);
        axpy4(d1, kr, acc[1][c]);
      }
    }
  }

  T* dqb = dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + ty + 32 * r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = tx * 4 + 32 * c;
      if (col < D) store4(dqb + row * st.dq[2] + col, scale4(acc[r][c], sm_scale));
    }
  }
}

template <int kD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* g,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int Hkv, int S, int D, const Strides& st, float sm_scale, int causal,
                   int window, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(g);
  const long long rows = static_cast<long long>(B) * H * S;
  flash_attention_bwd_delta_kernel<T>
      <<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
         stream>>>(static_cast<const T*>(o), tg, delta, H, S, D, rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // above 48 KB, dynamic shared memory must be granted per kernel (and per
  // device, so it is set at every launch: a cheap driver call)
  constexpr int kv_bytes = dkdv_smem_bytes<kD>();
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<kD, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((S + kKvBK - 1) / kKvBK, Hkv, B);
  flash_attention_bwd_dkdv_kernel<kD, T><<<kv_grid, kThreads, kv_bytes, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, H / Hkv, S, D,
      st, sm_scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int q_bytes = dq_smem_bytes<kD>();
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<kD, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return err;
  const dim3 q_grid((S + kQBQ - 1) / kQBQ, H, B);
  flash_attention_bwd_dq_kernel<kD, T><<<q_grid, kThreads, q_bytes, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), H / Hkv, S, D, st, sm_scale, causal,
      window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o, const void* g,
                     const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
                     int Hkv, int S, int D, const Strides& st, float sm_scale, int causal,
                     int window, cudaStream_t s) {
  // D runs zero-padded in the next size up
  if (D <= 32)
    return launch<32, T>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, Hkv, S, D, st, sm_scale,
                         causal, window, s);
  if (D <= 64)
    return launch<64, T>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, Hkv, S, D, st, sm_scale,
                         causal, window, s);
  if (D <= 128)
    return launch<128, T>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, Hkv, S, D, st, sm_scale,
                          causal, window, s);
  return launch<256, T>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, Hkv, S, D, st, sm_scale,
                        causal, window, s);
}

}  // namespace bwd

}  // namespace

extern "C" {

// q, o, do, dq: (B, H, S, D); k, v, dk, dv: (B, Hkv, S, D), each addressed
// by the 24 element strides in `strides` (b, h, s for q, k, v, o, do, dq,
// dk, dv in that order) with D contiguous, rows and bases 16-byte aligned.
// lse and delta (scratch, written here): (B, H, S) float32 contiguous.
// dtype 0 = float32, 1 = bfloat16 (inputs and gradients alike).  D a
// multiple of 8 up to 256; window 0 = no window.  Launches the three
// kernels on `stream`; returns a cudaError_t.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* g, const void* lse, void* delta, void* dq, void* dk,
                               void* dv, int dtype, int B, int H, int Hkv, int S, int D,
                               const long long* strides, float sm_scale, int causal,
                               int window, int device, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256 || D % 8 != 0 || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  bwd::Strides st;
  static_assert(sizeof(st) == 24 * sizeof(long long), "Strides is 24 packed strides");
  memcpy(&st, strides, sizeof(st));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == 0)
    return bwd::dispatch<float>(q, k, v, o, g, l, d, dq, dk, dv, B, H, Hkv, S, D, st, sm_scale,
                                causal, window, s);
  if (dtype == 1)
    return bwd::dispatch<__nv_bfloat16>(q, k, v, o, g, l, d, dq, dk, dv, B, H, Hkv, S, D, st,
                                        sm_scale, causal, window, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
