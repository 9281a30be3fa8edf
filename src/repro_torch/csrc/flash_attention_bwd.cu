// Backward of the flash-attention forward (flash_attention.cu), causal
// and/or sliding window, GQA by head map.  Given q, k, v, the forward's
// output o, the output's gradient do and the forward's row log-sum-exp lse
// (natural log, float32), it computes, over the pairs (i, j) the masks keep
// (as in the forward: i < S query rows, j < Sk key rows, j <= i when causal,
// j > i - window when window > 0; Sk != S only with neither, whisper's
// cross-attention of S decoder rows over Sk = 1,500 encoder rows),
//
//   P[i, j]  = exp(c(q_i . k_j * scale) - lse_i)     (recomputed, not stored)
//   dV[j]    = sum_{h in group, i} P[i, j] do_i
//   dP[i, j] = do_i . v_j
//   dS[i, j] = P[i, j] c'[i, j] (dP[i, j] - delta_i),  delta_i = do_i . o_i
//   dQ[i]    = scale sum_j dS[i, j] k_j
//   dK[j]    = scale sum_{h in group, i} dS[i, j] q_i
//
// in float32 from the inputs' values, the gradients written in the inputs'
// type.  c is the forward's: the identity (c' = 1), or with a soft-cap > 0
// the reference model's logit cap c(x) = cap t, t = tanh(x / cap), whose
// derivative is c' = 1 - t^2 (the forward's lse is already of the capped
// scores).  The capped kernels are their own template instances (kCap), so
// the uncapped ones compile and time as they did: t is formed with tanhf
// from the scaled score, as the forward forms it, and P c' is one product
// taken before (dP - delta), so dS = (P c') (dP - delta).  At grok's
// training layer (B = 2, H = 48, Hkv = 8, S = 1,024, D = 128, causal, cap
// 30) the bound is 10 D x 50.4 M kept pairs = 64.5 GFLOP, 0.0652 ms; on the
// H100 a capped call took 0.465 ms against 0.357 uncapped on the same
// inputs (chip_smoke.py's timing line): the tanh sits on the path of both
// the dK/dV and the dQ kernels, as in the forward.  Tensors are addressed by strides (the head dimension contiguous),
// as in the forward; lse is (B, H, S) float32 contiguous.
//
// The reference package has no Pallas backward: it differentiates the plain
// flash_chunked (src/repro/models/attention.py) with XLA
// (jax.value_and_grad in src/repro/training/train_step.py).  These kernels
// compute that gradient on the card behind the forward kernel of
// src/repro/kernels/flash_attention/flash_attention.py (_kernel).
//
// Bound on the H100 at gemma-2b's training layer (B = 4, H = 8, Hkv = 1,
// S = 1,024, D = 256, causal): operations.  Five products of 2 D per kept
// pair (S, dV, dP, dQ, dK): 10 D x 16.8 M pairs = 43 GFLOP, 0.0435 ms at the
// dense bf16 tensor-core rate (989 TFLOP/s).  Their inputs and outputs are
// 44 MB, 0.013 ms at 3.35 TB/s.
//
// Two paths, chosen by dtype; neither falls back to the other.
//
// bfloat16 (the trained models' path): the products run on the tensor cores
// with wgmma on bf16 operands and fp32 accumulators, the tiles arrive by
// TMA (cp.async.bulk.tensor, 64 x 64 boxes with the 128-byte swizzle, rows
// past S and columns past D filled with zeros) into two-stage rings guarded
// by mbarriers, as in the forward.  Four kernels, in order on the caller's
// stream:
//
// flash_attention_bwd_delta_kernel: delta = rowsum(do * o), one warp per
//   row, into the head of the scratch buffer.
// flash_attention_bwd_dkdv_wgmma_kernel: one block per (64-row k tile,
//   split, KV head, b), two consumer warpgroups.  K and V of the tile stay
//   in shared memory; the (Q, dO) tile pairs of the block's query heads and
//   of the q tiles the masks keep stream through the ring.  Warpgroup 0
//   runs S^T = K Q^T (64 x 64 wgmmas, both operands K-major in shared
//   memory), forms P^T in registers from the lse of the tile's q columns,
//   hands it to warpgroup 1 in float32 through 16 KB of shared memory and
//   two named barriers, and accumulates dV += P^T dO (register-A wgmmas, dO
//   read MN-major from the same swizzled tile).  Warpgroup 1 runs
//   dP^T = V dO^T, forms dS^T = P^T (dP^T - delta) and accumulates
//   dK += dS^T Q.  Each warpgroup holds one 64 x D fp32 accumulator (128
//   registers a thread at D = 256).  P and dS are rounded once to bf16
//   before their products (the A fragments), unlike the forward, which
//   splits P in two bf16 terms: the gradients are held to rel L2 1e-2 and
//   one rounding (2^-9) stays far inside it (kernels/flash_attention/ref.py
//   attention_bwd_bf16_ref emulates this arithmetic).
// flash_attention_bwd_reduce_kernel: at MQA a grid of one block per (k
//   tile, KV head, b) is B S / 64 = 64 blocks on 132 SMs.  So the G query
//   heads of a group are split over G / heads_per_block blocks (Plan; a
//   pure function of the shape, never of timing), each writing float32
//   partial dK and dV into scratch; this kernel sums them in split order
//   and writes bf16.  No atomics: two calls give the same bits.  With one
//   split (G = 1, or heads_per_block = G) the dK/dV kernel writes bf16
//   itself and this kernel does not run.  The grid puts the k tile on its
//   slowest axis, lowest first: under causal masking those keep the most q
//   rows, so the long blocks start in the first wave.
// flash_attention_bwd_dq_wgmma_kernel: one block of one warpgroup per
//   (64-row q tile, head, b), heaviest first; Q and dO stay in shared
//   memory, the K and V tiles the masks keep stream through the ring.
//   S = Q K^T and dP = dO V^T from shared memory, dS in registers, then
//   dQ += dS K with K read MN-major.  It recomputes S and dP, so the four
//   kernels execute 14 D operations per kept pair where the bound counts 10.
//
// At gemma-2b's layer the plan gives heads_per_block 2: 256 dK/dV blocks,
// 34 MB of float32 partials (written once, read once by the reduction), and
// 512 dQ blocks; at gemma3-4b's (G = 2) one block keeps its whole group and
// the reduction does not run.  Shared memory per block at D = 256: dK/dV K + V 64 KB,
// two stages of Q + dO 128 KB, P^T 16 KB: 214,080 B with barriers and
// alignment slack (of 232,448); dQ Q + dO 64 KB and two stages of K + V
// 128 KB: 197,696 B.  One block per SM each.  Registers per thread
// (ptxas, sm_90a, no spill): dK/dV 244 and dQ 245 at D = 256 (128: 167 and
// 181; 64: 155 and 149), the reduction 32; chip_smoke.py prints the build
// log's counts.  On the H100 at gemma-2b's layer a call takes 0.211 ms
// (chip_smoke.py's timing line), 4.9x the bound and 0.90x SDPA's backward.
//
// Keys that are not the queries (whisper's cross-attention in training: S
// = 448 decoder rows over Sk = 1,500 encoder rows, non-causal, G = 1): the
// dK/dV blocks, the K/V TMA maps and the partials follow Sk, the dQ blocks
// and the delta rows S; kept() reads both lengths.  1,500 = 23 x 64 + 28,
// so the last k tile is ragged: TMA fills its rows past Sk with zeros and
// the mask zeroes their P and dS; q rows past S (448 = 7 x 64, none here)
// read lse and delta as 0 and are masked the same way, so they add nothing
// to dK/dV.  Bound at that shape (B = 16, H = 8, D = 64): 10 D x 86.0 M
// pairs = 55.1 GFLOP, 0.0557 ms (operations; 128 MB of bytes, 0.038 ms).
// On the H100 a call took 0.5946 ms, 10.7x the bound and 2.87x SDPA's
// backward (chip_smoke.py's timing line): each of the 3,072 dK/dV blocks
// streams only 7 q tiles past its K/V prologue, and each of the 896 dQ
// blocks 24 k tiles.
//
// float32 (the checking dtype: the reduced-config runs): fp32 FMA on the
// CUDA cores, since the tensor cores have no fp32 product that holds 1e-4
// (TF32 keeps 10 bits).  Three kernels: the delta kernel;
// flash_attention_bwd_dkdv_kernel, one block per (64-row k tile, KV head,
// b) looping over the G query heads and their 32-row q tiles, the group's
// sum taken inside the block in a fixed order; and
// flash_attention_bwd_dq_kernel, one block per (64-row q tile, head, b)
// over 32-row k tiles.  256 threads as 32 row groups x 8 column lanes, every
// tile converted to float32 in shared memory (rows padded to D + 4 floats):
// dK/dV 218,368 B, dQ 210,432 B at D = 256; ptxas gave 254 and 168
// registers and no spill.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

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

__device__ __forceinline__ bool kept(int i, int j, int S, int Sk, int causal, int window) {
  return i < S && j < Sk && (!causal || j <= i) && (window <= 0 || j > i - window);
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

// P and P c' of one kept pair from its raw score s = q . k (kCap: the
// capped score cap tanh(s scale / cap), formed as the float32 forward
// kernel forms it)
template <bool kCap>
__device__ __forceinline__ void prob(float s, float li, float sm_scale, float cap, float& p,
                                     float& pc) {
  if (kCap) {
    const float t = tanhf(s * sm_scale / cap);
    p = expf(t * cap - li);
    pc = p * (1.f - t * t);
  } else {
    p = expf(s * sm_scale - li);
    pc = p;
  }
}

template <int kD, typename T, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ g,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv, int H, int group, int S,
                                int Sk, int D, Strides st, float sm_scale, float cap, int causal,
                                int window) {
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

  load_tile<kD, kKvBK>(Ks, k + b * st.k[0] + hk * st.k[1], st.k[2], k0, Sk, D);
  load_tile<kD, kKvBK>(Vs, v + b * st.v[0] + hk * st.v[1], st.v[2], k0, Sk, D);

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
        float p = 0.f, pc = 0.f;
        if (kept(i, k0 + col, S, Sk, causal, window))
          prob<kCap>(s[j], li, sm_scale, cap, p, pc);
        Ps[ty * kPLd + col] = p;
        dSs[ty * kPLd + col] = pc * (dp[j] - di);
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
    if (row >= Sk) continue;
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

template <int kD, typename T, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dq, int group, int S, int Sk, int D, Strides st,
                              float sm_scale, float cap, int causal, int window) {
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
  const int k_end = causal ? min(Sk, q0 + kQBQ) : Sk;

  for (int k0 = k_begin; k0 < k_end; k0 += kQBK) {
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_tile<kD, kQBK>(Ks, kb, st.k[2], k0, Sk, D);
    load_tile<kD, kQBK>(Vs, vb, st.v[2], k0, Sk, D);
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
        float p = 0.f, pc = 0.f;
        if (kept(q0 + lrow, k0 + col, S, Sk, causal, window))
          prob<kCap>(s[r][j], li, sm_scale, cap, p, pc);
        dSs[lrow * kSLd + col] = pc * (dp[r][j] - di);
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

template <int kD, typename T, bool kCap>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* g,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int Hkv, int S, int Sk, int D, const Strides& st, float sm_scale, float softcap,
                   int causal, int window, cudaStream_t stream) {
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
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<kD, T, kCap>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((Sk + kKvBK - 1) / kKvBK, Hkv, B);
  flash_attention_bwd_dkdv_kernel<kD, T, kCap><<<kv_grid, kThreads, kv_bytes, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, H / Hkv, S, Sk,
      D, st, sm_scale, softcap, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int q_bytes = dq_smem_bytes<kD>();
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<kD, T, kCap>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return err;
  const dim3 q_grid((S + kQBQ - 1) / kQBQ, H, B);
  flash_attention_bwd_dq_kernel<kD, T, kCap><<<q_grid, kThreads, q_bytes, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), H / Hkv, S, Sk, D, st, sm_scale, softcap,
      causal, window);
  return cudaGetLastError();
}

template <typename T, bool kCap>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* o,
                       const void* g, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int H, int Hkv, int S, int Sk, int D,
                       const Strides& st, float sm_scale, float softcap, int causal, int window,
                       cudaStream_t s) {
  // D runs zero-padded in the next size up
  if (D <= 32)
    return launch<32, T, kCap>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                               sm_scale, softcap, causal, window, s);
  if (D <= 64)
    return launch<64, T, kCap>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                               sm_scale, softcap, causal, window, s);
  if (D <= 128)
    return launch<128, T, kCap>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                                sm_scale, softcap, causal, window, s);
  return launch<256, T, kCap>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                              sm_scale, softcap, causal, window, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o, const void* g,
                     const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
                     int Hkv, int S, int Sk, int D, const Strides& st, float sm_scale,
                     float softcap, int causal, int window, cudaStream_t s) {
  if (softcap > 0.f)
    return dispatch_d<T, true>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                               sm_scale, softcap, causal, window, s);
  return dispatch_d<T, false>(q, k, v, o, g, lse, delta, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                              sm_scale, softcap, causal, window, s);
}

}  // namespace bwd
// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int kTile = 64;               // rows of every q, k, v and dO tile
constexpr int kStages = 2;              // ring depth of the streamed tiles
constexpr int kPanelBytes = 64 * 128;   // 64 rows x 64 bf16 columns (128 B, swizzled)
constexpr int kKvThreads = 256;         // dK/dV: two consumer warpgroups
constexpr int kQThreads = 128;          // dQ: one consumer warpgroup
constexpr int kProducer = 128;          // dK/dV: the thread that issues the loads
constexpr int kTargetBlocks = 256;      // dK/dV blocks wanted: about two waves of 132 SMs
constexpr float kLog2e = 1.4426950408889634f;

// the split of a call: kd, the padded head size; n_kt, the 64-row k tiles
// (of Sk rows); n_qt, the 64-row q tiles (of S rows); heads_per_block query
// heads of one group summed inside a dK/dV block; n_split = group /
// heads_per_block blocks per (k tile, KV head, b), whose float32 partials
// the reduction kernel sums in split order
struct Plan {
  int kd, n_kt, n_qt, heads_per_block, n_split;
  long long delta_floats, part_floats;  // scratch: delta, then 2 x part_floats
};

inline int padded_d(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }

// a pure function of the shape (window is not used by this rule): the
// largest divisor of the group that still gives kTargetBlocks blocks, else
// one head per block; `heads_per_block` > 0 overrides the rule.  Measured
// on the H100 (launch/bwd_splits.py times every split at six shapes): 256
// blocks, one per SM, beat 512 (twice the partials to write and sum) and
// 128 (one wave, a tail of idle SMs) wherever 256 were possible
inline Plan plan(int B, int H, int Hkv, int S, int Sk, int D, int heads_per_block) {
  Plan p;
  const int group = H / Hkv;
  p.kd = padded_d(D);
  p.n_kt = (Sk + kTile - 1) / kTile;
  p.n_qt = (S + kTile - 1) / kTile;
  const long long base = static_cast<long long>(p.n_kt) * Hkv * B;
  p.heads_per_block = 1;
  if (heads_per_block > 0) {
    p.heads_per_block = heads_per_block;
  } else {
    for (int hpb = group; hpb >= 1; --hpb)
      if (group % hpb == 0 && base * (group / hpb) >= kTargetBlocks) {
        p.heads_per_block = hpb;
        break;
      }
  }
  p.n_split = group / p.heads_per_block;
  // delta rounded up to 64 floats, so the partials start 256-byte aligned
  p.delta_floats = (static_cast<long long>(B) * H * S + 63) / 64 * 64;
  p.part_floats = p.n_split > 1 ? static_cast<long long>(p.n_split) * B * Hkv * Sk * D : 0;
  return p;
}

template <int kD>
struct KvLayout {
  static constexpr int kPanels = kD / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 64 rows x kD
  static constexpr int kK = 0;                               // resident
  static constexpr int kV = kTileBytes;                      // resident
  static constexpr int kQ = 2 * kTileBytes;                  // kStages tiles
  static constexpr int kG = kQ + kStages * kTileBytes;       // kStages dO tiles
  static constexpr int kP = kG + kStages * kTileBytes;       // P^T, 64 x 64 fp32
  static constexpr int kBar = kP + kTile * kTile * 4;        // 1 + 2 kStages mbarriers
  static constexpr int kBytes = kBar + 64 + 1024;            // + alignment slack
};

template <int kD>
struct QLayout {
  static constexpr int kPanels = kD / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  static constexpr int kQ = 0;                               // resident
  static constexpr int kG = kTileBytes;                      // resident dO
  static constexpr int kK = 2 * kTileBytes;                  // kStages tiles
  static constexpr int kV = kK + kStages * kTileBytes;       // kStages tiles
  static constexpr int kBar = kV + kStages * kTileBytes;     // 1 + 2 kStages mbarriers
  static constexpr int kBytes = kBar + 64 + 1024;
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ bool kept(int i, int j, int S, int Sk, int causal, int window) {
  return i < S && j < Sk && (!causal || j <= i) && (window <= 0 || j > i - window);
}

// kk-th 16-deep slice of a 64 x kD swizzled tile, the K-major operand of an
// ss wgmma: 64-column panels kPanelBytes apart, 32 bytes per slice
__device__ __forceinline__ int k_slice(int kk) { return (kk / 4) * kPanelBytes + (kk % 4) * 32; }

// 64 x kD accumulator (wgmma layout) stored as bf16 times `mult`: rows row0,
// row0 + 8 of the tile starting at `first` (rows < S), columns < D
template <int kD>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* base, long long ss, const float (&acc)[kD / 2],
                                           int row0, int S, int D, int cq, float mult) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + cq;
    if (col < D) {
      const __nv_bfloat162 v0 = __floats2bfloat162_rn(acc[4 * j] * mult, acc[4 * j + 1] * mult);
      const __nv_bfloat162 v1 =
          __floats2bfloat162_rn(acc[4 * j + 2] * mult, acc[4 * j + 3] * mult);
      if (row0 < S) *reinterpret_cast<__nv_bfloat162*>(base + row0 * ss + col) = v0;
      if (row1 < S) *reinterpret_cast<__nv_bfloat162*>(base + row1 * ss + col) = v1;
    }
  }
}

// dK and dV of one 64-row k tile of KV head hk and batch b, over the query
// heads [h0, h0 + hpb) of its group and, for each, the q tiles the masks
// keep.  Warpgroup 0: S^T = K Q^T, P^T, dV += P^T dO.  Warpgroup 1:
// dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.  Thread 128
// streams the Q and dO tiles through the ring.  With kCap warpgroup 0
// hands over (P c')^T in place of P^T: warpgroup 1 needs P only through
// P c', and warpgroup 0 alone holds t, so no second buffer and no
// recovery of t from P (c' = 1 - t^2, t = tanh(s scale / cap), with
// cap_scale = scale / cap and cap_log2 = cap log2 e as in the forward).
template <int kD, bool kCap>
__global__ void __launch_bounds__(kKvThreads, 1)
flash_attention_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                      const __grid_constant__ CUtensorMap tk,
                                      const __grid_constant__ CUtensorMap tv,
                                      const __grid_constant__ CUtensorMap tg,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta,
                                      __nv_bfloat16* __restrict__ dk,
                                      __nv_bfloat16* __restrict__ dv,
                                      float* __restrict__ part_k, float* __restrict__ part_v,
                                      int H, int Hkv, int group, int hpb, int S, int Sk,
                                      int D, long long dksb, long long dksh, long long dkss,
                                      long long dvsb, long long dvsh, long long dvss,
                                      float sm_scale, float scale_log2, float cap_scale,
                                      float cap_log2, int causal, int window) {
  using L = KvLayout<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_kv + 1;          // kStages: a Q/dO tile pair has landed
  uint64_t* empty = full + kStages;     // kStages: all threads are done with it
  float* p_s = reinterpret_cast<float*>(smem + L::kP);

  const int n_split = group / hpb;
  const int hk = blockIdx.x / n_split;
  const int split = blockIdx.x % n_split;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;    // causal: the lowest k tiles keep the most rows, first
  const int h0 = hk * group + split * hpb;
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int lane = tid % 32;

  // q rows that keep some column of [k0, k0 + 64): i >= k0 when causal,
  // i < k0 + 63 + window with a window
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + kTile - 1 + window) : S;
  const int n_q = (q_end - q_begin + kTile - 1) / kTile;
  const int n_t = hpb * n_q;            // (head, q tile) steps, head-major

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kKvThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_qg = [&](int t) {
    const int s = t % kStages;
    const int head = h0 + t / n_q;
    const int row = q_begin + (t % n_q) * kTile;
    mbar_expect_tx(&full[s], 2 * L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      tma_load(smem + L::kQ + s * L::kTileBytes + p * kPanelBytes, &tq, 64 * p, row, head, b,
               &full[s]);
      tma_load(smem + L::kG + s * L::kTileBytes + p * kPanelBytes, &tg, 64 * p, row, head, b,
               &full[s]);
    }
  };

  if (tid == kProducer) {
    mbar_expect_tx(bar_kv, 2 * L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      tma_load(smem + L::kK + p * kPanelBytes, &tk, 64 * p, k0, hk, b, bar_kv);
      tma_load(smem + L::kV + p * kPanelBytes, &tv, 64 * p, k0, hk, b, bar_kv);
    }
    for (int t = 0; t < kStages && t < n_t; ++t) load_qg(t);
  }

  // this thread's accumulator rows (k rows of the tile) and columns
  const int r0 = (tid % 128) / 32 * 16 + lane / 4;
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  const int ti = tid % 128;

  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
  const uint8_t* ks = smem + L::kK;
  const uint8_t* vs = smem + L::kV;

  mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_t; ++t) {
    const int stage = t % kStages;
    const int parity = (t / kStages) & 1;
    const int head = h0 + t / n_q;
    const int q0 = q_begin + (t % n_q) * kTile;
    // the lse (warpgroup 0, in the log2 domain) or delta (warpgroup 1) of
    // this thread's q columns 8 j + cq + e
    const float* rv = (wgi == 0 ? lse : delta) + (static_cast<long long>(b) * H + head) * S;
    const float rmul = wgi == 0 ? kLog2e : 1.f;
    float cv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = q0 + 8 * j + cq + e;
        cv[2 * j + e] = c < S ? __ldg(rv + c) * rmul : 0.f;
      }
    // does some pair of the tile fall outside the masks?
    const bool edge = q0 + kTile > S || k0 + kTile > Sk || (causal && k0 + kTile - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kTile - 1 - window);
    mbar_wait(&full[stage], parity);
    const uint8_t* qs = smem + L::kQ + stage * L::kTileBytes;
    const uint8_t* gs = smem + L::kG + stage * L::kTileBytes;
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    fence_regs(x);
    wgmma_fence();
    // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T (both K-major)
    const uint8_t* a_s = wgi == 0 ? ks : vs;
    const uint8_t* b_s = wgi == 0 ? qs : gs;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64(x, desc(a_s + k_slice(kk), 16, 1024), desc(b_s + k_slice(kk), 16, 1024), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);

    if (wgi == 0) {
      if (t > 0) named_sync(2, kKvThreads);  // warpgroup 1 has read the previous P^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p, pc;
          if (kCap) {
            const float tc = tanhf(x[4 * j + e] * cap_scale);
            p = exp2f(tc * cap_log2 - cv[2 * j + (e & 1)]);
            pc = p * (1.f - tc * tc);
          } else {
            p = pc = exp2f(x[4 * j + e] * scale_log2 - cv[2 * j + (e & 1)]);
          }
          if (edge &&
              !kept(q0 + 8 * j + cq + (e & 1), k0 + (e < 2 ? r0 : r1), S, Sk, causal, window))
            p = pc = 0.f;
          x[4 * j + e] = p;
          p_s[(4 * j + e) * 128 + ti] = pc;
        }
      named_arrive(1, kKvThreads);
    } else {
      named_sync(1, kKvThreads);             // warpgroup 0's (P c')^T of this tile is in p_s
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = p_s[i * 128 + ti] * (x[i] - cv[2 * (i / 4) + (i & 1)]);
      if (t + 1 < n_t) named_arrive(2, kKvThreads);
    }
    // P^T (warpgroup 0) or dS^T (warpgroup 1) rounded once to bf16, as the
    // A fragments of k step j / 2: rows r0, r1, columns 8 j + cq, + 1
    uint32_t af[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      af[j / 2][(j % 2) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
      af[j / 2][(j % 2) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
    }
    // dV += P^T dO or dK += dS^T Q: 16 q rows of the MN-major tile per step
    const uint8_t* m_s = wgi == 0 ? gs : qs;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_rs<kD>(acc, af[kk], desc(m_s + kk * 16 * 128, kPanelBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    mbar_arrive(&empty[stage]);
    if (tid == kProducer && t + kStages < n_t) {
      mbar_wait(&empty[stage], parity);
      load_qg(t + kStages);
    }
    __syncwarp();
  }

  const int B = gridDim.y;
  if (n_split == 1) {
    if (wgi == 0)
      store_bf16<kD>(dv + b * dvsb + hk * dvsh + static_cast<long long>(k0) * dvss, dvss, acc,
                     r0, Sk - k0, D, cq, 1.f);
    else
      store_bf16<kD>(dk + b * dksb + hk * dksh + static_cast<long long>(k0) * dkss, dkss, acc,
                     r0, Sk - k0, D, cq, sm_scale);
    return;
  }
  // float32 partials of this split, (n_split, B, Hkv, Sk, D) contiguous
  float* part = (wgi == 0 ? part_v : part_k) +
                ((static_cast<long long>(split) * B + b) * Hkv + hk) * Sk * D;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + cq;
    if (col < D) {
      if (k0 + r0 < Sk)
        *reinterpret_cast<float2*>(part + static_cast<long long>(k0 + r0) * D + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (k0 + r1 < Sk)
        *reinterpret_cast<float2*>(part + static_cast<long long>(k0 + r1) * D + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// dK = scale sum_split part_k[split], dV = sum_split part_v[split], in
// split order, written as bf16; four columns per thread, blockIdx.y picks
// dK (0) or dV (1)
__global__ void __launch_bounds__(256)
flash_attention_bwd_reduce_kernel(const float* __restrict__ part_k,
                                  const float* __restrict__ part_v,
                                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                  int n_split, int Hkv, int Sk, int D, long long per_split,
                                  long long dksb, long long dksh, long long dkss,
                                  long long dvsb, long long dvsh, long long dvss,
                                  float sm_scale) {
  const long long e = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (e >= per_split) return;
  const bool is_k = blockIdx.y == 0;
  const float* part = is_k ? part_k : part_v;
  float4 acc = *reinterpret_cast<const float4*>(part + e);
  for (int s = 1; s < n_split; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + s * per_split + e);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float mult = is_k ? sm_scale : 1.f;
  const int col = static_cast<int>(e % D);
  const long long r = e / D;
  const int row = static_cast<int>(r % Sk);
  const long long bh = r / Sk;
  const int hk = static_cast<int>(bh % Hkv);
  const int b = static_cast<int>(bh / Hkv);
  __nv_bfloat16* out = is_k ? dk + b * dksb + hk * dksh + row * dkss + col
                            : dv + b * dvsb + hk * dvsh + row * dvss + col;
  uint2 raw;
  raw.x = pack_bf16(acc.x * mult, acc.y * mult);
  raw.y = pack_bf16(acc.z * mult, acc.w * mult);
  *reinterpret_cast<uint2*>(out) = raw;
}

// dQ of one 64-row q tile of head h and batch b over the k tiles the masks
// keep: S = Q K^T and dP = dO V^T from shared memory, dS = P c' (dP -
// delta) in registers, dQ += dS K with K read MN-major.  Thread 0 streams
// the K and V tiles through the ring.
template <int kD, bool kCap>
__global__ void __launch_bounds__(kQThreads, 1)
flash_attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const __grid_constant__ CUtensorMap tg,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    __nv_bfloat16* __restrict__ dq, int H, int group, int S,
                                    int Sk, int D, long long dqsb, long long dqsh, long long dqss,
                                    float sm_scale, float scale_log2, float cap_scale,
                                    float cap_log2, int causal, int window) {
  using L = QLayout<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // heaviest first
  const int hk = h / group;
  const int q0 = qt * kTile;
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  // k tiles that some row of the tile keeps: [kt0, kt0 + n_tiles)
  int kt0 = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // first column row q0 keeps
    kt0 = lo > 0 ? lo / kTile : 0;
  }
  const int k_rows = causal ? min(Sk, q0 + kTile) : Sk;
  const int n_tiles = (k_rows + kTile - 1) / kTile - kt0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kQThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int t) {
    const int s = t % kStages;
    const int row = (kt0 + t) * kTile;
    mbar_expect_tx(&full[s], 2 * L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      tma_load(smem + L::kK + s * L::kTileBytes + p * kPanelBytes, &tk, 64 * p, row, hk, b,
               &full[s]);
      tma_load(smem + L::kV + s * L::kTileBytes + p * kPanelBytes, &tv, 64 * p, row, hk, b,
               &full[s]);
    }
  };

  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * L::kTileBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      tma_load(smem + L::kQ + p * kPanelBytes, &tq, 64 * p, q0, h, b, bar_q);
      tma_load(smem + L::kG + p * kPanelBytes, &tg, 64 * p, q0, h, b, bar_q);
    }
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_kv(t);
  }

  // this thread's accumulator rows (query rows) and columns
  const int lr0 = tid / 32 * 16 + lane / 4;
  const int row0 = q0 + lr0;
  const int row1 = row0 + 8;
  const int cq = 2 * (lane % 4);
  const long long rbase = (static_cast<long long>(b) * H + h) * S;
  const float l0 = row0 < S ? __ldg(lse + rbase + row0) * kLog2e : 0.f;
  const float l1 = row1 < S ? __ldg(lse + rbase + row1) * kLog2e : 0.f;
  const float d0 = row0 < S ? __ldg(delta + rbase + row0) : 0.f;
  const float d1 = row1 < S ? __ldg(delta + rbase + row1) : 0.f;

  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
  const uint8_t* qs = smem + L::kQ;
  const uint8_t* gs = smem + L::kG;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    const int parity = (t / kStages) & 1;
    const int k0 = (kt0 + t) * kTile;
    mbar_wait(&full[stage], parity);
    const uint8_t* ks = smem + L::kK + stage * L::kTileBytes;
    const uint8_t* vs = smem + L::kV + stage * L::kTileBytes;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss_n64(s, desc(qs + k_slice(kk), 16, 1024), desc(ks + k_slice(kk), 16, 1024), 1);
      wgmma_ss_n64(dp, desc(gs + k_slice(kk), 16, 1024), desc(vs + k_slice(kk), 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = k0 + kTile > Sk || q0 + kTile > S || (causal && k0 + kTile - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kTile - 1 - window);
    uint32_t af[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        float pc;
        if (kCap) {
          const float tc = tanhf(s[4 * j + e] * cap_scale);
          pc = exp2f(tc * cap_log2 - (hi ? l1 : l0)) * (1.f - tc * tc);
        } else {
          pc = exp2f(s[4 * j + e] * scale_log2 - (hi ? l1 : l0));
        }
        if (edge && !kept(hi ? row1 : row0, k0 + 8 * j + cq + (e & 1), S, Sk, causal, window))
          pc = 0.f;
        ds[e] = pc * (dp[4 * j + e] - (hi ? d1 : d0));
      }
      af[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
      af[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_rs<kD>(acc, af[kk], desc(ks + kk * 16 * 128, kPanelBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    mbar_arrive(&empty[stage]);
    if (tid == 0 && t + kStages < n_tiles) {
      mbar_wait(&empty[stage], parity);
      load_kv(t + kStages);
    }
    __syncwarp();
  }

  store_bf16<kD>(dq + b * dqsb + h * dqsh + static_cast<long long>(q0) * dqss, dqss, acc, lr0,
                 S - q0, D, cq, sm_scale);
}

template <int kD, bool kCap>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* g,
                   const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int H,
                   int Hkv, int S, int Sk, int D, const bwd::Strides& st, const Plan& pl,
                   float sm_scale, float softcap, int causal, int window, cudaStream_t stream) {
  using T = __nv_bfloat16;
  float* delta = scratch;
  const long long rows = static_cast<long long>(B) * H * S;
  bwd::flash_attention_bwd_delta_kernel<T>
      <<<static_cast<unsigned>((rows + bwd::kThreads / 32 - 1) / (bwd::kThreads / 32)),
         bwd::kThreads, 0, stream>>>(static_cast<const T*>(o), static_cast<const T*>(g), delta,
                                     H, S, D, rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap mq, mk, mv, mg;
  err = make_map(&mq, q, B, H, S, D, st.q[0], st.q[1], st.q[2]);
  if (err == cudaSuccess) err = make_map(&mk, k, B, Hkv, Sk, D, st.k[0], st.k[1], st.k[2]);
  if (err == cudaSuccess) err = make_map(&mv, v, B, Hkv, Sk, D, st.v[0], st.v[1], st.v[2]);
  if (err == cudaSuccess) err = make_map(&mg, g, B, H, S, D, st.g[0], st.g[1], st.g[2]);
  if (err != cudaSuccess) return err;
  const int group = H / Hkv;
  const float scale_log2 = sm_scale * kLog2e;
  const float cap_scale = kCap ? sm_scale / softcap : 0.f;
  const float cap_log2 = softcap * kLog2e;
  float* part_k = scratch + pl.delta_floats;
  float* part_v = part_k + pl.part_floats;
  T* tdk = static_cast<T*>(dk);
  T* tdv = static_cast<T*>(dv);

  // above 48 KB, dynamic shared memory must be granted per kernel (and per
  // device, so it is set at every launch: a cheap driver call)
  constexpr int kv_bytes = KvLayout<kD>::kBytes;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_wgmma_kernel<kD, kCap>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(Hkv * pl.n_split, B, pl.n_kt);
  flash_attention_bwd_dkdv_wgmma_kernel<kD, kCap><<<kv_grid, kKvThreads, kv_bytes, stream>>>(
      mq, mk, mv, mg, lse, delta, tdk, tdv, part_k, part_v, H, Hkv, group, pl.heads_per_block,
      S, Sk, D, st.dk[0], st.dk[1], st.dk[2], st.dv[0], st.dv[1], st.dv[2], sm_scale, scale_log2,
      cap_scale, cap_log2, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (pl.n_split > 1) {
    const long long per_split = static_cast<long long>(B) * Hkv * Sk * D;
    const long long threads = per_split / 4;
    const dim3 r_grid(static_cast<unsigned>((threads + 255) / 256), 2);
    flash_attention_bwd_reduce_kernel<<<r_grid, 256, 0, stream>>>(
        part_k, part_v, tdk, tdv, pl.n_split, Hkv, Sk, D, per_split, st.dk[0], st.dk[1],
        st.dk[2], st.dv[0], st.dv[1], st.dv[2], sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  constexpr int q_bytes = QLayout<kD>::kBytes;
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_wgmma_kernel<kD, kCap>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return err;
  const dim3 q_grid(H, B, pl.n_qt);
  flash_attention_bwd_dq_wgmma_kernel<kD, kCap><<<q_grid, kQThreads, q_bytes, stream>>>(
      mq, mk, mv, mg, lse, delta, static_cast<T*>(dq), H, group, S, Sk, D, st.dq[0], st.dq[1],
      st.dq[2], sm_scale, scale_log2, cap_scale, cap_log2, causal, window);
  return cudaGetLastError();
}

template <bool kCap>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* o,
                       const void* g, const float* lse, float* scratch, void* dq, void* dk,
                       void* dv, int B, int H, int Hkv, int S, int Sk, int D,
                       const bwd::Strides& st, const Plan& pl, float sm_scale, float softcap,
                       int causal, int window, cudaStream_t s) {
  // D runs zero-padded in the next size up (TMA fills the columns past D)
  if (pl.kd == 64)
    return launch<64, kCap>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                            pl, sm_scale, softcap, causal, window, s);
  if (pl.kd == 128)
    return launch<128, kCap>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                             pl, sm_scale, softcap, causal, window, s);
  return launch<256, kCap>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                           pl, sm_scale, softcap, causal, window, s);
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o, const void* g,
                     const float* lse, float* scratch, void* dq, void* dk, void* dv, int B,
                     int H, int Hkv, int S, int Sk, int D, const bwd::Strides& st,
                     const Plan& pl, float sm_scale, float softcap, int causal, int window,
                     cudaStream_t s) {
  if (softcap > 0.f)
    return dispatch_d<true>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                            pl, sm_scale, softcap, causal, window, s);
  return dispatch_d<false>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                           pl, sm_scale, softcap, causal, window, s);
}

}  // namespace wg

}  // namespace

extern "C" {

// The split of a call (wgmma path for dtype 1; the FMA path has one split):
// out[0..7] = padded D, k tiles (of Sk rows), heads per block, splits, dK/dV
// blocks, dQ blocks (one per 64-row q tile of S rows, head and b), dK/dV and
// dQ dynamic shared memory bytes.  heads_per_block 0 takes the rule.
// Returns the float32 scratch the launch needs (delta, then the partials),
// or -1 for a shape the kernels do not take.
long long flash_attention_bwd_plan(int dtype, int B, int H, int Hkv, int S, int Sk, int D,
                                   int window, int heads_per_block, long long* out) {
  (void)window;
  if (B <= 0 || H <= 0 || S <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
      D > 256 || D % 8 != 0 || heads_per_block < 0 ||
      (heads_per_block > 0 && (H / Hkv) % heads_per_block != 0) || (dtype != 0 && dtype != 1))
    return -1;
  wg::Plan p = wg::plan(B, H, Hkv, S, Sk, D, dtype == 1 ? heads_per_block : H / Hkv);
  long long kv_smem = 0, q_smem = 0;
  if (p.kd == 64) {
    kv_smem = wg::KvLayout<64>::kBytes;
    q_smem = wg::QLayout<64>::kBytes;
  } else if (p.kd == 128) {
    kv_smem = wg::KvLayout<128>::kBytes;
    q_smem = wg::QLayout<128>::kBytes;
  } else {
    kv_smem = wg::KvLayout<256>::kBytes;
    q_smem = wg::QLayout<256>::kBytes;
  }
  if (dtype == 0) {
    p.kd = D <= 32 ? 32 : p.kd;
    kv_smem = q_smem = 0;  // not reported for the FMA path
  }
  const long long vals[8] = {p.kd, p.n_kt, p.heads_per_block, p.n_split,
                             static_cast<long long>(p.n_kt) * Hkv * p.n_split * B,
                             static_cast<long long>(p.n_qt) * H * B, kv_smem, q_smem};
  if (out != nullptr) memcpy(out, vals, sizeof(vals));
  return p.delta_floats + 2 * p.part_floats;
}

// q, o, do, dq: (B, H, S, D); k, v, dk, dv: (B, Hkv, Sk, D), each addressed
// by the 24 element strides in `strides` (b, h, s for q, k, v, o, do, dq,
// dk, dv in that order) with D contiguous, rows and bases 16-byte aligned.
// Sk != S (keys that are not the queries) only with causal = 0 and window =
// 0, as in the forward.  lse: (B, H, S) float32 contiguous.  delta: float32
// scratch of flash_attention_bwd_plan(...) floats, written here (delta, then
// the partial dK and dV).  dtype 0 = float32 (FMA kernels), 1 = bfloat16
// (wgmma kernels).  D a multiple of 8 up to 256; window 0 = no window;
// softcap 0 = none, else the forward's logit soft-cap.
// heads_per_block: 0 takes the plan's rule; else a divisor of the group
// (bfloat16 only; it exists to measure the rule against the alternatives).
// Launches the kernels on `stream`; returns a cudaError_t.
int flash_attention_bwd_launch_split(const void* q, const void* k, const void* v,
                                     const void* o, const void* g, const void* lse, void* delta,
                                     void* dq, void* dk, void* dv, int dtype, int B, int H,
                                     int Hkv, int S, int Sk, int D, const long long* strides,
                                     float sm_scale, float softcap, int causal, int window,
                                     int device, void* stream, int heads_per_block) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256 || D % 8 != 0 || B > 65535 ||
      H > 65535 || heads_per_block < 0 || !(softcap >= 0.f) || Sk <= 0 ||
      (Sk != S && (causal || window)) ||
      (heads_per_block > 0 && (H / Hkv) % heads_per_block != 0))
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
    return bwd::dispatch<float>(q, k, v, o, g, l, d, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                                sm_scale, softcap, causal, window, s);
  if (dtype == 1) {
    const wg::Plan p = wg::plan(B, H, Hkv, S, Sk, D, heads_per_block);
    if (p.n_kt > 65535 || p.n_qt > 65535 ||
        static_cast<long long>(Hkv) * p.n_split > 2147483647LL)
      return cudaErrorInvalidValue;
    return wg::dispatch(q, k, v, o, g, l, d, dq, dk, dv, B, H, Hkv, S, Sk, D, st, p, sm_scale,
                        softcap, causal, window, s);
  }
  return cudaErrorInvalidValue;
}

int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* g, const void* lse, void* delta, void* dq, void* dk,
                               void* dv, int dtype, int B, int H, int Hkv, int S, int Sk, int D,
                               const long long* strides, float sm_scale, float softcap,
                               int causal, int window, int device, void* stream) {
  return flash_attention_bwd_launch_split(q, k, v, o, g, lse, delta, dq, dk, dv, dtype, B, H,
                                          Hkv, S, Sk, D, strides, sm_scale, softcap, causal,
                                          window, device, stream, 0);
}

}  // extern "C"
