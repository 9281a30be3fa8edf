// Backward of the flash-attention forward (flash_attention.cu), causal
// and/or sliding window, GQA by head map.  Given q, k, v, the forward's
// output o, the output's gradient do and the forward's row log-sum-exp lse
// (natural log, float32), it computes, over the pairs (i, j) the masks keep
// (as in the forward: i < S query rows, j < Sk key rows, j <= i when causal,
// j > i - window when window > 0; Sk != S only with neither, whisper's
// cross-attention of S decoder rows over Sk = 1,500 encoder rows),
//
//   P[i, j]  = exp(c(q_i . k_j * scale) - lse_i)     (recomputed from lse)
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
// float32 (the checking dtype: the reduced configs trained against the CPU,
// the float32 mesh jobs, chip_smoke.py's float32 gates): outer products in
// fp32 FMA on the CUDA cores, for the reasons the forward's header gives
// (no TF32 in any form: one pass breaks 1e-4, three do not fit).  Bound at
// (B, H, Hkv, S, D) = (2, 8, 4, 2,048, 256), causal: 10 D x 33.57 M kept
// pairs = 86 GFLOP, 1.283 ms at 67 TFLOP/s: operations.  Two kernels, no
// delta kernel and no atomics:
//
// flash_attention_bwd_ds_kernel<D, cap>: one block of 128 threads per (64-row
//   q tile, head, b), causal the last q tile first.  Its 64 rows' delta_i =
//   do_i . o_i and lse come first, read while the first items land; then,
//   for each 64-row k tile the q tile keeps, the Q, dO, K and V tiles stream
//   through a three-slot cp.async ring in items of 32 head columns (16 at
//   D = 16), and each thread keeps 8 rows x 4 keys of S = Q K^T and of
//   dP = dO V^T (24 loads of 16 bytes for 256 FMAs), summed over the head
//   in order as the forward sums.  At a k tile's end it forms
//   P = exp(c(s scale) - lse) and dS = P c' (dP - delta) and writes both,
//   a 64 x 64 tile each, with zeros where a mask drops a pair or a row is
//   past S, to the float32 scratch: every kept tile of every head once, in
//   q-tile order (tiles_before gives a tile's place).
// flash_attention_bwd_grad_kernel<D>: one launch of two kinds of block.  A
//   dK/dV block (64-row k tile, KV head, b) reads, for each head of its
//   group in order and each q tile that keeps the k tile, 16-row items of
//   that tile's P and dS with the same rows of dO and Q, and accumulates
//   dV += P^T dO and dK += dS^T Q: 8 keys x 8 columns of each a thread at
//   D >= 128 (8 loads for 128 FMAs), 8 x 4 below (6 for 64); the group's sum
//   in a fixed order inside the block.  A dQ block (64-row q tile, head, b)
//   reads 32-key items of its consecutive dS tiles with those rows of K
//   and accumulates dQ += dS K: 8 rows x 8 columns a thread at D >= 128 (16
//   loads for 256 FMAs), 8 x 4 below (12 for 128).  Causal, rank r runs the
//   dK/dV blocks of k tile r, then the dQ blocks of q tile nqt - 1 - r, each
//   the heaviest left of its kind; otherwise every dK/dV block, then every
//   dQ block.
//
// The dQ route: dS of the kept tiles is written once and read once, where
// recomputing S and dP in a dQ kernel costs 14 D operations a kept pair
// against 10 D.  The P/dS route also keeps any operand from having to sit
// in shared memory for a whole k tile's loop: at D = 256 one 64-row float32
// tile is 64 KB, and a dK/dV block that held K and V (128 KB) would leave no
// room for a two-stage ring of Q and dO tiles large enough for 8 x 4
// micro-tiles.  The scratch is 2 x 4,096 floats a kept tile: 277 MB at the
// shape above (528 tiles a head).  A call is two launches at every shape,
// the reduced MoE rank's (2, 2, 2, 64, 16) too.  Shared memory per block:
// the P/dS kernel 98,816 B at D >= 32 (two blocks per SM), the dK/dV and
// dQ kernel 122,880 B at D = 256, 73,728 B at D = 128.  Registers (ptxas,
// sm_90a, chip_smoke.py's build log): the P/dS kernel 254 at every D, the
// dK/dV and dQ kernel 232 at D >= 128 and 167 below; no spill.  On the H100
// (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's timing line) a call at
// the shape above takes 2.67994 ms, 48% of the fp32 rate, against SDPA's
// float32 backward 3.45222 ms; at (2, 2, 2, 64, 16) 0.01676 ms against
// 0.02378.  A thread's
// accumulators and one group of loads in flight fill its 254 (232)
// registers; 8 x 8 tiles in the P/dS kernel spilled and ran slower, and
// three blocks an SM at fewer registers ran slower too.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "attention_f32.cuh"
#include "hopper.cuh"

namespace {

namespace bwd {

using namespace f32attn;
using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr int kThreads = 256;      // the delta kernel (bf16 path)
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];  // (b, h, s)
};

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

// delta = rowsum(do * o), one warp per row (the bf16 path's first kernel)
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

// ---------------------------------------------------------------------------
// float32: outer products on the CUDA cores (see the file's header)
// ---------------------------------------------------------------------------

constexpr int kTile = 64;                     // q rows and k rows of a scratch tile
constexpr int kTileFloats = kTile * kTile;    // a P or a dS tile

// the rows of a thread in a 64-row tile: 4 g + i and 32 + 4 g + i, i < 4
__device__ __forceinline__ int frow(int g, int i) { return 4 * g + (i & 3) + 32 * (i >> 2); }

// flash_attention_bwd_ds_kernel: one block of 128 threads (8 row groups x
// 16 key groups, 8 rows x 4 keys a thread) per (q tile, head, b); an item
// is kDC columns of the Q, dO, K and V tiles of one kept k tile
template <int kD>
struct DsLayout {
  static constexpr int kThreads = 128;
  static constexpr int kDC = kD < 32 ? kD : 32;   // head columns per item
  static constexpr int kCpr = kDC / 4;
  static constexpr int kItems = kD / kDC;         // items per k tile
  static constexpr int kSlots = 3;
  static constexpr int kPart = kTile * kDC;       // one operand's columns
  static constexpr int kSlot = 4 * kPart;         // Q, dO, K, V
  static constexpr int kRows = kSlots * kSlot;    // then lse (log2) and delta
  static constexpr int kBytes = (kRows + 2 * kTile) * 4;
};

// P = exp(c(q k scale) - lse) and dS = P c' (dP - delta) of every kept pair
// of the block's q tile, one 64 x 64 tile of each per kept k tile, written
// to the scratch (zeros where the masks drop a pair or a row is past S).
// scale_log2 = sm_scale log2 e; with kCap, cap_scale = sm_scale / cap and
// cap_log2 = cap log2 e, as in the forward.
template <int kD, bool kCap>
__global__ void __launch_bounds__(DsLayout<kD>::kThreads, 2)
flash_attention_bwd_ds_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ o,
                              const float* __restrict__ g, const float* __restrict__ lse,
                              float* __restrict__ scratch, int H, int group, int S, int Sk,
                              int D, Strides st, float scale_log2, float cap_scale,
                              float cap_log2, int causal, int window,
                              long long tiles_per_head) {
  using L = DsLayout<kD>;
  constexpr int kDC = L::kDC, kCpr = L::kCpr, kSlots = L::kSlots;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* lse_s = smem + L::kRows;
  float* delta_s = lse_s + kTile;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // heaviest first
  const int q0 = qt * kTile;
  const int hk = h / group;
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* gb = g + b * st.g[0] + h * st.g[1];
  const float* kb = k + b * st.k[0] + hk * st.k[1];
  const float* vb = v + b * st.v[0] + hk * st.v[1];
  const int tid = threadIdx.x;
  const int rg = tid / 16;
  const int cg = tid % 16;
  const int lo = tile_lo(qt, kTile, kTile, window);
  const int n_items = (tile_hi(qt, kTile, kTile, S, Sk, causal) - lo + 1) * L::kItems;

  auto issue = [&](int n) {
    if (n < n_items) {
      float* slot = smem + (n % kSlots) * L::kSlot;
      const int k0 = (lo + n / L::kItems) * kTile;
      const int d0 = (n % L::kItems) * kDC;
      load_tile<kTile, kDC, L::kThreads, true>(slot, qb, st.q[2], q0, S, d0, D);
      load_tile<kTile, kDC, L::kThreads, true>(slot + L::kPart, gb, st.g[2], q0, S, d0, D);
      load_tile<kTile, kDC, L::kThreads, true>(slot + 2 * L::kPart, kb, st.k[2], k0, Sk, d0, D);
      load_tile<kTile, kDC, L::kThreads, true>(slot + 3 * L::kPart, vb, st.v[2], k0, Sk, d0, D);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < kSlots - 1; ++n) issue(n);

  // while they land: delta_i = do_i . o_i (two threads a row) and lse in
  // the log2 domain, for the block's 64 rows
  {
    const int r = tid / 2;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < S) {
      const float* orow = o + b * st.o[0] + h * st.o[1] + static_cast<long long>(row) * st.o[2];
      const float* grow = gb + static_cast<long long>(row) * st.g[2];
      for (int col = 4 * (tid % 2); col < D; col += 8)
        acc = dot4(__ldg(reinterpret_cast<const float4*>(orow + col)),
                   __ldg(reinterpret_cast<const float4*>(grow + col)), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid % 2 == 0) {
      delta_s[r] = acc;
      lse_s[r] = row < S ? lse[(static_cast<long long>(b) * H + h) * S + row] * kLog2e
                         : INFINITY;
    }
  }

  float* tiles = scratch + (((static_cast<long long>(b) * H + h) * tiles_per_head +
                             tiles_before(qt, S, Sk, causal, window)) *
                            2 * kTileFloats);
  float s[8][4], dp[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;

  for (int n = 0; n < n_items; ++n) {
    cp_async_wait<kSlots - 2>();
    __syncthreads();
    issue(n + kSlots - 1);
    const float* Qs = smem + (n % kSlots) * L::kSlot;
    const float* Gs = Qs + L::kPart;
    const float* Ks = Gs + L::kPart;
    const float* Vs = Ks + L::kPart;
    // S = Q K^T and dP = dO V^T over the item's columns: 8 rows x 4 keys
    // each, 24 loads of 16 bytes for 256 FMAs
#pragma unroll 2
    for (int c = 0; c < kCpr; ++c) {
      float4 kf[4], vf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = 4 * cg + j;
        kf[j] = ld4(Ks + key * kDC + 4 * swz<kCpr>(key, c));
        vf[j] = ld4(Vs + key * kDC + 4 * swz<kCpr>(key, c));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = frow(rg, i);
        const float4 qf = ld4(Qs + row * kDC + 4 * swz<kCpr>(row, c));
        const float4 gf = ld4(Gs + row * kDC + 4 * swz<kCpr>(row, c));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(qf, kf[j], s[i][j]);
          dp[i][j] = dot4(gf, vf[j], dp[i][j]);
        }
      }
    }
    if (n % L::kItems != L::kItems - 1) continue;

    // the k tile is complete: its P and dS tiles into the scratch
    const int t = n / L::kItems;
    const int k0 = (lo + t) * kTile;
    float* tp = tiles + static_cast<long long>(t) * 2 * kTileFloats;
    float* td = tp + kTileFloats;
    const bool edge = k0 + kTile > Sk || q0 + kTile > S || (causal && k0 + kTile - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kTile - 1 - window);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = frow(rg, i);
      const float li = lse_s[r], di = delta_s[r];
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x, dc = 1.f;
        if (kCap) {
          const float tt = tanhf(s[i][j] * cap_scale);
          x = tt * cap_log2;
          dc = 1.f - tt * tt;
        } else {
          x = s[i][j] * scale_log2;
        }
        float pij = exp2f(x - li);
        if (edge && !kept(q0 + r, k0 + 4 * cg + j, S, Sk, causal, window)) pij = 0.f;
        p[j] = pij;
        ds[j] = pij * dc * (dp[i][j] - di);
        s[i][j] = dp[i][j] = 0.f;
      }
      st4(tp + r * kTile + 4 * cg, make_float4(p[0], p[1], p[2], p[3]));
      st4(td + r * kTile + 4 * cg, make_float4(ds[0], ds[1], ds[2], ds[3]));
    }
  }
}

// flash_attention_bwd_grad_kernel: 8 x kNCG threads, kTC output columns
// each; a dK/dV block keeps 8 keys x kTC columns of dK and of dV a thread,
// a dQ block 8 rows x kTC columns of dQ
template <int kD>
struct GradLayout {
  static constexpr int kTC = kD >= 128 ? 8 : 4;   // output columns a thread
  static constexpr int kNCG = kD / kTC;           // column groups
  static constexpr int kThreads = 8 * kNCG;
  static constexpr int kBQC = 16;                  // q rows per dK/dV item
  static constexpr int kBKC = 32;                  // k rows per dQ item
  static constexpr int kSlots = 3;
  // dK/dV item: P and dS (kBQC x 64), dO and Q (kBQC x kD); dQ item: dS
  // (64 x kBKC), K (kBKC x kD): the same floats at every kD
  static constexpr int kSlot = kBQC * (2 * kTile + 2 * kD);
  static_assert(kSlot == kTile * kBKC + kBKC * kD, "the two items fill one slot");
  static constexpr int kBytes = kSlots * kSlot * 4;
  static constexpr int kMinBlocks = kD >= 256 ? 1 : 2;
};

// dK and dV of 64 keys (k tile kt, KV head hk, batch b) from the scratch
// tiles of the q tiles that keep them, over the group's heads in order
template <int kD>
__device__ __forceinline__ void dkdv_block(float* smem, const float* __restrict__ q,
                                           const float* __restrict__ g,
                                           const float* __restrict__ scratch,
                                           float* __restrict__ dk, float* __restrict__ dv,
                                           int kt, int hk, int b, int H, int group, int S,
                                           int Sk, int D, const Strides& st, float sm_scale,
                                           int causal, int window, long long tiles_per_head) {
  using L = GradLayout<kD>;
  constexpr int kTC = L::kTC, kNCG = L::kNCG, kBQC = L::kBQC, kSlots = L::kSlots;
  constexpr int kPer = kTile / kBQC;   // items per (head, q tile)
  const int tid = threadIdx.x;
  const int kg = tid / kNCG;
  const int cg = tid % kNCG;
  const int nqt = (S + kTile - 1) / kTile;

  // the q tiles that keep k tile kt: [qa, qb], and the kept tiles before qa
  int qa = 0;
  long long pre_qa = 0;
  while (qa < nqt && tile_hi(qa, kTile, kTile, S, Sk, causal) < kt) {
    pre_qa += tile_hi(qa, kTile, kTile, S, Sk, causal) - tile_lo(qa, kTile, kTile, window) + 1;
    ++qa;
  }
  int qb = qa;
  while (qb + 1 < nqt && tile_lo(qb + 1, kTile, kTile, window) <= kt) ++qb;
  const int n_items = group * (qb - qa + 1) * kPer;

  // the producer's cursor: head gi of the group, q tile qt (pre: its first
  // kept tile's index in the head), item r of it
  int gi = 0, qt = qa, r = 0;
  long long pre = pre_qa;
  auto issue = [&](int n) {
    if (n < n_items) {
      float* slot = smem + (n % kSlots) * L::kSlot;
      const int h = hk * group + gi;
      const long long tile = (static_cast<long long>(b) * H + h) * tiles_per_head + pre + kt -
                             tile_lo(qt, kTile, kTile, window);
      const float* src = scratch + tile * 2 * kTileFloats + r * kBQC * kTile;
      // P rows then dS rows of the tile: contiguous
      for (int i = tid; i < 2 * kBQC * kTile / 4; i += L::kThreads) {
        const int part = i / (kBQC * kTile / 4);
        const int j = i % (kBQC * kTile / 4);
        cp_async16(slot + part * kBQC * kTile + 4 * j, src + part * kTileFloats + 4 * j);
      }
      const int row0 = qt * kTile + r * kBQC;
      float* gs = slot + 2 * kBQC * kTile;
      load_tile<kBQC, kD, L::kThreads, false>(gs, g + b * st.g[0] + h * st.g[1], st.g[2], row0,
                                              S, 0, D);
      load_tile<kBQC, kD, L::kThreads, false>(gs + kBQC * kD, q + b * st.q[0] + h * st.q[1],
                                              st.q[2], row0, S, 0, D);
      if (++r == kPer) {
        r = 0;
        pre += tile_hi(qt, kTile, kTile, S, Sk, causal) - tile_lo(qt, kTile, kTile, window) + 1;
        if (++qt > qb) {
          qt = qa;
          pre = pre_qa;
          ++gi;
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < kSlots - 1; ++n) issue(n);

  float4 acc_v[8][kTC / 4], acc_k[8][kTC / 4];
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int c = 0; c < kTC / 4; ++c)
      acc_v[e][c] = acc_k[e][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int n = 0; n < n_items; ++n) {
    cp_async_wait<kSlots - 2>();
    __syncthreads();
    issue(n + kSlots - 1);
    const float* Ps = smem + (n % kSlots) * L::kSlot;
    const float* dSs = Ps + kBQC * kTile;
    const float* Gs = dSs + kBQC * kTile;
    const float* Qs = Gs + kBQC * kD;
    // dV += P^T dO, dK += dS^T Q: per q row 4 + kTC / 2 loads of 16 bytes
    // for 16 kTC FMAs; keys 4 kg + e and 32 + 4 kg + e
#pragma unroll 4
    for (int rq = 0; rq < kBQC; ++rq) {
      const float4 pa = ld4(Ps + rq * kTile + 4 * kg), pb = ld4(Ps + rq * kTile + 32 + 4 * kg);
      const float4 sa = ld4(dSs + rq * kTile + 4 * kg), sb = ld4(dSs + rq * kTile + 32 + 4 * kg);
      const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float ds[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
      for (int c = 0; c < kTC / 4; ++c) {
        const float4 gf = ld4(Gs + rq * kD + 4 * (cg + kNCG * c));
        const float4 qf = ld4(Qs + rq * kD + 4 * (cg + kNCG * c));
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          axpy4(p[e], gf, acc_v[e][c]);
          axpy4(ds[e], qf, acc_k[e][c]);
        }
      }
    }
  }

  float* dkb = dk + b * st.dk[0] + hk * st.dk[1];
  float* dvb = dv + b * st.dv[0] + hk * st.dv[1];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int row = kt * kTile + frow(kg, e);
    if (row >= Sk) continue;
#pragma unroll
    for (int c = 0; c < kTC / 4; ++c) {
      const int col = 4 * (cg + kNCG * c);
      if (col >= D) continue;
      const float4 a = acc_k[e][c];
      st4(dkb + static_cast<long long>(row) * st.dk[2] + col,
          make_float4(a.x * sm_scale, a.y * sm_scale, a.z * sm_scale, a.w * sm_scale));
      st4(dvb + static_cast<long long>(row) * st.dv[2] + col, acc_v[e][c]);
    }
  }
}

// dQ of 64 query rows (q tile qt, head h, batch b): scale dS K over the
// block's kept k tiles, their dS tiles consecutive in the scratch
template <int kD>
__device__ __forceinline__ void dq_block(float* smem, const float* __restrict__ k,
                                         const float* __restrict__ scratch,
                                         float* __restrict__ dq, int qt, int h, int b, int H,
                                         int group, int S, int Sk, int D, const Strides& st,
                                         float sm_scale, int causal, int window,
                                         long long tiles_per_head) {
  using L = GradLayout<kD>;
  constexpr int kTC = L::kTC, kNCG = L::kNCG, kBKC = L::kBKC, kSlots = L::kSlots;
  constexpr int kPer = kTile / kBKC;   // items per k tile
  constexpr int kCpr = kBKC / 4;
  const int tid = threadIdx.x;
  const int qg = tid / kNCG;
  const int cg = tid % kNCG;
  const int lo = tile_lo(qt, kTile, kTile, window);
  const int n_items = (tile_hi(qt, kTile, kTile, S, Sk, causal) - lo + 1) * kPer;
  const float* tiles = scratch + ((static_cast<long long>(b) * H + h) * tiles_per_head +
                                  tiles_before(qt, S, Sk, causal, window)) *
                                     2 * kTileFloats;
  const float* kb = k + b * st.k[0] + (h / group) * st.k[1];

  auto issue = [&](int n) {
    if (n < n_items) {
      float* slot = smem + (n % kSlots) * L::kSlot;
      const int t = n / kPer;
      const int c0 = (n % kPer) * kBKC;
      // kBKC columns of the tile's dS, 64 rows, swizzled
      const float* src = tiles + static_cast<long long>(t) * 2 * kTileFloats + kTileFloats + c0;
      for (int i = tid; i < kTile * kCpr; i += L::kThreads) {
        const int row = i / kCpr;
        const int c = i % kCpr;
        cp_async16(slot + row * kBKC + 4 * swz<kCpr>(row, c), src + row * kTile + 4 * c);
      }
      load_tile<kBKC, kD, L::kThreads, false>(slot + kTile * kBKC, kb, st.k[2],
                                              (lo + t) * kTile + c0, Sk, 0, D);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < kSlots - 1; ++n) issue(n);

  float4 acc[8][kTC / 4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < kTC / 4; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int n = 0; n < n_items; ++n) {
    cp_async_wait<kSlots - 2>();
    __syncthreads();
    issue(n + kSlots - 1);
    const float* dSs = smem + (n % kSlots) * L::kSlot;
    const float* Ks = dSs + kTile * kBKC;
    // dQ += dS K: per 4 keys 8 + kTC loads of 16 bytes for 32 kTC FMAs
#pragma unroll 4
    for (int c = 0; c < kCpr; ++c) {
      float4 kf[4][kTC / 4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int cc = 0; cc < kTC / 4; ++cc)
          kf[kk][cc] = ld4(Ks + (4 * c + kk) * kD + 4 * (cg + kNCG * cc));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = frow(qg, i);
        const float4 d4 = ld4(dSs + row * kBKC + 4 * swz<kCpr>(row, c));
#pragma unroll
        for (int cc = 0; cc < kTC / 4; ++cc) {
          axpy4(d4.x, kf[0][cc], acc[i][cc]);
          axpy4(d4.y, kf[1][cc], acc[i][cc]);
          axpy4(d4.z, kf[2][cc], acc[i][cc]);
          axpy4(d4.w, kf[3][cc], acc[i][cc]);
        }
      }
    }
  }

  float* dqb = dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = qt * kTile + frow(qg, i);
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kTC / 4; ++c) {
      const int col = 4 * (cg + kNCG * c);
      if (col >= D) continue;
      const float4 a = acc[i][c];
      st4(dqb + static_cast<long long>(row) * st.dq[2] + col,
          make_float4(a.x * sm_scale, a.y * sm_scale, a.z * sm_scale, a.w * sm_scale));
    }
  }
}

// the block's role and tile: causal, rank r = 0, 1, ... holds the dK/dV
// blocks of k tile r, then the dQ blocks of q tile nqt - 1 - r (each the
// heaviest left of its kind); otherwise every dK/dV block, then every dQ
// block (all alike within a kind)
struct GradBlock {
  bool kv;
  int tile, head, b;
};

__host__ __device__ __forceinline__ GradBlock grad_block(long long idx, int B, int H, int Hkv,
                                                         int nqt, int nkt, int causal) {
  const long long n_kv = static_cast<long long>(Hkv) * B, n_q = static_cast<long long>(H) * B;
  GradBlock gb;
  long long j;
  if (causal) {
    const long long r = idx / (n_kv + n_q);
    j = idx % (n_kv + n_q);
    gb.kv = j < n_kv;
    if (!gb.kv) j -= n_kv;
    gb.tile = static_cast<int>(gb.kv ? r : nqt - 1 - r);
  } else if (idx < nkt * n_kv) {
    gb.kv = true;
    gb.tile = static_cast<int>(idx / n_kv);
    j = idx % n_kv;
  } else {
    gb.kv = false;
    idx -= nkt * n_kv;
    gb.tile = static_cast<int>(idx / n_q);
    j = idx % n_q;
  }
  const int heads = gb.kv ? Hkv : H;
  gb.head = static_cast<int>(j % heads);
  gb.b = static_cast<int>(j / heads);
  return gb;
}

template <int kD>
__global__ void __launch_bounds__(GradLayout<kD>::kThreads, GradLayout<kD>::kMinBlocks)
flash_attention_bwd_grad_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ g, const float* __restrict__ scratch,
                                float* __restrict__ dq, float* __restrict__ dk,
                                float* __restrict__ dv, int B, int H, int Hkv, int S, int Sk,
                                int D, Strides st, float sm_scale, int causal, int window,
                                long long tiles_per_head) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int group = H / Hkv;
  const GradBlock gb = grad_block(blockIdx.x, B, H, Hkv, (S + kTile - 1) / kTile,
                                  (Sk + kTile - 1) / kTile, causal);
  if (gb.kv)
    dkdv_block<kD>(smem, q, g, scratch, dk, dv, gb.tile, gb.head, gb.b, H, group, S, Sk, D, st,
                   sm_scale, causal, window, tiles_per_head);
  else
    dq_block<kD>(smem, k, scratch, dq, gb.tile, gb.head, gb.b, H, group, S, Sk, D, st, sm_scale,
                 causal, window, tiles_per_head);
}

inline long long tiles_per_head(int S, int Sk, int causal, int window) {
  return tiles_before((S + kTile - 1) / kTile, S, Sk, causal, window);
}

template <int kD, bool kCap>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* g,
                   const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int H,
                   int Hkv, int S, int Sk, int D, const Strides& st, float sm_scale,
                   float softcap, int causal, int window, cudaStream_t stream) {
  const long long tph = tiles_per_head(S, Sk, causal, window);
  const int nqt = (S + kTile - 1) / kTile, nkt = (Sk + kTile - 1) / kTile;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tg = static_cast<const float*>(g);
  cudaError_t err = allow_smem<&flash_attention_bwd_ds_kernel<kD, kCap>>(DsLayout<kD>::kBytes);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_ds_kernel<kD, kCap>
      <<<dim3(H, B, nqt), DsLayout<kD>::kThreads, DsLayout<kD>::kBytes, stream>>>(
          tq, tk, static_cast<const float*>(v), static_cast<const float*>(o), tg, lse, scratch,
          H, H / Hkv, S, Sk, D, st, sm_scale * kLog2e, kCap ? sm_scale / softcap : 0.f,
          softcap * kLog2e, causal, window, tph);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using G = GradLayout<kD>;
  err = allow_smem<&flash_attention_bwd_grad_kernel<kD>>(G::kBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(nkt) * Hkv * B + static_cast<long long>(nqt) * H * B;
  flash_attention_bwd_grad_kernel<kD><<<static_cast<unsigned>(blocks), G::kThreads, G::kBytes,
                                        stream>>>(
      tq, tk, tg, scratch, static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), B, H, Hkv, S, Sk, D, st, sm_scale, causal, window, tph);
  return cudaGetLastError();
}

template <bool kCap>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* o,
                       const void* g, const float* lse, float* scratch, void* dq, void* dk,
                       void* dv, int B, int H, int Hkv, int S, int Sk, int D,
                       const Strides& st, float sm_scale, float softcap, int causal, int window,
                       cudaStream_t s) {
  switch (instance_d(D)) {
    case 16:
      return launch<16, kCap>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                              sm_scale, softcap, causal, window, s);
    case 32:
      return launch<32, kCap>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                              sm_scale, softcap, causal, window, s);
    case 64:
      return launch<64, kCap>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                              sm_scale, softcap, causal, window, s);
    case 128:
      return launch<128, kCap>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                               sm_scale, softcap, causal, window, s);
    default:
      return launch<256, kCap>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                               sm_scale, softcap, causal, window, s);
  }
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o, const void* g,
                     const float* lse, float* scratch, void* dq, void* dk, void* dv, int B,
                     int H, int Hkv, int S, int Sk, int D, const Strides& st, float sm_scale,
                     float softcap, int causal, int window, cudaStream_t s) {
  if (softcap > 0.f)
    return dispatch_d<true>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                            sm_scale, softcap, causal, window, s);
  return dispatch_d<false>(q, k, v, o, g, lse, scratch, dq, dk, dv, B, H, Hkv, S, Sk, D, st,
                           sm_scale, softcap, causal, window, s);
}

// threads and dynamic shared memory of the two kernels of instance kD
template <int kD>
void sizes_of(long long* grad_threads, long long* grad_bytes, long long* ds_bytes) {
  *grad_threads = GradLayout<kD>::kThreads;
  *grad_bytes = GradLayout<kD>::kBytes;
  *ds_bytes = DsLayout<kD>::kBytes;
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

// The split of a call.  bfloat16 (dtype 1): out[0..7] = padded D, k tiles
// (of Sk rows), heads per block, splits, dK/dV blocks, dQ blocks (one per
// 64-row q tile of S rows, head and b), dK/dV and dQ dynamic shared memory
// bytes; heads_per_block 0 takes the rule.  float32 (dtype 0): instance D,
// k tiles, heads per block (the group: a dK/dV block sums all its heads),
// 1, dK/dV blocks, dQ blocks, then the dynamic shared memory bytes of
// flash_attention_bwd_grad_kernel (which runs both kinds of block) and of
// flash_attention_bwd_ds_kernel.  Returns the float32 scratch the launch
// needs (bfloat16: delta, then the partials; float32: a P and a dS tile for
// every kept 64 x 64 tile, which depend on causal and window), or -1 for a
// shape the kernels do not take.
long long flash_attention_bwd_plan(int dtype, int B, int H, int Hkv, int S, int Sk, int D,
                                   int causal, int window, int heads_per_block,
                                   long long* out) {
  if (B <= 0 || H <= 0 || S <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
      D > 256 || D % 8 != 0 || heads_per_block < 0 ||
      (heads_per_block > 0 && (H / Hkv) % heads_per_block != 0) || (dtype != 0 && dtype != 1))
    return -1;
  if (dtype == 0) {
    const int nqt = (S + 63) / 64, nkt = (Sk + 63) / 64;
    long long threads = 0, grad_bytes = 0, ds_bytes = 0;
    const int kd = f32attn::instance_d(D);
    if (kd == 16) bwd::sizes_of<16>(&threads, &grad_bytes, &ds_bytes);
    else if (kd == 32) bwd::sizes_of<32>(&threads, &grad_bytes, &ds_bytes);
    else if (kd == 64) bwd::sizes_of<64>(&threads, &grad_bytes, &ds_bytes);
    else if (kd == 128) bwd::sizes_of<128>(&threads, &grad_bytes, &ds_bytes);
    else bwd::sizes_of<256>(&threads, &grad_bytes, &ds_bytes);
    const long long vals[8] = {kd, nkt, H / Hkv, 1, static_cast<long long>(nkt) * Hkv * B,
                               static_cast<long long>(nqt) * H * B, grad_bytes, ds_bytes};
    if (out != nullptr) memcpy(out, vals, sizeof(vals));
    return 2LL * bwd::kTileFloats * B * H * bwd::tiles_per_head(S, Sk, causal, window);
  }
  wg::Plan p = wg::plan(B, H, Hkv, S, Sk, D, heads_per_block);
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
// scratch of flash_attention_bwd_plan(...) floats (with this call's causal
// and window), written here.  dtype 0 = float32 (two FMA kernels), 1 =
// bfloat16 (wgmma kernels).  D a multiple of 8 up to 256; window 0 = no
// window; softcap 0 = none, else the forward's logit soft-cap.
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
  if (dtype == 0) {
    const long long nqt = (S + 63) / 64, nkt = (Sk + 63) / 64;
    if (nqt > 65535 || nkt * Hkv * B + nqt * H * B > 2147483647LL) return cudaErrorInvalidValue;
    return bwd::dispatch(q, k, v, o, g, l, d, dq, dk, dv, B, H, Hkv, S, Sk, D, st, sm_scale,
                         softcap, causal, window, s);
  }
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
