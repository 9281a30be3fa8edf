// Online-softmax (flash) attention forward, causal and/or sliding window,
// GQA by head map:
//
//   out[b, h, i] = sum_j softmax_j(c(q[b, h, i] . k[b, h / G, j] * scale)) v[b, h / G, j]
//
// over the columns j < Sk that the masks keep (j <= i when causal,
// j > i - window when window > 0), the output written in the inputs' type.
// i runs over the S query rows and j over the Sk key rows: Sk = S for
// self-attention; Sk != S only without causal mask and window (whisper's
// cross-attention, S decoder rows over Sk = 1,500 encoder rows), which the
// wrapper alone lets through.
// c is the identity, or with a soft-cap > 0 the reference model's logit
// soft-cap c(x) = cap tanh(x / cap) (flash_chunked), formed with tanhf
// before the mask and the softmax.
// q, k, v and out are addressed by strides (the head dimension contiguous),
// so the model's (B, S, H, D) activations are read and written in place,
// without a transpose.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention/
// flash_attention.py: _kernel, launched by flash_attention().
//
// Bound on the H100 at gemma3-4b's prefill (B = 2, H = 8, Hkv = 4,
// D = 256, S = 2,048): operations.  A causal global layer holds
// 4 B H D S (S + 1) / 2 = 34 GFLOP, 0.035 ms at the dense bf16 tensor-core
// rate (989 TFLOP/s); its q, k, v and out are 25 MB, 0.0075 ms at
// 3.35 TB/s.
//
// Two kernels, chosen by dtype; neither falls back to the other.
//
// bfloat16, flash_attention_wgmma_kernel (the served model's path): the
// products run on the tensor cores with wgmma.  One block of two consumer
// warpgroups per (b, h, 128 query rows), 64 rows each.  The q tile is loaded
// once by TMA; 64-row k and v tiles, bf16 as stored, arrive by TMA
// (cp.async.bulk.tensor, 128-byte swizzle, rows past S and columns past D
// filled with zeros) into a two-stage ring guarded by mbarriers: thread 0
// refills a stage once all 256 threads have released it, so the next
// tile's load overlaps this tile's products.  Per k tile each warpgroup
// runs S = q k^T as 64 x 64 wgmmas with both operands in shared memory
// (bf16 x bf16 products are exact in fp32 and summed in fp32, as the
// reference computes after its cast to f32), the online softmax in
// registers, then O += P v as register-A wgmmas against v in shared memory
// (v is MN-major there, read transposed by the instruction).  P is split
// in two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi), each run
// through its own wgmma into the same fp32 accumulator: p is carried to
// about 2^-17 relative, where one bf16 rounding (2^-9) would put errors of
// half a bf16 unit of the output on top of the output's own rounding and
// break the half-unit limit that chip_smoke.py holds bf16 outputs to.  The
// split costs 1.5x the nominal products; the bound keeps the least work.
// Shared memory at D = 256: q 64 KB + 2 stages x (k 32 KB + v 32 KB) =
// 192 KB, one block per SM.  Registers per thread: the 64 x 256 fp32 O
// accumulator 128, S 32, the two P terms 32; ptxas gives the D = 256
// kernel 222 registers and no spill (D = 128: 167, D = 64: 128), which
// fits 256 threads only at one block per SM; chip_smoke.py prints the
// build log's counts.  The grid puts the q tile on its slowest axis,
// heaviest first under causal masking, so the long tiles start in the
// first wave; k tiles that every row of a block masks (above the
// diagonal, or wholly before the window) are not loaded, and a warpgroup
// whose rows all mask a loaded tile skips its products.
// D = 16..256 runs in tiles of 64, 128 or 256 columns, zero-filled past D.
//
// Both kernels also write each row's log-sum-exp of its kept scaled (and
// capped) scores, lse[b, h, i] = log sum_j exp(c(q_i . k_j * scale)) (natural log, float32,
// (B, H, S) contiguous; +inf for a row that keeps no column), when the
// caller passes a pointer: the backward (flash_attention_bwd.cu) recomputes
// the probabilities from it.  A null pointer writes nothing, so the serving
// path runs as it did.  The wgmma kernel keeps its running max in base 2
// (scores times scale * log2 e; with a cap, cap tanh(s scale / cap) times
// log2 e: the cap is formed first, log2 e folded in after) and converts at
// the store.  The capped wgmma kernel is its own instance (kCap), so the
// uncapped one compiles as it did.
//
// float32, flash_attention_f32_kernel<D, cap> (the checking dtype: the
// reduced configs trained and served against the CPU, the float32 mesh jobs,
// every float32 gate of chip_smoke.py): outer products in fp32 FMA on the
// CUDA cores.  One TF32 pass keeps 10 mantissa bits and breaks the 1e-4
// float32 limits; a three-pass split TF32 needs a hi and a lo copy of every
// shared-memory operand (K and V resident at D = 256 would be 4 x 64 KB,
// over the 227 KB a block may have), and wgmma reads TF32 only K-major, so
// V would be transposed in shared memory.  So the CUDA cores' own route, as
// SGEMM takes it: shared memory, cp.async rings and register micro-tiles.
// Bound at (B, H, Hkv, S, D) = (2, 8, 4, 2,048, 256), causal: the same
// 34.4 GFLOP at the fp32 rate (67 TFLOP/s), 0.513 ms: operations.
// One block per (head, b, 64-row q tile), the q tile on the grid's slowest
// axis and, causal, last first (the tiles with the most keys start in the
// first wave).  Instances D = 16, 32, 64, 128 and 256; another multiple of
// 8 runs in the next one up, its columns past D zero (96 in 128).  The
// block's q rows arrive once by 16-byte cp.async.cg; the K and V tiles of
// the k tiles the block keeps arrive in turn into a ring of kSlots slots
// (2 at D >= 128, 4 below), each slot's copies in flight while the tile
// before it is multiplied: at D >= 128 K of tile t + 1 lands during P V of
// tile t and V of tile t during Q K^T, below two tiles ahead.  Rows past S
// or Sk and columns past D are zero-filled by the copy (src-size 0).  Every
// product is an outer product from registers: Q K^T gives a thread 8 rows
// x 4 keys (12 loads of 16 bytes for 128 FMAs), P V 8 rows x 4 kOC columns
// through P^T in shared memory (at D = 256 6 loads for 128 FMAs, at
// D <= 64 3 for 32).  Tiles are swizzled (f32attn::at: a chunk XORed with
// its row / 4), so a warp's loads broadcast or touch 8 bank groups.
// Threads: 8 row groups x 16 key groups (128) at D >= 64, x 8 (64) at 32,
// x 4 (32) at 16; a k tile is 4 keys a key group.  The softmax is online in
// base 2: the tile's max by shuffles across the row's key groups, the sums
// per thread until the end.  Shared memory per block: D = 256 212,992 B
// (the q rows 64 KB, one K and one V tile 64 KB each, P^T 16 KB), so one
// block of 4 warps per SM: the q rows and one K and one V tile are already
// 192 KB; D = 128 114,688 B and D = 64 98,304 B, two blocks per SM.
// Registers (ptxas, sm_90a, chip_smoke.py's build log): 255 at D = 256
// (the capped instance spills 8 bytes), 248 and 246 at 128, 202-208 at 64
// and 32, 168 and 196 at 16; no other spill.
// On the H100 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's timing
// line) the (2, 8, 4, 2,048, 256) causal call takes 1.17983 ms, 43% of
// the fp32 rate, against SDPA's float32 2.47260 ms.  What holds it back is
// the one block of 4 warps a shared memory of 213 KB allows: one warp per
// SM sub-partition, every load's latency exposed where the 255 registers
// leave no room for more loads in flight.  Splitting the head's columns
// over two warpgroups (8 warps, the scores summed from two halves) ran
// faster but summed q . k in another order, and against the float32 plain
// version the capped D = 256 backward then left its 1e-4 gate, so it is not
// taken.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int kBM = 128;             // query rows per block
constexpr int kBN = 64;              // key rows per k tile
constexpr int kThreads = 256;        // two warpgroups of 64 query rows
constexpr int kStages = 2;           // k/v ring depth
constexpr int kPanelBytes = 64 * 128;  // 64 rows x 64 bf16 columns (128 B, swizzled)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int kD>
struct Layout {
  static constexpr int kPanels = kD / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 64 rows x kD
  static constexpr int kQ = 0;                               // 2 tiles
  static constexpr int kK = 2 * kTileBytes;                  // kStages tiles
  static constexpr int kV = kK + kStages * kTileBytes;       // kStages tiles
  static constexpr int kBar = kV + kStages * kTileBytes;     // 5 mbarriers
  static constexpr int kBytes = kBar + 64 + 1024;            // + alignment slack
};

// scale_log2 = sm_scale log2 e; with kCap, cap_scale = sm_scale / cap and
// cap_log2 = cap log2 e
template <int kD, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                             int group, int S, int Sk, int D,
                             long long osb, long long osh, long long oss,
                             float scale_log2, float cap_scale, float cap_log2,
                             int causal, int window) {
  using L = Layout<kD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_q + 1;              // kStages: a k/v tile has landed
  uint64_t* empty = full + kStages;        // kStages: all threads are done with it

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // heaviest first
  const int hk = h / group;
  const int q0 = qt * kBM;
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int lane = tid % 32;
  const int r_base = q0 + 64 * wgi;        // this warpgroup's first query row
  const bool live = r_base < S;
  const int nq = (q0 + 64 < S) ? 2 : 1;    // q tiles that hold rows < S

  // k tiles that some row of the block keeps: [kt0, kt0 + n_tiles)
  int kt0 = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;        // first column row q0 keeps
    kt0 = lo > 0 ? lo / kBN : 0;
  }
  const int k_rows = causal ? min(Sk, q0 + kBM) : Sk;
  const int n_tiles = (k_rows + kBN - 1) / kBN - kt0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int t) {
    const int s = t % kStages;
    const int row = (kt0 + t) * kBN;
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
    mbar_expect_tx(bar_q, nq * L::kTileBytes);
    for (int w = 0; w < nq; ++w)
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(smem + L::kQ + w * L::kTileBytes + p * kPanelBytes, &tq, 64 * p,
                 q0 + 64 * w, h, b, bar_q);
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_kv(t);
  }

  // this thread's accumulator rows (wgmma m64 layout) and columns
  const int row0 = r_base + (tid % 128) / 32 * 16 + lane / 4;
  const int row1 = row0 + 8;
  const int cq = 2 * (lane % 4);

  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const uint8_t* qs = smem + L::kQ + wgi * L::kTileBytes;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    const int parity = (t / kStages) & 1;
    const int k0 = (kt0 + t) * kBN;
    mbar_wait(&full[stage], parity);
    // does any row of this warpgroup keep a column of this tile?
    bool any = live;
    if (causal && k0 > r_base + 63) any = false;
    if (window > 0 && k0 + kBN - 1 <= r_base - window) any = false;
    if (any) {
      const uint8_t* ks = smem + L::kK + stage * L::kTileBytes;
      const uint8_t* vs = smem + L::kV + stage * L::kTileBytes;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
        wgmma_ss_n64(s, desc(qs + off, 16, 1024), desc(ks + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale (and cap) into the log2 domain and mask
      const bool edge = k0 + kBN > Sk || (causal && k0 + kBN - 1 > r_base) ||
                        (window > 0 && k0 <= r_base + 63 - window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = kCap ? tanhf(s[4 * j + e] * cap_scale) * cap_log2
                         : s[4 * j + e] * scale_log2;
          if (edge) {
            const int col = k0 + 8 * j + cq + (e & 1);
            const int row = e < 2 ? row0 : row1;
            const bool keep = col < Sk && (!causal || col <= row) &&
                              (window <= 0 || col > row - window);
            x = keep ? x : -INFINITY;
          }
          s[4 * j + e] = x;
        }
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        t0 = fmaxf(t0, fmaxf(s[4 * j], s[4 * j + 1]));
        t1 = fmaxf(t1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      // the four lanes of one row are neighbours
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
      const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
      // a row with nothing kept so far keeps max -inf: subtract 0 instead,
      // so no exp(-inf - -inf) is formed
      const float u0 = n0 == -INFINITY ? 0.f : n0;
      const float u1 = n1 == -INFINITY ? 0.f : n1;
      const float alpha0 = exp2f(m0 - u0), alpha1 = exp2f(m1 - u1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(s[4 * j] - u0), p1 = exp2f(s[4 * j + 1] - u0);
        const float p2 = exp2f(s[4 * j + 2] - u1), p3 = exp2f(s[4 * j + 3] - u1);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        // A fragment of k step j / 2: a0 (row0, cols 0-7), a1 (row1, 0-7),
        // a2 (row0, 8-15), a3 (row1, 8-15), two columns per register
        const __nv_bfloat16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
        const __nv_bfloat16 h2 = __float2bfloat16_rn(p2), h3 = __float2bfloat16_rn(p3);
        const int kk = j / 2, r = (j % 2) * 2;
        ph[kk][r] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
        ph[kk][r + 1] = pack_bf16(__bfloat162float(h2), __bfloat162float(h3));
        pl[kk][r] = pack_bf16(p0 - __bfloat162float(h0), p1 - __bfloat162float(h1));
        pl[kk][r + 1] = pack_bf16(p2 - __bfloat162float(h2), p3 - __bfloat162float(h3));
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        // 16 key rows of v: K groups of 8 rows 1,024 B apart, 64-column
        // panels kPanelBytes apart
        const uint64_t dv = desc(vs + kk * 16 * 128, kPanelBytes, 1024);
        wgmma_rs<kD>(acc, ph[kk], dv);
        wgmma_rs<kD>(acc, pl[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(&empty[stage]);
    if (tid == 0 && t + kStages < n_tiles) {
      mbar_wait(&empty[stage], parity);
      load_kv(t + kStages);
    }
    __syncwarp();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && lane % 4 == 0) {
    // the quad's lanes hold the same max and sum: lane 0 of it stores
    float* lb = lse + (static_cast<long long>(b) * gridDim.x + h) * S;
    if (row0 < S) lb[row0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : INFINITY;
    if (row1 < S) lb[row1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : INFINITY;
  }
  __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + cq;
    if (col < D) {
      const __nv_bfloat162 v0 = __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      const __nv_bfloat162 v1 = __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      if (row0 < S) *reinterpret_cast<__nv_bfloat162*>(ob + row0 * oss + col) = v0;
      if (row1 < S) *reinterpret_cast<__nv_bfloat162*>(ob + row1 * oss + col) = v1;
    }
  }
}


template <int kD, bool kCap>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int Hkv, int S, int Sk, int D, const long long* st, float sm_scale,
                   float softcap, int causal, int window, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, B, H, S, D, st[0], st[1], st[2]);
  if (err == cudaSuccess) err = make_map(&mk, k, B, Hkv, Sk, D, st[3], st[4], st[5]);
  if (err == cudaSuccess) err = make_map(&mv, v, B, Hkv, Sk, D, st[6], st[7], st[8]);
  if (err != cudaSuccess) return err;
  constexpr int bytes = Layout<kD>::kBytes;
  err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<kD, kCap>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (S + kBM - 1) / kBM);
  flash_attention_wgmma_kernel<kD, kCap><<<grid, kThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, H / Hkv, S, Sk, D, st[9], st[10], st[11],
      sm_scale * kLog2e, kCap ? sm_scale / softcap : 0.f, softcap * kLog2e, causal, window);
  return cudaGetLastError();
}

template <bool kCap>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int Hkv, int S, int Sk, int D, const long long* st,
                       float sm_scale, float softcap, int causal, int window,
                       cudaStream_t stream) {
  if (D <= 64)
    return launch<64, kCap>(q, k, v, o, lse, B, H, Hkv, S, Sk, D, st, sm_scale, softcap, causal,
                            window, stream);
  if (D <= 128)
    return launch<128, kCap>(q, k, v, o, lse, B, H, Hkv, S, Sk, D, st, sm_scale, softcap, causal,
                             window, stream);
  return launch<256, kCap>(q, k, v, o, lse, B, H, Hkv, S, Sk, D, st, sm_scale, softcap, causal,
                           window, stream);
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int H, int Hkv, int S, int Sk, int D, const long long* st, float sm_scale,
                     float softcap, int causal, int window, cudaStream_t stream) {
  if (softcap > 0.f)
    return dispatch_d<true>(q, k, v, o, lse, B, H, Hkv, S, Sk, D, st, sm_scale, softcap, causal,
                            window, stream);
  return dispatch_d<false>(q, k, v, o, lse, B, H, Hkv, S, Sk, D, st, sm_scale, 0.f, causal,
                           window, stream);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// float32: outer products on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

using namespace f32attn;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr int kBQ = 64;  // query rows per block: 8 row groups x 8 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The tiles of the instance for head size kD (see the file's header).
template <int kD>
struct Fwd {
  static constexpr int kCG = kD >= 64 ? 16 : kD / 4;  // key (and column) groups
  static constexpr int kThreads = 8 * kCG;            // x 8 row groups
  static constexpr int kBK = 4 * kCG;                 // keys per k tile
  static constexpr int kOC = kD / (4 * kCG);          // 16-byte output chunks a thread
  static constexpr int kSlots = kD >= 128 ? 2 : 4;    // ring: K and V tiles in turn
  static constexpr int kCpr = kD / 4;                 // 16-byte chunks a row
  static constexpr int kSlot = kBK * kD;              // floats
  static constexpr int kRing = kBQ * kD;              // after the resident Q
  static constexpr int kP = kRing + kSlots * kSlot;   // P^T, kBK x 64
  static constexpr int kBytes = (kP + kBK * kBQ) * 4;
  static constexpr int kMinBlocks = kD >= 256 ? 1 : 2;
};

// rows of a thread: 4 rg + i and 32 + 4 rg + i, i < 4
__device__ __forceinline__ int frow(int rg, int i) { return 4 * rg + (i & 3) + 32 * (i >> 2); }

// scale_log2 = sm_scale log2 e; with kCap, cap_scale = sm_scale / cap and
// cap_log2 = cap log2 e (the cap formed first, log2 e folded in after)
template <int kD, bool kCap>
__global__ void __launch_bounds__(Fwd<kD>::kThreads, Fwd<kD>::kMinBlocks)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int group, int S, int Sk, int D,
                           long long qsb, long long qsh, long long qss, long long ksb,
                           long long ksh, long long kss, long long vsb, long long vsh,
                           long long vss, long long osb, long long osh, long long oss,
                           float scale_log2, float cap_scale, float cap_log2, int causal,
                           int window) {
  using L = Fwd<kD>;
  constexpr int kCG = L::kCG, kBK = L::kBK, kCpr = L::kCpr, kSlots = L::kSlots;
  // the products' loops unrolled by 4, by 2 at D = 256, where the 128
  // accumulators leave no room for more loads in flight (unrolled by 4,
  // ptxas spills there)
  constexpr int kUnroll = kD >= 256 ? 2 : 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;
  float* Pt = smem + L::kP;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // heaviest first
  const int q0 = qt * kBQ;
  const int hk = h / group;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  const int tid = threadIdx.x;
  const int rg = tid / kCG;
  const int cg = tid % kCG;
  const int kt0 = tile_lo(qt, kBQ, kBK, window);
  const int n_items = 2 * (tile_hi(qt, kBQ, kBK, S, Sk, causal) - kt0 + 1);

  // the block's q rows once, then item n = the K (n even) or V (n odd) tile
  // of k tile kt0 + n / 2 into ring slot n % kSlots; every call commits one
  // group, empty past the last item, so the wait below counts groups alike
  load_tile<kBQ, kD, L::kThreads, true>(Qs, q + b * qsb + h * qsh, qss, q0, S, 0, D);
  cp_async_commit();
  auto issue = [&](int n) {
    if (n < n_items) {
      const bool is_v = n & 1;
      load_tile<kBK, kD, L::kThreads, true>(smem + L::kRing + (n % kSlots) * L::kSlot,
                                            is_v ? vb : kb, is_v ? vss : kss,
                                            (kt0 + n / 2) * kBK, Sk, 0, D);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < kSlots - 1; ++n) issue(n);

  float4 acc[8][L::kOC];
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kOC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int n = 0; n < n_items; ++n) {
    cp_async_wait<kSlots - 2>();  // item n has landed (for this thread's copies)
    __syncthreads();              // ... for all, and item n - 1's slot is free
    issue(n + kSlots - 1);
    const float* tile = smem + L::kRing + (n % kSlots) * L::kSlot;
    const int k0 = (kt0 + n / 2) * kBK;
    if ((n & 1) == 0) {
      // S = Q K^T: 8 rows x 4 keys a thread, 12 loads of 16 bytes for 128 FMAs
      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll(kUnroll)
      for (int c = 0; c < kCpr; ++c) {
        float4 kf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = 4 * cg + j;
          kf[j] = ld4(tile + key * kD + 4 * swz<kCpr>(key, c));
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = frow(rg, i);
          const float4 qf = ld4(Qs + row * kD + 4 * swz<kCpr>(row, c));
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(qf, kf[j], s[i][j]);
        }
      }
      // scale (and cap) into the log2 domain, mask, online softmax
      const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && k0 <= q0 + kBQ - 1 - window);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float t = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = kCap ? tanhf(s[i][j] * cap_scale) * cap_log2 : s[i][j] * scale_log2;
          if (edge && !kept(q0 + frow(rg, i), k0 + 4 * cg + j, S, Sk, causal, window))
            x = -INFINITY;
          s[i][j] = x;
          t = fmaxf(t, x);
        }
        // the kCG lanes of a row group are neighbours
#pragma unroll
        for (int off = 1; off < kCG; off *= 2) t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, off));
        const float mn = fmaxf(m[i], t);
        // a row with nothing kept so far keeps max -inf: subtract 0
        // instead, so no exp(-inf - -inf) is formed
        const float u = mn == -INFINITY ? 0.f : mn;
        const float alpha = exp2f(m[i] - u);
        m[i] = mn;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = exp2f(s[i][j] - u);
          sum += s[i][j];
        }
        l[i] = l[i] * alpha + sum;  // this thread's keys; summed over the group at the end
#pragma unroll
        for (int c = 0; c < L::kOC; ++c) {
          acc[i][c].x *= alpha;
          acc[i][c].y *= alpha;
          acc[i][c].z *= alpha;
          acc[i][c].w *= alpha;
        }
      }
      // P^T (keys x 64 rows) for the P V product
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = 4 * cg + j;
        float* pr = Pt + key * kBQ;
        st4(pr + 4 * swz<16>(key, rg), make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
        st4(pr + 4 * swz<16>(key, 8 + rg), make_float4(s[4][j], s[5][j], s[6][j], s[7][j]));
      }
    } else {
      // O += P V: 8 rows x 4 kOC columns a thread
#pragma unroll(kUnroll)
      for (int key = 0; key < kBK; ++key) {
        const float* pr = Pt + key * kBQ;
        const float4 pa = ld4(pr + 4 * swz<16>(key, rg));
        const float4 pb = ld4(pr + 4 * swz<16>(key, 8 + rg));
        const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int c = 0; c < L::kOC; ++c) {
          const float4 vf = ld4(tile + key * kD + 4 * swz<kCpr>(key, cg + kCG * c));
#pragma unroll
          for (int i = 0; i < 8; ++i) axpy4(p[i], vf, acc[i][c]);
        }
      }
    }
  }

  float* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < kCG; off *= 2) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + frow(rg, i);
    if (row >= S) continue;
    if (lse != nullptr && cg == 0)
      lse[(static_cast<long long>(b) * gridDim.x + h) * S + row] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : INFINITY;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < L::kOC; ++c) {
      const int col = 4 * (cg + kCG * c);
      if (col < D)
        st4(ob + static_cast<long long>(row) * oss + col,
            make_float4(acc[i][c].x * inv, acc[i][c].y * inv, acc[i][c].z * inv,
                        acc[i][c].w * inv));
    }
  }
}

template <int kD, bool kCap>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int H, int Hkv, int S, int Sk, int D,
                   const long long* st, float sm_scale, float softcap, int causal,
                   int window, cudaStream_t stream) {
  using L = Fwd<kD>;
  cudaError_t err = allow_smem<&flash_attention_f32_kernel<kD, kCap>>(L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (S + kBQ - 1) / kBQ);
  flash_attention_f32_kernel<kD, kCap><<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H / Hkv, S, Sk, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], sm_scale * kLog2e, kCap ? sm_scale / softcap : 0.f,
      softcap * kLog2e, causal, window);
  return cudaGetLastError();
}

template <bool kCap>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int Hkv, int S, int Sk, int D, const long long* st,
                       float sm_scale, float softcap, int causal, int window,
                       cudaStream_t s) {
  switch (instance_d(D)) {
    case 16:
      return launch<16, kCap>(q, k, v, o, lse, B, H, Hkv, S, Sk, D, st, sm_scale, softcap,
                              causal, window, s);
    case 32:
      return launch<32, kCap>(q, k, v, o, lse, B, H, Hkv, S, Sk, D, st, sm_scale, softcap,
                              causal, window, s);
    case 64:
      return launch<64, kCap>(q, k, v, o, lse, B, H, Hkv, S, Sk, D, st, sm_scale, softcap,
                              causal, window, s);
    case 128:
      return launch<128, kCap>(q, k, v, o, lse, B, H, Hkv, S, Sk, D, st, sm_scale, softcap,
                               causal, window, s);
    default:
      return launch<256, kCap>(q, k, v, o, lse, B, H, Hkv, S, Sk, D, st, sm_scale, softcap,
                               causal, window, s);
  }
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                     int B, int H, int Hkv, int S, int Sk, int D,
                     const long long* st, float sm_scale, float softcap, int causal,
                     int window, cudaStream_t stream) {
  if (softcap > 0.f)
    return dispatch_d<true>(q, k, v, o, lse, B, H, Hkv, S, Sk, D, st, sm_scale, softcap, causal,
                            window, stream);
  return dispatch_d<false>(q, k, v, o, lse, B, H, Hkv, S, Sk, D, st, sm_scale, 0.f, causal,
                           window, stream);
}

// the plan of an instance: threads, keys per k tile, ring slots, dynamic
// shared memory bytes
template <int kD>
void plan_of(long long* out) {
  using L = Fwd<kD>;
  out[0] = kD;
  out[1] = L::kThreads;
  out[2] = L::kBK;
  out[3] = L::kSlots;
  out[4] = L::kBytes;
}

}  // namespace f32

}  // namespace

extern "C" {

// q, out: (B, H, S, D) and k, v: (B, Hkv, Sk, D), each addressed by the
// strides in `strides` (elements; b, h, s for q, k, v, out in that order)
// with D contiguous.  dtype 0 = float32 (flash_attention_f32_kernel),
// 1 = bfloat16 (flash_attention_wgmma_kernel; its strides and base
// addresses must be multiples of 16 bytes).  D a multiple of 8 up to 256;
// window 0 = no window; softcap 0 = none.  lse: null, or (B, H, S) float32
// contiguous, the rows' log-sum-exp.  Sk != S only with causal = 0 and
// window = 0.  Returns a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int Hkv, int S,
                           int Sk, int D, const long long* strides, float sm_scale,
                           float softcap, int causal, int window, void* lse,
                           int device, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      B > 65535 || H > 65535 || !(softcap >= 0.f) || Sk <= 0 ||
      (Sk != S && (causal || window)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return f32::dispatch(q, k, v, o, l, B, H, Hkv, S, Sk, D, strides, sm_scale, softcap, causal,
                         window, s);
  if (dtype == 1)
    return wg::dispatch(q, k, v, o, l, B, H, Hkv, S, Sk, D, strides, sm_scale, softcap, causal,
                        window, s);
  return cudaErrorInvalidValue;
}

// The float32 kernel's instance for head size D (a multiple of 8 up to
// 256): out[0..4] = instance D, threads, keys per k tile, ring slots,
// dynamic shared memory bytes per block.  Returns 0, or -1 for another D.
int flash_attention_f32_plan(int D, long long* out) {
  if (D <= 0 || D > 256 || D % 8 != 0 || out == nullptr) return -1;
  switch (f32attn::instance_d(D)) {
    case 16: f32::plan_of<16>(out); break;
    case 32: f32::plan_of<32>(out); break;
    case 64: f32::plan_of<64>(out); break;
    case 128: f32::plan_of<128>(out); break;
    default: f32::plan_of<256>(out); break;
  }
  return 0;
}

}  // extern "C"
