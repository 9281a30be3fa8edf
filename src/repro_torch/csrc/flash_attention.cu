// Online-softmax (flash) attention forward, causal and/or sliding window,
// GQA by head map:
//
//   out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] * scale) v[b, h / G, j]
//
// over the columns j < S that the masks keep (j <= i when causal,
// j > i - window when window > 0), the output written in the inputs' type.
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
// float32, flash_attention_f32_kernel: fp32 FMA on the CUDA cores.  The
// tensor cores have no fp32 product that holds 1e-4 absolute (TF32 keeps
// 10 bits), and float32 is the checking dtype, not the served one.  One
// block of 256 threads per (b, h, 64-row q tile), a loop over 32-row k
// tiles with the 64 x D fp32 accumulator in registers (64 floats per
// thread) and the q, k and v tiles in 140 KB of shared memory; its own
// ceiling is the fp32 FMA rate (67 TFLOP/s on the data sheet).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBM = 128;             // query rows per block
constexpr int kBN = 64;              // key rows per k tile
constexpr int kThreads = 256;        // two warpgroups of 64 query rows
constexpr int kStages = 2;           // k/v ring depth
constexpr int kPanelBytes = 64 * 128;  // 64 rows x 64 bf16 columns (128 B, swizzled)
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one 64 x 64 bf16 box of a 4-d (D, S, heads, B) tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (the tile's 1,024-byte
// swizzle atoms start at 1,024-byte aligned addresses, so base offset 0)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving register accesses across the async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, fp32) = A (64 x 16, shared, K-major) . B (64 x 16, shared,
// K-major)^T + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16, registers) . B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x kD) += P (64 x 16, registers) . v (16 x kD, shared)
template <int kD>
__device__ __forceinline__ void wgmma_pv(float (&o)[kD / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kD == 64) {
    wgmma_rs_n64(o, a, db);
  } else if constexpr (kD == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n256(o, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int group, int S, int D,
                             long long osb, long long osh, long long oss,
                             float scale_log2, int causal, int window) {
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
  const int k_rows = causal ? min(S, q0 + kBM) : S;
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

      // scale into the log2 domain and mask
      const bool edge = k0 + kBN > S || (causal && k0 + kBN - 1 > r_base) ||
                        (window > 0 && k0 <= r_base + 63 - window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale_log2;
          if (edge) {
            const int col = k0 + 8 * j + cq + (e & 1);
            const int row = e < 2 ? row0 : row1;
            const bool keep = col < S && (!causal || col <= row) &&
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
        wgmma_pv<kD>(acc, ph[kk], dv);
        wgmma_pv<kD>(acc, pl[kk], dv);
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

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library links no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, heads, S, D) bf16 addressed by element strides (b, head, s), D
// contiguous, as a 4-d map (D, S, heads, B) read in 64 x 64 boxes
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int heads, int S, int D,
                     long long sb, long long sh, long long ss) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int S, int D, const long long* st, float sm_scale, int causal,
                   int window, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, B, H, S, D, st[0], st[1], st[2]);
  if (err == cudaSuccess) err = make_map(&mk, k, B, Hkv, S, D, st[3], st[4], st[5]);
  if (err == cudaSuccess) err = make_map(&mv, v, B, Hkv, S, D, st[6], st[7], st[8]);
  if (err != cudaSuccess) return err;
  constexpr int bytes = Layout<kD>::kBytes;
  err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (S + kBM - 1) / kBM);
  flash_attention_wgmma_kernel<kD><<<grid, kThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), H / Hkv, S, D, st[9], st[10], st[11],
      sm_scale * kLog2e, causal, window);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int H,
                     int Hkv, int S, int D, const long long* st, float sm_scale, int causal,
                     int window, cudaStream_t stream) {
  if (D <= 64) return launch<64>(q, k, v, o, B, H, Hkv, S, D, st, sm_scale, causal, window, stream);
  if (D <= 128) return launch<128>(q, k, v, o, B, H, Hkv, S, D, st, sm_scale, causal, window, stream);
  return launch<256>(q, k, v, o, B, H, Hkv, S, D, st, sm_scale, causal, window, stream);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// float32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

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

// rows x kD elements (strided rows, D valid columns) -> shared tile with row
// stride kD + 4; rows at or past S and columns at or past D are 0.
template <int kD, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
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

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  float* ob = o + b * osb + h * osh;
  const int tx = threadIdx.x % 8;   // column lane
  const int ty = threadIdx.x / 8;   // rows ty and ty + 32

  load_tile<kD, kBQ>(Qs, qb, qss, q0, S, D);

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
    load_tile<kD, kBK>(Ks, kb, kss, k0, S, D);
    load_tile<kD, kBK>(Vs, vb, vss, k0, S, D);
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
        *reinterpret_cast<float4*>(ob + static_cast<long long>(row) * oss + col) =
            make_float4(acc[i][c].x * inv, acc[i][c].y * inv,
                        acc[i][c].z * inv, acc[i][c].w * inv);
      }
    }
  }
}

template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int S, int D,
                   const long long* st, float sm_scale, int causal,
                   int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<kD>();
  // above 48 KB, dynamic shared memory must be granted per kernel (and
  // per device, so it is set at every launch: a cheap driver call)
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_f32_kernel<kD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H / Hkv, S, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], sm_scale, causal, window);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int Hkv, int S, int D,
                     const long long* st, float sm_scale, int causal,
                     int window, cudaStream_t stream) {
  // the ported configs' head sizes: 16 (reduced) and 256 (gemma3-4b,
  // gemma-2b); any other D runs zero-padded in the next size up
  if (D <= 32) return launch<32>(q, k, v, o, B, H, Hkv, S, D, st, sm_scale, causal, window, stream);
  return launch<256>(q, k, v, o, B, H, Hkv, S, D, st, sm_scale, causal, window, stream);
}

}  // namespace f32

}  // namespace

extern "C" {

// q, out: (B, H, S, D) and k, v: (B, Hkv, S, D), each addressed by the
// strides in `strides` (elements; b, h, s for q, k, v, out in that order)
// with D contiguous.  dtype 0 = float32 (flash_attention_f32_kernel),
// 1 = bfloat16 (flash_attention_wgmma_kernel; its strides and base
// addresses must be multiples of 16 bytes).  D a multiple of 8 up to 256;
// window 0 = no window.  Returns a cudaError_t.
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
  if (dtype == 0)
    return f32::dispatch(q, k, v, o, B, H, Hkv, S, D, strides, sm_scale, causal, window, s);
  if (dtype == 1)
    return wg::dispatch(q, k, v, o, B, H, Hkv, S, D, strides, sm_scale, causal, window, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
