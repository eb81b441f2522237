// Online-softmax attention forward for NVIDIA Hopper (sm_90a), built on
// TMA and warpgroup MMA (wgmma). Two entry points, one template:
//
//   fa_fwd_generic  (HEAD_DIM 96, 128)  replaces _fa_kernel
//                   (fantasy_world_tpu/ops/flash_attention.py), launched from
//                   _flash_forward when Lk > block_k: DiT self-attention
//                   (16317 x 16317, 40 x 128) and both bicross directions
//                   (16317 <-> 16422, 12 x 96).
//   fa_fwd_d64      (HEAD_DIM 64)       replaces _fa_kernel_pair (D <= 64, H
//                   even): VGGT frame (42 x 782) and global (2 x 16422)
//                   attention. The TPU kernel packs two 64-wide heads into 128
//                   lanes; on Hopper 64 is a native wgmma width, so this is
//                   the same template built for HEAD_DIM 64.
//
// (fa_fwd_onekv, the one-key-block kernel, stays in flash_attention.cu.)
//
// What bounds it on the card: 4 * Lq * Lk * D FLOP per (batch, head) against
// (2 Lq + 2 Lk) * D * 2 bytes -- thousands of FLOP per byte at the denoise
// shapes, so at D 96 and 128 the tensor cores bind (DiT self-attention:
// 10.9 TFLOP a CFG step, 11.0 ms at the bf16 peak). At D 64 the exponentials
// bind about as hard as the MMA: one exp2 per logit against 4 * 64 FLOP of
// MMA per logit, 8.6 G exponentials a denoise step for VGGT global, about
// 2.2 ms at 16 a clock per SM on the SFU.
//
// What the design does about it:
//   * Both products run as wgmma with f32 accumulators in registers:
//     S = Q K^T with both operands in shared memory (m64n128k16), and
//     O += P V with P from registers -- the S accumulator rounded to bf16 is
//     the register A operand, element for element -- and V from shared memory
//     as a transposed (MN-major) B operand (m64nDk16).
//   * The softmax stays in registers: row max and row sum from quad shuffles
//     over the accumulator layout (a thread holds two rows), the online
//     rescale of O applied to the accumulator registers, exp2 on ex2.approx.
//     Nothing goes through shared memory per key tile.
//   * Warp specialisation: a block is 128 query rows -- two consumer
//     warpgroups of 64 rows each -- plus a producer warpgroup whose one thread
//     issues TMA copies. The producer gives up registers (setmaxnreg 24) so
//     that the consumers can hold S, P and O (setmaxnreg 240).
//   * K and V tiles of 128 keys go through a two-stage ring of shared-memory
//     buffers guarded by mbarriers (full: TMA bytes arrived; empty: the
//     eight consumer warps are done), so the next tile's copy overlaps this
//     tile's math; K and V have separate full barriers, so Q K^T starts
//     before V has landed. Q is loaded once per block.
//   * Tensor maps are encoded on the host per call over (D, H, L, B) with the
//     tensors' own strides (dims 1-3 ordered by stride), so strided views --
//     VGGT's fused qkv, bicross's swapped q/k -- load without a copy. Rows
//     past L are zero-filled by TMA.
//   * Shared tiles are stored as panels of PW columns under the TMA swizzle
//     that the wgmma descriptors name: PW 64 with the 128-byte swizzle at D 64
//     and 128 (one and two panels), PW 32 with the 64-byte swizzle at D 96
//     (three panels: 192 bytes is not a multiple of 128).
//   * Each warpgroup runs S, softmax, P V in order and the two warpgroups are
//     not synchronised: the warp schedulers interleave one's softmax with the
//     other's MMAs. Issuing S(t) with P(t-1) V(t-1), with or without
//     ping-pong barriers between the warpgroups, measured slower at D 96 and
//     128 on the H100 (PERF.md, section 6).
//
// Numerics are those of the TPU kernels and of attention_plain_stats: q is
// multiplied by scale*log2(e) in f32 and rounded to bf16 before Q K^T (in
// shared memory, once per block, then fence.proxy.async before wgmma reads
// it); logits are f32 in the exp2 domain; P is rounded to bf16 before P V;
// m and l are f32. The ragged key tail is masked to -inf on the last tile;
// query rows >= Lq compute on zeros and are not stored.
//
// Statistics (the with_stats output of _fa_kernel): given non-null m2 and l,
// the epilogue also stores, per query row, the base-2 row max m2 = max_k s2
// and the sum l = sum_k exp2(s2 - m2) as contiguous (B, Lq, H) f32.
//
// The output is a contiguous (B, Lq, H, D) bf16 tensor. Each entry point
// launches on the given stream and returns 0, a cudaError_t, or
// FA_ENCODE_ERROR + the CUresult of a tensor map that failed to encode; it
// allocates nothing and does not synchronise. fa_error_string names any
// nonzero return of the attention entry points, these and those of
// flash_attention.cu and flash_attention_bwd.cu (cudaError_t only).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int BM = 128;                // query rows per block
constexpr int BN = 128;                // keys per tile
constexpr int STAGES = 2;              // K/V ring depth
constexpr int CONSUMER_WARPS = 8;      // two warpgroups
constexpr int THREADS = 128 * 3;       // producer warpgroup + two consumers
constexpr int FA_ENCODE_ERROR = 1 << 20;

template <int D>
struct Cfg {
  static constexpr int PW = D % 64 == 0 ? 64 : 32;   // columns per panel
  static constexpr int NP = D / PW;                  // panels per tile
  static constexpr int SWZ = PW * 2;                 // bytes per panel row = swizzle span
  static constexpr uint64_t LAYOUT = SWZ == 128 ? 1 : 2;   // wgmma: B128 or B64
  static constexpr int Q_PANEL = BM * SWZ;
  static constexpr int KV_PANEL = BN * SWZ;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int BAR_OFFSET = Q_BYTES + 2 * STAGES * KV_BYTES;
  // + barriers, + slack to align the base to the 1024-byte swizzle atom
  static constexpr int SMEM = BAR_OFFSET + 128 + 1024;
};

struct Params {
  __nv_bfloat16* o;
  float* m2;                       // (B, Lq, H) row max, base 2; null: no stats
  float* l;                        // (B, Lq, H) row sum
  int Lq, Lk, H;
  int4 q_pos, k_pos, v_pos;        // coordinate slot (1-3) of head, row, batch
  float qscale;                    // softmax scale * log2(e)
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

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

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of accumulator registers above the
// wgmma wait (the wgmma asm names them as outputs already at issue).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout (bits 62-63). The swizzle atoms of
// every tile start on 1024-byte boundaries, so base_offset stays 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

#define FA_F8(d, i)                                                                           \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_REGS32                                                                             \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FA_REGS48                                                                             \
  FA_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define FA_REGS64                                                                             \
  FA_REGS48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d[64] (+)= A(smem, 64 x 16, K-major) * B(smem, 128 x 16, K-major)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FA_REGS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_F8(d, 0), FA_F8(d, 8), FA_F8(d, 16), FA_F8(d, 24), FA_F8(d, 32), FA_F8(d, 40),
        FA_F8(d, 48), FA_F8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[N/2] += A(registers, 64 x 16 bf16) * B(smem, 16 x N, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FA_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_F8(d, 0), FA_F8(d, 8), FA_F8(d, 16), FA_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {" FA_REGS48
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : FA_F8(d, 0), FA_F8(d, 8), FA_F8(d, 16), FA_F8(d, 24), FA_F8(d, 32), FA_F8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FA_REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_F8(d, 0), FA_F8(d, 8), FA_F8(d, 16), FA_F8(d, 24), FA_F8(d, 32), FA_F8(d, 40),
        FA_F8(d, 48), FA_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The coordinate in map slot `slot` (1-3), given where head, row and batch
// landed.
__device__ __forceinline__ int pick(int slot, int4 pos, int h, int row, int b) {
  return pos.x == slot ? h : (pos.y == slot ? row : b);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;
  unsigned char* sK = smem + C::Q_BYTES;                        // [STAGES][KV_BYTES]
  unsigned char* sV = sK + STAGES * C::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFFSET);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;                                  // [STAGES]
  uint64_t* v_full = k_full + STAGES;
  uint64_t* kv_empty = v_full + STAGES;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int ntiles = (p.Lk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::NP; ++pn)
        tma_load(sQ + pn * C::Q_PANEL, &tq, q_full, pn * C::PW, pick(1, p.q_pos, h, q0, b),
                 pick(2, p.q_pos, h, q0, b), pick(3, p.q_pos, h, q0, b));
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, row = t * BN;
        if (t >= STAGES) mbar_wait(&kv_empty[s], (t / STAGES - 1) & 1);
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn)
          tma_load(sK + s * C::KV_BYTES + pn * C::KV_PANEL, &tk, &k_full[s], pn * C::PW,
                   pick(1, p.k_pos, h, row, b), pick(2, p.k_pos, h, row, b),
                   pick(3, p.k_pos, h, row, b));
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn)
          tma_load(sV + s * C::KV_BYTES + pn * C::KV_PANEL, &tv, &v_full[s], pn * C::PW,
                   pick(1, p.v_pos, h, row, b), pick(2, p.v_pos, h, row, b),
                   pick(3, p.v_pos, h, row, b));
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows [64 cw, 64 cw + 64) ---------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int lane = tid % 32;
  // accumulator layout: this thread holds rows r and r + 8 of its warp's 16,
  // columns 8 j + c and 8 j + c + 1 of each 8-column group j
  const int r = (tid / 32) * 16 + lane / 4;
  const int c = 2 * (lane % 4);

  // Q * scale * log2(e): f32 multiply, bf16 round, in place (the swizzle
  // only permutes 16-byte chunks within the warpgroup's rows)
  mbar_wait(q_full, 0);
  {
    constexpr int CHUNKS = 64 * C::SWZ / 16;       // 16-byte chunks of one panel's 64 rows
    for (int i = tid; i < C::NP * CHUNKS; i += 128) {
      uint4* ptr = reinterpret_cast<uint4*>(sQ + (i / CHUNKS) * C::Q_PANEL + cw * 64 * C::SWZ) +
                   i % CHUNKS;
      uint4 val = *ptr;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        h2[j] = __floats2bfloat162_rn(f.x * p.qscale, f.y * p.qscale);
      }
      *ptr = val;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  }

  const uint32_t q_addr = smem_u32(sQ) + cw * 64 * C::SWZ;
  constexpr uint32_t SBO = 8 * C::SWZ;               // 8-row core-matrix groups

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const uint32_t k_addr = smem_u32(sK) + s * C::KV_BYTES;
    const uint32_t v_addr = smem_u32(sV) + s * C::KV_BYTES;

    // S = Q K^T (exp2 domain: q carries scale * log2(e))
    float sc[64];
    mbar_wait(&k_full[s], parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk * 16 / C::PW) * C::Q_PANEL + (kk * 16 % C::PW) * 2;
      const uint32_t koff = (kk * 16 / C::PW) * C::KV_PANEL + (kk * 16 % C::PW) * 2;
      wgmma_ss_n128(sc, make_desc(q_addr + off, 16, SBO, C::LAYOUT),
                    make_desc(k_addr + koff, 16, SBO, C::LAYOUT), kk > 0);
    }
    wg_commit();
    wg_wait0();
    pin(sc);

    // ragged key tail: keys >= Lk score -inf
    const int valid = p.Lk - t * BN;
    if (valid < BN) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (8 * (i / 4) + c + (i & 1) >= valid) sc[i] = -INFINITY;
    }

    // online softmax in registers: quad shuffles give the row max
    float x0 = m0, x1 = m1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
    const float alpha0 = ex2(m0 - x0), alpha1 = ex2(m1 - x1);   // 0 on the first tile
    m0 = x0;
    m1 = x1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j] = ex2(sc[4 * j] - m0);
      sc[4 * j + 1] = ex2(sc[4 * j + 1] - m0);
      sc[4 * j + 2] = ex2(sc[4 * j + 2] - m1);
      sc[4 * j + 3] = ex2(sc[4 * j + 3] - m1);
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    // per-thread partial sums; the quad's are added in the epilogue
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
    // P in bf16: the S accumulator of keys 16 kk .. 16 kk + 15 is the
    // register A fragment of the kk-th k16 step
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V: V (keys x D, D contiguous) is the transposed B operand;
    // LBO steps over the PW-column panels of D, SBO over 8-key groups
    mbar_wait(&v_full[s], parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], make_desc(v_addr + kk * 16 * C::SWZ, C::KV_PANEL, SBO, C::LAYOUT));
    wg_commit();
    wg_wait0();
    pin(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&kv_empty[s]);
  }

  // epilogue: the quad's partial sums, O / l, rows < Lq stored
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const int row0 = q0 + cw * 64 + r, row1 = row0 + 8;
  const long long i0 = ((long long)b * p.Lq + row0) * p.H + h;
  const long long i1 = ((long long)b * p.Lq + row1) * p.H + h;
  if (row0 < p.Lq) {
    __nv_bfloat16* og = p.o + i0 * D + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (p.m2 != nullptr && c == 0) {
      p.m2[i0] = m0;
      p.l[i0] = l0;
    }
  }
  if (row1 < p.Lq) {
    __nv_bfloat16* og = p.o + i1 * D + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    if (p.m2 != nullptr && c == 0) {
      p.m2[i1] = m1;
      p.l[i1] = l1;
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A 4-d bf16 tensor map over (D, and head, row, batch ordered by stride),
// box (PW columns, `rows` rows) under the swizzle of PW; `pos` gets the slot
// (1-3) of head, row and batch. Size-1 dims go last with a stride past the
// others' extent (any stride would do; TMA wants a valid one).
int encode(CUtensorMap* map, int4* pos, const void* ptr, int D, int pw, int rows,
           const long long (&size)[3], const long long (&stride)[3]) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return FA_ENCODE_ERROR + CUDA_ERROR_NOT_FOUND;
  long long extent = D;
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1 && stride[i] * size[i] > extent) extent = stride[i] * size[i];
  long long st[3];
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i) st[i] = size[i] > 1 ? stride[i] : extent;
  for (int i = 0; i < 3; ++i)        // three elements: insertion sort by stride
    for (int j = i; j > 0 && st[order[j]] < st[order[j - 1]]; --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)pw, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int slot[3];
  for (int i = 0; i < 3; ++i) {
    const int which = order[i];        // 0 head, 1 row, 2 batch
    dims[i + 1] = (cuuint64_t)size[which];
    strides[i] = (cuuint64_t)st[which] * 2;
    if (which == 1) box[i + 1] = rows;
    slot[which] = i + 1;
  }
  *pos = make_int4(slot[0], slot[1], slot[2], 0);
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : FA_ENCODE_ERROR + (int)res;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* m2, void* l, int B,
           int Lq, int Lk, int H, long long q_sb, long long q_sr, long long q_sh, long long k_sb,
           long long k_sr, long long k_sh, long long v_sb, long long v_sr, long long v_sh,
           float qscale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  Params p;
  int err;
  if ((err = encode(&tq, &p.q_pos, q, D, C::PW, BM, {H, Lq, B}, {q_sh, q_sr, q_sb})) ||
      (err = encode(&tk, &p.k_pos, k, D, C::PW, BN, {H, Lk, B}, {k_sh, k_sr, k_sb})) ||
      (err = encode(&tv, &p.v_pos, v, D, C::PW, BN, {H, Lk, B}, {v_sh, v_sr, v_sb})))
    return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.m2 = static_cast<float*>(m2);
  p.l = static_cast<float*>(l);
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.qscale = qscale;
  cudaError_t e = cudaFuncSetAttribute(fa_fwd_wgmma<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lq + BM - 1) / BM, H, B);
  fa_fwd_wgmma<D><<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

#define FA_ARGS                                                                            \
  const void *q, const void *k, const void *v, void *o, void *m2, void *l, int B, int Lq,  \
      int Lk, int H, int D, long long q_sb, long long q_sr, long long q_sh, long long k_sb, \
      long long k_sr, long long k_sh, long long v_sb, long long v_sr, long long v_sh,      \
      float qscale, void *stream
#define FA_FORWARD                                                                          \
  q, k, v, o, m2, l, B, Lq, Lk, H, q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, qscale, \
      static_cast<cudaStream_t>(stream)

extern "C" {

int fa_fwd_generic(FA_ARGS) {
  if (D == 128) return launch<128>(FA_FORWARD);
  if (D == 96) return launch<96>(FA_FORWARD);
  return (int)cudaErrorInvalidValue;
}

int fa_fwd_d64(FA_ARGS) {
  if (D != 64) return (int)cudaErrorInvalidValue;
  return launch<64>(FA_FORWARD);
}

const char* fa_error_string(int err) {
  if (err < FA_ENCODE_ERROR) return cudaGetErrorString((cudaError_t)err);
  static thread_local char msg[64];
  snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled returned CUresult %d",
           err - FA_ENCODE_ERROR);
  return msg;
}

}  // extern "C"
