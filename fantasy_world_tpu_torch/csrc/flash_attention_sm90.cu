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
// (fa_fwd_onekv, the one-key-block kernel, is flash_attention_onekv.cu: the
// same layer, two passes over the keys and no rescale.)
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
// nonzero return of the attention entry points: these and those of
// flash_attention_onekv.cu and flash_attention_bwd.cu, which encode tensor
// maps the same way.
//
// The PTX layer (mbarriers, TMA, wgmma, descriptors, tensor-map encoding)
// is sm90_common.cuh, shared with the one-key-block forward and the
// backward.

#include "sm90_common.cuh"

#include <stdio.h>

namespace {

using namespace sm90;

constexpr int BM = 128;                // query rows per block
constexpr int BN = 128;                // keys per tile
constexpr int STAGES = 2;              // K/V ring depth
constexpr int CONSUMER_WARPS = 8;      // two warpgroups
constexpr int THREADS = 128 * 3;       // producer warpgroup + two consumers

template <int D>
struct Cfg : Panels<D> {
  using P = Panels<D>;
  static constexpr int Q_PANEL = BM * P::SWZ;
  static constexpr int KV_PANEL = BN * P::SWZ;
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
      wgmma_ss<BN>(sc, make_desc(q_addr + off, 16, SBO, C::LAYOUT),
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
    pack_a<BN>(pa, sc);

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
// host side: launch
// ---------------------------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* m2, void* l, int B,
           int Lq, int Lk, int H, long long q_sb, long long q_sr, long long q_sh, long long k_sb,
           long long k_sr, long long k_sh, long long v_sb, long long v_sr, long long v_sh,
           float qscale, cudaStream_t stream) {
  using C = Cfg<D>;
  // a runtime call first: it makes the device's context current on this
  // thread, which cuTensorMapEncodeTiled needs
  const cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
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
  if (err < sm90::FA_ENCODE_ERROR) return cudaGetErrorString((cudaError_t)err);
  static thread_local char msg[64];
  snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled returned CUresult %d",
           err - sm90::FA_ENCODE_ERROR);
  return msg;
}

}  // extern "C"
