// Flash-attention backward for NVIDIA Hopper (sm_90a), built on TMA and
// warpgroup MMA (wgmma): two entry points, one per Pallas TPU backward
// kernel of the JAX reference (fantasy_world_tpu/ops/flash_attention.py,
// _flash_backward), each built for HEAD_DIM 64, 96 and 128 -- the VGGT,
// bicross and DiT head widths.
//
//   fa_bwd_dq   replaces _fa_bwd_dq_kernel. A block owns 128 query rows and
//               sweeps the key tiles -- the TPU's sequential grid axis -- with
//               dq in registers:
//                 s2 = qs.k^T with qs = bf16(q * scale * log2(e)),
//                 p = exp2(s2 - lse2), dp = do.v^T, ds = p (dp - delta),
//                 dq = scale * sum_k bf16(ds).k.
//               delta = rowsum(do * o) is computed once per query row in f32
//               and also stored, as (B, Lq, H) f32, for fa_bwd_dkv; the TPU
//               kernel recomputes it for every (key tile, query tile) pair.
//   fa_bwd_dkv  replaces _fa_bwd_dkv_kernel. A block owns 128 key rows and
//               sweeps the query tiles with dk and dv in registers, the
//               products taken transposed so that p^T and ds^T come out in
//               the accumulator layout that wgmma takes as a register A
//               operand:
//                 s2^T = k.qs^T, dp^T = v.do^T,
//                 dv = sum_q bf16(p^T).do,  dk = scale * sum_q bf16(ds^T).q
//               with the unscaled q. Reads the delta that fa_bwd_dq wrote:
//               both launch on one stream, dq first.
//
// What bounds them on the card: 6 (dq: S, dP, dS.K) and 8 (dk/dv: S, dP,
// P^T.dO, dS^T.Q) B H Lq Lk D FLOP, ~1.1 PFLOP a full-width training step,
// against (B, L, H, D) tensors read once -- thousands of FLOP per byte, so
// the tensor cores bind, with the exponentials and the softmax gradient
// between the products next (one exp2 per logit, as in the forward).
//
// What the design does about it -- the forward's (flash_attention_sm90.cu):
//   * Every product is a wgmma with f32 accumulators in registers: the
//     logits and dP as m64n64k16 with both operands in shared memory
//     (K-major), the gradient products as m64nDk16 with the bf16-rounded
//     accumulator of ds (or p) as the register A operand and k, do or q as
//     the transposed (MN-major) B operand.
//   * The softmax gradient stays in registers: p = exp2(s - lse2) on
//     ex2.approx and ds = p (dp - delta) element for element on the
//     accumulators; nothing goes through shared memory per tile.
//   * Warp specialisation: two consumer warpgroups of 64 rows each and a
//     producer warpgroup whose one thread starts TMA copies (setmaxnreg 24 /
//     240). The block's own rows load once; the swept tiles go through a
//     two-stage mbarrier ring (full: TMA bytes arrived; empty: the eight
//     consumer warps are done), so the next tile's copy overlaps this
//     tile's math.
//       dq:   q and do once (128 rows); k and v tiles of 64 keys on separate
//             full barriers, so S starts before v has landed. 64-key tiles
//             keep dq, S and dP at 64 + 32 + 32 f32 registers a thread at
//             D 128.
//       dk/dv: k and v once (128 rows); q and do tiles of 64 queries on
//             separate full barriers. dk, dv, S^T and dP^T take 64 + 64 + 32
//             + 32 registers a thread at D 128; shared memory is k and v
//             (64 KB) plus two stages of q, qs and do (48 KB each).
//   * Tensor maps are encoded on the host per call over (D, H, L, B) with
//     the tensors' own strides (sm90_common.cuh), so strided views -- VGGT's
//     fused qkv, bicross's swapped q/k -- load without a copy. Rows past L
//     load as zeros. Tiles are panels of 64 columns under the 128-byte
//     swizzle at D 64 and 128, of 32 columns under the 64-byte swizzle at
//     D 96.
//
// Numerics follow the TPU kernels and attention_backward_plain: logits are
// recomputed exactly as the forward computed them (q scaled in f32 and
// rounded to bf16 -- in place in dq; into a second shared tile in dk/dv,
// which also needs the unscaled q -- then fence.proxy.async before wgmma
// reads it; f32 products; exp2 domain) against the saved lse2 = m2 +
// log2(l); p and ds are rounded to bf16 only as operands of the dv/dk/dq
// products; dq and dk are scaled by the softmax scale at the end; every
// accumulator is f32. Masks: in dq the keys past Lk of the last key tile get
// p = ds = 0 (zero keys would give p = exp2(-lse2) != 0); in dk/dv the query
// rows past Lq of the last query tile get p = ds = 0 exactly. Rows of the
// block's own tile past L compute on zeros and are not stored.
//
// Layout: q/k/v/do are read through tensor maps over their (batch, row,
// head) strides in elements with a unit stride on D, o through its strides
// with plain loads (for delta only); lse2 and delta are contiguous
// (B, Lq, H) f32 -- a 64-row column of them is 4 H bytes apart, below TMA's
// 16-byte box minimum, so dq reads its rows' values directly and dk/dv
// stages each query tile's values in shared memory one tile ahead; dq, dk
// and dv are contiguous (B, L, H, D) bf16. Each entry point launches on the
// given stream and returns 0, a cudaError_t, or FA_ENCODE_ERROR + the
// CUresult of a tensor map that failed to encode (fa_error_string in
// flash_attention_sm90.cu names both); it allocates nothing and does not
// synchronise.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int CONSUMER_WARPS = 8;      // two warpgroups
constexpr int THREADS = 128 * 3;       // producer warpgroup + two consumers

struct BwdParams {
  const __nv_bfloat16* o;          // dq: read for delta
  const __nv_bfloat16* dout;       // dq: read for delta (also through tdo)
  const float* lse;                // (B, Lq, H) lse2 = m2 + log2(l)
  float* delta;                    // (B, Lq, H) rowsum(do * o): dq writes, dk/dv reads
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int Lq, Lk, H;
  int4 q_pos, k_pos, v_pos, do_pos;   // coordinate slot (1-3) of head, row, batch
  long long o_sb, o_sr, o_sh, do_sb, do_sr, do_sh;
  float qscale;                    // softmax scale * log2(e)
  float scale;                     // softmax scale
};

// fa_bwd_dq: q (scaled in place) and do of the block's 128 rows, then the
// k and v ring of 64-key tiles.
template <int D>
struct DqCfg : Panels<D> {
  using P = Panels<D>;
  static constexpr int BM = 128;                 // query rows per block
  static constexpr int BN = 64;                  // keys per tile
  static constexpr int STAGES = 2;               // k/v ring depth
  static constexpr int Q_PANEL = BM * P::SWZ;
  static constexpr int KV_PANEL = BN * P::SWZ;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int BAR_OFFSET = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  // + barriers, + slack to align the base to the 1024-byte swizzle atom
  static constexpr int SMEM = BAR_OFFSET + 128 + 1024;
};

// fa_bwd_dkv: k and v of the block's 128 rows, then per stage q, qs and do
// of 64 query rows, then per stage the tile's lse2 and delta (f32).
template <int D>
struct DkvCfg : Panels<D> {
  using P = Panels<D>;
  static constexpr int BM = 128;                 // key rows per block
  static constexpr int BQ = 64;                  // query rows per tile
  static constexpr int STAGES = 2;               // q/do ring depth
  static constexpr int K_PANEL = BM * P::SWZ;
  static constexpr int Q_PANEL = BQ * P::SWZ;
  static constexpr int K_BYTES = BM * D * 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int STAGE_BYTES = 3 * Q_BYTES;
  static constexpr int STAT_OFFSET = 2 * K_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFFSET = STAT_OFFSET + STAGES * 2 * BQ * 4;
  static constexpr int SMEM = BAR_OFFSET + 128 + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// bf16(x * mult) of every value in a 16-byte chunk.
__device__ __forceinline__ uint4 scale_chunk(uint4 val, float mult) {
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    h2[j] = __floats2bfloat162_rn(f.x * mult, f.y * mult);
  }
  return val;
}

// This lane's share of sum_d a[d] b[d] over a D-wide bf16 row: the 16-byte
// chunks q4, q4 + 4, ... (a quad of lanes covers the row).
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                         int q4) {
  float acc = 0.0f;
#pragma unroll
  for (int ch = q4; ch < D / 8; ch += 4) {
    const uint4 av = *reinterpret_cast<const uint4*>(a + ch * 8);
    const uint4 bv = *reinterpret_cast<const uint4*>(b + ch * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 af = __bfloat1622float2(a2[j]), bf = __bfloat1622float2(b2[j]);
      acc += af.x * bf.x + af.y * bf.y;
    }
  }
  return acc;
}

// Rows row0 and row0 + 8 (those < L) of a warpgroup's 64 x D accumulator,
// times mult, rounded to bf16 into a contiguous (B, L, H, D) output; this
// thread holds columns 8 j + c and 8 j + c + 1.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float (&acc)[D / 2],
                                          float mult, int b, int L, int H, int h, int row0,
                                          int c) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= L) continue;
    __nv_bfloat16* og = out + (((long long)b * L + row) * H + h) * D + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] * mult, acc[4 * j + 2 * half + 1] * mult);
  }
}

// ---------------------------------------------------------------------------
// fa_bwd_dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const BwdParams p) {
  using C = DqCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sQ = smem;                                     // scaled in place
  unsigned char* sDO = smem + C::Q_BYTES;
  unsigned char* sK = sDO + C::Q_BYTES;                         // [STAGES][KV_BYTES]
  unsigned char* sV = sK + C::STAGES * C::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFFSET);
  uint64_t* q_full = bars;                                      // q and do
  uint64_t* k_full = bars + 1;                                  // [STAGES]
  uint64_t* v_full = k_full + C::STAGES;
  uint64_t* kv_empty = v_full + C::STAGES;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::BM;
  const int ntiles = (p.Lk + C::BN - 1) / C::BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
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
      mbar_expect_tx(q_full, 2 * C::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::NP; ++pn) {
        tma_load(sQ + pn * C::Q_PANEL, &tq, q_full, pn * C::PW, pick(1, p.q_pos, h, q0, b),
                 pick(2, p.q_pos, h, q0, b), pick(3, p.q_pos, h, q0, b));
        tma_load(sDO + pn * C::Q_PANEL, &tdo, q_full, pn * C::PW, pick(1, p.do_pos, h, q0, b),
                 pick(2, p.do_pos, h, q0, b), pick(3, p.do_pos, h, q0, b));
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % C::STAGES, row = t * C::BN;
        if (t >= C::STAGES) mbar_wait(&kv_empty[s], (t / C::STAGES - 1) & 1);
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
  const int row0 = q0 + cw * 64 + r, row1 = row0 + 8;

  // lse2 and delta of the thread's two rows; delta summed over the quad
  const long long i0 = ((long long)b * p.Lq + row0) * p.H + h;
  const long long i1 = ((long long)b * p.Lq + row1) * p.H + h;
  float lse0 = 0.0f, lse1 = 0.0f, dl0 = 0.0f, dl1 = 0.0f;
  {
    const __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
    const __nv_bfloat16* db = p.dout + b * p.do_sb + h * p.do_sh;
    if (row0 < p.Lq) {
      lse0 = p.lse[i0];
      dl0 = row_dot<D>(ob + row0 * p.o_sr, db + row0 * p.do_sr, lane % 4);
    }
    if (row1 < p.Lq) {
      lse1 = p.lse[i1];
      dl1 = row_dot<D>(ob + row1 * p.o_sr, db + row1 * p.do_sr, lane % 4);
    }
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
    if (c == 0 && row0 < p.Lq) p.delta[i0] = dl0;
    if (c == 0 && row1 < p.Lq) p.delta[i1] = dl1;
  }

  // q * scale * log2(e): f32 multiply, bf16 round, in place (the swizzle
  // only permutes 16-byte chunks within the warpgroup's rows)
  mbar_wait(q_full, 0);
  {
    constexpr int CHUNKS = 64 * C::SWZ / 16;       // 16-byte chunks of one panel's 64 rows
    for (int i = tid; i < C::NP * CHUNKS; i += 128) {
      uint4* ptr = reinterpret_cast<uint4*>(sQ + (i / CHUNKS) * C::Q_PANEL + cw * 64 * C::SWZ) +
                   i % CHUNKS;
      *ptr = scale_chunk(*ptr, p.qscale);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  }

  const uint32_t q_addr = smem_u32(sQ) + cw * 64 * C::SWZ;
  const uint32_t do_addr = smem_u32(sDO) + cw * 64 * C::SWZ;
  constexpr uint32_t SBO = 8 * C::SWZ;               // 8-row core-matrix groups

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % C::STAGES;
    const uint32_t parity = (t / C::STAGES) & 1;
    const uint32_t k_addr = smem_u32(sK) + s * C::KV_BYTES;
    const uint32_t v_addr = smem_u32(sV) + s * C::KV_BYTES;

    // S = Qs K^T and dP = dO V^T, one commit group
    float sc[32], dp[32];
    mbar_wait(&k_full[s], parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk * 16 / C::PW) * C::Q_PANEL + (kk * 16 % C::PW) * 2;
      const uint32_t koff = (kk * 16 / C::PW) * C::KV_PANEL + (kk * 16 % C::PW) * 2;
      wgmma_ss<64>(sc, make_desc(q_addr + off, 16, SBO, C::LAYOUT),
                   make_desc(k_addr + koff, 16, SBO, C::LAYOUT), kk > 0);
    }
    mbar_wait(&v_full[s], parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk * 16 / C::PW) * C::Q_PANEL + (kk * 16 % C::PW) * 2;
      const uint32_t koff = (kk * 16 / C::PW) * C::KV_PANEL + (kk * 16 % C::PW) * 2;
      wgmma_ss<64>(dp, make_desc(do_addr + off, 16, SBO, C::LAYOUT),
                   make_desc(v_addr + koff, 16, SBO, C::LAYOUT), kk > 0);
    }
    wg_commit();
    wg_wait0();
    pin(sc);
    pin(dp);

    // ds = exp2(s - lse2) (dp - delta) in registers; keys >= Lk give 0
    const int valid = p.Lk - t * C::BN;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool upper = (i >> 1) & 1;
      const float pv = ex2(sc[i] - (upper ? lse1 : lse0));
      float ds = pv * (dp[i] - (upper ? dl1 : dl0));
      if (valid < C::BN && 8 * (i / 4) + c + (i & 1) >= valid) ds = 0.0f;
      sc[i] = ds;
    }
    uint32_t da[C::BN / 16][4];
    pack_a<C::BN>(da, sc);

    // dQ += dS K: K (keys x D, D contiguous) is the transposed B operand;
    // LBO steps over the PW-column panels of D, SBO over 8-key groups
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk)
      wgmma_rs<D>(dq, da[kk], make_desc(k_addr + kk * 16 * C::SWZ, C::KV_PANEL, SBO, C::LAYOUT));
    wg_commit();
    wg_wait0();
    pin(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&kv_empty[s]);
  }

  store_acc<D>(p.dq, dq, p.scale, b, p.Lq, p.H, h, row0, c);
}

// ---------------------------------------------------------------------------
// fa_bwd_dkv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const BwdParams p) {
  using C = DkvCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + C::K_BYTES;
  unsigned char* stages = smem + 2 * C::K_BYTES;                // [STAGES][q | qs | do]
  float* sStat = reinterpret_cast<float*>(smem + C::STAT_OFFSET);   // [STAGES][lse2 | delta]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFFSET);
  uint64_t* kv_full = bars;
  uint64_t* q_full = bars + 1;                                  // [STAGES]
  uint64_t* do_full = q_full + C::STAGES;
  uint64_t* empty = do_full + C::STAGES;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * C::BM;
  const int ntiles = (p.Lq + C::BQ - 1) / C::BQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&do_full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * C::K_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::NP; ++pn) {
        tma_load(sK + pn * C::K_PANEL, &tk, kv_full, pn * C::PW, pick(1, p.k_pos, h, k0, b),
                 pick(2, p.k_pos, h, k0, b), pick(3, p.k_pos, h, k0, b));
        tma_load(sV + pn * C::K_PANEL, &tv, kv_full, pn * C::PW, pick(1, p.v_pos, h, k0, b),
                 pick(2, p.v_pos, h, k0, b), pick(3, p.v_pos, h, k0, b));
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % C::STAGES, row = t * C::BQ;
        unsigned char* st = stages + s * C::STAGE_BYTES;
        if (t >= C::STAGES) mbar_wait(&empty[s], (t / C::STAGES - 1) & 1);
        mbar_expect_tx(&q_full[s], C::Q_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn)
          tma_load(st + pn * C::Q_PANEL, &tq, &q_full[s], pn * C::PW,
                   pick(1, p.q_pos, h, row, b), pick(2, p.q_pos, h, row, b),
                   pick(3, p.q_pos, h, row, b));
        mbar_expect_tx(&do_full[s], C::Q_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn)
          tma_load(st + 2 * C::Q_BYTES + pn * C::Q_PANEL, &tdo, &do_full[s], pn * C::PW,
                   pick(1, p.do_pos, h, row, b), pick(2, p.do_pos, h, row, b),
                   pick(3, p.do_pos, h, row, b));
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns key rows [64 cw, 64 cw + 64) -----------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int ctid = threadIdx.x - 128;                // 0..255 over both consumers
  const int tid = ctid % 128;
  const int lane = tid % 32;
  // accumulator layout: rows r and r + 8 (keys), columns 8 j + c and
  // 8 j + c + 1 (queries of S^T and dP^T; D of dk and dv)
  const int r = (tid / 32) * 16 + lane / 4;
  const int c = 2 * (lane % 4);

  // The first 128 consumer threads stage the query tile's lse2 (ctid < 64)
  // and delta (64 <= ctid < 128) in shared memory, loaded a tile ahead;
  // rows >= Lq stage 0.
  const float* stat_src = ctid < C::BQ ? p.lse : p.delta;
  auto load_stat = [&](int t) {
    const int row = t * C::BQ + ctid % C::BQ;
    return ctid < 2 * C::BQ && row < p.Lq ? stat_src[((long long)b * p.Lq + row) * p.H + h]
                                          : 0.0f;
  };
  float stat = load_stat(0);

  const uint32_t k_addr = smem_u32(sK) + cw * 64 * C::SWZ;
  const uint32_t v_addr = smem_u32(sV) + cw * 64 * C::SWZ;
  constexpr uint32_t SBO = 8 * C::SWZ;               // 8-row core-matrix groups

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }
  mbar_wait(kv_full, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % C::STAGES;
    const uint32_t parity = (t / C::STAGES) & 1;
    unsigned char* sQ = stages + s * C::STAGE_BYTES;
    unsigned char* sQs = sQ + C::Q_BYTES;
    const uint32_t q_addr = smem_u32(sQ);
    const uint32_t qs_addr = smem_u32(sQs);
    const uint32_t do_addr = smem_u32(sQ + 2 * C::Q_BYTES);
    float* lse = sStat + s * 2 * C::BQ;
    const float* delta = lse + C::BQ;

    if (ctid < 2 * C::BQ) lse[ctid] = stat;
    if (t + 1 < ntiles) stat = load_stat(t + 1);

    // Qs = bf16(q * scale * log2(e)) into the stage's second tile (same
    // swizzled layout), shared by both warpgroups: each thread scales its
    // share, then fence.proxy.async and a named barrier of the two
    mbar_wait(&q_full[s], parity);
    for (int i = ctid; i < C::Q_BYTES / 16; i += 256)
      reinterpret_cast<uint4*>(sQs)[i] =
          scale_chunk(reinterpret_cast<const uint4*>(sQ)[i], p.qscale);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");

    // S^T = K Qs^T and dP^T = V dO^T, one commit group
    float st[32], dpt[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk * 16 / C::PW) * C::K_PANEL + (kk * 16 % C::PW) * 2;
      const uint32_t qoff = (kk * 16 / C::PW) * C::Q_PANEL + (kk * 16 % C::PW) * 2;
      wgmma_ss<64>(st, make_desc(k_addr + koff, 16, SBO, C::LAYOUT),
                   make_desc(qs_addr + qoff, 16, SBO, C::LAYOUT), kk > 0);
    }
    mbar_wait(&do_full[s], parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk * 16 / C::PW) * C::K_PANEL + (kk * 16 % C::PW) * 2;
      const uint32_t qoff = (kk * 16 / C::PW) * C::Q_PANEL + (kk * 16 % C::PW) * 2;
      wgmma_ss<64>(dpt, make_desc(v_addr + koff, 16, SBO, C::LAYOUT),
                   make_desc(do_addr + qoff, 16, SBO, C::LAYOUT), kk > 0);
    }
    wg_commit();
    wg_wait0();
    pin(st);
    pin(dpt);

    // p^T = exp2(s^T - lse2[q]), ds^T = p^T (dp^T - delta[q]) in registers;
    // queries >= Lq give exactly 0. Columns 8 j + c and 8 j + c + 1 of this
    // thread share one float2 of lse2 and of delta.
    const int valid = p.Lq - t * C::BQ;
#pragma unroll
    for (int j = 0; j < C::BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + c);
      const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * j + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float pv = ex2(st[i] - (e & 1 ? l2.y : l2.x));
        float ds = pv * (dpt[i] - (e & 1 ? d2.y : d2.x));
        if (valid < C::BQ && 8 * j + c + (e & 1) >= valid) {
          pv = 0.0f;
          ds = 0.0f;
        }
        st[i] = pv;
        dpt[i] = ds;
      }
    }
    uint32_t pa[C::BQ / 16][4], da[C::BQ / 16][4];
    pack_a<C::BQ>(pa, st);
    pack_a<C::BQ>(da, dpt);

    // dV += P^T dO, dK += dS^T Q: dO and the unscaled Q (queries x D, D
    // contiguous) are transposed B operands
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk)
      wgmma_rs<D>(dv, pa[kk], make_desc(do_addr + kk * 16 * C::SWZ, C::Q_PANEL, SBO, C::LAYOUT));
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk)
      wgmma_rs<D>(dk, da[kk], make_desc(q_addr + kk * 16 * C::SWZ, C::Q_PANEL, SBO, C::LAYOUT));
    wg_commit();
    wg_wait0();
    pin(dv);
    pin(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const int row0 = k0 + cw * 64 + r;
  store_acc<D>(p.dk, dk, p.scale, b, p.Lk, p.H, h, row0, c);
  store_acc<D>(p.dv, dv, 1.0f, b, p.Lk, p.H, h, row0, c);
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launch
// ---------------------------------------------------------------------------

struct Strides {
  long long sb, sr, sh;
};

// Tensor maps of q, do (boxes of the query tile's rows) and k, v (boxes of
// the key tile's rows), then the kernel over blocks of its own rows: query
// rows for dq, key rows for dk/dv.
template <int D, bool DKV>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, BwdParams p,
               int B, Strides sq, Strides sk, Strides sv, Strides sdo, cudaStream_t stream) {
  constexpr int PW = Panels<D>::PW;
  constexpr int Q_ROWS = DKV ? DkvCfg<D>::BQ : DqCfg<D>::BM;
  constexpr int K_ROWS = DKV ? DkvCfg<D>::BM : DqCfg<D>::BN;
  constexpr int SMEM = DKV ? DkvCfg<D>::SMEM : DqCfg<D>::SMEM;
  // a runtime call first: it makes the device's context current on this
  // thread (autograd runs the backward on a thread of its own), which
  // cuTensorMapEncodeTiled needs
  const cudaError_t e =
      DKV ? cudaFuncSetAttribute(fa_bwd_dkv_wgmma<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)
          : cudaFuncSetAttribute(fa_bwd_dq_wgmma<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv, tdo;
  int err;
  if ((err = encode(&tq, &p.q_pos, q, D, PW, Q_ROWS, {p.H, p.Lq, B}, {sq.sh, sq.sr, sq.sb})) ||
      (err = encode(&tdo, &p.do_pos, dout, D, PW, Q_ROWS, {p.H, p.Lq, B},
                    {sdo.sh, sdo.sr, sdo.sb})) ||
      (err = encode(&tk, &p.k_pos, k, D, PW, K_ROWS, {p.H, p.Lk, B}, {sk.sh, sk.sr, sk.sb})) ||
      (err = encode(&tv, &p.v_pos, v, D, PW, K_ROWS, {p.H, p.Lk, B}, {sv.sh, sv.sr, sv.sb})))
    return err;
  if constexpr (DKV) {
    const dim3 grid((p.Lk + DkvCfg<D>::BM - 1) / DkvCfg<D>::BM, p.H, B);
    fa_bwd_dkv_wgmma<D><<<grid, THREADS, SMEM, stream>>>(tq, tk, tv, tdo, p);
  } else {
    const dim3 grid((p.Lq + DqCfg<D>::BM - 1) / DqCfg<D>::BM, p.H, B);
    fa_bwd_dq_wgmma<D><<<grid, THREADS, SMEM, stream>>>(tq, tk, tv, tdo, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define FA_BWD_DISPATCH(DKV)                                                          \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                                 \
  const Strides sq = {q_sb, q_sr, q_sh}, sk = {k_sb, k_sr, k_sh};                     \
  const Strides sv = {v_sb, v_sr, v_sh}, sdo = {do_sb, do_sr, do_sh};                 \
  if (D == 128) return launch_bwd<128, DKV>(q, k, v, dout, p, B, sq, sk, sv, sdo, s); \
  if (D == 96) return launch_bwd<96, DKV>(q, k, v, dout, p, B, sq, sk, sv, sdo, s);   \
  if (D == 64) return launch_bwd<64, DKV>(q, k, v, dout, p, B, sq, sk, sv, sdo, s);   \
  return (int)cudaErrorInvalidValue;

extern "C" {

// q, k, v, do read through their strides, o for delta; lse2 read, delta
// written; dq written. Strides in elements: (batch, row, head) for q, k, v,
// o, do.
int fa_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* delta, void* dq, int B, int Lq, int Lk, int H, int D,
              long long q_sb, long long q_sr, long long q_sh, long long k_sb, long long k_sr,
              long long k_sh, long long v_sb, long long v_sr, long long v_sh, long long o_sb,
              long long o_sr, long long o_sh, long long do_sb, long long do_sr, long long do_sh,
              float qscale, float scale, void* stream) {
  BwdParams p = {};
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.Lq = Lq; p.Lk = Lk; p.H = H;
  p.o_sb = o_sb; p.o_sr = o_sr; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_sr = do_sr; p.do_sh = do_sh;
  p.qscale = qscale;
  p.scale = scale;
  FA_BWD_DISPATCH(false)
}

// q, k, v, do read through their strides; lse2 and the delta of fa_bwd_dq
// read; dk and dv written.
int fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int Lq, int Lk, int H, int D,
               long long q_sb, long long q_sr, long long q_sh, long long k_sb, long long k_sr,
               long long k_sh, long long v_sb, long long v_sr, long long v_sh, long long do_sb,
               long long do_sr, long long do_sh, float qscale, float scale, void* stream) {
  BwdParams p = {};
  p.lse = static_cast<const float*>(lse);
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.Lq = Lq; p.Lk = Lk; p.H = H;
  p.qscale = qscale;
  p.scale = scale;
  FA_BWD_DISPATCH(true)
}

}  // extern "C"
