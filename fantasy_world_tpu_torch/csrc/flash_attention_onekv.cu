// One-key-block attention forward for NVIDIA Hopper (sm_90a), built on TMA
// and warpgroup MMA (wgmma):
//
//   fa_fwd_onekv  (HEAD_DIM 128)  replaces _fa_kernel_onekv
//                 (fantasy_world_tpu/ops/flash_attention.py), which
//                 _flash_forward launches when every key fits in one block
//                 (Lk <= 2048): DiT cross-attention against 512 text and 257
//                 CLIP keys (16317 queries, 40 x 128) and the camera-head
//                 trunk (81 tokens, 16 x 128).
//
// It computes what the TPU kernel computes, in the same order: the exact row
// max over every key first, then exp2, the row sum and P V against that max,
// with no online rescale.
//
// What bounds it on the card: 4 * Lq * Lk * D FLOP per (batch, head) against
// q in and o out, (2 Lq + 2 Lk) * D * 2 bytes. At 512 keys that is 0.34 TFLOP
// a CFG step, 0.346 ms at the bf16 peak; at 257 keys the bytes bind (q and o
// are 668 of 679 MB, 0.203 ms at the HBM rate, against 0.172 ms of FLOP).
//
// The design's cost: the exact max takes S = Qs K^T twice, once per pass, so
// the kernel does 6 units of MMA work where the function needs 4 (a floor of
// 0.52 ms at 512 keys). That keeps the TPU kernel's numerics: P is never
// rescaled, so its bf16 rounding is the plain version's.
//
// What the design does about the rest:
//   * Every product is a wgmma with f32 accumulators in registers and A from
//     registers: S as m64n64k16 with Qs as A (loaded once an item with
//     ldmatrix and scaled there) and K from shared memory (K-major); O += P V
//     as m64n128k16 with P as A -- the S accumulator rounded to bf16 is the
//     register A operand, element for element -- and V from shared memory as
//     a transposed (MN-major) B operand. With A in registers an S product
//     reads 2 KB of shared memory per k16 step, not 4.
//   * Pass 1 keeps only the row max, in registers (quad shuffles once at the
//     end); pass 2 takes P = exp2(s2 - m2) on ex2.approx, the row sum and
//     O in registers. Nothing goes through shared memory per key tile.
//   * Keys come in tiles of 64, so 257 keys pad to 320, not 384.
//   * Warp specialisation: an item is 128 query rows of one (batch, head) --
//     two consumer warpgroups of 64 rows (setmaxnreg 240) -- and a producer
//     warpgroup whose one thread issues TMA copies (setmaxnreg 24).
//   * A persistent grid, one block per SM, each taking a run of items in
//     order, the query block fastest: Q has two buffers, and the producer
//     loads the next item's Q while this item's second pass and epilogue
//     run, so neither the load nor the store of a block's 64 KB of q and o
//     stands between two items.
//   * K: eight slots of one 64-key tile each. Up to 512 keys every tile keeps
//     its slot through both passes and through every item of its head, so K
//     is read once a head; past that the slots are a ring that streams K
//     twice an item. V: a two-stage ring. Every slot has a full (TMA bytes
//     arrived) and an empty mbarrier (eight consumer warps done with its
//     last use), so copies overlap the math.
//   * Epilogue: each warpgroup writes its O / l as bf16 into its own 64 rows
//     of the item's Q buffer (free once its last product is done), in the
//     swizzle of the output's tensor map, and one thread stores them with a
//     TMA tensor store; rows past Lq are not written. The buffer goes back
//     to the producer once the store has read it, an item later.
//   * Tensor maps are encoded on the host per call over (D, and head, row,
//     batch ordered by stride) with the tensors' own strides
//     (sm90_common.cuh), so the camera trunk's fused-qkv views and a q
//     shared by two calls load without a copy.
//
// Numerics are those of _fa_kernel_onekv and attention_plain_stats: q is
// multiplied by scale*log2(e) in f32 and rounded to bf16 (in registers);
// logits are f32 in the exp2 domain; P is rounded to bf16 before P V; the
// sum and the accumulator are f32. The ragged key tail is masked to -inf on
// the last tile (its rows load as zeros); query rows >= Lq compute on zeros
// and are not stored.
//
// Statistics (the with_stats output of _fa_kernel_onekv): given non-null m2
// and l, the epilogue also stores, per query row, the base-2 row max
// m2 = max_k s2 and the sum l = sum_k exp2(s2 - m2) as contiguous (B, Lq, H)
// f32, one store per row, where the TPU kernel writes a lane-replicated
// (BQ, 128) block (a Mosaic limit). The TPU's zero-pad correction of l and
// its 2^-23 clamp are not needed: the tail is masked, not zero-padded.
//
// The output is a contiguous (B, Lq, H, D) bf16 tensor. The entry point
// launches on the given stream and returns 0, a cudaError_t, or
// FA_ENCODE_ERROR + the CUresult of a tensor map that failed to encode
// (fa_error_string in flash_attention_sm90.cu names both); it allocates
// nothing and does not synchronise.

#include "sm90_common.cuh"

#include <limits.h>

namespace {

using namespace sm90;

constexpr int BM = 128;                // query rows per item
constexpr int BN = 64;                 // keys per tile
constexpr int Q_BUFS = 2;              // Q tiles: this item's and the next one's
constexpr int K_SLOTS = 8;             // K tiles held: every tile up to 512 keys
constexpr int V_SLOTS = 2;             // V ring depth
constexpr int CONSUMER_WARPS = 8;      // two warpgroups
constexpr int THREADS = 128 * 3;       // producer warpgroup + two consumers

template <int D>
struct OnekvCfg : Panels<D> {
  using P = Panels<D>;
  static constexpr int Q_PANEL = BM * P::SWZ;
  static constexpr int KV_PANEL = BN * P::SWZ;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int BAR_OFFSET = Q_BUFS * Q_BYTES + (K_SLOTS + V_SLOTS) * KV_BYTES;
  // + barriers, + slack to align the base to the 1024-byte swizzle atom
  static constexpr int SMEM = BAR_OFFSET + 256 + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block can have");
};

struct Params {
  float* m2;                       // (B, Lq, H) row max, base 2; null: no stats
  float* l;                        // (B, Lq, H) row sum
  int Lq, Lk, H;
  int q_blocks;                    // ceil(Lq / BM)
  int items;                       // B * H * q_blocks
  int4 q_pos, k_pos, v_pos, o_pos;   // coordinate slot (1-3) of head, row, batch
  float qscale;                    // softmax scale * log2(e)
};

// Item i is (batch, head, query block), the query block fastest: a block's
// run of items stays on one head for q_blocks items at a time.
struct Item {
  int b, h, q0, bh;
};

__device__ __forceinline__ Item item_at(const Params& p, int i) {
  const int bh = i / p.q_blocks;
  return {bh / p.H, bh % p.H, (i % p.q_blocks) * BM, bh};
}

// S = Qs K^T of one warpgroup's 64 rows against a 64-key tile (exp2 domain:
// q carries scale * log2(e)), Qs from registers; returns once the product
// is in sc.
template <int D>
__device__ __forceinline__ void scores(float (&sc)[32], const uint32_t (&qa)[D / 16][4],
                                       uint32_t k_addr) {
  using C = OnekvCfg<D>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t koff = (kk * 16 / C::PW) * C::KV_PANEL + (kk * 16 % C::PW) * 2;
    wgmma_rs_k64(sc, qa[kk], make_desc(k_addr + koff, 16, 8 * C::SWZ, C::LAYOUT), kk > 0);
  }
  wg_commit();
  wg_wait0();
  pin(sc);
}

// Keys >= Lk of the last tile score -inf; `valid` keys of the tile are real.
__device__ __forceinline__ void mask_tail(float (&sc)[32], int valid, int c) {
  if (valid >= BN) return;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (8 * (i / 4) + c + (i & 1) >= valid) sc[i] = -INFINITY;
}

// A persistent grid: block g takes items [g N / G, (g + 1) N / G) of the N
// items in order. Every copy has a sequence number over the block's life --
// K loads jk, V loads jv, Q loads by item -- that gives its slot and the
// parity of its full and empty barriers; producer and consumers count alike.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_fwd_onekv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                   const Params p) {
  using C = OnekvCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;                                     // [Q_BUFS][Q_BYTES]: q, then O
  unsigned char* sK = sQ + Q_BUFS * C::Q_BYTES;                 // [K_SLOTS][KV_BYTES]
  unsigned char* sV = sK + K_SLOTS * C::KV_BYTES;               // [V_SLOTS][KV_BYTES]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFFSET);
  uint64_t* q_full = bars;                                      // [Q_BUFS]
  uint64_t* q_empty = q_full + Q_BUFS;
  uint64_t* k_full = q_empty + Q_BUFS;                          // [K_SLOTS]
  uint64_t* k_empty = k_full + K_SLOTS;
  uint64_t* v_full = k_empty + K_SLOTS;                         // [V_SLOTS]
  uint64_t* v_empty = v_full + V_SLOTS;

  const int first = static_cast<int>((long long)blockIdx.x * p.items / gridDim.x);
  const int last = static_cast<int>((long long)(blockIdx.x + 1) * p.items / gridDim.x);
  const int ntiles = (p.Lk + BN - 1) / BN;
  // Up to K_SLOTS tiles, K stays in its slots for both passes and for every
  // item of the same head; past that the slots are a ring that streams K
  // twice an item.
  const bool resident = ntiles <= K_SLOTS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Q_BUFS; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 2);                   // the storing thread of each warpgroup
    }
    for (int s = 0; s < K_SLOTS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < V_SLOTS; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy, in the order of use ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      auto load = [&](const CUtensorMap* map, int4 pos, unsigned char* dst, uint64_t* bar,
                      const Item& it, int row, int bytes) {
        mbar_expect_tx(bar, bytes);
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn)
          tma_load(dst + pn * (bytes / C::NP), map, bar, pn * C::PW,
                   pick(1, pos, it.h, row, it.b), pick(2, pos, it.h, row, it.b),
                   pick(3, pos, it.h, row, it.b));
      };
      // Q of the n-th item of this block, once both warpgroups have stored
      // the O staged in its buffer two items before
      auto load_q = [&](int n) {
        const int s = n % Q_BUFS;
        if (n >= Q_BUFS) mbar_wait(&q_empty[s], (n / Q_BUFS - 1) & 1);
        const Item it = item_at(p, first + n);
        load(&tq, p.q_pos, sQ + s * C::Q_BYTES, &q_full[s], it, it.q0, C::Q_BYTES);
      };
      int jk = 0, jv = 0, loaded_bh = -1;
      if (first < last) load_q(0);
      for (int i = first; i < last; ++i) {
        const Item it = item_at(p, i);
        auto load_k = [&](int t) {
          const int s = jk % K_SLOTS;
          if (jk >= K_SLOTS) mbar_wait(&k_empty[s], (jk / K_SLOTS - 1) & 1);
          load(&tk, p.k_pos, sK + s * C::KV_BYTES, &k_full[s], it, t * BN, C::KV_BYTES);
          ++jk;
        };
        if (!resident || it.bh != loaded_bh)
          for (int t = 0; t < ntiles; ++t) load_k(t);
        loaded_bh = it.bh;
        for (int t = 0; t < ntiles; ++t) {
          if (!resident) load_k(t);
          const int s = jv % V_SLOTS;
          if (jv >= V_SLOTS) mbar_wait(&v_empty[s], (jv / V_SLOTS - 1) & 1);
          load(&tv, p.v_pos, sV + s * C::KV_BYTES, &v_full[s], it, t * BN, C::KV_BYTES);
          ++jv;
          // the next item's Q, once this item's first V tiles are on their
          // way: it lands while this item's second pass runs
          if (t == min(ntiles, V_SLOTS) - 1 && i + 1 < last) load_q(i + 1 - first);
        }
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

  int jk = 0, jv = 0, loaded_bh = -1, kbase = 0;
  for (int i = first; i < last; ++i) {
    const int n = i - first;
    const Item it = item_at(p, i);
    const int next_bh = i + 1 < last ? item_at(p, i + 1).bh : -1;
    unsigned char* sQb = sQ + (n % Q_BUFS) * C::Q_BYTES;
    if (!resident || it.bh != loaded_bh) {
      kbase = jk;
      jk += ntiles;
    }
    loaded_bh = it.bh;

    // Qs = bf16(q * scale * log2(e)), f32 multiply, in registers: the A
    // fragments of this warp's 16 rows (ldmatrix through the swizzle), the
    // operand of every S product of the item
    mbar_wait(&q_full[n % Q_BUFS], (n / Q_BUFS) & 1);
    uint32_t qa[D / 16][4];
    {
      const int mat = lane / 8;
      const int row = cw * 64 + (tid / 32) * 16 + (mat & 1) * 8 + lane % 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = kk * 16 + (mat >> 1) * 8;
        ldmatrix_x4(qa[kk], smem_u32(sQb) + (col / C::PW) * C::Q_PANEL + row * C::SWZ +
                                (((col % C::PW) / 8) ^ (row % 8)) * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][e]));
          qa[kk][e] = pack_bf16(f.x * p.qscale, f.y * p.qscale);
        }
      }
    }

    // pass 1: the exact row max over every key
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int t = 0; t < ntiles; ++t) {
      const int j = kbase + t, s = j % K_SLOTS;
      float sc[32];
      mbar_wait(&k_full[s], (j / K_SLOTS) & 1);
      scores<D>(sc, qa, smem_u32(sK) + s * C::KV_BYTES);
      __syncwarp();
      if (!resident && lane == 0) mbar_arrive(&k_empty[s]);
      mask_tail(sc, p.Lk - t * BN, c);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        m0 = fmaxf(m0, fmaxf(sc[4 * x], sc[4 * x + 1]));
        m1 = fmaxf(m1, fmaxf(sc[4 * x + 2], sc[4 * x + 3]));
      }
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));

    // the O of the item before has been read out of its Q buffer: release
    // the buffer to the producer for the item after this one
    if (tid == 0 && n > 0) {
      tma_store_wait();
      mbar_arrive(&q_empty[(n - 1) % Q_BUFS]);
    }

    // pass 2: sum and P V against the exact max, no rescale
    if (!resident) {
      kbase = jk;
      jk += ntiles;
    }
    // the last use of a resident K tile is the second pass of the head's
    // last item
    const bool release_k = !resident || next_bh != it.bh;
    float o[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] = 0.0f;
    float l0 = 0.0f, l1 = 0.0f;
    for (int t = 0; t < ntiles; ++t) {
      const int j = kbase + t, s = j % K_SLOTS;
      float sc[32];
      mbar_wait(&k_full[s], (j / K_SLOTS) & 1);
      scores<D>(sc, qa, smem_u32(sK) + s * C::KV_BYTES);
      __syncwarp();
      if (release_k && lane == 0) mbar_arrive(&k_empty[s]);
      mask_tail(sc, p.Lk - t * BN, c);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        sc[4 * x] = ex2(sc[4 * x] - m0);
        sc[4 * x + 1] = ex2(sc[4 * x + 1] - m0);
        sc[4 * x + 2] = ex2(sc[4 * x + 2] - m1);
        sc[4 * x + 3] = ex2(sc[4 * x + 3] - m1);
        l0 += sc[4 * x] + sc[4 * x + 1];
        l1 += sc[4 * x + 2] + sc[4 * x + 3];
      }
      // P in bf16: the S accumulator of keys 16 kk .. 16 kk + 15 is the
      // register A fragment of the kk-th k16 step
      uint32_t pa[BN / 16][4];
      pack_a<BN>(pa, sc);

      // O += P V: V (keys x D, D contiguous) is the transposed B operand;
      // LBO steps over the PW-column panels of D, SBO over 8-key groups
      const int vs = jv % V_SLOTS;
      const uint32_t v_addr = smem_u32(sV) + vs * C::KV_BYTES;
      mbar_wait(&v_full[vs], (jv / V_SLOTS) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    make_desc(v_addr + kk * 16 * C::SWZ, C::KV_PANEL, 8 * C::SWZ, C::LAYOUT));
      wg_commit();
      wg_wait0();
      pin(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[vs]);
      ++jv;
    }

    // epilogue: the quad's partial sums, O / l staged as bf16 in this
    // warpgroup's rows of the Q buffer under the 128-byte swizzle of the
    // output map (16-byte chunk k of row r at chunk k ^ (r % 8)), one TMA
    // store whose read is waited for an item later
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    unsigned char* sO = sQb + cw * 64 * C::SWZ;
#pragma unroll
    for (int x = 0; x < D / 8; ++x) {
      unsigned char* panel = sO + (x * 8 / C::PW) * C::Q_PANEL;
      const int chunk = x % (C::PW / 8);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r + 8 * half;
        const float inv = half ? inv1 : inv0;
        *reinterpret_cast<uint32_t*>(panel + row * C::SWZ + ((chunk ^ (row % 8)) * 16) + c * 2) =
            pack_bf16(o[4 * x + 2 * half] * inv, o[4 * x + 2 * half + 1] * inv);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    const int orow = it.q0 + cw * 64;
    if (tid == 0 && orow < p.Lq) {
#pragma unroll
      for (int pn = 0; pn < C::NP; ++pn)
        tma_store(&to, sO + pn * C::Q_PANEL, pn * C::PW, pick(1, p.o_pos, it.h, orow, it.b),
                  pick(2, p.o_pos, it.h, orow, it.b), pick(3, p.o_pos, it.h, orow, it.b));
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if (p.m2 != nullptr && c == 0) {
      const int row0 = orow + r, row1 = row0 + 8;
      if (row0 < p.Lq) {
        const long long i0 = ((long long)it.b * p.Lq + row0) * p.H + it.h;
        p.m2[i0] = m0;
        p.l[i0] = l0;
      }
      if (row1 < p.Lq) {
        const long long i1 = ((long long)it.b * p.Lq + row1) * p.H + it.h;
        p.m2[i1] = m1;
        p.l[i1] = l1;
      }
    }
  }
  // the last item's O must leave shared memory before the block ends
  if (tid == 0) tma_store_wait();
}

// ---------------------------------------------------------------------------
// host side: launch
// ---------------------------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* m2, void* l, int B,
           int Lq, int Lk, int H, long long q_sb, long long q_sr, long long q_sh, long long k_sb,
           long long k_sr, long long k_sh, long long v_sb, long long v_sr, long long v_sh,
           float qscale, cudaStream_t stream) {
  using C = OnekvCfg<D>;
  // a runtime call first: it makes the device's context current on this
  // thread, which cuTensorMapEncodeTiled needs
  const cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_onekv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv, to;
  Params p;
  const long long o_sh = D, o_sr = (long long)H * D, o_sb = (long long)Lq * H * D;
  int err;
  if ((err = encode(&tq, &p.q_pos, q, D, C::PW, BM, {H, Lq, B}, {q_sh, q_sr, q_sb})) ||
      (err = encode(&tk, &p.k_pos, k, D, C::PW, BN, {H, Lk, B}, {k_sh, k_sr, k_sb})) ||
      (err = encode(&tv, &p.v_pos, v, D, C::PW, BN, {H, Lk, B}, {v_sh, v_sr, v_sb})) ||
      (err = encode(&to, &p.o_pos, o, D, C::PW, 64, {H, Lq, B}, {o_sh, o_sr, o_sb})))
    return err;
  p.m2 = static_cast<float*>(m2);
  p.l = static_cast<float*>(l);
  p.Lq = Lq;
  p.Lk = Lk;
  p.H = H;
  p.qscale = qscale;
  p.q_blocks = (Lq + BM - 1) / BM;
  const long long items = (long long)B * H * p.q_blocks;
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  int device, sms;
  cudaError_t ce;
  if ((ce = cudaGetDevice(&device)) != cudaSuccess ||
      (ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)ce;
  const int grid = p.items < sms ? p.items : sms;   // one block per SM
  fa_fwd_onekv_wgmma<D><<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fa_fwd_onekv(const void* q, const void* k, const void* v, void* o, void* m2, void* l, int B,
                 int Lq, int Lk, int H, int D, long long q_sb, long long q_sr, long long q_sh,
                 long long k_sb, long long k_sr, long long k_sh, long long v_sb, long long v_sr,
                 long long v_sh, float qscale, void* stream) {
  if (D != 128) return (int)cudaErrorInvalidValue;
  return launch<128>(q, k, v, o, m2, l, B, Lq, Lk, H, q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb,
                     v_sr, v_sh, qscale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
