// Flash-attention forward for NVIDIA Hopper (sm_90a) over one key block:
// the counterpart of the Pallas kernel _fa_kernel_onekv
// (fantasy_world_tpu/ops/flash_attention.py, Lk <= 2048).
//
//   fa_fwd_onekv    (HEAD_DIM 128)      DiT cross-attention against 512 text /
//                   257 CLIP keys and the camera-head trunk (81 keys). Exact
//                   row max first, then sum and P.V with no rescale.
//
// (The online-softmax routes, fa_fwd_generic and fa_fwd_d64, are the TMA and
// wgmma kernel in flash_attention_sm90.cu.)
//
// What bounds it on the card: at 257-512 keys DiT cross-attention is
// 0.17-0.34 TFLOP per CFG step, so it is bound by tensor-core math and by the
// softmax work between the two products, not by device memory. The design
// keeps Q in registers for the whole key sweep, runs both products on the
// tensor cores through nvcuda::wmma bf16 16x16x16 fragments (mma.sync) with
// f32 accumulators, and keeps the output accumulator in registers; the
// per-row softmax runs on a 16 x 64 f32 score tile in shared memory, two
// lanes per row. The final 1/l is applied elementwise through an accumulator
// fragment loaded from a row-broadcast 16 x 16 matrix, which has the same
// element-to-row mapping as the output fragments whatever the hardware
// layout is.
//
// Numerics follow the TPU kernel: q is multiplied by scale*log2(e) in f32
// and rounded to bf16, logits are f32 in the exp2 domain, P is rounded to
// bf16 before P.V, statistics and the accumulator are f32. The ragged key
// tail is masked on the last tile (OOB keys score -inf and their V rows load
// as zeros); query rows >= Lq compute on zeros and are not stored.
//
// Statistics (the with_stats output of _fa_kernel_onekv): given non-null m2
// and l, the entry point also stores, per query row, the base-2 row max
// m2 = max_k s2 and the sum l = sum_k exp2(s2 - m2) as contiguous (B, Lq, H)
// f32 -- one store per row in the epilogue, where the TPU kernel writes a
// lane-replicated (BQ, 128) block (a Mosaic limit). The TPU's zero-pad
// correction of l and its 2^-23 clamp are not needed: the tail is masked,
// not zero-padded.
//
// Layout: q/k/v are read in place through their (batch, row, head) strides in
// elements, with a unit stride on D -- (B, L, H*D) rows with the head's D-wide
// column slice, so strided views need no copy. The output is a contiguous
// (B, Lq, H, D) bf16 tensor.
//
// The entry point launches on the given stream and returns a cudaError_t
// (0 on success); it allocates nothing and does not synchronise.

#include "fa_common.cuh"

namespace {

using namespace fa;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* m2;                       // (B, Lq, H) row max, base 2; null: no stats
  float* l;                        // (B, Lq, H) row sum
  int Lq, Lk;
  long long q_sb, q_sr, q_sh;
  long long k_sb, k_sr, k_sh;
  long long v_sb, v_sr, v_sh;
  long long o_sb, o_sr, o_sh;
  float qscale;                    // softmax scale * log2(e)
};

// Shared-memory plan of one block. Every region and every 16-row sub-tile
// starts on a 32-byte boundary, as wmma loads and stores require.
template <int D>
struct Plan {
  static constexpr int LDH = D + PAD_H;                     // Q, K, V tiles
  static constexpr int LDS = (D > BK ? D : BK) + PAD_F;     // f32 scratch
  static constexpr int LDP = BK + PAD_H;                    // P tile
  static constexpr size_t q_bytes = size_t(BQ) * LDH * 2;
  static constexpr size_t kv_bytes = size_t(BK) * LDH * 2;
  static constexpr size_t s_bytes = size_t(WARPS) * 16 * LDS * 4;
  static constexpr size_t p_bytes = size_t(WARPS) * 16 * LDP * 2;
  static constexpr size_t a_bytes = size_t(WARPS) * 16 * 16 * 4;
  static constexpr size_t total = q_bytes + 2 * kv_bytes + s_bytes + p_bytes + a_bytes;
};

// The warp's 16 x BK logits S = Q K^T (exp2 domain) into its f32 scratch.
template <int D>
__device__ __forceinline__ void score_tile(const FragA (&qf)[D / 16],
                                           const __nv_bfloat16* sK, float* sS) {
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    FragC sf;
    wmma::fill_fragment(sf, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBc kf;
      wmma::load_matrix_sync(kf, sK + n * 16 * Plan<D>::LDH + kk * 16, Plan<D>::LDH);
      wmma::mma_sync(sf, qf[kk], kf, sf);
    }
    wmma::store_matrix_sync(sS + n * 16, sf, Plan<D>::LDS, wmma::mem_row_major);
  }
}

// Multiply every output fragment row r by the value each lane pair holds
// for its row: broadcast through a 16 x 16 accumulator-layout matrix.
template <int D>
__device__ __forceinline__ void scale_rows(FragC (&of)[D / 16], float* sA, int r, int par,
                                           float value) {
#pragma unroll
  for (int j = 0; j < 8; ++j) sA[r * 16 + 2 * j + par] = value;
  __syncwarp();
  FragC af;
  wmma::load_matrix_sync(af, sA, 16, wmma::mem_row_major);
#pragma unroll
  for (int d = 0; d < D / 16; ++d)
#pragma unroll
    for (int i = 0; i < af.num_elements; ++i) of[d].x[i] *= af.x[i];
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
fa_fwd_kernel(const Params p) {
  using P = Plan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + P::q_bytes);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + P::q_bytes + P::kv_bytes);
  float* sS = reinterpret_cast<float*>(smem + P::q_bytes + 2 * P::kv_bytes) + warp * 16 * P::LDS;
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(
      smem + P::q_bytes + 2 * P::kv_bytes + P::s_bytes) + warp * 16 * P::LDP;
  float* sA = reinterpret_cast<float*>(
      smem + P::q_bytes + 2 * P::kv_bytes + P::s_bytes + P::p_bytes) + warp * 256;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;

  // Q tile, pre-scaled by scale*log2(e) in f32 and rounded to bf16
  load_tile<D, true>(sQ, qg, p.q_sr, q0, p.Lq, p.qscale);
  __syncthreads();
  FragA qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * P::LDH + kk * 16, P::LDH);

  FragC of[D / 16];
#pragma unroll
  for (int d = 0; d < D / 16; ++d) wmma::fill_fragment(of[d], 0.0f);

  // lane -> (row r of the warp's 16, column parity): lanes 2r and 2r+1 own
  // row r and hold identical copies of its running max m and sum l
  const int r = lane >> 1, par = lane & 1;
  float m = -INFINITY, l = 0.0f;
  const int ntiles = (p.Lk + BK - 1) / BK;

  // pass 1: the exact row max over every key
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    load_tile<D>(sK, kg, p.k_sr, t * BK, p.Lk);
    __syncthreads();
    score_tile<D>(qf, sK, sS);
    __syncwarp();
    const int valid = min(BK, p.Lk - t * BK);
#pragma unroll 8
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + par;
      if (c < valid) m = fmaxf(m, sS[r * P::LDS + c]);
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  }

  // pass 2: sum and P V with the exact max, no rescale
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    load_tile<D>(sK, kg, p.k_sr, t * BK, p.Lk);
    load_tile<D>(sV, vg, p.v_sr, t * BK, p.Lk);
    __syncthreads();
    score_tile<D>(qf, sK, sS);
    __syncwarp();
    const int valid = min(BK, p.Lk - t * BK);
    const float* srow = sS + r * P::LDS;
    float sum = 0.0f;
#pragma unroll 8
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + par;
      const float pv = c < valid ? exp2f(srow[c] - m) : 0.0f;
      sum += pv;
      sP[r * P::LDP + c] = __float2bfloat16(pv);
    }
    l += sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    __syncwarp();
    // O += P V
    FragA pf[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wmma::load_matrix_sync(pf[kk], sP + kk * 16, P::LDP);
#pragma unroll
    for (int d = 0; d < D / 16; ++d) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        FragBr vf;
        wmma::load_matrix_sync(vf, sV + kk * 16 * P::LDH + d * 16, P::LDH);
        wmma::mma_sync(of[d], pf[kk], vf, of[d]);
      }
    }
  }

  // epilogue: O / l, staged through the f32 scratch, rows < Lq stored
  scale_rows<D>(of, sA, r, par, 1.0f / l);
#pragma unroll
  for (int d = 0; d < D / 16; ++d)
    wmma::store_matrix_sync(sS + d * 16, of[d], P::LDS, wmma::mem_row_major);
  __syncwarp();
  store_rows<D>(p.o + b * p.o_sb + h * p.o_sh, sS, q0 + warp * 16, p.Lq, p.o_sr, lane);
  const int qrow = q0 + warp * 16 + r;
  if (p.m2 != nullptr && par == 0 && qrow < p.Lq) {
    const long long i = ((long long)b * p.Lq + qrow) * gridDim.y + h;
    p.m2[i] = m;
    p.l[i] = l;
  }
}

template <int D>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  const size_t smem = Plan<D>::total;
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Lq + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<D><<<grid, WARPS * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, void* o, void* m2, void* l,
                   int Lq, int Lk, int H,
                   int D, long long q_sb, long long q_sr, long long q_sh, long long k_sb,
                   long long k_sr, long long k_sh, long long v_sb, long long v_sr,
                   long long v_sh, float qscale) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.m2 = static_cast<float*>(m2);
  p.l = static_cast<float*>(l);
  p.Lq = Lq;
  p.Lk = Lk;
  p.q_sb = q_sb; p.q_sr = q_sr; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sr = k_sr; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sr = v_sr; p.v_sh = v_sh;
  p.o_sh = D;
  p.o_sr = (long long)H * D;
  p.o_sb = (long long)Lq * H * D;
  p.qscale = qscale;
  return p;
}

}  // namespace

#define FA_ARGS                                                                         \
  const void *q, const void *k, const void *v, void *o, void *m2, void *l, int B, int Lq,  \
      int Lk, int H, int D,                                                                 \
      long long q_sb, long long q_sr, long long q_sh, long long k_sb, long long k_sr,       \
      long long k_sh, long long v_sb, long long v_sr, long long v_sh, float qscale,         \
      void *stream
#define FA_PARAMS                                                                        \
  make_params(q, k, v, o, m2, l, Lq, Lk, H, D, q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, \
              qscale)

extern "C" {

int fa_fwd_onekv(FA_ARGS) {
  const Params p = FA_PARAMS;
  if (D != 128) return (int)cudaErrorInvalidValue;
  return launch<128>(p, B, H, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
