// Flash-attention backward for NVIDIA Hopper (sm_90a): two entry points,
// one per Pallas TPU backward kernel of the JAX reference
// (fantasy_world_tpu/ops/flash_attention.py, _flash_backward), each built for
// HEAD_DIM 64, 96 and 128 -- the VGGT, bicross and DiT head widths.
//
//   fa_bwd_dq   replaces _fa_bwd_dq_kernel. One block per (batch, head,
//               64-row query tile) loops over the key tiles -- the TPU's
//               sequential grid axis -- and keeps dq in registers:
//                 s2 = qs.k^T with qs = bf16(q * scale * log2(e)),
//                 p = exp2(s2 - lse2), dp = do.v^T, ds = p (dp - delta),
//                 dq = scale * sum_k bf16(ds).k.
//               delta = rowsum(do * o) is computed once per query tile in f32
//               and also stored, as (B, Lq, H) f32, for fa_bwd_dkv; the TPU
//               kernel recomputes it for every (key tile, query tile) pair.
//   fa_bwd_dkv  replaces _fa_bwd_dkv_kernel. One block per (batch, head,
//               64-row key tile) loops over the query tiles and keeps dk and
//               dv in registers:
//                 dv = sum_q bf16(p)^T.do,  dk = scale * sum_q bf16(ds)^T.q
//               with the unscaled q. Query rows past Lq load q and do as
//               zeros and their p and ds columns are set to exactly 0, so the
//               sums over q see no garbage (on the TPU an OOB row read NaN,
//               and 0 * NaN would poison every row).
//               Reads the delta that fa_bwd_dq wrote: both launch on one
//               stream, dq first.
//
// What bounds them on the card: the two kernels do 14 B H Lq Lk D FLOPs
// between them (dq: three products, dk/dv: four), ~1.1 PFLOP per full-width
// training step, so they are bound by tensor-core math and by the
// elementwise softmax-gradient work between the products, as the forward
// is. The design is the forward's: both products of each stage run on the
// tensor cores through nvcuda::wmma bf16 16x16x16 fragments (mma.sync) with
// f32 accumulators; the per-element work (p, ds) runs on 16 x 64 f32 tiles in
// shared memory, two lanes per row; the output accumulators stay in
// registers for the whole sweep; tiles are loaded synchronously, no
// pipelining yet.
//
// Numerics follow the TPU kernels: logits are recomputed exactly as the
// forward computed them (bf16 qs, f32 products, exp2 domain) against the
// saved lse2 = m2 + log2(l); p and ds are rounded to bf16 only as operands of
// the dv/dk/dq products; dq and dk are scaled by the softmax scale at the
// end; every accumulator is f32. The ragged key tail is masked on the last
// tile (keys past Lk load as zeros and get p = ds = 0).
//
// Layout: q/k/v/o/do are read in place through their (batch, row, head)
// strides in elements with a unit stride on D; lse2 and delta are contiguous
// (B, Lq, H) f32; dq, dk and dv are contiguous (B, L, H, D) bf16. Each entry
// point launches on the given stream and returns a cudaError_t (0 on
// success); it allocates nothing and does not synchronise.

#include "fa_common.cuh"

namespace {

using namespace fa;

struct Strides {
  long long sb, sr, sh;
};

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;                // (B, Lq, H) lse2 = m2 + log2(l)
  float* delta;                    // (B, Lq, H) rowsum(do * o)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int Lq, Lk, H;
  Strides sq, sk, sv, so, sdo;
  float qscale;                    // softmax scale * log2(e)
  float scale;                     // softmax scale
};

template <int D>
struct BwdPlan {
  static constexpr int LDH = D + PAD_H;           // bf16 tiles
  static constexpr int LDS = BK + PAD_F;          // f32 16 x 64 scratch
  static constexpr int LDP = BK + PAD_H;          // bf16 16 x 64 operands
  static constexpr size_t tile = size_t(64) * LDH * 2;
  // per warp: S and dP scratch, back to back; the epilogue reuses them to
  // stage a 16 x D f32 result (16 (D + PAD_F) <= 2 * 16 * LDS for D <= 128)
  static constexpr size_t warp_f = size_t(2) * 16 * LDS;
  static constexpr size_t f_bytes = size_t(WARPS) * warp_f * 4;
  static constexpr size_t p_bytes = size_t(WARPS) * 16 * LDP * 2;
  static_assert(16 * (D + PAD_F) <= 2 * 16 * LDS, "staging does not fit the scratch");
  // fa_bwd_dq: qs, do, k, v tiles + scratch + ds
  static constexpr size_t dq_total = 4 * tile + f_bytes + p_bytes;
  // fa_bwd_dkv: k, v, q, qs, do tiles + scratch + p, ds + lse, delta
  static constexpr size_t dkv_total = 5 * tile + f_bytes + 2 * p_bytes + 2 * 64 * 4;
};

// acc (16 x 16 tiles over the warp's 16 rows) = A (16 x D, rows of `a`) times
// B^T, for the 64 rows of `b` (each 16-row block of b gives one 16 x 16 tile):
// the 16 x 64 product a.b^T stored f32 into `out` (row stride BwdPlan::LDS).
template <int D>
__device__ __forceinline__ void rows_times_tile_t(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                                  float* out) {
  constexpr int LDH = BwdPlan<D>::LDH;
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA af;
      FragBc bf;
      wmma::load_matrix_sync(af, a + kk * 16, LDH);
      wmma::load_matrix_sync(bf, b + n * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, BwdPlan<D>::LDS, wmma::mem_row_major);
  }
}

// acc[d] += A (16 x 64 bf16, row stride LDP) . B (64 x D bf16 tile, row-major)
template <int D>
__device__ __forceinline__ void accumulate(FragC (&acc)[D / 16], const __nv_bfloat16* a,
                                           const __nv_bfloat16* b) {
  constexpr int LDH = BwdPlan<D>::LDH;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    FragA af;
    wmma::load_matrix_sync(af, a + kk * 16, BwdPlan<D>::LDP);
#pragma unroll
    for (int d = 0; d < D / 16; ++d) {
      FragBr bf;
      wmma::load_matrix_sync(bf, b + kk * 16 * LDH + d * 16, LDH);
      wmma::mma_sync(acc[d], af, bf, acc[d]);
    }
  }
}

// Scale the warp's 16 x D accumulator by `mult`, stage it through the warp's
// f32 scratch and store rows row0 + r < limit of a contiguous (rows, H, D)
// bf16 output.
template <int D>
__device__ __forceinline__ void finish(FragC (&acc)[D / 16], float mult, float* stage,
                                       __nv_bfloat16* out, int row0, int limit, int H,
                                       int lane) {
#pragma unroll
  for (int d = 0; d < D / 16; ++d) {
#pragma unroll
    for (int i = 0; i < acc[d].num_elements; ++i) acc[d].x[i] *= mult;
    wmma::store_matrix_sync(stage + d * 16, acc[d], D + PAD_F, wmma::mem_row_major);
  }
  __syncwarp();
  store_rows<D>(out, stage, row0, limit, (long long)H * D, lane);
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
fa_bwd_dq_kernel(const BwdParams p) {
  using P = BwdPlan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* sQs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sDO = reinterpret_cast<__nv_bfloat16*>(smem + P::tile);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + 2 * P::tile);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + 3 * P::tile);
  float* sS = reinterpret_cast<float*>(smem + 4 * P::tile) + warp * P::warp_f;
  float* sDP = sS + 16 * P::LDS;
  __nv_bfloat16* sDS = reinterpret_cast<__nv_bfloat16*>(smem + 4 * P::tile + P::f_bytes) +
                       warp * 16 * P::LDP;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qg = p.q + b * p.sq.sb + h * p.sq.sh;
  const __nv_bfloat16* kg = p.k + b * p.sk.sb + h * p.sk.sh;
  const __nv_bfloat16* vg = p.v + b * p.sv.sb + h * p.sv.sh;
  const __nv_bfloat16* dog = p.dout + b * p.sdo.sb + h * p.sdo.sh;

  load_tile<D, true>(sQs, qg, p.sq.sr, q0, p.Lq, p.qscale);
  load_tile<D>(sDO, dog, p.sdo.sr, q0, p.Lq);
  __syncthreads();

  // lanes 2r and 2r+1 own row r of the warp's 16: its lse2 and delta, delta
  // summed over D in f32, half the columns each
  const int r = lane >> 1, par = lane & 1;
  const int qrow = q0 + warp * 16 + r;
  const long long srow = ((long long)b * p.Lq + qrow) * p.H + h;
  float lse = 0.0f, delta = 0.0f;
  if (qrow < p.Lq) {
    lse = p.lse[srow];
    const __nv_bfloat16* orow = p.o + b * p.so.sb + h * p.so.sh + (long long)qrow * p.so.sr;
    const __nv_bfloat16* drow = sDO + (warp * 16 + r) * P::LDH;
    for (int c = par * (D / 2); c < (par + 1) * (D / 2); c += 8) {
      uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
      uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 of = __bfloat1622float2(o2[j]), df = __bfloat1622float2(d2[j]);
        delta += of.x * df.x + of.y * df.y;
      }
    }
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  if (qrow < p.Lq && par == 0) p.delta[srow] = delta;

  FragC acc[D / 16];
#pragma unroll
  for (int d = 0; d < D / 16; ++d) wmma::fill_fragment(acc[d], 0.0f);

  const int ntiles = (p.Lk + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    load_tile<D>(sK, kg, p.sk.sr, t * BK, p.Lk);
    load_tile<D>(sV, vg, p.sv.sr, t * BK, p.Lk);
    __syncthreads();
    rows_times_tile_t<D>(sQs + warp * 16 * P::LDH, sK, sS);    // s2
    rows_times_tile_t<D>(sDO + warp * 16 * P::LDH, sV, sDP);   // dp
    __syncwarp();
    const int valid = min(BK, p.Lk - t * BK);
#pragma unroll 8
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + par;
      float ds = 0.0f;
      if (c < valid) {
        const float pv = exp2f(sS[r * P::LDS + c] - lse);
        ds = pv * (sDP[r * P::LDS + c] - delta);
      }
      sDS[r * P::LDP + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate<D>(acc, sDS, sK);                               // dq += ds.k
  }
  finish<D>(acc, p.scale, sS, p.dq + (long long)b * p.Lq * p.H * D + (long long)h * D,
            q0 + warp * 16, p.Lq, p.H, lane);
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
fa_bwd_dkv_kernel(const BwdParams p) {
  using P = BwdPlan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + P::tile);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + 2 * P::tile);
  __nv_bfloat16* sQs = reinterpret_cast<__nv_bfloat16*>(smem + 3 * P::tile);
  __nv_bfloat16* sDO = reinterpret_cast<__nv_bfloat16*>(smem + 4 * P::tile);
  float* sS = reinterpret_cast<float*>(smem + 5 * P::tile) + warp * P::warp_f;
  float* sDP = sS + 16 * P::LDS;
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + 5 * P::tile + P::f_bytes) +
                      warp * 16 * P::LDP;
  __nv_bfloat16* sDS = sP + WARPS * 16 * P::LDP;
  float* sLse = reinterpret_cast<float*>(smem + 5 * P::tile + P::f_bytes + 2 * P::p_bytes);
  float* sDelta = sLse + 64;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const __nv_bfloat16* qg = p.q + b * p.sq.sb + h * p.sq.sh;
  const __nv_bfloat16* dog = p.dout + b * p.sdo.sb + h * p.sdo.sh;
  load_tile<D>(sK, p.k + b * p.sk.sb + h * p.sk.sh, p.sk.sr, k0, p.Lk);
  load_tile<D>(sV, p.v + b * p.sv.sb + h * p.sv.sh, p.sv.sr, k0, p.Lk);

  FragC dk[D / 16], dv[D / 16];
#pragma unroll
  for (int d = 0; d < D / 16; ++d) {
    wmma::fill_fragment(dk[d], 0.0f);
    wmma::fill_fragment(dv[d], 0.0f);
  }

  // lanes 2r and 2r+1 own key row r of the warp's 16; columns are queries
  const int r = lane >> 1, par = lane & 1;
  const int ntiles = (p.Lq + BQ - 1) / BQ;
  for (int t = 0; t < ntiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();
    load_tile<D>(sQ, qg, p.sq.sr, q0, p.Lq);
    load_tile<D, true>(sQs, qg, p.sq.sr, q0, p.Lq, p.qscale);
    load_tile<D>(sDO, dog, p.sdo.sr, q0, p.Lq);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      const long long i = ((long long)b * p.Lq + row) * p.H + h;
      sLse[threadIdx.x] = row < p.Lq ? p.lse[i] : 0.0f;
      sDelta[threadIdx.x] = row < p.Lq ? p.delta[i] : 0.0f;
    }
    __syncthreads();
    rows_times_tile_t<D>(sK + warp * 16 * P::LDH, sQs, sS);    // s2^T
    rows_times_tile_t<D>(sV + warp * 16 * P::LDH, sDO, sDP);   // dp^T
    __syncwarp();
    const int valid = min(BQ, p.Lq - q0);
#pragma unroll 8
    for (int j = 0; j < BQ / 2; ++j) {
      const int c = 2 * j + par;
      float pv = 0.0f, ds = 0.0f;
      if (c < valid) {
        pv = exp2f(sS[r * P::LDS + c] - sLse[c]);
        ds = pv * (sDP[r * P::LDS + c] - sDelta[c]);
      }
      sP[r * P::LDP + c] = __float2bfloat16(pv);
      sDS[r * P::LDP + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate<D>(dv, sP, sDO);                                // dv += p^T.do
    accumulate<D>(dk, sDS, sQ);                                // dk += ds^T.q
  }
  const long long out0 = (long long)b * p.Lk * p.H * D + (long long)h * D;
  finish<D>(dk, p.scale, sS, p.dk + out0, k0 + warp * 16, p.Lk, p.H, lane);
  finish<D>(dv, 1.0f, sS, p.dv + out0, k0 + warp * 16, p.Lk, p.H, lane);
}

template <int D, bool DKV>
int launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  const size_t smem = DKV ? BwdPlan<D>::dkv_total : BwdPlan<D>::dq_total;
  auto kernel = DKV ? fa_bwd_dkv_kernel<D> : fa_bwd_dq_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = DKV ? p.Lk : p.Lq;
  const dim3 grid((rows + 63) / 64, p.H, B);
  kernel<<<grid, WARPS * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool DKV>
int dispatch(const BwdParams& p, int B, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_bwd<128, DKV>(p, B, s);
  if (D == 96) return launch_bwd<96, DKV>(p, B, s);
  if (D == 64) return launch_bwd<64, DKV>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, o, do read through their strides; lse2 read, delta written;
// dq written. Strides in elements: (batch, row, head) for q, k, v, o, do.
int fa_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* delta, void* dq, int B, int Lq, int Lk, int H, int D,
              long long q_sb, long long q_sr, long long q_sh, long long k_sb, long long k_sr,
              long long k_sh, long long v_sb, long long v_sr, long long v_sh, long long o_sb,
              long long o_sr, long long o_sh, long long do_sb, long long do_sr, long long do_sh,
              float qscale, float scale, void* stream) {
  BwdParams p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.Lq = Lq; p.Lk = Lk; p.H = H;
  p.sq = {q_sb, q_sr, q_sh};
  p.sk = {k_sb, k_sr, k_sh};
  p.sv = {v_sb, v_sr, v_sh};
  p.so = {o_sb, o_sr, o_sh};
  p.sdo = {do_sb, do_sr, do_sh};
  p.qscale = qscale;
  p.scale = scale;
  return dispatch<false>(p, B, D, stream);
}

// q, k, v, do read through their strides; lse2 and the delta of fa_bwd_dq
// read; dk and dv written.
int fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int Lq, int Lk, int H, int D,
               long long q_sb, long long q_sr, long long q_sh, long long k_sb, long long k_sr,
               long long k_sh, long long v_sb, long long v_sr, long long v_sh, long long do_sb,
               long long do_sr, long long do_sh, float qscale, float scale, void* stream) {
  BwdParams p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.Lq = Lq; p.Lk = Lk; p.H = H;
  p.sq = {q_sb, q_sr, q_sh};
  p.sk = {k_sb, k_sr, k_sh};
  p.sv = {v_sb, v_sr, v_sh};
  p.sdo = {do_sb, do_sr, do_sh};
  p.qscale = qscale;
  p.scale = scale;
  return dispatch<true>(p, B, D, stream);
}

}  // extern "C"
