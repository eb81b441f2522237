// Pieces of the one-key-block forward (flash_attention.cu), the port's last
// mma.sync kernel: the tile geometry, the WMMA fragment types and the
// global -> shared tile loads. (The TMA/wgmma kernels share
// sm90_common.cuh instead.)
//
// Every kernel runs WARPS warps per block; a warp owns 16 rows of the
// block's 64-row tile, and the tile it sweeps over is 64 rows too. Shared
// tiles are padded by 16 bytes a row, so every 16-row sub-tile starts on a
// 32-byte boundary, as wmma loads and stores require.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

namespace fa {

using namespace nvcuda;

constexpr int WARPS = 4;           // warps per block
constexpr int BQ = 16 * WARPS;     // rows of the block's own tile (16 per warp)
constexpr int BK = 64;             // rows of each swept tile
constexpr int PAD_H = 8;           // bf16 row padding: 16 bytes
constexpr int PAD_F = 4;           // f32 row padding: 16 bytes

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 64 rows x D bf16 from global (row stride sr elements) into a shared tile
// with row stride D + PAD_H; rows at or past `limit` load as zeros. With
// SCALED, every value is multiplied by `scale` in f32 and rounded back to
// bf16 (the softmax scale * log2(e) folded into q).
template <int D, bool SCALED = false>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long sr, int row0, int limit,
                                          float scale = 1.0f) {
  constexpr int CH = D / 8;        // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += WARPS * 32) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * sr + c * 8);
    if (SCALED) {
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        h2[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (D + PAD_H) + c * 8) = val;
  }
}

// One warp's 16 x D f32 result, staged in shared memory with row stride
// D + PAD_F, rounded to bf16 and stored to rows row0 + r < limit of a
// contiguous (rows, H, D) output at head offset `head`. Lanes 2r and 2r+1
// store row r, 8 columns at a time.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float* stage, int row0,
                                           int limit, long long row_stride, int lane) {
  const int r = lane >> 1, par = lane & 1;
  if (row0 + r >= limit) return;
  __nv_bfloat16* og = out + (long long)(row0 + r) * row_stride;
  const float* srow = stage + r * (D + PAD_F);
  for (int c = par * 8; c < D; c += 16) {
    uint4 v;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) o2[j] = __floats2bfloat162_rn(srow[c + 2 * j], srow[c + 2 * j + 1]);
    *reinterpret_cast<uint4*>(og + c) = v;
  }
}

}  // namespace fa
