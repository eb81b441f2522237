// The PTX layer of the TMA/wgmma attention kernels for NVIDIA Hopper
// (sm_90a), shared by the forwards (flash_attention_sm90.cu,
// flash_attention_onekv.cu) and the backward (flash_attention_bwd.cu):
//
//   * mbarriers, 4-d TMA tile loads into shared memory and tile stores
//     from it;
//   * warpgroup MMA (wgmma): fence / commit / wait, shared-memory matrix
//     descriptors, m64nNk16 bf16 products with f32 accumulators -- both
//     operands from shared memory (wgmma_ss, N 64 and 128, both K-major), or
//     A from registers and B from shared memory as a transposed (MN-major)
//     operand (wgmma_rs, N 64, 96 and 128) or a K-major one (wgmma_rs_k64);
//     ldmatrix of register A fragments;
//   * ex2.approx and bf16 packing of the accumulator layout;
//   * the host-side tensor-map encoding over (D, and head, row, batch
//     ordered by stride), so strided views load without a copy, and the
//     coordinate-slot lookup (pick) that undoes that ordering on the card.
//
// Shared tiles are panels of PW columns (Panels<D>): PW 64 under the
// 128-byte swizzle at D 64 and 128, PW 32 under the 64-byte swizzle at D 96
// (192-byte rows are not a multiple of 128). A tile of R rows stores panel
// p at byte p * R * SWZ; every panel starts on a 1024-byte boundary.
//
// An entry point returns 0, a cudaError_t, or FA_ENCODE_ERROR + the CUresult
// of a tensor map that failed to encode; fa_error_string
// (flash_attention_sm90.cu) names all of them.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace sm90 {

constexpr int FA_ENCODE_ERROR = 1 << 20;

// The panel geometry of a D-wide bf16 tile.
template <int D>
struct Panels {
  static constexpr int PW = D % 64 == 0 ? 64 : 32;   // columns per panel
  static constexpr int NP = D / PW;                  // panels per tile
  static constexpr int SWZ = PW * 2;                 // bytes per panel row = swizzle span
  static constexpr uint64_t LAYOUT = SWZ == 128 ? 1 : 2;   // wgmma: B128 or B64
};

// ---------------------------------------------------------------------------
// mbarriers and TMA
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

// One box of shared memory into a 4-d tensor map (rows past the extent are
// not written), as one bulk group; tma_store_wait returns once the copies
// this thread started have read their shared memory.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of accumulator registers above the
// wgmma wait (the wgmma asm names them as outputs from its launch on).
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

// d[N/2] (+)= A(smem, 64 x 16, K-major) * B(smem, N x 16, K-major)^T
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FA_REGS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_F8(d, 0), FA_F8(d, 8), FA_F8(d, 16), FA_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
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

// d[32] (+)= A(registers, 64 x 16 bf16) * B(smem, 64 x 16, K-major)^T
__device__ __forceinline__ void wgmma_rs_k64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FA_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : FA_F8(d, 0), FA_F8(d, 8), FA_F8(d, 16), FA_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l addressing row l % 8
// of matrix l / 8: with matrices (rows 0-7, cols 0-7), (8-15, 0-7),
// (0-7, 8-15), (8-15, 8-15) of a warp's 16 x 16 tile, the register A
// fragment of one k16 step of a wgmma.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
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

// The accumulator of an m64nNk16 product over 16-column chunks kk, rounded
// to bf16, is the register A fragment of the kk-th k16 step of the next
// product, element for element.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(acc[8 * kk], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// The coordinate in map slot `slot` (1-3), given where head, row and batch
// landed.
__device__ __forceinline__ int pick(int slot, int4 pos, int h, int row, int b) {
  return pos.x == slot ? h : (pos.y == slot ? row : b);
}

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
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
// others' extent (any stride would do; TMA wants a valid one). Rows past the
// extent load as zeros.
inline int encode(CUtensorMap* map, int4* pos, const void* ptr, int D, int pw, int rows,
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

}  // namespace sm90
