// Hopper (sm_90a) building blocks for the port's kernels: mbarriers, TMA
// tile loads through 4-D tensor maps, and warpgroup matrix multiplies
// (wgmma) on 64 x 64 bf16 tiles kept in shared memory with the 128-byte
// swizzle. Header only; included by csrc/*.cu, which build.py hashes
// together with every csrc/*.cuh.
//
// Shared-memory tiles. A tile is 64 rows of 64 bf16 (128 bytes a row), as
// one TMA box of a tensor map made with CU_TENSOR_MAP_SWIZZLE_128B: the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8). Tiles start at a
// 1024-byte boundary, so the swizzle is a function of the address alone and
// a wgmma descriptor may start anywhere inside a tile.
//
// wgmma operands (m64n64k16 and m64n128k16, bf16 in, float32 accumulators):
// - K-major: the reduction index runs along a tile row (Q or K rows against
//   their head dim). k-step kk starts 32 * kk bytes into the tile; 8-row
//   groups lie 1024 bytes apart (SBO); LBO is unused.
// - MN-major (transpose bit set, 16-bit types only): the reduction index
//   runs down the tile's rows (P^T dO takes dO's rows as depth). k-step kk
//   starts 2048 * kk bytes in (16 rows); 8-row groups lie 1024 bytes apart
//   (SBO); LBO, the step between 64-column atoms, is unused at width 64.
// The accumulator of one warpgroup is 64 x 64 float32, 32 registers a
// thread, held as float[8][4]: warp w of the group owns rows 16w..16w+15;
// c[j][e] is row 16w + g + 8 * (e >> 1), column 8j + 2t + (e & 1), with
// g = lane / 4, t = lane % 4 (the mma.sync m16n8 fragment, 8 times across).
// The register A operand of a k-step uses the mma.sync m16n8k16 A layout,
// so an accumulator rounded to bf16 is the A operand of the next product
// (see acc_to_a in flash_attention.cu) without leaving registers.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kTileBytes = 64 * 128;   // one 64-row tile of 64 bf16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async (TMA) proxy; follow
// with __syncthreads()
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the completion of the phase with parity `parity`. A wait that
// lasts ~2^34 cycles (seconds) can only be a fault (a lost copy, a wrong
// byte count): trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// Named barriers (ids 1..15; 0 is __syncthreads'): `threads` (a multiple of
// 32) must arrive for a phase to complete; sync waits for it, arrive does not.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// TMA

// One box of a 4-D tensor map into shared memory at `dst`; its bytes (the
// whole box, zero-filled past the tensor's edge) complete on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// wgmma

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// k-step kk of a tile read K-major / MN-major (see the top of this file)
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + 32 * kk, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + 2048 * kk, 0, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it (from its launch to its wait).
template <int kGroups>
__device__ __forceinline__ void fence_acc(float (&d)[kGroups][4]) {
#pragma unroll
  for (int j = 0; j < kGroups; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

#define HOPPER_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_D64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define HOPPER_ROW_OPS(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define HOPPER_D32_OPS(d)                                                 \
  HOPPER_ROW_OPS(d, 0), HOPPER_ROW_OPS(d, 1), HOPPER_ROW_OPS(d, 2),        \
      HOPPER_ROW_OPS(d, 3), HOPPER_ROW_OPS(d, 4), HOPPER_ROW_OPS(d, 5),    \
      HOPPER_ROW_OPS(d, 6), HOPPER_ROW_OPS(d, 7)
#define HOPPER_D64_OPS(d)                                                 \
  HOPPER_D32_OPS(d), HOPPER_ROW_OPS(d, 8), HOPPER_ROW_OPS(d, 9),           \
      HOPPER_ROW_OPS(d, 10), HOPPER_ROW_OPS(d, 11), HOPPER_ROW_OPS(d, 12), \
      HOPPER_ROW_OPS(d, 13), HOPPER_ROW_OPS(d, 14), HOPPER_ROW_OPS(d, 15)

// d (+)= A * B, m64n64k16; A and B from shared memory, both K-major.
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D32_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A * B, m64n64k16; A from registers (four bf16x2 a thread, the
// mma.sync A layout), B from shared memory MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  const int accumulate = 1;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= A * B, m64n128k16; A and B from shared memory, both K-major (B's
// 128 rows are two adjacent tiles). d[j][e] is row 16w + g + 8 * (e >> 1),
// column 8j + 2t + (e & 1), j < 16.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D64_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_ROW_OPS
#undef HOPPER_D32_OPS
#undef HOPPER_D64_OPS

// 2^x on the SFU (ex2.approx, flushes denormals)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is taken
// through the runtime's entry-point query, so the library links against
// nothing but cudart.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a strided bf16 [B, N, H, 64] view (element strides sb,
// sn, sh; head dim contiguous): dims (64, H, N, B) innermost first, byte
// strides of h, n and b, box (64, 1, 64, 1) = 64 rows of one (b, h), 128-byte
// swizzle; rows past N read as zeros. Returns a cudaError_t.
inline int encode_bnhd_map(CUtensorMap* map, const void* base, int B, int N,
                           int H, long long sb, long long sn, long long sh) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {64, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sn * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
