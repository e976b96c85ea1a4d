// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// mbarriers, TMA tile loads and tensor maps, wgmma shared-memory descriptors,
// wgmma with both operands in shared memory or A in registers, the wgmma
// fence / commit / wait discipline, setmaxnreg, and the mma.sync / ldmatrix
// / cp.async instructions of the warp-level kernels (bf16 / fp16, and TF32
// with the split of an fp32 operand into two TF32 parts). Inline PTX only; the
// tensor maps are encoded on the host through cudaGetDriverEntryPoint, so no
// library needs -lcuda.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ------------------------------------------------------------- mbarriers --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` of TMA traffic on the barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Expects `bytes` more of TMA traffic on the barrier without arriving (the
// arrival comes later, with the thread's other stores).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
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

// ------------------------------------------------------------------- TMA --

// A 2-D box of `map` at (inner c0, outer c1) into shared memory at dst; the
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A 4-D box of `map` at (c0, c1, c2, c3), innermost first, into shared
// memory at dst; the completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once (null if absent).
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D map of 16-bit elements: `inner` contiguous elements per row, `outer`
// rows `ld` elements apart, boxes of box_inner x box_outer, 128-byte
// swizzle (box_inner * 2 must be <= 128). Returns a cudaError_t.
inline int encode_map_2d(CUtensorMap* map, const void* base, bool is_half,
                         uint64_t inner, uint64_t outer, uint64_t ld,
                         uint32_t box_inner, uint32_t box_outer) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map,
                  is_half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  2, const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 2-D map of bytes (int8 codes): `inner` contiguous bytes per row, `outer`
// rows `ld` bytes apart (a multiple of 16), boxes of box_inner x box_outer
// bytes (box_inner a multiple of 16, <= 256), no swizzle: a box lands in
// shared memory as box_outer rows of box_inner bytes. Returns a cudaError_t.
inline int encode_map_2d_u8(CUtensorMap* map, const void* base, uint64_t inner,
                            uint64_t outer, uint64_t ld, uint32_t box_inner,
                            uint32_t box_outer) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {ld};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                  dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 4-D map of a contiguous [B, S, H, D] tensor of 16-bit elements, dims
// innermost first (D, H, S, B), boxes of 64 x 1 x 64 x 1 (64 rows s of one
// head h, 64 values of D each: one 128-byte row a row), 128-byte swizzle.
// Reads past D, S or B fill with zeros. D * 2 and the base must be multiples
// of 16 bytes. Returns a cudaError_t.
inline int encode_map_bshd(CUtensorMap* map, const void* base, bool is_half,
                           uint64_t B, uint64_t S, uint64_t H, uint64_t D) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {D, H, S, B};
  const cuuint64_t strides[3] = {D * 2, H * D * 2, S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map,
                  is_half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  4, const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ----------------------------------------------------------------- wgmma --

// Shared-memory matrix descriptor of a 128-byte-swizzled tile (TMA's
// SWIZZLE_128B layout; the tile's 1024-byte atom must be 1024-aligned).
// lbo / sbo in bytes. K-major: lbo unused (16), sbo = 1024 (8 rows of 128
// bytes). MN-major: lbo = the stride between 64-element MN atoms, sbo =
// 1024 (8 k rows of 128 bytes).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  d |= (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
  d |= (uint64_t)1 << 62;  // layout: 128-byte swizzle
  return d;
}

// A 16-bit operand tile 64 deep in k as TMA lays it out with 128-byte
// swizzle: K-major, rows of 64 k values (128 bytes); MN-major, 64-wide MN
// boxes of 64 k rows, SW128_BOX bytes apart.
constexpr uint32_t SW128_BOX = 64 * 64 * 2;

// Shared-memory descriptor of the k-th 16-deep slice of such a tile:
// K-major, the slice is 32 bytes into each 128-byte row; MN-major, 16 rows
// (2048 bytes) further, with the 64-wide MN boxes SW128_BOX bytes apart.
template <int MN_MAJOR>
__device__ __forceinline__ uint64_t slice_desc(const uint8_t* tile, int k) {
  return MN_MAJOR ? sw128_desc(tile + k * 2048, SW128_BOX, 1024)
                  : sw128_desc(tile + k * 32, 16, 1024);
}

// Makes this thread's st.shared writes visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

#define WGMMA_N64_REGS \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}"
#define WGMMA_N64_OUTS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[32] += A (64 x 16) * B (16 x 64), both from shared memory through
// descriptors; TA / TB: 1 where the operand is MN-major (transposed).
template <bool HALF, int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  if constexpr (HALF) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WGMMA_N64_REGS
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : WGMMA_N64_OUTS
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_N64_REGS
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : WGMMA_N64_OUTS
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
}

#define WGMMA_N128_REGS \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}"
#define WGMMA_N128_OUTS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64] += A (64 x 16) * B (16 x 128), both from shared memory through
// descriptors; TA / TB: 1 where the operand is MN-major (transposed).
template <bool HALF, int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  if constexpr (HALF) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " WGMMA_N128_REGS
        ", %64, %65, p, 1, 1, %67, %68;\n}\n"
        : WGMMA_N128_OUTS
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_N128_REGS
        ", %64, %65, p, 1, 1, %67, %68;\n}\n"
        : WGMMA_N128_OUTS
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
}

// Warp specialisation's register split: a warpgroup gives registers back
// (dec) or takes them (inc); every warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

#define WGMMA_N80_REGS \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39" \
  "}"
#define WGMMA_N80_OUTS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])

// d[N / 2] += A (64 x 16 from registers: warp w of the warpgroup holds rows
// 16 w .. 16 w + 15 as mma.sync m16n8k16 holds its A fragment) * B (16 x N
// from shared memory through a descriptor, MN-major: trans-b 1), for N = 64,
// 80 or 128. The operands after the outputs: a[0..3], the descriptor,
// the scale-d flag.
#define WGMMA_RS(SHAPE, REGS, OUTS, A, DESC, FLAG)                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " FLAG ", 0;\n"         \
               "wgmma.mma_async.sync.aligned." SHAPE " " REGS ", {" A "}, " \
               DESC ", p, 1, 1, 1;\n}\n"                                  \
               : OUTS                                                    \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <bool HALF, int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert(N == 64 || N == 80 || N == 128, "wgmma_rs_mn's N");
  if constexpr (N == 64) {
    if constexpr (HALF)
      WGMMA_RS("m64n64k16.f32.f16.f16", WGMMA_N64_REGS, WGMMA_N64_OUTS,
               "%32, %33, %34, %35", "%36", "%37");
    else
      WGMMA_RS("m64n64k16.f32.bf16.bf16", WGMMA_N64_REGS, WGMMA_N64_OUTS,
               "%32, %33, %34, %35", "%36", "%37");
  } else if constexpr (N == 80) {
    if constexpr (HALF)
      WGMMA_RS("m64n80k16.f32.f16.f16", WGMMA_N80_REGS, WGMMA_N80_OUTS,
               "%40, %41, %42, %43", "%44", "%45");
    else
      WGMMA_RS("m64n80k16.f32.bf16.bf16", WGMMA_N80_REGS, WGMMA_N80_OUTS,
               "%40, %41, %42, %43", "%44", "%45");
  } else {
    if constexpr (HALF)
      WGMMA_RS("m64n128k16.f32.f16.f16", WGMMA_N128_REGS, WGMMA_N128_OUTS,
               "%64, %65, %66, %67", "%68", "%69");
    else
      WGMMA_RS("m64n128k16.f32.bf16.bf16", WGMMA_N128_REGS, WGMMA_N128_OUTS,
               "%64, %65, %66, %67", "%68", "%69");
  }
}
#undef WGMMA_RS

// -------------------------------------------- warp-level tensor-core MMA --

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d[4] += a[4] (16 x 16, row) * b[2] (16 x 8, col), fp32 accumulate.
template <bool HALF>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  if constexpr (HALF) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// a rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero): half the dropped range added to the bit pattern,
// then the low 13 mantissa bits cleared. Two integer instructions, where
// the cvt costs a handful on sm_90.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// Split fp32: a = hi + lo + O(2^-22 |a|), hi = tf32(a), lo = tf32(a - hi)
// (a - hi is exact in fp32).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d[4] += a[4] (16 x 8, row) * b[2] (8 x 8, col), TF32 operands, fp32
// accumulate.
__device__ __forceinline__ void mma_1688_tf32(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
