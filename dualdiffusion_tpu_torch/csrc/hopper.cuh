// Hopper (sm_90a) building blocks shared by the port's wgmma kernels (K1,
// K4 and K7): shared-memory addresses, mbarriers, TMA tensor loads, wgmma
// shared-memory descriptors and instructions, ldmatrix, and the host's
// tensor-map encoder (cuTensorMapEncodeTiled, looked up at run time, so the
// library needs no -lcuda).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace dd {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

// box (c0, c1, c2, c3) of a 4-D tensor map -> shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// box (c0, ..., c4) of a 5-D tensor map -> shared memory, completing on
// `bar`; coordinates may be negative or past the end: TMA fills those
// elements with zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

// ---- ldmatrix --------------------------------------------------------------

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and r[i] receives matrix i in the mma fragment layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// byte offset of 16-byte chunk `chunk` of 64-byte row `row` in a tile that
// TMA wrote with the 64-byte swizzle (chunk bits 4-5 XOR address bits 7-8;
// the tile's base 512-byte aligned)
__device__ __forceinline__ uint32_t swz64(int row, int chunk) {
  return static_cast<uint32_t>(row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4));
}

// ---- wgmma -----------------------------------------------------------------

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, and the swizzle (128 or 64 bytes)
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(SW == 128 ? 1 : 2) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads and writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define DD_ACC8(i)                                                                     \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (64 x 64, fp32) (+)= A (64 x 16, shared) * B (64 x 16, shared), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DD_ACC8(0), DD_ACC8(8), DD_ACC8(16), DD_ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, fp32) (+)= A (64 x 16, shared) * B (128 x 16, shared), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : DD_ACC8(0), DD_ACC8(8), DD_ACC8(16), DD_ACC8(24),
        DD_ACC8(32), DD_ACC8(40), DD_ACC8(48), DD_ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, fp32, NR = N / 2 registers a thread) += A (64 x 16, registers)
// * B (16 x N, shared, MN-major: the transpose bit), N = 32, 64, ..., 256.
// The A fragment is mma.sync's m16n8k16 A layout for each warp's 16 rows.
template <int NR>
__device__ __forceinline__ void wgmma_rs(float (&d)[NR], const uint32_t (&a)[4], uint64_t db) {
  static_assert(NR % 16 == 0 && NR >= 16 && NR <= 128, "N must be 32, 64, ..., 256");
  if constexpr (NR == 16) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : DD_ACC8(0), DD_ACC8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (NR == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : DD_ACC8(0), DD_ACC8(8), DD_ACC8(16), DD_ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (NR == 48) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : DD_ACC8(0), DD_ACC8(8), DD_ACC8(16), DD_ACC8(24), DD_ACC8(32), DD_ACC8(40)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (NR == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : DD_ACC8(0), DD_ACC8(8), DD_ACC8(16), DD_ACC8(24), DD_ACC8(32), DD_ACC8(40), DD_ACC8(48), DD_ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (NR == 80) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
        : DD_ACC8(0), DD_ACC8(8), DD_ACC8(16), DD_ACC8(24), DD_ACC8(32), DD_ACC8(40), DD_ACC8(48), DD_ACC8(56), DD_ACC8(64), DD_ACC8(72)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (NR == 96) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : DD_ACC8(0), DD_ACC8(8), DD_ACC8(16), DD_ACC8(24), DD_ACC8(32), DD_ACC8(40), DD_ACC8(48), DD_ACC8(56), DD_ACC8(64), DD_ACC8(72), DD_ACC8(80), DD_ACC8(88)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (NR == 112) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %117, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
        "}, {%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n"
        : DD_ACC8(0), DD_ACC8(8), DD_ACC8(16), DD_ACC8(24), DD_ACC8(32), DD_ACC8(40), DD_ACC8(48), DD_ACC8(56), DD_ACC8(64), DD_ACC8(72), DD_ACC8(80), DD_ACC8(88), DD_ACC8(96), DD_ACC8(104)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (NR == 128) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : DD_ACC8(0), DD_ACC8(8), DD_ACC8(16), DD_ACC8(24), DD_ACC8(32), DD_ACC8(40), DD_ACC8(48), DD_ACC8(56), DD_ACC8(64), DD_ACC8(72), DD_ACC8(80), DD_ACC8(88), DD_ACC8(96), DD_ACC8(104), DD_ACC8(112), DD_ACC8(120)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

#undef DD_ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- host: tensor maps -----------------------------------------------------

inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// a bf16 tensor map of `rank` dims (innermost first) with byte strides of
// dims 1.. and boxes of `box`; elements outside the tensor read as zeros
inline bool encode_bf16_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                            const uint64_t* byte_strides, const uint32_t* box, int swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                reinterpret_cast<const cuuint64_t*>(dims),
                reinterpret_cast<const cuuint64_t*>(byte_strides),
                reinterpret_cast<const cuuint32_t*>(box), elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;  // zero fill
}

// encode_bf16_map through a per-thread cache. A map is a function of its
// arguments alone, so a call whose arguments equal an earlier call's (a
// module's weights, a repeated step's activations) reuses that map and
// skips the encoder's host time.
inline bool cached_bf16_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                            const uint64_t* byte_strides, const uint32_t* box, int swizzle) {
  struct Key {
    const void* ptr;
    int64_t rank, swizzle;
    uint64_t dims[5], strides[4], box[5];
  };
  struct Entry {
    CUtensorMap map;
    Key key;
    bool valid;
  };
  constexpr int kEntries = 256;
  static thread_local Entry cache[kEntries];
  Key k = {};
  k.ptr = ptr;
  k.rank = rank;
  k.swizzle = swizzle;
  for (int i = 0; i < rank; ++i) {
    k.dims[i] = dims[i];
    k.box[i] = box[i];
    if (i + 1 < rank) k.strides[i] = byte_strides[i];
  }
  const uint64_t p = reinterpret_cast<uintptr_t>(ptr);
  Entry& e = cache[((p >> 9) ^ (p >> 17) ^ k.dims[0] ^ (k.box[0] << 3)) % kEntries];
  if (e.valid && memcmp(&e.key, &k, sizeof k) == 0) {
    *map = e.map;
    return true;
  }
  e.valid = encode_bf16_map(&e.map, ptr, rank, dims, byte_strides, box, swizzle);
  if (!e.valid) return false;
  e.key = k;
  *map = e.map;
  return true;
}

}  // namespace dd
