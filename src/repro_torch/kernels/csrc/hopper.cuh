// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (flash_attention_wgmma.cu, flash_attention_bwd_wgmma.cu, ssd_scan_wgmma.cu):
// mbarriers, TMA tile and bulk loads and their tensor maps, wgmma
// descriptors and the m64n64k16 bf16 products.
// Each kernel source includes this header and is compiled on its own; the
// device functions are inline and the host ones static.  (No unnamed
// namespace here: nvcc's generated stubs name the including file's unnamed
// namespace, and a second one nested in this namespace makes that ambiguous.)

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda's encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier and TMA
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// A copy that never lands (a tensor map the hardware refuses) traps after
// ~2^28 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 1-d copy of `bytes` bytes (a multiple of 16; both addresses 16-byte
// aligned) from device memory, completing on `bar` like a tile.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared memory written by the threads (the generic proxy) and then read by
// wgmma or TMA (the async proxy) needs this fence before the barrier that
// orders the two.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout (1 = 128B, 2 = 64B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous product
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define F16(a, i) F4(a, i), F4(a, i + 4), F4(a, i + 8), F4(a, i + 12)

// d[64 x 64] += A[64 x 16] B[16 x 64], A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F16
#undef F4

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<const uint32_t*>(&v); }

// ---------------------------------------------------------------- tensor maps (host)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which these libraries do not link
// (they link only the CUDA runtime), so take its entry point from the
// runtime once.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

constexpr int ERR_NO_ENCODE = -1000;  // libcuda offers no cuTensorMapEncodeTiled

// A 4-d map over a (B, S, H, D) bf16 tensor: dims innermost first, strides in
// bytes of dims 1..3, box = one chunk of cw columns x `rows` rows of one
// head.  Rows past S read as zeros.  Returns 0, a cudaError_t (> 0) or the
// negated CUresult.  The encoding is a driver call and needs the device's
// context current on this thread; a host thread on which the runtime has not
// run yet (autograd's device thread, when a flash backward is the first node
// it runs) has none, so set the current device, which makes its primary
// context current.
static int make_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B, long long ss, long long sh,
                    long long sb, int cw, int rows, int swizzle_bytes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 2, cuuint64_t(sh) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {cuuint32_t(cw), cuuint32_t(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -int(r);
}

// 0, a cudaError_t (> 0) or a negated CUresult of the map encoding (< 0), named
static const char* error_string(int err) {
  static char buf[128];
  if (err == ERR_NO_ENCODE) return "libcuda offers no cuTensorMapEncodeTiled";
  if (err < 0) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed with CUresult %d", -err);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace hopper
