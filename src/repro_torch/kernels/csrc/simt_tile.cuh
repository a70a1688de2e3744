// What the fp32 kernels on the CUDA cores share (flash_attention.cu,
// flash_attention_bwd.cu, ssd_scan.cu): element loads and stores in fp32 or
// bf16, cp.async copies, and the staged tiles and register-blocked products
// of the flash kernels.
//
// An SM reads 128 bytes a clock from shared memory against 128 fp32 FMAs, so
// these kernels are bound by shared-memory reads unless each float read
// feeds several FMAs.  A warp's float4 load costs 2 of the memory's cycles
// when each quarter-warp asks for one or two addresses and 4 when it asks for
// more (scripts/smem_load_bench.py), so every product here reads float4s and
// lets each quarter-warp share one operand (a broadcast) while its 8 lanes
// read 8 distinct 16-byte chunks of the other.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace simt {

constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// copies of 16 or 4 bytes that zero-fill the destination when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// whether a (B, S, H, D) fp32 tensor's rows can be copied 16 bytes at a time:
// its base and the strides of its dimensions longer than 1 16-byte aligned
inline bool rows_aligned(const void* ptr, long long sb, long long ss, long long sh, int B, int S, int H) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (B <= 1 || sb % 4 == 0) && (S <= 1 || ss % 4 == 0) &&
         (H <= 1 || sh % 4 == 0);
}

// ---------------------------------------------------------------- flash tiles
// The flash kernels' tiles: BR rows of one head (64, or 32 at D > 128 so that
// the double-buffered tiles fit a block's 227 KB), staged as fp32 rows of D.
template <int D>
struct Rows {
  static constexpr int BR = D > 128 ? 32 : 64;  // rows of every q and kv tile
  static constexpr int SPAD = BR + 4;            // row of a P or dS tile (16-byte aligned)
  static constexpr int TILE = BR * D;            // floats of a staged tile
};

// float index of column c of row r in a staged tile: 16-byte chunk c / 4 of
// the row swizzled by r & 7, so that float4 reads of eight rows at one
// chunk, and of eight chunks of one row, fall in distinct banks
template <int D>
__device__ __forceinline__ int sw(int r, int c) {
  return r * D + ((((c >> 2) ^ (r & 7))) << 2) + (c & 3);
}

// Rows [r0, r0 + BR) of one (batch, head) slice into a staged tile, zero
// past row n: fp32 by cp.async (the caller commits the group) ...
template <int D, int BR = Rows<D>::BR>
__device__ __forceinline__ void stage(float* dst, const float* src, long long row_stride, int r0, int n, int vec) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < BR * C4; idx += THREADS) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const bool ok = r0 + r < n;
    const float* s = ok ? src + (r0 + r) * row_stride + c : src;  // not read when !ok
    float* d = dst + sw<D>(r, c);
    if (vec) {
      cp_async16(d, s, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(d + e, ok ? s + e : src, ok);
    }
  }
}
// ... bf16 converted by the threads
template <int D, int BR = Rows<D>::BR>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src, long long row_stride, int r0, int n,
                                      int) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < BR * C4; idx += THREADS) {
    const int r = idx / C4, c = (idx % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) {
      const __nv_bfloat16* s = src + (r0 + r) * row_stride + c;
      x = make_float4(ld(s), ld(s + 1), ld(s + 2), ld(s + 3));
    }
    *reinterpret_cast<float4*>(dst + sw<D>(r, c)) = x;
  }
}

// The accumulator products: NT threads hold a BR x D output (dK, dV, dQ or
// the forward's O; BR_ rows where it is not a flash tile's), each RQ quads
// of rows (4 (ra + NRG q) + r) x NCOL columns (VW floats at (ca + NCG v)
// VW); a warp spans 4 row groups and 8 column groups, a quarter-warp 8
// column groups of one row group.
template <int D, int NT, int RQ, int BR_ = Rows<D>::BR>
struct Acc {
  static constexpr int BR = BR_;
  static constexpr int NRG = BR / (4 * RQ);  // row groups
  static constexpr int NCG = NT / NRG;       // column groups
  static constexpr int NCOL = D / NCG;       // head-dim columns a thread holds
  static constexpr int VW = NCOL % 4 == 0 ? 4 : NCOL % 2 == 0 ? 2 : 1;  // floats a read (2 at NCOL 2 or 6)
  static constexpr int NV = NCOL / VW;
  static constexpr int RW = NRG / 4;  // warps across the row groups
  static_assert(NRG % 4 == 0 && NCG * NCOL == D && NV * VW == NCOL && NT / 32 / RW * 8 == NCG, "accumulator tiling");
  using Tile = float[4 * RQ][NCOL];

  // this thread's row group and column group; w = its warp among the NT threads
  __device__ __forceinline__ static int ra(int w, int lane) { return (lane >> 3) + 4 * (w % RW); }
  __device__ __forceinline__ static int ca(int w, int lane) { return (lane & 7) + 8 * (w / RW); }
  __device__ __forceinline__ static int row(int ra, int q, int r) { return 4 * (ra + NRG * q) + r; }
  __device__ __forceinline__ static int col(int ca, int v) { return (ca + NCG * v) * VW; }
};

template <int VW>
__device__ __forceinline__ void load_vec(float (&x)[VW], const float* src);
template <>
__device__ __forceinline__ void load_vec<4>(float (&x)[4], const float* src) {
  const float4 f = *reinterpret_cast<const float4*>(src);
  x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
}
template <>
__device__ __forceinline__ void load_vec<2>(float (&x)[2], const float* src) {
  const float2 f = *reinterpret_cast<const float2*>(src);
  x[0] = f.x, x[1] = f.y;
}

// acc[.][.] += sum_k A[k][this thread's rows] B[k][its columns], over the
// BR rows k of A (a P or dS tile, [k][row] at SPAD = BR + 4) and of B (a
// staged tile)
template <int D, int NT, int RQ, int BR_ = Rows<D>::BR>
__device__ __forceinline__ void accumulate(const float* A, const float* B, typename Acc<D, NT, RQ, BR_>::Tile& acc,
                                           int ra, int ca) {
  using G = Acc<D, NT, RQ, BR_>;
  constexpr int SPAD = BR_ + 4;
  // in runs of 8 rows k, where row k & 7 = u of the staged tile swizzles by u
  const float* ap = A + G::row(ra, 0, 0);
  int c4[G::NV];  // this thread's column vectors, as chunk and offset in it
#pragma unroll
  for (int v = 0; v < G::NV; ++v) c4[v] = G::col(ca, v) >> 2;
  const int e0 = G::col(ca, 0) & 3;
#pragma unroll 1
  for (int k = 0; k < G::BR; k += 8, ap += 8 * SPAD) {
    const float* bp = B + k * D + e0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float av[4 * RQ];
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const float4 f = *reinterpret_cast<const float4*>(ap + u * SPAD + 4 * G::NRG * q);
        av[4 * q] = f.x, av[4 * q + 1] = f.y, av[4 * q + 2] = f.z, av[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int v = 0; v < G::NV; ++v) {
        float bv[G::VW];
        load_vec<G::VW>(bv, bp + u * D + ((c4[v] ^ u) << 2));
#pragma unroll
        for (int r = 0; r < 4 * RQ; ++r)
#pragma unroll
          for (int e = 0; e < G::VW; ++e) acc[r][v * G::VW + e] = fmaf(av[r], bv[e], acc[r][v * G::VW + e]);
      }
    }
  }
}

// this thread's rows of a (.., S, .., D) output whose row i starts at out +
// i * row_stride, from row0, times mul; rows at or past n are not written
template <typename T, int D, int NT, int RQ, int BR_ = Rows<D>::BR>
__device__ __forceinline__ void store_acc(T* out, long long row_stride, int row0, int n,
                                          const typename Acc<D, NT, RQ, BR_>::Tile& acc, float mul, int ra, int ca) {
  using G = Acc<D, NT, RQ, BR_>;
#pragma unroll
  for (int q = 0; q < RQ; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + G::row(ra, q, r);
      if (row >= n) continue;
#pragma unroll
      for (int v = 0; v < G::NV; ++v)
#pragma unroll
        for (int e = 0; e < G::VW; ++e)
          st(out + row * row_stride + G::col(ca, v) + e, acc[4 * q + r][v * G::VW + e] * mul);
    }
}

template <int D, int NT, int RQ, int BR_ = Rows<D>::BR>
__device__ __forceinline__ void zero(typename Acc<D, NT, RQ, BR_>::Tile& acc) {
#pragma unroll
  for (int r = 0; r < 4 * RQ; ++r)
#pragma unroll
    for (int c = 0; c < Acc<D, NT, RQ, BR_>::NCOL; ++c) acc[r][c] = 0.f;
}

}  // namespace simt
