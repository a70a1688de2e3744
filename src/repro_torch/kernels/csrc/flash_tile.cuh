// The (B, S, H, D) bf16 tiles that the tensor-core flash kernels
// (flash_attention_wgmma.cu, flash_attention_bwd_wgmma.cu) bring in by TMA
// and feed to wgmma: 64 rows of one head, D columns, 128-byte swizzled
// (64-byte for D = 32, whose rows are 64 bytes).  The tensor maps and the
// wgmma descriptors name the same swizzle, and every tile starts on a
// 1024-byte boundary so the swizzle phase is the same in both.  A tile of
// D > 64 is D / 64 chunks of 64 columns, each one TMA box.

#pragma once

#include "hopper.cuh"

namespace flash {

using namespace hopper;

constexpr int ROWS = 64;  // rows of every tile: one wgmma M, one score tile's N

template <int D>
struct Tile {
  static constexpr int SW = D * 2 >= 128 ? 128 : D * 2;  // swizzle span = bytes of one chunk row
  static constexpr int CW = SW / 2;                        // bf16 columns per chunk (one TMA box)
  static constexpr int NCHUNK = D / CW;
  static constexpr int CHUNK_BYTES = ROWS * SW;            // 64 rows of one chunk
  static constexpr int TILE_BYTES = NCHUNK * CHUNK_BYTES;  // a 64 x D bf16 tile
  static constexpr int NB = D >= 64 ? 64 : D;              // output columns per rs wgmma
  static constexpr int NOB = D / NB;                       // rs output blocks across D
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;    // descriptor layout: 1 = 128B, 2 = 64B swizzle
};

// One 64-row tile: NCHUNK boxes of (CW columns x 64 rows), completing on
// `bar`.  The caller has armed the barrier with the tile's bytes (TMA counts
// the whole box, zero-filled rows included).
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int row, int head,
                                         int batch) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < T::NCHUNK; ++c) tma_load(dst + c * T::CHUNK_BYTES, map, bar, c * T::CW, row, head, batch);
}

// A tile as a K-major operand (K = head dim), k-step kk (16 columns): rows
// at SW bytes, 8-row groups at 8 SW; within a swizzled row the k-step moves
// the start by 32 bytes (the hardware applies the swizzle to the address,
// so the tile's 1024-byte alignment keeps it in phase).
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  using T = Tile<D>;
  const uint32_t addr = tile + (kk * 16 / T::CW) * T::CHUNK_BYTES + (kk * 16 % T::CW) * 2;
  return make_desc(addr, 16, 8 * T::SW, T::LAYOUT);
}

// A tile as an MN-major B operand (N = head dim, K = the tile's rows), output
// block nb (NB columns, one swizzle atom wide) and k-step j (16 rows).  The
// 8-row K groups lie 8 SW apart; N fits one atom, so the leading offset is
// never stepped (given the same value, so either reading of the two fields
// names the K-group stride).
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int nb, int j) {
  using T = Tile<D>;
  const uint32_t addr = tile + nb * (T::NB / T::CW) * T::CHUNK_BYTES + j * 16 * T::SW;
  return make_desc(addr, 8 * T::SW, 8 * T::SW, T::LAYOUT);
}

// d[64 x NB] += A[64 x 16] B[16 x NB], A from registers, B MN-major
template <int NB>
__device__ __forceinline__ void wgmma_rs(float (&d)[NB / 2], const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t* a, uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t* a, uint64_t db) {
  wgmma_rs_n32(d, a, db);
}

// A 64 x 64 fp32 accumulator fragment as the bf16 A operand of the next
// product: pair i/2 of the fragment is register i/2 of the A fragments, k-step
// j taking registers 4j .. 4j+3.  With TERMS = 2 the value is carried as hi =
// bf16(x) in `hi` plus lo = bf16(x - hi) in `lo` (~16 bits); with 1, `lo` is
// not written.
template <int TERMS>
__device__ __forceinline__ void to_bf16_a(const float (&x)[32], uint32_t (&hi)[16], uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[i], x[i + 1]);
    hi[i >> 1] = bits(h);
    if (TERMS == 2) {
      const float2 hf = __bfloat1622float2(h);
      lo[i >> 1] = bits(__floats2bfloat162_rn(x[i] - hf.x, x[i + 1] - hf.y));
    }
  }
}

// Write the first NBLK blocks of NB columns of a 64-row fp32 accumulator of
// NACC blocks (a whole 64 x D tile by default; a warpgroup's share of D when
// warpgroups split it), times `mul`, as bf16 rows [row0, row0 + 64) of a
// (.., S, .., D) tensor whose row r starts at out + r * row_stride (out
// already at the first column); rows at or past n are not written.  The
// fragment rows are those of the calling warp within its warpgroup.
template <int D, int NBLK = Tile<D>::NOB, int NACC = NBLK>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long row_stride, int row0, int n,
                                           const float (&acc)[NACC][Tile<D>::NB / 2], const float (&mul)[2]) {
  using T = Tile<D>;
  static_assert(NBLK <= NACC, "accumulator blocks");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = row0 + warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* orow = out + row * row_stride;
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb)
#pragma unroll
      for (int g = 0; g < T::NB / 8; ++g) {
        const int i = g * 4 + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(orow + nb * T::NB + g * 8 + cq) =
            __floats2bfloat162_rn(acc[nb][i] * mul[r], acc[nb][i + 1] * mul[r]);
      }
  }
}

}  // namespace flash
