// Flash attention backward for Hopper (sm_90a) in bf16: every product on the
// tensor cores (wgmma), the q, k, v and dO tiles brought in by TMA.  Plain C
// interface.
//
// Replaces the gradient that XLA takes of repro/kernels/ops.py::_xla_flash,
// the blocked online-softmax form the JAX package trains through off the
// TPU (the Pallas kernel _flash_kernel has no backward), for bf16 at every
// head dim (32, 64, 128 and 256): dense training's type and widths, gemma-7b's
// and paligemma-3b's 256 among them; and at MLA's (q/k 192, v 128)
// (deepseek-v2: 128 + 64 rope columns of q and k, 128 of v), MoE/MLA
// training's.  Same function as flash_attention_bwd.cu,
// which keeps fp32 (TF32 would miss the fp32 tolerance): the gradients of
// softmax(q k^T * scale) v with respect to q, k and v, per query head, kv
// head h / group (GQA and MQA: dK and dV summed over the group), causal
// (Sq == Sk) or not, with or without a prefix-LM prefix (causal only: every
// row also sees the first prefix_len keys).
//
// Layout: q (B, Sq, Hq, DQK), k (B, Sk, Hkv, DQK), v (B, Sk, Hkv, DV), o and
// dO (B, Sq, Hq, DV) read through their strides (the head dim contiguous; q,
// k, v and dO with base and strides 16-byte aligned, as TMA needs: the
// wrapper checks); lse (B, Hq, Sq) fp32 as the forward kernels write it
// (natural log, +inf for a row that sees no key); dq (B, Sq, Hq, DQK), dk
// (B, Sk, Hkv, DQK) and dv (B, Sk, Hkv, DV) written contiguous; scratch of 2
// (B, Hq, Sq_pad) fp32 rows, Sq_pad = Sq rounded up to 64.  (DQK, DV) in
// (32, 32), (64, 64), (128, 128), (256, 256) and (192, 128).
//
// Design: the FlashAttention-2 backward in three launches, so that no block
// adds into another's output (no atomics: every run gives the same result):
//   1. flash_bwd_prep: D_i = rowsum(dO_i * O_i), one warp a row (the SIMT
//      backward's flash_bwd_delta), which also writes lse * log2(e); both
//      padded to Sq_pad with D_i = 0 and lse = +inf, so that a q tile's 64
//      values are one aligned 256-byte bulk copy and padded rows get P = 0;
//   2. flash_bwd_dkdv_wgmma: one block per (kv head, 64-row kv tile,
//      batch) loads its K and V tile once by TMA, then streams (Q, lse) and
//      (dO, D_i) tiles through a two-stage TMA ring on mbarriers, over the
//      GQA group's q heads and the q tiles from the causal diagonal on (from
//      the first, for a kv tile that holds prefix keys: every q row sees
//      those).  Per
//      q tile, on the fp32 accumulator fragments in registers:
//        S^T = K Q^T          ss, K and Q both K-major over D;
//        P^T = exp2(S^T scale log2e - lse log2e), lse by column; the causal
//                             diagonal masked by row and column, padded q
//                             columns by lse = +inf;
//        dV += P^T dO         rs: P^T's fragment is, pair for pair, the A
//                             fragment, dO read transposed (MN-major);
//                             issued before dP^T is formed, so P's bf16
//                             fragment dies early;
//        dP^T = V dO^T        ss;
//        dS^T = P^T (dP^T - D_i), D_i by column;
//        dK += dS^T Q         rs, Q read transposed;
//      dK takes the scale once at the end;
//   3. flash_bwd_dq_wgmma: one block per (q head, 64-row q tile, batch)
//      loads Q and dO once and streams K and V through a two-stage ring up
//      to the diagonal (or the prefix's end, if further): S = Q K^T and dP =
//      dO V^T (ss, issued together), P
//      and dS on the fragment with lse and D_i per row, the ragged kv edge
//      and the diagonal masked (TMA zero-fills K rows past Sk, and a zero
//      score would give P > 0), dQ += dS K (rs, K read transposed).
//
// Head dim 256 (Split<256>): a block runs two consumer warpgroups, and each
// owns one half of D of the block's outputs (dK and dV, or dQ): 64 x 128
// accumulators, 128 registers a thread in the dK/dV kernel as at D = 128,
// where one warpgroup holding all of D would need 256.  Both halves need the
// whole S^T and dP^T (sums over all of D), and each warpgroup computes both
// from the shared tiles itself, rather than one computing S^T and the other
// dP^T and trading P and dS through shared memory: no exchange buffer, no
// barrier between the two inside a tile, and each keeps the D <= 128
// kernel's register layout, at 1.33x the tensor work of one warpgroup
// holding all of D (S and dP twice; dV and dK, with their second bf16 term,
// split).  The dQ kernel takes the same split: one warpgroup would hold a
// 128-register dQ plus S and dP, and a ~198 KB block leaves one warpgroup an
// SM.  Shared memory at D = 256: dkdv_smem 198,696 and dq_smem 197,672 bytes.
//
// MLA's (192, 128) (Split<192, 128>).  Q and K tiles are 192 columns (three
// 64-column chunks, S^T = K Q^T in 12 k-steps), V, O and dO 128 (dP^T = V
// dO^T in 8).  One warpgroup holding the 64 x 192 dK and the 64 x 128 dV
// accumulators would need 160 registers a thread for them alone, beside
// S^T, dP^T and the bf16 terms of P and dS: it would spill.  Split<256>'s
// halves of D do not divide 192 (three 64-column blocks), so the dK/dV block
// runs two warpgroups split by output: warpgroup 0 owns dK (96 registers)
// and computes S^T, dP^T and dS^T; warpgroup 1 owns dV (64 registers) and
// computes S^T and P^T only.  Both compute S^T from the shared tiles, as at
// D = 256, so nothing is traded through shared memory; warpgroup 0 carries
// the longer chain (S^T in 12 k-steps, dP^T in 8, dK in 24 rs products with
// dS's two terms) against warpgroup 1's S^T and dV (16).  The dQ block keeps
// one warpgroup: its 64 x 192 dQ is 96 registers beside S and dP.  Shared
// memory: dkdv_smem 124,968 and dq_smem 123,944 bytes, one block an SM.
//
// Numerics.  P and dS enter their products as bf16: P as P_TERMS terms and
// dS as DS_TERMS (one term = bf16(x), two = hi + bf16(x - hi), ~16 bits),
// chosen by scripts/flash_bwd_rounding.py's counts of gradient entries
// outside chip_smoke.py's tolerance on every full-width layer's real inputs
// (PERF.md §6).  S, dP and every sum are fp32.
//
// What bounds it: five products of 2 Sq Sk per head (halved when causal),
// three over DQK (S, dQ, dK) and two over DV (dP, dV), against q, k, v, o,
// dO read and dq, dk, dv written once; at training's S = 2048, D = 128 the
// products bound it.  The kernels run seven (S and dP
// in both), plus one for each second bf16 term.  A warpgroup keeps its
// products in sequence (no producer warp), so a block's time is its chain of
// tiles; shared memory is ~98 KB a dK/dV block at D = 128, so two blocks can
// share an SM, and ~198 KB at D = 256, one block of two warpgroups.

#include <math.h>

#include "flash_tile.cuh"

namespace {

using namespace flash;

constexpr int BR = ROWS;   // rows of every q and kv tile
constexpr int STAGES = 2;  // ring depth
constexpr int WG_THREADS = 128;
constexpr int PREP_THREADS = 256;
constexpr int P_TERMS = 2;   // bf16 terms of P in dV += P^T dO
constexpr int DS_TERMS = 2;  // bf16 terms of dS in dK += dS^T Q and dQ += dS K
constexpr int ROW_BYTES = BR * 4;  // one q tile's lse or D_i
constexpr float LOG2E = 1.4426950408889634f;

// Consumer warpgroups of a dK/dV block (Split<DQK, DV>) and of a dQ block
// (Split<DQK, DV, true>).  Equal widths: one up to D = 128; two at D = 256,
// each owning half of D's output columns of dK and dV, or of dQ (its
// accumulators alone would otherwise take 256 registers a thread), both
// running the score products S and dP over the whole of D.  (192, 128): a
// dK/dV block of two warpgroups split by output (BY_OUTPUT: warpgroup 0 owns
// dK, warpgroup 1 dV), a dQ block of one.  NBW: the NB-column accumulator
// blocks a warpgroup holds.
template <int DQK, int DV, bool DQ = false>
struct Split {
  static constexpr bool BY_OUTPUT = !DQ && DQK != DV;
  static constexpr int WG = DQK > 128 && (DQK == DV || BY_OUTPUT) ? 2 : 1;
  static constexpr int THREADS = WG * WG_THREADS;
  static constexpr int NBW = BY_OUTPUT ? Tile<DQK>::NOB : Tile<DQK>::NOB / WG;
  static_assert(Tile<DQK>::NB == Tile<DV>::NB, "one output block width");
  static_assert(BY_OUTPUT ? WG == 2 && Tile<DV>::NOB <= NBW : Tile<DQK>::NOB % WG == 0,
                "whole output blocks per warpgroup");
};
template <int D, int NBW>
using Acc = float[NBW][Tile<D>::NB / 2];  // a warpgroup's 64-row share of a dK, dV or dQ tile

// K, V, the (Q, dO) ring, each stage's lse and D_i rows, the barriers
template <int DQK, int DV>
constexpr size_t dkdv_smem() {
  return 1024 + size_t(1 + STAGES) * (Tile<DQK>::TILE_BYTES + Tile<DV>::TILE_BYTES) + STAGES * 2 * ROW_BYTES +
         8 * (1 + 2 * STAGES);
}
// Q, dO, the K/V ring, the barriers
template <int DQK, int DV>
constexpr size_t dq_smem() {
  return 1024 + size_t(1 + STAGES) * (Tile<DQK>::TILE_BYTES + Tile<DV>::TILE_BYTES) + 8 * (1 + 2 * STAGES);
}

struct Params {
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Sq)
  float* lse2;       // (B, Hq, Sq_pad): lse * log2(e), +inf past Sq
  float* delta;      // (B, Hq, Sq_pad): D_i, 0 past Sq
  void* dq;          // (B, Sq, Hq, DQK) contiguous
  void* dk;          // (B, Sk, Hkv, DQK) contiguous
  void* dv;          // (B, Sk, Hkv, DV) contiguous
  int B, Sq, Sk, Hq, Hkv, Sq_pad;
  long long o_sb, o_ss, o_sh;  // strides in elements
  long long d_sb, d_ss, d_sh;
  float scale, scale_log2;
  int causal;
  int prefix;  // causal: keys [0, prefix) are visible to every row
};

// D_i = rowsum(dO_i * O_i) over the DV columns of o and dO, and lse_i
// log2(e), for every (batch, head, row < Sq_pad), one warp a row.
template <int DV>
__global__ void __launch_bounds__(PREP_THREADS) flash_bwd_prep(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (PREP_THREADS / 32) + warp;  // (b * Hq + h) * Sq_pad + i
  if (row >= (long long)p.B * p.Hq * p.Sq_pad) return;                      // the whole warp leaves
  const int i = int(row % p.Sq_pad);
  const long long bh = row / p.Sq_pad;
  if (i >= p.Sq) {
    if (lane == 0) {
      p.delta[row] = 0.f;
      p.lse2[row] = INFINITY;
    }
    return;
  }
  const int h = int(bh % p.Hq), b = int(bh / p.Hq);
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o) + b * p.o_sb + i * p.o_ss + h * p.o_sh;
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(p.dout) + b * p.d_sb + i * p.d_ss + h * p.d_sh;
  float acc = 0.f;
  for (int d = lane; d < DV; d += 32) acc = fmaf(__bfloat162float(o[d]), __bfloat162float(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    p.delta[row] = acc;
    p.lse2[row] = p.lse[bh * p.Sq + i] * LOG2E;  // +inf stays +inf
  }
}

template <int N, int M>
__device__ __forceinline__ void zero(float (&a)[N][M]) {
#pragma unroll
  for (int nb = 0; nb < N; ++nb)
#pragma unroll
    for (int i = 0; i < M; ++i) a[nb][i] = 0.f;
}

template <int N, int M>
__device__ __forceinline__ void pin_all(float (&a)[N][M]) {
#pragma unroll
  for (int nb = 0; nb < N; ++nb) pin(a[nb]);
}

// acc[64 x 64] = A B^T over the head dim, both 64 x D tiles K-major
template <int D>
__device__ __forceinline__ void issue_scores(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  pin(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(acc, desc_kmajor<D>(a, kk), desc_kmajor<D>(b, kk));
}

// acc[0, NBLK) [64 x NB each] += X[64 x 64] T[64 x NBLK NB], X as TERMS bf16
// A fragments, T the output blocks [nb0, nb0 + NBLK) of a 64 x D tile read
// transposed (MN-major); blocks of acc past NBLK are left as they are
template <int D, int NBLK, int TERMS, int NACC>
__device__ __forceinline__ void accumulate(float (&acc)[NACC][Tile<D>::NB / 2], const uint32_t (&hi)[16],
                                           const uint32_t (&lo)[16], uint32_t tile, int nb0) {
  using T = Tile<D>;
  static_assert(NBLK <= NACC, "accumulator blocks");
  pin_all(acc);
  wg_fence();
#pragma unroll
  for (int nb = 0; nb < NBLK; ++nb)
#pragma unroll
    for (int j = 0; j < BR / 16; ++j) {
      const uint64_t db = desc_mnmajor<D>(tile, nb0 + nb, j);
      wgmma_rs<T::NB>(acc[nb], hi + 4 * j, db);
      if constexpr (TERMS == 2) wgmma_rs<T::NB>(acc[nb], lo + 4 * j, db);
    }
  wg_commit();
  wg_wait0();
  pin_all(acc);
}

// P (P^T) from the raw scores S (S^T) on the fragment in place, in base 2:
// exp2(s scale log2(e) - lse log2(e)); lse2 holds the q tile's 64 values of
// lse log2(e) (+inf on padded rows, which gives 0), read by fragment column
// (the dK/dV kernel's q columns)
__device__ __forceinline__ void p_from_scores_by_column(float (&st)[32], const float* lse2, float scale_log2,
                                                        int cq) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + (i >> 2) * 8 + cq);
    st[i] = exp2f(st[i] * scale_log2 - l.x);
    st[i + 1] = exp2f(st[i + 1] * scale_log2 - l.y);
  }
}

// dS^T = P^T (dP^T - D_i) on the fragment, in dP^T's place, D_i by column
__device__ __forceinline__ void ds_by_column(float (&dp)[32], const float (&st)[32], const float* dl, int cq) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const float2 d = *reinterpret_cast<const float2*>(dl + (i >> 2) * 8 + cq);
    dp[i] = st[i] * (dp[i] - d.x);
    dp[i + 1] = st[i + 1] * (dp[i + 1] - d.y);
  }
}

// dK and dV of one 64-row kv tile.  Fragment rows are kv rows, columns q rows.
template <int DQK, int DV>
__global__ void __launch_bounds__(Split<DQK, DV>::THREADS, 1) flash_bwd_dkdv_wgmma(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo, const Params p) {
  using TQ = Tile<DQK>;  // Q and K tiles, dK
  using TV = Tile<DV>;   // V and dO tiles, dV
  using W = Split<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms need 1024-byte alignment
  const uint32_t sK = base, sV = sK + TQ::TILE_BYTES;
  const uint32_t sQ = sV + TV::TILE_BYTES;              // STAGES tiles
  const uint32_t sdO = sQ + STAGES * TQ::TILE_BYTES;    // STAGES tiles
  const uint32_t sRow = sdO + STAGES * TV::TILE_BYTES;  // per stage: lse log2(e), then D_i
  const uint32_t bar_kv = sRow + STAGES * 2 * ROW_BYTES;
  const uint32_t bar_q = bar_kv + 8;          // + 8 s: Q and lse of stage s
  const uint32_t bar_do = bar_q + 8 * STAGES;  // + 8 s: dO and D_i of stage s
  const float* rows = reinterpret_cast<const float*>(smem_raw + (sRow - raw));

  constexpr int NBW = W::NBW;
  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, warp = (tid >> 5) & 3, lane = tid & 31;  // warp within its warpgroup
  const int hk = blockIdx.x;
  const int k0 = blockIdx.y * BR;  // causal: the first kv tiles see the most q tiles and start first
  const int b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  // causal (Sq == Sk): q rows below k0 see nothing of this tile, unless it holds prefix keys
  const int q_begin = p.causal && k0 >= p.prefix ? k0 : 0;
  const int nq = q_begin < p.Sq ? (p.Sq - q_begin + BR - 1) / BR : 0;
  const int n_it = G * nq;  // (q head of the group, q tile) pairs, head-major

  // thread 0: bring q tile `it` of the walk into stage s
  auto issue = [&](int it, int s) {
    const int h = hk * G + it / nq, q0 = q_begin + (it % nq) * BR;
    const size_t off = (size_t(b) * p.Hq + h) * p.Sq_pad + q0;
    mbar_expect_tx(bar_q + 8 * s, TQ::TILE_BYTES + ROW_BYTES);
    tma_tile<DQK>(sQ + s * TQ::TILE_BYTES, &tq, bar_q + 8 * s, q0, h, b);
    bulk_load(sRow + s * 2 * ROW_BYTES, p.lse2 + off, ROW_BYTES, bar_q + 8 * s);
    mbar_expect_tx(bar_do + 8 * s, TV::TILE_BYTES + ROW_BYTES);
    tma_tile<DV>(sdO + s * TV::TILE_BYTES, &tdo, bar_do + 8 * s, q0, h, b);
    bulk_load(sRow + s * 2 * ROW_BYTES + ROW_BYTES, p.delta + off, ROW_BYTES, bar_do + 8 * s);
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_q + 8 * s, 1);
      mbar_init(bar_do + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_it > 0) {
    mbar_expect_tx(bar_kv, TQ::TILE_BYTES + TV::TILE_BYTES);
    tma_tile<DQK>(sK, &tk, bar_kv, k0, hk, b);
    tma_tile<DV>(sV, &tv, bar_kv, k0, hk, b);
    for (int s = 0; s < STAGES && s < n_it; ++s) issue(s, s);
  }

  const int r0 = k0 + warp * 16 + (lane >> 2);  // this thread's kv rows: r0 and r0 + 8
  const int cq = (lane & 3) * 2;                // its q column pair within each 8-column group

  // Equal widths: this warpgroup's output blocks [wg NBW, (wg + 1) NBW) of dK
  // and of dV.  By output: dk holds the output this warpgroup owns (dK for
  // warpgroup 0, dV for 1), and dv is never touched.
  Acc<DQK, NBW> dk;
  [[maybe_unused]] Acc<DQK, NBW> dv;
  zero(dk);
  if constexpr (!W::BY_OUTPUT) zero(dv);

  if (n_it > 0) mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int q0 = q_begin + (it % nq) * BR;
    const uint32_t tQ = sQ + s * TQ::TILE_BYTES, tdO = sdO + s * TV::TILE_BYTES;
    const float* lse2 = rows + s * 2 * BR;
    const float* dl = lse2 + BR;

    // S^T = K Q^T
    float st[32];
    mbar_wait(bar_q + 8 * s, phase);
    issue_scores<DQK>(st, sK, tQ);
    wg_commit();
    wg_wait0();
    pin(st);

    // P^T on the fragment; only q tiles that reach above the diagonal need the
    // causal mask, and only where the kv tile reaches past the prefix
    p_from_scores_by_column(st, lse2, p.scale_log2, cq);
    if (p.causal && q0 < k0 + BR && k0 + BR > p.prefix) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = (i >> 2) * 8 + cq + (i & 1);
        const int kv = r0 + ((i >> 1) & 1) * 8;
        if (q0 + c < kv && kv >= p.prefix) st[i] = 0.f;
      }
    }

    if constexpr (W::BY_OUTPUT) {
      mbar_wait(bar_do + 8 * s, phase);
      if (wg == 1) {
        // dV += P^T dO
        uint32_t pa[16], pb[16];
        to_bf16_a<P_TERMS>(st, pa, pb);
        pin(pa);
        if constexpr (P_TERMS == 2) pin(pb);
        accumulate<DV, TV::NOB, P_TERMS>(dk, pa, pb, tdO, 0);
      } else {
        // dP^T = V dO^T, dS^T = P^T (dP^T - D_i) in its place, dK += dS^T Q
        float dp[32];
        issue_scores<DV>(dp, sV, tdO);
        wg_commit();
        wg_wait0();
        pin(dp);
        ds_by_column(dp, st, dl, cq);
        uint32_t sa[16], sb[16];
        to_bf16_a<DS_TERMS>(dp, sa, sb);
        pin(sa);
        if constexpr (DS_TERMS == 2) pin(sb);
        accumulate<DQK, TQ::NOB, DS_TERMS>(dk, sa, sb, tQ, 0);
      }
    } else {
      uint32_t pa[16], pb[16];
      to_bf16_a<P_TERMS>(st, pa, pb);

      // dV += P^T dO
      mbar_wait(bar_do + 8 * s, phase);
      pin(pa);
      if constexpr (P_TERMS == 2) pin(pb);
      accumulate<DV, NBW, P_TERMS>(dv, pa, pb, tdO, wg * NBW);

      // dP^T = V dO^T, then dS^T = P^T (dP^T - D_i) in its place
      float dp[32];
      issue_scores<DV>(dp, sV, tdO);
      wg_commit();
      wg_wait0();
      pin(dp);
      ds_by_column(dp, st, dl, cq);
      uint32_t sa[16], sb[16];
      to_bf16_a<DS_TERMS>(dp, sa, sb);

      // dK += dS^T Q
      pin(sa);
      if constexpr (DS_TERMS == 2) pin(sb);
      accumulate<DQK, NBW, DS_TERMS>(dk, sa, sb, tQ, wg * NBW);
    }

    // every warp is done with stage s: refill it with the tile STAGES ahead
    __syncthreads();
    if (tid == 0 && it + STAGES < n_it) issue(it + STAGES, s);
  }

  const float one[2] = {1.f, 1.f}, scale[2] = {p.scale, p.scale};
  const size_t row = size_t(b) * p.Sk * p.Hkv + hk;  // kv row r of the outputs at + r Hkv
  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.dk) + row * DQK;
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.dv) + row * DV;
  if constexpr (W::BY_OUTPUT) {
    if (wg == 0)
      store_rows<DQK, TQ::NOB>(dk_out, (long long)p.Hkv * DQK, k0, p.Sk, dk, scale);
    else
      store_rows<DV, TV::NOB>(dv_out, (long long)p.Hkv * DV, k0, p.Sk, dk, one);
  } else {
    const int c0 = wg * NBW * TQ::NB;  // this warpgroup's first column
    store_rows<DQK, NBW>(dk_out + c0, (long long)p.Hkv * DQK, k0, p.Sk, dk, scale);
    store_rows<DV, NBW>(dv_out + c0, (long long)p.Hkv * DV, k0, p.Sk, dv, one);
  }
}

// dQ of one 64-row q tile.  Fragment rows are q rows, columns kv rows.
template <int DQK, int DV>
__global__ void __launch_bounds__(Split<DQK, DV, true>::THREADS, 1) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo, const Params p) {
  using TQ = Tile<DQK>;  // Q and K tiles, dQ
  using TV = Tile<DV>;   // V and dO tiles
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = sQ + TQ::TILE_BYTES;
  const uint32_t sK = sdO + TV::TILE_BYTES;          // STAGES tiles
  const uint32_t sV = sK + STAGES * TQ::TILE_BYTES;  // STAGES tiles
  const uint32_t bar_q = sV + STAGES * TV::TILE_BYTES;
  const uint32_t bar_k = bar_q + 8;           // + 8 s
  const uint32_t bar_v = bar_k + 8 * STAGES;  // + 8 s

  constexpr int NBW = Split<DQK, DV, true>::NBW;
  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, warp = (tid >> 5) & 3, lane = tid & 31;  // warp within its warpgroup
  const int h = blockIdx.x;
  const int q0 = (p.Sq_pad / BR - 1 - int(blockIdx.y)) * BR;  // causal: the last q tiles see the most kv tiles
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  // causal: to the diagonal, or to the end of the prefix where that lies further
  const int k_end = p.causal ? max(min(p.Sk, q0 + BR), min(p.prefix, p.Sk)) : p.Sk;
  const int nkv = (k_end + BR - 1) / BR;  // 0 when Sk == 0: dQ = 0

  const int r0 = q0 + warp * 16 + (lane >> 2);  // this thread's q rows: r0 and r0 + 8
  const int cq = (lane & 3) * 2;
  const size_t bh = size_t(b) * p.Hq + h;
  float lse2[2], dl[2];  // rows past Sq read the padding: +inf and 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = p.lse2[bh * p.Sq_pad + r0 + 8 * r];
    dl[r] = p.delta[bh * p.Sq_pad + r0 + 8 * r];
  }

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int it, int s) {
    mbar_expect_tx(bar_k + 8 * s, TQ::TILE_BYTES);
    tma_tile<DQK>(sK + s * TQ::TILE_BYTES, &tk, bar_k + 8 * s, it * BR, hk, b);
    mbar_expect_tx(bar_v + 8 * s, TV::TILE_BYTES);
    tma_tile<DV>(sV + s * TV::TILE_BYTES, &tv, bar_v + 8 * s, it * BR, hk, b);
  };
  if (tid == 0 && nkv > 0) {
    mbar_expect_tx(bar_q, TQ::TILE_BYTES + TV::TILE_BYTES);
    tma_tile<DQK>(sQ, &tq, bar_q, q0, h, b);
    tma_tile<DV>(sdO, &tdo, bar_q, q0, h, b);
    for (int s = 0; s < STAGES && s < nkv; ++s) issue(s, s);
  }

  Acc<DQK, NBW> dq;  // this warpgroup's output blocks [wg NBW, (wg + 1) NBW)
  zero(dq);

  if (nkv > 0) mbar_wait(bar_q, 0);
  for (int it = 0; it < nkv; ++it) {
    const int s = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int k0 = it * BR;
    const uint32_t tK = sK + s * TQ::TILE_BYTES, tV = sV + s * TV::TILE_BYTES;

    // S = Q K^T and dP = dO V^T in one group
    float sc[32], dp[32];
    mbar_wait(bar_k + 8 * s, phase);
    issue_scores<DQK>(sc, sQ, tK);
    mbar_wait(bar_v + 8 * s, phase);
    issue_scores<DV>(dp, sdO, tV);
    wg_commit();
    wg_wait0();
    pin(sc);
    pin(dp);

    // P, then dS = P (dP - D_i), on the fragment; the ragged kv edge and the
    // causal diagonal (past the prefix) only in the last tiles
    const bool edge = k0 + BR > p.Sk || (p.causal && k0 + BR - 1 > q0 && k0 + BR > p.prefix);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int col = k0 + (i >> 2) * 8 + cq + (i & 1);
      float pv = exp2f(sc[i] * p.scale_log2 - lse2[r]);
      if (edge && (col >= p.Sk || (p.causal && col > r0 + 8 * r && col >= p.prefix))) pv = 0.f;
      dp[i] = pv * (dp[i] - dl[r]);
    }
    uint32_t sa[16], sb[16];
    to_bf16_a<DS_TERMS>(dp, sa, sb);

    // dQ += dS K
    pin(sa);
    if constexpr (DS_TERMS == 2) pin(sb);
    accumulate<DQK, NBW, DS_TERMS>(dq, sa, sb, tK, wg * NBW);

    __syncthreads();
    if (tid == 0 && it + STAGES < nkv) issue(it + STAGES, s);
  }

  const float scale[2] = {p.scale, p.scale};
  const size_t out = (size_t(b) * p.Sq * p.Hq + h) * DQK + wg * NBW * TQ::NB;  // row r at + r Hq DQK
  store_rows<DQK, NBW>(static_cast<__nv_bfloat16*>(p.dq) + out, (long long)p.Hq * DQK, q0, p.Sq, dq, scale);
}

// ---------------------------------------------------------------- host side
template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const void* dout, const Params& p, const long long* st,
           cudaStream_t stream) {
  using TQ = Tile<DQK>;
  using TV = Tile<DV>;
  // a map over a tensor with no rows is never read (and cannot be encoded)
  CUtensorMap tq{}, tk{}, tv{}, tdo{};
  int err = 0;
  if (p.Sq > 0) {
    err = make_map(&tq, q, DQK, p.Sq, p.Hq, p.B, st[1], st[2], st[0], TQ::CW, BR, TQ::SW);
    if (err == 0) err = make_map(&tdo, dout, DV, p.Sq, p.Hq, p.B, st[13], st[14], st[12], TV::CW, BR, TV::SW);
  }
  if (err == 0 && p.Sk > 0) {
    err = make_map(&tk, k, DQK, p.Sk, p.Hkv, p.B, st[4], st[5], st[3], TQ::CW, BR, TQ::SW);
    if (err == 0) err = make_map(&tv, v, DV, p.Sk, p.Hkv, p.B, st[7], st[8], st[6], TV::CW, BR, TV::SW);
  }
  if (err != 0) return err;
  constexpr size_t SMEM_KV = dkdv_smem<DQK, DV>(), SMEM_Q = dq_smem<DQK, DV>();
  static_assert(SMEM_KV <= 232448 && SMEM_Q <= 232448, "shared memory of one block");
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(SMEM_KV));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_Q));
  if (e != cudaSuccess) return int(e);
  const long long rows = (long long)p.B * p.Hq * p.Sq_pad;
  if (rows > 0) {
    const int per_block = PREP_THREADS / 32;
    flash_bwd_prep<DV><<<unsigned((rows + per_block - 1) / per_block), PREP_THREADS, 0, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (p.Sk > 0) {  // with Sq == 0 the kernel writes dK = dV = 0
    flash_bwd_dkdv_wgmma<DQK, DV><<<dim3(p.Hkv, (p.Sk + BR - 1) / BR, p.B), Split<DQK, DV>::THREADS, SMEM_KV,
                                    stream>>>(tq, tk, tv, tdo, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (p.Sq > 0) {  // with Sk == 0 the kernel writes dQ = 0
    flash_bwd_dq_wgmma<DQK, DV><<<dim3(p.Hq, p.Sq_pad / BR, p.B), Split<DQK, DV, true>::THREADS, SMEM_Q, stream>>>(
        tq, tk, tv, tdo, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
}

}  // namespace

// bf16 only.  D is q's and k's head dim, Dv v's, o's and dO's.  Strides in
// elements, (batch, seq, head) for q, k, v, o and dO in that order.  scratch
// holds 2 B Hq Sq_pad floats (Sq_pad = Sq rounded up to 64) and is 256-byte
// aligned.  prefix_len > 0 (causal only, else invalid) keeps keys [0,
// prefix_len) visible to every row.  Launches three kernels on the stream.
// Returns 0, a cudaError_t (> 0), or a negated CUresult of the tensor-map
// encoding (< 0); repro_flash_bwd_wgmma_error_string names it.
extern "C" int repro_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    void* dq, void* dk, void* dv, void* scratch,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, int Dv,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long d_sb, long long d_ss, long long d_sh,
    float scale, int causal, int prefix_len, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (causal && Sq != Sk) || prefix_len < 0 || (prefix_len > 0 && !causal))
    return int(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0) return 0;
  const int Sq_pad = (Sq + BR - 1) / BR * BR;
  float* lse2 = static_cast<float*>(scratch);
  const Params p{o, dout, static_cast<const float*>(lse), lse2, lse2 + size_t(B) * Hq * Sq_pad, dq, dk, dv,
                 B, Sq, Sk, Hq, Hkv, Sq_pad, o_sb, o_ss, o_sh, d_sb, d_ss, d_sh,
                 scale, scale * LOG2E, causal, prefix_len};
  const long long st[15] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                            o_sb, o_ss, o_sh, d_sb, d_ss, d_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == Dv) {
    switch (D) {
      case 32: return launch<32, 32>(q, k, v, dout, p, st, s);
      case 64: return launch<64, 64>(q, k, v, dout, p, st, s);
      case 128: return launch<128, 128>(q, k, v, dout, p, st, s);
      case 256: return launch<256, 256>(q, k, v, dout, p, st, s);
    }
  }
  if (D == 192 && Dv == 128) return launch<192, 128>(q, k, v, dout, p, st, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* repro_flash_bwd_wgmma_error_string(int err) { return hopper::error_string(err); }
