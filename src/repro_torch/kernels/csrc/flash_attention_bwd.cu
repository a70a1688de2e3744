// Flash attention backward for Hopper (sm_90a) on the CUDA cores, with a
// plain C interface: the fp32 route.  bf16 runs the tensor-core backward
// (flash_attention_bwd_wgmma.cu) at every head dim; this kernel also takes
// bf16 when asked (route "simt"), so that the two can be timed side by side.
// fp32 stays here because the tensor cores' fp32 input type is TF32, which
// would miss the fp32 tolerance.
//
// Replaces the gradient that XLA takes of repro/kernels/ops.py::_xla_flash,
// the blocked online-softmax form the JAX package trains through off the
// TPU (the Pallas kernel _flash_kernel has no backward).  Same function:
// the gradients of softmax(q k^T * scale) v with respect to q, k and v, per
// query head, kv head h / group (GQA: dK and dV summed over the group),
// causal (Sq == Sk) or not, with or without a prefix-LM prefix (causal only:
// every row also sees the first prefix_len keys).
//
// Layout: q (B, Sq, Hq, DQK), k (B, Sk, Hkv, DQK), v (B, Sk, Hkv, DV), o
// and dO (B, Sq, Hq, DV), all read through their strides (the last dimension
// contiguous; dO arrives from the output projection's gradient and may be
// any view); lse (B, Hq, Sq) fp32 as the forward kernels write it (natural
// log, +inf for a row that sees no key); dq (B, Sq, Hq, DQK), dk (B, Sk,
// Hkv, DQK) and dv (B, Sk, Hkv, DV) written contiguous; delta (B, Hq, Sq)
// fp32 scratch.  fp32 or bf16 in and out (one type for q, k, v, o, dO and
// the gradients), fp32 inside, at (DQK, DV) in (32, 32), (64, 64), (128,
// 128) and (256, 256); fp32 alone at MLA's (192, 128).
//
// Design: the FlashAttention-2 backward, split in three launches so that no
// block adds into another's output (no atomics, the result is the same on
// every run):
//   1. flash_bwd_delta: D_i = rowsum(dO_i * O_i), one warp a row;
//   2. flash_bwd_dkdv: one block per (kv tile, kv head, batch) keeps its K
//      and V tile and the dK, dV accumulators resident and walks the q
//      heads of its group and, for each, the q tiles from the causal
//      diagonal on (from the first, for a kv tile that holds prefix keys):
//      P = exp(S * scale - lse) from the recomputed scores, dV += P^T dO,
//      dP = dO V^T, dS = P (dP - D_i), dK += dS^T Q;
//   3. flash_bwd_dq: one block per (q tile, q head, batch) keeps its Q and
//      dO tile resident and walks the kv tiles up to the diagonal (or the
//      prefix's end, if further): the same P and dS, dQ += dS K.
// dQ and dK take the scale once at the end.  A score is masked by the
// causal diagonal (past the prefix) and the ragged edges of both tiles;
// masked and padded entries give P = 0 and dS = 0, and a row whose lse is +inf has
// exp(s - inf) = 0, so fully masked rows give zero gradients, not nan.
//
// What bounds it: five products of 2 Sq Sk D per head (halved when causal)
// against q, k, v, o, dO read once and dq, dk, dv written once; at
// training's S = 2048, D = 128 the products bound it, and in fp32 on the
// CUDA cores (S and dP are computed twice, once per kernel: seven products)
// the FMA rate would.  An SM reads 128 bytes a clock from shared memory
// against 128 FMAs, so the tiling is built to read as few floats per FMA as
// the 227 KB of shared memory allows:
//   * tiles are 64 rows (32 at D = 256, to fit shared memory), staged as
//     fp32 rows of D with their 16-byte chunks swizzled (chunk c of row r at
//     c ^ (r & 7)), so that float4 reads of eight rows at one chunk, and of
//     eight chunks of one row, fall in distinct banks;
//   * the score products split the block: 128 threads compute S (S^T in the
//     dK/dV kernel), 128 dP, each thread an 8 x 4 micro-tile read as float4s
//     along D (12 float4 reads for 128 FMAs); the raw tiles go to shared
//     memory transposed, and one pass of all threads forms P (exp2, the
//     causal and ragged masks) and dS = P (dP - D_i) in their place;
//   * the accumulators read P or dS as the A operand (one float4 of four
//     rows) and a staged tile as B: in the dK/dV kernel 128 threads hold dV
//     and 128 dK, each an 8 x 8 block (4 float4 reads for 64 FMAs); in the
//     dQ kernel all 256 hold dQ, 4 x 8 each;
//   * the next q tile (dK/dV) or kv tile (dQ) comes in by cp.async, 16 bytes
//     a copy (4 where a base or stride is not 16-byte aligned), into the
//     second of two stages while the current one is computed, so a tile
//     takes three barriers; bf16 inputs are converted on the way in, by the
//     threads, so their loads do not overlap.
// Shared memory at D = 128: 232,448 bytes a dK/dV block (K, V, two stages
// of Q and dO, P, dS, two stages of lse and D_i), all a block may take;
// 231,936 a dQ block.  The staging, the swizzle and the accumulator
// products are simt_tile.cuh's, shared with the fp32 forward.
//
// MLA's (192, 128) separates the two widths, as the fp32 forward does: Q, K,
// S and dP's Q side, dQ and dK run over 192 columns, V, O, dO, dP and dV
// over 128.  Six 64-row tiles of 192- and 128-wide fp32 rows would take 245
// KB, so it takes the 32-row tiles of D = 256: 132,608 bytes a dK/dV block.
// The half of the threads that computes S^T sums over 192 columns while the
// other sums dP^T over 128; dK is held in 8 x 6 register blocks (two-float
// reads) and dV in 8 x 4, and the dQ kernel's 256 threads hold dQ in 4 x 6.
// scripts/flash_simt_parts.py times the kernel with each part taken out.

#include <math.h>

#include <type_traits>

#include "simt_tile.cuh"

namespace {

using namespace simt;

// DQK: the head dim of q and k (S, dQ, dK), DV: that of v, o and dO (dP, dV)
template <int DQK, int DV>
struct Cfg : Rows<DQK> {  // BR, SPAD: the q/k width sets every tile's rows
  using Rows<DQK>::BR;
  using Rows<DQK>::SPAD;
  static constexpr int TQK = BR * DQK, TV = BR * DV;  // floats of a staged Q or K tile, of a V or dO tile
  // dK/dV: K, V, two stages of Q and dO, P, dS, two stages of lse and D_i
  static constexpr size_t SMEM_KV = (size_t(3) * (TQK + TV) + 2 * BR * SPAD + 4 * BR) * sizeof(float);
  // dQ: Q, dO, two stages of K and V, P, dS, lse and D_i
  static constexpr size_t SMEM_Q = (size_t(3) * (TQK + TV) + 2 * BR * SPAD + 2 * BR) * sizeof(float);
  // dQ's row quads a thread: 8 x 4 blocks (4 x 8 at D = 32; 4 x 6 at 192, where two quads would leave a
  // thread 3 columns)
  static constexpr int RQ_DQ = DQK >= 64 && DQK != 192 ? 2 : 1;
  static_assert(DV / 4 >= 8 && SMEM_KV <= 232448, "tiling");
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Sq)
  float* delta;      // (B, Hq, Sq) scratch
  void* dq;          // (B, Sq, Hq, DQK) contiguous
  void* dk;          // (B, Sk, Hkv, DQK) contiguous
  void* dv;          // (B, Sk, Hkv, DV) contiguous
  int B, Sq, Sk, Hq, Hkv;
  long long q_sb, q_ss, q_sh;  // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long d_sb, d_ss, d_sh;
  float scale, scale_log2;
  int causal;
  int prefix;  // causal: keys [0, prefix) are visible to every row
  int vec;     // fp32 q, k, v and dO can be copied 16 bytes at a time
};

// D_i = rowsum(dO_i * O_i) over the DV columns, for every (batch, head,
// row), one warp a row.
template <typename T, int DV>
__global__ void __launch_bounds__(THREADS) flash_bwd_delta(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (THREADS / 32) + warp;  // (b * Hq + h) * Sq + i
  if (row >= (long long)p.B * p.Hq * p.Sq) return;                      // the whole warp leaves
  const int i = int(row % p.Sq);
  const int h = int((row / p.Sq) % p.Hq);
  const int b = int(row / ((long long)p.Sq * p.Hq));
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + i * p.o_ss + h * p.o_sh;
  const T* g = static_cast<const T*>(p.dout) + b * p.d_sb + i * p.d_ss + h * p.d_sh;
  float acc = 0.f;
  for (int d = lane; d < DV; d += 32) acc = fmaf(ld(o + d), ld(g + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// ---------------------------------------------------------------- staging
// lse and D_i of rows [q0, q0 + BR) of one (batch, head) by cp.async; rows
// past Sq read 0 (their scores are masked)
__device__ __forceinline__ void stage_rows(float* sLse, float* sDelta, const Params& p, size_t bh, int q0, int BR) {
  for (int r = threadIdx.x; r < BR; r += THREADS) {
    const bool ok = q0 + r < p.Sq;
    const size_t i = bh * p.Sq + (ok ? q0 + r : 0);
    cp_async4(sLse + r, p.lse + i, ok);
    cp_async4(sDelta + r, p.delta + i, ok);
  }
}

// ---------------------------------------------------------------- products
// The score products split the block in two halves of 128 threads: one
// computes S (or S^T), the other dP (or dP^T), each thread a TI x TJ
// micro-tile (rows rg + 8 i, columns cg + 16 j).  A quarter-warp spans one
// row group and 8 column groups: a float4 that one address serves for the
// whole quarter takes 2 of the shared memory's cycles, one of 8 addresses
// 4, so the 8 rows are the broadcast operand.  s[i][j] = sum_d
// X[rg + 8 i][d] Y[cg + 16 j][d] over the D columns of two BR-row tiles,
// four columns at a time.
template <int BR>
constexpr int TI = BR / 8;  // score micro-tile: TI x TJ of S or of dP a thread
template <int BR>
constexpr int TJ = BR / 16;
template <int D, int BR>
__device__ __forceinline__ void scores(const float* X, const float* Y, float (&s)[TI<BR>][TJ<BR>], int rg, int cg) {
#pragma unroll
  for (int i = 0; i < TI<BR>; ++i)
#pragma unroll
    for (int j = 0; j < TJ<BR>; ++j) s[i][j] = 0.f;
  // rows rg + 8 i all swizzle by rg & 7, rows cg + 16 j by cg & 7: walk D in
  // runs of 8 chunks, where chunk u of a run sits at u ^ (row & 7), so that
  // every load is a run pointer plus a constant
  const float* xr = X + rg * D;
  const float* yr = Y + cg * D;
  const int mx = rg & 7, my = cg & 7;
#pragma unroll 1
  for (int c = 0; c < D; c += 32, xr += 32, yr += 32) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float* xp = xr + ((u ^ mx) << 2);
      const float* yp = yr + ((u ^ my) << 2);
      float4 x[TI<BR>], y[TJ<BR>];
#pragma unroll
      for (int i = 0; i < TI<BR>; ++i) x[i] = *reinterpret_cast<const float4*>(xp + 8 * i * D);
#pragma unroll
      for (int j = 0; j < TJ<BR>; ++j) y[j] = *reinterpret_cast<const float4*>(yp + 16 * j * D);
#pragma unroll
      for (int i = 0; i < TI<BR>; ++i)
#pragma unroll
        for (int j = 0; j < TJ<BR>; ++j)
          s[i][j] = fmaf(x[i].x, y[j].x, fmaf(x[i].y, y[j].y, fmaf(x[i].z, y[j].z, fmaf(x[i].w, y[j].w, s[i][j]))));
    }
  }
}

// P and dS of a BR x BR tile, from the raw S in sP and dP in sdS, in their
// places: P = exp2(S scale log2(e) - lse log2(e)) on entries the causal
// diagonal (past the prefix) and both ragged edges leave visible (0
// elsewhere), dS = P (dP - D_i).  Both tiles are [column][row] at SPAD, four rows at a time; q is the
// column and kv the row (the dK/dV kernel, KV_ROWS) or the other way round
// (the dQ kernel).  lse and dl are the q tile's lse and D_i.
template <int BR, bool KV_ROWS>
__device__ __forceinline__ void form_p_ds(float* sP, float* sdS, const float* lse, const float* dl, int q0, int k0,
                                          const Params& p) {
  constexpr int SPAD = BR + 4, R4 = BR / 4;
  for (int idx = threadIdx.x; idx < BR * R4; idx += THREADS) {
    const int c = idx / R4, r = (idx % R4) * 4;
    float4 sv = *reinterpret_cast<const float4*>(sP + c * SPAD + r);
    float4 dv = *reinterpret_cast<const float4*>(sdS + c * SPAD + r);
    float* s4 = &sv.x;
    float* d4 = &dv.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = KV_ROWS ? c : r + e;  // q within the tile
      const int qr = q0 + qi, kv = KV_ROWS ? k0 + r + e : k0 + c;
      const bool ok = qr < p.Sq && kv < p.Sk && (!p.causal || kv <= qr || kv < p.prefix);
      const float pv = ok ? exp2f(fmaf(s4[e], p.scale_log2, -lse[qi] * LOG2E)) : 0.f;
      s4[e] = pv;
      d4[e] = pv * (d4[e] - dl[qi]);
    }
    *reinterpret_cast<float4*>(sP + c * SPAD + r) = sv;
    *reinterpret_cast<float4*>(sdS + c * SPAD + r) = dv;
  }
}

// dK and dV of one kv tile: a block per (kv tile, kv head, batch).  The
// first half of the threads computes S^T, P^T and then dV; the second dP^T
// and then dK.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv(const Params p) {
  using C = Cfg<DQK, DV>;
  constexpr int BR = C::BR, TQK = C::TQK, TV = C::TV, SPAD = C::SPAD;
  using GK = Acc<DQK, THREADS / 2, 2, BR>;  // dK: the second half
  using GV = Acc<DV, THREADS / 2, 2, BR>;   // dV: the first half
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + TQK;
  float* sQ = sV + TV;            // two stages
  float* sdO = sQ + 2 * TQK;      // two stages
  float* sP = sdO + 2 * TV;       // [q row][kv row]
  float* sdS = sP + BR * SPAD;    // [q row][kv row]: dP^T, then dS^T
  float* sRow = sdS + BR * SPAD;  // per stage: lse, then D_i

  const int half = threadIdx.x / (THREADS / 2), w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int rg = (lane >> 3) + 4 * (w & 1), cg = (lane & 7) + 8 * (w >> 1);  // score micro-tile
  const int ra = GK::ra(w, lane), ca = GK::ca(w, lane);  // accumulator (GV's are the same)
  static_assert(GK::RW == GV::RW, "one accumulator thread layout for dK and dV");
  const int k0 = blockIdx.x * BR;  // causal: the first kv tiles see the most q tiles and start first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G_ = p.Hq / p.Hkv;
  // causal (Sq == Sk): q rows below k0 see nothing of this tile, unless it holds prefix keys
  const int q_begin = p.causal && k0 >= p.prefix ? k0 : 0;
  const int nq = q_begin < p.Sq ? (p.Sq - q_begin + BR - 1) / BR : 0;
  const int n_it = G_ * nq;  // (q head of the group, q tile) pairs, head-major

  // bring q tile `it` of the walk into stage it & 1, as one cp.async group
  auto issue = [&](int it) {
    const int s = it & 1, h = hk * G_ + it / nq, q0 = q_begin + (it % nq) * BR;
    stage<DQK, BR>(sQ + s * TQK, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq, p.vec);
    stage<DV, BR>(sdO + s * TV, static_cast<const T*>(p.dout) + b * p.d_sb + h * p.d_sh, p.d_ss, q0, p.Sq, p.vec);
    stage_rows(sRow + s * 2 * BR, sRow + s * 2 * BR + BR, p, size_t(b) * p.Hq + h, q0, BR);
    cp_commit();
  };
  stage<DQK, BR>(sK, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.Sk, p.vec);
  stage<DV, BR>(sV, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.Sk, p.vec);
  cp_commit();
  if (n_it > 0) issue(0);

  // dV (first half) or dK (second half): at equal widths one accumulator
  // serves both halves; at (192, 128) each half has its own, and holds the
  // other's registers idle
  typename GK::Tile dk;
  [[maybe_unused]] typename GV::Tile dv_own;
  typename GV::Tile& dv = [&]() -> typename GV::Tile& {
    if constexpr (DQK == DV) return dk; else return dv_own;
  }();
  zero<DQK, THREADS / 2, 2, BR>(dk);
  if constexpr (DQK != DV) zero<DV, THREADS / 2, 2, BR>(dv);

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1, q0 = q_begin + (it % nq) * BR;
    cp_wait<0>();
    __syncthreads();  // stage s has landed for every thread, and every read of stage s ^ 1 is done
    if (it + 1 < n_it) issue(it + 1);
    const float* tQ = sQ + s * TQK;
    const float* tdO = sdO + s * TV;
    const float* lse = sRow + s * 2 * BR;

    // S^T = K Q^T or dP^T = V dO^T, rows kv and columns q, stored transposed
    float sc[TI<BR>][TJ<BR>];
    if constexpr (DQK == DV)
      scores<DQK, BR>(half ? sV : sK, half ? tdO : tQ, sc, rg, cg);
    else if (half)
      scores<DV, BR>(sV, tdO, sc, rg, cg);
    else
      scores<DQK, BR>(sK, tQ, sc, rg, cg);
    float* dst = half ? sdS : sP;
#pragma unroll
    for (int i = 0; i < TI<BR>; ++i)
#pragma unroll
      for (int j = 0; j < TJ<BR>; ++j) dst[(cg + 16 * j) * SPAD + rg + 8 * i] = sc[i][j];
    __syncthreads();
    form_p_ds<BR, true>(sP, sdS, lse, lse + BR, q0, k0, p);
    __syncthreads();
    // dV += P^T dO or dK += dS^T Q, reduced over the tile's q rows
    if constexpr (DQK == DV)
      accumulate<DQK, THREADS / 2, 2, BR>(half ? sdS : sP, half ? tQ : tdO, dk, ra, ca);
    else if (half)
      accumulate<DQK, THREADS / 2, 2, BR>(sdS, tQ, dk, ra, ca);
    else
      accumulate<DV, THREADS / 2, 2, BR>(sP, tdO, dv, ra, ca);
  }
  cp_wait<0>();  // with no q tile, nothing waited for K and V

  const size_t row = size_t(b) * p.Sk * p.Hkv + hk;  // kv row r of the outputs at + r Hkv
  if constexpr (DQK == DV) {
    store_acc<T, DQK, THREADS / 2, 2, BR>(static_cast<T*>(half ? p.dk : p.dv) + row * DQK, (long long)p.Hkv * DQK,
                                          k0, p.Sk, dk, half ? p.scale : 1.f, ra, ca);
  } else if (half) {
    store_acc<T, DQK, THREADS / 2, 2, BR>(static_cast<T*>(p.dk) + row * DQK, (long long)p.Hkv * DQK, k0, p.Sk, dk,
                                          p.scale, ra, ca);
  } else {
    store_acc<T, DV, THREADS / 2, 2, BR>(static_cast<T*>(p.dv) + row * DV, (long long)p.Hkv * DV, k0, p.Sk, dv, 1.f,
                                         ra, ca);
  }
}

// dQ of one q tile: a block per (q tile, q head, batch).  The first half of
// the threads computes S and P, the second dP; all of them dQ.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq(const Params p) {
  using C = Cfg<DQK, DV>;
  constexpr int BR = C::BR, TQK = C::TQK, TV = C::TV, SPAD = C::SPAD, RQ = C::RQ_DQ;
  using G = Acc<DQK, THREADS, RQ, BR>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + TQK;
  float* sK = sdO + TV;          // two stages
  float* sV = sK + 2 * TQK;      // two stages
  float* sP = sV + 2 * TV;       // [kv row][q row]
  float* sdS = sP + BR * SPAD;   // [kv row][q row]: dP, then dS
  float* sLse = sdS + BR * SPAD;
  float* sDelta = sLse + BR;

  const int half = threadIdx.x / (THREADS / 2), w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int rg = (lane >> 3) + 4 * (w & 1), cg = (lane & 7) + 8 * (w >> 1);  // score micro-tile
  const int ra = G::ra(threadIdx.x >> 5, lane), ca = G::ca(threadIdx.x >> 5, lane);
  const int n_qtiles = (p.Sq + BR - 1) / BR;
  const int q0 = (n_qtiles - 1 - int(blockIdx.x)) * BR;  // causal: the last q tiles see the most kv tiles
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  // causal: to the diagonal, or to the end of the prefix where that lies further
  const int k_end = p.causal ? max(min(p.Sk, q0 + BR), min(p.prefix, p.Sk)) : p.Sk;
  const int nkv = (k_end + BR - 1) / BR;  // 0 when Sk == 0: dQ = 0
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  auto issue = [&](int it) {
    const int s = it & 1;
    stage<DQK, BR>(sK + s * TQK, k, p.k_ss, it * BR, p.Sk, p.vec);
    stage<DV, BR>(sV + s * TV, v, p.v_ss, it * BR, p.Sk, p.vec);
    cp_commit();
  };
  stage<DQK, BR>(sQ, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq, p.vec);
  stage<DV, BR>(sdO, static_cast<const T*>(p.dout) + b * p.d_sb + h * p.d_sh, p.d_ss, q0, p.Sq, p.vec);
  stage_rows(sLse, sDelta, p, size_t(b) * p.Hq + h, q0, BR);
  cp_commit();
  if (nkv > 0) issue(0);

  typename G::Tile dq;
  zero<DQK, THREADS, RQ, BR>(dq);

  for (int it = 0; it < nkv; ++it) {
    const int s = it & 1, k0 = it * BR;
    cp_wait<0>();
    __syncthreads();  // stage s has landed for every thread, and every read of stage s ^ 1 is done
    if (it + 1 < nkv) issue(it + 1);
    const float* tK = sK + s * TQK;

    // S = Q K^T or dP = dO V^T, rows q and columns kv, stored transposed
    float sc[TI<BR>][TJ<BR>];
    if constexpr (DQK == DV)
      scores<DQK, BR>(half ? sdO : sQ, half ? sV + s * TV : tK, sc, rg, cg);
    else if (half)
      scores<DV, BR>(sdO, sV + s * TV, sc, rg, cg);
    else
      scores<DQK, BR>(sQ, tK, sc, rg, cg);
    float* dst = half ? sdS : sP;
#pragma unroll
    for (int i = 0; i < TI<BR>; ++i)
#pragma unroll
      for (int j = 0; j < TJ<BR>; ++j) dst[(cg + 16 * j) * SPAD + rg + 8 * i] = sc[i][j];
    __syncthreads();
    form_p_ds<BR, false>(sP, sdS, sLse, sDelta, q0, k0, p);
    __syncthreads();
    // dQ += dS K, reduced over the tile's kv rows
    accumulate<DQK, THREADS, RQ, BR>(sdS, tK, dq, ra, ca);
  }
  cp_wait<0>();

  const size_t out = (size_t(b) * p.Sq * p.Hq + h) * DQK;  // row r at + r Hq DQK
  store_acc<T, DQK, THREADS, RQ, BR>(static_cast<T*>(p.dq) + out, (long long)p.Hq * DQK, q0, p.Sq, dq, p.scale, ra,
                                     ca);
}

template <typename T, int DQK, int DV>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(C::SMEM_KV));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(C::SMEM_Q));
  if (e != cudaSuccess) return int(e);
  const long long rows = (long long)p.B * p.Hq * p.Sq;
  if (rows > 0) {
    flash_bwd_delta<T, DV><<<unsigned((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (p.Sk > 0) {  // with Sq == 0 the kernel writes dK = dV = 0
    flash_bwd_dkdv<T, DQK, DV><<<dim3((p.Sk + C::BR - 1) / C::BR, p.Hkv, p.B), THREADS, C::SMEM_KV, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (p.Sq > 0) {  // with Sk == 0 the kernel writes dQ = 0
    flash_bwd_dq<T, DQK, DV><<<dim3((p.Sq + C::BR - 1) / C::BR, p.Hq, p.B), THREADS, C::SMEM_Q, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
}

template <typename T>
int dispatch_dims(const Params& p, int D, int Dv, cudaStream_t stream) {
  if (D == Dv) {
    switch (D) {
      case 32: return launch<T, 32, 32>(p, stream);
      case 64: return launch<T, 64, 64>(p, stream);
      case 128: return launch<T, 128, 128>(p, stream);
      case 256: return launch<T, 256, 256>(p, stream);
    }
  }
  if constexpr (std::is_same_v<T, float>) {  // fp32 alone: bf16 at (192, 128) runs the tensor-core kernel
    if (D == 192 && Dv == 128) return launch<T, 192, 128>(p, stream);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  D is q's and k's head dim, Dv v's, o's and
// dO's.  Strides in elements, (batch, seq, head) for q, k, v, o and dO in
// that order.  prefix_len > 0 (causal only, else invalid) keeps keys [0,
// prefix_len) visible to every row.  Launches three kernels on the stream.
// Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    void* dq, void* dk, void* dv, void* delta,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, int Dv, int dtype,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long d_sb, long long d_ss, long long d_sh,
    float scale, int causal, int prefix_len, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (causal && Sq != Sk) || prefix_len < 0 || (prefix_len > 0 && !causal))
    return int(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0) return 0;
  const int vec = rows_aligned(q, q_sb, q_ss, q_sh, B, Sq, Hq) && rows_aligned(dout, d_sb, d_ss, d_sh, B, Sq, Hq) &&
                  rows_aligned(k, k_sb, k_ss, k_sh, B, Sk, Hkv) && rows_aligned(v, v_sb, v_ss, v_sh, B, Sk, Hkv);
  const Params p{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,
                 B, Sq, Sk, Hq, Hkv,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, d_sb, d_ss, d_sh,
                 scale, scale * LOG2E, causal, prefix_len, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dims<float>(p, D, Dv, s);
    case 1: return dispatch_dims<__nv_bfloat16>(p, D, Dv, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
