// Flash attention forward for Hopper (sm_90a) on the CUDA cores, with a
// plain C interface.  fp32 runs here because the tensor cores' fp32 input
// type is TF32 (~10 bits of mantissa), which misses the fp32 tolerance
// (2e-5) the fp32 checks hold the kernel to.  bf16 runs on the tensor-core
// kernel (flash_attention_wgmma.cu) at every head dim; this kernel takes
// bf16 at head dim 256 only when asked (route "simt"), so that the two can
// be timed side by side.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (the
// Pallas TPU kernel _flash_kernel).  Same function: softmax(q k^T * scale) v
// per query head, kv head h / group (GQA without expanding K/V), causal or
// not, with or without a prefix-LM prefix (causal only: every row also sees
// the first prefix_len keys), the online softmax's running max, denominator and accumulator in
// fp32, a row that sees no key gives 0.
//
// Layout: q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv), out (B,
// Sq, Hq, Dv), all read and written through their strides (the last
// dimension contiguous), so the caller needs no transposes.  fp32 at (D, Dv)
// in (32, 32), (64, 64), (128, 128), (256, 256) and MLA's (192, 128), or
// bf16 at (256, 256) only, in and out (one type for all four), fp32 inside.
// Any other combination returns cudaErrorInvalidValue.  With a non-null lse
// pointer each row also writes its logsumexp, lse (B, Hq, Sq) fp32: the
// natural log of sum_j exp(s_ij * scale), +inf for a row that sees no key
// (the backward recomputes P from it).
//
// Design.  The TPU kernel walks the kv blocks as the innermost, sequential
// grid dimension and carries m, l and acc in VMEM scratch between grid
// steps.  CUDA blocks run in no order, so here one block of 256 threads
// owns one (query head, query tile, batch) and loops over the kv tiles
// itself, stopping at the causal diagonal (or at the end of the prefix, if
// that lies further); the heads vary fastest across
// the grid, so every head's last query tiles, which see the most kv tiles,
// start in the first wave.  Both products run as fp32 FMAs, and an
// SM reads 128 bytes a clock from shared memory against 128 FMAs, so the
// tiling follows the fp32 backward's (flash_attention_bwd.cu) to read as few
// floats per FMA as it can (simt_tile.cuh):
//   * tiles of BR = 64 rows (32 at D > 128, to fit shared memory), Q once
//     and K, V in two stages, staged as fp32 rows of D with their 16-byte
//     chunks swizzled (chunk c of row r at c ^ (r & 7)), brought in by
//     cp.async (16 bytes a copy, 4 where a base or stride is not 16-byte
//     aligned; bf16 converted by the threads), the next kv tile's copy
//     overlapping the current tile's products;
//   * S = Q K^T: every thread an 8 x 4 micro-tile read as float4s along D (12
//     float4 reads for 128 FMAs, the 8 rows broadcast across a quarter-warp),
//     so a tile's 64 x 64 (32 x 32) scores take 128 (32) threads and the
//     block splits D in KS = 2 (8 at D = 256, 6 at 192) parts, each part's raw scores
//     written transposed to its own shared tile; at D <= 64 one part (half
//     the threads) sums each score over D in order, as the plain product
//     does: split sums drift the fp32 smoke parity past its three-step
//     tolerance (PERF.md §6);
//   * one pass of all threads sums the parts and forms P = exp(S scale - m)
//     in place (the causal and ragged masks; each row's max and rescale
//     factor by shuffles across the threads of its row quad), and keeps the
//     rows' running max and partial denominator in registers;
//   * O += P V: all threads hold O (BR x D), each an 8 x 4 register block
//     (8 x 2 at D = 64, 4 x 2 at 32), P read as the float4 A operand of
//     four rows and V as a staged tile; the rows' rescale factors come
//     through shared memory.
// Three barriers a kv tile.  Shared memory: 199,168 bytes a block at D = 128
// (Q, two stages of K and V, two raw score tiles), 200,960 at D = 256.
// MLA's (192, 128) separates the two widths: Q, K and the scores' parts run
// over 192 columns, V and O over 128.  At 64-row tiles Q and two stages of K
// and V alone take 213 KB, so it takes the 32-row tiles of D = 256: six
// parts of 32 columns (192 of the 256 threads compute scores), O in 8 x 2
// register blocks, 134,400 bytes of shared memory.
//
// What bounds it: two products of 2 Sq Sk D per head (halved when causal)
// against q, k, v and out moved once; at S = 512, D = 128 the products, at
// the fp32 FMA rate, and the shared-memory reads that feed them.

#include <math.h>

#include "simt_tile.cuh"

namespace {

using namespace simt;

// DQK: the head dim of q and k (the scores), DV: that of v and out
template <int DQK, int DV>
struct Fwd : Rows<DQK> {  // BR, SPAD: the q/k width sets every tile's rows
  using Rows<DQK>::BR;
  using Rows<DQK>::SPAD;
  static constexpr int TQK = BR * DQK, TV = BR * DV;  // floats of a staged Q or K tile, of a V tile
  static constexpr int TI = 8, TJ = 4;               // score micro-tile a thread: rows, columns
  static constexpr int NRG = BR / TI, NCG = BR / TJ;  // its row and column groups: 8, 16 (BR = 64) or 4, 8
  static constexpr int TPS = NRG * NCG;               // threads a part of D: 128 or 32
  // parts of D: as many as the threads hold, each 32 columns or more: 2 (8 at D = 256, 6 at 192); one at
  // D <= 64, where S is cheap, so each score is one sum over D in order
  static constexpr int KS = DQK <= 64 ? 1 : (THREADS / TPS < DQK / 32 ? THREADS / TPS : DQK / 32);
  static constexpr int DK = DQK / KS;                 // head-dim columns a part: runs of 8 chunks
  static constexpr int TPR = THREADS / (BR / 4);      // softmax pass: threads a row quad, 16 or 32
  static constexpr int CPT = BR / TPR;                // its columns a thread: 4 or 1
  static constexpr int RQ = DV >= 64 ? 2 : 1;         // O: row quads a thread
  // Q, two stages of K and V, KS raw score tiles (the first holds P), the rows' rescale factors and sums
  static constexpr size_t SMEM =
      (size_t(3) * TQK + size_t(2) * TV + size_t(KS) * BR * SPAD + 2 * BR) * sizeof(float);
  static_assert(DK % 32 == 0 && KS * DK == DQK && TPR <= 32 && CPT * TPR == BR && SMEM <= 232448, "tiling");
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, Hq, Sq), or null: not written
  int Sq, Sk, Hq, Hkv;
  long long q_sb, q_ss, q_sh;  // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
  int prefix;  // causal: keys [0, prefix) are visible to every row
  int vec;     // fp32 q, k and v can be copied 16 bytes at a time
};

// This thread's 8 x 4 scores of a BR x BR tile over head-dim columns [c0, c0
// + DK): s[i][j] = sum_d X[rg + NRG i][d] Y[cg + NCG j][d], four columns at a
// time.  Row r's chunk u sits at u ^ (r & 7); rows cg + NCG j all swizzle by
// cg & 7, and rows rg + NRG i by rg & 7 (NRG = 8) or by rg ^ 4 (i & 1) (NRG =
// 4, rg < 4), so every load is one of three run pointers plus a constant.
template <typename F, int D>
__device__ __forceinline__ void scores_part(const float* X, const float* Y, float (&s)[8][4], int rg, int cg,
                                            int c0) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  const float* xr = X + rg * D;
  const float* yr = Y + cg * D;
#pragma unroll 1
  for (int c = c0 / 4; c < (c0 + F::DK) / 4; c += 8) {
    // c is a multiple of 8, so chunk c + u of row r sits at (c ^ (r & 7)) ^ u
    const int bx = c ^ (rg & 7), by = c ^ (cg & 7);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float* xp0 = xr + ((bx ^ u) << 2);
      const float* xp1 = xr + ((bx ^ u ^ 4) << 2);
      const float* yp = yr + ((by ^ u) << 2);
      float4 x[8], y[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = *reinterpret_cast<const float4*>((F::NRG == 4 && (i & 1) ? xp1 : xp0) + F::NRG * i * D);
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(yp + F::NCG * j * D);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(x[i].w, y[j].w, fmaf(x[i].z, y[j].z, fmaf(x[i].y, y[j].y, fmaf(x[i].x, y[j].x, s[i][j]))));
    }
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(const Params p) {
  using F = Fwd<DQK, DV>;
  constexpr int BR = F::BR, TQK = F::TQK, TV = F::TV, SPAD = F::SPAD, NRG = F::NRG, NCG = F::NCG;
  using G = Acc<DV, THREADS, F::RQ, BR>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + TQK;               // two stages
  float* sV = sK + 2 * TQK;           // two stages
  float* sS = sV + 2 * TV;            // KS raw score tiles, [kv col][q row] at SPAD; the first then holds P
  float* sAlpha = sS + F::KS * BR * SPAD;  // each row's rescale factor for this tile
  float* sL = sAlpha + BR;                 // each row's denominator, at the end

  const int tid = threadIdx.x, lane = tid & 31;
  // S = Q K^T: part `part` of D, an 8 x 4 micro-tile at rows rg + NRG i, columns cg + NCG j
  const int part = tid / F::TPS, pw = (tid % F::TPS) >> 5;  // pw: the warp within the part
  const int rg = (lane >> 3) + 4 * (pw % (NRG / 4)), cg = (lane & 7) + 8 * (pw / (NRG / 4));
  // softmax pass: rows 4 rq .. 4 rq + 3, columns ci + TPR m
  const int rq = tid / F::TPR, ci = tid % F::TPR;
  // O: Acc's register blocks
  const int ra = G::ra(tid >> 5, lane), ca = G::ca(tid >> 5, lane);

  // blocks start in the order of blockIdx.x, then y: every head's longest causal tiles (the last q tiles)
  // go first, and the short ones fill in behind them
  const int h = blockIdx.x;
  const int q0 = (int(gridDim.y) - 1 - int(blockIdx.y)) * BR;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  // causal: to the diagonal, or to the end of the prefix where that lies further
  const int k_end = p.causal ? max(min(p.Sk, q0 + BR), min(p.prefix, p.Sk)) : p.Sk;
  const int nkv = (k_end + BR - 1) / BR;  // 0 when Sk == 0: the rows give 0
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  auto issue = [&](int it) {
    const int s = it & 1;
    stage<DQK, BR>(sK + s * TQK, k, p.k_ss, it * BR, p.Sk, p.vec);
    stage<DV, BR>(sV + s * TV, v, p.v_ss, it * BR, p.Sk, p.vec);
  };
  stage<DQK, BR>(sQ, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq, p.vec);
  if (nkv > 0) issue(0);
  cp_commit();

  typename G::Tile acc;
  zero<DV, THREADS, F::RQ, BR>(acc);
  float m[4], l[4];  // the softmax pass's rows: running max of s scale, this thread's part of the sum
#pragma unroll
  for (int e = 0; e < 4; ++e) m[e] = -INFINITY, l[e] = 0.f;

  for (int it = 0; it < nkv; ++it) {
    const int s = it & 1, k0 = it * BR;
    cp_wait<0>();
    __syncthreads();  // stage s has landed for every thread, and every read of stage s ^ 1, P and alpha is done
    if (it + 1 < nkv) {
      issue(it + 1);
      cp_commit();
    }

    if (part < F::KS) {  // this part's raw scores, stored transposed
      float sc[8][4];
      scores_part<F, DQK>(sQ, sK + s * TQK, sc, rg, cg, part * F::DK);
      float* dst = sS + part * BR * SPAD;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[(cg + NCG * j) * SPAD + rg + NRG * i] = sc[i][j];
    }
    __syncthreads();

    {  // P = exp(S scale - m) in place of the first part, and each row's rescale factor
      float4 sv[F::CPT];
#pragma unroll
      for (int c = 0; c < F::CPT; ++c) {
        const float* src = sS + (ci + F::TPR * c) * SPAD + 4 * rq;
        sv[c] = *reinterpret_cast<const float4*>(src);
#pragma unroll
        for (int kp = 1; kp < F::KS; ++kp) {
          const float4 t = *reinterpret_cast<const float4*>(src + kp * BR * SPAD);
          sv[c].x += t.x, sv[c].y += t.y, sv[c].z += t.z, sv[c].w += t.w;
        }
      }
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < F::CPT; ++c) {
        float* s4 = &sv[c].x;
        const int col = k0 + ci + F::TPR * c;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + 4 * rq + e;
          const bool ok = col < p.Sk && (!p.causal || col <= row || col < p.prefix);
          s4[e] = ok ? s4[e] * p.scale : -INFINITY;
          mx[e] = fmaxf(mx[e], s4[e]);
        }
      }
      float alpha[4], shift[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int off = F::TPR / 2; off > 0; off >>= 1) mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], off));
        const float m_new = fmaxf(m[e], mx[e]);
        // a row with nothing visible yet keeps m = -inf: take 0 as its shift, so exp gives 0, not nan
        shift[e] = m_new == -INFINITY ? 0.f : m_new;
        alpha[e] = expf(m[e] - shift[e]);
        m[e] = m_new;
      }
      float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < F::CPT; ++c) {
        float* s4 = &sv[c].x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s4[e] = expf(s4[e] - shift[e]);
          rs[e] += s4[e];
        }
        *reinterpret_cast<float4*>(sS + (ci + F::TPR * c) * SPAD + 4 * rq) = sv[c];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e] = l[e] * alpha[e] + rs[e];
      if (ci == 0) *reinterpret_cast<float4*>(sAlpha + 4 * rq) = make_float4(alpha[0], alpha[1], alpha[2], alpha[3]);
    }
    __syncthreads();

    // O = alpha O + P V
#pragma unroll
    for (int q = 0; q < F::RQ; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(sAlpha + G::row(ra, q, 0));
      const float a4[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < G::NCOL; ++c) acc[4 * q + r][c] *= a4[r];
    }
    accumulate<DV, THREADS, F::RQ, BR>(sS, sV + s * TV, acc, ra, ca);
  }
  cp_wait<0>();  // with no kv tile, nothing waited for Q

  // each row's denominator, summed over the threads of its row quad; its lse
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int off = F::TPR / 2; off > 0; off >>= 1) l[e] += __shfl_xor_sync(0xffffffffu, l[e], off);
  if (ci == 0) {
    *reinterpret_cast<float4*>(sL + 4 * rq) = make_float4(l[0], l[1], l[2], l[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + 4 * rq + e;
      if (p.lse != nullptr && row < p.Sq)
        p.lse[(size_t(b) * p.Hq + h) * p.Sq + row] = l[e] == 0.f ? INFINITY : m[e] + logf(l[e]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < F::RQ; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float lt = sL[G::row(ra, q, r)];
#pragma unroll
      for (int c = 0; c < G::NCOL; ++c) acc[4 * q + r][c] = lt == 0.f ? 0.f : acc[4 * q + r][c] / lt;  // masked row: 0
    }
  store_acc<T, DV, THREADS, F::RQ, BR>(static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh, p.o_ss, q0, p.Sq, acc, 1.f,
                                       ra, ca);
}

template <typename T, int DQK, int DV>
int launch(const Params& p, int B, cudaStream_t stream) {
  using F = Fwd<DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(F::SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(p.Hq, (p.Sq + F::BR - 1) / F::BR, B);
  flash_fwd_kernel<T, DQK, DV><<<grid, THREADS, F::SMEM, stream>>>(p);
  return int(cudaGetLastError());
}

int dispatch_fp32(const Params& p, int B, int D, int Dv, cudaStream_t stream) {
  if (D == Dv) {
    switch (D) {
      case 32: return launch<float, 32, 32>(p, B, stream);
      case 64: return launch<float, 64, 64>(p, B, stream);
      case 128: return launch<float, 128, 128>(p, B, stream);
      case 256: return launch<float, 256, 256>(p, B, stream);
    }
  }
  if (D == 192 && Dv == 128) return launch<float, 192, 128>(p, B, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// D: the head dim of q and k, Dv: that of v and o.  dtype: 0 = fp32, 1 =
// bf16 (q, k, v and o alike).  lse may be null.  prefix_len > 0 (causal
// only, else invalid) keeps keys [0, prefix_len) visible to every row.  Returns a cudaError_t (0 on
// success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, int Dv, int dtype,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int prefix_len, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || prefix_len < 0 || (prefix_len > 0 && !causal)) return int(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  const int vec = rows_aligned(q, q_sb, q_ss, q_sh, B, Sq, Hq) && rows_aligned(k, k_sb, k_ss, k_sh, B, Sk, Hkv) &&
                  rows_aligned(v, v_sb, v_ss, v_sh, B, Sk, Hkv);
  const Params p{q, k, v, o, lse, Sq, Sk, Hq, Hkv,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 scale, causal, prefix_len, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_fp32(p, B, D, Dv, s);
    // bf16 comes here only at D = Dv = 256, when the caller asks for this kernel
    case 1: return D == 256 && Dv == 256 ? launch<__nv_bfloat16, 256, 256>(p, B, s) : int(cudaErrorInvalidValue);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
