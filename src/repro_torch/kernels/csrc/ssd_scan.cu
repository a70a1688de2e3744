// Mamba-2 SSD chunked scan forward for Hopper (sm_90a) on the CUDA cores, with
// a plain C interface: the fp32 route.  bf16 runs the tensor-core kernels
// (ssd_scan_wgmma.cu); this one also takes bf16 when asked (route "simt"),
// so that the two can be timed side by side.  fp32 stays here because the
// tensor cores' fp32 input type is TF32, which would miss the fp32 tolerance.
//
// Replaces repro/kernels/ssd_scan.py::ssd_scan_pallas (the Pallas TPU kernel
// _ssd_kernel).  Same function, the linear recurrence
//
//     h_t = exp(A·dt_t)·h_{t-1} + dt_t·(x_t ⊗ B_t),   y_t = C_t·h_t + D·x_t
//
// computed in its chunked form over tiles of L = 64 rows, with cum the
// inclusive prefix sum of A·dt inside the tile:
//
//     intra-tile   y  = (tril(C Bᵀ) ⊙ exp(cum_t − cum_s) ⊙ dt_s + diag(D)) @ X
//     inter-tile   y += exp(cum_t) · (C @ h_inᵀ)
//     state        h  = exp(cum_L)·h_in + Xwᵀ @ B,   Xw = X ⊙ exp(cum_L − cum_s)·dt_s
//
// The s > t entries are masked before exp, as the TPU kernel does.
//
// Layout: x (B, S, H, P), dt (B, S, H), B and C (B, S, G, N), all read
// through their strides (the last dimension of x, B and C contiguous); head
// h reads group h / (H/G) of B and C in place.  A, D (H,) and h0 (B, H, P, N)
// fp32 and contiguous; x, B, C fp32 or bf16; y (B, S, H, P) contiguous in
// x's type, h_final (B, H, P, N) fp32.  Any P (in slices of PS = 64 state
// rows, the last zero-padded) and N up to 256 (padded with zeros to NS = 64,
// 128 or 256).
//
// Design: the chunked-parallel form in three kernels on one stream, one
// tile a chunk, so that every product is a block's own:
//   ssd_prep  one block per (tile, group, batch): C Bᵀ once for the group's
//             heads, written to scratch (B, G, nT, L, L); and one block per
//             (tile, head and state slice, batch): the tile's own state
//             Xwᵀ B, written as (n, p) rows to scratch (B, nT, H, slices, NS,
//             PS), and exp(cum_L).
//   ssd_pass  one thread per 4 state values of one (batch, head): walks the
//             tiles in order in fp32 from h0, putting each tile's entering
//             state in place of its own, and writes h_final.
//   ssd_out   one block per (tile, head and state slice, batch): from the
//             entering state, y = [exp(cum_t) C | M] @ [h_inᵀ ; X] with M =
//             tril(C Bᵀ) ⊙ exp(cum_t − cum_s) ⊙ dt_s + diag(D) (the skip term
//             on M's diagonal).
// Each block has 256 threads.  Tiles come in by cp.async (16 bytes a copy,
// 4 where a base, stride or width is not 16-byte aligned; bf16 converted
// by the threads), rows past S zero-filled with dt = 0, which keeps cum
// flat and w zero, so any S works and nothing is padded in memory; cum is a
// warp scan.  Every product is register-blocked and reads float4s with one
// operand broadcast across each quarter-warp (simt_tile.cuh):
//   C Bᵀ    4 x 4 scores a thread, rows of C and B along N at a padded stride;
//   Xwᵀ B   8 x 4 state values a thread (8 x 2 at NS = 64, 8 x 8 at 256), a
//           float4 of four n and one of four p per row s of the tile;
//   y       8 x 4 outputs a thread, each half of the block taking half of
//           the concatenated depth NS + L (the halves' sums meet in shared
//           memory), a float4 of four columns of the A operand against four
//           rows of the B operand; exp(cum_t) scales the rows of the C hᵀ
//           part before M X joins them.
//
// What bounds it: the work (C Bᵀ once per group and tile, the causal halves
// of it and of M X, C h_inᵀ and Xwᵀ B per head and tile) is small against
// the bytes the function moves, so the function is bound by bytes; the
// kernels do the work as fp32 FMAs, at shared-memory and FMA rate, and add
// the tile states' round trip (PS·NS·4 bytes per (batch, head, tile):
// written, read and written by the pass, read).

#include <math.h>

#include "simt_tile.cuh"

namespace {

using namespace simt;

constexpr int L = 64;   // rows per tile
constexpr int PS = 64;  // state rows p per block: one slice of P

template <int NS>
struct Cfg {
  static constexpr int LDP = NS + 4;  // C Bᵀ role: row of a C or B tile, 16 bytes past NS so rows fall in other banks
  static constexpr size_t PREP_CB = size_t(2) * L * LDP;
  static constexpr size_t PREP_ST = size_t(L) * NS + size_t(L) * PS + 3 * L;  // B, x, dt, cum, w
  static constexpr size_t PREP_SMEM = (PREP_CB > PREP_ST ? PREP_CB : PREP_ST) * sizeof(float);
  static constexpr size_t OUT_SMEM = (size_t(L) * NS + size_t(NS) * PS + L * L + L * PS + 2 * L) * sizeof(float);
  static constexpr int KH = (NS + L) / 2;  // ssd_out: the depth of the concatenated product each half takes
  static_assert(KH % 4 == 0 && OUT_SMEM <= 232448, "tiling");
};

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;   // may be null: no skip term
  const float* h0;  // may be null: zero initial state
  void* y;
  float* h_out;
  float* cb;     // (B, G, nT, L, L): C Bᵀ of each tile
  float* st;     // (B, nT, H, nps, NS, PS): each tile's own state as (n, p) rows, then the state entering it
  float* decay;  // (B, nT, H): exp(cum_L) of each tile
  int S, H, G, P, N, nT, nps;
  long long x_sb, x_ss, x_sh;  // strides in elements
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  int vec;  // fp32 x, B and C can be copied 16 bytes at a time
};

// rows [0, L) x columns [0, W) of a strided source into a shared tile at row
// stride LD, zero past `rows` rows and `cols` columns: fp32 by cp.async (the
// caller commits) ...
template <int W, int LD>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, long long row_stride, int rows, int cols,
                                           int vec) {
  constexpr int C4 = W / 4;
  for (int idx = threadIdx.x; idx < L * C4; idx += THREADS) {
    const int r = idx / C4, c = (idx % C4) * 4;
    float* d = dst + r * LD + c;
    const float* s = src + r * row_stride + c;
    if (vec) {  // cols is a multiple of 4
      const bool ok = r < rows && c < cols;
      cp_async16(d, ok ? s : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = r < rows && c + e < cols;
        cp_async4(d + e, ok ? s + e : src, ok);
      }
    }
  }
}
// ... bf16 converted by the threads
template <int W, int LD>
__device__ __forceinline__ void stage_tile(float* dst, const __nv_bfloat16* src, long long row_stride, int rows,
                                           int cols, int) {
  constexpr int C4 = W / 4;
  for (int idx = threadIdx.x; idx < L * C4; idx += THREADS) {
    const int r = idx / C4, c = (idx % C4) * 4;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = r < rows && c + e < cols ? ld(src + r * row_stride + c + e) : 0.f;
    *reinterpret_cast<float4*>(dst + r * LD + c) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// dt of the tile's rows (0 past S) and cum, the inclusive prefix of A·dt,
// times log2(e) (two warp scans joined), into shared memory; all wait
__device__ __forceinline__ void tile_cum(const float* dt, long long dt_ss, int rows, float A, float* sDt,
                                         float* sCum2) {
  const int tid = threadIdx.x;
  if (tid < L) {
    const float d = tid < rows ? dt[tid * dt_ss] : 0.f;
    float run = A * d;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, run, off);
      if ((tid & 31) >= off) run += v;
    }
    sDt[tid] = d;
    sCum2[tid] = run;
  }
  __syncthreads();
  if (tid >= 32 && tid < L) sCum2[tid] += sCum2[31];
  __syncthreads();
  if (tid < L) sCum2[tid] *= LOG2E;
  __syncthreads();
}

// ---------------------------------------------------------------- ssd_prep
template <typename T, int NS>
__device__ __forceinline__ void prep_cb(const Params& p, float* smem, int t, int g, int b) {
  using C = Cfg<NS>;
  float* sC = smem;
  float* sB = sC + L * C::LDP;
  const int t0 = t * L, rows = min(L, p.S - t0);
  stage_tile<NS, C::LDP>(sC, static_cast<const T*>(p.Cm) + b * p.c_sb + t0 * p.c_ss + g * p.c_sg, p.c_ss, rows, p.N,
                         p.vec);
  stage_tile<NS, C::LDP>(sB, static_cast<const T*>(p.Bm) + b * p.b_sb + t0 * p.b_ss + g * p.b_sg, p.b_ss, rows, p.N,
                         p.vec);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  // scores (tr + 16 i, tc + 16 j): a quarter-warp shares tr (C broadcast) and reads 8 rows of B
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  float acc[4][4] = {};
  const float* cp = sC + tr * C::LDP;
  const float* bp = sB + tc * C::LDP;
#pragma unroll 4
  for (int n = 0; n < NS; n += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = *reinterpret_cast<const float4*>(cp + 16 * i * C::LDP + n);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(bp + 16 * j * C::LDP + n);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = fmaf(cv[i].x, bv[j].x, fmaf(cv[i].y, bv[j].y, fmaf(cv[i].z, bv[j].z, fmaf(cv[i].w, bv[j].w, acc[i][j]))));
  }
  float* out = p.cb + ((size_t(b) * p.G + g) * p.nT + t) * (L * L);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(tr + 16 * i) * L + tc + 16 * j] = acc[i][j];
}

template <typename T, int NS>
__device__ __forceinline__ void prep_state(const Params& p, float* smem, int t, int hs, int b) {
  using G = Acc<PS, THREADS, 2, NS>;  // rows n, columns p
  float* sB = smem;             // L x NS
  float* sX = sB + L * NS;      // L x PS, then x w
  float* sDt = sX + L * PS;
  float* sCum2 = sDt + L;
  float* sW = sCum2 + L;
  const int h = hs / p.nps, p0 = (hs % p.nps) * PS, g = h / (p.H / p.G);
  const int t0 = t * L, rows = min(L, p.S - t0);
  stage_tile<NS, NS>(sB, static_cast<const T*>(p.Bm) + b * p.b_sb + t0 * p.b_ss + g * p.b_sg, p.b_ss, rows, p.N,
                     p.vec);
  stage_tile<PS, PS>(sX, static_cast<const T*>(p.x) + b * p.x_sb + t0 * p.x_ss + h * p.x_sh + p0, p.x_ss, rows,
                     p.P - p0, p.vec);
  cp_commit();
  tile_cum(p.dt + b * p.dt_sb + t0 * p.dt_ss + h * p.dt_sh, p.dt_ss, rows, p.A[h], sDt, sCum2);
  const int tid = threadIdx.x;
  if (tid < L) sW[tid] = exp2f(sCum2[L - 1] - sCum2[tid]) * sDt[tid];
  if (tid == 0 && p0 == 0) p.decay[(size_t(b) * p.nT + t) * p.H + h] = exp2f(sCum2[L - 1]);
  cp_wait<0>();
  __syncthreads();
  for (int i = tid; i < L * PS / 4; i += THREADS) {  // x w
    float4* x4 = reinterpret_cast<float4*>(sX) + i;
    const float w = sW[i / (PS / 4)];
    float4 v = *x4;
    v.x *= w, v.y *= w, v.z *= w, v.w *= w;
    *x4 = v;
  }
  __syncthreads();

  // own[n][p] = sum_s B[s][n] Xw[s][p]: B read as float4s of four n (one address a quarter-warp), Xw as
  // VW-wide vectors of p (a quarter-warp's 8 contiguous)
  const int lane = tid & 31, ra = G::ra(tid >> 5, lane), ca = G::ca(tid >> 5, lane);
  float acc[8][G::NCOL] = {};
#pragma unroll 4
  for (int s = 0; s < L; ++s) {
    float av[8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(sB + s * NS + G::row(ra, q, 0));
      av[4 * q] = f.x, av[4 * q + 1] = f.y, av[4 * q + 2] = f.z, av[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int v = 0; v < G::NV; ++v) {
      float bv[G::VW];
      load_vec<G::VW>(bv, sX + s * PS + G::col(ca, v));
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < G::VW; ++e) acc[r][v * G::VW + e] = fmaf(av[r], bv[e], acc[r][v * G::VW + e]);
    }
  }
  float* out = p.st + (((size_t(b) * p.nT + t) * p.H + h) * p.nps + p0 / PS) * (NS * PS);
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int v = 0; v < G::NV; ++v)
#pragma unroll
        for (int e = 0; e < G::VW; ++e) out[G::row(ra, q, r) * PS + G::col(ca, v) + e] = acc[4 * q + r][v * G::VW + e];
}

// blockIdx = (tile, group or head and state slice, batch): the first G rows of y compute C Bᵀ
template <typename T, int NS>
__global__ void __launch_bounds__(THREADS, 2) ssd_prep(const Params p) {
  extern __shared__ __align__(16) float smem[];
  if (int(blockIdx.y) < p.G)
    prep_cb<T, NS>(p, smem, blockIdx.x, blockIdx.y, blockIdx.z);
  else
    prep_state<T, NS>(p, smem, blockIdx.x, blockIdx.y - p.G, blockIdx.z);
}

// ---------------------------------------------------------------- ssd_pass
// Each thread walks 4 state values of one (batch, head) across the tiles:
// st[t] (the tile's own state) becomes the state entering tile t, h = exp(cum_L)
// h + own.  Its loads do not wait on h, so AHEAD tiles' loads are in flight
// at once: the pass is bound by the states' bytes, not by their latency.
template <int NS>
__global__ void __launch_bounds__(THREADS) ssd_pass(const Params p) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int per_head = p.nps * NS * PS;
  const int e = (blockIdx.x * THREADS + threadIdx.x) * 4;
  if (e >= per_head) return;
  const int ps = e / (NS * PS), n = (e % (NS * PS)) / PS, p0 = ps * PS + e % PS;  // p0 .. p0 + 3 at n
  const size_t hb = (size_t(b) * p.H + h) * p.P * p.N;
  float hv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    hv[j] = p.h0 != nullptr && n < p.N && p0 + j < p.P ? p.h0[hb + size_t(p0 + j) * p.N + n] : 0.f;
  const size_t tstride = size_t(p.H) * per_head;
  float4* st = reinterpret_cast<float4*>(p.st + size_t(b) * p.nT * tstride + size_t(h) * per_head + e);
  const float* dec = p.decay + size_t(b) * p.nT * p.H + h;
  constexpr int AHEAD = 16;
  for (int t0 = 0; t0 < p.nT; t0 += AHEAD) {
    float4 own[AHEAD];
    float d[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i)
      if (t0 + i < p.nT) own[i] = st[(t0 + i) * (tstride / 4)], d[i] = dec[size_t(t0 + i) * p.H];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      if (t0 + i >= p.nT) break;
      st[(t0 + i) * (tstride / 4)] = make_float4(hv[0], hv[1], hv[2], hv[3]);
      hv[0] = fmaf(d[i], hv[0], own[i].x);
      hv[1] = fmaf(d[i], hv[1], own[i].y);
      hv[2] = fmaf(d[i], hv[2], own[i].z);
      hv[3] = fmaf(d[i], hv[3], own[i].w);
    }
  }
  if (n < p.N)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (p0 + j < p.P) p.h_out[hb + size_t(p0 + j) * p.N + n] = hv[j];
}

// ---------------------------------------------------------------- ssd_out
// acc[i][e] += sum_k A[rg + 8 i][k] B[k][4 cg + e] over k in [k0, k1): A rows
// at stride LDA (a quarter-warp shares rg: one address), B rows at LDB (a
// quarter-warp reads 8 contiguous float4s)
template <int LDA, int LDB>
__device__ __forceinline__ void rows_product(const float* A, const float* B, int k0, int k1, float (&acc)[8][4],
                                             int rg, int cg) {
  const float* ap = A + rg * LDA + k0;
  const float* bp = B + k0 * LDB + 4 * cg;
#pragma unroll 2
  for (int k = k0; k < k1; k += 4, ap += 4, bp += 4 * LDB) {
    float4 a[8], bv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(ap + 8 * i * LDA);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) bv[kk] = *reinterpret_cast<const float4*>(bp + kk * LDB);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[i][0] = fmaf(av[kk], bv[kk].x, acc[i][0]);
        acc[i][1] = fmaf(av[kk], bv[kk].y, acc[i][1]);
        acc[i][2] = fmaf(av[kk], bv[kk].z, acc[i][2]);
        acc[i][3] = fmaf(av[kk], bv[kk].w, acc[i][3]);
      }
    }
  }
}

template <typename T, int NS>
__global__ void __launch_bounds__(THREADS, 2) ssd_out(const Params p) {
  using C = Cfg<NS>;
  extern __shared__ __align__(16) float smem[];
  float* sC = smem;            // L x NS
  float* sH = sC + L * NS;     // NS x PS: the entering state, (n, p) rows
  float* sM = sH + NS * PS;    // L x L, then the second half's sums (L x PS)
  float* sX = sM + L * L;      // L x PS
  float* sDt = sX + L * PS;
  float* sCum2 = sDt + L;
  const int t = blockIdx.x, hs = blockIdx.y, b = blockIdx.z;
  const int h = hs / p.nps, p0 = (hs % p.nps) * PS, g = h / (p.H / p.G);
  const int t0 = t * L, rows = min(L, p.S - t0);
  const int tid = threadIdx.x;

  stage_tile<NS, NS>(sC, static_cast<const T*>(p.Cm) + b * p.c_sb + t0 * p.c_ss + g * p.c_sg, p.c_ss, rows, p.N,
                     p.vec);
  stage_tile<PS, PS>(sX, static_cast<const T*>(p.x) + b * p.x_sb + t0 * p.x_ss + h * p.x_sh + p0, p.x_ss, rows,
                     p.P - p0, p.vec);
  const float* hin = p.st + (((size_t(b) * p.nT + t) * p.H + h) * p.nps + p0 / PS) * (NS * PS);
  for (int i = tid; i < NS * PS / 4; i += THREADS) cp_async16(sH + 4 * i, hin + 4 * i, true);
  cp_commit();
  tile_cum(p.dt + b * p.dt_sb + t0 * p.dt_ss + h * p.dt_sh, p.dt_ss, rows, p.A[h], sDt, sCum2);

  // M = tril(C Bᵀ) ⊙ exp(cum_t − cum_s) ⊙ dt_s + diag(D), four columns a thread at a time
  const float Dh = p.D != nullptr ? p.D[h] : 0.f;
  const float* cb = p.cb + ((size_t(b) * p.G + g) * p.nT + t) * (L * L);
  for (int i = tid; i < L * L / 4; i += THREADS) {
    const int r = i / (L / 4), s0 = (i % (L / 4)) * 4;
    float m4[4] = {0.f, 0.f, 0.f, 0.f};
    if (s0 <= r) {
      const float4 c4 = *reinterpret_cast<const float4*>(cb + r * L + s0);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s0 + e <= r) m4[e] = cv[e] * exp2f(sCum2[r] - sCum2[s0 + e]) * sDt[s0 + e] + (s0 + e == r ? Dh : 0.f);
    }
    *reinterpret_cast<float4*>(sM + r * L + s0) = make_float4(m4[0], m4[1], m4[2], m4[3]);
  }
  cp_wait<0>();
  __syncthreads();

  // y = exp(cum_t) (C h_inᵀ) + M X over the concatenated depth NS + L, each half of the block half of it
  const int half = tid / (THREADS / 2), w = (tid >> 5) & 3, lane = tid & 31;
  const int rg = (lane >> 3) + 4 * (w & 1), cg = (lane & 7) + 8 * (w >> 1);  // rows rg + 8 i, columns 4 cg ..
  float acc[8][4] = {};
  const int k0 = half ? C::KH : 0, k1 = half ? NS : C::KH;  // the C h_inᵀ part of this half's depth
  if (k0 < k1) rows_product<NS, PS>(sC, sH, k0, k1, acc, rg, cg);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float e = exp2f(sCum2[rg + 8 * i]);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] *= e;
  }
  if (half) rows_product<L, PS>(sM, sX, 0, L, acc, rg, cg);  // the M X part
  __syncthreads();  // every read of M is done
  if (half)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(sM + (rg + 8 * i) * PS + 4 * cg) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  if (!half) {
    T* y = static_cast<T*>(p.y) + ((size_t(b) * p.S + t0) * p.H + h) * p.P + p0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rg + 8 * i;
      if (r >= rows) continue;
      const float4 o = *reinterpret_cast<const float4*>(sM + r * PS + 4 * cg);
      const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (p0 + 4 * cg + c < p.P) st(y + size_t(r) * p.H * p.P + 4 * cg + c, acc[i][c] + ov[c]);
    }
  }
}

template <typename T, int NS>
int launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<NS>;
  cudaError_t e = cudaFuncSetAttribute(ssd_prep<T, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::PREP_SMEM));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_out<T, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::OUT_SMEM));
  if (e != cudaSuccess) return int(e);
  if (p.nT > 0) {
    ssd_prep<T, NS><<<dim3(p.nT, p.G + p.H * p.nps, B), THREADS, C::PREP_SMEM, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  const int per_head = p.nps * NS * PS / 4;  // threads a (batch, head) in the pass
  ssd_pass<NS><<<dim3((per_head + THREADS - 1) / THREADS, p.H, B), THREADS, 0, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  if (p.nT > 0) {
    ssd_out<T, NS><<<dim3(p.nT, p.H * p.nps, B), THREADS, C::OUT_SMEM, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
}

template <typename T>
int dispatch_state(const Params& p, int B, cudaStream_t stream) {
  if (p.N <= 64) return launch<T, 64>(p, B, stream);
  if (p.N <= 128) return launch<T, 128>(p, B, stream);
  return launch<T, 256>(p, B, stream);
}

}  // namespace

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16.  D and h0 may be null.
// cb, st and decay are fp32 scratch of the sizes Params names (ssd_scan.simt_scratch).
// Launches three kernels on the stream (two when S = 0).  Returns a
// cudaError_t (0 on success).
extern "C" int repro_ssd_scan_fwd(
    const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
    const float* D, const float* h0, void* y, float* h_out, float* cb, float* st, float* decay, int dtype,
    int B, int S, int H, int G, int P, int N,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    void* stream) {
  if (G <= 0 || H % G != 0 || P <= 0 || N <= 0 || N > 256) return int(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const int vec = dtype == 0 && P % 4 == 0 && N % 4 == 0 && rows_aligned(x, x_sb, x_ss, x_sh, B, S, H) &&
                  rows_aligned(Bm, b_sb, b_ss, b_sg, B, S, G) && rows_aligned(Cm, c_sb, c_ss, c_sg, B, S, G);
  const Params p{x, dt, A, Bm, Cm, D, h0, y, h_out, cb, st, decay, S, H, G, P, N, (S + L - 1) / L, (P + PS - 1) / PS,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_state<float>(p, B, s);
  if (dtype == 1) return dispatch_state<__nv_bfloat16>(p, B, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* repro_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
