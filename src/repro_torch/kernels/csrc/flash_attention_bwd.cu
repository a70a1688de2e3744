// Flash attention backward for Hopper (sm_90a) on the CUDA cores, with a
// plain C interface: the fp32 route, and bf16 at head dim 256 (gemma-7b,
// paligemma-3b).  bf16 at head dims 32-128, dense training's, runs the
// tensor-core backward (flash_attention_bwd_wgmma.cu); this kernel also
// takes those when asked (route "simt"), so the two can be timed side by
// side.  fp32 stays here because the tensor cores' fp32 input type is TF32,
// which would miss the fp32 tolerance.
//
// Replaces the gradient that XLA takes of repro/kernels/ops.py::_xla_flash,
// the blocked online-softmax form the JAX package trains through off the
// TPU (the Pallas kernel _flash_kernel has no backward).  Same function:
// the gradients of softmax(q k^T * scale) v with respect to q, k and v, per
// query head, kv head h / group (GQA: dK and dV summed over the group),
// causal (Sq == Sk) or not.
//
// Layout: q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), o and dO (B, Sq, Hq, D),
// all read through their strides (the last dimension contiguous; dO arrives
// from the output projection's gradient and may be any view); lse
// (B, Hq, Sq) fp32 as the forward kernels write it (natural log, +inf for a
// row that sees no key); dq (B, Sq, Hq, D), dk and dv (B, Sk, Hkv, D) written
// contiguous; delta (B, Hq, Sq) fp32 scratch.  fp32 or bf16 in and out (one
// type for q, k, v, o, dO and the gradients), fp32 inside.  D in 32, 64,
// 128, 256.
//
// Design: the FlashAttention-2 backward, split in three launches so that no
// block adds into another's output (no atomics, the result is the same on
// every run):
//   1. flash_bwd_delta: D_i = rowsum(dO_i * O_i), one warp a row;
//   2. flash_bwd_dkdv: one block per (kv tile, kv head, batch) keeps its K
//      and V tile and the dK, dV accumulators resident and walks the q
//      heads of its group and, for each, the q tiles from the causal
//      diagonal on: P = exp(S * scale - lse) from the recomputed scores,
//      dV += P^T dO, dP = dO V^T, dS = P (dP - D_i), dK += dS^T Q;
//   3. flash_bwd_dq: one block per (q tile, q head, batch) keeps its Q and
//      dO tile resident and walks the kv tiles up to the diagonal: the same
//      P and dS, dQ += dS K.
// dQ and dK take the scale once at the end.  Tiles are 64 rows (32 at
// D = 256, to fit shared memory), staged in shared memory as fp32 with one
// float of padding a row, so the 16 threads reading 16 rows at the same
// column fall into 16 banks.  256 threads form a 16 x 16 grid: in a score
// tile each thread holds TR q rows x TR kv columns (columns strided by 16),
// in an accumulator TR rows x D/16 columns.  A score is masked by the
// causal diagonal and the ragged edges of both tiles; masked and padded
// entries give P = 0 and dS = 0, and a row whose lse is +inf has
// exp(s - inf) = 0, so fully masked rows give zero gradients, not nan.
//
// What bounds it: five products of 2 Sq Sk D per head (halved when causal)
// against q, k, v, o, dO read once and dq, dk, dv written once; at
// training's S = 2048, D = 128 the products bound it.  This kernel runs
// them as fp32 FMAs on the CUDA cores (S and dP are computed twice, once
// per kernel: seven products), so it is bound by the fp32 FMA rate and by
// shared-memory reads, far from the bf16 tensor-core bound that the
// tensor-core backward works toward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

constexpr int THREADS = 256;  // 16 x 16

template <int D>
struct Cfg {
  static constexpr int BR = D >= 256 ? 32 : 64;  // rows of every q and kv tile
  static constexpr int LD = D + 1;               // padded row of a staged tile
  static constexpr int SP = BR + 1;              // padded row of a score tile
  static constexpr int TR = BR / 16;             // tile rows (or score columns) per thread
  static constexpr int NC = D / 16;              // head-dim columns per thread
  // four staged BR x D tiles, two BR x BR score tiles, lse and delta of BR rows
  static constexpr size_t SMEM = (4 * size_t(BR) * LD + 2 * size_t(BR) * SP + 2 * BR) * sizeof(float);
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Sq)
  float* delta;      // (B, Hq, Sq) scratch
  void* dq;          // (B, Sq, Hq, D) contiguous
  void* dk;          // (B, Sk, Hkv, D) contiguous
  void* dv;          // (B, Sk, Hkv, D) contiguous
  int B, Sq, Sk, Hq, Hkv;
  long long q_sb, q_ss, q_sh;  // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long d_sb, d_ss, d_sh;
  float scale;
  int causal;
};

// D_i = rowsum(dO_i * O_i) for every (batch, head, row), one warp a row.
template <typename T, int D>
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
  for (int d = lane; d < D; d += 32) acc = fmaf(ld(o + d), ld(g + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// Rows [r0, r0 + BR) of one (batch, head) slice into shared memory as fp32,
// zero past row n.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row_stride, int r0, int n) {
  using C = Cfg<D>;
  for (int idx = threadIdx.x; idx < C::BR * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int row = r0 + r;
    dst[r * C::LD + d] = row < n ? ld(src + row * row_stride + d) : 0.f;
  }
}

// lse and delta of rows [q0, q0 + BR) of one (batch, head); +inf and 0 past Sq
__device__ __forceinline__ void stage_rows(float* sLse, float* sDelta, const Params& p, size_t bh, int q0, int BR) {
  for (int r = threadIdx.x; r < BR; r += THREADS) {
    const int row = q0 + r;
    sLse[r] = row < p.Sq ? p.lse[bh * p.Sq + row] : INFINITY;
    sDelta[r] = row < p.Sq ? p.delta[bh * p.Sq + row] : 0.f;
  }
}

// The score tile of q rows [q0, q0 + BR) against kv rows [k0, k0 + BR), from
// the staged Q, dO, K, V tiles: P = exp(S * scale - lse) on visible entries
// (0 elsewhere) and dS = P (dP - D_i), written [q row][kv row] at stride SP
// (P only where sP is not null).  Thread (ty, tx) takes q rows ty*TR + i and
// kv rows tx + 16 j.
template <int D>
__device__ __forceinline__ void score_tile(const Params& p, const float* sQ, const float* sdO, const float* sK,
                                           const float* sV, const float* sLse, const float* sDelta, float* sP,
                                           float* sdS, int q0, int k0) {
  using C = Cfg<D>;
  constexpr int TR = C::TR, LD = C::LD, SP = C::SP;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[TR][TR], dp[TR][TR];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[TR], gv[TR], kv[TR], vv[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      qv[i] = sQ[(ty * TR + i) * LD + d];
      gv[i] = sdO[(ty * TR + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      kv[j] = sK[(tx + 16 * j) * LD + d];
      vv[j] = sV[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ty * TR + i, row = q0 + r;
    const float lse = sLse[r], dl = sDelta[r];
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int c = tx + 16 * j, col = k0 + c;
      const bool ok = row < p.Sq && col < p.Sk && (!p.causal || col <= row);
      const float pij = ok ? expf(s[i][j] * p.scale - lse) : 0.f;
      if (sP != nullptr) sP[r * SP + c] = pij;
      sdS[r * SP + c] = pij * (dp[i][j] - dl);
    }
  }
}

// dK and dV of one kv tile: a block per (kv tile, kv head, batch).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv(const Params p) {
  using C = Cfg<D>;
  constexpr int BR = C::BR, LD = C::LD, SP = C::SP, TR = C::TR, NC = C::NC;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BR * LD;
  float* sQ = sV + BR * LD;
  float* sdO = sQ + BR * LD;
  float* sP = sdO + BR * LD;
  float* sdS = sP + BR * SP;
  float* sLse = sdS + BR * SP;
  float* sDelta = sLse + BR;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * BR;  // causal: the first kv tiles see the most q tiles and start first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.Hq / p.Hkv;

  stage<T, D>(sK, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.Sk);
  stage<T, D>(sV, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.Sk);

  float dk[TR][NC], dv[TR][NC];
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[a][c] = dv[a][c] = 0.f;

  // causal (Sq == Sk): q rows below k0 see nothing of this tile
  const int q_begin = p.causal ? k0 : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* gO = static_cast<const T*>(p.dout) + b * p.d_sb + h * p.d_sh;
    for (int q0 = q_begin; q0 < p.Sq; q0 += BR) {
      __syncthreads();  // the previous tile's reads of sQ, sdO, sP, sdS are done
      stage<T, D>(sQ, q, p.q_ss, q0, p.Sq);
      stage<T, D>(sdO, gO, p.d_ss, q0, p.Sq);
      stage_rows(sLse, sDelta, p, size_t(b) * p.Hq + h, q0, BR);
      __syncthreads();
      score_tile<D>(p, sQ, sdO, sK, sV, sLse, sDelta, sP, sdS, q0, k0);
      __syncthreads();
      // thread (ty, tx): kv rows ty*TR + a, head-dim columns tx + 16 c
#pragma unroll 4
      for (int r = 0; r < BR; ++r) {
        float pv[TR], sv[TR], gv[NC], qv[NC];
#pragma unroll
        for (int a = 0; a < TR; ++a) {
          pv[a] = sP[r * SP + ty * TR + a];
          sv[a] = sdS[r * SP + ty * TR + a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          gv[c] = sdO[r * LD + tx + 16 * c];
          qv[c] = sQ[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[a][c] = fmaf(pv[a], gv[c], dv[a][c]);
            dk[a][c] = fmaf(sv[a], qv[c], dk[a][c]);
          }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int row = k0 + ty * TR + a;
    if (row >= p.Sk) continue;
    const size_t base = ((size_t(b) * p.Sk + row) * p.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      st(dk_out + base + tx + 16 * c, dk[a][c] * p.scale);
      st(dv_out + base + tx + 16 * c, dv[a][c]);
    }
  }
}

// dQ of one q tile: a block per (q tile, q head, batch).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq(const Params p) {
  using C = Cfg<D>;
  constexpr int BR = C::BR, LD = C::LD, SP = C::SP, TR = C::TR, NC = C::NC;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BR * LD;
  float* sK = sdO + BR * LD;
  float* sV = sK + BR * LD;
  float* sdS = sV + BR * LD;
  float* sLse = sdS + 2 * BR * SP;  // the layout of flash_bwd_dkdv; the P tile is not needed here
  float* sDelta = sLse + BR;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int n_qtiles = (p.Sq + BR - 1) / BR;
  const int q0 = (n_qtiles - 1 - int(blockIdx.x)) * BR;  // causal: the last q tiles see the most kv tiles
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  stage<T, D>(sQ, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.Sq);
  stage<T, D>(sdO, static_cast<const T*>(p.dout) + b * p.d_sb + h * p.d_sh, p.d_ss, q0, p.Sq);
  stage_rows(sLse, sDelta, p, size_t(b) * p.Hq + h, q0, BR);
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  float dq[TR][NC];
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[a][c] = 0.f;

  const int k_end = p.causal ? min(p.Sk, q0 + BR) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BR) {
    __syncthreads();  // the previous tile's reads of sK, sdS are done
    stage<T, D>(sK, k, p.k_ss, k0, p.Sk);
    stage<T, D>(sV, v, p.v_ss, k0, p.Sk);
    __syncthreads();
    score_tile<D>(p, sQ, sdO, sK, sV, sLse, sDelta, nullptr, sdS, q0, k0);
    __syncthreads();
    // thread (ty, tx): q rows ty*TR + a, head-dim columns tx + 16 c
#pragma unroll 4
    for (int c2 = 0; c2 < BR; ++c2) {
      float sv[TR], kv[NC];
#pragma unroll
      for (int a = 0; a < TR; ++a) sv[a] = sdS[(ty * TR + a) * SP + c2];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sK[c2 * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) dq[a][c] = fmaf(sv[a], kv[c], dq[a][c]);
    }
  }

  T* dq_out = static_cast<T*>(p.dq);
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int row = q0 + ty * TR + a;
    if (row >= p.Sq) continue;
    const size_t base = ((size_t(b) * p.Sq + row) * p.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) st(dq_out + base + tx + 16 * c, dq[a][c] * p.scale);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(C::SMEM));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (e != cudaSuccess) return int(e);
  const long long rows = (long long)p.B * p.Hq * p.Sq;
  if (rows > 0) {
    flash_bwd_delta<T, D><<<unsigned((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (p.Sk > 0) {  // with Sq == 0 the kernel writes dK = dV = 0
    flash_bwd_dkdv<T, D><<<dim3((p.Sk + C::BR - 1) / C::BR, p.Hkv, p.B), THREADS, C::SMEM, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (p.Sq > 0) {  // with Sk == 0 the kernel writes dQ = 0
    flash_bwd_dq<T, D><<<dim3((p.Sq + C::BR - 1) / C::BR, p.Hq, p.B), THREADS, C::SMEM, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
}

template <typename T>
int dispatch_dim(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  Strides in elements, (batch, seq, head) for q,
// k, v, o and dO in that order.  Launches three kernels on the stream.
// Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    void* dq, void* dk, void* dv, void* delta,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, int dtype,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long d_sb, long long d_ss, long long d_sh,
    float scale, int causal, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (causal && Sq != Sk)) return int(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0) return 0;
  const Params p{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,
                 B, Sq, Sk, Hq, Hkv,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, d_sb, d_ss, d_sh,
                 scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dim<float>(p, D, s);
    case 1: return dispatch_dim<__nv_bfloat16>(p, D, s);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
