// Flash attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (the
// Pallas TPU kernel _flash_kernel).  Same function: softmax(q k^T * scale) v
// per query head, kv head h / group (GQA without expanding K/V), causal or
// not, the online softmax's running max, denominator and accumulator in
// fp32, a row that sees no key gives 0.
//
// Layout: q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), out (B, Sq, Hq, D), all
// read and written through their strides (the last dimension contiguous),
// so the caller needs no transposes.  fp32 or bf16 in, the same type out.
//
// Design.  The TPU kernel walks the kv blocks as the innermost, sequential
// grid dimension and carries m, l and acc in VMEM scratch between grid
// steps.  CUDA blocks run in no order, so here one thread block owns one
// (batch, query head, 64-row query tile) and loops over 64-column kv tiles
// itself, stopping at the causal diagonal.  The query tile and each K/V
// tile are staged in shared memory as fp32; 256 threads form a 16 x 16 grid
// in which each thread holds 4 query rows x 4 score columns of the 64 x 64
// score tile and 4 rows x D/16 columns of the output accumulator, all in
// registers.  The 16 threads that share a row (one half-warp) reduce its
// max and denominator with shuffles.  The ragged Sk edge and the causal
// diagonal are masked in the kernel; nothing is padded in memory.
//
// What bounds it.  Both products run as fp32 FMAs on the CUDA cores, not on
// the tensor cores, so the kernel is bound by operations at the fp32 FMA
// rate (and by shared-memory reads, 8 loads per 16 FMAs in q k^T), far from
// the bf16 tensor-core peak that bounds the work itself.  That keeps fp32
// inputs exact to the reference's tolerance.  Moving the products onto
// wgmma with TMA-fed K/V tiles is the next step for this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv columns per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TR = 4;         // query rows per thread (BQ / 16)
constexpr int TC = 4;         // score columns per thread (BK / 16)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, Hq, Hkv;
  long long q_sb, q_ss, q_sh;  // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_floats() {
  // sQ and sK rows padded by one float so that the 16 threads reading 16
  // different rows at the same d fall into 16 different banks
  return size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D + size_t(BQ) * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                    // BQ x (D + 1)
  float* sK = sQ + BQ * (D + 1);       // BK x (D + 1)
  float* sV = sK + BK * (D + 1);       // BK x D
  float* sP = sV + BK * D;             // BQ x (BK + 1)

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*TR .. ty*TR+TR-1
  const int tx = tid & 15;  // score columns and output columns tx + 16*j
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal tiles start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    sQ[r * (D + 1) + d] = row < p.Sq ? to_f32(q[row * p.q_ss + d]) : 0.f;
  }

  float acc[TR][NC];
  float m[TR], l[TR];  // running max (shared by the row's 16 threads), partial denominator
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const int col = k0 + c;
      const bool ok = col < p.Sk;
      sK[c * (D + 1) + d] = ok ? to_f32(k[col * p.k_ss + d]) : 0.f;
      sV[c * D + d] = ok ? to_f32(v[col * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[TR], kv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = sQ[(ty * TR + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) kv[j] = sK[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + ty * TR + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < p.Sk && (!p.causal || col <= row);
        s[i][j] = ok ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing visible yet keeps m = -inf: take 0 as its shift
      // so that exp gives 0 instead of nan
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - shift);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float pj = expf(s[i][j] - shift);
        sP[(ty * TR + i) * (BK + 1) + tx + 16 * j] = pj;
        rs += pj;
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[TR], vv[NC];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = sP[(ty * TR + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + ty * TR + i;
    if (row < p.Sq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float val = lt == 0.f ? 0.f : acc[i][c] / lt;  // fully masked row → 0
        o[row * p.o_ss + tx + 16 * c] = from_f32<T>(val);
      }
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return int(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  const Params p{q, k, v, o, Sq, Sk, Hq, Hkv,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dim<float>(p, B, D, s);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16>(p, B, D, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
