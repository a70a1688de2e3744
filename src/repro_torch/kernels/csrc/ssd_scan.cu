// Mamba-2 SSD chunked scan forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces repro/kernels/ssd_scan.py::ssd_scan_pallas (the Pallas TPU kernel
// _ssd_kernel).  Same function, the linear recurrence
//
//     h_t = exp(A·dt_t)·h_{t-1} + dt_t·(x_t ⊗ B_t),   y_t = C_t·h_t + D·x_t
//
// computed in its chunked form over tiles of L rows:
//
//     intra-tile   y  = (tril(C Bᵀ) ⊙ exp(cum_t − cum_s) ⊙ dt_s) @ X
//     inter-tile   y += exp(cum_t) · (C @ hᵀ)
//     state        h  = exp(cum_L)·h + Xᵀ @ (B ⊙ exp(cum_L − cum_s)·dt_s)
//     skip         y += D·x
//
// with cum the inclusive prefix sum of A·dt inside the tile.  The s > t
// entries are masked before exp, as the TPU kernel does.
//
// Layout: x (B, S, H, P), dt (B, S, H), B and C (B, S, G, N), all read
// through their strides (the last dimension of x, B and C contiguous), so
// the caller transposes nothing; head h reads group h / (H/G) of B and C,
// which are never expanded in memory.  A, D (H,) and h0 (B, H, P, N) are
// fp32 and contiguous; x, B, C are fp32 or bf16; y (B, S, H, P) contiguous
// comes out in x's type, h_final (B, H, P, N) in fp32.
//
// Design.  The TPU kernel runs the chunks as the innermost, sequential grid
// dimension and carries the (P, N) state in VMEM scratch.  CUDA blocks run
// in no order, so here one thread block owns one (batch, head, slice of up
// to 32 state rows p) and walks the sequence's tiles itself, with its slice
// of the state in shared memory; rows p of the state are independent given
// dt, B and C, so splitting P adds blocks (the training microbatch has only
// B·H = 96 (b, h) pairs for 132 SMs) at the cost of computing C Bᵀ once per
// slice.  The tile is 64 rows whatever the caller's chunk: a 256-row chunk
// of B and C in fp32 at N = 128 is 256 KB, over the 227 KB a block may use,
// while a 64-row tile needs 108 KB (B, C 64.5 KB, x 8 KB, the masked L×L
// tile 16.3 KB, the state slice 16.1 KB).  Rows past S in the last tile are
// read as zeros with dt = 0, which adds nothing to the state and leaves
// cum flat, so any S works and nothing is padded in memory.  Shared rows of
// B, C and the state are padded to an odd stride so that the threads of a
// warp that read different rows at one column hit different banks.
//
// What bounds it.  The work itself (2L²N + 2L²P + 4LNP per tile and head)
// is small against the bytes it moves, so the function is bound by bytes;
// this first kernel does all three products as fp32 FMAs from shared memory
// on the CUDA cores and recomputes C Bᵀ per state slice, so it is bound by
// shared-memory reads and FMA issue.  wgmma on the three products, TMA for
// the tiles, and a scan across tiles in parallel are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int L = 64;         // rows per tile
constexpr int PB = 32;        // state rows p per block (at most)
constexpr int THREADS = 256;  // 16 x 16 threads in the C Bᵀ product
constexpr int TR = 4;         // tile rows t per thread in C Bᵀ (L / 16)
constexpr int TC = 4;         // tile columns s per thread in C Bᵀ (L / 16)

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
  int S, H, G, P, N, pb;
  long long x_sb, x_ss, x_sh;  // strides in elements
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ __forceinline__ int odd_stride(int n) { return n | 1; }

__host__ __device__ __forceinline__ size_t smem_floats(int N, int pb) {
  const int ns = odd_stride(N);
  return size_t(2) * L * ns      // B, C tiles
         + size_t(L) * pb        // x tile
         + size_t(L) * (L + 1)   // masked, decayed C Bᵀ tile
         + size_t(pb) * ns       // state slice
         + size_t(3) * L;        // dt, cum, state weights
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int N = p.N, pb = p.pb, ns = odd_stride(N);
  float* sB = smem;               // L x ns
  float* sC = sB + L * ns;        // L x ns
  float* sX = sC + L * ns;        // L x pb
  float* sM = sX + L * pb;        // L x (L + 1)
  float* sH = sM + L * (L + 1);   // pb x ns
  float* sDt = sH + pb * ns;      // L
  float* sCum = sDt + L;          // L
  float* sW = sCum + L;           // L: exp(cum_L - cum_s) * dt_s

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int p0 = blockIdx.x * pb;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int pw = min(pb, p.P - p0);  // valid state rows in this block

  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* Bg = static_cast<const T*>(p.Bm) + b * p.b_sb + g * p.b_sg;
  const T* Cg = static_cast<const T*>(p.Cm) + b * p.c_sb + g * p.c_sg;
  T* y = static_cast<T*>(p.y) + (long long)b * p.S * p.H * p.P + (long long)h * p.P + p0;
  const long long y_ss = (long long)p.H * p.P;
  const float A = p.A[h];
  const float Dh = p.D != nullptr ? p.D[h] : 0.f;

  const long long h_base = ((long long)b * p.H + h) * p.P * N + (long long)p0 * N;
  for (int i = tid; i < pb * N; i += THREADS) {
    const int r = i / N, n = i % N;
    sH[r * ns + n] = (p.h0 != nullptr && r < pw) ? p.h0[h_base + (long long)r * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < p.S; t0 += L) {
    const int rows = min(L, p.S - t0);
    __syncthreads();  // the previous tile's reads of sB / sC / sX / sW are done
    for (int i = tid; i < L * N; i += THREADS) {
      const int t = i / N, n = i % N;
      const bool ok = t < rows;
      sB[t * ns + n] = ok ? to_f32(Bg[(t0 + t) * p.b_ss + n]) : 0.f;
      sC[t * ns + n] = ok ? to_f32(Cg[(t0 + t) * p.c_ss + n]) : 0.f;
    }
    for (int i = tid; i < L * pb; i += THREADS) {
      const int t = i / pb, r = i % pb;
      sX[i] = (t < rows && r < pw) ? to_f32(x[(t0 + t) * p.x_ss + r]) : 0.f;
    }
    for (int t = tid; t < L; t += THREADS) sDt[t] = t < rows ? dt[(t0 + t) * p.dt_ss] : 0.f;
    __syncthreads();
    if (tid == 0) {  // 64 dependent adds: cheap beside the products below
      float run = 0.f;
      for (int t = 0; t < L; ++t) {
        run += A * sDt[t];
        sCum[t] = run;
      }
    }
    __syncthreads();
    for (int t = tid; t < L; t += THREADS) sW[t] = expf(sCum[L - 1] - sCum[t]) * sDt[t];

    // ---- C Bᵀ, masked (s <= t) before exp, times decay and dt_s ----------
    {
      float acc[TR][TC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[TR], bv[TC];
#pragma unroll
        for (int i = 0; i < TR; ++i) cv[i] = sC[(ty * TR + i) * ns + n];
#pragma unroll
        for (int j = 0; j < TC; ++j) bv[j] = sB[(tx + 16 * j) * ns + n];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int t = ty * TR + i;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int s = tx + 16 * j;
          sM[t * (L + 1) + s] = s <= t ? acc[i][j] * expf(sCum[t] - sCum[s]) * sDt[s] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = M @ X + exp(cum_t) (C @ hᵀ) + D x, from the state entering the tile
    for (int i = tid; i < L * pb; i += THREADS) {
      const int t = i / pb, r = i % pb;
      if (t >= rows || r >= pw) continue;
      float intra = 0.f;
      for (int s = 0; s <= t; ++s) intra = fmaf(sM[t * (L + 1) + s], sX[s * pb + r], intra);
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(sC[t * ns + n], sH[r * ns + n], inter);
      const float out = intra + expf(sCum[t]) * inter + Dh * sX[t * pb + r];
      y[(t0 + t) * y_ss + r] = from_f32<T>(out);
    }
    __syncthreads();  // every read of the entering state is done

    // ---- h = exp(cum_L) h + Xᵀ @ (B ⊙ w) ------------------------------------
    const float decay = expf(sCum[L - 1]);
    for (int i = tid; i < pb * N; i += THREADS) {
      const int r = i / N, n = i % N;
      float acc = sH[r * ns + n] * decay;
      for (int s = 0; s < rows; ++s) acc = fmaf(sX[s * pb + r] * sW[s], sB[s * ns + n], acc);
      sH[r * ns + n] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < pw * N; i += THREADS) {
    const int r = i / N, n = i % N;
    p.h_out[h_base + (long long)r * N + n] = sH[r * ns + n];
  }
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_floats(p.N, p.pb) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.P + p.pb - 1) / p.pb, p.H, B);
  ssd_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16.  D and h0 may be null.
// Returns a cudaError_t (0 on success).
extern "C" int repro_ssd_scan_fwd(
    const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
    const float* D, const float* h0, void* y, float* h_out, int dtype,
    int B, int S, int H, int G, int P, int N,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    void* stream) {
  if (G <= 0 || H % G != 0 || P <= 0 || N <= 0 || N > 256) return int(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const Params p{x, dt, A, Bm, Cm, D, h0, y, h_out, S, H, G, P, N, P < PB ? P : PB,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* repro_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
