// Mamba-2 SSD chunked scan forward for Hopper (sm_90a) in bf16: every product
// on the tensor cores (wgmma), the x, B and C tiles brought in by TMA.  Plain
// C interface.
//
// Replaces repro/kernels/ssd_scan.py::ssd_scan_pallas (the Pallas TPU kernel
// _ssd_kernel) for bf16, the training path's type.  Same function, the linear
// recurrence
//
//     h_t = exp(A·dt_t)·h_{t-1} + dt_t·(x_t ⊗ B_t),   y_t = C_t·h_t + D·x_t,
//
// computed in its chunked form over tiles of L = 64 rows, with cum the
// inclusive prefix of A·dt inside the tile:
//
//     intra-tile   y  = (tril(C Bᵀ) ⊙ exp(cum_t − cum_s) ⊙ dt_s) @ X
//     inter-tile   y += exp(cum_t) · (C @ hᵀ)
//     state        h  = exp(cum_L)·h + Xᵀ @ (B ⊙ exp(cum_L − cum_s)·dt_s)
//     skip         y += D·x
//
// fp32 inputs stay on the SIMT kernel (ssd_scan.cu): a TF32 product keeps ~10
// bits of mantissa and would miss the fp32 tolerance.
//
// Layout: x (B, S, H, P), dt (B, S, H), B and C (B, S, G, N), read through
// their strides (the last dimension contiguous; for x, B and C base and
// strides 16-byte aligned, as TMA needs: the wrapper checks); head h reads
// group h / (H/G) of B and C in place.  A, D (H,) and h0 (B, H, P, N) fp32
// and contiguous; y (B, S, H, P) bf16 contiguous, h_final (B, H, P, N) fp32.
// P in {64, 128} and N in {64, 128}: an x, B or C row is one or two 128-byte
// swizzled rows (one TMA box of 64 columns each).
//
// Design: the chunked-parallel form, in three kernels on one stream.
//   ssd_prep  one block per (batch, group, tile): C Bᵀ (m64n64, K = N), once
//             for all H/G heads of the group, written out in the accumulator's
//             fragment order; and one block per (batch, head, chunk of Q
//             tiles): the chunk's own state, h = exp(cum_L)·h + Xᵀ(B ⊙ w) from
//             h = 0 tile by tile, and the sum of its tiles' cum_L.
//   ssd_pass  one thread per 4 state values of one (batch, head): walks the
//             chunks in order in fp32, h_in[c] = h; h = exp(Σcum_L)·h +
//             local[c], from h0; writes each chunk's entering state and
//             h_final.  Its loads do not depend on h, so it runs at the rate
//             of the state bytes.
//   ssd_out   one block per (batch, head, chunk): from the entering state,
//             per tile y = exp(cum_t)·(C hᵀ) + M X with M = tril(C Bᵀ) ⊙
//             exp(cum_t − cum_s) ⊙ dt_s + diag(D) (the skip term rides on M's
//             diagonal), then, but for the chunk's last tile, the state
//             update as in ssd_prep.
// Q (tiles per chunk, 1 to 8) is the caller's (ssd_scan.tiles_per_chunk):
// it weighs the output kernel's waves (two blocks per SM at P = 64, one at
// P = 128, whose block needs ~178 KB of shared memory at N = 128) against the
// chunk states, 4·P·N bytes (32 KB at P = 64, N = 128) per (batch, head,
// chunk) written, passed on and read; 6 at train_4k's B=1, S=4096 (264
// blocks: one full wave), 2 at the training microbatch B=4, S=256 (192
// blocks).
//
// Every block holds P / 64 warpgroups (128 threads each): at P = 128 (jamba's
// SSM heads) warpgroup w owns state rows and y columns 64w..64w+63, reading
// the x tile's box w, while both read the same B and C tiles and build the
// same M fragment from the same C Bᵀ.  So a warpgroup's registers hold what
// they hold at P = 64 (the state fragment hs[N/64][32] beside the y
// accumulator), where one warpgroup over all 128 rows would hold twice the
// state and spill; this is how the flash backward splits D = 256.  The C Bᵀ
// blocks of ssd_prep use the first warpgroup only.  Thread 0 loads the tiles by
// TMA (64-column boxes, 128B swizzle, rows past S zero-filled, so the ragged
// last tile needs only dt = 0 past S, which keeps cum flat and w zero): a
// two-stage ring of x and B (prep) or x and C (out), and in the out kernel a
// single B tile, which the state update needs only at the end of a tile.
// The products, all m64n64k16 bf16 → fp32:
//   C Bᵀ   both K-major from shared memory (as flash's Q Kᵀ);
//   C hᵀ   C K-major, h as a K-major (p, n) tile the threads write to shared
//          memory from their fp32 state fragment, then fence to the async proxy;
//   M X    M from registers (its fragment comes from the C Bᵀ fragment, pair
//          for pair, as flash's P), X read transposed (MN-major) from the tile;
//   Xᵀ(B⊙w)  the weight rides on X: the A fragment (rows p, columns s) built
//          from the swizzled x tile in registers, B read transposed.
//
// Numerics.  wgmma takes bf16 operands; x, B and C are bf16 already, so C Bᵀ
// is exact up to fp32 summation.  M, x·w and the entering state h are fp32
// and each would lose ~2^-9 relative per term in one bf16 rounding, which
// puts h_final past SSD_H_REL (1e-3 relative L2) for x·w and outputs past
// the bf16 tolerance where large terms cancel for M and h.  So each is
// carried as hi = bf16(v) plus lo = bf16(v − hi), ~16 bits, and its product
// runs twice (hi, then lo); ref.ssd_tiled_ref rounds at the same points and
// the CPU tests show that each needs it.  The prefix cum of A·dt is summed
// in fp64 and the decays' arguments (cum_t − cum_s, cum_L − cum_s) taken
// from it before one rounding to fp32 (struct Decay): with fp32 prefixes,
// mamba2-130m's trained inputs put single outputs past the bf16 tolerance
// (ROADMAP queue 3, item 12).  The state passes between tiles and chunks in
// fp32; exponentials are exp2 of the log2(e)-scaled argument.
//
// What bounds it.  The function reads x, B, C, dt and writes y and h_final:
// bytes, against ~2L²N + 2L²P + 4LNP FLOPs per (batch, head, tile) at the
// tensor-core rate.  This design adds the chunk states' round trip (4·P·N
// bytes per item written, read, written and read) and C Bᵀ's (16 KB per
// tile), and
// runs each warpgroup's products in sequence.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int L = 64;             // rows per tile: one wgmma M
constexpr int WG = 128;           // threads of one warpgroup: 64 state rows (P) each
constexpr int STAGES = 2;         // tile ring depth
constexpr int BOX = 64 * 128;     // one TMA box: 64 rows of 64 bf16 columns, 128B-swizzled
constexpr int CB_FLOATS = L * L;  // one tile's C Bᵀ
constexpr float LOG2E = 1.4426950408889634f;

// One tile's decay terms in shared memory.  cum, the inclusive prefix of
// A·dt, is summed and kept in fp64: M and w take differences of two of its
// entries, which over a tile reach hundreds to thousands while their
// difference is a few units, and an fp32 prefix would carry its spacing
// there (1e-5 to 1e-3) as a relative error of exp(cum_t − cum_s), past what
// outputs where large terms cancel survive (ROADMAP queue 3, item 12).
struct Decay {
  double cum[L];
  double2 cum_pair[L / 2];  // (cum_s, cum_s+1) by column pair, for the M build
  float dt[L];
  float w[L];               // exp(cum_L − cum_s)·dt_s
  float2 dt_pair[L / 2];    // (dt_s, dt_s+1) by column pair
};
constexpr int DECAY_BYTES = int(sizeof(Decay));

template <int P, int N>
struct Cfg {
  static constexpr int NCH = N / 64;    // 64-column chunks of B, C and the state
  static constexpr int PW = P / 64;     // warpgroups of a block, and 64-column boxes of an x tile
  static constexpr int THREADS = PW * WG;
  static constexpr int BC = NCH * BOX;  // bytes of a B or C tile, and of one warpgroup's bf16 term of the state
  static constexpr int XT = PW * BOX;   // bytes of an x tile
  static constexpr int PREP_STAGE = XT + BC;  // x, B
  static constexpr int OUT_STAGE = XT + BC;   // x, C; the out kernel's B tile and state terms sit after the ring
  static constexpr size_t PREP_SMEM = 1024 + size_t(STAGES) * PREP_STAGE + DECAY_BYTES + 8 * STAGES;
  // the ring, the B tile, the hi and lo state terms of every warpgroup, dt / cum / w, the barriers
  static constexpr size_t OUT_SMEM =
      1024 + size_t(STAGES) * OUT_STAGE + BC + 2 * size_t(PW) * BC + DECAY_BYTES + 8 * (STAGES + 1);
  static_assert(P == 64 || P == 128, "head dim 64 or 128");
  static_assert(N == 64 || N == 128, "d_state 64 or 128");
  static_assert(2 * BC <= STAGES * PREP_STAGE, "a C Bᵀ item's C and B tiles fit the prep kernel's ring");
  static_assert(PREP_SMEM <= 232448 && OUT_SMEM <= 232448, "a block's shared memory fits an H100 SM's 227 KB");
};

struct Params {
  const float* dt;
  const float* A;
  const float* D;   // may be null: no skip term
  const float* h0;  // may be null: zero initial state
  void* y;
  float* h_out;
  float* cb;        // (B, G, n_tiles) x 4096: C Bᵀ per tile, fragment order
  float* local;     // (B, n_chunks, H, P, N): each chunk's own state
  float* enter;     // (B, n_chunks, H, P, N): the state entering each chunk
  float* logdecay;  // (B, n_chunks, H): Σ cum_L over the chunk's tiles
  int Bsz, S, H, G, n_tiles, tpc, n_chunks;
  long long dt_sb, dt_ss, dt_sh;  // strides in elements
};

// ---------------------------------------------------------------- operands
// K-major tile of 64-column chunks (C, B or the bf16 state), k-step kk (16
// columns), as flash's Q and K tiles
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024, 1);
}

// MN-major B operand (x or B read transposed): column chunk c, k-step j (16 rows)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int c, int j) {
  return make_desc(tile + c * BOX + j * 16 * 128, 1024, 1024, 1);
}

// byte offset of element (row, col) of a 128B-swizzled chunk of 2-byte values
__device__ __forceinline__ int swz(int row, int col) { return row * 128 + ((col * 2) ^ ((row & 7) << 4)); }

__device__ __forceinline__ float x_at(const uint8_t* sx, int s, int p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(sx + swz(s, p)));
}

// (v0, v1) as hi = bf16(v) and lo = bf16(v - hi), each a packed pair
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// warp of the thread within its warpgroup, and its warpgroup
__device__ __forceinline__ int wg_warp() { return (threadIdx.x >> 5) & 3; }
__device__ __forceinline__ int wg_index() { return threadIdx.x >> 7; }

// dt of one of the tile's rows (0 past S): threads 0..63 load row tid
__device__ __forceinline__ float load_dt(const float* dt, long long dt_ss, int rows) {
  const int tid = threadIdx.x;
  return tid < L && tid < rows ? dt[tid * dt_ss] : 0.f;
}

// exp(x) as exp2(x·log2 e): the fast exponent, ~2 ulp, far inside the
// two-term bf16 operands it feeds
__device__ __forceinline__ float fexp(float x) { return exp2f(x * LOG2E); }

// from each thread's dt (load_dt): cum = inclusive prefix of A·dt in fp64
// (two warp scans joined), w = exp(cum_L − cum)·dt and, for the M build,
// each column pair's cum and dt, in shared memory; all wait
__device__ __forceinline__ void tile_decay(float d, float A, Decay* sd) {
  const int tid = threadIdx.x;
  if (tid < L) {
    double run = double(A) * double(d);  // exact: two fp32 factors
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, run, off);
      if ((tid & 31) >= off) run += v;
    }
    sd->dt[tid] = d;
    sd->cum[tid] = run;
  }
  __syncthreads();
  if (tid >= 32 && tid < L) sd->cum[tid] += sd->cum[31];
  __syncthreads();
  if (tid < L) {
    const double c = sd->cum[tid];
    sd->w[tid] = fexp(float(sd->cum[L - 1] - c)) * d;
    reinterpret_cast<double*>(sd->cum_pair)[tid] = c;
    reinterpret_cast<float*>(sd->dt_pair)[tid] = d;
  }
  __syncthreads();
}

// A fragments of (X ⊙ w)ᵀ for the state product, rows p and columns s, as hi
// and lo terms, from the warpgroup's 64-column box sx of the x tile:
// register r of k-step j holds rows p0 + 8 (r & 1), columns
// 16 j + (lane % 4)·2 + 8 (r >> 1) and the next
__device__ __forceinline__ void xw_frags(const uint8_t* sx, const float* sW, uint32_t (&hi)[16],
                                         uint32_t (&lo)[16]) {
  const int lane = threadIdx.x & 31;
  const int p0 = wg_warp() * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + 8 * (r & 1);
      const int s = 16 * j + (lane & 3) * 2 + 8 * (r >> 1);
      split(x_at(sx, s, p) * sW[s], x_at(sx, s + 1, p) * sW[s + 1], hi[4 * j + r], lo[4 * j + r]);
    }
}

// h += Xᵀ (B ⊙ w) on the tensor cores, the state's fragments hs[c] over
// columns 64c..64c+63 of N
template <int N>
__device__ __forceinline__ void state_update(float (&hs)[N / 64][32], const uint8_t* sx, const float* sW,
                                             uint32_t sB) {
  uint32_t ah[16], al[16];
  xw_frags(sx, sW, ah, al);
#pragma unroll
  for (int c = 0; c < N / 64; ++c) pin(hs[c]);
  pin(ah);
  pin(al);
  wg_fence();
#pragma unroll
  for (int c = 0; c < N / 64; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t d = desc_mn(sB, c, j);
      wgmma_rs_n64(hs[c], ah + 4 * j, d);
      wgmma_rs_n64(hs[c], al + 4 * j, d);
    }
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int c = 0; c < N / 64; ++c) pin(hs[c]);
}

// Accumulator fragment of a wgmma m64n64 (fp32), value i of a thread: row
// warp*16 + lane/4 + 8*((i/2)%2), column (i/4)*8 + (lane%4)*2 + i%2, with
// warp the thread's warp within its warpgroup.
__device__ __forceinline__ int frag_row(int i) { return wg_warp() * 16 + ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int frag_col(int i) { return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1); }

// the state (P, N) of one item, fp32, natural layout, to / from its
// fragments: warpgroup w's rows 64w..64w+63
template <int N>
__device__ __forceinline__ void state_io(float (&hs)[N / 64][32], float* g, bool store) {
  g += wg_index() * 64 * N;
#pragma unroll
  for (int c = 0; c < N / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float2* at = reinterpret_cast<float2*>(g + frag_row(i) * N + c * 64 + frag_col(i));
      if (store) {
        *at = make_float2(hs[c][i], hs[c][i + 1]);
      } else {
        const float2 v = *at;
        hs[c][i] = v.x;
        hs[c][i + 1] = v.y;
      }
    }
}

__device__ __forceinline__ void init_bars(uint32_t bar) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// item index (batch, chunk, head) of the prep and out kernels, heads fastest
// so that neighbouring blocks share their B and C tiles in L2
struct Item {
  int b, c, h;
  __device__ Item(int item, const Params& p)
      : b(item / (p.H * p.n_chunks)), c((item / p.H) % p.n_chunks), h(item % p.H) {}
};

// ---------------------------------------------------------------- kernels
template <int P, int N>
__global__ void __launch_bounds__(2 * P) ssd_prep(const __grid_constant__ CUtensorMap tx,
                                                   const __grid_constant__ CUtensorMap tb,
                                                   const __grid_constant__ CUtensorMap tc, const Params p) {
  using T = Cfg<P, N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms need 1024-byte alignment
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  Decay* sd = reinterpret_cast<Decay*>(gbase + STAGES * T::PREP_STAGE);
  const uint32_t bar = base + STAGES * T::PREP_STAGE + DECAY_BYTES;
  const int tid = threadIdx.x;
  init_bars(bar);

  const int n_cb = p.Bsz * p.G * p.n_tiles;
  if (int(blockIdx.x) < n_cb) {  // C Bᵀ of one (batch, group, tile), by the first warpgroup
    if (tid >= WG) return;
    const int tile = blockIdx.x % p.n_tiles, g = (blockIdx.x / p.n_tiles) % p.G, b = blockIdx.x / (p.n_tiles * p.G);
    const uint32_t sC = base, sB = base + T::BC;
    if (tid == 0) {
      mbar_expect_tx(bar, 2 * T::BC);
      for (int c = 0; c < T::NCH; ++c) {
        tma_load(sC + c * BOX, &tc, bar, c * 64, tile * L, g, b);
        tma_load(sB + c * BOX, &tb, bar, c * 64, tile * L, g, b);
      }
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    mbar_wait(bar, 0);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) wgmma_ss_n64(acc, desc_k(sC, kk), desc_k(sB, kk));
    wg_commit();
    wg_wait0();
    pin(acc);
    float4* out = reinterpret_cast<float4*>(p.cb + (long long)blockIdx.x * CB_FLOATS);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k * WG + tid] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
    return;
  }

  // the own state of one (batch, head, chunk), from h = 0
  const int item = blockIdx.x - n_cb;
  const Item it_(item, p);
  const int g = it_.h / (p.H / p.G);
  const int q0 = it_.c * p.tpc, nq = min(p.tpc, p.n_tiles - q0);
  const float A = p.A[it_.h];
  const float* dt = p.dt + it_.b * p.dt_sb + it_.h * p.dt_sh;
  auto load = [&](int s, int q) {
    const uint32_t st = base + s * T::PREP_STAGE;
    mbar_expect_tx(bar + 8 * s, T::XT + T::BC);
    for (int w = 0; w < T::PW; ++w) tma_load(st + w * BOX, &tx, bar + 8 * s, w * 64, q * L, it_.h, it_.b);
    for (int c = 0; c < T::NCH; ++c) tma_load(st + T::XT + c * BOX, &tb, bar + 8 * s, c * 64, q * L, g, it_.b);
  };
  if (tid == 0)
    for (int s = 0; s < STAGES && s < nq; ++s) load(s, q0 + s);

  float hs[T::NCH][32];
#pragma unroll
  for (int c = 0; c < T::NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) hs[c][i] = 0.f;
  double logd = 0.0;
  for (int it = 0; it < nq; ++it) {
    const int s = it % STAGES;
    const int t0 = (q0 + it) * L;
    tile_decay(load_dt(dt + (long long)t0 * p.dt_ss, p.dt_ss, p.S - t0), A, sd);
    const float decay = fexp(float(sd->cum[L - 1]));
    logd += sd->cum[L - 1];
#pragma unroll
    for (int c = 0; c < T::NCH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) hs[c][i] *= decay;
    mbar_wait(bar + 8 * s, (it / STAGES) & 1);
    state_update<N>(hs, gbase + s * T::PREP_STAGE + wg_index() * BOX, sd->w, base + s * T::PREP_STAGE + T::XT);
    __syncthreads();  // every warp is done with stage s and with dt / cum / w
    if (tid == 0 && it + STAGES < nq) load(s, q0 + it + STAGES);
  }
  state_io<N>(hs, p.local + (long long)item * P * N, true);
  if (tid == 0) p.logdecay[item] = float(logd);
}

// one thread per 4 consecutive state values of one (batch, head)
__global__ void ssd_pass(const Params p, int P, int N) {
  const int per_head = P * N / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)p.Bsz * p.H * per_head) return;
  const int e = idx % per_head, h = (idx / per_head) % p.H, b = idx / ((long long)per_head * p.H);
  const long long hb = ((long long)b * p.H + h) * P * N;
  float4 v = p.h0 != nullptr ? reinterpret_cast<const float4*>(p.h0 + hb)[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* __restrict__ local = reinterpret_cast<const float4*>(p.local);
  float4* __restrict__ enter = reinterpret_cast<float4*>(p.enter);
#pragma unroll 4
  for (int c = 0; c < p.n_chunks; ++c) {
    const long long item = ((long long)b * p.n_chunks + c) * p.H + h;
    const float4 loc = local[item * per_head + e];
    const float d = fexp(p.logdecay[item]);
    enter[item * per_head + e] = v;
    v = make_float4(d * v.x + loc.x, d * v.y + loc.y, d * v.z + loc.z, d * v.w + loc.w);
  }
  reinterpret_cast<float4*>(p.h_out + hb)[e] = v;
}

template <int P, int N>
__global__ void __launch_bounds__(2 * P) ssd_out(const __grid_constant__ CUtensorMap tx,
                                                  const __grid_constant__ CUtensorMap tb,
                                                  const __grid_constant__ CUtensorMap tc, const Params p) {
  using T = Cfg<P, N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  // the B tile, then the state's hi terms of every warpgroup, then its lo terms
  const uint32_t sB = base + STAGES * T::OUT_STAGE, sHhi = sB + T::BC, sHlo = sHhi + T::PW * T::BC;
  Decay* sd = reinterpret_cast<Decay*>(gbase + (sHlo + T::PW * T::BC - base));
  const uint32_t bar = sHlo + T::PW * T::BC + DECAY_BYTES;  // STAGES ring barriers
  const uint32_t bar_b = bar + 8 * STAGES;                 // the B tile's
  const int tid = threadIdx.x;
  const int wg = wg_index();
  const uint32_t myHhi = sHhi + wg * T::BC, myHlo = sHlo + wg * T::BC;  // this warpgroup's state terms
  if (tid == 0) mbar_init(bar_b, 1);
  init_bars(bar);

  const int item = blockIdx.x;
  const Item it_(item, p);
  const int g = it_.h / (p.H / p.G);
  const int q0 = it_.c * p.tpc, nq = min(p.tpc, p.n_tiles - q0);
  const float A = p.A[it_.h];
  const float Dh = p.D != nullptr ? p.D[it_.h] : 0.f;
  const float* dt = p.dt + it_.b * p.dt_sb + it_.h * p.dt_sh;
  // x and C of every tile through the ring; B, single-buffered, only for the
  // tiles whose state moves on to a next tile of the chunk (it < nq - 1):
  // B of tile it + 1 loads while tile it + 1 computes its y
  auto load = [&](int s, int it) {
    const uint32_t st = base + s * T::OUT_STAGE;
    mbar_expect_tx(bar + 8 * s, T::XT + T::BC);
    for (int w = 0; w < T::PW; ++w) tma_load(st + w * BOX, &tx, bar + 8 * s, w * 64, (q0 + it) * L, it_.h, it_.b);
    for (int c = 0; c < T::NCH; ++c)
      tma_load(st + T::XT + c * BOX, &tc, bar + 8 * s, c * 64, (q0 + it) * L, g, it_.b);
  };
  auto load_b = [&](int it) {
    mbar_expect_tx(bar_b, T::BC);
    for (int c = 0; c < T::NCH; ++c) tma_load(sB + c * BOX, &tb, bar_b, c * 64, (q0 + it) * L, g, it_.b);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES && s < nq; ++s) load(s, s);
    if (nq > 1) load_b(0);
  }

  float hs[T::NCH][32];
  state_io<N>(hs, p.enter + (long long)item * P * N, false);
  const int r0 = frag_row(0);
  // this warpgroup's 64 columns of y
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y) + (long long)it_.b * p.S * p.H * P + (long long)it_.h * P + wg * 64;

  // a tile's dt and C Bᵀ (in the accumulator's fragment order) are loaded
  // one tile ahead, so that their latency hides behind the tile before
  const float4* cb = reinterpret_cast<const float4*>(p.cb + (long long)(it_.b * p.G + g) * p.n_tiles * CB_FLOATS);
  auto load_cb = [&](int q, float4 (&v)[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = cb[(long long)q * (CB_FLOATS / 4) + k * WG + (tid & (WG - 1))];
  };
  float4 cb_next[8];
  load_cb(q0, cb_next);
  float dt_next = load_dt(dt + (long long)q0 * L * p.dt_ss, p.dt_ss, p.S - q0 * L);

  for (int it = 0; it < nq; ++it) {
    const int s = it % STAGES;
    const int q = q0 + it, t0 = q * L, rows = min(L, p.S - t0);
    const uint32_t sX = base + s * T::OUT_STAGE, sC = sX + T::XT;
    const uint32_t myX = sX + wg * BOX;  // this warpgroup's 64 columns of the x tile

    float cbv[32];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cbv[4 * k] = cb_next[k].x;
      cbv[4 * k + 1] = cb_next[k].y;
      cbv[4 * k + 2] = cb_next[k].z;
      cbv[4 * k + 3] = cb_next[k].w;
    }
    const float d = dt_next;
    if (it + 1 < nq) {
      load_cb(q + 1, cb_next);
      dt_next = load_dt(dt + (long long)(t0 + L) * p.dt_ss, p.dt_ss, p.S - t0 - L);
    }
    tile_decay(d, A, sd);

    // the entering state as K-major (p, n) bf16 tiles, hi and lo terms, each
    // warpgroup its own 64 rows
#pragma unroll
    for (int c = 0; c < T::NCH; ++c)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int off = c * BOX + swz(frag_row(i), frag_col(i));
        uint32_t hi, lo;
        split(hs[c][i], hs[c][i + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(gbase + (myHhi - base) + off) = hi;
        *reinterpret_cast<uint32_t*>(gbase + (myHlo - base) + off) = lo;
      }
    fence_async_shared();
    __syncthreads();
    mbar_wait(bar + 8 * s, (it / STAGES) & 1);

    // y = exp(cum_t) · (C hᵀ)
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      wgmma_ss_n64(acc, desc_k(sC, kk), desc_k(myHhi, kk));
      wgmma_ss_n64(acc, desc_k(sC, kk), desc_k(myHlo, kk));
    }
    wg_commit();
    wg_wait0();
    pin(acc);
    const double c0 = sd->cum[r0], c1 = sd->cum[r0 + 8];
    const float e0 = fexp(float(c0)), e1 = fexp(float(c1));
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= (i >> 1) & 1 ? e1 : e0;

    // y += M X, M = tril(C Bᵀ) ⊙ exp(cum_t − cum_s) ⊙ dt_s + diag(D), masked
    // before exp; value i of the fragment is row r0 + 8 ((i / 2) % 2) and
    // column pair 4 (i / 4) + lane % 4, whose cum and dt come in one double2
    // and one float2; cum_t − cum_s is taken in fp64 and rounded once
    uint32_t ma[16], mb[16];
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const double2 cs = sd->cum_pair[g * 4 + (tid & 3)];  // (cum_s, cum_s+1)
      const float2 ds = sd->dt_pair[g * 4 + (tid & 3)];    // (dt_s, dt_s+1)
      const int s0 = frag_col(4 * g);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * g + 2 * r, t = r0 + 8 * r;
        const double ct = r ? c1 : c0;
        float m0 = s0 <= t ? cbv[i] * fexp(float(ct - cs.x)) * ds.x : 0.f;
        float m1 = s0 + 1 <= t ? cbv[i + 1] * fexp(float(ct - cs.y)) * ds.y : 0.f;
        if (s0 == t) m0 += Dh;
        if (s0 + 1 == t) m1 += Dh;
        split(m0, m1, ma[i >> 1], mb[i >> 1]);
      }
    }
    pin(acc);
    pin(ma);
    pin(mb);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t d = desc_mn(myX, 0, j);
      wgmma_rs_n64(acc, ma + 4 * j, d);
      wgmma_rs_n64(acc, mb + 4 * j, d);
    }
    wg_commit();
    wg_wait0();
    pin(acc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r0 + 8 * r;
      if (t >= rows) continue;
      __nv_bfloat16* row = y + (long long)(t0 + t) * p.H * P;
#pragma unroll
      for (int gq = 0; gq < 8; ++gq) {
        const int i = gq * 4 + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(row + frag_col(i)) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    }

    if (it + 1 < nq) {  // the state entering the next tile of this chunk
      const float decay = fexp(float(sd->cum[L - 1]));
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) hs[c][i] *= decay;
      mbar_wait(bar_b, it & 1);
      state_update<N>(hs, gbase + (myX - base), sd->w, sB);
    }
    __syncthreads();  // every warp is done with stage s, the B tile, the state terms and dt / cum / w
    if (tid == 0) {
      if (it + STAGES < nq) load(s, it + STAGES);
      if (it + 2 < nq) load_b(it + 1);
    }
  }
}

// ---------------------------------------------------------------- host side
template <int P, int N>
int launch(const void* x, const void* Bm, const void* Cm, const Params& p, const long long* st, cudaStream_t stream) {
  using T = Cfg<P, N>;
  const int n_items = p.Bsz * p.H * p.n_chunks;
  CUtensorMap tx{}, tb{}, tc{};
  if (n_items > 0) {
    int err = make_map(&tx, x, P, p.S, p.H, p.Bsz, st[1], st[2], st[0], 64, L, 128);
    if (err == 0) err = make_map(&tb, Bm, N, p.S, p.G, p.Bsz, st[4], st[5], st[3], 64, L, 128);
    if (err == 0) err = make_map(&tc, Cm, N, p.S, p.G, p.Bsz, st[7], st[8], st[6], 64, L, 128);
    if (err != 0) return err;
    cudaError_t e =
        cudaFuncSetAttribute(ssd_prep<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::PREP_SMEM));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_out<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::OUT_SMEM));
    if (e != cudaSuccess) return int(e);
    ssd_prep<P, N><<<p.Bsz * p.G * p.n_tiles + n_items, T::THREADS, T::PREP_SMEM, stream>>>(tx, tb, tc, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
  }
  const long long pass_threads = (long long)p.Bsz * p.H * P * N / 4;
  ssd_pass<<<int((pass_threads + 255) / 256), 256, 0, stream>>>(p, P, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_items == 0) return int(e);
  ssd_out<P, N><<<n_items, T::THREADS, T::OUT_SMEM, stream>>>(tx, tb, tc, p);
  return int(cudaGetLastError());
}

}  // namespace

// bf16 x, B, C and y; P 64 or 128, N 64 or 128.  Scratch (fp32, the caller's):
// cb (B, G, n_tiles, 64, 64), local and enter (B, n_chunks, H, P, N),
// logdecay (B, n_chunks, H), with n_tiles = ceil(S / 64) and n_chunks =
// ceil(n_tiles / tiles_per_chunk).  h0 and h_out 16-byte aligned.  Strides in
// elements.  Returns 0, a cudaError_t (> 0), or a negated CUresult of the
// tensor-map encoding (< 0); repro_ssd_wgmma_error_string names it.
extern "C" int repro_ssd_scan_fwd_wgmma(
    const void* x, const float* dt, const float* A, const void* Bm, const void* Cm, const float* D,
    const float* h0, void* y, float* h_out, float* cb, float* local, float* enter, float* logdecay,
    int B, int S, int H, int G, int P, int N, int tiles_per_chunk,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    void* stream) {
  if (G <= 0 || H % G != 0 || (P != 64 && P != 128) || (N != 64 && N != 128) || tiles_per_chunk < 1 || S < 0)
    return int(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const int n_tiles = (S + L - 1) / L;
  const Params p{dt, A, D, h0, y, h_out, cb, local, enter, logdecay,
                 B, S, H, G, n_tiles, tiles_per_chunk, (n_tiles + tiles_per_chunk - 1) / tiles_per_chunk,
                 dt_sb, dt_ss, dt_sh};
  const long long st[9] = {x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64) return N == 64 ? launch<64, 64>(x, Bm, Cm, p, st, s) : launch<64, 128>(x, Bm, Cm, p, st, s);
  return N == 64 ? launch<128, 64>(x, Bm, Cm, p, st, s) : launch<128, 128>(x, Bm, Cm, p, st, s);
}

extern "C" const char* repro_ssd_wgmma_error_string(int err) { return hopper::error_string(err); }
