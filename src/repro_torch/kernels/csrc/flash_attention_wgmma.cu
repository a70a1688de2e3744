// Flash attention forward for Hopper (sm_90a) in bf16: both products on the
// tensor cores (wgmma), the Q, K and V tiles brought in by TMA.  Plain C
// interface.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (the
// Pallas TPU kernel _flash_kernel) for bf16, the serving path's type.  Same
// function: softmax(q k^T * scale) v per query head, kv head h / group (GQA
// read in place, no expanded K/V), causal or not, with or without a prefix-LM
// prefix (causal only: every row also sees the first prefix_len keys, as
// paligemma's vision tokens are seen), the ragged Sk edge masked, the online softmax's running max, denominator and accumulator in
// fp32, a row that sees no key gives 0.  fp32 inputs stay on the SIMT kernel
// (flash_attention.cu): a TF32 product keeps ~10 bits of mantissa and would
// miss the fp32 tolerance (2e-5) the fp32 checks hold the kernel to.
//
// Layout: q (B, Sq, Hq, DQK), k (B, Sk, Hkv, DQK), v (B, Sk, Hkv, DV), out
// (B, Sq, Hq, DV), read and written through their strides (the head dim
// contiguous; base and strides 16-byte aligned, as TMA needs: the wrapper
// checks).  (DQK, DV) in (32, 32), (64, 64), (128, 128), (256, 256) and
// (192, 128), MLA's prefill (deepseek-v2: 128 + 64 rope columns of q and k,
// 128 of v).  With a non-null lse pointer
// each row also writes its logsumexp, lse (B, Hq, Sq) fp32, in natural log
// (the softmax runs in base 2: lse = (m + log2 l) * ln 2), +inf for a row
// that sees no key; the backward (flash_attention_bwd.cu) recomputes P
// from it (the tensor-core backward, flash_attention_bwd_wgmma.cu, at D up
// to 128; the SIMT one at D = 256).  Serving's prefill passes null and
// writes nothing.
//
// Design.  One block of one warpgroup (128 threads) owns one (query head,
// 64-row query tile, batch) and walks 64-column kv tiles to the causal
// diagonal (or to the end of the prefix, if that lies further); blockIdx.x
// is the head, so the first wave holds every head's longest causal tiles
// (a prefix lengthens only the tiles above it, and only up to its end, so
// the last tiles still walk furthest).  Thread 0 loads the Q tile and a ring of STAGES K/V
// tiles by TMA (cp.async.bulk.tensor, 4-d tensor maps over the strided
// inputs, one full mbarrier per tile), so the next tile's copy overlaps
// this tile's products.  Per kv tile:
//   S = Q K^T   wgmma m64n64k16, Q and K both K-major in shared memory;
//   mask + online softmax on the fp32 accumulator fragment in registers
//               (the causal diagonal, past the prefix, and the ragged edge
//               from each value's row and column; TMA zero-fills rows past Sk, so they must
//               be masked or a zero could win a row's max);
//   P -> bf16   in registers, as two terms hi + lo (below): the accumulator
//               fragment of S is, pair for pair, the A fragment of the next
//               product, so P never touches shared memory;
//   O += P V    wgmma m64nNk16 with A from registers (hi, then lo) and V as
//               B read transposed from shared memory (MN-major, allowed for
//               16-bit types).
//
// Numerics.  One bf16 rounding of P (8 bits) is not enough: at deepseek-7b
// full width, whose attention is near one-hot with |v| up to ~60, outputs
// of ~0 where two keys' p v nearly cancel land up to 1.3x past the bf16
// tolerance (atol 2e-2, rtol 1e-2) against the fp32-P plain version, in
// every layer (scripts/flash_p_rounding.py counts them).  So P is carried
// as hi = bf16(p) plus lo = bf16(p - hi), ~16 bits, and O += hi V + lo V:
// twice the P V products, on tensor cores that this kernel leaves mostly
// idle.  V and the scores need no such care (V is bf16 already; S
// accumulates in fp32).
//
// Shared memory is 128-byte swizzled (64-byte for D = 32), the tiles of
// flash_tile.cuh: a D = 128 tile is two 64-column chunks, each one TMA box,
// a D = 256 tile four.  At D = 256 (gemma-7b, paligemma-3b) Q and the
// two-stage K/V ring take 1,024 + 5 x 32,768 + 40 = 164,904 bytes of the
// 232,448 a block may have; what it strains is registers: the 64 x 256 fp32
// accumulator is 128 a thread, beside 32 for the scores and 32 for P's two
// terms.  Q and K tiles are DQK wide and V and O DV wide, so at (192, 128)
// S = Q K^T runs 12 k-steps over three 64-column chunks of Q and K, O += P V
// two 64-column output blocks over V's two chunks, and Q and the ring take
// 1,024 + 3 x 24,576 + 2 x 16,384 + 40 = 107,560 bytes.
//
// What bounds it.  The work is bound by bytes at these shapes (each of q, k,
// v, out moved once: 8 B H S D bytes against 2 B H S^2 D causal FLOPs at the
// bf16 tensor-core rate).  This first version keeps each warpgroup's
// products and its softmax in sequence (no producer warp, no ping-pong of
// two warpgroups, no persistent grid), so a block's time is its chain of
// kv tiles; room is left for those: the ring and its barriers are what a
// producer warp would drive.

#include <math.h>

#include "flash_tile.cuh"

namespace {

using namespace flash;

constexpr int BQ = ROWS;      // query rows per block (one wgmma M)
constexpr int BK = ROWS;      // kv columns per tile
constexpr int STAGES = 2;     // K/V ring depth
constexpr int THREADS = 128;  // one warpgroup

// Q, the K/V ring and their barriers, from a 1024-byte boundary
template <int DQK, int DV>
constexpr size_t smem_bytes() {
  return 1024 + size_t(1 + STAGES) * Tile<DQK>::TILE_BYTES + size_t(STAGES) * Tile<DV>::TILE_BYTES +
         8 * (1 + 2 * STAGES);
}

struct Params {
  void* o;
  float* lse;  // (B, Hq, Sq), or null: not written
  int Sq, Sk, Hq, Hkv;
  long long o_sb, o_ss, o_sh;  // strides in elements
  float scale_log2;            // scale * log2(e): the softmax runs in base 2
  int causal;
  int prefix;  // causal: keys [0, prefix) are visible to every row
  int n_qtiles;
};

// one 64-row tile, D columns, on its own barrier
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int row, int head,
                                          int batch) {
  mbar_expect_tx(bar, Tile<D>::TILE_BYTES);
  tma_tile<D>(dst, map, bar, row, head, batch);
}

// ---------------------------------------------------------------- the kernel
// Accumulator fragment of a wgmma m64nN (fp32), value i of a thread: row
// warp*16 + lane/4 + 8*((i/2)%2), column (i/4)*8 + (lane%4)*2 + i%2.  So each
// thread holds two rows (r0 and r0 + 8), shared with the 3 other threads of
// its quad.
template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS) flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                                                            const __grid_constant__ CUtensorMap tk,
                                                            const __grid_constant__ CUtensorMap tv,
                                                            const Params p) {
  using TQ = Tile<DQK>;  // Q and K tiles
  using T = Tile<DV>;    // V tiles and O
  constexpr int NOB = T::NOB;  // output blocks per row

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms need 1024-byte alignment
  const uint32_t sQ = base;
  const uint32_t sK = sQ + TQ::TILE_BYTES;           // STAGES tiles
  const uint32_t sV = sK + STAGES * TQ::TILE_BYTES;  // STAGES tiles
  const uint32_t bar_q = sV + STAGES * T::TILE_BYTES;
  const uint32_t bar_k = bar_q + 8;           // + 8 s
  const uint32_t bar_v = bar_k + 8 * STAGES;  // + 8 s

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x;
  const int q0 = (p.n_qtiles - 1 - int(blockIdx.y)) * BQ;  // longest causal tiles first
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  // causal: to the diagonal, or to the end of the prefix where that lies further
  const int k_end = p.causal ? max(min(p.Sk, q0 + BQ), min(p.prefix, p.Sk)) : p.Sk;
  const int nkv = (k_end + BK - 1) / BK;  // 0 when Sk == 0: no tile is loaded

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && nkv > 0) {
    load_tile<DQK>(sQ, &tq, bar_q, q0, h, b);
    for (int s = 0; s < STAGES && s < nkv; ++s) {
      load_tile<DQK>(sK + s * TQ::TILE_BYTES, &tk, bar_k + 8 * s, s * BK, hk, b);
      load_tile<DV>(sV + s * T::TILE_BYTES, &tv, bar_v + 8 * s, s * BK, hk, b);
    }
  }

  const int r0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int cq = (lane & 3) * 2;                // its column pair within each 8-column group

  float o[NOB][T::NB / 2];
#pragma unroll
  for (int nb = 0; nb < NOB; ++nb)
#pragma unroll
    for (int i = 0; i < T::NB / 2; ++i) o[nb][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of s * scale * log2(e), per row
  float l[2] = {0.f, 0.f};              // this thread's part of the running denominator

  if (nkv > 0) mbar_wait(bar_q, 0);
  for (int it = 0; it < nkv; ++it) {
    const int s = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int k0 = it * BK;
    const uint32_t tK = sK + s * TQ::TILE_BYTES, tV = sV + s * T::TILE_BYTES;

    // S = Q K^T
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(bar_k + 8 * s, phase);
    pin(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) wgmma_ss_n64(sc, desc_kmajor<DQK>(sQ, kk), desc_kmajor<DQK>(tK, kk));
    wg_commit();
    wg_wait0();
    pin(sc);

#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= p.scale_log2;
    // the ragged edge and the causal diagonal: only the tiles with a column
    // past Sk, or past both the diagonal and the prefix, need it
    if (k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0 && k0 + BK > p.prefix)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i >> 2) * 8 + cq + (i & 1);
        const int row = r0 + ((i >> 1) & 1) * 8;
        if (col >= p.Sk || (p.causal && col > row && col >= p.prefix)) sc[i] = -INFINITY;
      }
    }

    // online softmax on the fragment, in base 2
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float shift[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with nothing visible yet keeps m = -inf: shift by 0 so that
      // exp2 gives 0 instead of nan
      shift[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - shift[r]);
      m[r] = m_new;
    }
    uint32_t pa[16], pb[16];  // P = hi + lo in bf16: pa[4j .. 4j+3] (hi), pb (lo) the A fragments of k-step j
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2f(sc[i] - shift[r]);
      const float p1 = exp2f(sc[i + 1] - shift[r]);
      rs[r] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      pa[i >> 1] = bits(hi);
      pb[i >> 1] = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int nb = 0; nb < NOB; ++nb)
#pragma unroll
      for (int i = 0; i < T::NB / 2; ++i) o[nb][i] *= alpha[(i >> 1) & 1];

    // O += P V
    mbar_wait(bar_v + 8 * s, phase);
#pragma unroll
    for (int nb = 0; nb < NOB; ++nb) pin(o[nb]);
    pin(pa);
    pin(pb);
    wg_fence();
#pragma unroll
    for (int nb = 0; nb < NOB; ++nb)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint64_t dv = desc_mnmajor<DV>(tV, nb, j);
        wgmma_rs<T::NB>(o[nb], pa + 4 * j, dv);
        wgmma_rs<T::NB>(o[nb], pb + 4 * j, dv);
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nb = 0; nb < NOB; ++nb) pin(o[nb]);

    // every warp is done with stage s: refill it with the tile STAGES ahead
    __syncthreads();
    if (tid == 0 && it + STAGES < nkv) {
      load_tile<DQK>(tK, &tk, bar_k + 8 * s, (it + STAGES) * BK, hk, b);
      load_tile<DV>(tV, &tv, bar_v + 8 * s, (it + STAGES) * BK, hk, b);
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];  // a row that sees no key gives 0
    const int row = r0 + 8 * r;
    if (p.lse != nullptr && (lane & 3) == 0 && row < p.Sq)
      p.lse[(size_t(b) * p.Hq + h) * p.Sq + row] =
          l[r] == 0.f ? INFINITY : (m[r] + log2f(l[r])) * 0.6931471805599453f;
  }
  store_rows<DV>(static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh, p.o_ss, q0, p.Sq, o, inv);
}

// ---------------------------------------------------------------- host side
template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, int B, const Params& p, const long long* st,
           cudaStream_t stream) {
  using TQ = Tile<DQK>;
  using T = Tile<DV>;
  static_assert(BQ == BK, "one box shape serves Q, K and V");
  CUtensorMap tq{}, tk{}, tv{};  // K and V stay unencoded when Sk == 0: no tile is loaded
  int err = make_map(&tq, q, DQK, p.Sq, p.Hq, B, st[1], st[2], st[0], TQ::CW, BK, TQ::SW);
  if (err == 0 && p.Sk > 0) err = make_map(&tk, k, DQK, p.Sk, p.Hkv, B, st[4], st[5], st[3], TQ::CW, BK, TQ::SW);
  if (err == 0 && p.Sk > 0) err = make_map(&tv, v, DV, p.Sk, p.Hkv, B, st[7], st[8], st[6], T::CW, BK, T::SW);
  if (err != 0) return err;
  constexpr size_t SMEM = smem_bytes<DQK, DV>();
  static_assert(SMEM <= 232448, "shared memory of one block");
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma<DQK, DV>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(p.Hq, p.n_qtiles, B);
  flash_fwd_wgmma<DQK, DV><<<grid, THREADS, SMEM, stream>>>(tq, tk, tv, p);
  return int(cudaGetLastError());
}

}  // namespace

// bf16 only.  D is q's and k's head dim, Dv v's and out's.  Strides in
// elements, (batch, seq, head) for q, k, v and out in that order.
// prefix_len > 0 (causal only, else invalid) keeps keys [0, prefix_len)
// visible to every row.  Returns
// 0, a cudaError_t (> 0), or a negated CUresult of the tensor-map encoding
// (< 0); repro_flash_wgmma_error_string names it.
extern "C" int repro_flash_attention_fwd_wgmma(
    const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    int Dv, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int prefix_len, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || prefix_len < 0 || (prefix_len > 0 && !causal)) return int(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  const Params p{o, lse, Sq, Sk, Hq, Hkv, o_sb, o_ss, o_sh, scale * 1.4426950408889634f, causal, prefix_len,
                 (Sq + BQ - 1) / BQ};
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == Dv) {
    switch (D) {
      case 32: return launch<32, 32>(q, k, v, B, p, st, s);
      case 64: return launch<64, 64>(q, k, v, B, p, st, s);
      case 128: return launch<128, 128>(q, k, v, B, p, st, s);
      case 256: return launch<256, 256>(q, k, v, B, p, st, s);
    }
  }
  if (D == 192 && Dv == 128) return launch<192, 128>(q, k, v, B, p, st, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* repro_flash_wgmma_error_string(int err) { return hopper::error_string(err); }
