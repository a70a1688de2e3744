// The simulator's stat-landing kernels for Hopper (sm_90a), with a plain C interface.
//
// Segment scatter.  Replaces repro/core/array_ops.py::JaxOps._segment_kernel
// (the Pallas TPU kernel handed to pl.pallas_call at :229).  Same function:
//
//     table[seg[i] * row_size + lin[i]] += cnt[i]   for every i with seg[i] < n_segs
//
// over a (n_segs, row_size) table of uint64 counts, zeroed first; events past
// the final report boundary (seg >= n_segs) are dropped.  The flat index is
// the one NumpyOps.segment_scatter uses (array_ops.py:124).  The same kernel
// with no seg column is the accumulate entry: dense[lin[i]] += cnt[i] into a
// caller's buffer, which is not zeroed (the stats engine's flush scatter).
//
// Design.  The TPU kernel walks the events in order with a fori_loop over
// one VMEM-resident table and masks a dropped event onto row 0 with a zero
// count.  Here the events land with 64-bit atomicAdds, so they land in no
// fixed order.  uint64 addition is associative and commutative mod 2^64,
// so neither the order nor any grouping of the adds can change a bit of the
// result: it equals the sequential fold exactly, wraparound included.  A
// dropped event is skipped, not masked.  An event whose flat index falls
// outside the table is skipped as well and counted in *bad, so that a bad
// index can never write outside the buffer and the caller can raise (NumPy
// raises an IndexError there).
//
// Equal keys are summed before they reach device memory.  A warp takes a
// window of 64 consecutive events, two per lane, each column read with one
// 16-byte load per lane where the three columns are 16-byte aligned (plain
// 8-byte loads otherwise).  A lane whose two events share a key adds them.
// Then, once for the lanes' first events and once for their second,
// __match_any_sync groups the lanes by key, the group's counts are summed
// down a shuffle tree (uint64) and the group's lowest lane issues the one
// atomicAdd.  The landing's seg column is sorted (run-major, then report
// segment), so a window's events fall on a few cells of one or two table
// rows and most windows land with a handful of atomics instead of 64; any
// order stays exact, sortedness only makes it faster.  Dropped, bad and
// missing events carry the key -1, which no lane lands.
//
// What bounds it.  The work is one add per event; the bytes are 24 per event
// (seg, lin, cnt) and 8 per table cell (the zero fill and the write back),
// so it is bound by bytes, and at the simulator's sizes mostly by the table:
// 99.9 % of the cells stay zero.  The zero fill is cudaMemsetAsync; the
// scatter then reads its columns once and writes only the touched cells.

// Sequential fold.  The device path of ArrayOps.running_sum: out[r, c] =
// out[r - 1, c] + in[r, c], a strict left fold down each column, so float64
// rounds exactly as np.add.accumulate does (a parallel scan would
// reassociate).  int64 is folded as uint64, which gives the same bits and
// wraps without undefined behaviour.  The reference's JaxOps folds with
// lax.scan, outside Pallas.
//
// The fold's own work is one add a value, in a chain no thread can split, so
// what it can save is the wait for device memory: the compiled sweep's call
// is (300, 9) float64, and one thread walking each column's 300 rows pays a
// memory round trip a row.  Here a block takes up to FOLD_COLS columns and
// stages a chunk of their rows in shared memory with all its threads'
// cp.async copies, neighbouring threads on neighbouring addresses (the
// whole (300, 9) array is one chunk of 21.6 KB); one thread per column then
// folds the chunk in place in strict row order, from shared memory, reading
// eight rows ahead of its adds; all threads write the chunk back with
// coalesced stores.  A taller input goes in chunks of FOLD_STAGE values, two
// stages: the next chunk's copy is in flight while this one folds, and each
// column's running sum carries over in a register.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;  // 16 blocks per SM; the grid strides over the rest

constexpr unsigned FULL = 0xffffffffu;
constexpr int WINDOW = 64;  // events a warp takes per step: two per lane

// Sum v over the lanes of `peers` (the lanes holding this lane's key) into
// the group's lowest lane, by a shuffle tree: each round a lane adds the
// partial sum of the next peer above it that is still open, and the peers
// at odd positions drop out (the scheme of NVIDIA's "Voting and Shuffling to
// Optimize Atomic Operations").  Every lane of the warp takes part.
__device__ __forceinline__ unsigned long long sum_peers(unsigned peers, unsigned long long v, int lane) {
  unsigned rank = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
  peers &= ~((2u << lane) - 1u);                       // peers above this lane
  while (__any_sync(FULL, peers != 0)) {
    const int next = __ffs(peers);  // 1 + the nearest open peer above, or 0
    const unsigned long long t = __shfl_sync(FULL, v, next > 0 ? next - 1 : lane);
    if (next > 0) v += t;
    peers &= ~__ballot_sync(FULL, rank & 1u);  // peers at odd positions are summed in
    rank >>= 1;
  }
  return v;
}

// One key per lane: lanes of equal key (>= 0) land their summed count once.
__device__ __forceinline__ void land(long long key, unsigned long long c, int lane,
                                     unsigned long long* __restrict__ table) {
  const unsigned peers = __match_any_sync(FULL, key);
  const unsigned long long sum = sum_peers(peers, c, lane);
  if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(table + key, sum);
}

template <bool VEC, typename T>
__device__ __forceinline__ void load2(const T* __restrict__ col, long long i, long long n, T (&v)[2]) {
  if (VEC && i + 1 < n) {
    const ulonglong2 p = *reinterpret_cast<const ulonglong2*>(col + i);  // i is even: 16-byte aligned
    v[0] = static_cast<T>(p.x);
    v[1] = static_cast<T>(p.y);
  } else {
    v[0] = i < n ? col[i] : 0;
    v[1] = i + 1 < n ? col[i + 1] : 0;
  }
}

template <bool VEC>
__global__ void scatter_kernel(const long long* __restrict__ seg, const long long* __restrict__ lin,
                               const unsigned long long* __restrict__ cnt, long long n,
                               long long n_segs, long long row_size, long long size,
                               unsigned long long* __restrict__ table, unsigned long long* __restrict__ bad) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  unsigned long long n_bad = 0;
  for (long long base = warp * WINDOW; base < n; base += warps * WINDOW) {  // uniform across the warp
    const long long i = base + 2 * lane;
    long long key[2], s[2] = {0, 0};
    unsigned long long c[2];
    load2<VEC>(lin, i, n, key);
    load2<VEC>(cnt, i, n, c);
    if (seg != nullptr) load2<VEC>(seg, i, n, s);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (i + j >= n || (seg != nullptr && s[j] >= n_segs)) {  // no event, or dropped past the last row
        key[j] = -1;
        continue;
      }
      if (seg != nullptr) key[j] += s[j] * row_size;
      if (key[j] < 0 || key[j] >= size) {
        ++n_bad;
        key[j] = -1;
      }
    }
    if (key[0] >= 0 && key[0] == key[1]) {
      c[0] += c[1];  // wraps mod 2^64, as every add here does
      key[1] = -1;
    }
    land(key[0], c[0], lane, table);
    if (__any_sync(FULL, key[1] >= 0)) land(key[1], c[1], lane, table);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n_bad += __shfl_xor_sync(FULL, n_bad, off);
  if (lane == 0 && n_bad > 0) atomicAdd(bad, n_bad);
}

constexpr int FOLD_THREADS = 256;
constexpr int FOLD_COLS = 32;     // columns a block folds, one thread each
constexpr int FOLD_STAGE = 2816;  // 8-byte values a stage holds (22,528 bytes; two stages)

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Block b folds columns [b FOLD_COLS, + nc) of a contiguous (rows, cols) array,
// FOLD_STAGE / nc rows a chunk.
template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS) fold_kernel(const T* __restrict__ in, T* __restrict__ out,
                                                            long long rows, long long cols) {
  __shared__ __align__(16) T buf[2][FOLD_STAGE];
  const long long c0 = static_cast<long long>(blockIdx.x) * FOLD_COLS;
  const int nc = static_cast<int>(cols - c0 < FOLD_COLS ? cols - c0 : FOLD_COLS);
  const int rc = FOLD_STAGE / nc;
  const long long n_chunks = (rows + rc - 1) / rc;
  const int tid = threadIdx.x;
  auto chunk_rows = [&](long long ch) { return static_cast<int>(rows - ch * rc < rc ? rows - ch * rc : rc); };
  auto issue = [&](long long ch) {
    T* dst = buf[ch & 1];
    const T* src = in + ch * rc * cols + c0;
    const int n = chunk_rows(ch) * nc;
    for (int i = tid; i < n; i += FOLD_THREADS) {
      const int r = i / nc;
      cp_async8(dst + i, src + r * cols + (i - r * nc));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  issue(0);
  T acc = 0;
  for (long long ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      issue(ch + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // chunk ch has landed for every thread
    T* s = buf[ch & 1];
    const int nr = chunk_rows(ch);
    if (tid < nc) {
      int r = 0;
      if (ch == 0) {  // the fold starts from the first value (0 + x would turn -0.0 into 0.0)
        acc = s[tid];
        r = 1;
      }
      for (; r + 8 <= nr; r += 8) {
        T v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = s[(r + u) * nc + tid];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc = acc + v[u];
          s[(r + u) * nc + tid] = acc;
        }
      }
      for (; r < nr; ++r) {
        acc = acc + s[r * nc + tid];
        s[r * nc + tid] = acc;
      }
    }
    __syncthreads();
    T* dst = out + ch * rc * cols + c0;
    for (int i = tid; i < nr * nc; i += FOLD_THREADS) {
      const int r = i / nc;
      dst[r * cols + (i - r * nc)] = s[i];
    }
    __syncthreads();  // every write-back of this stage is done before issue(ch + 2) refills it
  }
}

int grid_for(long long n) {  // one warp per window of events; the grid strides over the rest
  const long long blocks = (n + WINDOW * (THREADS / 32) - 1) / (WINDOW * (THREADS / 32));
  return static_cast<int>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the scatter, with 16-byte loads where every column allows them
int launch_scatter(const long long* seg, const long long* lin, const unsigned long long* cnt, long long n,
                   long long n_segs, long long row_size, long long size, unsigned long long* table,
                   unsigned long long* bad, cudaStream_t s) {
  if (aligned16(seg) && aligned16(lin) && aligned16(cnt)) {
    scatter_kernel<true><<<grid_for(n), THREADS, 0, s>>>(seg, lin, cnt, n, n_segs, row_size, size, table, bad);
  } else {
    scatter_kernel<false><<<grid_for(n), THREADS, 0, s>>>(seg, lin, cnt, n, n_segs, row_size, size, table, bad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Segment scatter: zero table (n_segs * row_size uint64) and *bad, then land.
// seg, lin int64 and cnt uint64 of n elements each, contiguous, on the device.
extern "C" int repro_segment_scatter(const long long* seg, const long long* lin, const unsigned long long* cnt,
                                     long long n, long long n_segs, long long row_size,
                                     unsigned long long* table, unsigned long long* bad, void* stream) {
  if (n < 0 || n_segs < 0 || row_size < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long size = n_segs * row_size;
  cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(unsigned long long), s);
  if (err == cudaSuccess && size > 0) {
    err = cudaMemsetAsync(table, 0, static_cast<size_t>(size) * sizeof(unsigned long long), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  return launch_scatter(seg, lin, cnt, n, n_segs, row_size, size, table, bad, s);
}

// Accumulate entry: dense[lin[i]] += cnt[i] into the caller's dense buffer of
// size uint64 (not zeroed); *bad is zeroed and counts indices outside it.
extern "C" int repro_scatter_add(const long long* lin, const unsigned long long* cnt, long long n, long long size,
                                 unsigned long long* dense, unsigned long long* bad, void* stream) {
  if (n < 0 || size < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  return launch_scatter(nullptr, lin, cnt, n, 1, size, size, dense, bad, s);
}

// Sequential fold down axis 0 of a contiguous (rows, cols) array; dtype 0 is
// float64, 1 is int64.  rows >= 1.
extern "C" int repro_running_sum(const void* in, void* out, long long rows, long long cols, int dtype, void* stream) {
  if (rows < 1 || cols < 0 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (cols == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (cols + FOLD_COLS - 1) / FOLD_COLS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    fold_kernel<double><<<static_cast<unsigned>(blocks), FOLD_THREADS, 0, s>>>(
        static_cast<const double*>(in), static_cast<double*>(out), rows, cols);
  } else {
    fold_kernel<unsigned long long><<<static_cast<unsigned>(blocks), FOLD_THREADS, 0, s>>>(
        static_cast<const unsigned long long*>(in), static_cast<unsigned long long*>(out), rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_array_ops_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
