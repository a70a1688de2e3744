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
// count.  Here one thread takes one event (a grid-stride loop, 64-bit
// indices) and lands it with a 64-bit atomicAdd, so events land in no fixed
// order.  uint64 addition is associative and commutative mod 2^64, so the
// order cannot change a bit of the result: it equals the sequential fold
// exactly, wraparound included.  A dropped event is skipped, not masked.
// An event whose flat index falls outside the table is skipped as well and
// counted in *bad, so that a bad index can never write outside the buffer
// and the caller can raise (NumPy raises an IndexError there).
//
// What bounds it.  The work is one add per event; the bytes are 24 per event
// (seg, lin, cnt) and 8 per table cell (the zero fill and the write back),
// so it is bound by bytes, and at the simulator's sizes mostly by the table:
// 99.9 % of the cells stay zero.  This first kernel leaves the zero fill to
// cudaMemsetAsync and lands every event with its own atomic; events that
// hit one cell serialise on it in L2.  Aggregating equal keys within a warp
// (__match_any_sync) or in shared memory first is later work.
//
// Sequential fold.  The device path of ArrayOps.running_sum: out[r, c] =
// out[r - 1, c] + in[r, c], a strict left fold down each column, so float64
// rounds exactly as np.add.accumulate does (a parallel scan would
// reassociate).  One thread per column walks the rows in order; int64 is
// folded as uint64, which gives the same bits and wraps without undefined
// behaviour.  The reference's JaxOps folds with lax.scan, outside Pallas.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;  // 16 blocks per SM; the grid strides over the rest

__global__ void scatter_kernel(const long long* __restrict__ seg, const long long* __restrict__ lin,
                               const unsigned long long* __restrict__ cnt, long long n,
                               long long n_segs, long long row_size, long long size,
                               unsigned long long* __restrict__ table, unsigned long long* __restrict__ bad) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    long long flat = lin[i];
    if (seg != nullptr) {
      const long long s = seg[i];
      if (s >= n_segs) continue;  // after the final report boundary: dropped
      flat += s * row_size;
    }
    if (flat < 0 || flat >= size) {
      atomicAdd(bad, 1ULL);
      continue;
    }
    atomicAdd(table + flat, cnt[i]);
  }
}

template <typename T>
__global__ void fold_kernel(const T* __restrict__ in, T* __restrict__ out, long long rows, long long cols) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; c < cols; c += stride) {
    T acc = in[c];
    out[c] = acc;
    for (long long r = 1; r < rows; ++r) {
      acc = acc + in[r * cols + c];
      out[r * cols + c] = acc;
    }
  }
}

int grid_for(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
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
  scatter_kernel<<<grid_for(n), THREADS, 0, s>>>(seg, lin, cnt, n, n_segs, row_size, size, table, bad);
  return static_cast<int>(cudaGetLastError());
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
  scatter_kernel<<<grid_for(n), THREADS, 0, s>>>(nullptr, lin, cnt, n, 1, size, size, dense, bad);
  return static_cast<int>(cudaGetLastError());
}

// Sequential fold down axis 0 of a contiguous (rows, cols) array; dtype 0 is
// float64, 1 is int64.  rows >= 1.
extern "C" int repro_running_sum(const void* in, void* out, long long rows, long long cols, int dtype, void* stream) {
  if (rows < 1 || cols < 0 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (cols == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const long long want = (cols + threads - 1) / threads;
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  if (dtype == 0) {
    fold_kernel<double><<<blocks, threads, 0, s>>>(static_cast<const double*>(in), static_cast<double*>(out), rows, cols);
  } else {
    fold_kernel<unsigned long long><<<blocks, threads, 0, s>>>(
        static_cast<const unsigned long long*>(in), static_cast<unsigned long long*>(out), rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_array_ops_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
