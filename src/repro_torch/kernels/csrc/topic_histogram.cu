// Signed topic-delta histogram for Hopper (sm_90a).
//
//   topic_histogram  replaces _hist_kernel / topic_histogram_pallas
//                    (src/repro/kernels/topic_histogram.py):
//                      out[r, k] = sum_t inc[t] * ([k == z_new[t]]
//                                                 - [k == z_old[t]])
//                    over tokens t of row rows[t]: an (R, K) int32 matrix,
//                    the per-row count deltas of one sweep.
//
// What bounds it: the (R, K) output is written once (the zero fill) and
// each token's four int32 ids are read once: R K 4 + T 16 bytes, the least
// time the card could take. The atomics of changed tokens read and write
// 4 bytes each twice more, mostly in L2, where the rows of nearby tokens
// stay resident.
//
// Design: the TPU kernel avoids scatters (serialised there): it expands
// each tile of row-sorted tokens into one-hot rank x topic matrices and
// contracts them on the MXU, then scatters per-tile partials. Hopper has
// integer atomics in L2 at full rate, so the translation is the scatter
// itself: one fill kernel zeroes the output with 16-byte stores, then one
// thread per token adds +inc at (row, z_new) and -inc at (row, z_old) by
// atomicAdd (result unused: compiled to fire-and-forget reductions).
// Tokens with inc == 0 or z_new == z_old add nothing (the two entries
// cancel), so they skip their atomics. Integer sums are exact in any
// order, so the result is bit-equal to the plain version for sorted and
// unsorted rows alike; no tile ranks are needed. Row-sorted tokens (doc
// order, or word order after a sort) keep a warp's atomics on a few
// neighbouring rows. The cost of this simple form: atomics on one address
// serialise, so a row that holds a large share of the tokens (a Zipf
// corpus's top words, on the word side) is far slower than its bytes; a
// per-block shared-memory histogram of each run of equal rows, flushed
// once, is the next design (PERF.md keeps the times).
//
// An id outside its range (row not in [0, R), topic not in [0, K)) aborts
// the launch (__trap) before that token writes: no write lands out of
// bounds, and the error surfaces at the caller's next synchronize.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxFillBlocks = 1 << 16;

__global__ void __launch_bounds__(kThreads)
zero_fill_kernel(int* __restrict__ out, size_t n) {
  const size_t n4 = n / 4;
  int4* out4 = reinterpret_cast<int4*>(out);
  const size_t first = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = first; i < n4; i += stride) {
    out4[i] = make_int4(0, 0, 0, 0);
  }
  if (first < n - n4 * 4) out[n4 * 4 + first] = 0;  // the last n % 4
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ rows, const int* __restrict__ z_old,
            const int* __restrict__ z_new, const int* __restrict__ inc,
            int* __restrict__ out, int T, int R, int K) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int r = rows[t];
  const int zo = z_old[t];
  const int zn = z_new[t];
  const int v = inc[t];
  if (r < 0 || r >= R || zo < 0 || zo >= K || zn < 0 || zn >= K) __trap();
  if (v == 0 || zo == zn) return;
  int* row = out + (size_t)r * (size_t)K;
  atomicAdd(row + zn, v);
  atomicAdd(row + zo, -v);
}

}  // namespace

// Plain C launcher for ctypes: `out` is (R, K) int32, 16-byte aligned (a
// fresh torch allocation); launches both kernels on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int topic_histogram(const int* rows, const int* z_old,
                               const int* z_new, const int* inc, int* out,
                               int T, int R, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n = (size_t)R * (size_t)K;
  size_t fill = (n / 4 + kThreads - 1) / kThreads;
  if (fill < 1) fill = 1;
  if (fill > kMaxFillBlocks) fill = kMaxFillBlocks;
  zero_fill_kernel<<<(unsigned)fill, kThreads, 0, s>>>(out, n);
  int err = (int)cudaGetLastError();
  if (err != 0 || T <= 0) return err;
  const unsigned blocks = (unsigned)((T + kThreads - 1) / kThreads);
  hist_kernel<<<blocks, kThreads, 0, s>>>(rows, z_old, z_new, inc, out, T,
                                          R, K);
  return (int)cudaGetLastError();
}
