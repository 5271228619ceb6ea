// CDF row search for Hopper (sm_90a).
//
//   cdf_search  replaces _cdf_search_kernel / cdf_row_search_pallas
//               (src/repro/kernels/cdf_search.py): for token t, the count
//               row r = rows[t] of the resident (R, K) int32 matrix, the
//               per-topic term (K,) float32 and a target; returns
//                 min(#{k : prefix(counts[r] * term)[k] < target[t]}, K - 1)
//               the lower bound that draws zen_cdf's term-2 word topic,
//               without the (R, K) float CDF matrix or gathered (T, K) rows.
//
// What bounds it: the function needs, per token, the row's counts up to
// the lower-bound position (the walk stops there), one row id, one target
// and the one output; rows shared by tokens need reading once. The
// arithmetic (a convert, a multiply, a five-step scan and a compare per
// element) is far below the bytes, so a launch is bound by bytes, or, when
// L2 serves the repeated rows, by the instructions issued per strip.
//
// Design: one warp per token, the same walk as kernel 6 (sparse_row.cu).
// The lanes read the count row in 32-lane strips, each one coalesced
// 128-byte load of int32 counts read in place (scalar-prefetched row ids
// on the TPU; here the warp loads its own id). A lane converts its count
// and multiplies by the term (read through the read-only cache: K floats
// shared by every token). A strip gets an inclusive warp prefix sum by
// shuffles (Hillis-Steele: offsets 1, 2, 4, 8, 16, lane i adding lane
// i - off where i >= off), then the carry of the strips before it is
// added; __ballot_sync + __popc counts the real lanes whose prefix lies
// below the target. The carry grows by the strip's lane 31. Once the
// carry reaches the target no later prefix can lie below it (the terms of
// the callers are non-negative), so the warp stops: a token's walk ends at
// its lower bound. The carry is warp-uniform, so the exit is too and the
// shuffles stay full-mask.
//
// A whole row is one warp's, so the TPU kernel's K tiles and its running
// (mass, count) scratch carried between grid steps become the strip loop
// and two registers; no padding of K to a tile width is needed.
//
// Numerics: the plain torch version (kernels/cdf_search.py) adds in
// exactly this order and counts the whole row, which for non-negative
// terms is the count this walk stops at, so the two are bit-equal on the
// card. The
// multiply is rounded on its own (no contraction: -fmad=false), as torch's
// separate multiply is; no fast math.
//
// A row id outside [0, R) aborts the launch (__trap), as torch's own
// indexing does on the card: nothing is read or written out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cdf_search_kernel(const int* __restrict__ counts,
                  const int* __restrict__ rows,
                  const float* __restrict__ term,
                  const float* __restrict__ targets, int* __restrict__ out,
                  int T, int K, int R) {
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;  // uniform per warp: the shuffles stay full-mask
  const int lane = threadIdx.x & 31;
  const int r = rows[t];
  if (r < 0 || r >= R) __trap();
  const int* row = counts + (size_t)r * (size_t)K;
  const float target = targets[t];
  float carry = 0.0f;
  int cnt = 0;
  for (int s = 0; s < K; s += 32) {
    // every later prefix is >= carry >= target: nothing more to count
    if (carry >= target) break;
    const int k = s + lane;
    const bool real = k < K;
    float x = real ? (float)row[k] * __ldg(term + k) : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x = x + y;
    }
    const float c = carry + x;
    cnt += __popc(__ballot_sync(kFull, real && (c < target)));
    carry = carry + __shfl_sync(kFull, x, 31);
  }
  if (lane == 0) out[t] = cnt < K - 1 ? cnt : K - 1;
}

}  // namespace

// Plain C launcher for ctypes: launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 = launched).
extern "C" int cdf_search(const int* counts, const int* rows,
                          const float* term, const float* targets, int* out,
                          int T, int K, int R, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((T + kWarpsPerBlock - 1)
                                     / kWarpsPerBlock);
  cdf_search_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      (cudaStream_t)stream>>>(counts, rows, term, targets,
                                              out, T, K, R);
  return (int)cudaGetLastError();
}
