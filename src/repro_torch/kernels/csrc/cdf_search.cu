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
// What bounds it: the function needs, per token, one row id, one target
// and the one output; a token whose target is <= 0 needs nothing more
// (no prefix lies below it: the answer is 0), the others the row's counts
// up to the lower-bound position (the walk stops there), rows shared by
// tokens read once. On zen_cdf's path only ~3% of tokens search (the
// others' draws take another term, target 0), so a launch is bound by the
// per-token bytes, or, when most tokens search and L2 serves the repeated
// rows, by the instructions issued per strip of the walks.
//
// Design: two kernels, so that a token that searches nothing costs a lane
// and not a warp, and the walks are spread over every warp of the card
// however the searching tokens cluster.
//   cdf_compact_kernel  one thread per token, coalesced: reads the row id
//     (checked, searching or not) and the target; writes 0 for a target
//     that is not > 0 (what the walk returns for it: its first test stops
//     it with count 0, and a NaN target counts no prefix); appends the
//     others to a queue as (token, row, target) entries: a block ranks its
//     searching tokens by __ballot_sync and a shared prefix over its
//     warps, and takes its slice of the queue with one atomicAdd on the
//     queue's length.
//   cdf_walk_kernel  a grid of the blocks the card holds at once (no
//     second wave to wait for); warp w walks queue entries w, w + warps,
//     ... (loading its next entry during the walk) with the walk of the
//     one-warp-per-token kernel it replaces,
//     unchanged: 32-lane strips of the row, each one coalesced 128-byte
//     load of int32 counts read in place; a lane converts its count and
//     multiplies by the term (read-only cache: K floats shared by every
//     token); an inclusive warp prefix sum by shuffles (Hillis-Steele:
//     offsets 1, 2, 4, 8, 16, lane i adding lane i - off where i >= off),
//     then the carry of the strips before it; __ballot_sync + __popc
//     counts the real lanes whose prefix lies below the target; the carry
//     grows by the strip's lane 31; once the carry reaches the target no
//     later prefix can lie below it (the callers' terms are non-negative)
//     and the warp stops. What changed is how the row is read: a walk
//     issues kStrips strips' loads at once and then scans them in order,
//     so one memory latency serves kStrips strips (at most kStrips - 1
//     strips past the answer are read for nothing; loading the next
//     kStrips during the scan was tried, and its extra reads made the
//     all-searching case slower); the additions and their order are
//     untouched. Queue order varies from launch to launch; each token's
//     walk and result do not.
//
// The TPU kernel's K tiles and its running (mass, count) scratch carried
// between grid steps become the strip loop and two registers; no padding
// of K to a tile width is needed.
//
// Numerics: the plain torch version (kernels/cdf_search.py) adds in
// exactly this order and counts the whole row, which for non-negative
// terms is the count this walk stops at, so the two are bit-equal on the
// card. The multiply is rounded on its own (no contraction: -fmad=false),
// as torch's separate multiply is; no fast math.
//
// A row id outside [0, R) aborts the launch (__trap), as torch's own
// indexing does on the card, whether its token searches or not: nothing
// is read or written out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads per block of both kernels; a build may define CDF_SEARCH_THREADS
// (a multiple of 32) to measure another shape (_build.variant). A token's
// result depends on its own row, term and target only; where its queue
// entry lands changes nothing.
#ifndef CDF_SEARCH_THREADS
#define CDF_SEARCH_THREADS 256
#endif
constexpr int kThreads = CDF_SEARCH_THREADS;
static_assert(kThreads % 32 == 0, "CDF_SEARCH_THREADS: whole warps");
constexpr int kWarps = kThreads / 32;
constexpr int kTokensPerThread = 4;
constexpr int kTokensPerBlock = kThreads * kTokensPerThread;
constexpr int kStrips = 4;  // strips of a row a walk loads at once
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
cdf_compact_kernel(const int* __restrict__ rows,
                   const float* __restrict__ targets, int* __restrict__ out,
                   int4* __restrict__ queue, int* __restrict__ queue_len,
                   int T, int R) {
  __shared__ int warp_base[kTokensPerThread][kWarps];
  __shared__ int block_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kTokensPerBlock;
  int row[kTokensPerThread];
  float target[kTokensPerThread];
  unsigned ballot[kTokensPerThread];
#pragma unroll
  for (int m = 0; m < kTokensPerThread; ++m) {
    const int t = first + m * kThreads + threadIdx.x;
    row[m] = 0;
    target[m] = 0.0f;
    if (t < T) {
      row[m] = rows[t];
      target[m] = targets[t];
    }
  }
#pragma unroll
  for (int m = 0; m < kTokensPerThread; ++m) {
    const int t = first + m * kThreads + threadIdx.x;
    if (t < T) {
      if (row[m] < 0 || row[m] >= R) __trap();
      if (!(target[m] > 0.0f)) out[t] = 0;
    }
    ballot[m] = __ballot_sync(kFull, t < T && target[m] > 0.0f);
    if (lane == 0) warp_base[m][warp] = __popc(ballot[m]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int m = 0; m < kTokensPerThread; ++m) {
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_base[m][w];
        warp_base[m][w] = n;
        n += c;
      }
    }
    block_base = n > 0 ? atomicAdd(queue_len, n) : 0;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int m = 0; m < kTokensPerThread; ++m) {
    if ((ballot[m] >> lane) & 1u) {
      queue[block_base + warp_base[m][warp] + __popc(ballot[m] & below)] =
          make_int4(first + m * kThreads + threadIdx.x, row[m],
                    __float_as_int(target[m]), 0);
    }
  }
}

// one 32-lane strip of the walk: the row's counts times the term, the
// warp's inclusive prefix sum plus the carry, the real lanes below the
// target counted, the carry grown by the strip's total
__device__ __forceinline__ void walk_strip(int c, float w, bool real,
                                           float target, int lane,
                                           float& carry, int& cnt) {
  float x = real ? (float)c * w : 0.0f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x = x + y;
  }
  const float p = carry + x;
  cnt += __popc(__ballot_sync(kFull, real && (p < target)));
  carry = carry + __shfl_sync(kFull, x, 31);
}

__global__ void __launch_bounds__(kThreads)
cdf_walk_kernel(const int* __restrict__ counts,
                const float* __restrict__ term, int* __restrict__ out,
                const int4* __restrict__ queue,
                const int* __restrict__ queue_len, int K, int R) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  const int n = *queue_len;
  int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int4 next = q < n ? queue[q] : make_int4(0, 0, 0, 0);
  for (; q < n; q += warps) {
    const int4 e = next;
    if (q + warps < n) next = queue[q + warps];  // the warp's next token
    const int r = e.y;
    if (r < 0 || r >= R) __trap();
    const int* row = counts + (size_t)r * (size_t)K;
    const float target = __int_as_float(e.z);
    float carry = 0.0f;
    int cnt = 0;
    for (int s0 = 0; s0 < K; s0 += 32 * kStrips) {
      if (carry >= target) break;
      // kStrips strips' loads in flight at once, then their scans in order
      int c[kStrips];
      float w[kStrips];
#pragma unroll
      for (int j = 0; j < kStrips; ++j) {
        const int k = s0 + 32 * j + lane;
        c[j] = k < K ? row[k] : 0;
        w[j] = k < K ? __ldg(term + k) : 0.0f;
      }
      bool stop = false;
#pragma unroll
      for (int j = 0; j < kStrips; ++j) {
        const int s = s0 + 32 * j;
        // past the row, or every later prefix is >= carry >= target:
        // nothing more to count
        if (s >= K || carry >= target) {
          stop = true;
          break;
        }
        walk_strip(c[j], w[j], s + lane < K, target, lane, carry, cnt);
      }
      if (stop) break;
    }
    if (lane == 0) out[e.x] = cnt < K - 1 ? cnt : K - 1;
  }
}

}  // namespace

// Plain C launcher for ctypes: `queue` is int32 scratch of 4 (T + 1)
// entries, 16-byte aligned: its first int holds the queue's length, then
// one (token, row, target bits, 0) entry per searching token. Launches on
// `stream` (a memset and two kernels), does not synchronise, and returns
// cudaGetLastError() (0 = launched).
extern "C" int cdf_search(const int* counts, const int* rows,
                          const float* term, const float* targets, int* out,
                          int* queue, int T, int K, int R, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int* queue_len = queue;
  int4* entries = reinterpret_cast<int4*>(queue) + 1;
  int err = (int)cudaMemsetAsync(queue_len, 0, sizeof(int), s);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)((T + kTokensPerBlock - 1)
                                     / kTokensPerBlock);
  cdf_compact_kernel<<<blocks, kThreads, 0, s>>>(rows, targets, out,
                                                 entries, queue_len, T, R);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cdf_walk_kernel,
                                                kThreads, 0);
  // exactly the blocks the card holds at once, so that every warp starts
  // together and the strided queue shares out evenly; never more blocks
  // than the queue could need
  long walk = (long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const long need = ((long)T + kWarps - 1) / kWarps;
  if (walk > need) walk = need;
  cdf_walk_kernel<<<(unsigned)walk, kThreads, 0, s>>>(
      counts, term, out, entries, queue_len, K, R);
  return (int)cudaGetLastError();
}
