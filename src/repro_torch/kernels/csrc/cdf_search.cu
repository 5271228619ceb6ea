// CDF row search for Hopper (sm_90a).
//
//   cdf_search  replaces _cdf_search_kernel / cdf_row_search_pallas
//               (src/repro/kernels/cdf_search.py): for token t, the count
//               row r = rows[t] of the resident (R, K) int32 matrix, the
//               per-topic term (K,) float32 and a target; returns
//                 min(#{k : prefix(counts[r] * term)[k] < target[t]}, K - 1)
//               the lower bound that draws zen_cdf's term-2 word topic,
//               without the (R, K) float CDF matrix or gathered (T, K) rows.
//   doc_row_search  zen_cdf's term 3 for both draws of a token, from the
//               doc's top-J row read in place (no TPU kernel: the
//               reference computes it with XLA ops, doc_rows and a
//               row-wise searchsorted, src/repro/algorithms/zen_cdf.py);
//               its note is above its code, further down.
//
// cdf_search. What bounds it: the function needs, per token, one row id, one
// target and the one output; a token whose target is <= 0 needs nothing more
// (no prefix lies below it: the answer is 0), the others the row's counts up
// to the lower-bound position (the walk stops there), rows shared by tokens
// read once. On zen_cdf's path only ~3% of tokens search (the others' draws
// take another term, target 0), so a launch is bound by the per-token bytes,
// or, when most tokens search and L2 serves the repeated rows, by the
// instructions issued per strip of the walks.
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
// Work count, while a trace asks for it (a counter pointer given): the
// tokens queued for a walk (target > 0), the kernel's real work; each
// block adds its slice of the queue to the counter beside the atomicAdd
// that takes the slice. With no pointer a block pays one uniform branch;
// the output is the same either way.
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

// the counter of queued tokens that a launch given it adds to: zero when
// the library loads, added to only by launches made while tracing
__device__ unsigned long long g_searched_tokens = 0;

__global__ void __launch_bounds__(kThreads)
cdf_compact_kernel(const int* __restrict__ rows,
                   const float* __restrict__ targets, int* __restrict__ out,
                   int4* __restrict__ queue, int* __restrict__ queue_len,
                   unsigned long long* __restrict__ searched, int T, int R) {
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
    if (searched != nullptr && n > 0) {
      atomicAdd(searched, (unsigned long long)n);
    }
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

// ---------------------------------------------------------------------------
// doc_row_search: for token t, J = max_kd and the doc row r = doc[t] of the
// (D, J) tables kd_cnt (int32 counts, higher first) and kd_idx (their
// int32 topics),
//   v[j]   = cnt[r, j] > 0 ? (cnt · (n_wk[word[t], idx[r, j]] + beta))
//                            · t1[idx[r, j]] : 0
//   prefix = the prefix sums of v, d_mass the last
//   total  = (m1 + m2_all[word[t]]) + d_mass,   m1 = g_cdf[K - 1]
// and for each draw's uniform u01 (u_a[t], u_b[t]):
//   t3 = max((u01 · total - m1) - m2, 0)
//   z  = idx[r, min(#{j : prefix[j] < t3}, J - 1)]
// It writes total[t], z[t] (draw a) and z[T + t] (draw b); zen_cdf's draw
// takes the branch, term 1 and term 2 from there. No (tokens, J) array of
// weights, topics or prefix sums exists anywhere.
//
// What bounds it: per token 32 bytes of inputs and outputs, the doc row
// (12 bytes an entry) and the n_wk value of each live entry (cnt > 0) at
// the row's topics. In token order (tokens lie doc by doc) the warps of a
// block share the doc row through L1, but consecutive tokens have other
// words, so each live entry costs a 32-byte n_wk sector that L2 does not
// hold: ~94 sectors, ~3.0 KB a token on NYTimes at J = 128. Walked in
// word order (`order`, zen_cdf's word-major permutation of a chunk, sorted
// within tiles of the chunk), the warps running at once hold a few hundred
// words, each word's 4 KB n_wk row (K = 1000) is read from HBM about once a
// run of its tokens (~10 at 2^20-token tiles), and each token pays its doc
// row's sectors (from L2, the tile's ~3,200 rows fitting there) and ~7
// scattered sectors of its own reads and writes: ~450 bytes a token from
// HBM. On an H100 that walk takes a 2^24-token NYTimes chunk from 14.1 to
// 10.4 ms (J = 128), several times its HBM bytes, and J = 64 (half the doc
// row) is only 3% faster: bytes no longer bound it; each warp's chain of
// dependent loads (order, token, doc row, n_wk) most likely does
// (unverified: no profiler counter reads on the card).
//
// Design: one warp per token, lane i holding entry 32 s + i of strip s. A
// group of kGroup strips (the whole row up to J = 128) is loaded at once:
// first the counts and topics, then, for the live entries only, n_wk and
// t1 at the topics, all issued before the first scan, so one memory
// latency serves the group. Each strip gets the inclusive warp prefix sum
// of kernels 6 and 7 (shuffles at offsets 1, 2, 4, 8, 16, then the carry
// of the strips before it; the carry grows by the strip's lane 31); a
// strip with no live entry skips its shuffles, since every prefix in it
// equals the carry exactly. The carry after the last strip is d_mass; the
// group's prefix sums stay in registers, and each draw counts the real
// lanes below its t3 with __ballot_sync + __popc. Zero counts form the
// row's tail, and a strip of them costs its two coalesced loads and no
// gather: the positions are those of the whole walk, a t3 at or past
// d_mass counting every lane (clamped to J - 1). A row wider than one
// group (J > 128) is walked twice: the first pass keeps the carry only,
// the second loads and scans each group again (the same operations, so
// the same prefix sums) and counts. Warp i takes token order[i] (i without
// an order), and every per-token read and write goes through it: the
// order changes which warp computes a token, never what it computes.
//
// Work count, while a trace asks for it (a counter pointer given): the live
// entries gathered, summed over tokens; one atomicAdd a block.
//
// Numerics: the plain torch version (kernels/cdf_search.py) forms each
// weight with the same float32 operations in the same order as
// zen_cdf.doc_rows and adds in exactly this order, so the two are
// bit-equal on the card (-fmad=false: no contraction). A word, doc, topic
// or order entry out of range aborts the launch (__trap).

// strips of a row loaded and scanned at once; a row of up to 32 kGroup
// entries stays in registers
constexpr int kGroup = 4;
constexpr int kSpan = 32 * kGroup;
// tokens (warps) per block of doc_row_kernel
constexpr int kDocWarps = 8;

// the counter of live doc-row entries that a launch given it adds to
__device__ unsigned long long g_row_entries = 0;

// One group of a doc row from entry g0: each strip's prefix sums (plus the
// carry before it) into pre; the carry grows by the group's weights and
// live by the group's live entries.
__device__ __forceinline__ void row_group(
    const int* __restrict__ cnt_row, const int* __restrict__ idx_row,
    const int* __restrict__ nwk_row, const float* __restrict__ t1,
    float beta, int J, int K, int g0, int lane, float& carry,
    float (&pre)[kGroup], int& live) {
  int c[kGroup], k[kGroup], n[kGroup];
  float w[kGroup];
#pragma unroll
  for (int s = 0; s < kGroup; ++s) {
    const int e = g0 + 32 * s + lane;
    c[s] = e < J ? cnt_row[e] : 0;
    k[s] = e < J ? idx_row[e] : 0;
  }
#pragma unroll
  for (int s = 0; s < kGroup; ++s) {
    if (k[s] < 0 || k[s] >= K) __trap();
    n[s] = 0;
    w[s] = 0.0f;
    if (c[s] > 0) {
      n[s] = nwk_row[k[s]];
      w[s] = __ldg(t1 + k[s]);
    }
  }
#pragma unroll
  for (int s = 0; s < kGroup; ++s) {
    const unsigned any = __ballot_sync(kFull, c[s] > 0);
    live += __popc(any);
    if (any == 0u) {  // every weight 0: each prefix is the carry
      pre[s] = carry;
      continue;
    }
    float x = c[s] > 0 ? ((float)c[s] * ((float)n[s] + beta)) * w[s] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x = x + y;
    }
    pre[s] = carry + x;
    carry = carry + __shfl_sync(kFull, x, 31);
  }
}

// the real lanes of a group whose prefix lies below each draw's target
__device__ __forceinline__ void count_group(const float (&pre)[kGroup],
                                            int J, int g0, int lane,
                                            float t3a, float t3b, int& ca,
                                            int& cb) {
#pragma unroll
  for (int s = 0; s < kGroup; ++s) {
    const bool real = g0 + 32 * s + lane < J;
    ca += __popc(__ballot_sync(kFull, real && pre[s] < t3a));
    cb += __popc(__ballot_sync(kFull, real && pre[s] < t3b));
  }
}

__global__ void __launch_bounds__(kDocWarps * 32)
doc_row_kernel(const int* __restrict__ n_wk, const int* __restrict__ word,
               const int* __restrict__ doc, const int* __restrict__ kd_cnt,
               const int* __restrict__ kd_idx, const float* __restrict__ t1,
               const float* __restrict__ m2_all,
               const float* __restrict__ g_cdf,
               const float* __restrict__ u_a, const float* __restrict__ u_b,
               const int* __restrict__ order,
               float* __restrict__ total, int* __restrict__ z,
               unsigned long long* __restrict__ entries, int T, int K, int J,
               int W, int D, float beta) {
  __shared__ int warp_live[kDocWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kDocWarps + warp;
  int live = 0;
  if (i < T) {  // uniform per warp: the shuffles stay full-mask
    const int t = order != nullptr ? order[i] : i;
    if (t < 0 || t >= T) __trap();
    const int wd = word[t], d = doc[t];
    if (wd < 0 || wd >= W || d < 0 || d >= D) __trap();
    const int* cnt_row = kd_cnt + (size_t)d * (size_t)J;
    const int* idx_row = kd_idx + (size_t)d * (size_t)J;
    const int* nwk_row = n_wk + (size_t)wd * (size_t)K;
    const float m1 = g_cdf[K - 1];
    const float m2 = m2_all[wd];
    const float ua = u_a[t], ub = u_b[t];
    float carry = 0.0f;
    float pre[kGroup];
    for (int g0 = 0; g0 < J; g0 += kSpan) {
      row_group(cnt_row, idx_row, nwk_row, t1, beta, J, K, g0, lane, carry,
                pre, live);
    }
    const float tot = (m1 + m2) + carry;
    const float t3a = fmaxf((ua * tot - m1) - m2, 0.0f);
    const float t3b = fmaxf((ub * tot - m1) - m2, 0.0f);
    int ca = 0, cb = 0;
    if (J <= kSpan) {
      count_group(pre, J, 0, lane, t3a, t3b, ca, cb);
    } else {
      int again = 0;
      carry = 0.0f;
      for (int g0 = 0; g0 < J; g0 += kSpan) {
        row_group(cnt_row, idx_row, nwk_row, t1, beta, J, K, g0, lane,
                  carry, pre, again);
        count_group(pre, J, g0, lane, t3a, t3b, ca, cb);
      }
    }
    if (lane == 0) {
      total[t] = tot;
      z[t] = idx_row[ca < J - 1 ? ca : J - 1];
      z[(size_t)T + t] = idx_row[cb < J - 1 ? cb : J - 1];
    }
  }
  if (entries != nullptr) {  // uniform per launch
    if (lane == 0) warp_live[warp] = live;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long n = 0;
      for (int i = 0; i < kDocWarps; ++i) {
        n += (unsigned long long)warp_live[i];
      }
      if (n > 0) atomicAdd(entries, n);
    }
  }
}

}  // namespace

// The counter of queued tokens on the current card: where it is, for a
// launch to add to, and, where `value` is not null, what it holds (a
// blocking copy, after the card's earlier work). Returns the CUDA error.
extern "C" int cdf_search_searched(void** at, unsigned long long* value) {
  int err = (int)cudaGetSymbolAddress(at, g_searched_tokens);
  if (err == 0 && value != nullptr) {
    err = (int)cudaMemcpyFromSymbol(value, g_searched_tokens,
                                    sizeof(*value));
  }
  return err;
}

// Plain C launcher for ctypes: `queue` is int32 scratch of 4 (T + 1)
// entries, 16-byte aligned: its first int holds the queue's length, then
// one (token, row, target bits, 0) entry per searching token; `searched`
// (or null: none) the counter this launch adds its queued tokens to.
// Launches on `stream` (a memset and two kernels), does not synchronise,
// and returns cudaGetLastError() (0 = launched).
extern "C" int cdf_search(const int* counts, const int* rows,
                          const float* term, const float* targets, int* out,
                          int* queue, int T, int K, int R,
                          unsigned long long* searched, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int* queue_len = queue;
  int4* entries = reinterpret_cast<int4*>(queue) + 1;
  int err = (int)cudaMemsetAsync(queue_len, 0, sizeof(int), s);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)((T + kTokensPerBlock - 1)
                                     / kTokensPerBlock);
  cdf_compact_kernel<<<blocks, kThreads, 0, s>>>(
      rows, targets, out, entries, queue_len, searched, T, R);
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

// The counter of live doc-row entries on the current card: where it is,
// and, where `value` is not null, what it holds (as cdf_search_searched).
extern "C" int doc_row_search_entries(void** at, unsigned long long* value) {
  int err = (int)cudaGetSymbolAddress(at, g_row_entries);
  if (err == 0 && value != nullptr) {
    err = (int)cudaMemcpyFromSymbol(value, g_row_entries, sizeof(*value));
  }
  return err;
}

// Plain C launcher for ctypes: `total` (T,) float32 and `z` (2, T) int32
// out; `order` (or null: token order) a permutation of the T tokens, the
// one warp i takes being order[i]; `entries` (or null: none) the counter
// this launch adds its live row entries to. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int doc_row_search(const int* n_wk, const int* word,
                              const int* doc, const int* kd_cnt,
                              const int* kd_idx, const float* t1,
                              const float* m2_all, const float* g_cdf,
                              const float* u_a, const float* u_b,
                              const int* order, float* total, int* z, int T,
                              int K, int J, int W, int D, float beta,
                              unsigned long long* entries, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((T + kDocWarps - 1) / kDocWarps);
  doc_row_kernel<<<blocks, kDocWarps * 32, 0, (cudaStream_t)stream>>>(
      n_wk, word, doc, kd_cnt, kd_idx, t1, m2_all, g_cdf, u_a, u_b, order,
      total, z, entries, T, K, J, W, D, beta);
  return (int)cudaGetLastError();
}
