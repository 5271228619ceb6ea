// Signed topic-delta histogram for Hopper (sm_90a).
//
//   topic_histogram  replaces _hist_kernel / topic_histogram_pallas
//                    (src/repro/kernels/topic_histogram.py):
//                      out[r, k] = sum_t inc[t] * ([k == z_new[t]]
//                                                 - [k == z_old[t]])
//                    over tokens t of row rows[t]: an (R, K) int32 matrix,
//                    the per-row count deltas of one sweep.
//
// What bounds it: the (R, K) output written once and each token's ids
// read once: R K 4 + T (12 or 16) bytes (inc may be absent: every token
// counts once), the least time the card could take.
//
// Design: the TPU kernel avoids scatters (serialised there): it expands
// each tile of row-sorted tokens into one-hot rank x topic matrices and
// contracts them on the MXU. Here the tokens are walked in an order along
// which their rows do not decrease: the tokens' own order (doc rows of a
// corpus in doc order), or a permutation `perm` with the rows already
// gathered into that order (`rows[i]` is the row of token perm[i]; the
// session builds the word-major order of its corpus once). Each block
// takes kChunk consecutive positions and stages kTile of them at a time
// in shared memory (the loads run a tile ahead, their tokens two), finds
// the runs of equal rows (ballot-ranked run starts) and accumulates them
// with shared-memory atomics into K-wide histograms: no token costs a
// global atomic. A run that starts and ends inside one tile goes to one
// warp, into the warp's own histogram, so that the many short rows of a
// Zipf tail are written by eight warps at once; the run that reaches the
// tile's end goes to the whole block, into the block's histogram, so that
// a long row's tokens are added by every thread. A run whose row lies
// wholly inside the block is written whole, zeros included, with plain
// (16-byte, where K allows) stores; the rows between two runs have no
// tokens and are written as zeros by whoever writes the next run (the
// first block also zeroes the rows before the first run, the last those
// after the last): the zero fill is folded into the kernel, and each
// output byte is written once. A run cut by a block boundary (a long row:
// Zipf's top word holds ~20% of a corpus, spread over ~1,200 blocks)
// flushes its non-zero entries with one global atomicAdd each, onto a row
// that a small kernel before it zeroed: a hot row is spread over many
// blocks and never serialised on one address.
//
// K too wide for the block's and eight warps' histograms in what a block
// can opt into: the block takes every run itself, one after another; K
// too wide for the block's alone: the launcher splits the topics into
// slabs of the widest range that fits and a block walks its positions once
// per slab, keeping only that slab's topics. Both from K and the card
// alone (topic_histogram_shape reports the choice).
//
// The walk's rows must not decrease: the wrapper sorts rows given in any
// other order (topic_histogram.row_order), and a decrease along a walk it
// is handed aborts the launch like an id out of range.
//
// Work count, while a trace asks for it (a counter pointer given): the
// tokens whose topic changes (inc != 0 and z_old != z_new), the kernel's
// useful work, counted as the first slab stages them and added to the
// counter with one atomic a block. With no pointer the kernel pays one
// uniform branch; its output is the same either way.
//
// An id outside its range (row not in [0, R), topic not in [0, K), a
// permutation entry not in [0, T)) or a row below its predecessor's
// aborts the launch (__trap) before that token writes: no write lands out
// of bounds, and the error surfaces at the caller's next synchronize.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;  // positions staged in shared memory per pass
constexpr int kPerThread = kTile / kThreads;
constexpr int kChunk = 16 * kTile;  // positions per block
constexpr int kZeroBlocksPerSm = 4;
constexpr unsigned kFull = 0xffffffffu;

// the counter of changed tokens that a launch given it adds to: zero when
// the library loads, added to only by launches made while tracing
__device__ unsigned long long g_changed_tokens = 0;

struct Walk {
  const int* rows;  // row at each walk position
  const int* perm;  // token at each walk position; null: the position
  const int* z_old;
  const int* z_new;
  const int* inc;  // null: every token counts once
  int* out;
  unsigned long long* changed;  // null: no count of changed tokens
  int T, R, K;
};

// zero rows [lo, hi] in topic columns [k0, k0 + ks), by `n` threads of
// which this is thread `i`
__device__ void zero_rows(const Walk& w, int lo, int hi, int k0, int ks,
                          int i, int n) {
  if (hi < lo) return;
  if (ks == w.K) {  // whole rows: one contiguous range
    int* dst = w.out + (size_t)lo * (size_t)w.K;
    const size_t len = (size_t)(hi - lo + 1) * (size_t)w.K;
    if (w.K % 4 == 0) {
      int4* dst4 = reinterpret_cast<int4*>(dst);
      for (size_t j = i; j < len / 4; j += n) dst4[j] = make_int4(0, 0, 0, 0);
    } else {
      for (size_t j = i; j < len; j += n) dst[j] = 0;
    }
    return;
  }
  for (int r = lo; r <= hi; ++r) {
    int* dst = w.out + (size_t)r * (size_t)w.K + k0;
    for (int k = i; k < ks; k += n) dst[k] = 0;
  }
}

// write histogram `h` of row r, topic columns [k0, k0 + ks), and clear it,
// by `n` threads of which this is thread `i`: whole (zeros included) when
// the run is local, else its non-zero entries by atomics onto a row
// zeroed before the launch
__device__ void write_row(const Walk& w, int* h, int r, bool local, int k0,
                          int ks, int i, int n) {
  int* dst = w.out + (size_t)r * (size_t)w.K + k0;
  if (local && ks == w.K && w.K % 4 == 0) {  // 16-byte stores
    int4* h4 = reinterpret_cast<int4*>(h);
    int4* dst4 = reinterpret_cast<int4*>(dst);
    for (int k = i; k < ks / 4; k += n) {
      dst4[k] = h4[k];
      h4[k] = make_int4(0, 0, 0, 0);
    }
    return;
  }
  for (int k = i; k < ks; k += n) {
    const int v = h[k];
    h[k] = 0;
    if (local) {
      dst[k] = v;
    } else if (v != 0) {
      atomicAdd(dst + k, v);
    }
  }
}

// add positions [a, e) of the staged tile into histogram `h` (topic
// columns [k0, k0 + ks)), by `n` threads of which this is thread `i`
__device__ __forceinline__ void accumulate(int* h, const int* s_zo,
                                           const int* s_zn, const int* s_v,
                                           int a, int e, int k0, int ks,
                                           int i, int n) {
  for (int j = a + i; j < e; j += n) {
    const int v = s_v[j];
    const int zo = s_zo[j] - k0;
    const int zn = s_zn[j] - k0;
    if (v == 0 || zo == zn) continue;  // the two entries cancel
    if ((unsigned)zn < (unsigned)ks) atomicAdd(h + zn, v);
    if ((unsigned)zo < (unsigned)ks) atomicAdd(h + zo, -v);
  }
}

// one thread's share of a tile: its tokens, then their rows and topics
struct Stage {
  int tok[kPerThread];
  int row[kPerThread], zo[kPerThread], zn[kPerThread], v[kPerThread];
};

__device__ __forceinline__ void load_tokens(const Walk& w, Stage& st, int s,
                                            int i1) {
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    const int i = s + m * kThreads + threadIdx.x;
    st.tok[m] = i < i1 ? (w.perm == nullptr ? i : w.perm[i]) : 0;
  }
}

__device__ __forceinline__ void load_ids(const Walk& w, Stage& st, int s,
                                         int i1) {
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    const int i = s + m * kThreads + threadIdx.x;
    if (i < i1) {
      const int t = st.tok[m];
      if (t < 0 || t >= w.T) __trap();
      st.row[m] = w.rows[i];
      st.zo[m] = w.z_old[t];
      st.zn[m] = w.z_new[t];
      st.v[m] = w.inc == nullptr ? 1 : w.inc[t];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hist_sorted_kernel(Walk w, int slab, int warp_runs) {
  extern __shared__ int4 smem4[];
  int* hist = reinterpret_cast<int*>(smem4);  // the block's: slab topics
  // warp_runs: each warp's own K topics, after the block's (slab == K)
  int* whist = hist + slab + (threadIdx.x >> 5) * w.K;
  __shared__ int s_row[kTile], s_zo[kTile], s_zn[kTile], s_v[kTile];
  __shared__ int s_start[kTile];
  __shared__ int s_count[kPerThread][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = blockIdx.x * kChunk;
  const int i1 = min(w.T, i0 + kChunk);
  const int prev_row = i0 > 0 ? w.rows[i0 - 1] : -1;
  const int next_row = i1 < w.T ? w.rows[i1] : -1;
  const bool counting = w.changed != nullptr;
  unsigned changed = 0;  // this thread's staged tokens that change topic

  for (int k0 = 0; k0 < w.K; k0 += slab) {
    const int ks = min(slab, w.K - k0);
    for (int k = threadIdx.x; k < ks; k += kThreads) hist[k] = 0;
    if (warp_runs) {
      for (int k = lane; k < w.K; k += 32) whist[k] = 0;
    }
    // the open run: its row, and whether it started in this block
    int cur = -1;
    bool cur_here = false;
    int last = prev_row;  // row at the position before the tile
    if (w.rows[i0] == prev_row) cur = prev_row;
    // the loads run one tile ahead (their tokens two tiles ahead)
    Stage st, ahead;
    load_tokens(w, st, i0, i1);
    load_ids(w, st, i0, i1);
    load_tokens(w, ahead, i0 + kTile, i1);
    for (int s = i0; s < i1; s += kTile) {
      const int n = min(kTile, i1 - s);
#pragma unroll
      for (int m = 0; m < kPerThread; ++m) {
        const int j = m * kThreads + threadIdx.x;
        if (j < n) {
          if (st.row[m] < 0 || st.row[m] >= w.R || st.zo[m] < 0
              || st.zo[m] >= w.K || st.zn[m] < 0 || st.zn[m] >= w.K)
            __trap();
          s_row[j] = st.row[m];
          s_zo[j] = st.zo[m];
          s_zn[j] = st.zn[m];
          s_v[j] = st.v[m];
          if (counting && k0 == 0) {
            changed += (st.v[m] != 0) & (st.zo[m] != st.zn[m]);
          }
        }
      }
      if (s + kTile < i1) {  // the staged registers are free again
#pragma unroll
        for (int m = 0; m < kPerThread; ++m) st.tok[m] = ahead.tok[m];
        load_ids(w, st, s + kTile, i1);
        load_tokens(w, ahead, s + 2 * kTile, i1);
      }
      __syncthreads();
      // run starts, ranked in position order: (pass m, warp, lane)
      bool start[kPerThread];
      unsigned ballot[kPerThread];
#pragma unroll
      for (int m = 0; m < kPerThread; ++m) {
        const int j = m * kThreads + threadIdx.x;
        const int before = j == 0 ? last : (j < n ? s_row[j - 1] : 0);
        start[m] = j < n && s_row[j] != before;
        if (j < n && s_row[j] < before) __trap();  // not a sorted walk
        ballot[m] = __ballot_sync(kFull, start[m]);
        if (lane == 0) s_count[m][warp] = __popc(ballot[m]);
      }
      __syncthreads();
      // every warp scans the kPerThread x kWarps (= 32) counts itself
      static_assert(kPerThread * kWarps == 32, "one count per lane");
      const int count = (&s_count[0][0])[lane];
      int incl = count;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      const int ns = __shfl_sync(kFull, incl, 31);
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int m = 0; m < kPerThread; ++m) {
        const int base = __shfl_sync(kFull, incl - count, m * kWarps + warp);
        if (start[m]) {
          s_start[base + __popc(ballot[m] & below)] =
              m * kThreads + threadIdx.x;
        }
      }
      __syncthreads();
      // the open run goes on up to the tile's first start
      const int a0 = ns > 0 ? s_start[0] : n;
      accumulate(hist, s_zo, s_zn, s_v, 0, a0, k0, ks, threadIdx.x,
                 kThreads);
      if (ns > 0) {
        if (cur >= 0) {  // it ends here
          __syncthreads();
          write_row(w, hist, cur, cur_here, k0, ks, threadIdx.x, kThreads);
          __syncthreads();
        }
        // the runs that start and end in this tile: local to the block;
        // each zeroes the rows between its predecessor's row and its own
        if (warp_runs) {  // one warp each
          for (int g = warp; g < ns - 1; g += kWarps) {
            const int a = s_start[g], e = s_start[g + 1], r = s_row[a];
            zero_rows(w, (a > 0 ? s_row[a - 1] : last) + 1, r - 1, 0, w.K,
                      lane, 32);
            accumulate(whist, s_zo, s_zn, s_v, a, e, 0, w.K, lane, 32);
            __syncwarp();
            write_row(w, whist, r, true, 0, w.K, lane, 32);
            __syncwarp();
          }
        } else {  // the whole block, one after another
          for (int g = 0; g < ns - 1; ++g) {
            const int a = s_start[g], e = s_start[g + 1], r = s_row[a];
            zero_rows(w, (a > 0 ? s_row[a - 1] : last) + 1, r - 1, k0, ks,
                      threadIdx.x, kThreads);
            accumulate(hist, s_zo, s_zn, s_v, a, e, k0, ks, threadIdx.x,
                       kThreads);
            __syncthreads();
            write_row(w, hist, r, true, k0, ks, threadIdx.x, kThreads);
            __syncthreads();
          }
        }
        // the tile's last run: the block's open run from here on
        const int a = s_start[ns - 1];
        cur = s_row[a];
        cur_here = true;
        zero_rows(w, (a > 0 ? s_row[a - 1] : last) + 1, cur - 1, k0, ks,
                  threadIdx.x, kThreads);
        accumulate(hist, s_zo, s_zn, s_v, a, n, k0, ks, threadIdx.x,
                   kThreads);
      }
      last = s_row[n - 1];
      __syncthreads();  // the tile is read before the next one is staged
    }
    write_row(w, hist, cur, cur_here && next_row != cur, k0, ks,
              threadIdx.x, kThreads);
    if (i1 == w.T) {
      zero_rows(w, cur + 1, w.R - 1, k0, ks, threadIdx.x, kThreads);
    }
    __syncthreads();  // the histogram is clear before the next slab
  }
  if (counting) {  // the warps' sums, then one atomic for the block
    changed = __reduce_add_sync(kFull, changed);
    if (lane == 0) (&s_count[0][0])[warp] = (int)changed;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long n = 0;
      for (int v = 0; v < kWarps; ++v) n += (unsigned)(&s_count[0][0])[v];
      if (n > 0) atomicAdd(w.changed, n);
    }
  }
}

// zero each row that a block boundary cuts (its blocks add by atomics)
__global__ void __launch_bounds__(kThreads)
zero_cut_rows_kernel(const int* __restrict__ rows, int* __restrict__ out,
                     int T, int R, int K) {
  const int b = 1 + blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long p = (long)b * kChunk;
  if (p >= T) return;
  const int r = rows[p];
  if (r != rows[p - 1] || r < 0 || r >= R) return;  // range: traps later
  int* dst = out + (size_t)r * (size_t)K;
  for (int k = threadIdx.x & 31; k < K; k += 32) dst[k] = 0;
}

// the output of no token: zeros
__global__ void __launch_bounds__(kThreads)
zero_fill_kernel(int* __restrict__ out, size_t n) {
  const size_t first = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = first; i < n; i += stride) out[i] = 0;
}

// The launch's shape, from K and the card alone: with room for the
// block's histogram and one per warp, the runs inside a tile go one per
// warp; else the block takes every run itself, in slabs of the widest
// topic range that fits when K does not.
struct Shape {
  int slab, warp_runs, dynamic_bytes;
};

Shape launch_shape(int K) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, hist_sorted_kernel);
  const long room = ((long)optin - (long)attr.sharedSizeBytes)
                    / (long)sizeof(int);
  if ((long)(1 + kWarps) * K <= room) {
    return {K, 1, (1 + kWarps) * K * (int)sizeof(int)};
  }
  const int slab = K < room ? K : (int)room;
  return {slab, 0, slab * (int)sizeof(int)};
}

}  // namespace

// The launch's shape for K topics on the current card: the topics a block
// keeps in shared memory at once (K itself when it fits) and whether short
// runs go one per warp.
extern "C" int topic_histogram_shape(int K, int* slab, int* warp_runs) {
  const Shape shape = launch_shape(K);
  *slab = shape.slab;
  *warp_runs = shape.warp_runs;
  return (int)cudaGetLastError();
}

// The counter of changed tokens on the current card: where it is, for a
// launch to add to, and, where `value` is not null, what it holds (a
// blocking copy, after the card's earlier work). Returns the CUDA error.
extern "C" int topic_histogram_changed(void** at,
                                       unsigned long long* value) {
  int err = (int)cudaGetSymbolAddress(at, g_changed_tokens);
  if (err == 0 && value != nullptr) {
    err = (int)cudaMemcpyFromSymbol(value, g_changed_tokens, sizeof(*value));
  }
  return err;
}

// Plain C launcher for ctypes. `rows` holds the row at each walk position,
// not decreasing; `perm` (or null) the token at each position; `inc` (or
// null: 1 for every token); `out` is (R, K) int32; `changed` (or null:
// none) the counter this launch adds its changed tokens to. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 =
// launched).
extern "C" int topic_histogram(const int* rows, const int* perm,
                               const int* z_old, const int* z_new,
                               const int* inc, int* out, int T, int R, int K,
                               unsigned long long* changed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= 0) {  // no token: the output is zeros
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const unsigned blocks =
        (unsigned)((sms > 0 ? sms : 1) * kZeroBlocksPerSm);
    zero_fill_kernel<<<blocks, kThreads, 0, s>>>(out, (size_t)R * (size_t)K);
    return (int)cudaGetLastError();
  }
  int err = 0;
  const unsigned blocks = (unsigned)((T + kChunk - 1) / kChunk);
  if (blocks > 1) {
    const unsigned cuts = (blocks - 1 + kWarps - 1) / kWarps;
    zero_cut_rows_kernel<<<cuts, kThreads, 0, s>>>(rows, out, T, R, K);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const Shape shape = launch_shape(K);
  err = (int)cudaFuncSetAttribute(hist_sorted_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  shape.dynamic_bytes);
  if (err != 0) return err;
  const Walk w{rows, perm, z_old, z_new, inc, out, changed, T, R, K};
  hist_sorted_kernel<<<blocks, kThreads, shape.dynamic_bytes, s>>>(
      w, shape.slab, shape.warp_runs);
  return (int)cudaGetLastError();
}
