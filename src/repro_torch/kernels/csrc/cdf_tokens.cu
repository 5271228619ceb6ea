// zen_cdf's per-token draws and remedy on the kernel route, for Hopper
// (sm_90a). No TPU kernel: the reference computes them with XLA ops
// (src/repro/algorithms/zen_cdf.py, zen_cdf_cell's draw and remedy).
//
// A token chunk on the kernel route runs, in order,
//   cdf_uniforms_kernel  the chunk's three uniform streams, (3, n) float32:
//               entry (s, i) = (mix(seed ^ row_i·GOLD ^ mix(s)) >> 8)·2^-24,
//               row_i the token's global index (start + i, or token_index[i]
//               for a mesh cell's corpus indices), as core.keys'
//               stream_uniforms hashes it;
//   doc_row_kernel (cdf_search.cu): each token's total mass and the term-3
//               topics of both draws;
//   cdf_draws_kernel  for draws a and b: u = u01·total, the branch (u < m1:
//               term 1; u < m1 + m2_all[word]: term 2; else term 3), on
//               branch 1 the term-2 target max(u - m1, 0) kernel 7 searches
//               (0 elsewhere), and a code: the term-1 topic (the lower bound
//               of u in g_cdf, torch.searchsorted's left side, clamped to
//               K - 1) on branch 0, -1 on branch 1 (kernel 7 answers), and
//               -2 - z3 on branch 2 (z3 the term-3 topic);
//   kernel 7 (cdf_search.cu), once a draw, on the targets;
//   cdf_remedy_kernel  each draw's topic from its code and kernel 7's answer,
//               clamped to K - 1; then the paper's §3.1 remedy: where draw a's
//               topic z1 equals the token's previous topic and draw a took
//               term 2 or 3, p = 1/max(n_wk[w, z_old], 1) (term 2) or
//               clamp(1/nd + (nd + nw - 1)/(nd·nw), 0, 1) (term 3, nd and nw
//               the previous topic's counts clamped to 1), and the token takes
//               draw b's topic where u_remedy < p.
// So no int64 or other per-token temporary crosses HBM but the uniforms, the
// targets, the codes and kernel 7's answers.
//
// What bounds them: bytes. Per token the uniforms write 12 B; the draws read
// the word, the total, two uniforms and (on branch 2) the term-3 topics, 24 B,
// and write two targets and two codes, 16 B (m2_all, 0.4 MB at NYTimes width,
// and g_cdf, 4 KB at K = 1000, stay in L2 and L1); the remedy reads the two
// codes, the previous topic and the output, 12 B, and, where z1 equals the
// previous topic, the remedy uniform and, if draw a took term 2 or 3, the
// word, doc and one 32-byte n_wk sector (n_kd[d, ·] is shared by a doc's
// tokens, which lie together); kernel 7's answer only on branch 1.
// About 100 B a token in all.
//
// Design: one thread per token in each kernel, every access coalesced but the
// n_wk gather. The term-1 search is a binary search over g_cdf read through
// the read-only cache, done only where the draw takes term 1; the remedy's
// gathers only where it can engage. Nothing in a token's result depends on
// another token.
//
// Work count, while a trace asks for it (a counter pointer given): the tokens
// whose remedy takes draw b; one atomicAdd a block.
//
// Numerics: every float operation is the torch chain's (kernels/cdf_tokens.py,
// the plain versions), in its order: one multiply for u, the two branch
// compares against m1 and m1 + m2, the subtraction and max for the target,
// torch.searchsorted's comparison (!(g >= u): go right), and the remedy's
// conversions, clamps, reciprocals, sums, product and quotient, each rounded
// on its own (-fmad=false) with IEEE division (no fast math). So the kernels
// are bit-equal to their plain versions on the card. A word, doc or previous
// topic out of range aborts the launch (__trap).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kGold = 0x9E3779B9u;

// the counter of tokens whose remedy takes draw b that a launch given it
// adds to: zero when the library loads
__device__ unsigned long long g_remedy_second = 0;

// the hash's avalanche mixer (zen_train.cu's, kernels/zen_sampler.py's _mix)
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x = (x ^ (x >> 16)) * kM1;
  x = (x ^ (x >> 13)) * kM2;
  return x ^ (x >> 16);
}

__global__ void __launch_bounds__(kThreads)
cdf_uniforms_kernel(uint32_t seed, uint32_t start,
                    const int* __restrict__ token_index,
                    float* __restrict__ out, int n, int streams) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t row = token_index != nullptr
                           ? (uint32_t)__ldg(token_index + i)
                           : start + (uint32_t)i;  // mod 2^32, as u32(row)
  const uint32_t base = seed ^ (row * kGold);
  for (int s = 0; s < streams; ++s) {
    const uint32_t h = mix(base ^ mix((uint32_t)s));
    out[(size_t)s * (size_t)n + i] = (float)(h >> 8) * (1.0f / 16777216.0f);
  }
}

// torch.searchsorted's lower bound of u in the K sorted floats of g,
// clamped to K - 1
__device__ __forceinline__ int search_left(const float* __restrict__ g, int K,
                                           float u) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(__ldg(g + mid) >= u)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < K - 1 ? lo : K - 1;
}

__global__ void __launch_bounds__(kThreads)
cdf_draws_kernel(const int* __restrict__ word, const float* __restrict__ total,
                 const float* __restrict__ u_a, const float* __restrict__ u_b,
                 const float* __restrict__ m2_all,
                 const float* __restrict__ g_cdf,
                 const int* __restrict__ z_d, float* __restrict__ targets,
                 int* __restrict__ code, int T, int K, int W) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int w = word[t];
  if (w < 0 || w >= W) __trap();
  const float m1 = __ldg(g_cdf + K - 1);
  const float m12 = m1 + __ldg(m2_all + w);
  const float tot = total[t];
  const float u01[2] = {u_a[t], u_b[t]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at = (size_t)i * (size_t)T + t;
    const float u = u01[i] * tot;
    float target = 0.0f;
    int c;
    if (u < m1) {
      c = search_left(g_cdf, K, u);
    } else if (u < m12) {
      c = -1;
      target = fmaxf(u - m1, 0.0f);
    } else {  // term 3, and a NaN u, as torch.where's chain has it
      c = -2 - z_d[at];
    }
    targets[at] = target;
    code[at] = c;
  }
}

// a draw's topic from its code and kernel 7's answer, clamped to K - 1
__device__ __forceinline__ int topic_of(int c, const int* __restrict__ z_w,
                                        int t, int K) {
  const int z = c >= 0 ? c : (c == -1 ? z_w[t] : -2 - c);
  return z < K - 1 ? z : K - 1;
}

__global__ void __launch_bounds__(kThreads)
cdf_remedy_kernel(const int* __restrict__ code, const int* __restrict__ z_wa,
                  const int* __restrict__ z_wb,
                  const int* __restrict__ z_old,
                  const int* __restrict__ word, const int* __restrict__ doc,
                  const int* __restrict__ n_wk, const int* __restrict__ n_kd,
                  const float* __restrict__ u_r, int* __restrict__ out,
                  unsigned long long* __restrict__ second, int T, int K,
                  int W, int D) {
  __shared__ int warp_second[kWarps];
  const int t = blockIdx.x * kThreads + threadIdx.x;
  bool took = false;
  if (t < T) {
    const int ca = code[t];
    const int zo = z_old[t];
    if (zo < 0 || zo >= K) __trap();
    int z = topic_of(ca, z_wa, t, K);
    if (z == zo) {  // draw a drew the previous topic: the remedy may engage
      float p = 0.0f;  // term 1 is never stale
      if (ca < 0) {  // term 2 or 3: the previous topic's counts
        const int w = word[t], d = doc[t];
        if (w < 0 || w >= W || d < 0 || d >= D) __trap();
        const float nw =
            fmaxf((float)n_wk[(size_t)w * (size_t)K + zo], 1.0f);
        const float nd =
            fmaxf((float)n_kd[(size_t)d * (size_t)K + zo], 1.0f);
        if (ca == -1) {
          p = 1.0f / nw;
        } else {
          p = 1.0f / nd + ((nd + nw) - 1.0f) / (nd * nw);
          p = fminf(fmaxf(p, 0.0f), 1.0f);
        }
      }
      if (u_r[t] < p) {
        z = topic_of(code[(size_t)T + t], z_wb, t, K);
        took = true;
      }
    }
    out[t] = z;
  }
  if (second != nullptr) {  // uniform per launch
    const unsigned n = __popc(__ballot_sync(kFull, took));
    if ((threadIdx.x & 31) == 0) warp_second[threadIdx.x >> 5] = (int)n;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long sum = 0;
      for (int i = 0; i < kWarps; ++i) {
        sum += (unsigned long long)warp_second[i];
      }
      if (sum > 0) atomicAdd(second, sum);
    }
  }
}

unsigned blocks_for(long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C launcher for ctypes: `out` (streams, n) float32; `token_index`
// (n,) int32, or null for rows start, start + 1, ... (mod 2^32). Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 =
// launched).
extern "C" int cdf_uniforms(unsigned seed, unsigned start,
                            const int* token_index, float* out, int n,
                            int streams, void* stream) {
  if (n <= 0 || streams <= 0) return (int)cudaGetLastError();
  cdf_uniforms_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      seed, start, token_index, out, n, streams);
  return (int)cudaGetLastError();
}

// Plain C launcher for ctypes: `z_d` (2, T) int32 in (the term-3 topics of
// draws a and b); `targets` (2, T) float32 and `code` (2, T) int32 out.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int cdf_draws(const int* word, const float* total, const float* u_a,
                         const float* u_b, const float* m2_all,
                         const float* g_cdf, const int* z_d, float* targets,
                         int* code, int T, int K, int W, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  cdf_draws_kernel<<<blocks_for(T), kThreads, 0, (cudaStream_t)stream>>>(
      word, total, u_a, u_b, m2_all, g_cdf, z_d, targets, code, T, K, W);
  return (int)cudaGetLastError();
}

// The counter of tokens whose remedy takes draw b on the current card: where
// it is, and, where `value` is not null, what it holds (a blocking copy,
// after the card's earlier work). Returns the CUDA error.
extern "C" int cdf_remedy_second(void** at, unsigned long long* value) {
  int err = (int)cudaGetSymbolAddress(at, g_remedy_second);
  if (err == 0 && value != nullptr) {
    err = (int)cudaMemcpyFromSymbol(value, g_remedy_second, sizeof(*value));
  }
  return err;
}

// Plain C launcher for ctypes: `code` (2, T) int32 from cdf_draws, kernel 7's
// answers `z_wa` and `z_wb` (T,), `out` (T,) int32; `second` (or null: none)
// the counter this launch adds its tokens that take draw b to. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int cdf_remedy(const int* code, const int* z_wa, const int* z_wb,
                          const int* z_old, const int* word, const int* doc,
                          const int* n_wk, const int* n_kd, const float* u_r,
                          int* out, int T, int K, int W, int D,
                          unsigned long long* second, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  cdf_remedy_kernel<<<blocks_for(T), kThreads, 0, (cudaStream_t)stream>>>(
      code, z_wa, z_wb, z_old, word, doc, n_wk, n_kd, u_r, out, second, T, K,
      W, D);
  return (int)cudaGetLastError();
}
