// ZenLDA training sampler for Hopper (sm_90a).
//
// Two launchers share one scoring routine, so their draws are
// bit-identical:
//
//   zen_train_gathered  replaces _zen_sampler_kernel / zen_sample_pallas
//                       (src/repro/kernels/zen_sampler.py): reads row t of
//                       pre-gathered (T, K) word and doc count matrices.
//   zen_train_fused     replaces _fused_sample_kernel /
//                       zen_fused_sample_pallas
//                       (src/repro/kernels/fused_gather.py): reads the rows
//                       n_wk[word[t]] and n_kd[doc[t]] of the resident
//                       matrices directly, so no (T, K) gather exists.
//
// Each token t draws
//   z_t = argmax_k  log max(p_tk, 1e-30) + g(seed, row0 + t, k)
//   p_tk = (a_k b + N_wk a_k + N_kd (N_wk + b)) / (N_k + W b)
// with the token's own old topic subtracted, as a float, from all three
// counts (exact not-dw exclusion), and Gumbel noise from the counter hash
// of the JAX package (kernels/zen_sampler.py: _mix, hash_uniform) at the
// global token index row0 + t.
//
// What bounds it: per (t, k) it reads two int32 counts and does three logf
// (two for the noise, one for p) and about fifteen float32 ops. At a full
// NYTIMES sweep (T = 99.5M tokens, K = 1000) that is 3.0e11 logf, ~71 ms
// at the special-function units' rate, while the fused kernel's distinct
// bytes (n_wk 0.41 GB, n_kd 1.20 GB, per-token vectors) take ~1 ms at
// 3.35 TB/s: the launch is bound by arithmetic, the opposite of serving.
// The accurate logf is not one special-function instruction but a short
// sequence of FP32 ones, so the instruction issue rate bounds it too; the
// K loop is kept rolled (#pragma unroll 1) so that its instruction count
// per (t, k) can be read from the SASS.
//
// Design: one warp per token, as in zen_infer.cu. Lanes stride over the
// real K (no padding, so no padded topic can win: the reference's padded
// grid can return an id >= K where its noise is +inf), keep a running
// (max, argmax) with strict '>' and a shuffle reduction that breaks ties
// to the lower index: the reference's first-maximum rule. Row offsets are
// size_t (doc ids times K exceed 2^31 at larger corpora). A simple,
// correct kernel; making it fast is later work.
//
// Numerics: the terms in the reference's order, ((a b + nw a) + nd (nw+b))
// then an IEEE division (no reciprocal), the accurate logf. The build
// passes -fmad=false and no --use_fast_math, so each operation rounds as
// its plain torch version does on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kGold = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x = (x ^ (x >> 16)) * kM1;
  x = (x ^ (x >> 13)) * kM2;
  return x ^ (x >> 16);
}

// Gumbel-max over one token's K topics; every lane of the warp returns
// the token's topic. The noise hash is mix(seed ^ row * GOLD ^ mix(k)).
__device__ __forceinline__ int train_score_argmax(
    const int* __restrict__ nwk_row, const int* __restrict__ nkd_row,
    int z_old, uint32_t seed, uint32_t row, const float* __restrict__ alpha,
    const float* __restrict__ nk, int K, float beta, float w_beta) {
  const int lane = threadIdx.x & 31;
  const uint32_t seed_row = seed ^ (row * kGold);
  float best = -INFINITY;
  int arg = 0;
#pragma unroll 1
  for (int k = lane; k < K; k += 32) {
    const float self = (k == z_old) ? 1.0f : 0.0f;
    const float nw = (float)nwk_row[k] - self;
    const float nd = (float)nkd_row[k] - self;
    const float nkk = nk[k] - self;
    const float a = alpha[k];
    const float p = (a * beta + nw * a + nd * (nw + beta)) / (nkk + w_beta);
    const uint32_t h = mix(seed_row ^ mix((uint32_t)k));
    const float u = (float)(h >> 8) * (1.0f / 16777216.0f)
                    + (0.5f / 16777216.0f);
    const float g = -logf(-logf(u));
    const float s = logf(fmaxf(p, 1e-30f)) + g;
    if (s > best) {
      best = s;
      arg = k;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  return arg;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
zen_train_gathered_kernel(const int* __restrict__ nwk_rows,
                          const int* __restrict__ nkd_rows,
                          const int* __restrict__ z_old,
                          const float* __restrict__ alpha,
                          const float* __restrict__ nk,
                          int* __restrict__ out, int T, int K, int seed,
                          int row0, float beta, float w_beta) {
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;  // uniform per warp: the shuffles stay full-mask
  const size_t row = (size_t)t * (size_t)K;
  const int z = train_score_argmax(nwk_rows + row, nkd_rows + row, z_old[t],
                                   (uint32_t)seed, (uint32_t)(row0 + t),
                                   alpha, nk, K, beta, w_beta);
  if ((threadIdx.x & 31) == 0) out[t] = z;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
zen_train_fused_kernel(const int* __restrict__ n_wk,
                       const int* __restrict__ n_kd,
                       const int* __restrict__ word,
                       const int* __restrict__ doc,
                       const int* __restrict__ z_old,
                       const float* __restrict__ alpha,
                       const float* __restrict__ nk, int* __restrict__ out,
                       int T, int K, int W, int D, int seed, int row0,
                       float beta, float w_beta) {
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;
  const int w = word[t];
  const int d = doc[t];
  // An id outside its matrix aborts the launch, as torch's own indexing
  // does on the card: the error surfaces at the caller's next synchronize.
  if (w < 0 || w >= W || d < 0 || d >= D) __trap();
  const int z = train_score_argmax(n_wk + (size_t)w * (size_t)K,
                                   n_kd + (size_t)d * (size_t)K, z_old[t],
                                   (uint32_t)seed, (uint32_t)(row0 + t),
                                   alpha, nk, K, beta, w_beta);
  if ((threadIdx.x & 31) == 0) out[t] = z;
}

inline unsigned num_blocks(int T) {
  return (unsigned)((T + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// Plain C launchers for ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int zen_train_gathered(const int* nwk_rows, const int* nkd_rows,
                                  const int* z_old, const float* alpha,
                                  const float* nk, int* out, int T, int K,
                                  int seed, int row0, float beta,
                                  float w_beta, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  zen_train_gathered_kernel<<<num_blocks(T), kWarpsPerBlock * 32, 0,
                              (cudaStream_t)stream>>>(
      nwk_rows, nkd_rows, z_old, alpha, nk, out, T, K, seed, row0, beta,
      w_beta);
  return (int)cudaGetLastError();
}

extern "C" int zen_train_fused(const int* n_wk, const int* n_kd,
                               const int* word, const int* doc,
                               const int* z_old, const float* alpha,
                               const float* nk, int* out, int T, int K, int W,
                               int D, int seed, int row0, float beta,
                               float w_beta, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  zen_train_fused_kernel<<<num_blocks(T), kWarpsPerBlock * 32, 0,
                           (cudaStream_t)stream>>>(
      n_wk, n_kd, word, doc, z_old, alpha, nk, out, T, K, W, D, seed, row0,
      beta, w_beta);
  return (int)cudaGetLastError();
}
