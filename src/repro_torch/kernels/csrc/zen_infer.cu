// Frozen-model ZenLDA serving sampler for Hopper (sm_90a).
//
// Two launchers share one scoring routine, so their draws are
// bit-identical:
//
//   zen_infer_gathered  replaces _zen_infer_kernel / zen_infer_sample_pallas
//                       (src/repro/kernels/zen_sampler.py): reads row t of
//                       pre-gathered (T, K) word and doc count matrices.
//   zen_infer_fused     replaces _fused_infer_kernel /
//                       zen_fused_infer_sample_pallas
//                       (src/repro/kernels/fused_gather.py): reads the rows
//                       n_wk[word[t]] and n_kd[slot[t]] of the resident
//                       matrices directly, so no (T, K) gather exists.
//
// Each token t draws
//   z_t = argmax_k  log max(p_tk, 1e-30) + g(seed_t, 0, k)
//   p_tk = (N_kd^{not t} + alpha_k) (N_wk + beta) / (N_k + W beta)
// with doc-side self-exclusion only and Gumbel noise from the counter hash
// of the JAX package (kernels/zen_sampler.py: _mix, hash_uniform), so the
// draws equal the reference's up to the last bits of logf.
//
// What bounds it: per (t, k) the kernel reads two int32 counts and does
// three logf (two for the noise, one for p) plus about ten float32 ops.
// At the serving shapes (T = 16,384 tokens, K = 1000) the fused kernel's
// unique bytes are ~60 MB of n_wk rows (one per distinct word), ~18 us at
// 3.35 TB/s; the 49M logf take ~12 us at the special-function units' rate
// (16 per SM per clock). The gathered kernel reads 2 x 65 MB of gathered
// rows, ~39 us. Both are bound by bytes.
//
// Design: one warp per token. Lanes stride over K, so each warp reads its
// count rows as coalesced 128-byte lines, computes its scores in registers
// and keeps a running (max, argmax) with strict '>' (the first maximal
// index wins within a lane); a shuffle reduction then breaks ties to the
// lower index, which reproduces the reference's first-maximum rule across
// its K tiles. Nothing but the (T,) topics is written. Making it fast
// (keeping a slot's n_kd row in shared memory across its L tokens,
// overlapping row loads) is later work.
//
// Numerics: IEEE division and the accurate logf. The build passes
// -fmad=false and no --use_fast_math, so no multiply-add is contracted and
// each operation rounds as its plain torch version does on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x = (x ^ (x >> 16)) * kM1;
  x = (x ^ (x >> 13)) * kM2;
  return x ^ (x >> 16);
}

// Gumbel-max over one token's K topics; every lane of the warp returns
// the token's topic. Row coordinate of the noise is 0 (serving contract),
// so the hash is mix(seed ^ mix(k)).
__device__ __forceinline__ int score_argmax(
    const int* __restrict__ nwk_row, const int* __restrict__ nkd_row,
    int z_old, uint32_t seed, const float* __restrict__ alpha,
    const float* __restrict__ nk, int K, float beta, float w_beta) {
  const int lane = threadIdx.x & 31;
  float best = -INFINITY;
  int arg = 0;
  for (int k = lane; k < K; k += 32) {
    const float nw = (float)nwk_row[k];
    const float nd = (float)nkd_row[k] - (k == z_old ? 1.0f : 0.0f);
    const float p = (nd + alpha[k]) * (nw + beta) / (nk[k] + w_beta);
    const uint32_t h = mix(seed ^ mix((uint32_t)k));
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
zen_infer_gathered_kernel(const int* __restrict__ nwk_rows,
                          const int* __restrict__ nkd_rows,
                          const int* __restrict__ z_old,
                          const int* __restrict__ seeds,
                          const float* __restrict__ alpha,
                          const float* __restrict__ nk,
                          int* __restrict__ out, int T, int K, float beta,
                          float w_beta) {
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;  // uniform per warp: the shuffles stay full-mask
  const size_t row = (size_t)t * (size_t)K;
  const int z = score_argmax(nwk_rows + row, nkd_rows + row, z_old[t],
                             (uint32_t)seeds[t], alpha, nk, K, beta, w_beta);
  if ((threadIdx.x & 31) == 0) out[t] = z;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
zen_infer_fused_kernel(const int* __restrict__ n_wk,
                       const int* __restrict__ n_kd,
                       const int* __restrict__ word,
                       const int* __restrict__ slot,
                       const int* __restrict__ z_old,
                       const int* __restrict__ seeds,
                       const float* __restrict__ alpha,
                       const float* __restrict__ nk, int* __restrict__ out,
                       int T, int K, int W, int B, float beta,
                       float w_beta) {
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;
  const int w = word[t];
  const int d = slot[t];
  // An id outside its matrix aborts the launch, as torch's own indexing
  // does on the card: the error surfaces at the caller's next synchronize.
  if (w < 0 || w >= W || d < 0 || d >= B) __trap();
  const int z = score_argmax(n_wk + (size_t)w * (size_t)K,
                             n_kd + (size_t)d * (size_t)K, z_old[t],
                             (uint32_t)seeds[t], alpha, nk, K, beta, w_beta);
  if ((threadIdx.x & 31) == 0) out[t] = z;
}

inline unsigned num_blocks(int T) {
  return (unsigned)((T + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// Plain C launchers for ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int zen_infer_gathered(const int* nwk_rows, const int* nkd_rows,
                                  const int* z_old, const int* seeds,
                                  const float* alpha, const float* nk,
                                  int* out, int T, int K, float beta,
                                  float w_beta, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  zen_infer_gathered_kernel<<<num_blocks(T), kWarpsPerBlock * 32, 0,
                              (cudaStream_t)stream>>>(
      nwk_rows, nkd_rows, z_old, seeds, alpha, nk, out, T, K, beta, w_beta);
  return (int)cudaGetLastError();
}

extern "C" int zen_infer_fused(const int* n_wk, const int* n_kd,
                               const int* word, const int* slot,
                               const int* z_old, const int* seeds,
                               const float* alpha, const float* nk, int* out,
                               int T, int K, int W, int B, float beta,
                               float w_beta, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  zen_infer_fused_kernel<<<num_blocks(T), kWarpsPerBlock * 32, 0,
                           (cudaStream_t)stream>>>(
      n_wk, n_kd, word, slot, z_old, seeds, alpha, nk, out, T, K, W, B, beta,
      w_beta);
  return (int)cudaGetLastError();
}
