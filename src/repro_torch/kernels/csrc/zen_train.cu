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
//   z_t = argmax_k  s_k,  s_k = logf(max(p_k, 1e-30)) + g_k
//   p_k = (a_k b + N_wk a_k + N_kd (N_wk + b)) / (N_k + W b)
//   g_k = -logf(-logf(u_k)),  u_k = m_k 2^-24 + 2^-25,  m_k = h_k >> 8
// with the token's own old topic subtracted, as a float, from all three
// counts (exact not-dw exclusion), and h_k the counter hash of the JAX
// package (kernels/zen_sampler.py: _mix, hash_uniform) at the global
// token index: token_index[t] where the caller passes one (a mesh cell's
// corpus indices), else row0 + t. The first maximum wins, as torch.argmax.
//
// Numerics of s_k (exact_score): the terms in the reference's order,
// ((a b + nw a) + nd (nw + b)), an IEEE division, the accurate logf; the
// build passes -fmad=false and no --use_fast_math, so s_k rounds as its
// plain torch version does on the card. That chain is ~148 SASS
// instructions per (t, k); a kernel that runs it for every topic is bound
// by instruction issue.
//
// Design: bound, then verify. Only a handful of topics per token can come
// near the maximum, so the kernel fully scores only those.
//
// 1. Per-topic table: {a_k, a_k b, 1/(N_k + W b) rounded to nearest, a
//    word of mix(k)}, 16 bytes, one 128-bit load per (t, k), stored
//    without bank conflicts (table_pos). A persistent grid of one 32-warp
//    block per SM keeps it in shared memory, each block building its own,
//    wherever it fits (K rounded up to 128 entries within the card's
//    opt-in shared memory: K <= 14,464 on the H100); for larger K one
//    launch builds it in global memory and the blocks read it through L1
//    (table_in_shared; chip_smoke.py times both sides of that boundary).
//    Each block takes a contiguous run of tokens, so its warps share each
//    document's doc row in L1. For every topic other than the token's own
//    z_old, N_k - 0.0f == N_k, so these are the exact expression's own
//    values.
// 2. Fast estimate, per (t, k), in log2 units: the exact hash and m, the
//    numerator n computed bit-identically to the exact chain, then
//      f_k = lg2(max(n * rcp_k, 1e-30)) - lg2(-lg2(u_k))
//    with lg2 = lg2.approx (one MUFU each). With c = -ln(ln 2),
//    s^_k = ln2 f_k + c estimates s_k. Each lane keeps its best f (and its
//    topic) and its second-best f.
// 3. Margin: |s^_k - s_k| <= kMargin = 2^-8 for every topic the estimate
//    scores. Proof: s^ - s splits into
//    (a) ln2 lg2(x) - logf(x), over every float x in [1e-30, FLT_MAX]:
//        measured by exhaustion on the card (zen_train_fast_error, run by
//        tests/test_torch_gpu.py and chip_smoke.py), E1;
//    (b) the noise estimate -ln2 lg2(-lg2(u)) - ln ln2 against
//        -logf(-logf(u)) over every m below the forced bucket: measured
//        the same way, E2;
//    (c) p^ = RN(n RN(1/d)) against p = RN(n/d) for the same n: at most
//        3 ulp relative, so |ln p^ - ln p| <= 3 2^-24 (max(., 1e-30) is
//        monotone and both clamp when n <= 0, as n is the same float);
//        logf's own rounding at p^ against p, the roundings of f's
//        subtraction, of s's addition and of the threshold below: all
//        under 2^-14 together, as |f| < 256 and |s| < 256.
//    The checks assert E1 + E2 + 2^-14 <= kMargin. On the H100: E1 =
//    9.4e-6, E2 = 2.1e-4, so the sum is 2.8e-4, 14x inside 2^-8. The
//    premise holds only for finite, moderate inputs: each block checks
//    every topic (|a| <= 2^30, |b| <= 2^30, 2^-30 <= N_k + W b <= 2^100,
//    so |n| < 2^64 and p^ is finite) and otherwise samples with the exact
//    loop alone.
// 4. Forced exact topics: every m >= kTopBucket = 2^24 - 2^12, scored
//    inline (exact_score, kept out of line so that the fast loop stays
//    small): there -log u < 2^-12 and lg2.approx of u, accurate to an
//    absolute ~2^-22 near 1, loses its relative accuracy. The exhaustive
//    check set the width: E2 is 2.1e-4 below 2^24 - 2^12, 8.2e-4 below
//    2^24 - 2^10, 3.3e-3 below 2^24 - 2^8. The bucket holds m = 2^24 - 1,
//    whose u rounds to 1.0 and whose noise is exactly +inf: it still wins,
//    as in the reference. The token's own z_old, whose counts carry the
//    exclusion, is kept out of the pass and estimated once, after it, by
//    the same chain with its own 1/(N_k - 1 + W b) (so the same margin
//    holds), or scored exactly when its m is in the bucket or that
//    denominator breaks the premise.
// 5. Verify: the warp's maximum F of the lane bests; every topic with
//    s_k equal to the exact maximum has f_k >= F - 2 kMargin / ln 2 (if
//    it were lower, s_k < s of the topic at F). If any lane's second-best
//    reaches that threshold, a third topic might too, and the warp samples
//    the token with the exact loop over every topic (exact_argmax). If one
//    lane's best c alone reaches it and every exact score so far lies
//    below s^_c - 2 kMargin, c is the unique maximum (every other topic
//    scores below s^_c - kMargin <= s_c) and is drawn with no exact score.
//    Otherwise the lanes whose best reaches the threshold score it exactly
//    in one divergent pass, and the exact reduction, the lower id on equal
//    scores, gives the first maximum over a set that holds every topic
//    that could be a maximum. The draws are exact by construction,
//    bit-equal to the plain version.
//
// Loads: where K % 4 == 0 and the rows are 16-byte aligned, lane l reads
// topics 128 j + 4 l .. 4 l + 3 with one 128-bit load per matrix, one
// pass ahead; otherwise one topic per lane per pass. Row offsets are
// size_t (doc ids times K exceed 2^31).
//
// What bounds it now. Any exact draw must hash every (t, k) for its noise:
// ~9 integer operations per (t, k), the function's own floor. This design
// adds three MUFU lg2 per (t, k) (3 T K over 132 SMs x 16 per clock, above
// the hash's time on the H100; an estimate that compares in the ratio
// domain could do with one) and issues ~40 instructions of the fast loop
// per (t, k), which bound it in practice (its SASS and the share of exact
// work are read by chip_smoke.py). At K = 1000 the exact chain runs for
// ~0.34 topics per token (the top bucket ~0.24; z_old's rare exact cases;
// ~0.1 rescored candidates, where a token's maximum is not clear), the
// exact loop for ~0.03% of tokens. The fused kernel's bytes (distinct
// rows, per-token vectors) stay far below; the gathered kernel reads
// 8 T K bytes and runs near that bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// One block of 32 warps per SM (<= 64 registers a thread), taking a
// contiguous run of tokens: the warps of an SM then share each document's
// doc row in L1 (faster on the H100 than 8- or 16-warp blocks, or blocks
// striding over the tokens). A build may define ZEN_TRAIN_WARPS (8 or 16)
// to measure another shape (_build.variant): 32 / kWarpsPerBlock blocks an
// SM at the same register cap, each building its own table. A token's
// draw hashes its global index and reads only its own rows and the table,
// so the shape changes no draw.
#ifndef ZEN_TRAIN_WARPS
#define ZEN_TRAIN_WARPS 32
#endif
constexpr int kWarpsPerBlock = ZEN_TRAIN_WARPS;
static_assert(32 % kWarpsPerBlock == 0, "ZEN_TRAIN_WARPS must divide 32");
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMinBlocks = 32 / kWarpsPerBlock;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kGold = 0x9E3779B9u;
// m at or above this is scored exactly (the forced top bucket)
constexpr uint32_t kTopBucket = (1u << 24) - (1u << 12);
// bound on |s^ - s| in natural-log units (proof above)
constexpr float kMargin = 0.00390625f;  // 2^-8
// the candidate window 2 kMargin / ln 2, in log2 units (rounded up)
constexpr float kWindow2 = 0.011271056f;
constexpr double kLn2 = 0.6931471805599453;  // ln 2, for the check
constexpr float kLn2f = 0.693147182f;        // ln 2
constexpr float kNegLnLn2 = 0.366512921f;    // c = -ln(ln 2)

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x = (x ^ (x >> 16)) * kM1;
  x = (x ^ (x >> 13)) * kM2;
  return x ^ (x >> 16);
}

// lg2.approx without subnormal handling: every input the estimate keeps
// is a normal float (p >= 1e-30, u >= 2^-25, -lg2(u) >= 2^-12).
__device__ __forceinline__ float lg2a(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float uniform_of(uint32_t m) {
  return (float)m * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
}

// The exact score s_k of one topic, as the plain version computes it.
__device__ __noinline__ float exact_score(int nw_count, int nd_count,
                                          float a, float nk_k, bool self,
                                          uint32_t m, float beta,
                                          float w_beta) {
  const float s = self ? 1.0f : 0.0f;
  const float nw = (float)nw_count - s;
  const float nd = (float)nd_count - s;
  const float nkk = nk_k - s;
  const float p = (a * beta + nw * a + nd * (nw + beta)) / (nkk + w_beta);
  const float g = -logf(-logf(uniform_of(m)));
  return logf(fmaxf(p, 1e-30f)) + g;
}

// The estimate's two terms, in log2 units: lg2(max(p, 1e-30)) and
// lg2(-lg2(u)). The exhaustive check calls these very functions.
__device__ __forceinline__ float fast_log_term(float p) {
  return lg2a(fmaxf(p, 1e-30f));
}
__device__ __forceinline__ float fast_noise_term(uint32_t m) {
  // m 2^-24 is exact, so one FMA rounds u as uniform_of does
  const float u = __fmaf_rn((float)m, 1.0f / 16777216.0f,
                            0.5f / 16777216.0f);
  return lg2a(-lg2a(u));
}

// The exact loop: every topic through the exact chain. Every lane returns
// the token's topic. The fallback of the verified path, and the whole
// path for a block whose inputs break the margin's premise.
__device__ __forceinline__ int exact_argmax(
    const int* __restrict__ nwk_row, const int* __restrict__ nkd_row,
    int z_old, uint32_t seed_row, const float* __restrict__ alpha,
    const float* __restrict__ nk, int K, float beta, float w_beta) {
  const int lane = threadIdx.x & 31;
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
    const float g = -logf(-logf(uniform_of(h >> 8)));
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

// Whether topic k meets the margin's premise (finite, moderate values).
__device__ __forceinline__ bool topic_ok(float a, float den, float beta) {
  return fabsf(a) <= 1073741824.0f && fabsf(beta) <= 1073741824.0f &&
         den >= 9.3132257e-10f && den <= 1.2676506e30f;
}

// The table entry of topic k. Its last word is mix(k) ^ (mix(k) >> 16):
// with x = seed_row ^ mix(k), the first step of mix(x), x ^ (x >> 16),
// is then (seed_row ^ (seed_row >> 16)) ^ that word, one LOP3 per (t, k).
__device__ __forceinline__ float4 table_entry(const float* __restrict__ alpha,
                                              const float* __restrict__ nk,
                                              int k, float beta,
                                              float w_beta) {
  const float a = alpha[k];
  const uint32_t mk = mix((uint32_t)k);
  return make_float4(a, a * beta, __frcp_rn(nk[k] + w_beta),
                     __uint_as_float(mk ^ (mk >> 16)));
}

// m = mix(seed_row ^ mix(k)) >> 8 from s16 = seed_row ^ (seed_row >> 16)
// and the table's word for k.
__device__ __forceinline__ uint32_t hash_m(uint32_t s16, float word) {
  uint32_t x = (s16 ^ __float_as_uint(word)) * kM1;
  x = (x ^ (x >> 13)) * kM2;
  return (x ^ (x >> 16)) >> 8;
}

// Where topic k's entry lies. With 4 topics per lane, lane l reads topics
// 128 j + 4 l + i, so the entries are stored at 128 j + 32 i + l: for each
// i the warp reads 32 consecutive entries, with no bank conflict (in
// topic order the lanes' 16-byte reads would lie 64 bytes apart, four to
// a bank). The table then holds K rounded up to 128 entries.
template <int kVec>
__device__ __forceinline__ int table_pos(int k) {
  if constexpr (kVec == 4)
    return (k & ~127) | ((k & 3) << 5) | ((k >> 2) & 31);
  else
    return k;
}

inline size_t table_entries(int K) {
  return K > 0 ? ((size_t)K + 127) / 128 * 128 : 0;
}

// Per-warp counts of the exact work, for the optional stats output.
struct Counts {
  unsigned forced = 0, candidates = 0, fallback = 0;
};

template <bool kShared>
__device__ __forceinline__ float4 load_entry(const float4* entry) {
  if constexpr (kShared) return *entry;
  else return __ldg(entry);
}

template <int kVec>
__device__ __forceinline__ void load_counts(const int* __restrict__ at,
                                            int (&c)[kVec]) {
  if constexpr (kVec == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(at));
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
  } else {
    c[0] = __ldg(at);
  }
}

// The verified Gumbel-max draw of one token; every lane returns it.
template <int kVec, bool kShared>
__device__ __forceinline__ int sample_token(
    const int* __restrict__ nwk_row, const int* __restrict__ nkd_row,
    int z_old, uint32_t seed_row, const float4* table,
    const float* __restrict__ alpha, const float* __restrict__ nk, int K,
    float beta, float w_beta, Counts& counts) {
  constexpr int kStep = 32 * kVec;
  const int lane = threadIdx.x & 31;
  const uint32_t s16 = seed_row ^ (seed_row >> 16);
  float b1 = -INFINITY, b2 = -INFINITY;  // lane's best and second-best f
  int i1 = -1;
  float eb = -INFINITY;  // lane's best exact score so far, and its topic
  int ei = 0x7fffffff;
  int k0 = lane * kVec;
  const int* pw = nwk_row + k0;
  const int* pd = nkd_row + k0;
  const float4* tp = table + lane;  // entry i of this pass: tp[32 i]
  int zrel = z_old - k0;  // z_old's position in this pass's group
  // the counts are loaded one pass ahead, so their latency overlaps a pass
  int cw[kVec], cd[kVec];
  if (k0 < K) {
    load_counts<kVec>(pw, cw);
    load_counts<kVec>(pd, cd);
  }
#pragma unroll 1
  for (; k0 < K; k0 += kStep, pw += kStep, pd += kStep, tp += kStep,
                 zrel -= kStep) {
    int w[kVec], d[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      w[i] = cw[i];
      d[i] = cd[i];
    }
    if (k0 + kStep < K) {
      load_counts<kVec>(pw + kStep, cw);
      load_counts<kVec>(pd + kStep, cd);
    }
    uint32_t mm[kVec];
    bool any_top = false;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float4 e = load_entry<kShared>(tp + 32 * i);
      const uint32_t m = hash_m(s16, e.w);
      mm[i] = m;
      const bool top = m >= kTopBucket;
      any_top |= top;
      const float nw = (float)w[i];
      const float nd = (float)d[i];
      const float n = (e.y + nw * e.x) + nd * (nw + beta);
      float f = fast_log_term(n * e.z) - fast_noise_term(m);
      f = (top | (zrel == i)) ? -INFINITY : f;
      b2 = fmaxf(b2, fminf(b1, f));
      if (f > b1) {
        b1 = f;
        i1 = k0 + i;
      }
    }
    if (any_top) {  // rare: ~0.24 topics per token at K = 1000
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (mm[i] < kTopBucket || zrel == i) continue;  // z_old: below
        const int k = k0 + i;
        const float s = exact_score(w[i], d[i], alpha[k], nk[k], false,
                                    mm[i], beta, w_beta);
        ++counts.forced;
        if (s > eb || (s == eb && k < ei)) {
          eb = s;
          ei = k;
        }
      }
    }
  }
  // z_old, whose counts carry the exclusion, on lane 0: its own estimate
  // (the exact chain's numerator, 1/(N_k - 1 + W b) rounded to nearest)
  // joins the lane's two best, unless its m is in the top bucket or its
  // denominator breaks the premise: then it is scored exactly.
  if (lane == 0 && z_old >= 0 && z_old < K) {
    const int nwz = nwk_row[z_old], ndz = nkd_row[z_old];
    const float a = alpha[z_old], nkz = nk[z_old];
    const uint32_t m = mix(seed_row ^ mix((uint32_t)z_old)) >> 8;
    const float den = (nkz - 1.0f) + w_beta;
    if (m >= kTopBucket || !topic_ok(a, den, beta)) {
      const float s = exact_score(nwz, ndz, a, nkz, true, m, beta, w_beta);
      ++counts.forced;
      if (s > eb || (s == eb && z_old < ei)) {
        eb = s;
        ei = z_old;
      }
    } else {
      const float nw = (float)nwz - 1.0f;
      const float nd = (float)ndz - 1.0f;
      const float n = (a * beta + nw * a) + nd * (nw + beta);
      const float f =
          fast_log_term(n * __frcp_rn(den)) - fast_noise_term(m);
      b2 = fmaxf(b2, fminf(b1, f));
      if (f > b1) {
        b1 = f;
        i1 = z_old;
      }
    }
  }
  float top = b1;   // F, the warp's best estimate
  float emax = eb;  // the best exact score so far (top bucket, z_old)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
    emax = fmaxf(emax, __shfl_xor_sync(0xffffffffu, emax, off));
  }
  bool cand = false;
  if (top != -INFINITY) {  // some topic went through the estimate
    const float thr = top - kWindow2;
    if (__any_sync(0xffffffffu, b2 >= thr)) {
      if (lane == 0) ++counts.fallback;
      return exact_argmax(nwk_row, nkd_row, z_old, seed_row, alpha, nk, K,
                          beta, w_beta);
    }
    cand = b1 >= thr;
    const unsigned cmask = __ballot_sync(0xffffffffu, cand);
    // One candidate c: every other estimated topic has s < s^_c - kMargin
    // <= s_c. If every exact score so far is below s^_c - 2 kMargin (one
    // kMargin more than s_c needs, for this expression's own rounding),
    // c is the unique maximum and needs no exact score.
    if (__popc(cmask) == 1 &&
        emax < kLn2f * top + kNegLnLn2 - 2.0f * kMargin)
      return __shfl_sync(0xffffffffu, i1, __ffs(cmask) - 1);
  }
  if (cand) {  // one divergent pass scores every candidate
    const uint32_t m = mix(seed_row ^ mix((uint32_t)i1)) >> 8;
    const float s = exact_score(nwk_row[i1], nkd_row[i1], alpha[i1],
                                nk[i1], i1 == z_old, m, beta, w_beta);
    ++counts.candidates;
    if (s > eb || (s == eb && i1 < ei)) {
      eb = s;
      ei = i1;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, eb, off);
    const int oi = __shfl_xor_sync(0xffffffffu, ei, off);
    if (ob > eb || (ob == eb && oi < ei)) {
      eb = ob;
      ei = oi;
    }
  }
  return ei;
}

// Build the shared table (kShared) and check the margin's premise for
// every topic; returns true when the block must use the exact loop.
template <int kVec, bool kShared>
__device__ __forceinline__ bool prepare_block(
    float4* stable, const float* __restrict__ alpha,
    const float* __restrict__ nk, int K, float beta, float w_beta) {
  int bad = K <= 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float4 e = table_entry(alpha, nk, k, beta, w_beta);
    bad |= !topic_ok(e.x, nk[k] + w_beta, beta);
    if (kShared) stable[table_pos<kVec>(k)] = e;
  }
  return __syncthreads_or(bad) != 0;
}

__device__ __forceinline__ void flush_counts(const Counts& c,
                                             unsigned long long* stats) {
  if (stats == nullptr) return;
  const unsigned f = __reduce_add_sync(0xffffffffu, c.forced);
  const unsigned n = __reduce_add_sync(0xffffffffu, c.candidates);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(stats + 0, (unsigned long long)f);
    atomicAdd(stats + 1, (unsigned long long)n);
    atomicAdd(stats + 2, (unsigned long long)c.fallback);
  }
}

// Token t's noise row: its global index, token_index[t] when the caller
// gives one (a mesh cell's corpus indices: one 4-byte load per token),
// else row0 + t.
__device__ __forceinline__ uint32_t noise_row(const int* token_index,
                                              int row0, int t) {
  return token_index ? (uint32_t)__ldg(token_index + t)
                     : (uint32_t)(row0 + t);
}

template <int kVec, bool kShared>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
zen_train_gathered_kernel(const int* __restrict__ nwk_rows,
                          const int* __restrict__ nkd_rows,
                          const int* __restrict__ z_old,
                          const float* __restrict__ alpha,
                          const float* __restrict__ nk,
                          const float4* __restrict__ gtable,
                          int* __restrict__ out, int T, int K, int seed,
                          int row0, const int* __restrict__ token_index,
                          float beta, float w_beta,
                          unsigned long long* stats) {
  extern __shared__ float4 stable[];
  const bool exact_only =
      prepare_block<kVec, kShared>(stable, alpha, nk, K, beta, w_beta);
  const float4* table = kShared ? stable : gtable;
  Counts counts;
  const int lane = threadIdx.x & 31;
  // uniform per warp: the shuffles stay full-mask
  // each block takes a contiguous run of tokens, its warps in turn: the
  // tokens of one document share a doc row, which then stays in L1
  const long long per_block = ((long long)T + gridDim.x - 1) / gridDim.x;
  const long long start = (long long)blockIdx.x * per_block;
  const int t_end = (int)min((long long)T, start + per_block);
  for (int t = (int)min((long long)T, start) + (threadIdx.x >> 5); t < t_end;
       t += kWarpsPerBlock) {
    const size_t row = (size_t)t * (size_t)K;
    const uint32_t seed_row =
        (uint32_t)seed ^ (noise_row(token_index, row0, t) * kGold);
    int z;
    if (exact_only) {
      if (lane == 0) ++counts.fallback;
      z = exact_argmax(nwk_rows + row, nkd_rows + row, z_old[t], seed_row,
                       alpha, nk, K, beta, w_beta);
    } else {
      z = sample_token<kVec, kShared>(nwk_rows + row, nkd_rows + row,
                                      z_old[t], seed_row, table, alpha, nk,
                                      K, beta, w_beta, counts);
    }
    if (lane == 0) out[t] = z;
  }
  flush_counts(counts, stats);
}

template <int kVec, bool kShared>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
zen_train_fused_kernel(const int* __restrict__ n_wk,
                       const int* __restrict__ n_kd,
                       const int* __restrict__ word,
                       const int* __restrict__ doc,
                       const int* __restrict__ z_old,
                       const float* __restrict__ alpha,
                       const float* __restrict__ nk,
                       const float4* __restrict__ gtable,
                       int* __restrict__ out, int T, int K, int W, int D,
                       int seed, int row0,
                       const int* __restrict__ token_index, float beta,
                       float w_beta, unsigned long long* stats) {
  extern __shared__ float4 stable[];
  const bool exact_only =
      prepare_block<kVec, kShared>(stable, alpha, nk, K, beta, w_beta);
  const float4* table = kShared ? stable : gtable;
  Counts counts;
  const int lane = threadIdx.x & 31;
  // each block takes a contiguous run of tokens, its warps in turn: the
  // tokens of one document share a doc row, which then stays in L1
  const long long per_block = ((long long)T + gridDim.x - 1) / gridDim.x;
  const long long start = (long long)blockIdx.x * per_block;
  const int t_end = (int)min((long long)T, start + per_block);
  for (int t = (int)min((long long)T, start) + (threadIdx.x >> 5); t < t_end;
       t += kWarpsPerBlock) {
    const int w = word[t];
    const int d = doc[t];
    // An id outside its matrix aborts the launch, as torch's own indexing
    // does on the card: the error surfaces at the caller's next synchronize.
    if (w < 0 || w >= W || d < 0 || d >= D) __trap();
    const int* nwk_row = n_wk + (size_t)w * (size_t)K;
    const int* nkd_row = n_kd + (size_t)d * (size_t)K;
    const uint32_t seed_row =
        (uint32_t)seed ^ (noise_row(token_index, row0, t) * kGold);
    int z;
    if (exact_only) {
      if (lane == 0) ++counts.fallback;
      z = exact_argmax(nwk_row, nkd_row, z_old[t], seed_row, alpha, nk, K,
                       beta, w_beta);
    } else {
      z = sample_token<kVec, kShared>(nwk_row, nkd_row, z_old[t], seed_row,
                                      table, alpha, nk, K, beta, w_beta,
                                      counts);
    }
    if (lane == 0) out[t] = z;
  }
  flush_counts(counts, stats);
}

// The global table for blocks that do not keep it in shared memory.
template <int kVec>
__global__ void build_table_kernel(const float* __restrict__ alpha,
                                   const float* __restrict__ nk, int K,
                                   float beta, float w_beta,
                                   float4* __restrict__ table) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < K)
    table[table_pos<kVec>(k)] = table_entry(alpha, nk, k, beta, w_beta);
}

// Exhaustive check of the margin's premises: noise_err[m] for every m
// (2^24 doubles), and the largest log error over the floats whose bits lie
// in [lo_bits, hi_bits] (one double, as its bits, by atomicMax).
__global__ void noise_error_kernel(double* __restrict__ noise_err) {
  const uint32_t m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (1u << 24)) return;
  const double g = (double)(-logf(-logf(uniform_of(m))));
  const double est = -kLn2 * (double)fast_noise_term(m) - log(kLn2);
  noise_err[m] = fabs(est - g);
}

__global__ void log_error_kernel(uint32_t lo_bits, uint32_t hi_bits,
                                 unsigned long long* __restrict__ err_bits) {
  double worst = 0.0;
  const uint64_t n = (uint64_t)hi_bits - lo_bits + 1;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * blockDim.x) {
    const float x = __uint_as_float(lo_bits + (uint32_t)i);
    const double d = fabs(kLn2 * (double)fast_log_term(x) -
                          (double)logf(fmaxf(x, 1e-30f)));
    worst = fmax(worst, d);
  }
  atomicMax(err_bits, (unsigned long long)__double_as_longlong(worst));
}

struct Launch {
  unsigned grid;  // persistent blocks: SMs x resident blocks per SM
  size_t smem;    // dynamic shared bytes
};

template <typename KernelT>
cudaError_t plan(Launch& L, KernelT kernel, int T, int K, bool shared) {
  L.smem = shared ? table_entries(K) * sizeof(float4) : 0;
  cudaError_t e = cudaSuccess;
  if (L.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, L.smem);
  if (e != cudaSuccess) return e;
  const long long need = ((long long)T + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  L.grid = (unsigned)(need < full ? need : full);
  return cudaSuccess;
}

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// Whether the table goes in shared memory: wherever it fits in what a
// block of the current card can opt into (K <= 14,464 on the H100's
// 227 KB); otherwise in global memory.
inline cudaError_t table_in_shared(int K, bool& shared) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  shared = e == cudaSuccess &&
           table_entries(K) * sizeof(float4) <= (size_t)optin;
  return e;
}

}  // namespace

// Plain C launchers for ctypes. Each launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched). `table`
// is the global table's scratch, zen_train_global_table's count of
// float4, and may be null when that count is 0; `stats`, when not null,
// accumulates (topics scored exactly in the pass or as z_old, rescored
// candidates, tokens sampled by the exact loop).
#define ZEN_TRAIN_DISPATCH(KERNEL, VEC, SHARED, ...)                       \
  do {                                                                     \
    Launch L{};                                                            \
    auto kern = KERNEL<VEC, SHARED>;                                       \
    const cudaError_t pe = plan(L, kern, T, K, SHARED);                    \
    if (pe != cudaSuccess) {                                               \
      cudaGetLastError();                                                  \
      return (int)pe;                                                      \
    }                                                                      \
    if (!SHARED && K > 0)                                                  \
      build_table_kernel<VEC><<<(K + 255) / 256, 256, 0, st>>>(            \
          alpha, nk, K, beta, w_beta, (float4*)table);                     \
    kern<<<L.grid, kThreads, L.smem, st>>>(__VA_ARGS__);                   \
  } while (0)

extern "C" int zen_train_gathered(const int* nwk_rows, const int* nkd_rows,
                                  const int* z_old, const float* alpha,
                                  const float* nk, int* out, int T, int K,
                                  int seed, int row0,
                                  const int* token_index, float beta,
                                  float w_beta, void* table,
                                  unsigned long long* stats, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = K % 4 == 0 && aligned16(nwk_rows) && aligned16(nkd_rows);
  bool shared = false;
  const cudaError_t e = table_in_shared(K, shared);
  if (e != cudaSuccess || (!shared && table == nullptr)) {
    cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidValue);
  }
#define ARGS nwk_rows, nkd_rows, z_old, alpha, nk, (const float4*)table, out, \
             T, K, seed, row0, token_index, beta, w_beta, stats
  if (vec && shared)
    ZEN_TRAIN_DISPATCH(zen_train_gathered_kernel, 4, true, ARGS);
  else if (vec)
    ZEN_TRAIN_DISPATCH(zen_train_gathered_kernel, 4, false, ARGS);
  else if (shared)
    ZEN_TRAIN_DISPATCH(zen_train_gathered_kernel, 1, true, ARGS);
  else
    ZEN_TRAIN_DISPATCH(zen_train_gathered_kernel, 1, false, ARGS);
#undef ARGS
  return (int)cudaGetLastError();
}

extern "C" int zen_train_fused(const int* n_wk, const int* n_kd,
                               const int* word, const int* doc,
                               const int* z_old, const float* alpha,
                               const float* nk, int* out, int T, int K, int W,
                               int D, int seed, int row0,
                               const int* token_index, float beta,
                               float w_beta, void* table,
                               unsigned long long* stats, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = K % 4 == 0 && aligned16(n_wk) && aligned16(n_kd);
  bool shared = false;
  const cudaError_t e = table_in_shared(K, shared);
  if (e != cudaSuccess || (!shared && table == nullptr)) {
    cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidValue);
  }
#define ARGS n_wk, n_kd, word, doc, z_old, alpha, nk, (const float4*)table, \
             out, T, K, W, D, seed, row0, token_index, beta, w_beta, stats
  if (vec && shared)
    ZEN_TRAIN_DISPATCH(zen_train_fused_kernel, 4, true, ARGS);
  else if (vec)
    ZEN_TRAIN_DISPATCH(zen_train_fused_kernel, 4, false, ARGS);
  else if (shared)
    ZEN_TRAIN_DISPATCH(zen_train_fused_kernel, 1, true, ARGS);
  else
    ZEN_TRAIN_DISPATCH(zen_train_fused_kernel, 1, false, ARGS);
#undef ARGS
  return (int)cudaGetLastError();
}

#undef ZEN_TRAIN_DISPATCH

// The float4 entries of global scratch a training launch at K topics
// needs on the current card: 0 when its table goes in shared memory.
// Returns the CUDA error of the query (launches nothing).
extern "C" int zen_train_global_table(int K, long long* entries) {
  bool shared = false;
  const cudaError_t e = table_in_shared(K, shared);
  *entries = shared ? 0 : (long long)table_entries(K);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// The margin's constants, for the exhaustive check (written to host
// memory; launches nothing).
extern "C" int zen_train_constants(float* margin, int* top_bucket) {
  *margin = kMargin;
  *top_bucket = (int)kTopBucket;
  return 0;
}

// The exhaustive check's two launches (test-only, not on any path):
// noise_err gets 2^24 doubles; err_bits one zeroed uint64 that receives
// the largest log error over the floats with bits in [lo_bits, hi_bits].
extern "C" int zen_train_fast_error(double* noise_err, unsigned lo_bits,
                                    unsigned hi_bits,
                                    unsigned long long* err_bits,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  noise_error_kernel<<<(1u << 24) / 256, 256, 0, st>>>(noise_err);
  log_error_kernel<<<132 * 16, 256, 0, st>>>(lo_bits, hi_bits, err_bits);
  return (int)cudaGetLastError();
}
