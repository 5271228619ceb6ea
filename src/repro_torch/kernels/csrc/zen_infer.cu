// Frozen-model ZenLDA serving sampler for Hopper (sm_90a).
//
// Two launchers share one sampling routine, so their draws are
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
//   z_t = argmax_k  s_k,  s_k = logf(max(p_k, 1e-30)) + g_k
//   p_k = (N_kd^{not t} + a_k)(N_wk + b) / (N_k + W b)
//   g_k = -logf(-logf(u_k)),  u_k = m_k 2^-24 + 2^-25,  m_k = h_k >> 8
// with doc-side self-exclusion only (the token's own old topic subtracted,
// as a float, from N_kd) and h_k = mix(seed_t ^ mix(k)), the counter hash
// of the JAX package (kernels/zen_sampler.py: _mix, hash_uniform) at the
// serving coordinate (seed_t, 0, k). The first maximum wins, as
// torch.argmax.
//
// The exact chain (score_argmax, exact_score): IEEE division and the
// accurate logf; the build passes -fmad=false and no --use_fast_math, so
// no multiply-add is contracted. Its draws equal the plain torch version's
// up to the last bits of logf (torch's log on the card is not CUDA's logf:
// the two may part at near-ties). Per (t, k) it runs the hash with mix(k)
// recomputed, three accurate logf (each a polynomial of ~20 instructions,
// not one special-function op) and a division: over a hundred SASS
// instructions per (t, k) (chip_smoke.py counts them), so a kernel that
// runs it for every topic is bound by instruction issue, not by bytes.
//
// Design: bound, then verify. Only a handful of topics per token can come
// near the maximum, so the kernel fully scores only those. The draws stay
// those of the exact loop, bit for bit, on any input.
//
// 1. Per-topic table: {a_k, 1/(N_k + W b) rounded to nearest, a word of
//    mix(k), 0}, 16 bytes, one 128-bit load per (t, k), stored without bank
//    conflicts (table_pos). A persistent grid of one 32-warp block per SM
//    keeps it in shared memory, each block building its own, wherever it
//    fits (K rounded up to 128 entries within the card's opt-in shared
//    memory: K <= 14,464 on the H100); for larger K one launch builds it in
//    global memory and the blocks read it through L1 (table_in_shared).
//    Each block takes a contiguous run of tokens: the serving path lays a
//    slot's tokens next to each other, so the block's warps share each
//    slot's doc row in L1. Serving excludes nothing from N_k, so the
//    table's 1/(N_k + W b) holds for every topic, the token's z_old too.
// 2. Fast estimate, per (t, k), in log2 units: the exact hash and m, the
//    numerator n = (nd + a)(nw + b) computed bit-identically to the exact
//    chain, then
//      f_k = lg2(max(n * rcp_k, 1e-30)) - lg2(-lg2(u_k))
//    with lg2 = lg2.approx (one MUFU each). With c = -ln(ln 2),
//    s^_k = ln2 f_k + c estimates s_k. Each lane keeps its best f (and its
//    topic) and its second-best f. Chosen over a ratio-domain comparison
//    (one MUFU per (t, k)) because its margin and its exhaustive check are
//    the training sampler's, already measured on the card, and its three
//    MUFU per (t, k) take less time on the H100 than this kernel's bytes
//    or its other instructions (chip_smoke.py reports both floors).
// 3. Margin: |s^_k - s_k| <= kMargin = 2^-8 for every topic the estimate
//    scores. Proof: s^ - s splits into
//    (a) ln2 lg2(x) - logf(x), over every float x in [1e-30, FLT_MAX]:
//        measured by exhaustion on the card (zen_infer_fast_error, run by
//        tests/test_torch_gpu.py and chip_smoke.py), E1;
//    (b) the noise estimate -ln2 lg2(-lg2(u)) - ln ln2 against
//        -logf(-logf(u)) over every m below the forced bucket: measured
//        the same way, E2;
//    (c) p^ = RN(n RN(1/d)) against p = RN(n/d) for the same n: at most
//        3 ulp relative, so |ln p^ - ln p| <= 3 2^-24; max(., 1e-30) is
//        monotone and both clamp where n <= 0, as n is the same float (the
//        token's z_old with N_kd = 0, as at the engine's padding
//        positions, gives n < 0 in both); logf's own rounding at p^
//        against p, the roundings of f's subtraction, of s's addition and
//        of the threshold below: all under 2^-14 together, as |f| < 256
//        and |s| < 256.
//    The checks assert E1 + E2 + 2^-14 <= kMargin. The premise holds only
//    for finite, moderate inputs: each block checks every topic
//    (|a| <= 2^30, |b| <= 2^30, 2^-30 <= N_k + W b <= 2^100, so |n| < 2^64
//    and p^ is finite) and otherwise samples with the exact loop alone.
// 4. Forced exact topics: every m >= kTopBucket = 2^24 - 2^12, scored
//    inline (exact_score, kept out of line so that the fast loop stays
//    small): there -log u < 2^-12 and lg2.approx of u, accurate to an
//    absolute ~2^-22 near 1, loses its relative accuracy. The bucket holds
//    m = 2^24 - 1, whose u rounds to 1.0 and whose noise is exactly +inf:
//    it still wins, as in the reference. The token's own z_old, whose doc
//    count carries the exclusion, is kept out of the pass and estimated
//    once, after it, by the same chain from its own numerator
//    (nd - 1 + a)(nw + b) and the shared 1/(N_k + W b), or scored exactly
//    when its m is in the bucket.
// 5. Verify: the warp's maximum F of the lane bests; every topic with
//    s_k equal to the exact maximum has f_k >= F - 2 kMargin / ln 2 (if
//    it were lower, s_k < s of the topic at F). If any lane's second-best
//    reaches that threshold, a third topic might too, and the warp samples
//    the token with the exact loop over every topic (score_argmax). If one
//    lane's best c alone reaches it and every exact score so far lies
//    below s^_c - 2 kMargin, c is the unique maximum (every other topic
//    scores below s^_c - kMargin <= s_c) and is drawn with no exact score.
//    Otherwise the lanes whose best reaches the threshold score it exactly
//    in one divergent pass, and the exact reduction, the lower id on equal
//    scores, gives the first maximum over a set that holds every topic
//    that could be a maximum: the exact loop's draw.
//
// Loads: where K % 4 == 0 and the rows are 16-byte aligned, lane l reads
// topics 128 j + 4 l .. 4 l + 3 with one 128-bit load per matrix, one
// pass ahead; otherwise one topic per lane per pass. Row offsets are
// size_t (word ids times K reach 10^8 at NYTIMES width).
//
// What bounds it now. Any exact draw must hash every (t, k) for its noise:
// ~9 integer operations per (t, k). The fused kernel moves each distinct
// word row once (~60 MB at T = 16,384, K = 1000, W = 101,636 on random
// words), the gathered one 8 T K bytes; this design adds three MUFU lg2
// per (t, k) and issues the fast loop's instructions per (t, k), which
// chip_smoke.py reads from the SASS beside the exact work that the stats
// output counts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 32;
constexpr int kThreads = kWarpsPerBlock * 32;
// One block of 32 warps per SM (<= 64 registers a thread), taking a
// contiguous run of tokens: the warps of an SM then share each slot's doc
// row in L1.
constexpr int kMinBlocks = 1;
// The exact loop's own launch (zen_infer_exact, test-only): one warp per
// token in 8-warp blocks.
constexpr int kExactWarps = 8;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
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

// The exact loop: every topic through the exact chain, one warp per
// token; every lane returns the token's topic. Row coordinate of the noise
// is 0 (serving contract), so the hash is mix(seed ^ mix(k)). The fallback
// of the verified path, and the whole path for a block whose inputs break
// the margin's premise.
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

// The exact score s_k of one topic, as score_argmax computes it.
__device__ __noinline__ float exact_score(int nw_count, int nd_count,
                                          float a, float nk_k, bool self,
                                          uint32_t m, float beta,
                                          float w_beta) {
  const float nw = (float)nw_count;
  const float nd = (float)nd_count - (self ? 1.0f : 0.0f);
  const float p = (nd + a) * (nw + beta) / (nk_k + w_beta);
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

// Whether topic k meets the margin's premise (finite, moderate values).
__device__ __forceinline__ bool topic_ok(float a, float den, float beta) {
  return fabsf(a) <= 1073741824.0f && fabsf(beta) <= 1073741824.0f &&
         den >= 9.3132257e-10f && den <= 1.2676506e30f;
}

// The table entry of topic k. Its third word is mix(k) ^ (mix(k) >> 16):
// with x = seed ^ mix(k), the first step of mix(x), x ^ (x >> 16), is then
// (seed ^ (seed >> 16)) ^ that word, one LOP3 per (t, k).
__device__ __forceinline__ float4 table_entry(const float* __restrict__ alpha,
                                              const float* __restrict__ nk,
                                              int k, float w_beta) {
  const uint32_t mk = mix((uint32_t)k);
  return make_float4(alpha[k], __frcp_rn(nk[k] + w_beta),
                     __uint_as_float(mk ^ (mk >> 16)), 0.0f);
}

// m = mix(seed ^ mix(k)) >> 8 from s16 = seed ^ (seed >> 16) and the
// table's word for k.
__device__ __forceinline__ uint32_t hash_m(uint32_t s16, float word) {
  uint32_t x = (s16 ^ __float_as_uint(word)) * kM1;
  x = (x ^ (x >> 13)) * kM2;
  return (x ^ (x >> 16)) >> 8;
}

// Where topic k's entry lies. With 4 topics per lane, lane l reads topics
// 128 j + 4 l + i, so the entries are stored at 128 j + 32 i + l: for each
// i the warp reads 32 consecutive entries, with no bank conflict. The
// table then holds K rounded up to 128 entries.
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
    int z_old, uint32_t seed, const float4* table,
    const float* __restrict__ alpha, const float* __restrict__ nk, int K,
    float beta, float w_beta, Counts& counts) {
  constexpr int kStep = 32 * kVec;
  const int lane = threadIdx.x & 31;
  const uint32_t s16 = seed ^ (seed >> 16);
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
      const uint32_t m = hash_m(s16, e.z);
      mm[i] = m;
      const bool top = m >= kTopBucket;
      any_top |= top;
      const float n = ((float)d[i] + e.x) * ((float)w[i] + beta);
      float f = fast_log_term(n * e.y) - fast_noise_term(m);
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
  // z_old, whose doc count carries the exclusion, on lane 0: its own
  // estimate (the exact chain's numerator, the shared 1/(N_k + W b))
  // joins the lane's two best, unless its m is in the top bucket: then it
  // is scored exactly. Its numerator may be <= 0 (N_kd = 0 at z_old): the
  // estimate and the exact chain then both clamp at 1e-30.
  if (lane == 0 && z_old >= 0 && z_old < K) {
    const int nwz = nwk_row[z_old], ndz = nkd_row[z_old];
    const float a = alpha[z_old], nkz = nk[z_old];
    const uint32_t m = mix(seed ^ mix((uint32_t)z_old)) >> 8;
    if (m >= kTopBucket) {
      const float s = exact_score(nwz, ndz, a, nkz, true, m, beta, w_beta);
      ++counts.forced;
      if (s > eb || (s == eb && z_old < ei)) {
        eb = s;
        ei = z_old;
      }
    } else {
      const float n = (((float)ndz - 1.0f) + a) * ((float)nwz + beta);
      const float f = fast_log_term(n * __frcp_rn(nkz + w_beta))
                      - fast_noise_term(m);
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
      return score_argmax(nwk_row, nkd_row, z_old, seed, alpha, nk, K, beta,
                          w_beta);
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
    const uint32_t m = mix(seed ^ mix((uint32_t)i1)) >> 8;
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
    const float4 e = table_entry(alpha, nk, k, w_beta);
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

// The body both launchers share: the block's table, then its contiguous
// run of tokens, its warps in turn (the tokens of one slot share a doc
// row, which then stays in L1). rows(t, nwk_row, nkd_row) locates token
// t's two count rows.
template <int kVec, bool kShared, typename Rows>
__device__ __forceinline__ void sample_tokens(
    Rows rows, const int* __restrict__ z_old, const int* __restrict__ seeds,
    const float* __restrict__ alpha, const float* __restrict__ nk,
    const float4* __restrict__ gtable, int* __restrict__ out, int T, int K,
    float beta, float w_beta, unsigned long long* stats) {
  extern __shared__ float4 stable[];
  const bool exact_only =
      prepare_block<kVec, kShared>(stable, alpha, nk, K, beta, w_beta);
  const float4* table = kShared ? stable : gtable;
  Counts counts;
  const int lane = threadIdx.x & 31;
  const long long per_block = ((long long)T + gridDim.x - 1) / gridDim.x;
  const long long start = (long long)blockIdx.x * per_block;
  const int t_end = (int)min((long long)T, start + per_block);
  // uniform per warp: the shuffles stay full-mask
  for (int t = (int)min((long long)T, start) + (threadIdx.x >> 5); t < t_end;
       t += kWarpsPerBlock) {
    const int* nwk_row;
    const int* nkd_row;
    rows(t, nwk_row, nkd_row);
    const uint32_t seed = (uint32_t)seeds[t];
    int z;
    if (exact_only) {
      if (lane == 0) ++counts.fallback;
      z = score_argmax(nwk_row, nkd_row, z_old[t], seed, alpha, nk, K, beta,
                       w_beta);
    } else {
      z = sample_token<kVec, kShared>(nwk_row, nkd_row, z_old[t], seed,
                                      table, alpha, nk, K, beta, w_beta,
                                      counts);
    }
    if (lane == 0) out[t] = z;
  }
  flush_counts(counts, stats);
}

template <int kVec, bool kShared>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
zen_infer_gathered_kernel(const int* __restrict__ nwk_rows,
                          const int* __restrict__ nkd_rows,
                          const int* __restrict__ z_old,
                          const int* __restrict__ seeds,
                          const float* __restrict__ alpha,
                          const float* __restrict__ nk,
                          const float4* __restrict__ gtable,
                          int* __restrict__ out, int T, int K, float beta,
                          float w_beta, unsigned long long* stats) {
  auto rows = [=](int t, const int*& nwk_row, const int*& nkd_row) {
    const size_t row = (size_t)t * (size_t)K;
    nwk_row = nwk_rows + row;
    nkd_row = nkd_rows + row;
  };
  sample_tokens<kVec, kShared>(rows, z_old, seeds, alpha, nk, gtable, out,
                               T, K, beta, w_beta, stats);
}

template <int kVec, bool kShared>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
zen_infer_fused_kernel(const int* __restrict__ n_wk,
                       const int* __restrict__ n_kd,
                       const int* __restrict__ word,
                       const int* __restrict__ slot,
                       const int* __restrict__ z_old,
                       const int* __restrict__ seeds,
                       const float* __restrict__ alpha,
                       const float* __restrict__ nk,
                       const float4* __restrict__ gtable,
                       int* __restrict__ out, int T, int K, int W, int B,
                       float beta, float w_beta,
                       unsigned long long* stats) {
  auto rows = [=](int t, const int*& nwk_row, const int*& nkd_row) {
    const int w = word[t];
    const int d = slot[t];
    // An id outside its matrix aborts the launch, as torch's own indexing
    // does on the card: the error surfaces at the caller's next synchronize.
    if (w < 0 || w >= W || d < 0 || d >= B) __trap();
    nwk_row = n_wk + (size_t)w * (size_t)K;
    nkd_row = n_kd + (size_t)d * (size_t)K;
  };
  sample_tokens<kVec, kShared>(rows, z_old, seeds, alpha, nk, gtable, out,
                               T, K, beta, w_beta, stats);
}

// The exact loop alone over every token (test-only: the draws the
// verified kernels must keep), one warp per token, reading the rows in
// place as the fused kernel does.
__global__ void __launch_bounds__(kExactWarps * 32)
zen_infer_exact_kernel(const int* __restrict__ n_wk,
                       const int* __restrict__ n_kd,
                       const int* __restrict__ word,
                       const int* __restrict__ slot,
                       const int* __restrict__ z_old,
                       const int* __restrict__ seeds,
                       const float* __restrict__ alpha,
                       const float* __restrict__ nk, int* __restrict__ out,
                       int T, int K, int W, int B, float beta,
                       float w_beta) {
  const int t = blockIdx.x * kExactWarps + (threadIdx.x >> 5);
  if (t >= T) return;  // uniform per warp: the shuffles stay full-mask
  const int w = word[t];
  const int d = slot[t];
  if (w < 0 || w >= W || d < 0 || d >= B) __trap();
  const int z = score_argmax(n_wk + (size_t)w * (size_t)K,
                             n_kd + (size_t)d * (size_t)K, z_old[t],
                             (uint32_t)seeds[t], alpha, nk, K, beta, w_beta);
  if ((threadIdx.x & 31) == 0) out[t] = z;
}

// The global table for blocks that do not keep it in shared memory.
template <int kVec>
__global__ void build_table_kernel(const float* __restrict__ alpha,
                                   const float* __restrict__ nk, int K,
                                   float w_beta, float4* __restrict__ table) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < K) table[table_pos<kVec>(k)] = table_entry(alpha, nk, k, w_beta);
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
// is the global table's scratch, zen_infer_global_table's count of
// float4, and may be null when that count is 0; `stats`, when not null,
// accumulates (topics scored exactly in the pass or as z_old, rescored
// candidates, tokens sampled by the exact loop).
#define ZEN_INFER_DISPATCH(KERNEL, VEC, SHARED, ...)                       \
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
          alpha, nk, K, w_beta, (float4*)table);                           \
    kern<<<L.grid, kThreads, L.smem, st>>>(__VA_ARGS__);                   \
  } while (0)

extern "C" int zen_infer_gathered(const int* nwk_rows, const int* nkd_rows,
                                  const int* z_old, const int* seeds,
                                  const float* alpha, const float* nk,
                                  int* out, int T, int K, float beta,
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
#define ARGS nwk_rows, nkd_rows, z_old, seeds, alpha, nk, \
             (const float4*)table, out, T, K, beta, w_beta, stats
  if (vec && shared)
    ZEN_INFER_DISPATCH(zen_infer_gathered_kernel, 4, true, ARGS);
  else if (vec)
    ZEN_INFER_DISPATCH(zen_infer_gathered_kernel, 4, false, ARGS);
  else if (shared)
    ZEN_INFER_DISPATCH(zen_infer_gathered_kernel, 1, true, ARGS);
  else
    ZEN_INFER_DISPATCH(zen_infer_gathered_kernel, 1, false, ARGS);
#undef ARGS
  return (int)cudaGetLastError();
}

extern "C" int zen_infer_fused(const int* n_wk, const int* n_kd,
                               const int* word, const int* slot,
                               const int* z_old, const int* seeds,
                               const float* alpha, const float* nk, int* out,
                               int T, int K, int W, int B, float beta,
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
#define ARGS n_wk, n_kd, word, slot, z_old, seeds, alpha, nk, \
             (const float4*)table, out, T, K, W, B, beta, w_beta, stats
  if (vec && shared)
    ZEN_INFER_DISPATCH(zen_infer_fused_kernel, 4, true, ARGS);
  else if (vec)
    ZEN_INFER_DISPATCH(zen_infer_fused_kernel, 4, false, ARGS);
  else if (shared)
    ZEN_INFER_DISPATCH(zen_infer_fused_kernel, 1, true, ARGS);
  else
    ZEN_INFER_DISPATCH(zen_infer_fused_kernel, 1, false, ARGS);
#undef ARGS
  return (int)cudaGetLastError();
}

#undef ZEN_INFER_DISPATCH

// The exact loop over every token (test-only, not on any path): the fused
// launcher's arguments without the scratch and the stats.
extern "C" int zen_infer_exact(const int* n_wk, const int* n_kd,
                               const int* word, const int* slot,
                               const int* z_old, const int* seeds,
                               const float* alpha, const float* nk, int* out,
                               int T, int K, int W, int B, float beta,
                               float w_beta, void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  zen_infer_exact_kernel<<<(unsigned)((T + kExactWarps - 1) / kExactWarps),
                           kExactWarps * 32, 0, (cudaStream_t)stream>>>(
      n_wk, n_kd, word, slot, z_old, seeds, alpha, nk, out, T, K, W, B, beta,
      w_beta);
  return (int)cudaGetLastError();
}

// The float4 entries of global scratch a serving launch at K topics needs
// on the current card: 0 when its table goes in shared memory. Returns the
// CUDA error of the query (launches nothing).
extern "C" int zen_infer_global_table(int K, long long* entries) {
  bool shared = false;
  const cudaError_t e = table_in_shared(K, shared);
  *entries = shared ? 0 : (long long)table_entries(K);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// The margin's constants, for the exhaustive check (written to host
// memory; launches nothing).
extern "C" int zen_infer_constants(float* margin, int* top_bucket) {
  *margin = kMargin;
  *top_bucket = (int)kTopBucket;
  return 0;
}

// The exhaustive check's two launches (test-only, not on any path):
// noise_err gets 2^24 doubles; err_bits one zeroed uint64 that receives
// the largest log error over the floats with bits in [lo_bits, hi_bits].
extern "C" int zen_infer_fast_error(double* noise_err, unsigned lo_bits,
                                    unsigned hi_bits,
                                    unsigned long long* err_bits,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  noise_error_kernel<<<(1u << 24) / 256, 256, 0, st>>>(noise_err);
  log_error_kernel<<<132 * 16, 256, 0, st>>>(lo_bits, hi_bits, err_bits);
  return (int)cudaGetLastError();
}
