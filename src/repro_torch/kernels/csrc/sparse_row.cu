// Padded-sparse row sampler for Hopper (sm_90a).
//
//   sparse_row  replaces _sparse_row_kernel / sparse_row_sample_pallas
//               (src/repro/kernels/sparse_row.py): for token t, a compact
//               row of J (weight, topic id) pairs and a target; returns
//                 cnt = #{j : prefix(vals[t])[j] < target[t]}
//                 topics[t, min(cnt, J - 1)]
//               the lower-bound CDF inversion that ends the hot loops of
//               zen_sparse (term 3), SparseLDA (r and q buckets) and the
//               LightLDA word proposal.
//
// What bounds it: it reads each row's J float weights once (the count
// runs over every lane), one target and the one topic id it returns, and
// writes one topic: T * (4 J + 12) bytes at 3.35 TB/s. The arithmetic (a
// few adds and compares per lane) is far below that, so the launch is
// bound by bytes.
//
// Design: one warp per token. The lanes walk the row in 32-lane strips;
// each strip is one coalesced 128-byte line of weights. A strip gets an
// inclusive warp prefix sum by shuffles (Hillis-Steele: offsets 1, 2, 4,
// 8, 16, lane i adding lane i - off where i >= off), then the carry of the
// strips before it is added; __ballot_sync + __popc counts the real lanes
// whose prefix lies below the target. The carry grows by the strip's lane
// 31, the strip total in that order. Lane 0 then loads the one topic id.
// A whole row is one warp's, so the TPU kernel's cross-tile clamp hazard
// (a tile-local clamp cannot see an earlier tile) cannot arise, and no
// lane padding to a tile width is needed: the real J is walked.
//
// Numerics: float sums depend on their order, and jnp.cumsum, torch.cumsum
// on the CPU and on the card each use their own. The plain torch version
// (kernels/sparse_row.py) adds in exactly this kernel's order, so the two
// are bit-equal on the card. Only adds and compares: -fmad=false changes
// nothing here, and no fast math is used.
//
// Padded lanes carry weight 0 and a sentinel topic id K; the callers clamp
// the result to K - 1, as the reference's callers do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sparse_row_kernel(const float* __restrict__ vals,
                  const int* __restrict__ topics,
                  const float* __restrict__ targets, int* __restrict__ out,
                  int T, int J) {
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;  // uniform per warp: the shuffles stay full-mask
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)t * (size_t)J;
  const float target = targets[t];
  float carry = 0.0f;
  int cnt = 0;
  for (int s = 0; s < J; s += 32) {
    const int j = s + lane;
    const bool real = j < J;
    float x = real ? vals[base + j] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x = x + y;
    }
    const float c = carry + x;
    cnt += __popc(__ballot_sync(kFull, real && (c < target)));
    carry = carry + __shfl_sync(kFull, x, 31);
  }
  if (lane == 0) {
    const int pos = cnt < J - 1 ? cnt : J - 1;
    out[t] = topics[base + pos];
  }
}

}  // namespace

// Plain C launcher for ctypes: launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 = launched).
extern "C" int sparse_row(const float* vals, const int* topics,
                          const float* targets, int* out, int T, int J,
                          void* stream) {
  if (T <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((T + kWarpsPerBlock - 1)
                                     / kWarpsPerBlock);
  sparse_row_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      (cudaStream_t)stream>>>(vals, topics, targets, out, T,
                                              J);
  return (int)cudaGetLastError();
}
