// Kernel K1: voxel-hash candidate scoring + top-k (see ops/knn_tail.py).
//
// Replaces lvislam_tpu/ops/pallas_knn.py:79 topk_tail. One warp per query:
// lane l owns the flat candidate positions p = l + 32*i (i < 27), i.e. cell
// j = p / B, bucket rank r = p % B, and reads the planar int16 row
//   cand[q, j*4B + {0,1,2,3}*B + r]   (x, y, z, tag)
// straight from the gathered block. The scaled squared distance is
// (x*x + y*y) + z*z with x = cand_x + (corner_x - q_x), every op rounded on
// its own (__fadd_rn / __fmul_rn are never contracted into FMAs), matching
// the plain PyTorch version bit for bit. Lanes whose tag does not match the
// wanted cell tag score 1e10 (empty lanes carry tag -1).
//
// Selection: k rounds of a warp-wide argmin over (distance, position), the
// lower position winning ties — the order lax.top_k / a stable sort gives —
// then the owning lane marks the winner spent (1e30). Bound on the card:
// the single read of the gathered rows; nothing else touches device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCells = 27;
constexpr int kPerLane = 27;  // ceil(27 * 32 / 32): B <= 32
constexpr float kBig = 1e10f;
constexpr float kSpent = 1e30f;
constexpr float kPad = 3.0e38f;  // positions past 27*B: never selected

__global__ void knn_tail_kernel(const int16_t* __restrict__ cand,
                                const int32_t* __restrict__ want_tag,
                                const float* __restrict__ corner_off,
                                float* __restrict__ dist,
                                int32_t* __restrict__ pos,
                                int Q, int B, int k) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= Q) return;
  const int L = kCells * B;
  const int16_t* row = cand + (size_t)warp * (kCells * 4 * B);
  const int32_t* tags = want_tag + (size_t)warp * kCells;
  const float* off = corner_off + (size_t)warp * (3 * kCells);

  float d[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int p = lane + 32 * i;
    float v = kPad;
    if (p < L) {
      const int j = p / B;
      const int r = p - j * B;
      const int16_t* cell = row + j * 4 * B + r;
      const float x = __fadd_rn((float)cell[0], off[j]);
      const float y = __fadd_rn((float)cell[B], off[kCells + j]);
      const float z = __fadd_rn((float)cell[2 * B], off[2 * kCells + j]);
      const float s = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                __fmul_rn(z, z));
      v = ((int)cell[3 * B] == tags[j]) ? s : kBig;
    }
    d[i] = v;
  }

  for (int t = 0; t < k; ++t) {
    // lane-local min; positions rise with i, so strict < keeps the lowest
    float best = d[0];
    int best_p = lane;
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) {
      if (d[i] < best) {
        best = d[i];
        best_p = lane + 32 * i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int op = __shfl_xor_sync(0xffffffffu, best_p, o);
      if (ob < best || (ob == best && op < best_p)) {
        best = ob;
        best_p = op;
      }
    }
    if (lane == 0) {
      dist[(size_t)warp * k + t] = fminf(best, kBig);
      pos[(size_t)warp * k + t] = best_p;
    }
    if ((best_p & 31) == lane) {
      const int slot = best_p >> 5;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        if (i == slot) d[i] = kSpent;
      }
    }
  }
}

}  // namespace

extern "C" int lvt_knn_tail(const void* cand, const void* want_tag,
                            const void* corner_off, void* dist, void* pos,
                            int Q, int B, int k, void* stream) {
  constexpr int kThreads = 256;  // 8 queries per block
  const int blocks = (int)(((long long)Q * 32 + kThreads - 1) / kThreads);
  knn_tail_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)cand, (const int32_t*)want_tag, (const float*)corner_off,
      (float*)dist, (int32_t*)pos, Q, B, k);
  return (int)cudaGetLastError();
}
