// Kernels K3 (per-tile histogram) and K4 (CDF application) of CLAHE
// (see ops/clahe.py).
//
// K3 replaces lvislam_tpu/ops/pallas_clahe.py:53 tile_hist. One block per
// tile of the tiles x tiles tiling of the cropped th*tiles x tw*tiles
// region; each warp owns an n_bins int histogram in shared memory and
// counts its rows into it with shared-memory atomicAdd. The block then sums
// the warp histograms in warp order and writes each bin once, as f32.
// Integer counts do not depend on the order of the atomics, so the result
// repeats bit for bit. A pixel's bin is (int)(clamp(x, 0, 1) * (n_bins-1)),
// truncated, as lvislam_tpu/ops/image.py:192 computes it.
//
// K4 replaces lvislam_tpu/ops/pallas_clahe.py:98 apply_lut. One thread per
// column, kApplyRows rows a block. For a pixel at (y, x) the two-tap weights of
// image.py:lerp_mat give tile rows (r0, r1) with (wy0, wy1) and tile columns
// (s0, s1) with (wx0, wx1); the output is
//   wx0 * (wy0*C[r0,s0,b] + wy1*C[r1,s0,b]) + wx1 * (wy0*C[r0,s1,b] + wy1*C[r1,s1,b])
// with every op rounded on its own (never contracted into an FMA), which is
// the plain PyTorch version's order. A block first copies the CDF rows of
// the tiles its pixels can touch into shared memory (a window of at most
// cap_r x cap_c tiles, 4 x 5 at 576x1024), so the per-pixel gathers hit
// shared memory. Bound on the card: one read of the image and one write of
// the result (4.7 MB at 576x1024).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHistMaxWarps = 16;
constexpr int kHistSmem = 48 * 1024;  // warp histograms fit the static limit
constexpr int kApplyThreads = 256;
constexpr int kApplyRows = 8;
constexpr int kMaxSmem = 227 * 1024;

__global__ void clahe_hist_kernel(const float* __restrict__ img,
                                  float* __restrict__ hist,
                                  int W, int th, int tw, int tiles, int n_bins) {
  extern __shared__ int wh[];  // [warps][n_bins]
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < nw * n_bins; i += blockDim.x) wh[i] = 0;
  __syncthreads();

  const int tile = blockIdx.x;
  const int ty = tile / tiles;
  const int tx = tile - ty * tiles;
  const float* base = img + (size_t)ty * th * W + (size_t)tx * tw;
  int* mine = wh + warp * n_bins;
  const float scale = (float)(n_bins - 1);
  for (int r = warp; r < th; r += nw) {
    const float* row = base + (size_t)r * W;
    for (int c = lane; c < tw; c += 32) {
      const float v = fminf(fmaxf(row[c], 0.f), 1.f);
      atomicAdd(&mine[(int)__fmul_rn(v, scale)], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    int s = 0;
    for (int w = 0; w < nw; ++w) s += wh[w * n_bins + b];
    hist[(size_t)tile * n_bins + b] = (float)s;
  }
}

// image.py:lerp_mat for pixel i of an axis with tiles of `span` pixels:
// cc = (i + 0.5) / span - 0.5, i0 = clip(floor(cc), 0, tiles-1),
// i1 = min(i0 + 1, tiles-1), f = clip(cc - i0, 0, 1), weights (1-f, f).
__device__ __forceinline__ void lerp_taps(int i, int span, int tiles, int& i0,
                                          int& i1, float& w0, float& w1) {
  const float cc = __fsub_rn(__fdiv_rn(__fadd_rn((float)i, 0.5f), (float)span), 0.5f);
  const float a = fminf(fmaxf(floorf(cc), 0.f), (float)(tiles - 1));
  i0 = (int)a;
  i1 = min(i0 + 1, tiles - 1);
  const float f = fminf(fmaxf(__fsub_rn(cc, a), 0.f), 1.f);
  w0 = __fsub_rn(1.f, f);
  w1 = f;
}

__global__ void clahe_apply_kernel(const float* __restrict__ img,
                                   const float* __restrict__ cdf,
                                   float* __restrict__ out,
                                   int H, int W, int th, int tw, int tiles,
                                   int n_bins, int cap_r, int cap_c) {
  extern __shared__ float win[];  // [nr][nc][n_bins] CDF window
  const int x0 = blockIdx.x * blockDim.x;
  const int y0 = blockIdx.y * kApplyRows;
  const int xl = min(W, x0 + (int)blockDim.x) - 1;
  const int yl = min(H, y0 + kApplyRows) - 1;
  int rlo, rhi, clo, chi, unused;
  float u0, u1;
  lerp_taps(y0, th, tiles, rlo, unused, u0, u1);
  lerp_taps(yl, th, tiles, unused, rhi, u0, u1);
  lerp_taps(x0, tw, tiles, clo, unused, u0, u1);
  lerp_taps(xl, tw, tiles, unused, chi, u0, u1);
  const int nr = rhi - rlo + 1;
  const int nc = chi - clo + 1;
  if (nr > cap_r || nc > cap_c) __trap();  // the host's window bound failed
  const int row_len = nc * n_bins;  // tiles (r, clo..chi) are contiguous
  for (int i = threadIdx.x; i < nr * row_len; i += blockDim.x) {
    const int r = i / row_len;
    win[i] = cdf[((size_t)(rlo + r) * tiles + clo) * n_bins + (i - r * row_len)];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  int s0, s1;
  float wx0, wx1;
  lerp_taps(x, tw, tiles, s0, s1, wx0, wx1);
  s0 = (s0 - clo) * n_bins;
  s1 = (s1 - clo) * n_bins;
  const float scale = (float)(n_bins - 1);
  for (int y = y0; y <= yl; ++y) {
    int r0, r1;
    float wy0, wy1;
    lerp_taps(y, th, tiles, r0, r1, wy0, wy1);
    const float* c0 = win + (r0 - rlo) * row_len;
    const float* c1 = win + (r1 - rlo) * row_len;
    const float v = fminf(fmaxf(img[(size_t)y * W + x], 0.f), 1.f);
    const int b = (int)__fmul_rn(v, scale);
    const float a0 = __fadd_rn(__fmul_rn(wy0, c0[s0 + b]), __fmul_rn(wy1, c1[s0 + b]));
    const float a1 = __fadd_rn(__fmul_rn(wy0, c0[s1 + b]), __fmul_rn(wy1, c1[s1 + b]));
    out[(size_t)y * W + x] = __fadd_rn(__fmul_rn(wx0, a0), __fmul_rn(wx1, a1));
  }
}

}  // namespace

extern "C" int lvt_clahe_hist(const void* img, void* hist, int H, int W,
                              int tiles, int n_bins, void* stream) {
  const int th = H / tiles, tw = W / tiles;
  int warps = kHistSmem / (n_bins * (int)sizeof(int));
  warps = std::max(1, std::min(kHistMaxWarps, warps));
  const size_t smem = (size_t)warps * n_bins * sizeof(int);
  if (smem > (size_t)kHistSmem) return (int)cudaErrorInvalidValue;
  clahe_hist_kernel<<<tiles * tiles, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)img, (float*)hist, W, th, tw, tiles, n_bins);
  return (int)cudaGetLastError();
}

extern "C" int lvt_clahe_apply(const void* img, const void* cdf, void* out,
                               int H, int W, int tiles, int n_bins,
                               void* stream) {
  const int th = H / tiles, tw = W / tiles;
  // tiles a block's rows / columns can touch: floor((n-1)/span) + 3, plus
  // one for rounding at tile boundaries
  const int cap_r = std::min(tiles, (kApplyRows - 1) / th + 4);
  const int cap_c = std::min(tiles, (kApplyThreads - 1) / tw + 4);
  const size_t smem = (size_t)cap_r * cap_c * n_bins * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        clahe_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + kApplyThreads - 1) / kApplyThreads,
                  (H + kApplyRows - 1) / kApplyRows);
  clahe_apply_kernel<<<grid, kApplyThreads, smem, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)cdf, (float*)out, H, W, th, tw, tiles,
      n_bins, cap_r, cap_c);
  return (int)cudaGetLastError();
}
