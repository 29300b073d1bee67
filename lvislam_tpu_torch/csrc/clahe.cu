// Kernels K3 (per-tile histogram) and K4 (CDF application) of CLAHE
// (see ops/clahe.py).
//
// K3 replaces lvislam_tpu/ops/pallas_clahe.py:53 tile_hist: the n_bins-bin
// histogram of each tile of the tiles x tiles tiling of the cropped
// th*tiles x tw*tiles region, exact counts in f32. A pixel's bin is
// (int)(clamp(x, 0, 1) * (n_bins-1)), truncated, as
// lvislam_tpu/ops/image.py:192 computes it. Bound on the card: one read of
// the image (2.4 MB at 576x1024, 0.72 us at HBM rate), which is less than a
// launch costs, so the design is about latency: many blocks, each with all
// of its loads in flight at once.
//  - Vector kernel (W and tw multiples of 4, a 16-byte aligned image): a tile
//    is cut into `slabs` bands of rows, one block each, so that the grid holds
//    up to about two blocks an SM (ops/clahe.py:hist_slabs: no band under two
//    loads a thread). A thread starts up to kHistLoads 16-byte loads
//    before the block clears its histograms and before its first atomicAdd.
//    Each warp counts into its own n_bins ints of shared memory; the block
//    sums its warps' histograms into the first one.
//  - Aligned kernel (W a multiple of 4 and a 16-byte aligned image, but tw
//    not: the EuRoC camera's 752 columns give tw = 94): the same kernel over
//    groups of G = 4 / gcd(tw, 4) neighbouring tiles of one tile row, whose
//    G * tw columns are a multiple of 4, so no 16-byte load straddles two
//    groups. A pixel's tile in its group is G - 1 compares of its column;
//    each warp counts into G * n_bins ints. The vector kernel is G = 1.
//  - The slabs of a tile (group) are merged without float atomics and in the
//    same launch: its blocks are one thread block cluster; after a cluster
//    barrier each block sums its share of the bins over all the blocks'
//    histograms through distributed shared memory and writes them once as
//    f32. Integer counts are the same in any order, so the result repeats
//    bit for bit and equals torch.bincount.
//  - General kernel (W % 4 != 0, a misaligned image, or tiles % G != 0): one
//    block a tile, scalar loads.
//
// K4 replaces lvislam_tpu/ops/pallas_clahe.py:98 apply_lut. For a pixel at
// (y, x) the two-tap weights of image.py:lerp_mat give tile rows (r0, r1)
// with (wy0, wy1) and tile columns (s0, s1) with (wx0, wx1); the output is
//   wx0 * (wy0*C[r0,s0,b] + wy1*C[r1,s0,b]) + wx1 * (wy0*C[r0,s1,b] + wy1*C[r1,s1,b])
// with every op rounded on its own (never contracted into an FMA), which is
// the plain PyTorch version's order. Bound on the card: one read of the image
// and the CDFs and one write of the result (4.8 MB at 576x1024, 1.43 us).
//  - Vector kernel (W a multiple of 4, tw of 8, 16-byte aligned tensors):
//    blocks are cut along the interpolation lattice. All pixels between the
//    same two tile-centre rows and the same two tile-centre columns blend the
//    same four tiles, so a block of one lattice cell's columns by `rows` rows
//    of one cell needs a window of 2 x 2 tiles (capacity 3 x 3, worked out
//    from the block's own first and last pixel; a larger one traps). A thread
//    owns 4 neighbouring columns and walks the block's rows: it starts its
//    16-byte pixel loads first, then works out its column taps (the first
//    `rows` threads also one row's taps each, into shared memory) while the
//    pixels and the window arrive, and writes 16 bytes a row.
//  - The window's rows (neighbouring tiles are neighbours in memory) come
//    into shared memory by cp.async.bulk copies that complete on an
//    mbarrier, started by one thread after the pixel loads.
//  - Aligned kernel (W and n_bins multiples of 4, 16-byte aligned tensors, tw
//    not a multiple of 8, so lattice cells start on odd columns: at tw = 94
//    on 47, 141, ...): the vector kernel with the x axis cut into blocks of
//    `cols` columns from column 0, a power of two no wider than a tile,
//    instead of at lattice cells. A block then spans two lattice cells at
//    most, a window of 2 x 3 tiles, and each of a thread's 4 columns has its
//    own taps, so a 16-byte vector that straddles a cell edge needs nothing
//    more. Rows are cut at lattice cells as in the vector kernel.
//  - General kernel (W or n_bins % 4 != 0, a misaligned tensor, tw < 4): one
//    thread a column, kApplyRows rows a block, the window copied by the
//    threads before the first pixel load.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kHistMaxWarps = 16;     // general kernel
constexpr int kHistVecWarps = 8;      // vector kernel
constexpr int kHistMaxSlabs = 8;      // vector kernel: the portable cluster size
constexpr int kHistLoads = 4;         // 16-byte loads a thread has in flight
constexpr int kHistSmem = 48 * 1024;  // warp histograms fit the static limit
constexpr int kApplyThreads = 256;
constexpr int kApplyRows = 8;      // general kernel: rows a block
constexpr int kApplyLoads = 4;     // vector kernel: 16-byte loads in flight
constexpr int kApplyMaxRows = 64;  // vector kernel: most rows a block
constexpr int kWin = 3;            // vector kernel: window capacity, tiles a side
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ int bin_of(float x, float scale) {
  return (int)__fmul_rn(fminf(fmaxf(x, 0.f), 1.f), scale);
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

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
    for (int c = lane; c < tw; c += 32) atomicAdd(&mine[bin_of(row[c], scale)], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    int s = 0;
    for (int w = 0; w < nw; ++w) s += wh[w * n_bins + b];
    hist[(size_t)tile * n_bins + b] = (float)s;
  }
}

// Block (group, slab) of a grid of tiles*tiles/G*slabs blocks: a group is G
// neighbouring tiles of one tile row (G = 1: one tile, the vector kernel);
// the `slabs` blocks of a group are one cluster.
template <int G>
__global__ void clahe_hist_vec_kernel(const float* __restrict__ img,
                                      float* __restrict__ hist, int W, int th,
                                      int tw, int tiles, int n_bins, int slabs) {
  extern __shared__ int wh[];  // [warps][G][n_bins]
  const int nw = blockDim.x >> 5;
  const int group = blockIdx.x / slabs;
  const int slab = blockIdx.x - group * slabs;
  const int groups = tiles / G;  // a tile row's
  const int ty = group / groups;
  const int tx = (group - ty * groups) * G;  // the group's first tile
  const int r0 = slab * th / slabs;  // never empty: slabs <= th
  const int r1 = (slab + 1) * th / slabs;
  const int c4 = (G * tw) >> 2, w4 = W >> 2;
  const int n = (r1 - r0) * c4;  // the slab's 16-byte vectors
  const int nb = G * n_bins;     // a warp's counters
  const float4* base = reinterpret_cast<const float4*>(
      img + ((size_t)ty * th + r0) * W + (size_t)tx * tw);
  int* mine = wh + (threadIdx.x >> 5) * nb;
  const float scale = (float)(n_bins - 1);
  const int step = blockDim.x;

  float4 v[kHistLoads];
  int col[kHistLoads];  // G > 1: the vector's first column in the group
  auto load = [&](int i0) {
#pragma unroll
    for (int k = 0; k < kHistLoads; ++k) {
      const int i = i0 + k * step;
      if (i < n) {
        const int r = i / c4;
        v[k] = __ldg(base + (size_t)r * w4 + (i - r * c4));
        if constexpr (G > 1) col[k] = 4 * (i - r * c4);
      }
    }
  };
  // the pixel's counter: its tile in the group (columns [t*tw, (t+1)*tw)), its bin
  auto add = [&](float x, int c) {
    int t = 0;
    if constexpr (G > 1) t = (c >= tw);
    if constexpr (G > 2) t += (c >= 2 * tw) + (c >= 3 * tw);
    atomicAdd(&mine[t * n_bins + bin_of(x, scale)], 1);
  };
  auto count = [&](int i0) {
#pragma unroll
    for (int k = 0; k < kHistLoads; ++k) {
      if (i0 + k * step < n) {
        const int c = G > 1 ? col[k] : 0;
        add(v[k].x, c);
        add(v[k].y, c + 1);
        add(v[k].z, c + 2);
        add(v[k].w, c + 3);
      }
    }
  };

  load(threadIdx.x);  // in flight while the histograms are cleared
  for (int i = threadIdx.x; i < nw * nb; i += step) wh[i] = 0;
  __syncthreads();
  count(threadIdx.x);
  for (int i0 = threadIdx.x + kHistLoads * step; i0 < n; i0 += kHistLoads * step) {
    load(i0);
    count(i0);
  }
  __syncthreads();

  for (int b = threadIdx.x; b < nb; b += step) {
    int s = 0;
    for (int w = 0; w < nw; ++w) s += wh[w * nb + b];
    wh[b] = s;
  }
  // the group's G tiles are neighbours in the tile row-major result
  float* out = hist + ((size_t)ty * tiles + tx) * n_bins;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int b = slab * step + threadIdx.x; b < nb; b += slabs * step) {
    int s = 0;
    for (int k = 0; k < slabs; ++k) s += cluster.map_shared_rank(wh, k)[b];
    out[b] = (float)s;
  }
  cluster.sync();  // no block leaves while another reads its histogram
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

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
    const int b = bin_of(img[(size_t)y * W + x], scale);
    const float a0 = __fadd_rn(__fmul_rn(wy0, c0[s0 + b]), __fmul_rn(wy1, c1[s0 + b]));
    const float a1 = __fadd_rn(__fmul_rn(wy0, c0[s1 + b]), __fmul_rn(wy1, c1[s1 + b]));
    out[(size_t)y * W + x] = __fadd_rn(__fmul_rn(wx0, a0), __fmul_rn(wx1, a1));
  }
}

// The vector kernel's blocks along one axis of n pixels in `tiles` tiles of
// `span`: the lattice cells are [0, half), then tiles-1 cells of `span`
// pixels from `half` on, then the rest up to n, with half = span / 2 the
// first pixel whose lerp_mat coordinate is not negative. A cell is cut into
// blocks of `size` pixels: `per_first` in the first cell, `per_mid` in each
// middle one. ops/clahe.py:axis_blocks lists the same blocks on the host.
struct Axis {
  int n, span, tiles, half, per_first, per_mid, blocks;
};

Axis make_axis(int n, int tiles, int size) {
  Axis a;
  a.n = n;
  a.tiles = tiles;
  a.span = n / tiles;
  a.half = a.span / 2;
  a.per_first = (a.half + size - 1) / size;
  a.per_mid = (a.span + size - 1) / size;
  const int rest = n - a.half - (tiles - 1) * a.span;
  a.blocks = a.per_first + (tiles - 1) * a.per_mid + (rest + size - 1) / size;
  return a;
}

__device__ __forceinline__ void axis_block(const Axis a, int j, int size, int& lo, int& hi) {
  int start = 0, end = a.half;
  if (j >= a.per_first) {
    j -= a.per_first;
    const int c = min(j / a.per_mid, a.tiles - 1);
    j -= c * a.per_mid;
    start = a.half + c * a.span;
    end = c < a.tiles - 1 ? start + a.span : a.n;
  }
  lo = start + j * size;
  hi = min(lo + size, end);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One thread: ready the barrier for one arrival that brings `bytes`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by the copy engine
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  asm volatile(
      "{\n .reg .pred P1;\n LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      " @P1 bra DONE;\n bra LAB_WAIT;\n DONE:\n}\n" ::"r"(smem_addr(bar)), "r"(phase) : "memory");
}

// Block (blockIdx.x, blockIdx.y) takes 4 * cx columns at most (cx = 1 <<
// cx_shift threads along x) by block blockIdx.y of axis `ay` (`rows` rows at
// most). kLattice (the vector kernel): the columns are block blockIdx.x of
// axis `ax`; else (the aligned kernel) columns [4 * cx * blockIdx.x, +4 * cx).
template <bool kLattice>
__global__ void __launch_bounds__(kApplyThreads)
clahe_apply_vec_kernel(const float* __restrict__ img, const float* __restrict__ cdf,
                       float* __restrict__ out, const Axis ay, const Axis ax,
                       int n_bins, int rows, int cx_shift) {
  extern __shared__ __align__(16) float win[];
  __shared__ int4 rtap[kApplyMaxRows];  // a row's two table offsets and two weights
  __shared__ uint64_t bar;
  const int cx = 1 << cx_shift;
  const int lx = threadIdx.x & (cx - 1);
  const int ly = threadIdx.x >> cx_shift;
  const int ry = kApplyThreads >> cx_shift;  // rows the block's threads cover at once
  int y_lo, y_hi, x_lo, x_hi;
  axis_block(ay, blockIdx.y, rows, y_lo, y_hi);
  const int W = ax.n, tiles = ax.tiles;
  if constexpr (kLattice) {
    axis_block(ax, blockIdx.x, 4 * cx, x_lo, x_hi);
  } else {
    x_lo = 4 * cx * blockIdx.x;
    x_hi = min(x_lo + 4 * cx, W);
  }
  const int x = x_lo + 4 * lx;
  const bool live = x < x_hi;  // blocks start and end on multiples of 4

  float4 v[kApplyLoads];
  auto load = [&](int y0) {
#pragma unroll
    for (int k = 0; k < kApplyLoads; ++k) {
      const int y = y0 + k * ry;
      if (live && y < y_hi)
        v[k] = __ldg(reinterpret_cast<const float4*>(img + (size_t)y * W + x));
    }
  };
  load(y_lo + ly);  // in flight while the window and the taps are made

  int rlo, rhi, clo, chi, unused;
  float u0, u1;
  lerp_taps(y_lo, ay.span, tiles, rlo, unused, u0, u1);
  lerp_taps(y_hi - 1, ay.span, tiles, unused, rhi, u0, u1);
  lerp_taps(x_lo, ax.span, tiles, clo, unused, u0, u1);
  lerp_taps(x_hi - 1, ax.span, tiles, unused, chi, u0, u1);
  const int nr = rhi - rlo + 1;
  const int nc = chi - clo + 1;
  if (nr > kWin || nc > kWin) __trap();  // the block spans more than two lattice cells
  const int row_len = nc * n_bins;  // tiles (r, clo..chi) are contiguous

  if (threadIdx.x == 0) {
    mbar_expect(&bar, (unsigned)(nr * row_len * sizeof(float)));
    for (int r = 0; r < nr; ++r)
      bulk_copy(win + r * row_len, cdf + ((size_t)(rlo + r) * tiles + clo) * n_bins,
                (unsigned)(row_len * sizeof(float)), &bar);
  }
  if (threadIdx.x < y_hi - y_lo) {
    int r0, r1;
    float wy0, wy1;
    lerp_taps(y_lo + threadIdx.x, ay.span, tiles, r0, r1, wy0, wy1);
    rtap[threadIdx.x] = make_int4((r0 - rlo) * row_len, (r1 - rlo) * row_len,
                                  __float_as_int(wy0), __float_as_int(wy1));
  }
  int s0[4], s1[4];
  float wx0[4], wx1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lerp_taps(x + j, ax.span, tiles, s0[j], s1[j], wx0[j], wx1[j]);
    s0[j] = (s0[j] - clo) * n_bins;
    s1[j] = (s1[j] - clo) * n_bins;
  }
  __syncthreads();
  mbar_wait(&bar, 0);

  const float scale = (float)(n_bins - 1);
  auto blend = [&](int y0) {
#pragma unroll
    for (int k = 0; k < kApplyLoads; ++k) {
      const int y = y0 + k * ry;
      if (!(live && y < y_hi)) continue;
      const int4 t = rtap[y - y_lo];
      const float wy0 = __int_as_float(t.z), wy1 = __int_as_float(t.w);
      const float px[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      float res[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = bin_of(px[j], scale);
        const float* c0 = win + t.x + b;
        const float* c1 = win + t.y + b;
        const float a0 = __fadd_rn(__fmul_rn(wy0, c0[s0[j]]), __fmul_rn(wy1, c1[s0[j]]));
        const float a1 = __fadd_rn(__fmul_rn(wy0, c0[s1[j]]), __fmul_rn(wy1, c1[s1[j]]));
        res[j] = __fadd_rn(__fmul_rn(wx0[j], a0), __fmul_rn(wx1[j], a1));
      }
      *reinterpret_cast<float4*>(out + (size_t)y * W + x) =
          make_float4(res[0], res[1], res[2], res[3]);
    }
  };
  blend(y_lo + ly);
  for (int y0 = y_lo + ly + kApplyLoads * ry; y0 < y_hi; y0 += kApplyLoads * ry) {
    load(y0);
    blend(y0);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// slabs = 0: the general kernel. slabs in 1..min(kHistMaxSlabs, th): the
// vector kernel (tw % 4 == 0) or the aligned one (groups of G = 4 / gcd(tw,
// 4) tiles; tiles % G == 0), the slabs of a tile or group merged through a
// cluster.
extern "C" int lvt_clahe_hist(const void* img, void* hist, int H, int W, int tiles,
                              int n_bins, int slabs, void* stream) {
  const int th = H / tiles, tw = W / tiles;
  const int fit = kHistSmem / (n_bins * (int)sizeof(int));
  if (fit < 1) return (int)cudaErrorInvalidValue;
  if (slabs == 0) {
    const int warps = std::min(kHistMaxWarps, fit);
    clahe_hist_kernel<<<tiles * tiles, warps * 32, (size_t)warps * n_bins * sizeof(int),
                        (cudaStream_t)stream>>>(
        (const float*)img, (float*)hist, W, th, tw, tiles, n_bins);
    return (int)cudaGetLastError();
  }
  const int g = tw % 4 == 0 ? 1 : tw % 2 == 0 ? 2 : 4;  // 4 / gcd(tw, 4)
  if (slabs < 0 || slabs > std::min(kHistMaxSlabs, th) || W % 4 || tiles % g || !aligned16(img))
    return (int)cudaErrorInvalidValue;
  // two 16-byte loads a thread where the slab is large enough; one warp's
  // G * n_bins counters may pass the 48 KB budget (G = 4 and n_bins > 3072)
  const int vectors = ((th + slabs - 1) / slabs) * (g * tw / 4);
  const int warps =
      std::max(1, std::min({kHistVecWarps, fit / g, (vectors + 63) / 64}));
  const size_t smem = (size_t)warps * g * n_bins * sizeof(int);
  auto kernel = g == 1 ? &clahe_hist_vec_kernel<1>
                       : g == 2 ? &clahe_hist_vec_kernel<2> : &clahe_hist_vec_kernel<4>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = slabs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * tiles / g * slabs);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, (const float*)img, (float*)hist, W, th,
                                           tw, tiles, n_bins, slabs);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// rows = 0: the general kernel (cols unused). Else blocks of `rows` rows at
// most of one lattice cell (make_axis) by, with cols = 0, the vector kernel's
// columns of one lattice cell (a tile's width rounded up to a power of two,
// 256 at most; tw % 8 == 0), or the aligned kernel's `cols` columns from
// column 0 (a power of two from 4 to min(tw, 256)).
extern "C" int lvt_clahe_apply(const void* img, const void* cdf, void* out, int H, int W,
                               int tiles, int n_bins, int rows, int cols, void* stream) {
  const int th = H / tiles, tw = W / tiles;
  if (rows == 0) {
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
  if (rows < 0 || rows > kApplyMaxRows || W % 4 || n_bins % 4 || !aligned16(img) ||
      !aligned16(out) || !aligned16(cdf))
    return (int)cudaErrorInvalidValue;
  if (cols == 0 ? tw % 8 != 0
                : cols < 4 || cols > std::min(tw, kApplyThreads) || (cols & (cols - 1)))
    return (int)cudaErrorInvalidValue;
  int cx_shift = 0;  // 4 << cx_shift columns a block
  if (cols == 0) {
    while ((4 << cx_shift) < tw && (4 << cx_shift) < kApplyThreads) ++cx_shift;
  } else {
    while ((4 << cx_shift) < cols) ++cx_shift;
  }
  const Axis ay = make_axis(H, tiles, rows);
  const Axis ax = make_axis(W, tiles, 4 << cx_shift);
  const int side = std::min(tiles, kWin);
  const size_t smem = (size_t)side * side * n_bins * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = cols == 0 ? &clahe_apply_vec_kernel<true> : &clahe_apply_vec_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int bx = cols == 0 ? ax.blocks : (W + cols - 1) / cols;
  kernel<<<dim3(bx, ay.blocks), kApplyThreads, smem, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)cdf, (float*)out, ay, ax, n_bins, rows, cx_shift);
  return (int)cudaGetLastError();
}
