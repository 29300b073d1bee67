// Kernel K1: voxel-hash candidate scoring + top-k for two query sets in one
// launch (see ops/knn_tail.py).
//
// Replaces lvislam_tpu/ops/pallas_knn.py:79 topk_tail, which the JAX step
// calls once per feature class. Each query's candidates are one contiguous
// gathered row of planar int16 cells, cand[q, j*4B + {0,1,2,3}*B + r]
// (x, y, z, tag) for cell j < 27 and bucket rank r < B. The scaled squared
// distance of flat position p = j*B + r is (x*x + y*y) + z*z with
// x = cand_x + (corner_x - q_x), every op rounded on its own (__fadd_rn /
// __fmul_rn are never contracted into FMAs), matching the plain PyTorch
// version bit for bit. Lanes whose tag does not match the wanted cell tag
// score 1e10 (empty lanes carry tag -1). Selection: k rounds of a warp-wide
// argmin over (distance, position), the lower position winning ties — the
// order lax.top_k / a stable sort gives — then the owning lane marks the
// winner spent (1e30).
//
// Bound on the card: the single read of the gathered rows (11.8 MB for the
// LIO step's 512 corner queries at B=32 and 2048 surf queries at B=16:
// 3.5 us at HBM rate). The design keeps that read in flight while the
// scoring and selection run:
//  - one grid over both sets' queries, of persistent warps (as many as fit
//    on the card at once), each looping over queries one grid-stride apart;
//  - at the main path's buckets (16 and 32, compiled as constants) a warp
//    stages its query's row (3,456 or 6,912 B, contiguous and 16-byte
//    aligned) in shared memory with one cp.async.bulk copy that completes on
//    the warp's mbarrier, and the row's want_tag and corner_off (108 and
//    324 B, not 16-byte aligned a query) with 4-byte cp.async copies. Once
//    the row has been scored out of shared memory, the warp starts its next
//    query's copies, which stream in while it selects this one's top k. Each
//    lane scores 8 consecutive ranks of a cell from one 16-byte vector of
//    each of the x, y, z and tag planes, one cell's vectors at a time, so the
//    row never sits in registers whole; a position's cell and rank are
//    shifts and masks. The row keeps its global layout in shared memory, so
//    these reads conflict 2-way (B=32) or 4-way (B=16) across banks: on the
//    H100 that cost less than the 27 copies a row that a padded,
//    conflict-free layout needs. Any other B up to 32 reads one candidate at
//    a time from global memory, with B at run time, one warp a query;
//  - each round's lane-local argmin is a pairwise tree (depth log2 of the
//    lane's values, not a chain), and the warp-wide argmin is two
//    redux.sync minima: the distance's bits (non-negative floats order as
//    their bits), then the lowest position among the lanes that hold it.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCells = 27;
constexpr int kMaxB = 32;
constexpr int kWarps = 4;  // warps a block
constexpr int kBlocksPerSM = 5;  // the staged kernel's occupancy floor
constexpr float kBig = 1e10f;
constexpr float kSpent = 1e30f;
constexpr float kPad = 3.0e38f;  // positions past 27*B: never selected

struct QuerySet {
  const int16_t* cand;       // (Q, 27*4*B)
  const int32_t* want_tag;   // (Q, 27)
  const float* corner_off;   // (Q, 81)
  float* dist;               // (Q, k)
  int32_t* pos;              // (Q, k)
  int Q;
  int B;
};

// One query's inputs in shared memory, a warp's own: the row at B <= 32,
// want_tag (27 words), corner_off's bits (81 words), and the mbarrier on
// which the row's bulk copy completes.
struct alignas(16) Stage {
  int4 row[kCells * 4 * kMaxB / 8];
  int32_t side[4 * kCells];
  uint64_t bar;
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by the copy engine
}

// Arrive once on the barrier, expecting `bytes`, and copy them there.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem(bar)),
               "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  asm volatile(
      "{\n .reg .pred P1;\n LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      " @P1 bra DONE;\n bra LAB_WAIT;\n DONE:\n}\n" ::"r"(smem(bar)), "r"(phase) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float score(int x, int y, int z, int tag, int want, float ox,
                                       float oy, float oz) {
  const float dx = __fadd_rn((float)x, ox);
  const float dy = __fadd_rn((float)y, oy);
  const float dz = __fadd_rn((float)z, oz);
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return tag == want ? s : kBig;
}

// int16 element e (0..7) of a 16-byte vector
__device__ __forceinline__ int lane16(const int4& v, int e) {
  const int w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return (int)(int16_t)((e & 1) ? (w >> 16) : (w & 0xffff));
}

// k rounds of the warp-wide (distance, position) argmin over d. The lane's
// value i sits at flat position W*(lane + 32*(i/W)) + i%W: chunks of W
// consecutive positions, chunk u on lane u % 32, so positions rise with i.
template <int W, int N>
__device__ void select_k(float (&d)[N], int k, int lane, float* __restrict__ dist,
                         int32_t* __restrict__ pos) {
  for (int r = 0; r < k; ++r) {
    float bv[N];
    int bi[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      bv[i] = d[i];
      bi[i] = i;
    }
#pragma unroll
    for (int w = 1; w < N; w <<= 1) {  // the right half wins only if smaller
#pragma unroll
      for (int i = 0; i + w < N; i += 2 * w) {
        if (bv[i + w] < bv[i]) {
          bv[i] = bv[i + w];
          bi[i] = bi[i + w];
        }
      }
    }
    const unsigned best = __float_as_uint(bv[0]);
    const unsigned best_p = W * (lane + 32 * (bi[0] / W)) + bi[0] % W;
    const unsigned vmin = __reduce_min_sync(0xffffffffu, best);
    const int wp = (int)__reduce_min_sync(0xffffffffu, best == vmin ? best_p : 0xffffffffu);
    if (lane == 0) {
      dist[r] = fminf(__uint_as_float(vmin), kBig);
      pos[r] = wp;
    }
    if ((unsigned)wp / W % 32 == (unsigned)lane) {
      const int slot = (int)((unsigned)wp / (32 * W) * W + (unsigned)wp % W);
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i == slot) d[i] = kSpent;
    }
  }
}

// Start the copies of query g (of the set pair c, s) into the warp's stage.
__device__ __forceinline__ void stage_query(Stage& st, const QuerySet c, const QuerySet s,
                                            long long g, int lane) {
  const bool in_c = g < c.Q;
  const QuerySet a = in_c ? c : s;
  const int q = (int)(in_c ? g : g - c.Q);
  const unsigned bytes = kCells * 4 * a.B * sizeof(int16_t);
  if (lane == 0) bulk_copy(st.row, a.cand + (size_t)q * kCells * 4 * a.B, bytes, &st.bar);
  const int32_t* tags = a.want_tag + (size_t)q * kCells;
  const float* off = a.corner_off + (size_t)q * 3 * kCells;
  if (lane < kCells) cp_async4(&st.side[lane], tags + lane);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (lane + 32 * i < 3 * kCells)
      cp_async4(&st.side[kCells + lane + 32 * i], off + lane + 32 * i);
  cp_async_commit();
}

// Score and select query q of set a from the warp's stage (B compiled: 16
// or 32); between the two, start the copies of query `next` if there is one.
template <int B>
__device__ void query_staged(Stage& st, const QuerySet a, int q, int k, int lane,
                             const QuerySet c, const QuerySet s, long long next) {
  constexpr int C = B / 8;             // 16-byte chunks in one plane of a cell
  constexpr int U = kCells * C;        // chunks in one plane of the row
  constexpr int T = (U + 31) / 32;     // chunks a lane
  float d[T * 8];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int u = lane + 32 * t;
    if (u < U) {
      const int j = u / C;
      const int L = j * 4 * C + (u - j * C);  // the x plane's chunk
      const int4 X = st.row[L], Y = st.row[L + C], Z = st.row[L + 2 * C], G = st.row[L + 3 * C];
      const int want = st.side[j];
      const float ox = __int_as_float(st.side[kCells + j]);
      const float oy = __int_as_float(st.side[2 * kCells + j]);
      const float oz = __int_as_float(st.side[3 * kCells + j]);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[t * 8 + e] = score(lane16(X, e), lane16(Y, e), lane16(Z, e), lane16(G, e), want, ox,
                             oy, oz);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[t * 8 + e] = kPad;
    }
  }
  __syncwarp();  // every lane has read the stage: it may be refilled
  if (next < (long long)c.Q + s.Q) stage_query(st, c, s, next, lane);
  select_k<8>(d, k, lane, a.dist + (size_t)q * k, a.pos + (size_t)q * k);
}

// Every set's B is 16 or 32: persistent warps, rows staged in shared memory.
// At least kBlocksPerSM blocks an SM (at most 102 registers a thread):
// 20 warps x 132 SMs hold the LIO step's 2560 queries in one wave, where
// ptxas left alone takes 125 registers and 16 warps an SM.
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
knn_tail_staged_kernel(QuerySet c, QuerySet s, int k) {
  __shared__ Stage stages[kWarps];
  Stage& st = stages[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const long long total = (long long)c.Q + s.Q;
  const long long stride = (long long)gridDim.x * kWarps;
  long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (lane == 0) mbar_init(&st.bar);
  __syncwarp();
  if (g < total) stage_query(st, c, s, g, lane);
  for (unsigned phase = 0; g < total; g += stride, phase ^= 1) {
    const bool in_c = g < c.Q;
    const QuerySet a = in_c ? c : s;  // a copy: taking a parameter's address spills it
    const int q = (int)(in_c ? g : g - c.Q);
    cp_async_wait_all();
    mbar_wait(&st.bar, phase);
    __syncwarp();  // every lane's copies are visible to the warp
    if (a.B == 16)
      query_staged<16>(st, a, q, k, lane, c, s, g + stride);
    else
      query_staged<32>(st, a, q, k, lane, c, s, g + stride);
  }
}

// Any B up to 32, at run time: one warp a query, one candidate at a time. A
// kernel of its own, so that its registers do not lower the main path's
// occupancy.
__global__ void __launch_bounds__(kWarps * 32)
knn_tail_any_kernel(QuerySet c, QuerySet s, int k) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= (long long)c.Q + s.Q) return;
  const bool in_c = g < c.Q;
  const QuerySet a = in_c ? c : s;
  const int q = (int)(in_c ? g : g - c.Q);
  const int B = a.B;
  const int L = kCells * B;
  const int16_t* row = a.cand + (size_t)q * kCells * 4 * B;
  const int32_t* tags = a.want_tag + (size_t)q * kCells;
  const float* off = a.corner_off + (size_t)q * 3 * kCells;
  float d[kCells];  // 27*B <= 32*27 positions
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int p = lane + 32 * i;
    float v = kPad;
    if (p < L) {
      const int j = p / B;
      const int16_t* cp = row + j * 4 * B + (p - j * B);
      v = score(__ldg(cp), __ldg(cp + B), __ldg(cp + 2 * B), __ldg(cp + 3 * B), __ldg(tags + j),
                __ldg(off + j), __ldg(off + kCells + j), __ldg(off + 2 * kCells + j));
    }
    d[i] = v;
  }
  select_k<1>(d, k, lane, a.dist + (size_t)q * k, a.pos + (size_t)q * k);
}

// Blocks of the staged kernel that the current device holds at once.
int resident_blocks(int* out) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices];  // 0 until first asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!cached[dev]) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, knn_tail_staged_kernel,
                                                        kWarps * 32, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    cached[dev] = std::max(per_sm * sms, 1);
  }
  *out = cached[dev];
  return 0;
}

}  // namespace

extern "C" int lvt_knn_tail_pair(const void* c_cand, const void* c_tag, const void* c_off,
                                 void* c_dist, void* c_pos, int Qc, int Bc,
                                 const void* s_cand, const void* s_tag, const void* s_off,
                                 void* s_dist, void* s_pos, int Qs, int Bs,
                                 int k, void* stream) {
  const QuerySet c{(const int16_t*)c_cand, (const int32_t*)c_tag, (const float*)c_off,
                   (float*)c_dist, (int32_t*)c_pos, Qc, Bc};
  const QuerySet s{(const int16_t*)s_cand, (const int32_t*)s_tag, (const float*)s_off,
                   (float*)s_dist, (int32_t*)s_pos, Qs, Bs};
  const long long total = (long long)Qc + Qs;
  if (Qc < 0 || Qs < 0 || total == 0 || total > (1LL << 30) || k < 1 ||
      (Qc > 0 && (Bc < 1 || Bc > kMaxB || k > kCells * Bc)) ||
      (Qs > 0 && (Bs < 1 || Bs > kMaxB || k > kCells * Bs)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (total + kWarps - 1) / kWarps;
  const auto staged = [](int Q, int B) { return Q == 0 || B == 16 || B == 32; };
  if (staged(Qc, Bc) && staged(Qs, Bs)) {
    int resident = 0;
    const int err = resident_blocks(&resident);
    if (err) return err;
    knn_tail_staged_kernel<<<(int)std::min<long long>(blocks, resident), kWarps * 32, 0,
                             (cudaStream_t)stream>>>(c, s, k);
  } else {
    knn_tail_any_kernel<<<(int)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(c, s, k);
  }
  return (int)cudaGetLastError();
}
