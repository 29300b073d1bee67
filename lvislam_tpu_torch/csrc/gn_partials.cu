// Kernel K2: LOAM coefficients + Gauss-Newton row partials of both feature
// classes, summed into one normal-equation system (see ops/gn_partials.py).
//
// Replaces lvislam_tpu/ops/pallas_gn.py:369 gn_partials_packed (bodies
// _corner_kernel / _surf_kernel), which the JAX step calls once per class.
// One thread per scan point follows the plain PyTorch path op for op —
// scan2map.corner_coeffs_nbrs / surf_coeffs_nbrs with the smallmat
// closed-form eigensystem (true acosf, not the TPU kernel's polynomial) and
// the gn_update row assembly — and forms the 28 per-point partials: the
// upper triangle of J^T J (21), J^T b (6) and the residual count (1). nvcc
// contracts its multiply-adds into FMAs (the default -fmad=true), as XLA's
// CPU backend does for the reference.
//
// One launch per Gauss-Newton iteration: the grid is the corner class's
// blocks followed by the surf class's, 128 points a block. The batched entry
// point (lvt_gn_partials_pair_batched: S sequences of equal sizes, as JAX's
// vmap of the step gives the TPU kernel) adds the grid's y axis: blockIdx.y
// picks the sequence, whose blocks, scratch rows, ticket and output are its
// own, so each sequence's sums are those of its own unbatched launch. A fixed-order
// tree reduces each block to one row of 28 partial sums (two levels in
// shared memory, five by warp shuffles: the same pairs), written to a
// scratch row. Each block then takes an integer ticket; the last block to
// finish stages the rows in shared memory, sums each class's in the order
// torch.sum(rows, dim=0) uses on the card (four strided accumulators, then
// ((a0 + a1) + a2) + a3 — checked bit for bit on an H100), adds the two
// classes, writes H (6x6, both triangles), g (6) and n_res, and resets the
// ticket, so a captured CUDA graph of the step stays valid. No float
// atomics: two runs give the same bits, and the same bits as one launch per
// class followed by torch.sum and an add. Bound on the card: latency — one
// thread's dependent chain through the eigensystem, then the tree, the
// ticket and the last block's sum; the 330 KB it reads take 0.1 us at HBM
// rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kParts = 28;
constexpr float kBig = 1e10f;
constexpr float kEps = 1e-12f;
constexpr float kTwoPi3 = 2.0943951023931953f;

struct Sym3 {
  float a00, a01, a02, a11, a12, a22;
};

// smallmat._eigvals_entries: descending eigenvalues
__device__ void eigvals(const Sym3& A, float& l1, float& l2, float& l3) {
  const float p1 = A.a01 * A.a01 + A.a02 * A.a02 + A.a12 * A.a12;
  const float q = (A.a00 + A.a11 + A.a22) / 3.0f;
  const float b00 = A.a00 - q, b11 = A.a11 - q, b22 = A.a22 - q;
  const float p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2 / 6.0f, kEps));
  const float detb = b00 * (b11 * b22 - A.a12 * A.a12)
                     - A.a01 * (A.a01 * b22 - A.a12 * A.a02)
                     + A.a02 * (A.a01 * A.a12 - b11 * A.a02);
  const float r = fminf(fmaxf(detb / (2.0f * p * p * p), -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  l1 = q + 2.0f * p * cosf(phi);
  l3 = q + 2.0f * p * cosf(phi + kTwoPi3);
  l2 = 3.0f * q - l1 - l3;
  if (p2 < 1e-20f) l1 = l2 = l3 = q;
}

// smallmat.sym3x3_max_eigvec: dominant column of (A - la I)(A - lb I),
// first max of the column norms
__device__ void max_eigvec(const Sym3& A, float la, float lb, float v[3]) {
  const float B[3][3] = {{A.a00 - la, A.a01, A.a02},
                         {A.a01, A.a11 - la, A.a12},
                         {A.a02, A.a12, A.a22 - la}};
  const float C[3][3] = {{A.a00 - lb, A.a01, A.a02},
                         {A.a01, A.a11 - lb, A.a12},
                         {A.a02, A.a12, A.a22 - lb}};
  float M[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      M[r][c] = B[r][0] * C[0][c] + B[r][1] * C[1][c] + B[r][2] * C[2][c];
  float nrm[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    nrm[c] = sqrtf(M[0][c] * M[0][c] + M[1][c] * M[1][c] + M[2][c] * M[2][c]);
  int col = 0;
  if (nrm[1] > nrm[col]) col = 1;
  if (nrm[2] > nrm[col]) col = 2;
  const float inv = fmaxf(nrm[col], kEps);
#pragma unroll
  for (int r = 0; r < 3; ++r) v[r] = M[r][col] / inv;
}

struct Point {
  float q[3];   // lidar frame
  float pw[3];  // world frame
  bool valid;
};

__device__ Point load_point(const float* pts, const float* par, int n, int N) {
  Point P;
#pragma unroll
  for (int c = 0; c < 3; ++c) P.q[c] = pts[c * N + n];
  P.valid = pts[3 * N + n] > 0.5f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    P.pw[i] = par[3 * i] * P.q[0] + par[3 * i + 1] * P.q[1]
              + par[3 * i + 2] * P.q[2] + par[9 + i];
  return P;
}

// neighbour distances (gate), sums for the mean
__device__ float nbr_dmax(const float* nbr, int n, int N, const Point& P,
                          float nb[5][3], bool& all_has) {
  float dmax = -kBig;
  all_has = true;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) nb[k][c] = nbr[(3 * k + c) * N + n];
    const bool h = nbr[(15 + k) * N + n] > 0.5f;
    all_has = all_has && h;
    const float dx = nb[k][0] - P.pw[0], dy = nb[k][1] - P.pw[1],
                dz = nb[k][2] - P.pw[2];
    const float d = dx * dx + dy * dy + dz * dz;
    dmax = fmaxf(dmax, h ? d : kBig);
  }
  return dmax;
}

__device__ void mean5(const float nb[5][3], float m[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    m[c] = (nb[0][c] + nb[1][c] + nb[2][c] + nb[3][c] + nb[4][c]) / 5.0f;
}

__device__ Sym3 scatter5(const float nb[5][3], const float m[3]) {
  float dv[5][3];
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) dv[k][c] = nb[k][c] - m[c];
  Sym3 S;
#define LVT_SUM5(i, j) \
  (dv[0][i] * dv[0][j] + dv[1][i] * dv[1][j] + dv[2][i] * dv[2][j] + \
   dv[3][i] * dv[3][j] + dv[4][i] * dv[4][j])
  S.a00 = LVT_SUM5(0, 0);
  S.a01 = LVT_SUM5(0, 1);
  S.a02 = LVT_SUM5(0, 2);
  S.a11 = LVT_SUM5(1, 1);
  S.a12 = LVT_SUM5(1, 2);
  S.a22 = LVT_SUM5(2, 2);
#undef LVT_SUM5
  return S;
}

// scan2map.corner_coeffs_nbrs: point-to-line normal (scaled by s) + offset
__device__ bool corner_coeffs(const Point& P, const float* nbr, int n, int N,
                              float nrm[3], float& off) {
  float nb[5][3];
  bool all_has;
  const float dmax = nbr_dmax(nbr, n, N, P, nb, all_has);
  bool ok = P.valid && (dmax < 1.0f);
  float ctr[3];
  mean5(nb, ctr);
  Sym3 A = scatter5(nb, ctr);
  A.a00 /= 5.0f; A.a01 /= 5.0f; A.a02 /= 5.0f;
  A.a11 /= 5.0f; A.a12 /= 5.0f; A.a22 /= 5.0f;
  float l1, l2, l3;
  eigvals(A, l1, l2, l3);
  ok = ok && (l1 > 3.0f * l2);
  float u[3];
  max_eigvec(A, l2, l3, u);
  const float pc[3] = {P.pw[0] - ctr[0], P.pw[1] - ctr[1], P.pw[2] - ctr[2]};
  const float cr[3] = {pc[1] * u[2] - pc[2] * u[1], pc[2] * u[0] - pc[0] * u[2],
                       pc[0] * u[1] - pc[1] * u[0]};
  const float d = sqrtf(cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2]);
  const float t = pc[0] * u[0] + pc[1] * u[1] + pc[2] * u[2];
  const float dd = fmaxf(d, 1e-9f);
  float nv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) nv[c] = (P.pw[c] - (ctr[c] + t * u[c])) / dd;
  const float s = 1.0f - 0.9f * fabsf(d);
  ok = ok && (s > 0.1f);
#pragma unroll
  for (int c = 0; c < 3; ++c) nrm[c] = ok ? s * nv[c] : 0.0f;
  off = ok ? s * d : 0.0f;
  return ok;
}

// scan2map.surf_coeffs_nbrs with smallmat.plane_fit
__device__ bool surf_coeffs(const Point& P, const float* nbr, int n, int N,
                            float nrm[3], float& off) {
  float nb[5][3];
  bool all_has;
  const float dmax = nbr_dmax(nbr, n, N, P, nb, all_has);
  bool ok = P.valid && (dmax < 1.0f) && all_has;
  float m[3];
  mean5(nb, m);
  const Sym3 S = scatter5(nb, m);
  float l1, l2, l3;
  eigvals(S, l1, l2, l3);
  float v1[3], v3[3];
  max_eigvec(S, l2, l3, v1);
  max_eigvec(S, l2, l1, v3);  // min eigenvector: roles of l1, l3 swapped
  const float m1 = v1[0] * m[0] + v1[1] * m[1] + v1[2] * m[2];
  const float m3 = v3[0] * m[0] + v3[1] * m[1] + v3[2] * m[2];
  const float reg = 1e-8f + 1e-6f * l1;
  const float w1 = 1.0f / (l1 + reg);
  const float w2 = 1.0f / (l2 + reg);
  const float w3 = 1.0f / (l3 + reg);
  float bim[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    bim[c] = w1 * m1 * v1[c] + w3 * m3 * v3[c]
             + w2 * (m[c] - m1 * v1[c] - m3 * v3[c]);
  const float sd = m[0] * bim[0] + m[1] * bim[1] + m[2] * bim[2];
  float x[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = -5.0f * bim[c] / (1.0f + 5.0f * sd);
  const float ps = fmaxf(sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]), kEps);
  float nv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) nv[c] = x[c] / ps;
  const float d0 = 1.0f / ps;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float pe = fabsf(nb[k][0] * nv[0] + nb[k][1] * nv[1]
                           + nb[k][2] * nv[2] + d0);
    ok = ok && (pe <= 0.2f);
  }
  const float pd2 = P.pw[0] * nv[0] + P.pw[1] * nv[1] + P.pw[2] * nv[2] + d0;
  const float rng = sqrtf(P.q[0] * P.q[0] + P.q[1] * P.q[1] + P.q[2] * P.q[2]);
  const float s = 1.0f - 0.9f * fabsf(pd2) / sqrtf(sqrtf(fmaxf(rng, 1e-9f)));
  ok = ok && (s > 0.1f);
#pragma unroll
  for (int c = 0; c < 3; ++c) nrm[c] = ok ? s * nv[c] : 0.0f;
  off = ok ? s * pd2 : 0.0f;
  return ok;
}

struct ClassBlocks {
  const float* pts;  // (8, N) packed points
  const float* nbr;  // (24, N) packed neighbours
  int N;
  int blocks;
};

__global__ void gn_partials_pair_kernel(ClassBlocks corner, ClassBlocks surf,
                                        const float* __restrict__ par,
                                        float* rows, int* ticket,
                                        float* __restrict__ out) {
  // sequence blockIdx.y of a batched launch (0 for the unbatched one)
  const int seq = blockIdx.y;
  corner.pts += (size_t)seq * 8 * corner.N;
  corner.nbr += (size_t)seq * 24 * corner.N;
  surf.pts += (size_t)seq * 8 * surf.N;
  surf.nbr += (size_t)seq * 24 * surf.N;
  par += (size_t)seq * 39;
  rows += (size_t)seq * gridDim.x * kParts;
  ticket += seq;
  out += (size_t)seq * 43;
  __shared__ float red[kParts][kThreads];
  __shared__ float tot[kParts];
  __shared__ float cls_tot[2][kParts];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int kind = blockIdx.x < corner.blocks ? 0 : 1;
  const float* pts = kind == 0 ? corner.pts : surf.pts;
  const float* nbr = kind == 0 ? corner.nbr : surf.nbr;
  const int N = kind == 0 ? corner.N : surf.N;
  const int n = (kind == 0 ? blockIdx.x : blockIdx.x - corner.blocks) * kThreads + tid;
  float part[kParts];
#pragma unroll
  for (int i = 0; i < kParts; ++i) part[i] = 0.0f;
  if (n < N) {
    const Point P = load_point(pts, par, n, N);
    float nrm[3], off;
    const bool ok = kind == 0 ? corner_coeffs(P, nbr, n, N, nrm, off)
                              : surf_coeffs(P, nbr, n, N, nrm, off);
    // gn_update rows: [n·(Ja q), n·(Jb q), n·(Jc q), n] * w, b = -off * w
    const float w = ok ? 1.0f : 0.0f;
    float J[6];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* Ja = par + 12 + 9 * a;  // row-major 3x3
      float jp[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        jp[i] = P.q[0] * Ja[3 * i] + P.q[1] * Ja[3 * i + 1]
                + P.q[2] * Ja[3 * i + 2];
      J[a] = (nrm[0] * jp[0] + nrm[1] * jp[1] + nrm[2] * jp[2]) * w;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) J[3 + c] = nrm[c] * w;
    const float b = -off * w;
    int t = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int c = a; c < 6; ++c) part[t++] = J[a] * J[c];
#pragma unroll
    for (int a = 0; a < 6; ++a) part[21 + a] = J[a] * b;
    part[27] = w;
  }
  // the block's 128 points by a fixed tree: strides 64 and 32 through
  // shared memory, each thread's 28 loads issued before its adds, then 16
  // ... 1 by warp shuffles in warp 0 (the pairs of a shared-memory tree)
#pragma unroll
  for (int i = 0; i < kParts; ++i) red[i][tid] = part[i];
  __syncthreads();
  if (tid < 64) {
    float other[kParts];
#pragma unroll
    for (int i = 0; i < kParts; ++i) other[i] = red[i][tid + 64];
#pragma unroll
    for (int i = 0; i < kParts; ++i) red[i][tid] = part[i] += other[i];
  }
  __syncthreads();
  if (tid < 32) {
    float other[kParts];
#pragma unroll
    for (int i = 0; i < kParts; ++i) other[i] = red[i][tid + 32];
#pragma unroll
    for (int i = 0; i < kParts; ++i) {
      part[i] += other[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part[i] += __shfl_down_sync(0xffffffffu, part[i], o);
    }
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < kParts; ++i) rows[(size_t)blockIdx.x * kParts + i] = part[i];
    }
  }

  // the last block to finish sums the block rows
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Thread c*28 + i sums column i of class c in the order
  // torch.sum(rows, dim=0) takes on the card: row r of the class into
  // accumulator r % 4 (four strided accumulators), then ((a0 + a1) + a2)
  // + a3, each starting at 0 as torch's do. The rows come through shared
  // memory, kThreads at a time, all loads of a chunk in flight together.
  float* stage = &red[0][0];  // kThreads rows of kParts
  const int cls = tid / kParts, col = tid - cls * kParts;
  const int first = cls == 0 ? 0 : corner.blocks;
  const int end = cls == 0 ? corner.blocks : corner.blocks + surf.blocks;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int base = 0; base < (int)gridDim.x; base += kThreads) {
    const int m = min(kThreads, (int)gridDim.x - base);
    __syncthreads();  // the tree, or the previous chunk's sums, are done
    for (int e = tid; e < m * kParts; e += kThreads)
      stage[e] = __ldcg(rows + (size_t)base * kParts + e);
    __syncthreads();
    if (cls < 2) {
      for (int r = max(first, base); r < min(end, base + m); ++r) {
        const float v = stage[(r - base) * kParts + col];
        switch ((r - first) & 3) {
          case 0: a0 += v; break;
          case 1: a1 += v; break;
          case 2: a2 += v; break;
          default: a3 += v;
        }
      }
    }
  }
  if (cls < 2) cls_tot[cls][col] = ((a0 + a1) + a2) + a3;
  __syncthreads();
  if (tid < kParts) {
    const float tc = cls_tot[0][tid], ts = cls_tot[1][tid];
    tot[tid] = corner.blocks == 0 ? ts : surf.blocks == 0 ? tc : tc + ts;
    if (tid == kParts - 1)  // counts: each class's to int32, then added
      reinterpret_cast<int*>(out)[42] = (int)tc + (int)ts;
  }
  __syncthreads();
  if (tid < 36) {
    const int a = tid / 6, c = tid % 6;
    const int lo = min(a, c), hi = max(a, c);
    out[tid] = tot[lo * (11 - lo) / 2 + hi];  // row-major upper triangle
  } else if (tid < 42) {
    out[tid] = tot[21 + tid - 36];
  }
  if (tid == 0) *ticket = 0;
}

int launch(const void* c_pts, const void* c_nbr, int Nc, const void* s_pts,
           const void* s_nbr, int Ns, int S, const void* par, void* rows, void* ticket,
           void* out, void* stream) {
  const ClassBlocks corner{(const float*)c_pts, (const float*)c_nbr, Nc,
                           (Nc + kThreads - 1) / kThreads};
  const ClassBlocks surf{(const float*)s_pts, (const float*)s_nbr, Ns,
                         (Ns + kThreads - 1) / kThreads};
  if (Nc < 0 || Ns < 0 || S < 1 || S > 65535 || corner.blocks + surf.blocks == 0)
    return (int)cudaErrorInvalidValue;
  gn_partials_pair_kernel<<<dim3(corner.blocks + surf.blocks, S), kThreads, 0,
                            (cudaStream_t)stream>>>(
      corner, surf, (const float*)par, (float*)rows, (int*)ticket, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lvt_gn_partials_pair(const void* c_pts, const void* c_nbr, int Nc,
                                    const void* s_pts, const void* s_nbr, int Ns,
                                    const void* par, void* rows, void* ticket,
                                    void* out, void* stream) {
  return launch(c_pts, c_nbr, Nc, s_pts, s_nbr, Ns, 1, par, rows, ticket, out, stream);
}

// S sequences: c_pts (S, 8, Nc), c_nbr (S, 24, Nc), s_* likewise with Ns,
// par (S, 39), rows (S, blocks, 28), ticket (S,) int32, out (S, 43)
extern "C" int lvt_gn_partials_pair_batched(const void* c_pts, const void* c_nbr, int Nc,
                                            const void* s_pts, const void* s_nbr, int Ns,
                                            int S, const void* par, void* rows, void* ticket,
                                            void* out, void* stream) {
  return launch(c_pts, c_nbr, Nc, s_pts, s_nbr, Ns, S, par, rows, ticket, out, stream);
}
