// K3: one whole multigrid V-cycle over a level hierarchy, in one launch.
//
// Replaces naviflow_tpu/ops/pallas_mg.py:fused_vcycle (_mk_kernel with
// whole_solve=False, vcycle_value).  Per level, finest to coarsest:
// Gauss-Seidel pre-smoothing (red-black on 5-point levels, four colours on
// 9-point Galerkin levels), the residual, and its 2x2 cell-centred
// restriction into the next level's right-hand side; `coarsest` sweeps on
// the last level; then, coarsest to finest, the bilinear prolongation of the
// correction and post-smoothing.  Transfers use their direct 2-tap / 4-tap
// fp32 weights (the cell-centred factors of pallas_mg._transfer_matrices),
// not matrix products.
//
// Bound on the H100: a 256^2 -> 4^2 tail holds ~5 MB, so it lives in L2
// and the cycle is bound by the ~200 dependent passes (one per colour,
// residual and transfer) and the grid-wide barriers between them.  Design:
// a cooperative launch (cudaLaunchCooperativeKernel) of as many blocks as
// fit at once on the SMs; every pass loops over its level's cells with a
// grid stride and ends in cooperative_groups' grid.sync().  Levels of at
// most SMALL_CELLS cells run in block 0 alone between __syncthreads(), and
// the other blocks wait at the next grid barrier, so the coarsest sweeps cost
// no grid barriers at all.  Level 0's iterate is the output buffer; the
// coarser iterates and right-hand sides are scratch from the wrapper.
// Every neighbour access is bounds-checked: nothing reads outside an
// allocation.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 16;
constexpr int SMALL_CELLS = 1024;

struct Level {
  const float* st[9];  // c, e, w, n, s, ne, nw, se, sw (corners null on 5-point)
  float* x;
  const float* rhs;
  int ni, nj, five;
};

struct Params {
  Level lv[MAX_LEVELS];
  int L, pre, post, coarsest;
  float omega;
};

__device__ __forceinline__ float at(const float* x, const Level& L, int i, int j) {
  return (i >= 0 && i < L.ni && j >= 0 && j < L.nj) ? x[(int64_t)i * L.nj + j] : 0.f;
}

// Off-diagonal part of (A x)[i, j].
__device__ __forceinline__ float offdiag(const Level& L, int i, int j, int64_t g) {
  const float* x = L.x;
  float off = L.st[1][g] * at(x, L, i + 1, j) + L.st[2][g] * at(x, L, i - 1, j) +
              L.st[3][g] * at(x, L, i, j + 1) + L.st[4][g] * at(x, L, i, j - 1);
  if (!L.five)
    off = off + L.st[5][g] * at(x, L, i + 1, j + 1) + L.st[6][g] * at(x, L, i - 1, j + 1) +
          L.st[7][g] * at(x, L, i + 1, j - 1) + L.st[8][g] * at(x, L, i - 1, j - 1);
  return off;
}

__device__ __forceinline__ float residual(const Level& L, int i, int j) {
  const int64_t g = (int64_t)i * L.nj + j;
  const float* x = L.x;
  float ax = L.st[0][g] * x[g] + L.st[1][g] * at(x, L, i + 1, j) +
             L.st[2][g] * at(x, L, i - 1, j) + L.st[3][g] * at(x, L, i, j + 1) +
             L.st[4][g] * at(x, L, i, j - 1);
  if (!L.five)
    ax = ax + L.st[5][g] * at(x, L, i + 1, j + 1) + L.st[6][g] * at(x, L, i - 1, j + 1) +
         L.st[7][g] * at(x, L, i + 1, j - 1) + L.st[8][g] * at(x, L, i - 1, j - 1);
  return L.rhs[g] - ax;
}

// One colour pass of Gauss-Seidel (same-colour cells are never neighbours,
// so the in-place update is a true GS update).
__device__ void smooth_pass(const Level& L, int color, float omega, int64_t start,
                            int64_t stride) {
  const int64_t n = (int64_t)L.ni * L.nj;
  for (int64_t g = start; g < n; g += stride) {
    const int i = (int)(g / L.nj), j = (int)(g % L.nj);
    const int c = L.five ? ((i + j) & 1) : (((i & 1) << 1) | (j & 1));
    if (c != color) continue;
    const float pnew = (L.rhs[g] - offdiag(L, i, j, g)) * nf_inv_diag(L.st[0][g]);
    L.x[g] = L.x[g] + omega * (pnew - L.x[g]);
  }
}

// Coarse right-hand side = 2x2-restricted fine residual; coarse iterate = 0.
__device__ void restrict_pass(const Level& F, const Level& C, int64_t start, int64_t stride) {
  const int64_t n = (int64_t)C.ni * C.nj;
  for (int64_t g = start; g < n; g += stride) {
    const int I = (int)(g / C.nj), J = (int)(g % C.nj);
    const int i = 2 * I, j = 2 * J;
    const float r00 = residual(F, i, j), r10 = residual(F, i + 1, j);
    const float r01 = residual(F, i, j + 1), r11 = residual(F, i + 1, j + 1);
    const_cast<float*>(C.rhs)[g] = 0.5f * (0.5f * (r00 + r10) + 0.5f * (r01 + r11));
    C.x[g] = 0.f;
  }
}

__device__ void prolong_pass(const Level& F, const Level& C, int64_t start, int64_t stride) {
  const int64_t n = (int64_t)F.ni * F.nj;
  for (int64_t g = start; g < n; g += stride) {
    const int i = (int)(g / F.nj), j = (int)(g % F.nj);
    F.x[g] = F.x[g] + nf_prolong_cc(C.x, C.ni, C.nj, i, j);
  }
}

__global__ void __launch_bounds__(THREADS) vcycle_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  const int64_t gtid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * blockDim.x;
  bool pending = false;  // block 0 wrote without a grid barrier since

  // Run one pass over `cells` cells: block 0 alone for small levels,
  // the whole grid otherwise.  `cells` is uniform over the grid.
#define NF_PASS(cells, CALL)                                 \
  do {                                                       \
    if ((cells) <= SMALL_CELLS) {                            \
      if (blockIdx.x == 0) {                                 \
        const int64_t start = threadIdx.x;                   \
        const int64_t stride = blockDim.x;                   \
        CALL;                                                \
        __syncthreads();                                     \
      }                                                      \
      pending = true;                                        \
    } else {                                                 \
      if (pending) {                                         \
        grid.sync();                                         \
        pending = false;                                     \
      }                                                      \
      const int64_t start = gtid;                            \
      const int64_t stride = gstride;                        \
      CALL;                                                  \
      grid.sync();                                           \
    }                                                        \
  } while (0)

  const int L = P.L;
  for (int l = 0; l < L - 1; ++l) {
    const Level& F = P.lv[l];
    const Level& C = P.lv[l + 1];
    const int64_t cells = (int64_t)F.ni * F.nj;
    const int colors = F.five ? 2 : 4;
    for (int s = 0; s < P.pre; ++s)
      for (int c = 0; c < colors; ++c) NF_PASS(cells, smooth_pass(F, c, P.omega, start, stride));
    NF_PASS((int64_t)C.ni * C.nj, restrict_pass(F, C, start, stride));
  }
  {
    const Level& Cst = P.lv[L - 1];
    const int64_t cells = (int64_t)Cst.ni * Cst.nj;
    const int colors = Cst.five ? 2 : 4;
    for (int s = 0; s < P.coarsest; ++s)
      for (int c = 0; c < colors; ++c) NF_PASS(cells, smooth_pass(Cst, c, P.omega, start, stride));
  }
  for (int l = L - 2; l >= 0; --l) {
    const Level& F = P.lv[l];
    const Level& C = P.lv[l + 1];
    const int64_t cells = (int64_t)F.ni * F.nj;
    const int colors = F.five ? 2 : 4;
    NF_PASS(cells, prolong_pass(F, C, start, stride));
    for (int s = 0; s < P.post; ++s)
      for (int c = 0; c < colors; ++c) NF_PASS(cells, smooth_pass(F, c, P.omega, start, stride));
  }
#undef NF_PASS
}

}  // namespace

// ptrs: per level, 9 stencil pointers (0 for absent corners), x, rhs
//       (level 0: x = output already holding p, rhs = b)
// ip:   L, pre, post, coarsest, then per level ni, nj, five
// fp:   omega
NF_EXPORT int nf_fused_vcycle(const long long* ptrs, const int* ip, const float* fp,
                              void* stream) {
  Params P = {};
  P.L = ip[0];
  if (P.L < 1 || P.L > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  P.pre = ip[1]; P.post = ip[2]; P.coarsest = ip[3]; P.omega = fp[0];
  for (int l = 0; l < P.L; ++l) {
    Level& lv = P.lv[l];
    for (int k = 0; k < 9; ++k) lv.st[k] = reinterpret_cast<const float*>(ptrs[11 * l + k]);
    lv.x = reinterpret_cast<float*>(ptrs[11 * l + 9]);
    lv.rhs = reinterpret_cast<const float*>(ptrs[11 * l + 10]);
    lv.ni = ip[4 + 3 * l]; lv.nj = ip[5 + 3 * l]; lv.five = ip[6 + 3 * l];
  }
  int device = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vcycle_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as the largest level can use, and no more than fit at once
  int64_t cells0 = (int64_t)P.lv[0].ni * P.lv[0].nj;
  int blocks = (int)((cells0 + THREADS - 1) / THREADS);
  if (blocks > per_sm * n_sm) blocks = per_sm * n_sm;
  if (blocks < 1) blocks = 1;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((void*)vcycle_kernel, dim3(blocks), dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
