// Device code of the multigrid kernels over a hierarchy of levels held in
// device memory: the cell updates, residuals and transfers that K3's and
// K5's cluster cycle (vcycle.cuh) and K6's (cluster.cuh) are built from.
// (The vertex Galerkin RAP of K4 and K6 is cluster.cuh's.)
//
// Per level, finest to coarsest: Gauss-Seidel pre-smoothing (red-black on
// 5-point levels, four colours on 9-point Galerkin levels), the residual,
// and its restriction into the next level's right-hand side; `coarsest`
// sweeps on the last level; then, coarsest to finest, the prolongation of
// the correction and post-smoothing.  Transfers use direct taps in f32, not
// matrix products: cell-centred pairs (nf == 2 nc) the 2x2 mean and the
// clamped bilinear of ops/transfer_cc.py; vertex pairs (nf == 2 nc + 1) the
// per-axis (1/4, 1/2, 1/4) full weighting and the bilinear prolongation with
// boundary slabs copied from the first interior line of ops/transfer.py.
// Each 2-D transfer runs along axis 0, then axis 1, as the plain versions.
// Every neighbour access is bounds-checked: nothing reads outside an
// allocation, and out-of-grid neighbours read as zero.
#pragma once

#include "coop.cuh"

constexpr int NF_MAX_LEVELS = 16;

struct NfLevel {
  const float* st[9];  // c, e, w, n, s, ne, nw, se, sw (corners null on 5-point)
  float* x;
  const float* rhs;
  int ni, nj, five;
};

struct NfMG {
  NfLevel lv[NF_MAX_LEVELS];
  int L, pre, post, coarsest;
  float omega;
};

__device__ __forceinline__ float nf_at(const float* x, const NfLevel& L, int i, int j) {
  return (i >= 0 && i < L.ni && j >= 0 && j < L.nj) ? x[(int64_t)i * L.nj + j] : 0.f;
}

// Off-diagonal part of (A x)[i, j].
__device__ __forceinline__ float nf_offdiag(const NfLevel& L, int i, int j, int64_t g) {
  const float* x = L.x;
  float off = L.st[1][g] * nf_at(x, L, i + 1, j) + L.st[2][g] * nf_at(x, L, i - 1, j) +
              L.st[3][g] * nf_at(x, L, i, j + 1) + L.st[4][g] * nf_at(x, L, i, j - 1);
  if (!L.five)
    off = off + L.st[5][g] * nf_at(x, L, i + 1, j + 1) + L.st[6][g] * nf_at(x, L, i - 1, j + 1) +
          L.st[7][g] * nf_at(x, L, i + 1, j - 1) + L.st[8][g] * nf_at(x, L, i - 1, j - 1);
  return off;
}

// (b - A x)[i, j], in ops/stencil9.apply9's order.
__device__ __forceinline__ float nf_residual(const NfLevel& L, int i, int j) {
  const int64_t g = (int64_t)i * L.nj + j;
  const float* x = L.x;
  float ax = L.st[0][g] * x[g] + L.st[1][g] * nf_at(x, L, i + 1, j) +
             L.st[2][g] * nf_at(x, L, i - 1, j) + L.st[3][g] * nf_at(x, L, i, j + 1) +
             L.st[4][g] * nf_at(x, L, i, j - 1);
  if (!L.five)
    ax = ax + L.st[5][g] * nf_at(x, L, i + 1, j + 1) + L.st[6][g] * nf_at(x, L, i - 1, j + 1) +
         L.st[7][g] * nf_at(x, L, i + 1, j - 1) + L.st[8][g] * nf_at(x, L, i - 1, j - 1);
  return L.rhs[g] - ax;
}

// Coarse right-hand side = restricted fine residual; coarse iterate = 0.
__device__ inline void nf_restrict_pass(const NfLevel& F, const NfLevel& C, int64_t start,
                                 int64_t stride) {
  const int64_t n = (int64_t)C.ni * C.nj;
  const bool vertex = F.ni == 2 * C.ni + 1;
  for (int64_t g = start; g < n; g += stride) {
    const int I = (int)(g / C.nj), J = (int)(g % C.nj);
    const int i = 2 * I, j = 2 * J;
    float rc;
    if (vertex) {
      float t[3];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        t[b] = 0.25f * nf_residual(F, i, j + b) + 0.5f * nf_residual(F, i + 1, j + b) +
               0.25f * nf_residual(F, i + 2, j + b);
      rc = 0.25f * t[0] + 0.5f * t[1] + 0.25f * t[2];
    } else {
      const float r00 = nf_residual(F, i, j), r10 = nf_residual(F, i + 1, j);
      const float r01 = nf_residual(F, i, j + 1), r11 = nf_residual(F, i + 1, j + 1);
      rc = 0.5f * (0.5f * (r00 + r10) + 0.5f * (r01 + r11));
    }
    const_cast<float*>(C.rhs)[g] = rc;
    C.x[g] = 0.f;
  }
}

// Vertex bilinear interpolation along one axis: fine index i of a level of
// nc coarse points; returns the coarse indices and weights (w1 == 0: one tap).
__device__ __forceinline__ void nf_vertex_taps(int i, int nc, int& a, int& b, float& w0,
                                               float& w1) {
  if (i == 0) {
    a = b = 0; w0 = 1.f; w1 = 0.f;
  } else if (i >= 2 * nc) {
    a = b = nc - 1; w0 = 1.f; w1 = 0.f;
  } else if (i & 1) {
    a = b = (i - 1) >> 1; w0 = 1.f; w1 = 0.f;
  } else {
    a = (i >> 1) - 1; b = i >> 1; w0 = 0.5f; w1 = 0.5f;
  }
}

__device__ __forceinline__ float nf_prolong_vertex(const float* __restrict__ ec, int nci, int ncj,
                                                   int i, int j) {
  int ia, ib, ja, jb;
  float wi0, wi1, wj0, wj1;
  nf_vertex_taps(i, nci, ia, ib, wi0, wi1);
  nf_vertex_taps(j, ncj, ja, jb, wj0, wj1);
  // axis 0 first, as ops/transfer.prolong_linear
  auto col = [&](int J) {
    const float a = ec[(int64_t)ia * ncj + J];
    return wi1 == 0.f ? a : 0.5f * (a + ec[(int64_t)ib * ncj + J]);
  };
  const float ta = col(ja);
  return wj1 == 0.f ? ta : 0.5f * (ta + col(jb));
}

__device__ inline void nf_prolong_pass(const NfLevel& F, const NfLevel& C, int64_t start,
                                int64_t stride) {
  const int64_t n = (int64_t)F.ni * F.nj;
  const bool vertex = F.ni == 2 * C.ni + 1;
  for (int64_t g = start; g < n; g += stride) {
    const int i = (int)(g / F.nj), j = (int)(g % F.nj);
    const float e = vertex ? nf_prolong_vertex(C.x, C.ni, C.nj, i, j)
                           : nf_prolong_cc(C.x, C.ni, C.nj, i, j);
    F.x[g] = F.x[g] + e;
  }
}

// r = b - A x on level 0 into `r` (if given), and the partial compensated
// sum of r^2 over this thread's cells.
__device__ inline NfDS nf_residual_pass(const NfLevel& F, float* r, int64_t start, int64_t stride) {
  NfDS acc = nf_ds_zero();
  const int64_t n = (int64_t)F.ni * F.nj;
  for (int64_t g = start; g < n; g += stride) {
    const float rr = nf_residual(F, (int)(g / F.nj), (int)(g % F.nj));
    if (r) r[g] = rr;
    nf_ds_fma(acc, rr, rr);
  }
  return acc;
}
