// Device code of the multigrid kernels: the V-cycle (K3), the whole solve
// (K5) and the vertex Galerkin RAP (K4), over a hierarchy of levels held in
// device memory.  The whole-step kernel K6 (step.cu) calls the same
// functions.
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

// One colour pass of Gauss-Seidel (same-colour cells are never neighbours,
// so the in-place update is a true GS update).
__device__ inline void nf_smooth_pass(const NfLevel& L, int color, float omega, int64_t start,
                               int64_t stride) {
  const int64_t n = (int64_t)L.ni * L.nj;
  for (int64_t g = start; g < n; g += stride) {
    const int i = (int)(g / L.nj), j = (int)(g % L.nj);
    const int c = L.five ? ((i + j) & 1) : (((i & 1) << 1) | (j & 1));
    if (c != color) continue;
    const float pnew = (L.rhs[g] - nf_offdiag(L, i, j, g)) * nf_inv_diag(L.st[0][g]);
    L.x[g] = L.x[g] + omega * (pnew - L.x[g]);
  }
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

__device__ inline void nf_smooth(NfCoop& Cp, const NfLevel& F, int sweeps, float omega) {
  const int64_t cells = (int64_t)F.ni * F.nj;
  const int colors = F.five ? 2 : 4;
  for (int s = 0; s < sweeps; ++s)
    for (int c = 0; c < colors; ++c) NF_PASS(Cp, cells, nf_smooth_pass(F, c, omega, start, stride));
}

// One V-cycle from level 0: level 0's iterate x is updated in place.
__device__ inline void nf_vcycle(NfCoop& Cp, const NfMG& M) {
  const int L = M.L;
  for (int l = 0; l < L - 1; ++l) {
    const NfLevel& F = M.lv[l];
    const NfLevel& C = M.lv[l + 1];
    nf_smooth(Cp, F, M.pre, M.omega);
    NF_PASS(Cp, (int64_t)C.ni * C.nj, nf_restrict_pass(F, C, start, stride));
  }
  nf_smooth(Cp, M.lv[L - 1], M.coarsest, M.omega);
  for (int l = L - 2; l >= 0; --l) {
    const NfLevel& F = M.lv[l];
    const NfLevel& C = M.lv[l + 1];
    NF_PASS(Cp, (int64_t)F.ni * F.nj, nf_prolong_pass(F, C, start, stride));
    nf_smooth(Cp, F, M.post, M.omega);
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

// The whole solve (K5; pallas_mg.mg_solve_value): from level 0's iterate,
// `check_every` V-cycles per check until cycles >= max_cycles or
// ||b - A p|| / ||b|| < tol (compensated norms), then the mean removed when
// `mean_normalize`, and the final residual into r.  *cycles and *rel are
// written by one thread; every block returns the same values.
__device__ inline void nf_mg_solve(NfCoop& Cp, const NfMG& M, float* r, int max_cycles, int check_every,
                            float tol, bool mean_normalize, int* cycles_out, float* rel_out) {
  const NfLevel& F = M.lv[0];
  const int64_t n = (int64_t)F.ni * F.nj;
  float bn[1];
  {
    nf_settle(Cp);
    NfDS acc[1] = {nf_ds_zero()};
    for (int64_t g = Cp.gtid; g < n; g += Cp.gstride) nf_ds_fma(acc[0], F.rhs[g], F.rhs[g]);
    nf_grid_reduce<1>(Cp, acc, bn);
  }
  const float bnorm = sqrtf(bn[0]);
  const float safe_b = bnorm > 0.f ? bnorm : 1.f;
  int k = 0;
  float rel = __int_as_float(0x7f800000);  // +inf
  while (k < max_cycles && rel >= tol) {
    for (int c = 0; c < check_every; ++c) nf_vcycle(Cp, M);
    nf_settle(Cp);
    NfDS acc[1] = {nf_residual_pass(F, nullptr, Cp.gtid, Cp.gstride)};
    float r2[1];
    nf_grid_reduce<1>(Cp, acc, r2);
    rel = sqrtf(r2[0]) / safe_b;
    k += check_every;
  }
  nf_settle(Cp);
  if (mean_normalize) {
    NfDS acc[1] = {nf_ds_zero()};
    for (int64_t g = Cp.gtid; g < n; g += Cp.gstride) nf_ds_addf(acc[0], F.x[g]);
    float sum[1];
    nf_grid_reduce<1>(Cp, acc, sum);
    const float mean = sum[0] / (float)n;
    for (int64_t g = Cp.gtid; g < n; g += Cp.gstride) F.x[g] = F.x[g] - mean;
    Cp.grid.sync();
  }
  nf_residual_pass(F, r, Cp.gtid, Cp.gstride);
  Cp.grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (cycles_out) *cycles_out = k;
    if (rel_out) *rel_out = rel;
  }
}

// ---------------------------------------------------------------------------
// Vertex Galerkin RAP (K4): A_c = R A P entry by entry.
//
// With the per-axis full weighting w = (1/4, 1/2, 1/4) on fine rows 2I..2I+2
// and the bilinear prolongation weights p(i, I') of nf_vertex_taps, the
// coarse entry of (I, J) at neighbour offset (di, dj) is
//   sum_{a, b in 0..2} w_a w_b sum_{taps k} S_k(2I+a, 2J+b)
//       * p(2I+a+ka, I+di) * p(2J+b+kb, J+dj),
// fine neighbours outside the grid contributing zero (the zero-filled
// shifts of ops/stencil9.apply9), coarse neighbours outside the grid giving
// a zero entry.  81 fine-point/tap pairs per entry, in f32; no comb, no
// matrix product (the TPU's comb + MXU form needed Precision.HIGHEST).

__device__ __forceinline__ float nf_pweight(int i, int nf, int I, int nc) {
  if (i < 0 || i >= nf || I < 0 || I >= nc) return 0.f;
  int a, b;
  float w0, w1;
  nf_vertex_taps(i, nc, a, b, w0, w1);
  if (w1 == 0.f) return I == a ? 1.f : 0.f;
  return (I == a || I == b) ? 0.5f : 0.f;
}

__device__ inline void nf_rap_pass(const NfLevel& F, const NfLevel& C, int64_t start, int64_t stride) {
  constexpr int KI[9] = {0, 1, -1, 0, 0, 1, -1, 1, -1};
  constexpr int KJ[9] = {0, 0, 0, 1, -1, 1, 1, -1, -1};
  constexpr float W[3] = {0.25f, 0.5f, 0.25f};
  const int taps = F.five ? 5 : 9;
  const int64_t n = (int64_t)C.ni * C.nj;
  for (int64_t g = start; g < n; g += stride) {
    const int I = (int)(g / C.nj), J = (int)(g % C.nj);
#pragma unroll 1
    for (int o = 0; o < 9; ++o) {
      const int Ic = I + KI[o], Jc = J + KJ[o];
      float val = 0.f;
      if (Ic >= 0 && Ic < C.ni && Jc >= 0 && Jc < C.nj) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int fi = 2 * I + a;
          float row = 0.f;
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const int fj = 2 * J + b;
            const int64_t fg = (int64_t)fi * F.nj + fj;
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 9; ++k) {
              if (k >= taps) break;
              const float pi = nf_pweight(fi + KI[k], F.ni, Ic, C.ni);
              const float pj = nf_pweight(fj + KJ[k], F.nj, Jc, C.nj);
              if (pi != 0.f && pj != 0.f) s = s + F.st[k][fg] * (pi * pj);
            }
            row = row + W[b] * s;
          }
          val = val + W[a] * row;
        }
      }
      const_cast<float*>(C.st[o])[g] = val;
    }
  }
}

// Every coarse stencil of the vertex hierarchy lv[0..L-1] (lv[0] holds the
// fine stencil; lv[1..]'s st[] are the outputs, all nine arrays).
__device__ inline void nf_galerkin_rap(NfCoop& Cp, const NfLevel* lv, int L) {
  for (int l = 1; l < L; ++l)
    NF_PASS(Cp, (int64_t)lv[l].ni * lv[l].nj, nf_rap_pass(lv[l - 1], lv[l], start, stride));
}
