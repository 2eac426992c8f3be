// Power-law momentum coefficients of one staggered face, from global
// indices (ops/powerlaw.py, face by face).  Shared by K1 (asmcheby.cu) and
// K6 (step.cu).  `Prm` is the kernel's parameter struct; it must hold the
// BC-applied fields u (nx+1, ny), v (nx, ny+1), p (nx, ny), the sizes nx,
// ny, and the scalars cFu = 0.5 rho dy, cFv = 0.5 rho dx, De = mu dy / dx,
// Dn = mu dx / dy, dx, dy and alpha.
#pragma once

#include "common.cuh"

struct Coef {
  float ae, aw, an, as, ap, src;
};

template <class Prm>
__device__ __forceinline__ float U(const Prm& P, int i, int j) {
  return P.u[(int64_t)i * P.ny + j];
}
template <class Prm>
__device__ __forceinline__ float V(const Prm& P, int i, int j) {
  return P.v[(int64_t)i * (P.ny + 1) + j];
}
template <class Prm>
__device__ __forceinline__ float Pr(const Prm& P, int i, int j) {
  return P.p[(int64_t)i * P.ny + j];
}

// ops/powerlaw.power_law_A for a scalar diffusion conductance D
__device__ __forceinline__ float power_law_A(float F, float D) {
  if (!(fabsf(D) > 1e-10f)) return 0.f;
  const float base = fmaxf(1.f - 0.1f * fabsf(F / D), 0.f);
  const float b2 = base * base;
  return b2 * b2 * base;
}

// Unrelaxed u-momentum coefficients of face (i, j); rows 0 and nx are zero.
template <class Prm>
__device__ Coef u_coef(const Prm& P, int i, int j) {
  Coef c = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int nx = P.nx, ny = P.ny;
  if (i <= 0 || i >= nx) return c;
  const float uc = U(P, i, j);
  const float Fe = P.cFu * (U(P, i + 1, j) + uc);
  const float Fw = P.cFu * (U(P, i - 1, j) + uc);
  const float Fn = (j == ny - 1) ? 0.f : P.cFv * (V(P, i, j + 1) + V(P, i - 1, j + 1));
  const float Fs = (j == 0) ? 0.f : P.cFv * (V(P, i, j) + V(P, i - 1, j));
  float ae = P.De * power_law_A(Fe, P.De) + fmaxf(-Fe, 0.f);
  float aw = P.De * power_law_A(Fw, P.De) + fmaxf(Fw, 0.f);
  float an = (j == ny - 1) ? 0.f : P.Dn * power_law_A(Fn, P.Dn) + fmaxf(-Fn, 0.f);
  float as = (j == 0) ? 0.f : P.Dn * power_law_A(Fs, P.Dn) + fmaxf(Fs, 0.f);
  c.ap = ae + aw + an + as + (Fe - Fw) + (Fn - Fs);
  float src = (Pr(P, i - 1, j) - Pr(P, i, j)) * P.dy;
  // Practice B, in the order of ops/powerlaw.py
  if (i == 1) { src = src + aw * U(P, 0, j); aw = 0.f; }
  if (i == nx - 1) { src = src + ae * U(P, nx, j); ae = 0.f; }
  if (j == 1) { src = src + as * U(P, i, 0); as = 0.f; }
  if (j == ny - 2) { src = src + an * U(P, i, ny - 1); an = 0.f; }
  c.ae = ae; c.aw = aw; c.an = an; c.as = as; c.src = src;
  return c;
}

// Unrelaxed v-momentum coefficients of face (i, j); columns 0 and ny are zero.
template <class Prm>
__device__ Coef v_coef(const Prm& P, int i, int j) {
  Coef c = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int nx = P.nx, ny = P.ny;
  if (j <= 0 || j >= ny) return c;
  const float Fe = (i == nx - 1) ? 0.f : P.cFu * (U(P, i + 1, j) + U(P, i + 1, j - 1));
  const float Fw = (i == 0) ? 0.f : P.cFu * (U(P, i, j) + U(P, i, j - 1));
  const float Fn = P.cFv * (V(P, i, j) + V(P, i, j + 1));
  const float Fs = P.cFv * (V(P, i, j - 1) + V(P, i, j));
  float ae = (i == nx - 1) ? 0.f : P.De * power_law_A(Fe, P.De) + fmaxf(-Fe, 0.f);
  float aw = (i == 0) ? 0.f : P.De * power_law_A(Fw, P.De) + fmaxf(Fw, 0.f);
  float an = P.Dn * power_law_A(Fn, P.Dn) + fmaxf(-Fn, 0.f);
  float as = P.Dn * power_law_A(Fs, P.Dn) + fmaxf(Fs, 0.f);
  c.ap = ae + aw + an + as + (Fe - Fw) + (Fn - Fs);
  float src = (Pr(P, i, j - 1) - Pr(P, i, j)) * P.dx;
  if (j == 1) { src = src + as * V(P, i, 0); as = 0.f; }
  if (j == ny - 1) { src = src + an * V(P, i, ny); an = 0.f; }
  if (i == 1) { src = src + aw * V(P, 0, j); aw = 0.f; }
  if (i == nx - 2) { src = src + ae * V(P, nx - 1, j); ae = 0.f; }
  c.ae = ae; c.aw = aw; c.an = an; c.as = as; c.src = src;
  return c;
}

// ops/powerlaw.relax_coefficients' a_p (1e-12 floor, / alpha)
template <class Prm>
__device__ __forceinline__ float relax_ap(const Prm& P, float ap) {
  return (fabsf(ap) > 1e-12f ? ap : 1e-12f) / P.alpha;
}

// ops/powerlaw.d_coefficient, with the consistent-variant face masks of
// ops/poisson.poisson_coefficients folded in when `consistent`
template <class Prm>
__device__ float d_u_face(const Prm& P, int i, int j, bool consistent) {
  if (i < 1 || i > P.nx - 1) return 0.f;
  if (consistent && (j < 1 || j > P.ny - 2)) return 0.f;
  const float ap = relax_ap(P, u_coef(P, i, j).ap);
  return fabsf(ap) > 1e-12f ? P.dy / ap : 0.f;
}

template <class Prm>
__device__ float d_v_face(const Prm& P, int i, int j, bool consistent) {
  if (j < 1 || j > P.ny - 1) return 0.f;
  if (consistent && (i < 1 || i > P.nx - 2)) return 0.f;
  const float ap = relax_ap(P, v_coef(P, i, j).ap);
  return fabsf(ap) > 1e-12f ? P.dx / ap : 0.f;
}
