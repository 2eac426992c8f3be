// Power-law momentum coefficients of one staggered face, from global
// indices (ops/powerlaw.py, face by face).  Shared by K1 (asmcheby.cuh), K6
// (step.cu) and K8 (assembly.cu).  `Prm` is the kernel's parameter struct
// (or a per-case view of it); it must hold the BC-applied fields u
// (nx+1, ny), v (nx, ny+1), p (nx, ny), the sizes nx, ny, and the scalars
// cFu = 0.5 rho dy, cFv = 0.5 rho dx, De = mu dy / dx, Dn = mu dx / dy,
// dx, dy and alpha.
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

// The assembly of K1 and K8 with shared fluxes.  The west flux of face
// (i + 1, j) and the east flux of face (i, j) are the same sum of the same
// two velocities (added in either order, which IEEE addition does not
// see), and so are the south flux of (i, j + 1) and the north flux of
// (i, j); their power-law terms D A(F) are then the same too.  So each face
// computes its east and north terms once (face_flux, or flux_east /
// flux_north alone), and u_coef_flux / v_coef_flux take the west and south
// ones from the neighbours: the coefficients are u_coef's and v_coef's bit
// for bit, with half the divisions and loads.
struct FaceFlux {
  float Fe, DAe, Fn, DAn;  // the east and north flux and D A(F) (0 where not defined)
};

struct Flux {
  float F, DA;  // a side's flux and D A(F) (0 where not defined)
};

// The east terms of u face (i, j) (IS_U) or v face (i, j), as u_coef /
// v_coef compute them for the face or for its east neighbour's west side.
template <bool IS_U, class Prm>
__device__ __forceinline__ Flux flux_east(const Prm& P, int i, int j) {
  Flux f = {0.f, 0.f};
  if (IS_U ? i < P.nx : (i < P.nx - 1 && j >= 1 && j <= P.ny - 1)) {
    if constexpr (IS_U) f.F = P.cFu * (U(P, i + 1, j) + U(P, i, j));
    else f.F = P.cFu * (U(P, i + 1, j) + U(P, i + 1, j - 1));
    f.DA = P.De * power_law_A(f.F, P.De);
  }
  return f;
}

// The north terms of the face, as u_coef / v_coef compute them for the
// face or for its north neighbour's south side.
template <bool IS_U, class Prm>
__device__ __forceinline__ Flux flux_north(const Prm& P, int i, int j) {
  Flux f = {0.f, 0.f};
  if (IS_U ? (i >= 1 && i <= P.nx - 1 && j < P.ny - 1) : j <= P.ny - 1) {
    if constexpr (IS_U) f.F = P.cFv * (V(P, i, j + 1) + V(P, i - 1, j + 1));
    else f.F = P.cFv * (V(P, i, j) + V(P, i, j + 1));
    f.DA = P.Dn * power_law_A(f.F, P.Dn);
  }
  return f;
}

// Both: the face's east and north terms.
template <bool IS_U, class Prm>
__device__ __forceinline__ FaceFlux face_flux(const Prm& P, int i, int j) {
  const Flux e = flux_east<IS_U>(P, i, j), n = flux_north<IS_U>(P, i, j);
  return {e.F, e.DA, n.F, n.DA};
}

// u_coef from the face's own terms `o` and the west neighbour's east
// terms (Fw, DAw) and the south neighbour's north terms (Fs, DAs).
template <class Prm>
__device__ __forceinline__ Coef u_coef_flux(const Prm& P, int i, int j, FaceFlux o, float Fw,
                                            float DAw, float Fs, float DAs) {
  Coef c = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int nx = P.nx, ny = P.ny;
  if (i <= 0 || i >= nx) return c;
  const float Fe = o.Fe;
  const float Fn = (j == ny - 1) ? 0.f : o.Fn;
  if (j == 0) Fs = 0.f;
  float ae = o.DAe + fmaxf(-Fe, 0.f);
  float aw = DAw + fmaxf(Fw, 0.f);
  float an = (j == ny - 1) ? 0.f : o.DAn + fmaxf(-Fn, 0.f);
  float as = (j == 0) ? 0.f : DAs + fmaxf(Fs, 0.f);
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

// v_coef from the face's own terms and its west and south neighbours'.
template <class Prm>
__device__ __forceinline__ Coef v_coef_flux(const Prm& P, int i, int j, FaceFlux o, float Fw,
                                            float DAw, float Fs, float DAs) {
  Coef c = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int nx = P.nx, ny = P.ny;
  if (j <= 0 || j >= ny) return c;
  const float Fe = (i == nx - 1) ? 0.f : o.Fe;
  if (i == 0) Fw = 0.f;
  const float Fn = o.Fn;
  float ae = (i == nx - 1) ? 0.f : o.DAe + fmaxf(-Fe, 0.f);
  float aw = (i == 0) ? 0.f : DAw + fmaxf(Fw, 0.f);
  float an = o.DAn + fmaxf(-Fn, 0.f);
  float as = DAs + fmaxf(Fs, 0.f);
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

// ops/poisson.poisson_coefficients of cell (i, j) from the d of its four
// faces (d_u of faces (i, j) and (i + 1, j), d_v of faces (i, j) and
// (i, j + 1), each as ops/powerlaw.d_coefficient gives it); variant 0
// consistent (its face masks applied here), 1 symmetric, 2 reference.
// Writes a_e, a_w, a_n, a_s, diag at index k of pc[0..4].  Needs P.rho
// besides the fields above.  K1 and K8 keep d of their faces and call it,
// so no coefficient set is rebuilt for the operator.
template <class Prm>
__device__ __forceinline__ void pressure_cell_from_d(const Prm& P, int variant, int i, int j,
                                                     float du_w, float du_e, float dv_s,
                                                     float dv_n, float* const* pc, int64_t k) {
  const int nx = P.nx, ny = P.ny;
  const bool consistent = variant == 0;
  const bool j_out = consistent && (j < 1 || j > ny - 2);  // the u faces' mask
  const bool i_out = consistent && (i < 1 || i > nx - 2);  // the v faces' mask
  float ae = (i < nx - 1) ? P.rho * (j_out ? 0.f : du_e) * P.dy : 0.f;
  float aw = (i > 0) ? P.rho * (j_out ? 0.f : du_w) * P.dy : 0.f;
  float an = (j < ny - 1) ? P.rho * (i_out ? 0.f : dv_n) * P.dx : 0.f;
  float as = (j > 0) ? P.rho * (i_out ? 0.f : dv_s) * P.dx : 0.f;
  float dg = 0.f;
  if (variant == 2) {  // 'reference' boundary fold
    if (i == 0) dg = dg + ae;
    if (i == nx - 1) dg = dg + aw;
    if (j == 0) dg = dg + an;
    if (j == ny - 1) dg = dg + as;
    if (i == 0) ae = 0.f;
    if (i == nx - 1) aw = 0.f;
    if (j == 0) an = 0.f;
    if (j == ny - 1) as = 0.f;
  }
  pc[0][k] = ae;
  pc[1][k] = aw;
  pc[2][k] = an;
  pc[3][k] = as;
  pc[4][k] = dg + ae + aw + an + as;
}
