// K6: one whole SIMPLE outer step in one cooperative launch.
//
// Replaces naviflow_tpu/ops/pallas_step.py:fused_outer_step /
// fused_simple_step (the "simple" body of _mk_step_kernel).  In order:
//   velocity BCs -> power-law assembly + relaxation + d of both fields
//   (powerlaw.cuh, shared with K1) -> masked BiCGSTAB of u, then of v, with
//   compensated dots (krylov.cuh, K7's solve) -> BCs on u*, v* ->
//   compensated unrelaxed residuals and their interior norms -> continuity
//   RHS and the 5-point pressure-correction operator -> every Galerkin
//   coarse operator (mg.cuh, K4's RAP; rebuilt every step) -> the whole
//   multigrid solve from zeros, mean-normalised unless the variant is
//   'reference' (mg.cuh, K5's solve) -> pressure and velocity corrections
//   -> the pressure residual's relative norm.
// Every norm and dot is a compensated grid reduction whose value every
// block holds (coop.cuh), so the data-dependent loops stay grid-uniform.
//
// Bound on the H100: at the 63^2 headline every field is ~16 KB and the
// working set ~0.5 MB (~8 MB at 255^2, the largest grid the gate admits),
// all in L2; the step is a chain of dependent passes with up to ~400 grid
// barriers (two Krylov solves of up to 20 iterations x 5, up to 6 V-cycles,
// the RAP levels), so it is bound by grid-barrier latency and by the
// levels small enough to run in block 0 alone, not by bytes or flops.
// Design: coop.cuh's cooperative launch sized from occupancy x SM count,
// grid-stride passes, multigrid levels of <= 1,024 cells in block 0 alone.
// Scratch comes from the wrapper; nothing is allocated here.

#include "krylov.cuh"
#include "mg.cuh"
#include "powerlaw.cuh"

namespace {

struct StepParams {
  // read by powerlaw.cuh: the BC-applied velocities and the pressure
  const float* u;
  const float* v;
  const float* p;
  int nx, ny;
  float cFu, cFv, De, Dn, dx, dy, alpha, one_m_alpha, rho;
  const float* u_in;
  const float* v_in;
  const float* pmax_in;
  float *u_out, *v_out, *p_out, *r_u, *r_v, *r_p, *sc_out;
  int* cyc_out;
  float *ub, *vb;          // the BC-applied u, v (= u, v above)
  float *cu[8], *cv[8];    // a_e, a_w, a_n, a_s, a_p, src unrelaxed; a_p, src relaxed
  float *ustar, *vstar, *d_u, *d_v;
  float* kry;              // 6 Krylov vectors of the larger field
  float* pnew;             // p before the boundary overwrite
  float* fine[5];          // the pressure operator: c, e, w, n, s
  NfMG M;                  // lv[0]: fine operator, x = p', rhs = b
  float* red;
  int mom_maxiter, max_cycles, check_every, pin, variant, overwrite_p;
  float mom_tol, mg_tol, alpha_p;
  int bc_vel[4];           // top, bottom, left, right: a VELOCITY side
  float bc_u[4], bc_v[4];
};

// core/bc.apply_velocity_bcs, one u face: walls zero, then VELOCITY sides in
// the order top, bottom, left, right.
__device__ float bc_u_val(const StepParams& P, int i, int j, float val) {
  const int nx = P.nx, ny = P.ny;
  if (j == 0 || j == ny - 1 || i == 0 || i == nx) val = 0.f;
  if (P.bc_vel[0] && j == ny - 1) val = P.bc_u[0];
  if (P.bc_vel[1] && j == 0) val = P.bc_u[1];
  if (P.bc_vel[2] && i == 0) val = P.bc_u[2];
  if (P.bc_vel[3] && i == nx) val = P.bc_u[3];
  return val;
}

__device__ float bc_v_val(const StepParams& P, int i, int j, float val) {
  const int nx = P.nx, ny = P.ny;
  if (j == 0 || j == ny || i == 0 || i == nx - 1) val = 0.f;
  if (P.bc_vel[0] && j == ny) val = P.bc_v[0];
  if (P.bc_vel[1] && j == 0) val = P.bc_v[1];
  if (P.bc_vel[2] && i == 0) val = P.bc_v[2];
  if (P.bc_vel[3] && i == nx - 1) val = P.bc_v[3];
  return val;
}

// One field's faces: coefficients, relaxation and d.
template <bool IS_U>
__device__ void assemble_field(const StepParams& P, int64_t start, int64_t stride) {
  const int NJ = IS_U ? P.ny : P.ny + 1;
  const int64_t n = IS_U ? (int64_t)(P.nx + 1) * P.ny : (int64_t)P.nx * (P.ny + 1);
  float* const* c = IS_U ? P.cu : P.cv;
  const float* x = IS_U ? P.ub : P.vb;
  float* d = IS_U ? P.d_u : P.d_v;
  for (int64_t g = start; g < n; g += stride) {
    const int i = (int)(g / NJ), j = (int)(g % NJ);
    const Coef k = IS_U ? u_coef(P, i, j) : v_coef(P, i, j);
    const float apr = relax_ap(P, k.ap);
    c[0][g] = k.ae; c[1][g] = k.aw; c[2][g] = k.an; c[3][g] = k.as;
    c[4][g] = k.ap; c[5][g] = k.src;
    c[6][g] = apr;
    c[7][g] = k.src + P.one_m_alpha * apr * x[g];
    const bool row = IS_U ? (i >= 1 && i <= P.nx - 1) : (j >= 1 && j <= P.ny - 1);
    d[g] = (row && fabsf(apr) > 1e-12f) ? (IS_U ? P.dy : P.dx) / apr : 0.f;
  }
}

__device__ __forceinline__ float at2(const float* x, int ni, int nj, int i, int j) {
  return (i >= 0 && i < ni && j >= 0 && j < nj) ? x[(int64_t)i * nj + j] : 0.f;
}

// solvers/momentum._unrelaxed_residual(compensated=True), one face:
// src - A_un x as an error-free sum (ops/compensated.compensated_linear_combination).
__device__ float comp_residual(float* const* c, const float* x, int ni, int nj, int i, int j,
                               int64_t g) {
  const float a[5] = {c[0][g], c[1][g], c[2][g], c[3][g], -c[4][g]};
  const float xs[5] = {at2(x, ni, nj, i + 1, j), at2(x, ni, nj, i - 1, j),
                       at2(x, ni, nj, i, j + 1), at2(x, ni, nj, i, j - 1), x[g]};
  float hi = c[5][g], lo = 0.f;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    float p, e, s, carry;
    nf_two_prod(a[k], xs[k], p, e);
    nf_two_sum(hi, p, s, carry);
    hi = s;
    lo = lo + (carry + e);
  }
  float s, e;
  nf_two_sum(hi, lo, s, e);
  return s;
}

// ops/poisson.poisson_coefficients of cell (i, j) from the d fields, and
// its signed 5-point stencil (ops/stencil9.from_poisson).
__device__ void pressure_cell(const StepParams& P, int i, int j, int64_t g) {
  const int nx = P.nx, ny = P.ny;
  const bool consistent = P.variant == 0;
  auto du = [&](int a, int b) {
    return (consistent && (b == 0 || b == ny - 1)) ? 0.f : P.d_u[(int64_t)a * ny + b];
  };
  auto dv = [&](int a, int b) {
    return (consistent && (a == 0 || a == nx - 1)) ? 0.f : P.d_v[(int64_t)a * (ny + 1) + b];
  };
  float ae = (i < nx - 1) ? P.rho * du(i + 1, j) * P.dy : 0.f;
  float aw = (i > 0) ? P.rho * du(i, j) * P.dy : 0.f;
  float an = (j < ny - 1) ? P.rho * dv(i, j + 1) * P.dx : 0.f;
  float as = (j > 0) ? P.rho * dv(i, j) * P.dx : 0.f;
  float dg = 0.f;
  if (P.variant == 2) {  // 'reference' boundary fold
    if (i == 0) dg = dg + ae;
    if (i == nx - 1) dg = dg + aw;
    if (j == 0) dg = dg + an;
    if (j == ny - 1) dg = dg + as;
    if (i == 0) ae = 0.f;
    if (i == nx - 1) aw = 0.f;
    if (j == 0) an = 0.f;
    if (j == ny - 1) as = 0.f;
  }
  P.fine[0][g] = dg + ae + aw + an + as;
  P.fine[1][g] = -ae;
  P.fine[2][g] = -aw;
  P.fine[3][g] = -an;
  P.fine[4][g] = -as;
}

// core/bc.enforce_pressure_bcs of q at (i, j): the north, south, west,
// east slabs copy their first interior neighbour, each step reading the
// state the previous one left.
__device__ float enforced_p(const float* q, int nx, int ny, int i, int j) {
  auto s1 = [&](int a, int b) { return q[(int64_t)a * ny + (b == ny - 1 ? ny - 2 : b)]; };
  auto s2 = [&](int a, int b) { return b == 0 ? s1(a, 1) : s1(a, b); };
  auto s3 = [&](int a, int b) { return a == 0 ? s2(1, b) : s2(a, b); };
  return i == nx - 1 ? s3(nx - 2, j) : s3(i, j);
}

__global__ void __launch_bounds__(NF_THREADS) step_kernel(StepParams P) {
  NfCoop C = nf_coop(P.red);
  const int nx = P.nx, ny = P.ny;
  const int64_t nu = (int64_t)(nx + 1) * ny, nv = (int64_t)nx * (ny + 1),
                np = (int64_t)nx * ny;

  // 1. velocity BCs
  for (int64_t g = C.gtid; g < nu; g += C.gstride)
    P.ub[g] = bc_u_val(P, (int)(g / ny), (int)(g % ny), P.u_in[g]);
  for (int64_t g = C.gtid; g < nv; g += C.gstride)
    P.vb[g] = bc_v_val(P, (int)(g / (ny + 1)), (int)(g % (ny + 1)), P.v_in[g]);
  C.grid.sync();

  // 2. both fields' coefficients, relaxed systems and d
  assemble_field<true>(P, C.gtid, C.gstride);
  assemble_field<false>(P, C.gtid, C.gstride);
  C.grid.sync();

  // 3. the two momentum solves (K7's device solve)
  const int64_t nk = nu > nv ? nu : nv;
  NfKrylov Ku = {P.cu[0], P.cu[1], P.cu[2], P.cu[3], P.cu[6], P.cu[7], P.ub, P.ustar,
                 P.kry, P.kry + nk, P.kry + 2 * nk, P.kry + 3 * nk, P.kry + 4 * nk, P.kry + 5 * nk,
                 nx + 1, ny, 1, 1, 1, 1};
  nf_bicgstab_solve(C, Ku, P.mom_tol, P.mom_maxiter);
  NfKrylov Kv = Ku;
  Kv.ae = P.cv[0]; Kv.aw = P.cv[1]; Kv.an = P.cv[2]; Kv.as = P.cv[3];
  Kv.ap = P.cv[6]; Kv.src = P.cv[7]; Kv.x0 = P.vb; Kv.x = P.vstar;
  Kv.ni = nx; Kv.nj = ny + 1;
  nf_bicgstab_solve(C, Kv, P.mom_tol, P.mom_maxiter);

  // 4. BCs on u*, v*
  for (int64_t g = C.gtid; g < nu; g += C.gstride)
    P.ustar[g] = bc_u_val(P, (int)(g / ny), (int)(g % ny), P.ustar[g]);
  for (int64_t g = C.gtid; g < nv; g += C.gstride)
    P.vstar[g] = bc_v_val(P, (int)(g / (ny + 1)), (int)(g % (ny + 1)), P.vstar[g]);
  C.grid.sync();

  // 5. residuals and their norms; continuity RHS and the pressure operator
  float norms[2];
  {
    NfDS acc[2] = {nf_ds_zero(), nf_ds_zero()};
    for (int64_t g = C.gtid; g < nu; g += C.gstride) {
      const int i = (int)(g / ny), j = (int)(g % ny);
      const float r = comp_residual(P.cu, P.ustar, nx + 1, ny, i, j, g);
      P.r_u[g] = (i >= 2 && i <= nx - 2 && j >= 1 && j <= ny - 2) ? r : 0.f;
      if (i >= 1 && i <= nx - 1 && j >= 1 && j <= ny - 2) nf_ds_fma(acc[0], r, r);
    }
    for (int64_t g = C.gtid; g < nv; g += C.gstride) {
      const int i = (int)(g / (ny + 1)), j = (int)(g % (ny + 1));
      const float r = comp_residual(P.cv, P.vstar, nx, ny + 1, i, j, g);
      P.r_v[g] = (i >= 1 && i <= nx - 2 && j >= 2 && j <= ny - 2) ? r : 0.f;
      if (i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 1) nf_ds_fma(acc[1], r, r);
    }
    float* b = const_cast<float*>(P.M.lv[0].rhs);
    for (int64_t g = C.gtid; g < np; g += C.gstride) {
      const int i = (int)(g / ny), j = (int)(g % ny);
      const float bu = (P.ustar[(int64_t)i * ny + j] - P.ustar[(int64_t)(i + 1) * ny + j]) * P.dy;
      const float bv =
          (P.vstar[(int64_t)i * (ny + 1) + j] - P.vstar[(int64_t)i * (ny + 1) + j + 1]) * P.dx;
      b[g] = (P.pin && g == 0) ? 0.f : P.rho * (bu + bv);
      pressure_cell(P, i, j, g);
      P.M.lv[0].x[g] = 0.f;
    }
    nf_grid_reduce<2>(C, acc, norms);
  }

  // 6. the Galerkin hierarchy (K4's RAP) and 7. the multigrid solve (K5's)
  nf_galerkin_rap(C, P.M.lv, P.M.L);
  nf_mg_solve(C, P.M, P.r_p, P.max_cycles, P.check_every, P.mg_tol, !P.pin, P.cyc_out, nullptr);

  // 8. corrections and the pressure residual norm
  const float* pp = P.M.lv[0].x;
  float pr[1];
  {
    NfDS acc[1] = {nf_ds_zero()};
    float* pdst = P.overwrite_p ? P.pnew : P.p_out;
    for (int64_t g = C.gtid; g < np; g += C.gstride) {
      const int i = (int)(g / ny), j = (int)(g % ny);
      pdst[g] = P.p[g] + P.alpha_p * pp[g];
      if (i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 2) nf_ds_fma(acc[0], P.r_p[g], P.r_p[g]);
    }
    for (int64_t g = C.gtid; g < nu; g += C.gstride) {
      const int i = (int)(g / ny), j = (int)(g % ny);
      float val = P.ustar[g];
      if (i >= 1 && i <= nx - 1 && j >= 1 && j <= ny - 2)
        val = val + P.d_u[g] * (pp[(int64_t)(i - 1) * ny + j] - pp[(int64_t)i * ny + j]);
      P.u_out[g] = bc_u_val(P, i, j, val);
    }
    for (int64_t g = C.gtid; g < nv; g += C.gstride) {
      const int i = (int)(g / (ny + 1)), j = (int)(g % (ny + 1));
      float val = P.vstar[g];
      if (i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 1)
        val = val + P.d_v[g] * (pp[(int64_t)i * ny + j - 1] - pp[(int64_t)i * ny + j]);
      P.v_out[g] = bc_v_val(P, i, j, val);
    }
    nf_grid_reduce<1>(C, acc, pr);
  }
  if (P.overwrite_p)
    for (int64_t g = C.gtid; g < np; g += C.gstride)
      P.p_out[g] = enforced_p(P.pnew, nx, ny, (int)(g / ny), (int)(g % ny));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const float p_l2 = sqrtf(pr[0]);
    const float p_max = fmaxf(P.pmax_in[0], p_l2);
    P.sc_out[0] = p_max;
    P.sc_out[1] = sqrtf(norms[0]);
    P.sc_out[2] = sqrtf(norms[1]);
    P.sc_out[3] = p_max > 0.f ? p_l2 / p_max : 1.f;
  }
}

}  // namespace

// ptrs: u, v, p, p_max (1 float), then the outputs u', v', p', r_u, r_v,
//       r_p, scalars (4 floats: p_max', u_norm, v_norm, p_rel), cycles
//       (int32), then scratch: ub, vb, 8 u-coefficient arrays, 8
//       v-coefficient arrays, u*, v*, d_u, d_v, Krylov (6 x the larger
//       field), p before the overwrite, the fine operator (c, e, w, n, s),
//       b, p'; then per coarse level 9 stencil arrays, x, rhs; then the
//       reduction scratch
// ip:   nx, ny, L, pre, post, coarsest, max_cycles, check_every,
//       mom_maxiter, pin, variant, overwrite_p, bc_vel[4], then per level
//       ni, nj
// fp:   cFu, cFv, De, Dn, dx, dy, alpha_u, 1 - alpha_u, rho, alpha_p,
//       mom_tol, mg_tol, omega, bc_u[4], bc_v[4]
NF_EXPORT int nf_fused_simple_step(const long long* ptrs, const int* ip, const float* fp,
                                   void* stream) {
  StepParams P = {};
  int k = 0;
  auto next = [&]() { return reinterpret_cast<float*>(ptrs[k++]); };
  P.u_in = next(); P.v_in = next(); P.p = next(); P.pmax_in = next();
  P.u_out = next(); P.v_out = next(); P.p_out = next();
  P.r_u = next(); P.r_v = next(); P.r_p = next(); P.sc_out = next();
  P.cyc_out = reinterpret_cast<int*>(next());
  P.ub = next(); P.vb = next();
  P.u = P.ub; P.v = P.vb;
  for (int a = 0; a < 8; ++a) P.cu[a] = next();
  for (int a = 0; a < 8; ++a) P.cv[a] = next();
  P.ustar = next(); P.vstar = next(); P.d_u = next(); P.d_v = next();
  P.kry = next(); P.pnew = next();
  for (int a = 0; a < 5; ++a) P.fine[a] = next();
  float* b = next();
  float* pprime = next();
  P.nx = ip[0]; P.ny = ip[1];
  const int L = ip[2];
  if (L < 1 || L > NF_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  NfMG& M = P.M;
  M.L = L; M.pre = ip[3]; M.post = ip[4]; M.coarsest = ip[5];
  P.max_cycles = ip[6]; P.check_every = ip[7]; P.mom_maxiter = ip[8];
  P.pin = ip[9]; P.variant = ip[10]; P.overwrite_p = ip[11];
  if (P.check_every < 1) return (int)cudaErrorInvalidValue;
  for (int a = 0; a < 4; ++a) P.bc_vel[a] = ip[12 + a];
  for (int l = 0; l < L; ++l) {
    NfLevel& lv = M.lv[l];
    lv.ni = ip[16 + 2 * l]; lv.nj = ip[17 + 2 * l];
    if (l == 0) {
      for (int a = 0; a < 5; ++a) lv.st[a] = P.fine[a];
      lv.x = pprime; lv.rhs = b; lv.five = 1;
    } else {
      for (int a = 0; a < 9; ++a) lv.st[a] = next();
      lv.x = next(); lv.rhs = next(); lv.five = 0;
    }
  }
  if (M.lv[0].ni != P.nx || M.lv[0].nj != P.ny) return (int)cudaErrorInvalidValue;
  P.red = next();
  P.cFu = fp[0]; P.cFv = fp[1]; P.De = fp[2]; P.Dn = fp[3]; P.dx = fp[4]; P.dy = fp[5];
  P.alpha = fp[6]; P.one_m_alpha = fp[7]; P.rho = fp[8]; P.alpha_p = fp[9];
  P.mom_tol = fp[10]; P.mg_tol = fp[11]; M.omega = fp[12];
  for (int a = 0; a < 4; ++a) { P.bc_u[a] = fp[13 + a]; P.bc_v[a] = fp[17 + a]; }
  const int64_t nu = (int64_t)(P.nx + 1) * P.ny, nv = (int64_t)P.nx * (P.ny + 1);
  return nf_coop_launch(step_kernel, P, nu > nv ? nu : nv, (cudaStream_t)stream);
}
