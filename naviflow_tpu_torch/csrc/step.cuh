// K6: one whole outer step of SIMPLE, SIMPLEC, PISO or SIMPLER in one
// launch of one thread-block cluster, or of B cases in one launch of B
// clusters, one a case (the device code and the launch; the entry points
// are step.cu, step_phases.cu with the phase timers and step_batched.cu
// with the case axis, three sources so that nvcc builds the three sets of
// instantiations in parallel).
//
// Replaces naviflow_tpu/ops/pallas_step.py:fused_outer_step /
// fused_simple_step (the four bodies of _mk_step_kernel).  The parts, each a
// device function below:
//   momentum    power-law assembly + relaxation + d of both fields from the
//               BC-applied velocities (powerlaw.cuh, shared with K1 and K8)
//               -> masked BiCGSTAB of u, then of v, with compensated dots
//               (krylov.cuh, K7's solve), or PISO's Jacobi corrector sweeps
//               -> BCs on u*, v*; for the predictor, the compensated
//               unrelaxed residuals and their interior norms
//   pressure    continuity RHS and the 5-point pressure-correction operator
//               -> every Galerkin coarse operator (cluster.cuh's RAP, entry
//               by entry K4's sums; rebuilt for every solve) -> the whole
//               multigrid solve from zeros, mean-normalised unless the
//               variant is 'reference' (cluster.cuh's nf_cl_mg_solve)
//   corrections p = p_base + a p' (and the boundary overwrite), then the
//               velocity correction and BCs
// and the bodies (pallas_step.py:216-310):
//   SIMPLE      momentum, pressure, corrections, p_rel of the residual
//   SIMPLEC     momentum with d / alpha_u, pressure, optional 0.6/0.1 p'
//               smoothing, corrections with the carried alpha_p, the
//               max-abs field changes and the x0.95 alpha_p backoff
//   PISO        momentum, then n_corrections x (pressure, corrections, and
//               between corrections the unrelaxed momentum re-solve)
//   SIMPLER     momentum, pressure -> p += p_bar, momentum at the new p,
//               pressure -> corrections, ||p - p_old|| / sqrt(n)
// Every norm, dot and maximum is a cluster reduction whose value every CTA
// holds bit-identically (cluster.cuh), so the data-dependent loops (Krylov,
// multigrid checks) stay uniform; PISO's correction count is a launch
// parameter.
//
// Bound on the H100: at the 63^2 headline every field is ~16 KB and the
// working set ~0.5 MB (~8 MB at 255^2, the largest grid the gate admits),
// all in L2; a step is a chain of ~100-300 dependent passes, so it is bound
// by the latency of the barriers between them and of the passes over the
// small multigrid levels, not by bytes or flops.  Design (cluster.cuh): one
// cluster of 16 CTAs (8 where 16 do not fit) with hardware cluster barriers
// in place of the cooperative grid's barriers through global memory; the
// coarse levels in rank 0's shared memory; the RAP spread over the cluster;
// one kernel instantiation per body (and per timer flag), so each gets its
// own register allocation.  Scratch comes from the wrapper; nothing is
// allocated here.
//
// The case axis (nf_fused_outer_step_batched, the lockstep loop of
// algorithms/batch.py): a grid of (cluster size, B), case b = blockIdx.y.
// Every per-case slot comes with its case stride; rank 0's thread 0 moves
// each pointer of the case-0 view by b strides into a shared-memory copy
// of the parameters, with the case's own viscous conductances (De, Dn,
// rounded to float32 on the host as the single launch's are), and the body
// runs on that view: the same code, the same cluster size and so the same
// reductions as the single launch, so each case's bits are its single
// launch's whatever B is.  A case whose active flag is false (frozen: it
// has converged or reached its limit) leaves before the first cluster
// barrier, every CTA of its cluster alike, after copying its inputs and
// held results into its outputs.  B above the clusters the card holds at
// once (nf_max_active_clusters) runs in waves.

#pragma once

#include "cluster.cuh"
#include "krylov.cuh"
#include "powerlaw.cuh"

// step.cu: the single launch's cluster size for `algo` (the batched launch
// takes the same, so that each case reduces in the same order; asked here so
// that step_batched.cu does not build the single kernels again)
NF_EXPORT int nf_step_cluster_size(int algo, int* size);

namespace {

enum Algo { SIMPLE = 0, SIMPLEC = 1, PISO = 2, SIMPLER = 3 };

// What powerlaw.cuh reads: the BC-applied velocities and the pressure the
// coefficients are assembled from, and the relaxation factor.
struct StepAsm {
  const float* u;
  const float* v;
  const float* p;
  int nx, ny;
  float cFu, cFv, De, Dn, dx, dy, alpha, one_m_alpha;
};

struct StepParams {
  StepAsm A;               // the predictor's: ub, vb, the step's p, alpha_u
  int nx, ny;
  float rho;
  const float *u_in, *v_in, *sc_in;
  float *u_out, *v_out, *p_out, *r_u, *r_v, *r_p, *sc_out;
  int* cyc_out;
  float *ub, *vb;          // the BC-applied velocities the momentum step reads
  float *cu[8], *cv[8];    // a_e, a_w, a_n, a_s, a_p, src unrelaxed; a_p, src relaxed
  float *ustar, *vstar, *d_u, *d_v;
  float* kry;              // 6 Krylov vectors of the larger field
  float* pnew;             // p before the boundary overwrite
  float* psm;              // SIMPLEC's smoothed p'
  float* fine[5];          // the pressure operator: c, e, w, n, s
  NfMG M;                  // lv[0]: fine operator, x = p', rhs = b
  int Ls;                  // lv[Ls..L-1] live in rank 0's shared memory
  unsigned long long* ph;  // phase timers (nf_fused_outer_step_phases), else null
  int mom_maxiter, max_cycles, check_every, pin, variant, overwrite_p;
  int n_corr, corr_exact, corr_sweeps, smooth_pp, dyn_alpha;
  float mom_tol, mg_tol, alpha_p, alpha_u;
  int bc_vel[4];           // top, bottom, left, right: a VELOCITY side
  float bc_u[4], bc_v[4];
  // a batched launch's per-case extras (null in a single launch): what a
  // frozen case returns beside its inputs (null: zeros), its active flag
  // and its (De, Dn)
  const float *sc_held, *ru_held, *rv_held, *rp_held;
  const int* cyc_held;
  const bool* active;
  const float* visc;
};

// A batched launch's parameters: the case-0 view and, in the same layout,
// each pointer's case stride in bytes.
struct StepBatch {
  StepParams P, S;
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

__device__ __forceinline__ float at2(const float* x, int ni, int nj, int i, int j) {
  return (i >= 0 && i < ni && j >= 0 && j < nj) ? x[(int64_t)i * nj + j] : 0.f;
}

// ub, vb = the velocity BCs applied to (uin, vin).
__device__ void apply_bcs(NfCluster& C, const StepParams& P, const float* uin, const float* vin) {
  const int ny = P.ny;
  const int64_t nu = (int64_t)(P.nx + 1) * ny, nv = (int64_t)P.nx * (ny + 1);
  for (int64_t g = C.gtid; g < nu; g += C.gstride)
    P.ub[g] = bc_u_val(P, (int)(g / ny), (int)(g % ny), uin[g]);
  for (int64_t g = C.gtid; g < nv; g += C.gstride)
    P.vb[g] = bc_v_val(P, (int)(g / (ny + 1)), (int)(g % (ny + 1)), vin[g]);
  nf_sync(C);
}

// One field's faces: coefficients, relaxation and d / d_div.
template <bool IS_U>
__device__ void assemble_field(const StepParams& P, const StepAsm& A, float d_div,
                               int64_t start, int64_t stride) {
  const int NJ = IS_U ? P.ny : P.ny + 1;
  const int64_t n = IS_U ? (int64_t)(P.nx + 1) * P.ny : (int64_t)P.nx * (P.ny + 1);
  float* const* c = IS_U ? P.cu : P.cv;
  const float* x = IS_U ? A.u : A.v;
  float* d = IS_U ? P.d_u : P.d_v;
  for (int64_t g = start; g < n; g += stride) {
    const int i = (int)(g / NJ), j = (int)(g % NJ);
    const Coef k = IS_U ? u_coef(A, i, j) : v_coef(A, i, j);
    const float apr = relax_ap(A, k.ap);
    c[0][g] = k.ae; c[1][g] = k.aw; c[2][g] = k.an; c[3][g] = k.as;
    c[4][g] = k.ap; c[5][g] = k.src;
    c[6][g] = apr;
    c[7][g] = k.src + A.one_m_alpha * apr * x[g];
    const bool row = IS_U ? (i >= 1 && i <= P.nx - 1) : (j >= 1 && j <= P.ny - 1);
    const float dv = (row && fabsf(apr) > 1e-12f) ? (IS_U ? A.dy : A.dx) / apr : 0.f;
    d[g] = dv / d_div;
  }
}

// solvers/momentum._jacobi_sweeps of one field into x: `sweeps` sweeps of
// x = (sum a_nb x_nb + src) / a_p on the solve mask, from x0, ping-ponging
// between x and tmp so that the last sweep lands in x.
__device__ void jacobi_field(NfCluster& C, float* const* c, const float* x0, float* x, float* tmp,
                             int ni, int nj, int sweeps) {
  const int64_t n = (int64_t)ni * nj;
  const float* src = x0;
  for (int s = 0; s < sweeps; ++s) {
    float* dst = ((sweeps - 1 - s) % 2 == 0) ? x : tmp;
    for (int64_t g = C.gtid; g < n; g += C.gstride) {
      const int i = (int)(g / nj), j = (int)(g % nj);
      const bool in = i >= 1 && i <= ni - 2 && j >= 1 && j <= nj - 2;
      const float ap = c[6][g];
      const float nb = c[0][g] * at2(src, ni, nj, i + 1, j) + c[1][g] * at2(src, ni, nj, i - 1, j) +
                       c[2][g] * at2(src, ni, nj, i, j + 1) + c[3][g] * at2(src, ni, nj, i, j - 1);
      dst[g] = in ? (nb + c[7][g]) / (ap == 0.f ? 1.f : ap) : src[g];
    }
    nf_sync(C);
    src = dst;
  }
  if (sweeps == 0) {
    for (int64_t g = C.gtid; g < n; g += C.gstride) x[g] = x0[g];
    nf_sync(C);
  }
}

// The momentum pair from ub, vb and A.p at relaxation A.alpha: coefficients,
// d / d_div, both solves (BiCGSTAB, or `corr_sweeps` Jacobi sweeps), BCs on
// u*, v*.
template <bool PH>
__device__ void momentum_pair(NfCluster& C, const StepParams& P, const StepAsm& A, float d_div,
                              bool jacobi) {
  const int nx = P.nx, ny = P.ny;
  const int64_t nu = (int64_t)(nx + 1) * ny, nv = (int64_t)nx * (ny + 1);
  assemble_field<true>(P, A, d_div, C.gtid, C.gstride);
  assemble_field<false>(P, A, d_div, C.gtid, C.gstride);
  nf_sync(C);
  nf_stamp<PH>(P.ph, PH_ASM);
  if (jacobi) {
    jacobi_field(C, P.cu, P.ub, P.ustar, P.kry, nx + 1, ny, P.corr_sweeps);
    nf_stamp<PH>(P.ph, PH_U);
    jacobi_field(C, P.cv, P.vb, P.vstar, P.kry, nx, ny + 1, P.corr_sweeps);
    nf_stamp<PH>(P.ph, PH_V);
  } else {
    const int64_t nk = nu > nv ? nu : nv;
    NfKrylov Ku = {P.cu[0], P.cu[1], P.cu[2], P.cu[3], P.cu[6], P.cu[7], P.ub, P.ustar,
                   P.kry, P.kry + nk, P.kry + 2 * nk, P.kry + 3 * nk, P.kry + 4 * nk,
                   P.kry + 5 * nk, nx + 1, ny, 1, 1, 1, 1};
    nf_bicgstab_solve(C, Ku, P.mom_tol, P.mom_maxiter);
    nf_stamp<PH>(P.ph, PH_U);
    NfKrylov Kv = Ku;
    Kv.ae = P.cv[0]; Kv.aw = P.cv[1]; Kv.an = P.cv[2]; Kv.as = P.cv[3];
    Kv.ap = P.cv[6]; Kv.src = P.cv[7]; Kv.x0 = P.vb; Kv.x = P.vstar;
    Kv.ni = nx; Kv.nj = ny + 1;
    nf_bicgstab_solve(C, Kv, P.mom_tol, P.mom_maxiter);
    nf_stamp<PH>(P.ph, PH_V);
  }
  for (int64_t g = C.gtid; g < nu; g += C.gstride)
    P.ustar[g] = bc_u_val(P, (int)(g / ny), (int)(g % ny), P.ustar[g]);
  for (int64_t g = C.gtid; g < nv; g += C.gstride)
    P.vstar[g] = bc_v_val(P, (int)(g / (ny + 1)), (int)(g % (ny + 1)), P.vstar[g]);
  nf_sync(C);
  nf_stamp<PH>(P.ph, PH_ASM);
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

// The predictor's residual fields r_u, r_v and their interior norms^2.
__device__ void momentum_residuals(NfCluster& C, const StepParams& P, float (&norms)[2]) {
  const int nx = P.nx, ny = P.ny;
  const int64_t nu = (int64_t)(nx + 1) * ny, nv = (int64_t)nx * (ny + 1);
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
  nf_reduce<2>(C, acc, norms);
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
  float ae = (i < nx - 1) ? P.rho * du(i + 1, j) * P.A.dy : 0.f;
  float aw = (i > 0) ? P.rho * du(i, j) * P.A.dy : 0.f;
  float an = (j < ny - 1) ? P.rho * dv(i, j + 1) * P.A.dx : 0.f;
  float as = (j > 0) ? P.rho * dv(i, j) * P.A.dx : 0.f;
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

// The pressure solve from u*, v*, d_u, d_v: RHS and operator, the RAP, the
// multigrid solve from zeros into lv[0].x with its residual in r_p
// (`scratch`: rank 0's residual scratch).
// Returns the cycle count (the same in every CTA).
template <bool PH>
__device__ int pressure_solve(NfCluster& C, const StepParams& P, const NfLevel* lv,
                              float* scratch) {
  const int nx = P.nx, ny = P.ny;
  const int64_t np = (int64_t)nx * ny;
  float* b = const_cast<float*>(lv[0].rhs);
  for (int64_t g = C.gtid; g < np; g += C.gstride) {
    const int i = (int)(g / ny), j = (int)(g % ny);
    const float bu = (P.ustar[(int64_t)i * ny + j] - P.ustar[(int64_t)(i + 1) * ny + j]) * P.A.dy;
    const float bv =
        (P.vstar[(int64_t)i * (ny + 1) + j] - P.vstar[(int64_t)i * (ny + 1) + j + 1]) * P.A.dx;
    b[g] = (P.pin && g == 0) ? 0.f : P.rho * (bu + bv);
    pressure_cell(P, i, j, g);
    lv[0].x[g] = 0.f;
  }
  nf_sync(C);
  nf_stamp<PH>(P.ph, PH_RHS);
  nf_cl_galerkin_rap(C, lv, P.M.L);
  nf_stamp<PH>(P.ph, PH_RAP);
  return nf_cl_mg_solve<PH>(C, P.M, lv, P.Ls, scratch, P.r_p, P.max_cycles, P.check_every,
                            P.mg_tol, !P.pin, P.ph);
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

// p_out = pbase + a * pp (then the boundary overwrite, where configured);
// pbase may be p_out itself.
__device__ void update_pressure(NfCluster& C, const StepParams& P, const float* pbase, float a,
                                const float* pp) {
  const int64_t np = (int64_t)P.nx * P.ny;
  float* dst = P.overwrite_p ? P.pnew : P.p_out;
  for (int64_t g = C.gtid; g < np; g += C.gstride) dst[g] = pbase[g] + a * pp[g];
  nf_sync(C);
  if (P.overwrite_p) {
    for (int64_t g = C.gtid; g < np; g += C.gstride)
      P.p_out[g] = enforced_p(P.pnew, P.nx, P.ny, (int)(g / P.ny), (int)(g % P.ny));
    nf_sync(C);
  }
}

// solvers/velocity.update_velocity: u_out, v_out from u*, v*, pp and d.
__device__ void update_velocity(NfCluster& C, const StepParams& P, const float* pp) {
  const int nx = P.nx, ny = P.ny;
  const int64_t nu = (int64_t)(nx + 1) * ny, nv = (int64_t)nx * (ny + 1);
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
  nf_sync(C);
}

// The compensated sum of squares of r_p over the interior cells.
__device__ float interior_rp2(NfCluster& C, const StepParams& P) {
  const int nx = P.nx, ny = P.ny;
  NfDS acc[1] = {nf_ds_zero()};
  for (int64_t g = C.gtid; g < (int64_t)nx * ny; g += C.gstride) {
    const int i = (int)(g / ny), j = (int)(g % ny);
    if (i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 2) nf_ds_fma(acc[0], P.r_p[g], P.r_p[g]);
  }
  float out[1];
  nf_reduce<1>(C, acc, out);
  return out[0];
}

template <int ALGO, bool PH>
__device__ __forceinline__ void step_body(const StepParams& P) {
  extern __shared__ float dyn[];  // rank 0's partials, scratch and small levels (cluster.cuh)
  __shared__ NfLevel lv[NF_MAX_LEVELS];
  NfCluster C = nf_cluster(dyn);
  float* scratch = dyn + NF_CL_RED_FLOATS;  // rank 0's residual scratch
  if (threadIdx.x == 0) nf_cl_levels(P.M, P.Ls, dyn, lv);
  __syncthreads();
  nf_sync(C);  // every CTA has started before any touches rank 0's shared memory
  const int nx = P.nx, ny = P.ny;
  const int64_t nu = (int64_t)(nx + 1) * ny, nv = (int64_t)nx * (ny + 1),
                np = (int64_t)nx * ny;
  const float* pp = lv[0].x;  // p' (or p_bar) after each pressure solve
  nf_stamp<PH>(P.ph, -1);

  // the predictor: relaxed momentum at the step's p; its residuals
  apply_bcs(C, P, P.u_in, P.v_in);
  momentum_pair<PH>(C, P, P.A, ALGO == SIMPLEC ? P.alpha_u : 1.f, false);
  float norms[2];
  momentum_residuals(C, P, norms);
  nf_stamp<PH>(P.ph, PH_RESID);
  int cycles = pressure_solve<PH>(C, P, lv, scratch);
  float sc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};

  if constexpr (ALGO == SIMPLE) {
    update_pressure(C, P, P.A.p, P.alpha_p, pp);
    update_velocity(C, P, pp);
    nf_stamp<PH>(P.ph, PH_CORR);
    const float p_l2 = sqrtf(interior_rp2(C, P));
    nf_stamp<PH>(P.ph, PH_NORMS);
    const float p_max = fmaxf(P.sc_in[0], p_l2);
    sc[0] = p_max; sc[1] = sqrtf(norms[0]); sc[2] = sqrtf(norms[1]);
    sc[3] = p_max > 0.f ? p_l2 / p_max : 1.f;
  } else if constexpr (ALGO == SIMPLEC) {
    if (P.smooth_pp) {  // algorithms/simplec._smooth_p_prime
      for (int64_t g = C.gtid; g < np; g += C.gstride) {
        const int i = (int)(g / ny), j = (int)(g % ny);
        float s = 0.f;
        if (i >= 1 && i <= nx - 2 && j >= 1 && j <= ny - 2)
          s = 0.6f * pp[g] + 0.1f * (((pp[g + ny] + pp[g - ny]) + pp[g + 1]) + pp[g - 1]);
        P.psm[g] = s;
      }
      nf_sync(C);
      pp = P.psm;
    }
    const float alpha_p = P.sc_in[0], prev = P.sc_in[1];
    update_pressure(C, P, P.A.p, alpha_p, pp);
    update_velocity(C, P, pp);
    nf_stamp<PH>(P.ph, PH_CORR);
    float m[3] = {0.f, 0.f, 0.f};
    for (int64_t g = C.gtid; g < nu; g += C.gstride)
      m[0] = nf_max_nan(m[0], fabsf(P.u_out[g] - P.u_in[g]));
    for (int64_t g = C.gtid; g < nv; g += C.gstride)
      m[1] = nf_max_nan(m[1], fabsf(P.v_out[g] - P.v_in[g]));
    for (int64_t g = C.gtid; g < np; g += C.gstride)
      m[2] = nf_max_nan(m[2], fabsf(P.p_out[g] - P.A.p[g]));
    float res[3];
    nf_cl_max<3>(C, m, res);
    nf_stamp<PH>(P.ph, PH_NORMS);
    const float total = nf_max_nan(res[0], res[1]);
    sc[0] = (P.dyn_alpha && total > prev) ? alpha_p * 0.95f : alpha_p;
    sc[1] = total; sc[2] = res[0]; sc[3] = res[1]; sc[4] = res[2];
  } else if constexpr (ALGO == PISO) {
    StepAsm Ac = P.A;  // the corrector: unrelaxed, at the corrected pressure
    Ac.p = P.p_out;
    Ac.alpha = 1.f;
    Ac.one_m_alpha = 0.f;
    const float* pbase = P.A.p;
    for (int k = 0; k < P.n_corr; ++k) {
      if (k > 0) cycles += pressure_solve<PH>(C, P, lv, scratch);
      update_pressure(C, P, pbase, P.alpha_p, pp);
      pbase = P.p_out;
      update_velocity(C, P, pp);
      nf_stamp<PH>(P.ph, PH_CORR);
      if (k < P.n_corr - 1) {
        apply_bcs(C, P, P.u_out, P.v_out);
        momentum_pair<PH>(C, P, Ac, 1.f, !P.corr_exact);
      }
    }
    const float p_l2 = sqrtf(interior_rp2(C, P));
    nf_stamp<PH>(P.ph, PH_NORMS);
    const float p_max = fmaxf(P.sc_in[0], p_l2);
    sc[0] = p_max; sc[1] = sqrtf(norms[0]); sc[2] = sqrtf(norms[1]);
    sc[3] = p_max > 0.f ? p_l2 / p_max : 1.f;
  } else {  // SIMPLER
    update_pressure(C, P, P.A.p, 1.f, pp);  // p + p_bar
    nf_stamp<PH>(P.ph, PH_CORR);
    StepAsm A3 = P.A;  // ub, vb still hold the BC-applied step input
    A3.p = P.p_out;
    momentum_pair<PH>(C, P, A3, 1.f, false);
    cycles += pressure_solve<PH>(C, P, lv, scratch);
    update_pressure(C, P, P.p_out, P.alpha_p, pp);
    update_velocity(C, P, pp);
    nf_stamp<PH>(P.ph, PH_CORR);
    NfDS acc[1] = {nf_ds_zero()};
    for (int64_t g = C.gtid; g < np; g += C.gstride) {
      const float dp = P.p_out[g] - P.A.p[g];
      nf_ds_fma(acc[0], dp, dp);
    }
    float s2[1];
    nf_reduce<1>(C, acc, s2);
    nf_stamp<PH>(P.ph, PH_NORMS);
    sc[0] = P.sc_in[0]; sc[1] = sqrtf(norms[0]); sc[2] = sqrtf(norms[1]);
    sc[3] = sqrtf(s2[0]) / (sqrtf((float)np) + 1e-30f);
  }
  if (C.rank == 0 && threadIdx.x == 0) {
    for (int k = 0; k < (ALGO == SIMPLEC ? 5 : 4); ++k) P.sc_out[k] = sc[k];
    *P.cyc_out = cycles;
  }
  nf_sync(C);  // no CTA exits while another may read rank 0's shared memory
}

template <int ALGO, bool PH>
__global__ void __launch_bounds__(NF_CL_THREADS, 1) step_kernel(StepParams P) {
  step_body<ALGO, PH>(P);
}

template <class T>
__device__ __forceinline__ void step_shift(T*& p, const void* stride, int b) {
  p = reinterpret_cast<T*>(reinterpret_cast<intptr_t>(p) +
                           (intptr_t)b * reinterpret_cast<intptr_t>(stride));
}

// Case b's view: every pointer of P moved by b times its stride in S.
__device__ void step_case(StepParams& P, const StepParams& S, int b) {
  step_shift(P.A.u, S.A.u, b); step_shift(P.A.v, S.A.v, b); step_shift(P.A.p, S.A.p, b);
  step_shift(P.u_in, S.u_in, b); step_shift(P.v_in, S.v_in, b);
  step_shift(P.sc_in, S.sc_in, b);
  step_shift(P.u_out, S.u_out, b); step_shift(P.v_out, S.v_out, b);
  step_shift(P.p_out, S.p_out, b);
  step_shift(P.r_u, S.r_u, b); step_shift(P.r_v, S.r_v, b); step_shift(P.r_p, S.r_p, b);
  step_shift(P.sc_out, S.sc_out, b); step_shift(P.cyc_out, S.cyc_out, b);
  step_shift(P.ub, S.ub, b); step_shift(P.vb, S.vb, b);
  for (int a = 0; a < 8; ++a) {
    step_shift(P.cu[a], S.cu[a], b);
    step_shift(P.cv[a], S.cv[a], b);
  }
  step_shift(P.ustar, S.ustar, b); step_shift(P.vstar, S.vstar, b);
  step_shift(P.d_u, S.d_u, b); step_shift(P.d_v, S.d_v, b);
  step_shift(P.kry, S.kry, b); step_shift(P.pnew, S.pnew, b); step_shift(P.psm, S.psm, b);
  for (int a = 0; a < 5; ++a) step_shift(P.fine[a], S.fine[a], b);
  for (int l = 0; l < P.M.L; ++l) {  // the shared-memory levels' pointers are null
    for (int a = 0; a < 9; ++a) step_shift(P.M.lv[l].st[a], S.M.lv[l].st[a], b);
    step_shift(P.M.lv[l].x, S.M.lv[l].x, b);
    step_shift(P.M.lv[l].rhs, S.M.lv[l].rhs, b);
  }
  step_shift(P.sc_held, S.sc_held, b); step_shift(P.ru_held, S.ru_held, b);
  step_shift(P.rv_held, S.rv_held, b); step_shift(P.rp_held, S.rp_held, b);
  step_shift(P.cyc_held, S.cyc_held, b);
  step_shift(P.active, S.active, b); step_shift(P.visc, S.visc, b);
}

// A frozen case: its state and scalar carries come back as they went in,
// its other results as held (zeros where none are held).  No cluster
// barrier: every CTA of the cluster takes this branch, and no CTA touches
// another's shared memory.
template <int ALGO>
__device__ void step_frozen(const StepParams& P) {
  constexpr int N_IN = ALGO == SIMPLEC ? 2 : 1, N_OUT = ALGO == SIMPLEC ? 5 : 4;
  cg::cluster_group cl = cg::this_cluster();
  const int64_t start = (int64_t)cl.block_rank() * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)cl.num_blocks() * blockDim.x;
  const int64_t nu = (int64_t)(P.nx + 1) * P.ny, nv = (int64_t)P.nx * (P.ny + 1),
                np = (int64_t)P.nx * P.ny;
  for (int64_t g = start; g < nu; g += stride) {
    P.u_out[g] = P.u_in[g];
    P.r_u[g] = P.ru_held ? P.ru_held[g] : 0.f;
  }
  for (int64_t g = start; g < nv; g += stride) {
    P.v_out[g] = P.v_in[g];
    P.r_v[g] = P.rv_held ? P.rv_held[g] : 0.f;
  }
  for (int64_t g = start; g < np; g += stride) {
    P.p_out[g] = P.A.p[g];
    P.r_p[g] = P.rp_held ? P.rp_held[g] : 0.f;
  }
  if (start < N_OUT)
    P.sc_out[start] = start < N_IN ? P.sc_in[start] : (P.sc_held ? P.sc_held[start] : 0.f);
  if (start == 0) *P.cyc_out = P.cyc_held ? *P.cyc_held : 0;
}

template <int ALGO>
__global__ void __launch_bounds__(NF_CL_THREADS, 1) step_kernel_batched(const StepBatch SB) {
  __shared__ StepParams P;  // this case's view
  if (threadIdx.x == 0) {
    P = SB.P;
    step_case(P, SB.S, (int)blockIdx.y);
    P.A.De = P.visc[0];
    P.A.Dn = P.visc[1];
  }
  __syncthreads();
  if (*P.active)
    step_body<ALGO, false>(P);
  else
    step_frozen<ALGO>(P);
}

template <int ALGO, bool PH>
NfClusterCfg& step_cfg() {
  static NfClusterCfg cfg = {};
  return cfg;
}

template <int ALGO, bool PH>
int launch_algo(const StepParams& P, size_t smem, cudaStream_t s) {
  int size = 0;
  int err = nf_cluster_size(step_kernel<ALGO, PH>, step_cfg<ALGO, PH>(), size);
  if (err) return err;
  return nf_cluster_launch(step_kernel<ALGO, PH>, size, P, smem, s);
}

template <int ALGO>
NfClusterCfg& step_batch_cfg() {
  static NfClusterCfg cfg = {};
  return cfg;
}

// `cases` clusters of the single launch's size (so its reduction order),
// or an error where that size does not fit the batched kernel.
template <int ALGO>
int launch_algo_batched(const StepBatch& SB, int cases, size_t smem, cudaStream_t s) {
  int size = 0, bsize = 0;
  int err = nf_step_cluster_size(ALGO, &size);
  if (!err) err = nf_cluster_size(step_kernel_batched<ALGO>, step_batch_cfg<ALGO>(), bsize, size);
  if (err) return err;
  if (bsize != size) return (int)cudaErrorLaunchOutOfResources;
  return nf_cluster_launch(step_kernel_batched<ALGO>, size, SB, smem, s, cases);
}

// ptrs: u, v, p, the scalar carries (ops/step.py ALGO_SCALARS: 1 or 2
//       floats), then the outputs u', v', p', r_u, r_v, r_p, scalars (4 or 5
//       floats), cycles (int32), then scratch: ub, vb, 8 u-coefficient
//       arrays, 8 v-coefficient arrays, u*, v*, d_u, d_v, Krylov (6 x the
//       larger field), p before the overwrite, the smoothed p', the fine
//       operator (c, e, w, n, s), b, p'; then per coarse level of more than
//       NF_SMALL_CELLS cells 9 stencil arrays, x, rhs (the smaller levels
//       live in shared memory); with the timers, the timer buffer
//       (2 * NF_PHASES + 1 zeroed 64-bit integers); batched, case 0's
//       slots, then the held scalars (4 or 5 floats), r_u, r_v, r_p and
//       cycles a frozen case returns (0: zeros), the active flags (bool)
//       and (De, Dn) (2 floats), then every slot's case stride in bytes,
//       in the same order
// ip:   algo (0 simple, 1 simplec, 2 piso, 3 simpler), nx, ny, L, pre, post,
//       coarsest, max_cycles, check_every, mom_maxiter, pin, variant,
//       overwrite_p, n_corrections, corrector_exact, corrector_sweeps,
//       smooth_p_prime, dynamic_alpha_p, bc_vel[4], then per level ni, nj;
//       batched, then the case count
// fp:   cFu, cFv, De, Dn, dx, dy, alpha_u, 1 - alpha_u, rho, alpha_p,
//       mom_tol, mg_tol, omega, bc_u[4], bc_v[4] (batched: De and Dn are
//       each case's own, from its slot)
template <bool PH, bool BATCH = false>
int launch_step(const long long* ptrs, const int* ip, const float* fp, void* stream) {
  StepBatch SB = {};
  int k = 0;
  auto next = [&]() { return reinterpret_cast<float*>(ptrs[k++]); };
  const int algo = ip[0];
  if (algo < SIMPLE || algo > SIMPLER) return (int)cudaErrorInvalidValue;
  int64_t small_floats = 0;
  // batched, a second pass reads the strides into SB.S through the same reads
  for (int pass = 0; pass < (BATCH ? 2 : 1); ++pass) {
    StepParams& P = pass == 0 ? SB.P : SB.S;
    P.u_in = next(); P.v_in = next(); P.A.p = next(); P.sc_in = next();
    P.u_out = next(); P.v_out = next(); P.p_out = next();
    P.r_u = next(); P.r_v = next(); P.r_p = next(); P.sc_out = next();
    P.cyc_out = reinterpret_cast<int*>(next());
    P.ub = next(); P.vb = next();
    P.A.u = P.ub; P.A.v = P.vb;
    for (int a = 0; a < 8; ++a) P.cu[a] = next();
    for (int a = 0; a < 8; ++a) P.cv[a] = next();
    P.ustar = next(); P.vstar = next(); P.d_u = next(); P.d_v = next();
    P.kry = next(); P.pnew = next(); P.psm = next();
    for (int a = 0; a < 5; ++a) P.fine[a] = next();
    float* b = next();
    float* pprime = next();
    P.nx = P.A.nx = ip[1];
    P.ny = P.A.ny = ip[2];
    const int L = ip[3];
    if (L < 1 || L > NF_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    NfMG& M = P.M;
    M.L = L; M.pre = ip[4]; M.post = ip[5]; M.coarsest = ip[6];
    P.max_cycles = ip[7]; P.check_every = ip[8]; P.mom_maxiter = ip[9];
    P.pin = ip[10]; P.variant = ip[11]; P.overwrite_p = ip[12];
    P.n_corr = ip[13]; P.corr_exact = ip[14]; P.corr_sweeps = ip[15];
    P.smooth_pp = ip[16]; P.dyn_alpha = ip[17];
    if (P.check_every < 1) return (int)cudaErrorInvalidValue;
    if (algo == PISO && (P.n_corr < 1 || P.corr_sweeps < 0)) return (int)cudaErrorInvalidValue;
    for (int a = 0; a < 4; ++a) P.bc_vel[a] = ip[18 + a];
    P.Ls = L;
    small_floats = 0;
    for (int l = 0; l < L; ++l) {
      NfLevel& lv = M.lv[l];
      lv.ni = ip[22 + 2 * l]; lv.nj = ip[23 + 2 * l];
      const int64_t cells = (int64_t)lv.ni * lv.nj;
      if (l > 0 && (M.lv[l - 1].ni != 2 * lv.ni + 1 || M.lv[l - 1].nj != 2 * lv.nj + 1))
        return (int)cudaErrorInvalidValue;  // vertex pairs only (odd grids)
      if (l == 0) {
        for (int a = 0; a < 5; ++a) lv.st[a] = P.fine[a];
        lv.x = pprime; lv.rhs = b; lv.five = 1;
      } else if (cells > NF_SMALL_CELLS) {
        for (int a = 0; a < 9; ++a) lv.st[a] = next();
        lv.x = next(); lv.rhs = next(); lv.five = 0;
      } else {
        small_floats += (P.Ls == L ? 12 : 11) * cells;  // the first also sizes the scratch
        if (P.Ls == L) P.Ls = l;
      }
    }
    if (M.lv[0].ni != P.nx || M.lv[0].nj != P.ny) return (int)cudaErrorInvalidValue;
    if (PH) P.ph = reinterpret_cast<unsigned long long*>(ptrs[k++]);
    if (BATCH) {
      P.sc_held = next(); P.ru_held = next(); P.rv_held = next(); P.rp_held = next();
      P.cyc_held = reinterpret_cast<const int*>(next());
      P.active = reinterpret_cast<const bool*>(next());
      P.visc = next();
    }
    P.A.cFu = fp[0]; P.A.cFv = fp[1]; P.A.De = fp[2]; P.A.Dn = fp[3];
    P.A.dx = fp[4]; P.A.dy = fp[5];
    P.A.alpha = P.alpha_u = fp[6]; P.A.one_m_alpha = fp[7]; P.rho = fp[8]; P.alpha_p = fp[9];
    P.mom_tol = fp[10]; P.mg_tol = fp[11]; M.omega = fp[12];
    for (int a = 0; a < 4; ++a) { P.bc_u[a] = fp[13 + a]; P.bc_v[a] = fp[17 + a]; }
  }
  const size_t smem = (size_t)(NF_CL_RED_FLOATS + small_floats) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (BATCH) {
    const int cases = ip[22 + 2 * SB.P.M.L];
    switch (algo) {
      case SIMPLE: return launch_algo_batched<SIMPLE>(SB, cases, smem, s);
      case SIMPLEC: return launch_algo_batched<SIMPLEC>(SB, cases, smem, s);
      case PISO: return launch_algo_batched<PISO>(SB, cases, smem, s);
      default: return launch_algo_batched<SIMPLER>(SB, cases, smem, s);
    }
  } else {
    switch (algo) {
      case SIMPLE: return launch_algo<SIMPLE, PH>(SB.P, smem, s);
      case SIMPLEC: return launch_algo<SIMPLEC, PH>(SB.P, smem, s);
      case PISO: return launch_algo<PISO, PH>(SB.P, smem, s);
      default: return launch_algo<SIMPLER, PH>(SB.P, smem, s);
    }
  }
}

}  // namespace
