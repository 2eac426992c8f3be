// Device code of the masked BiCGSTAB momentum solve: the whole-step kernel
// K6 calls it for both velocity fields, over its cluster; K7 (krylov.cu)
// for a field whose band does not fit its cluster kernel, over a
// cooperative grid.
//
// The algebra, the breakdown guards and the stopping rule are those of
// solvers/momentum._bicgstab_masked with compensated dots
// (ops/pallas_krylov.py's kernel):
//   while ok and k < maxiter and (r, r) > tol2: one BiCGSTAB step
// on the nodes inside the mask (margins lo_i, hi_i, lo_j, hi_j); the matrix
// is the 5-point momentum stencil, zero outside the mask; neighbours are
// read with bounds checks (zero outside the array) where the TPU rolled.
// Every dot is a compensated (Dot2) sum over the grid from nf_reduce, so
// every block computes the same scalars and leaves the loop together.
// Per iteration: five passes and five barriers (p; v = A p with (rhat, v);
// s; t = A s with (t, t) and (t, s); x and r with (r, r) and (rhat, r)).
// The solve is written once for both execution contexts: a cooperative grid
// (NfCoop, coop.cuh) and a thread-block cluster (NfCluster, cluster.cuh);
// each gives gtid / gstride, nf_sync and nf_reduce.
#pragma once

#include "cluster.cuh"

struct NfKrylov {
  const float *ae, *aw, *an, *as, *ap, *src;  // relaxed system (StencilCoeffs)
  const float* x0;                            // initial guess, kept off the mask
  float* x;                                   // the solution (output)
  float *r, *rhat, *v, *p, *s, *t;            // scratch, each ni x nj
  int ni, nj, lo_i, hi_i, lo_j, hi_j;
};

__device__ __forceinline__ bool nf_kry_in(const NfKrylov& K, int i, int j) {
  return i >= K.lo_i && i <= K.ni - 1 - K.hi_i && j >= K.lo_j && j <= K.nj - 1 - K.hi_j;
}

__device__ __forceinline__ float nf_kry_at(const NfKrylov& K, const float* x, int i, int j) {
  return (i >= 0 && i < K.ni && j >= 0 && j < K.nj) ? x[(int64_t)i * K.nj + j] : 0.f;
}

// (A x)[i, j] * mask, in ops/stencil.apply_stencil's order.
__device__ __forceinline__ float nf_kry_A(const NfKrylov& K, const float* x, int i, int j,
                                          int64_t g) {
  if (!nf_kry_in(K, i, j)) return 0.f;
  return K.ap[g] * x[g] - K.ae[g] * nf_kry_at(K, x, i + 1, j) -
         K.aw[g] * nf_kry_at(K, x, i - 1, j) - K.an[g] * nf_kry_at(K, x, i, j + 1) -
         K.as[g] * nf_kry_at(K, x, i, j - 1);
}

// The whole solve; writes K.x (mask ? x : x0).  Every thread of the grid
// (or cluster) calls it; it begins and ends with the grid in step.
template <class Ctx>
__device__ inline void nf_bicgstab_solve(Ctx& C, const NfKrylov& K, float tol, int maxiter) {
  const int64_t n = (int64_t)K.ni * K.nj;
  const float eps = 1.17549435e-38f * 1e6f;  // finfo(float32).tiny * 1e6
  for (int64_t g = C.gtid; g < n; g += C.gstride) {
    const int i = (int)(g / K.nj), j = (int)(g % K.nj);
    K.x[g] = nf_kry_in(K, i, j) ? K.x0[g] : 0.f;
  }
  nf_sync(C);
  float sc[3];
  {
    NfDS acc[3] = {nf_ds_zero(), nf_ds_zero(), nf_ds_zero()};
    for (int64_t g = C.gtid; g < n; g += C.gstride) {
      const int i = (int)(g / K.nj), j = (int)(g % K.nj);
      const float b = nf_kry_in(K, i, j) ? K.src[g] : 0.f;
      const float r = b - nf_kry_A(K, K.x, i, j, g);
      K.r[g] = r; K.rhat[g] = r; K.v[g] = 0.f; K.p[g] = 0.f;
      nf_ds_fma(acc[0], b, b);
      nf_ds_fma(acc[1], r, r);
      nf_ds_fma(acc[2], r, r);  // (rhat, r) with rhat = r
    }
    nf_reduce<3>(C, acc, sc);
  }
  const float bnorm = sqrtf(sc[0]);
  const float tb = tol * fmaxf(bnorm, 1e-30f);
  const float tol2 = tb * tb;
  float rr = sc[1], rho_new = sc[2];
  float rho = 1.f, alpha = 1.f, omega = 1.f;
  bool ok = true;
  for (int k = 0; ok && k < maxiter && rr > tol2; ++k) {
    bool good = fabsf(rho) > eps && fabsf(omega) > eps;
    const float beta =
        good ? (rho_new / (rho == 0.f ? 1.f : rho)) * (alpha / (omega == 0.f ? 1.f : omega)) : 0.f;
    for (int64_t g = C.gtid; g < n; g += C.gstride)
      K.p[g] = K.r[g] + beta * (K.p[g] - omega * K.v[g]);
    nf_sync(C);
    float dn[1];
    {
      NfDS acc[1] = {nf_ds_zero()};
      for (int64_t g = C.gtid; g < n; g += C.gstride) {
        const float vv = nf_kry_A(K, K.p, (int)(g / K.nj), (int)(g % K.nj), g);
        K.v[g] = vv;
        nf_ds_fma(acc[0], K.rhat[g], vv);
      }
      nf_reduce<1>(C, acc, dn);
    }
    good = good && fabsf(dn[0]) > eps;
    alpha = good ? rho_new / (dn[0] == 0.f ? 1.f : dn[0]) : 0.f;
    for (int64_t g = C.gtid; g < n; g += C.gstride) K.s[g] = K.r[g] - alpha * K.v[g];
    nf_sync(C);
    float ts[2];
    {
      NfDS acc[2] = {nf_ds_zero(), nf_ds_zero()};
      for (int64_t g = C.gtid; g < n; g += C.gstride) {
        const float tv = nf_kry_A(K, K.s, (int)(g / K.nj), (int)(g % K.nj), g);
        K.t[g] = tv;
        nf_ds_fma(acc[0], tv, tv);
        nf_ds_fma(acc[1], tv, K.s[g]);
      }
      nf_reduce<2>(C, acc, ts);
    }
    omega = ts[0] > eps ? ts[1] / (ts[0] == 0.f ? 1.f : ts[0]) : 0.f;
    {
      NfDS acc[2] = {nf_ds_zero(), nf_ds_zero()};
      for (int64_t g = C.gtid; g < n; g += C.gstride) {
        K.x[g] = K.x[g] + alpha * K.p[g] + omega * K.s[g];
        const float r = K.s[g] - omega * K.t[g];
        K.r[g] = r;
        nf_ds_fma(acc[0], r, r);
        nf_ds_fma(acc[1], K.rhat[g], r);
      }
      float nr[2];
      nf_reduce<2>(C, acc, nr);
      rr = nr[0];
      rho = rho_new;
      rho_new = nr[1];
    }
    ok = good;
  }
  for (int64_t g = C.gtid; g < n; g += C.gstride) {
    const int i = (int)(g / K.nj), j = (int)(g % K.nj);
    if (!nf_kry_in(K, i, j)) K.x[g] = K.x0[g];
  }
  nf_sync(C);
}
