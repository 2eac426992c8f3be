// Device code of the masked BiCGSTAB momentum solve, written once
// (nf_kry_body) for every caller: the whole-step kernel K6 calls it for
// both velocity fields over its cluster, and K7's cooperative grid kernel
// (krylov.cu) for a field whose band does not fit its cluster kernel
// (nf_bicgstab_solve, one case); the grid kernel's case form for B such
// fields in one launch (nf_bicgstab_solve_cases).
//
// The algebra, the breakdown guards and the stopping rule are those of
// solvers/momentum._bicgstab_masked with compensated dots
// (ops/pallas_krylov.py's kernel):
//   while ok and k < maxiter and (r, r) > tol2: one BiCGSTAB step
// on the nodes inside the mask (margins lo_i, hi_i, lo_j, hi_j); the matrix
// is the 5-point momentum stencil, zero outside the mask; neighbours are
// read with bounds checks (zero outside the array) where the TPU rolled.
// Every dot is a compensated (Dot2) sum over the grid, so every block
// computes the same scalars and leaves the loop together.  Per iteration:
// five passes and five barriers (p; v = A p with (rhat, v); s; t = A s with
// (t, t) and (t, s); x and r with (r, r) and (rhat, r)).  The context (a
// cooperative grid, NfCoop in coop.cuh, or a thread-block cluster,
// NfCluster in cluster.cuh) gives gtid / gstride, nf_sync and nf_reduce;
// the set of cases (NfKryOne, NfKryCases below) gives each case's arrays,
// its scalars and its sums.
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

// Each case's scalars (rho, alpha, omega, its stopping and breakdown flags,
// its last sums): KC_FIELDS floats a case.
enum NfKrylovCaseField { KC_RUN = 0, KC_OK, KC_GOOD, KC_RHO, KC_ALPHA, KC_OMEGA, KC_RR,
                         KC_RHO_NEW, KC_TOL2, KC_BETA, KC_SUM, KC_FIELDS = KC_SUM + 3 };

// B fields of one shape over one cooperative grid (krylov.cu's
// bicgstab_grid_kernel_batched): every pass is a loop over the running
// cases, each over the cells the block covers in the single grid launch
// (the same gtid / gstride), and every reduction sums each running case's
// partials in the single launch's order (nf_block_sum into the case's own
// slots, one grid barrier, then nf_warp_sum, warp w taking cases w,
// w + warps, ...; nf_grid_reduce's order).  So each case's bits are its
// single launch's, and one barrier
// serves every case: a launch pays the slowest case's barriers once.  Each
// case's scalars live in every block's shared memory, written by thread b
// for case b from the reduced sums every block holds, so every block takes
// the same branches.  A case the active flags freeze gets x0 back; a case
// that stops skips its cells; the loop ends when no case runs.
struct NfKrylovCases {
  NfKrylov K;                // case 0's arrays: x0, coefficients, x (out), scratch vectors
  NfKrylov S;                // each pointer field's case stride in bytes, in the same field
  float* red;                // case 0's reduction partials (2 x NF_RED_SLOTS x NF_MAX_BLOCKS)
  const float* red_stride;   // their case stride in bytes
  const bool* active;        // the cases' active flags (null: every case runs)
  const bool* active_stride;
  int cases;
};

__device__ __forceinline__ NfKrylov nf_kry_case(const NfKrylovCases& Q, int b) {
  NfKrylov K = Q.K;
  const NfKrylov& S = Q.S;
  nf_case_shift(K.ae, S.ae, b); nf_case_shift(K.aw, S.aw, b); nf_case_shift(K.an, S.an, b);
  nf_case_shift(K.as, S.as, b); nf_case_shift(K.ap, S.ap, b); nf_case_shift(K.src, S.src, b);
  nf_case_shift(K.x0, S.x0, b); nf_case_shift(K.x, S.x, b);
  nf_case_shift(K.r, S.r, b); nf_case_shift(K.rhat, S.rhat, b); nf_case_shift(K.v, S.v, b);
  nf_case_shift(K.p, S.p, b); nf_case_shift(K.s, S.s, b); nf_case_shift(K.t, S.t, b);
  return K;
}

// Case b's partials of the next reduction (the ping-pong half C.phase).
__device__ __forceinline__ float* nf_kry_partials(const NfCoop& C, const NfKrylovCases& Q,
                                                  int b) {
  float* red = Q.red;
  nf_case_shift(red, Q.red_stride, b);
  return red + (size_t)C.phase * NF_RED_SLOTS * NF_MAX_BLOCKS;
}

// After every running case's nf_block_sum: one grid barrier, then each
// running case's N sums into its KC_SUM.. fields; ends with the block in
// step.
template <int N>
__device__ __forceinline__ void nf_kry_cases_sum(NfCoop& C, const NfKrylovCases& Q, float* sh) {
  const int B = Q.cases;
  C.grid.sync();
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int b = warp; b < B; b += n_warps) {
    if (sh[KC_RUN * B + b] == 0.f) continue;
    float sum[N];
    nf_warp_sum<N>(nf_kry_partials(C, Q, b), (int)gridDim.x, sum);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) sh[(KC_SUM + k) * B + b] = sum[k];
    }
  }
  __syncthreads();
  C.phase ^= 1;
}


// One field (K6's solves over its cluster, K7's single grid launch): every
// thread holds the scalars in registers, and each sum is the context's
// nf_reduce.
template <class Ctx>
struct NfKryOne {
  const NfKrylov& K;
  float f[KC_FIELDS];

  __device__ __forceinline__ static constexpr int cases() { return 1; }
  __device__ __forceinline__ int64_t cells() const { return (int64_t)K.ni * K.nj; }
  __device__ __forceinline__ const NfKrylov& view(int) const { return K; }
  __device__ __forceinline__ float& at(int field, int) { return f[field]; }
  __device__ __forceinline__ static bool active(int) { return true; }
  // the threads that compute a case's scalars (here every one), and the
  // barrier that publishes them (none)
  __device__ __forceinline__ static int first() { return 0; }
  __device__ __forceinline__ static int step() { return 1; }
  __device__ __forceinline__ static void publish() {}
  template <int N>
  __device__ __forceinline__ void part(Ctx& C, int, NfDS (&acc)[N]) {
    float out[N];
    nf_reduce<N>(C, acc, out);
#pragma unroll
    for (int k = 0; k < N; ++k) f[KC_SUM + k] = out[k];
  }
  template <int N>
  __device__ __forceinline__ static void sum(Ctx&) {}
};

// B fields over a cooperative grid: the scalars in the dynamic shared
// memory `sh` (KC_FIELDS x B floats), thread b computing case b's; each
// case's partials its own, summed for every case after one barrier.
struct NfKryCases {
  const NfKrylovCases& Q;
  float* sh;

  __device__ __forceinline__ int cases() const { return Q.cases; }
  __device__ __forceinline__ int64_t cells() const { return (int64_t)Q.K.ni * Q.K.nj; }
  __device__ __forceinline__ NfKrylov view(int b) const { return nf_kry_case(Q, b); }
  __device__ __forceinline__ float& at(int field, int b) { return sh[field * Q.cases + b]; }
  __device__ __forceinline__ bool active(int b) const {
    if (!Q.active) return true;
    const bool* a = Q.active;
    nf_case_shift(a, Q.active_stride, b);
    return *a;
  }
  __device__ __forceinline__ static int first() { return threadIdx.x; }
  __device__ __forceinline__ static int step() { return blockDim.x; }
  __device__ __forceinline__ static void publish() { __syncthreads(); }
  template <int N>
  __device__ __forceinline__ void part(NfCoop& C, int b, NfDS (&acc)[N]) {
    nf_block_sum<N>(acc, nf_kry_partials(C, Q, b));
    __syncthreads();
  }
  template <int N>
  __device__ __forceinline__ void sum(NfCoop& C) { nf_kry_cases_sum<N>(C, Q, sh); }
};

// The solve of every case of `q`.  Every thread of the grid (or cluster)
// calls it; it begins and ends with the grid in step.
template <class Ctx, class Cases>
__device__ inline void nf_kry_body(Ctx& C, Cases& q, float tol, int maxiter) {
  const int B = q.cases();
  const int64_t n = q.cells();
  const float eps = 1.17549435e-38f * 1e6f;  // finfo(float32).tiny * 1e6
  for (int b = q.first(); b < B; b += q.step()) q.at(KC_RUN, b) = q.active(b) ? 1.f : 0.f;
  q.publish();
  // x = mask ? x0 : 0 (a frozen case: x0 everywhere)
  for (int b = 0; b < B; ++b) {
    const auto& K = q.view(b);
    const bool on = q.at(KC_RUN, b) != 0.f;
    for (int64_t g = C.gtid; g < n; g += C.gstride) {
      const int i = (int)(g / K.nj), j = (int)(g % K.nj);
      K.x[g] = on ? (nf_kry_in(K, i, j) ? K.x0[g] : 0.f) : K.x0[g];
    }
  }
  nf_sync(C);
  for (int b = 0; b < B; ++b) {
    if (q.at(KC_RUN, b) == 0.f) continue;
    const auto& K = q.view(b);
    NfDS acc[3] = {nf_ds_zero(), nf_ds_zero(), nf_ds_zero()};
    for (int64_t g = C.gtid; g < n; g += C.gstride) {
      const int i = (int)(g / K.nj), j = (int)(g % K.nj);
      const float bb = nf_kry_in(K, i, j) ? K.src[g] : 0.f;
      const float r = bb - nf_kry_A(K, K.x, i, j, g);
      K.r[g] = r; K.rhat[g] = r; K.v[g] = 0.f; K.p[g] = 0.f;
      nf_ds_fma(acc[0], bb, bb);
      nf_ds_fma(acc[1], r, r);
      nf_ds_fma(acc[2], r, r);  // (rhat, r) with rhat = r
    }
    q.template part<3>(C, b, acc);
  }
  q.template sum<3>(C);
  for (int b = q.first(); b < B; b += q.step()) {
    if (q.at(KC_RUN, b) == 0.f) continue;
    const float bnorm = sqrtf(q.at(KC_SUM, b));
    const float tb = tol * fmaxf(bnorm, 1e-30f);
    q.at(KC_TOL2, b) = tb * tb;
    q.at(KC_RR, b) = q.at(KC_SUM + 1, b);
    q.at(KC_RHO_NEW, b) = q.at(KC_SUM + 2, b);
    q.at(KC_RHO, b) = q.at(KC_ALPHA, b) = q.at(KC_OMEGA, b) = 1.f;
    q.at(KC_OK, b) = 1.f;
  }
  q.publish();
  for (int k = 0;; ++k) {
    // the loop test of each case, and its beta
    for (int b = q.first(); b < B; b += q.step()) {
      if (q.at(KC_RUN, b) == 0.f) continue;
      if (!(q.at(KC_OK, b) != 0.f && k < maxiter && q.at(KC_RR, b) > q.at(KC_TOL2, b))) {
        q.at(KC_RUN, b) = 0.f;
        continue;
      }
      const float rho = q.at(KC_RHO, b), omega = q.at(KC_OMEGA, b);
      const bool good = fabsf(rho) > eps && fabsf(omega) > eps;
      q.at(KC_GOOD, b) = good ? 1.f : 0.f;
      q.at(KC_BETA, b) = good ? (q.at(KC_RHO_NEW, b) / (rho == 0.f ? 1.f : rho)) *
                                    (q.at(KC_ALPHA, b) / (omega == 0.f ? 1.f : omega))
                              : 0.f;
    }
    q.publish();
    bool any = false;
    for (int b = 0; b < B; ++b) any = any || q.at(KC_RUN, b) != 0.f;
    if (!any) break;
    for (int b = 0; b < B; ++b) {
      if (q.at(KC_RUN, b) == 0.f) continue;
      const auto& K = q.view(b);
      const float beta = q.at(KC_BETA, b), omega = q.at(KC_OMEGA, b);
      for (int64_t g = C.gtid; g < n; g += C.gstride)
        K.p[g] = K.r[g] + beta * (K.p[g] - omega * K.v[g]);
    }
    nf_sync(C);
    for (int b = 0; b < B; ++b) {
      if (q.at(KC_RUN, b) == 0.f) continue;
      const auto& K = q.view(b);
      NfDS acc[1] = {nf_ds_zero()};
      for (int64_t g = C.gtid; g < n; g += C.gstride) {
        const float vv = nf_kry_A(K, K.p, (int)(g / K.nj), (int)(g % K.nj), g);
        K.v[g] = vv;
        nf_ds_fma(acc[0], K.rhat[g], vv);
      }
      q.template part<1>(C, b, acc);
    }
    q.template sum<1>(C);
    for (int b = q.first(); b < B; b += q.step()) {
      if (q.at(KC_RUN, b) == 0.f) continue;
      const float dn = q.at(KC_SUM, b);
      const bool good = q.at(KC_GOOD, b) != 0.f && fabsf(dn) > eps;
      q.at(KC_GOOD, b) = good ? 1.f : 0.f;
      q.at(KC_ALPHA, b) = good ? q.at(KC_RHO_NEW, b) / (dn == 0.f ? 1.f : dn) : 0.f;
    }
    q.publish();
    for (int b = 0; b < B; ++b) {
      if (q.at(KC_RUN, b) == 0.f) continue;
      const auto& K = q.view(b);
      const float alpha = q.at(KC_ALPHA, b);
      for (int64_t g = C.gtid; g < n; g += C.gstride) K.s[g] = K.r[g] - alpha * K.v[g];
    }
    nf_sync(C);
    for (int b = 0; b < B; ++b) {
      if (q.at(KC_RUN, b) == 0.f) continue;
      const auto& K = q.view(b);
      NfDS acc[2] = {nf_ds_zero(), nf_ds_zero()};
      for (int64_t g = C.gtid; g < n; g += C.gstride) {
        const float tv = nf_kry_A(K, K.s, (int)(g / K.nj), (int)(g % K.nj), g);
        K.t[g] = tv;
        nf_ds_fma(acc[0], tv, tv);
        nf_ds_fma(acc[1], tv, K.s[g]);
      }
      q.template part<2>(C, b, acc);
    }
    q.template sum<2>(C);
    for (int b = q.first(); b < B; b += q.step()) {
      if (q.at(KC_RUN, b) == 0.f) continue;
      const float tt = q.at(KC_SUM, b);
      q.at(KC_OMEGA, b) = tt > eps ? q.at(KC_SUM + 1, b) / (tt == 0.f ? 1.f : tt) : 0.f;
    }
    q.publish();
    for (int b = 0; b < B; ++b) {
      if (q.at(KC_RUN, b) == 0.f) continue;
      const auto& K = q.view(b);
      const float alpha = q.at(KC_ALPHA, b), omega = q.at(KC_OMEGA, b);
      NfDS acc[2] = {nf_ds_zero(), nf_ds_zero()};
      for (int64_t g = C.gtid; g < n; g += C.gstride) {
        K.x[g] = K.x[g] + alpha * K.p[g] + omega * K.s[g];
        const float r = K.s[g] - omega * K.t[g];
        K.r[g] = r;
        nf_ds_fma(acc[0], r, r);
        nf_ds_fma(acc[1], K.rhat[g], r);
      }
      q.template part<2>(C, b, acc);
    }
    q.template sum<2>(C);
    for (int b = q.first(); b < B; b += q.step()) {
      if (q.at(KC_RUN, b) == 0.f) continue;
      q.at(KC_RR, b) = q.at(KC_SUM, b);
      q.at(KC_RHO, b) = q.at(KC_RHO_NEW, b);
      q.at(KC_RHO_NEW, b) = q.at(KC_SUM + 1, b);
      q.at(KC_OK, b) = q.at(KC_GOOD, b);
    }
    q.publish();
  }
  // x0 off the mask (a frozen case holds x0 everywhere already)
  for (int b = 0; b < B; ++b) {
    const auto& K = q.view(b);
    for (int64_t g = C.gtid; g < n; g += C.gstride) {
      const int i = (int)(g / K.nj), j = (int)(g % K.nj);
      if (!nf_kry_in(K, i, j)) K.x[g] = K.x0[g];
    }
  }
  nf_sync(C);
}

// One field's solve; writes K.x (mask ? x : x0).
template <class Ctx>
__device__ inline void nf_bicgstab_solve(Ctx& C, const NfKrylov& K, float tol, int maxiter) {
  NfKryOne<Ctx> q{K, {}};
  nf_kry_body(C, q, tol, maxiter);
}

// Every case's solve; `sh` is the dynamic shared memory.
__device__ inline void nf_bicgstab_solve_cases(NfCoop& C, const NfKrylovCases& Q, float tol,
                                               int maxiter, float* sh) {
  NfKryCases q{Q, sh};
  nf_kry_body(C, q, tol, maxiter);
}
