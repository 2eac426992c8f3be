// K7: the whole masked BiCGSTAB of one momentum field, in one cooperative
// launch.  Replaces naviflow_tpu/ops/pallas_krylov.py:bicgstab_momentum_pallas
// (its kernel body _mk_kernel); the device solve is krylov.cuh's.
//
// Bound on the H100: a field the gate admits is at most 1 MiB (<= 511^2),
// so the system and the Krylov vectors live in L2; each iteration is five
// dependent passes with a grid barrier after each (three of them grid
// reductions), so the kernel is bound by barrier latency, not by bytes or
// flops.  Design: coop.cuh's cooperative launch; every dot a compensated
// per-block partial, one barrier, then every block combines all partials
// in the same order, so the stopping test and the breakdown guards agree in
// every block.

#include "krylov.cuh"

namespace {

struct KrylovParams {
  NfKrylov K;
  float* red;
  float tol;
  int maxiter;
};

__global__ void __launch_bounds__(NF_THREADS) bicgstab_kernel(KrylovParams P) {
  NfCoop C = nf_coop(P.red);
  nf_bicgstab_solve(C, P.K, P.tol, P.maxiter);
}

}  // namespace

// ptrs: x0, a_e, a_w, a_n, a_s, a_p, src, out, scratch (6 arrays of ni x nj,
//       contiguous: r, rhat, v, p, s, t), reduction scratch
// ip:   ni, nj, maxiter, lo_i, hi_i, lo_j, hi_j
// fp:   tol
NF_EXPORT int nf_bicgstab(const long long* ptrs, const int* ip, const float* fp, void* stream) {
  KrylovParams P = {};
  NfKrylov& K = P.K;
  K.x0 = reinterpret_cast<const float*>(ptrs[0]);
  K.ae = reinterpret_cast<const float*>(ptrs[1]);
  K.aw = reinterpret_cast<const float*>(ptrs[2]);
  K.an = reinterpret_cast<const float*>(ptrs[3]);
  K.as = reinterpret_cast<const float*>(ptrs[4]);
  K.ap = reinterpret_cast<const float*>(ptrs[5]);
  K.src = reinterpret_cast<const float*>(ptrs[6]);
  K.x = reinterpret_cast<float*>(ptrs[7]);
  K.ni = ip[0]; K.nj = ip[1];
  const int64_t n = (int64_t)K.ni * K.nj;
  float* scratch = reinterpret_cast<float*>(ptrs[8]);
  float** vecs[] = {&K.r, &K.rhat, &K.v, &K.p, &K.s, &K.t};
  for (int k = 0; k < 6; ++k) *vecs[k] = scratch + k * n;
  P.red = reinterpret_cast<float*>(ptrs[9]);
  P.maxiter = ip[2];
  K.lo_i = ip[3]; K.hi_i = ip[4]; K.lo_j = ip[5]; K.hi_j = ip[6];
  P.tol = fp[0];
  return nf_coop_launch(bicgstab_kernel, P, n, (cudaStream_t)stream);
}
