// K3, K4, K5: the multigrid kernels over a whole level hierarchy, each one
// cooperative launch over the device code of mg.cuh.
//
// K3 nf_fused_vcycle    one V-cycle; replaces
//                       naviflow_tpu/ops/pallas_mg.py:fused_vcycle.
// K4 nf_galerkin_levels every Galerkin coarse stencil of a vertex
//                       hierarchy; replaces pallas_mg.py:galerkin_levels_pallas.
// K5 nf_fused_mg_solve  the whole solve: cycles, compensated convergence
//                       checks, mean normalisation and residual; replaces
//                       pallas_mg.py:fused_mg_solve.
//
// Bound on the H100: a hierarchy the gate admits (<= 255^2 for K4/K5, the
// 256^2 -> 4^2 tail for K3) holds at most ~8 MB, so it lives in the 50 MB
// L2 and the kernels are bound by their dependent passes (one per colour,
// residual, transfer and RAP level) and the grid-wide barriers between
// them, not by HBM.  Design (coop.cuh): as many blocks as fit at once,
// grid-stride passes ending in grid.sync(), levels of <= 1,024 cells in
// block 0 alone, so the coarsest sweeps cost no grid barriers; the
// convergence scalars of K5 come from nf_grid_reduce, identical in every
// block, so every block takes the same number of cycles.  Level 0's iterate
// is the output buffer; coarser iterates and right-hand sides are scratch
// from the wrapper.

#include "mg.cuh"

namespace {

__global__ void __launch_bounds__(NF_THREADS) vcycle_kernel(NfMG M) {
  NfCoop C = nf_coop(nullptr);
  nf_vcycle(C, M);
}

struct SolveParams {
  NfMG M;
  float* r;
  int* cycles;
  float* rel;
  float* red;
  int max_cycles, check_every, mean_normalize;
  float tol;
};

__global__ void __launch_bounds__(NF_THREADS) mg_solve_kernel(SolveParams P) {
  NfCoop C = nf_coop(P.red);
  nf_mg_solve(C, P.M, P.r, P.max_cycles, P.check_every, P.tol, P.mean_normalize != 0, P.cycles,
              P.rel);
}

struct RapParams {
  NfLevel lv[NF_MAX_LEVELS];
  int L;
};

__global__ void __launch_bounds__(NF_THREADS) rap_kernel(RapParams P) {
  NfCoop C = nf_coop(nullptr);
  nf_galerkin_rap(C, P.lv, P.L);
}

// `n` grid-wide barriers and nothing else: the unit of the K3-K7 bound.
__global__ void __launch_bounds__(NF_THREADS) sync_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// Per level: 9 stencil pointers (0 for absent corners), x, rhs; ni, nj, five.
int read_levels(NfMG& M, const long long* ptrs, const int* ip, int L) {
  if (L < 1 || L > NF_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  M.L = L;
  for (int l = 0; l < L; ++l) {
    NfLevel& lv = M.lv[l];
    for (int k = 0; k < 9; ++k) lv.st[k] = reinterpret_cast<const float*>(ptrs[11 * l + k]);
    lv.x = reinterpret_cast<float*>(ptrs[11 * l + 9]);
    lv.rhs = reinterpret_cast<const float*>(ptrs[11 * l + 10]);
    lv.ni = ip[3 * l]; lv.nj = ip[3 * l + 1]; lv.five = ip[3 * l + 2];
  }
  return 0;
}

}  // namespace

// ptrs: per level, 9 stencil pointers, x, rhs (level 0: x = output already
//       holding p, rhs = b)
// ip:   L, pre, post, coarsest, then per level ni, nj, five
// fp:   omega
NF_EXPORT int nf_fused_vcycle(const long long* ptrs, const int* ip, const float* fp,
                              void* stream) {
  NfMG M = {};
  int err = read_levels(M, ptrs, ip + 4, ip[0]);
  if (err) return err;
  M.pre = ip[1]; M.post = ip[2]; M.coarsest = ip[3]; M.omega = fp[0];
  return nf_coop_launch(vcycle_kernel, M, (int64_t)M.lv[0].ni * M.lv[0].nj,
                        (cudaStream_t)stream);
}

// ptrs: per level 11 pointers as nf_fused_vcycle, then r, cycles (int32),
//       rel, reduction scratch
// ip:   L, pre, post, coarsest, max_cycles, check_every, mean_normalize,
//       then per level ni, nj, five
// fp:   omega, tolerance
NF_EXPORT int nf_fused_mg_solve(const long long* ptrs, const int* ip, const float* fp,
                                void* stream) {
  SolveParams P = {};
  const int L = ip[0];
  int err = read_levels(P.M, ptrs, ip + 7, L);
  if (err) return err;
  P.M.pre = ip[1]; P.M.post = ip[2]; P.M.coarsest = ip[3]; P.M.omega = fp[0];
  P.max_cycles = ip[4]; P.check_every = ip[5]; P.mean_normalize = ip[6];
  if (P.check_every < 1) return (int)cudaErrorInvalidValue;
  P.tol = fp[1];
  P.r = reinterpret_cast<float*>(ptrs[11 * L]);
  P.cycles = reinterpret_cast<int*>(ptrs[11 * L + 1]);
  P.rel = reinterpret_cast<float*>(ptrs[11 * L + 2]);
  P.red = reinterpret_cast<float*>(ptrs[11 * L + 3]);
  return nf_coop_launch(mg_solve_kernel, P, (int64_t)P.M.lv[0].ni * P.M.lv[0].nj,
                        (cudaStream_t)stream);
}

// ptrs: the fine stencil (9 pointers, 0 for absent corners), then 9 output
//       arrays per coarse level
// ip:   L (levels, fine included), fine_five, then per level ni, nj
NF_EXPORT int nf_galerkin_levels(const long long* ptrs, const int* ip, const float* fp,
                                 void* stream) {
  (void)fp;
  RapParams P = {};
  P.L = ip[0];
  if (P.L < 2 || P.L > NF_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  int64_t cells = 0;
  for (int l = 0; l < P.L; ++l) {
    NfLevel& lv = P.lv[l];
    for (int k = 0; k < 9; ++k) lv.st[k] = reinterpret_cast<const float*>(ptrs[9 * l + k]);
    lv.ni = ip[2 + 2 * l]; lv.nj = ip[3 + 2 * l];
    lv.five = l == 0 ? ip[1] : 0;
    if (l == 1) cells = (int64_t)lv.ni * lv.nj;
  }
  return nf_coop_launch(rap_kernel, P, cells, (cudaStream_t)stream);
}

// A measurement aid, not a kernel of the solver: `syncs` grid-wide barriers
// in one cooperative launch sized, as the kernels above, for `cells` cells.
// ip: cells, syncs
NF_EXPORT int nf_grid_sync_probe(const long long* ptrs, const int* ip, const float* fp,
                                 void* stream) {
  (void)ptrs;
  (void)fp;
  int syncs = ip[1];
  return nf_coop_launch(sync_probe_kernel, syncs, (int64_t)ip[0], (cudaStream_t)stream);
}
