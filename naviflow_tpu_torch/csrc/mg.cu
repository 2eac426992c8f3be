// K3, K4, K5: the multigrid kernels over a whole level hierarchy, each one
// launch.
//
// K3 nf_fused_vcycle    one V-cycle, in one thread-block cluster over the
//                       device code of vcycle.cuh (its header says how);
//                       replaces naviflow_tpu/ops/pallas_mg.py:fused_vcycle.
// K4 nf_galerkin_levels every Galerkin coarse stencil of a vertex
//                       hierarchy; replaces pallas_mg.py:galerkin_levels_pallas.
// K5 nf_fused_mg_solve  the whole solve: cycles, compensated convergence
//                       checks, mean normalisation and residual; replaces
//                       pallas_mg.py:fused_mg_solve.
//
// Bound on the H100: a hierarchy the gate admits (<= 255^2 for K4/K5, the
// 256^2 -> 4^2 tail for K3) holds at most ~8 MB, so it lives in the 50 MB
// L2 and the kernels are bound by their dependent passes (one per colour,
// residual, transfer and RAP level) and the barriers between them, not by
// HBM.  K4 and K5 (coop.cuh): cooperative launches of as many blocks as fit
// at once, grid-stride passes ending in grid.sync(), levels of <= 1,024
// cells in block 0 alone, so the coarsest sweeps cost no grid barriers; the
// convergence scalars of K5 come from nf_grid_reduce, identical in every
// block, so every block takes the same number of cycles.  Level 0's iterate
// is the output buffer; coarser iterates and right-hand sides of the levels
// in global memory are scratch from the wrapper.

#include "vcycle.cuh"

namespace {

// K3: one V-cycle in one thread-block cluster (vcycle.cuh); PH adds the
// phase timers (nf_fused_vcycle_phases, a measurement aid).
struct VcParams {
  NfMG M;
  const float* p_in;
  unsigned long long* ph;
  int Ls;
};

template <bool PH>
__global__ void __launch_bounds__(NF_CL_THREADS, 1) vcycle_kernel(VcParams P) {
  extern __shared__ __align__(16) float vc_dyn[];
  nf_vc_cycle<PH>(P.M, P.Ls, P.p_in, vc_dyn, P.ph);
}

template <bool PH>
NfClusterCfg& vcycle_cfg() {
  static NfClusterCfg cfg = {};
  return cfg;
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

// `n` grid-wide barriers and nothing else: the unit of K4's, K5's and K7's
// bound.
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

// ptrs: per level 11 pointers (9 stencil pointers, 0 for absent corners;
//       x, rhs: level 0's output and b, 0 for the levels in shared memory,
//       scratch for the other coarse levels), then the input iterate p,
//       then (PH) the timer buffer
// ip:   NfVcIp: L, pre, post, coarsest, Ls (the first level in shared
//       memory: the first below level 0 of <= NF_SMALL_CELLS cells, L if
//       none), then per level ni, nj, five
// fp:   omega
template <bool PH>
int launch_vcycle(const long long* ptrs, const int* ip, const float* fp, void* stream) {
  VcParams P = {};
  const int L = ip[VC_IP_L];
  int err = read_levels(P.M, ptrs, ip + VC_IP_LEVELS, L);
  if (err) return err;
  P.M.pre = ip[VC_IP_PRE]; P.M.post = ip[VC_IP_POST]; P.M.coarsest = ip[VC_IP_COARSEST];
  P.M.omega = fp[0];
  int cells[NF_MAX_LEVELS], Ls = L;
  for (int l = 0; l < L; ++l) cells[l] = P.M.lv[l].ni * P.M.lv[l].nj;
  for (int l = L - 1; l >= 1 && cells[l] <= NF_SMALL_CELLS; --l) Ls = l;
  if (ip[VC_IP_LS] != Ls) return (int)cudaErrorInvalidValue;
  P.Ls = Ls;
  P.p_in = reinterpret_cast<const float*>(ptrs[11 * L]);
  P.ph = PH ? reinterpret_cast<unsigned long long*>(ptrs[11 * L + 1]) : nullptr;
  const size_t smem = sizeof(float) * (size_t)nf_vc_smem_floats(cells, L, Ls);
  int size = 0;
  err = nf_cluster_size(vcycle_kernel<PH>, vcycle_cfg<PH>(), size);
  if (err) return err;
  return nf_cluster_launch(vcycle_kernel<PH>, size, P, smem, (cudaStream_t)stream);
}

NF_EXPORT int nf_fused_vcycle(const long long* ptrs, const int* ip, const float* fp,
                              void* stream) {
  return launch_vcycle<false>(ptrs, ip, fp, stream);
}

// The cluster size K3 launches with on the current device (its untimed or
// timed instantiation; chosen at the first launch or here), into *size.
NF_EXPORT int nf_vcycle_cluster_size(int timed, int* size) {
  return timed ? nf_cluster_size(vcycle_kernel<true>, vcycle_cfg<true>(), *size)
               : nf_cluster_size(vcycle_kernel<false>, vcycle_cfg<false>(), *size);
}

NF_EXPORT int nf_fused_vcycle_phases(const long long* ptrs, const int* ip, const float* fp,
                                     void* stream) {
  return launch_vcycle<true>(ptrs, ip, fp, stream);
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
