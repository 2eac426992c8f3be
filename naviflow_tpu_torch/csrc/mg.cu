// K3, K4, K5: the multigrid kernels over a whole level hierarchy, each one
// launch of one thread-block cluster.
//
// K3 nf_fused_vcycle    one V-cycle over the device code of vcycle.cuh (its
//                       header says how); replaces
//                       naviflow_tpu/ops/pallas_mg.py:fused_vcycle.
// K4 nf_galerkin_levels every Galerkin coarse stencil of a vertex
//                       hierarchy, cluster.cuh's RAP (K6's); replaces
//                       pallas_mg.py:galerkin_levels_pallas.
// K5 nf_fused_mg_solve  the whole solve: cycles, compensated convergence
//                       checks, mean normalisation and residual, on K3's
//                       cycle (vcycle.cuh's nf_vc_mg_solve); replaces
//                       pallas_mg.py:fused_mg_solve.
//
// Bound on the H100: a hierarchy the gate admits (<= 255^2 vertex, 256^2
// cell-centred for K4/K5, the 256^2 -> 4^2 tail for K3) holds at most
// ~8 MB, so it lives in the 50 MB L2 and the kernels are bound by their
// dependent passes (one per colour, residual, transfer and RAP level) and
// the barriers between them, not by HBM.  Each is one cluster of 16 CTAs
// (8 where 16 do not fit) with hardware cluster barriers (0.71 us) between
// the passes.  K3 and K5 keep the levels of <= 1,024 cells in rank 0's
// shared memory and the coarsest in one warp's registers; level 0's
// iterate is the output buffer, the iterates and right-hand sides of the
// coarse levels in global memory are scratch from the wrapper.  K4 spreads
// each coarse level's (cell, offset) entries over the whole cluster, with
// no branch at a tap, and ends each level in one cluster barrier: (L - 1)
// barriers.  The cooperative launch it replaced ran every level of <= 1,024
// cells in one block of 256 threads, with two branching weight lookups a
// tap, about 250x its barrier bound at 63^2.
//
// The case axis of K5, K4 and K3 (nf_fused_mg_solve_batched,
// nf_galerkin_levels_batched, nf_fused_vcycle_batched; the batching rules of
// ops/mg.py, the vmapped lockstep step of algorithms/batch.py): a grid of
// (cluster size, B), case b = blockIdx.y, at the single launch's cluster
// size.  Thread 0 of each
// CTA moves every pointer of the case-0 parameters by b times its slot's
// case stride into a shared-memory copy (each case its own stencils, its
// own global coarse-level scratch, its own outputs), and the single
// launch's device code runs on that view: the same reductions in the same
// order, so each case's bits are its single launch's whatever B is.  A
// frozen case (active flag false) writes its frozen outputs (K5: p0, a zero
// residual, 0 cycles and rel 0; K4: zero stencils; K3: p_in) and leaves before the
// first cluster barrier, every CTA of its cluster alike.  B above the
// clusters the card holds at once runs in waves.

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

// K5: the whole solve in one thread-block cluster (vcycle.cuh).
struct SolveParams {
  NfMG M;
  const float* p_in;
  float* r;
  int* cycles;
  float* rel;
  int Ls, max_cycles, check_every, mean_normalize;
  float tol;
};

__global__ void __launch_bounds__(NF_CL_THREADS, 1) mg_solve_kernel(SolveParams P) {
  extern __shared__ __align__(16) float ms_dyn[];
  nf_vc_mg_solve(P.M, P.Ls, P.p_in, P.r, P.max_cycles, P.check_every, P.tol,
                 P.mean_normalize != 0, P.cycles, P.rel, ms_dyn);
}

NfClusterCfg& mg_solve_cfg() {
  static NfClusterCfg cfg = {};
  return cfg;
}

// Case b's view of K5's or K4's level pointers: each moved by its stride.
__device__ void levels_case(NfLevel* lv, const NfLevel* S, int L, int b) {
  for (int l = 0; l < L; ++l) {
    for (int a = 0; a < 9; ++a) nf_case_shift(lv[l].st[a], S[l].st[a], b);
    nf_case_shift(lv[l].x, S[l].x, b);
    nf_case_shift(lv[l].rhs, S[l].rhs, b);
  }
}

// B solves: case 0's parameters, their case strides (the same fields),
// the active flags and their stride.
struct SolveBatch {
  SolveParams P, S;
  const bool* active;
  const bool* active_stride;
};

__global__ void __launch_bounds__(NF_CL_THREADS, 1) mg_solve_kernel_batched(SolveBatch SB) {
  extern __shared__ __align__(16) float ms_dyn[];
  __shared__ SolveParams P;  // this case's view
  __shared__ bool on;
  const int b = (int)blockIdx.y;
  if (threadIdx.x == 0) {
    P = SB.P;
    levels_case(P.M.lv, SB.S.M.lv, P.M.L, b);
    nf_case_shift(P.p_in, SB.S.p_in, b);
    nf_case_shift(P.r, SB.S.r, b);
    nf_case_shift(P.cycles, SB.S.cycles, b);
    nf_case_shift(P.rel, SB.S.rel, b);
    const bool* active = SB.active;
    nf_case_shift(active, SB.active_stride, b);
    on = *active;
  }
  __syncthreads();
  if (!on) {  // frozen: p0, a zero residual, 0 cycles, rel 0; no cluster barrier
    NfCluster C = nf_cluster(nullptr);
    const NfLevel& F = P.M.lv[0];
    const int64_t n = (int64_t)F.ni * F.nj;
    for (int64_t g = C.gtid; g < n; g += C.gstride) {
      F.x[g] = P.p_in[g];
      P.r[g] = 0.f;
    }
    if (C.gtid == 0) {
      *P.cycles = 0;
      *P.rel = 0.f;
    }
    return;
  }
  nf_vc_mg_solve(P.M, P.Ls, P.p_in, P.r, P.max_cycles, P.check_every, P.tol,
                 P.mean_normalize != 0, P.cycles, P.rel, ms_dyn);
}

NfClusterCfg& mg_solve_batch_cfg() {
  static NfClusterCfg cfg = {};
  return cfg;
}

// B V-cycles (K3's case axis): case 0's parameters, their case strides (the
// same fields), the active flags and their stride.
struct VcBatch {
  VcParams P, S;
  const bool* active;
  const bool* active_stride;
};

__global__ void __launch_bounds__(NF_CL_THREADS, 1) vcycle_kernel_batched(VcBatch SB) {
  extern __shared__ __align__(16) float vc_dyn[];
  __shared__ VcParams P;  // this case's view
  __shared__ bool on;
  const int b = (int)blockIdx.y;
  if (threadIdx.x == 0) {
    P = SB.P;
    levels_case(P.M.lv, SB.S.M.lv, P.M.L, b);
    nf_case_shift(P.p_in, SB.S.p_in, b);
    const bool* active = SB.active;
    nf_case_shift(active, SB.active_stride, b);
    on = *active;
  }
  __syncthreads();
  if (!on) {  // frozen: the input iterate; no cluster barrier
    NfCluster C = nf_cluster(nullptr);
    const NfLevel& F = P.M.lv[0];
    const int64_t n = (int64_t)F.ni * F.nj;
    for (int64_t g = C.gtid; g < n; g += C.gstride) F.x[g] = P.p_in[g];
    return;
  }
  nf_vc_cycle<false>(P.M, P.Ls, P.p_in, vc_dyn, nullptr);
}

NfClusterCfg& vcycle_batch_cfg() {
  static NfClusterCfg cfg = {};
  return cfg;
}

// K4: every coarse level's entries over the cluster, one barrier a level.
struct RapParams {
  NfLevel lv[NF_MAX_LEVELS];
  int L;
};

__global__ void __launch_bounds__(NF_CL_THREADS, 1) galerkin_kernel(RapParams P) {
  NfCluster C = nf_cluster(nullptr);
  nf_cl_galerkin_rap(C, P.lv, P.L);
}

NfClusterCfg& galerkin_cfg() {
  static NfClusterCfg cfg = {};
  return cfg;
}

// B hierarchies: case 0's levels, their case strides, the active flags.
struct RapBatch {
  RapParams P, S;
  const bool* active;
  const bool* active_stride;
};

__global__ void __launch_bounds__(NF_CL_THREADS, 1) galerkin_kernel_batched(RapBatch SB) {
  __shared__ RapParams P;  // this case's view
  __shared__ bool on;
  const int b = (int)blockIdx.y;
  if (threadIdx.x == 0) {
    P = SB.P;
    levels_case(P.lv, SB.S.lv, P.L, b);
    const bool* active = SB.active;
    nf_case_shift(active, SB.active_stride, b);
    on = *active;
  }
  __syncthreads();
  NfCluster C = nf_cluster(nullptr);
  if (!on) {  // frozen: zero stencils, no cluster barrier
    for (int l = 1; l < P.L; ++l) {
      const int64_t n = (int64_t)P.lv[l].ni * P.lv[l].nj;
      for (int a = 0; a < 9; ++a) {
        float* out = const_cast<float*>(P.lv[l].st[a]);
        for (int64_t g = C.gtid; g < n; g += C.gstride) out[g] = 0.f;
      }
    }
    return;
  }
  nf_cl_galerkin_rap(C, P.lv, P.L);
}

NfClusterCfg& galerkin_batch_cfg() {
  static NfClusterCfg cfg = {};
  return cfg;
}

// `n` grid-wide barriers and nothing else: the unit of the bound of K7's
// cooperative kernel (krylov.cu).
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

// The cycle parameters of K3's and K5's launches (NfVcIp; fp[0] omega) for
// the levels read_levels read into M; the first level in shared memory,
// checked against ip's, into *Ls, and the floats those levels take into
// *small.
int read_cycle(NfMG& M, const int* ip, const float* fp, int* Ls, int64_t* small) {
  const int L = M.L;
  M.pre = ip[VC_IP_PRE]; M.post = ip[VC_IP_POST]; M.coarsest = ip[VC_IP_COARSEST];
  M.omega = fp[0];
  int cells[NF_MAX_LEVELS];
  *Ls = L;
  for (int l = 0; l < L; ++l) cells[l] = M.lv[l].ni * M.lv[l].nj;
  for (int l = L - 1; l >= 1 && cells[l] <= NF_SMALL_CELLS; --l) *Ls = l;
  if (ip[VC_IP_LS] != *Ls) return (int)cudaErrorInvalidValue;
  *small = nf_vc_smem_floats(cells, L, *Ls);
  return 0;
}

// K5's parameters from nf_fused_mg_solve's slots, ip and fp (the batched
// entry: case 0's, and its strides); the dynamic shared memory's bytes
// into *smem.
int read_solve(SolveParams& P, const long long* ptrs, const int* ip, const float* fp,
               size_t* smem) {
  const int L = ip[VC_IP_L];
  int64_t small = 0;
  int err = read_levels(P.M, ptrs, ip + MS_IP_LEVELS, L);
  if (!err) err = read_cycle(P.M, ip, fp, &P.Ls, &small);
  if (err) return err;
  P.max_cycles = ip[MS_IP_MAX_CYCLES];
  P.check_every = ip[MS_IP_CHECK_EVERY];
  P.mean_normalize = ip[MS_IP_MEAN];
  if (P.check_every < 1) return (int)cudaErrorInvalidValue;
  P.tol = fp[1];
  P.p_in = reinterpret_cast<const float*>(ptrs[11 * L]);
  P.r = reinterpret_cast<float*>(ptrs[11 * L + 1]);
  P.cycles = reinterpret_cast<int*>(ptrs[11 * L + 2]);
  P.rel = reinterpret_cast<float*>(ptrs[11 * L + 3]);
  *smem = sizeof(float) * (size_t)(NF_CL_RED_FLOATS + small);
  return 0;
}

// K4's levels from nf_galerkin_levels' slots and ip (the batched entry:
// case 0's, and its strides).
int read_rap(RapParams& P, const long long* ptrs, const int* ip) {
  P.L = ip[0];
  if (P.L < 2 || P.L > NF_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < P.L; ++l) {
    NfLevel& lv = P.lv[l];
    for (int k = 0; k < 9; ++k) lv.st[k] = reinterpret_cast<const float*>(ptrs[9 * l + k]);
    lv.ni = ip[2 + 2 * l]; lv.nj = ip[3 + 2 * l];
    lv.five = l == 0 ? ip[1] : 0;
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
  int64_t small = 0;
  int err = read_levels(P.M, ptrs, ip + VC_IP_LEVELS, L);
  if (!err) err = read_cycle(P.M, ip, fp, &P.Ls, &small);
  if (err) return err;
  P.p_in = reinterpret_cast<const float*>(ptrs[11 * L]);
  P.ph = PH ? reinterpret_cast<unsigned long long*>(ptrs[11 * L + 1]) : nullptr;
  const size_t smem = sizeof(float) * (size_t)small;
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

// B V-cycles of one hierarchy layout in one launch, one cluster a case.
// ptrs: nf_fused_vcycle's 11 L + 1 slots for case 0, the cases' active
//       flags (bool), then each of these 11 L + 2 slots' case stride in
//       bytes, in the same order (0 for a null slot, or one array shared by
//       every case)
// ip:   nf_fused_vcycle's, then B
// fp:   omega
NF_EXPORT int nf_fused_vcycle_batched(const long long* ptrs, const int* ip, const float* fp,
                                      void* stream) {
  VcBatch SB = {};
  const int L = ip[VC_IP_L];
  if (L < 1 || L > NF_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const int half = 11 * L + 2;
  int64_t small = 0, unused = 0;
  int err = read_levels(SB.P.M, ptrs, ip + VC_IP_LEVELS, L);
  if (!err) err = read_cycle(SB.P.M, ip, fp, &SB.P.Ls, &small);
  if (!err) err = read_levels(SB.S.M, ptrs + half, ip + VC_IP_LEVELS, L);
  if (!err) err = read_cycle(SB.S.M, ip, fp, &SB.S.Ls, &unused);
  if (err) return err;
  SB.P.p_in = reinterpret_cast<const float*>(ptrs[11 * L]);
  SB.S.p_in = reinterpret_cast<const float*>(ptrs[half + 11 * L]);
  SB.active = reinterpret_cast<const bool*>(ptrs[half - 1]);
  SB.active_stride = reinterpret_cast<const bool*>(ptrs[2 * half - 1]);
  const int cases = ip[VC_IP_LEVELS + 3 * L];
  if (!SB.active) return (int)cudaErrorInvalidValue;
  int size = 0, bsize = 0;
  err = nf_cluster_size(vcycle_kernel<false>, vcycle_cfg<false>(), size);
  if (!err) err = nf_cluster_size(vcycle_kernel_batched, vcycle_batch_cfg(), bsize, size);
  if (err) return err;
  if (bsize != size) return (int)cudaErrorLaunchOutOfResources;
  return nf_cluster_launch(vcycle_kernel_batched, size, SB, sizeof(float) * (size_t)small,
                           (cudaStream_t)stream, cases);
}

// ptrs: per level 11 pointers as nf_fused_vcycle (level 0's x: the output
//       p), then the input iterate p0, r, cycles (int32), rel
// ip:   NfMsIp: NfVcIp's five, then max_cycles, check_every,
//       mean_normalize, then per level ni, nj, five
// fp:   omega, tolerance
NF_EXPORT int nf_fused_mg_solve(const long long* ptrs, const int* ip, const float* fp,
                                void* stream) {
  SolveParams P = {};
  size_t smem = 0;
  int err = read_solve(P, ptrs, ip, fp, &smem);
  if (err) return err;
  int size = 0;
  err = nf_cluster_size(mg_solve_kernel, mg_solve_cfg(), size);
  if (err) return err;
  return nf_cluster_launch(mg_solve_kernel, size, P, smem, (cudaStream_t)stream);
}

// B solves of one hierarchy layout in one launch, one cluster a case.
// ptrs: nf_fused_mg_solve's 11 L + 4 slots for case 0, the cases' active
//       flags (bool), then each of these 11 L + 5 slots' case stride in
//       bytes, in the same order (0 for a null slot, or one array shared by
//       every case)
// ip:   nf_fused_mg_solve's, then B
// fp:   omega, tolerance
NF_EXPORT int nf_fused_mg_solve_batched(const long long* ptrs, const int* ip, const float* fp,
                                        void* stream) {
  SolveBatch SB = {};
  const int L = ip[VC_IP_L];
  if (L < 1 || L > NF_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const int half = 11 * L + 5;
  size_t smem = 0, unused = 0;
  int err = read_solve(SB.P, ptrs, ip, fp, &smem);
  if (!err) err = read_solve(SB.S, ptrs + half, ip, fp, &unused);
  if (err) return err;
  SB.active = reinterpret_cast<const bool*>(ptrs[half - 1]);
  SB.active_stride = reinterpret_cast<const bool*>(ptrs[2 * half - 1]);
  const int cases = ip[MS_IP_LEVELS + 3 * L];
  if (!SB.active) return (int)cudaErrorInvalidValue;
  int size = 0, bsize = 0;
  err = nf_cluster_size(mg_solve_kernel, mg_solve_cfg(), size);
  if (!err) err = nf_cluster_size(mg_solve_kernel_batched, mg_solve_batch_cfg(), bsize, size);
  if (err) return err;
  if (bsize != size) return (int)cudaErrorLaunchOutOfResources;
  return nf_cluster_launch(mg_solve_kernel_batched, size, SB, smem, (cudaStream_t)stream,
                           cases);
}

// The cluster size K5 launches with on the current device, into *size.
NF_EXPORT int nf_mg_solve_cluster_size(int* size) {
  return nf_cluster_size(mg_solve_kernel, mg_solve_cfg(), *size);
}

// ptrs: the fine stencil (9 pointers, 0 for absent corners), then 9 output
//       arrays per coarse level (c, e, w, n, s, ne, nw, se, sw)
// ip:   L (levels, fine included), fine_five, then per level ni, nj
NF_EXPORT int nf_galerkin_levels(const long long* ptrs, const int* ip, const float* fp,
                                 void* stream) {
  (void)fp;
  RapParams P = {};
  int err = read_rap(P, ptrs, ip);
  if (err) return err;
  int size = 0;
  err = nf_cluster_size(galerkin_kernel, galerkin_cfg(), size);
  if (err) return err;
  return nf_cluster_launch(galerkin_kernel, size, P, 0, (cudaStream_t)stream);
}

// B hierarchies of one shape in one launch, one cluster a case.
// ptrs: nf_galerkin_levels's 9 L slots for case 0, the cases' active flags
//       (bool), then each of these 9 L + 1 slots' case stride in bytes, in
//       the same order
// ip:   nf_galerkin_levels's, then B
NF_EXPORT int nf_galerkin_levels_batched(const long long* ptrs, const int* ip, const float* fp,
                                         void* stream) {
  (void)fp;
  RapBatch SB = {};
  int err = read_rap(SB.P, ptrs, ip);
  if (err) return err;
  const int half = 9 * SB.P.L + 1;
  err = read_rap(SB.S, ptrs + half, ip);
  if (err) return err;
  SB.active = reinterpret_cast<const bool*>(ptrs[half - 1]);
  SB.active_stride = reinterpret_cast<const bool*>(ptrs[2 * half - 1]);
  const int cases = ip[2 + 2 * SB.P.L];
  if (!SB.active) return (int)cudaErrorInvalidValue;
  int size = 0, bsize = 0;
  err = nf_cluster_size(galerkin_kernel, galerkin_cfg(), size);
  if (!err) err = nf_cluster_size(galerkin_kernel_batched, galerkin_batch_cfg(), bsize, size);
  if (err) return err;
  if (bsize != size) return (int)cudaErrorLaunchOutOfResources;
  return nf_cluster_launch(galerkin_kernel_batched, size, SB, 0, (cudaStream_t)stream, cases);
}

// How many clusters of `size` CTAs of the batched K5 (kernel 1), K4 (2)
// or K3 (3) the current device holds at once, into *count (krylov.cu's
// nf_case_max_clusters).
int mg_case_max_clusters(int kernel, int size, int* count) {
  if (kernel == 1) return nf_max_active_clusters(mg_solve_kernel_batched, size, *count);
  if (kernel == 2) return nf_max_active_clusters(galerkin_kernel_batched, size, *count);
  if (kernel == 3) return nf_max_active_clusters(vcycle_kernel_batched, size, *count);
  return (int)cudaErrorInvalidValue;
}

// The cluster size K4 launches with on the current device, into *size.
NF_EXPORT int nf_galerkin_cluster_size(int* size) {
  return nf_cluster_size(galerkin_kernel, galerkin_cfg(), *size);
}

// A measurement aid, not a kernel of the solver: `syncs` grid-wide barriers
// in one cooperative launch sized, as K7's grid kernel, for `cells` cells.
// ip: cells, syncs
NF_EXPORT int nf_grid_sync_probe(const long long* ptrs, const int* ip, const float* fp,
                                 void* stream) {
  (void)ptrs;
  (void)fp;
  int syncs = ip[1];
  return nf_coop_launch(sync_probe_kernel, syncs, (int64_t)ip[0], (cudaStream_t)stream);
}
