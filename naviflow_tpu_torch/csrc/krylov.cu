// K7: the whole masked BiCGSTAB of one momentum field in one launch.
// Replaces naviflow_tpu/ops/pallas_krylov.py:bicgstab_momentum_pallas (its
// kernel body _mk_kernel).
//
// The algebra, the breakdown guards, the stopping rule and the masked x0
// are krylov.cuh's (K6's solve, solvers/momentum._bicgstab_masked with
// compensated dots), with the same expressions in the same order.
//
// Bound on the H100: a field the gate admits is at most 1 MiB (<= 511^2),
// so the system and the Krylov vectors live in L2 or closer; an iteration is
// a chain of dependent passes, each ending in a barrier, three of them
// reductions, so the solve is bound by latency, not by bytes or flops.  Two
// kernels, by shape (ops/krylov.py band_layout):
//   * where the band of every array fits a CTA's shared memory (up to about
//     128^2 at 16 CTAs; the 63^2 headline's 64 x 63 field takes 23 KB a
//     CTA): one thread-block cluster of 16 CTAs of 512 threads (8 where 16
//     do not fit).  CTA c owns the rows [c ni / size, (c + 1) ni / size) and
//     keeps their six coefficient arrays, x, r, rhat, s, t and two buffers
//     each of p and v in its shared memory, each with a halo row above and
//     below the band.  Each iteration's three reductions are cluster.cuh's
//     nf_reduce, so every CTA holds the same scalars and takes the same
//     branch.  The barriers that krylov.cuh needs after p and after s are
//     gone: each CTA computes its halo rows of p = r + beta (p - omega v)
//     and s = r - alpha v itself, from the neighbour's r, p, v rows (DSMEM),
//     with the same expression and scalars as the owner, so bit-identically.
//     Those operands were written before a reduction barrier that every CTA
//     has passed, and none is overwritten before every CTA has passed the
//     next one: p and v ping-pong by iteration parity, r is rewritten only
//     after the second reduction.  Three cluster barriers an iteration
//     instead of five;
//   * larger fields: krylov.cuh's solve over a cooperative grid of as many
//     blocks as fit on the 132 SMs, four an SM (coop.cuh).  The same band
//     scheme with the band in global memory took 1.8x (255^2) and 3.7x
//     (511^2) the cooperative grid's time: 16 SMs walking a band through the
//     L2 are bound by its latency, eight dependent loads a thread a pass at
//     255^2.
//
// The case axis (nf_bicgstab_batched; the batching rule of ops/krylov.py,
// the vmapped lockstep step of algorithms/batch.py): a grid of (cluster
// size, B), case b = blockIdx.y, at the single launch's cluster size.  Each
// thread moves every pointer of the case-0 parameters by b times its slot's
// case stride and runs kb_solve, the single launch's code, on that view:
// the same reductions in the same order, so each case's bits are its single
// launch's whatever B is.  Each cluster's partials and bands are its own
// CTAs' shared memory.  A frozen case (active flag false) copies x0 to its
// output and leaves before the first cluster barrier, every CTA of its
// cluster alike.  B above the clusters the card holds at once runs in waves.
// Fields above the band kernel's shared memory take the grid kernel's case
// form (nf_bicgstab_grid_batched): krylov.cuh's nf_bicgstab_solve_cases,
// one cooperative launch at the single grid kernel's block count.  Each
// block covers the cells of every case that it covers in the single
// launch, each case's sums go to its own partials and are added in the
// single launch's order, so each case's bits are its single launch's; each
// grid barrier serves every case, so a launch pays the slowest case's
// 3 + 5 k barriers once instead of B times, and a block's work a pass
// grows B-fold.  Each case's scratch is the single launch's (six vectors,
// then the partials), B of them.

#include "krylov.cuh"

namespace {

// The arrays of a CTA's band, in shared-memory order after the partials
// (ops/krylov.py BAND_ARRAYS).
enum KbArray { KB_AE = 0, KB_AW, KB_AN, KB_AS, KB_AP, KB_SRC, KB_X, KB_R, KB_RHAT, KB_P0, KB_P1,
               KB_V0, KB_V1, KB_S, KB_T, KB_ARRAYS };

// The floats of the cluster kernel's shared memory for a field of ni x nj
// over `size` CTAs: the partials, then KB_ARRAYS arrays of (rows + 2) x nj.
__host__ __device__ inline int64_t kb_smem_floats(int ni, int nj, int size) {
  const int rows = (ni + size - 1) / size;
  return NF_CL_RED_FLOATS + (int64_t)KB_ARRAYS * (rows + 2) * nj;
}

__device__ __forceinline__ int kb_start(int c, int ni, int size) {
  return (int)((int64_t)c * ni / size);
}

// The CTA whose band holds row i.
__device__ __forceinline__ int kb_owner(int i, int ni, int size) {
  return (int)(((int64_t)(i + 1) * size - 1) / ni);
}

struct KbParams {
  const float* x0;
  const float* coef[6];  // a_e, a_w, a_n, a_s, a_p, src
  float* out;
  int ni, nj, maxiter, lo_i, hi_i, lo_j, hi_j;
  float tol;
};

// One CTA's band: rows [i0, i1); each array's `band` pointer is its row i0
// (row i, i0 - 1 <= i <= i1, at band + (i - i0) nj: the halo rows sit just
// above and below).
struct KbBand {
  int i0, i1, ni, nj, size, lo_i, hi_i, lo_j, hi_j;

  __device__ __forceinline__ bool in(int i, int j) const {
    return i >= lo_i && i <= ni - 1 - hi_i && j >= lo_j && j <= nj - 1 - hi_j;
  }
  // Element (i, j) of row i owned by another CTA, from the array whose band
  // in this CTA is `band` (the same offset in every CTA's shared memory).
  __device__ __forceinline__ float remote(const float* band, int i, int j) const {
    const int o = kb_owner(i, ni, size);
    const float* theirs = cg::this_cluster().map_shared_rank(const_cast<float*>(band), o);
    return theirs[(i - kb_start(o, ni, size)) * nj + j];
  }
  // (A x)[i, j] * mask at own row i, local index e = (i - i0) nj + j, in
  // ops/stencil.apply_stencil's order (krylov.cuh's nf_kry_A); `x` has its
  // halo rows.
  __device__ __forceinline__ float apply(const float* const* coef, const float* x, int i, int j,
                                         int e) const {
    if (!in(i, j)) return 0.f;
    const float xe = i + 1 < ni ? x[e + nj] : 0.f;
    const float xw = i >= 1 ? x[e - nj] : 0.f;
    const float xn = j + 1 < nj ? x[e + 1] : 0.f;
    const float xs = j >= 1 ? x[e - 1] : 0.f;
    return coef[4][e] * x[e] - coef[0][e] * xe - coef[1][e] * xw - coef[2][e] * xn -
           coef[3][e] * xs;
  }
};

// One case's solve in one cluster; `kb_dyn` is the dynamic shared memory.
__device__ __forceinline__ void kb_solve(const KbParams& P, float* kb_dyn) {
  nf_cl_arrive_relaxed();  // waited for before the first access to another CTA
  NfCluster C = nf_cluster(kb_dyn);
  KbBand B;
  B.ni = P.ni; B.nj = P.nj; B.size = C.size;
  B.lo_i = P.lo_i; B.hi_i = P.hi_i; B.lo_j = P.lo_j; B.hi_j = P.hi_j;
  B.i0 = kb_start(C.rank, P.ni, C.size);
  B.i1 = kb_start(C.rank + 1, P.ni, C.size);
  const int nj = P.nj, own = (B.i1 - B.i0) * nj;
  const int64_t base = (int64_t)B.i0 * nj;
  const int stride = ((P.ni + C.size - 1) / C.size + 2) * nj;
  float* a[KB_ARRAYS];
#pragma unroll
  for (int k = 0; k < KB_ARRAYS; ++k) a[k] = kb_dyn + NF_CL_RED_FLOATS + k * stride + nj;
  const float* coef[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) coef[k] = a[KB_AE + k];
  float *const x = a[KB_X], *const r = a[KB_R], *const rhat = a[KB_RHAT];
  float *const s = a[KB_S], *const t = a[KB_T];

  // the band's coefficients; x = mask ? x0 : 0; r = rhat = b - A x; p, v of
  // "iteration -1" = 0
  const float eps = 1.17549435e-38f * 1e6f;  // finfo(float32).tiny * 1e6
  auto xm = [&](int i, int j) {
    return (i >= 0 && i < P.ni && j >= 0 && j < nj && B.in(i, j))
               ? P.x0[(int64_t)i * nj + j] : 0.f;
  };
  float sc[3];
  {
    NfDS acc[3] = {nf_ds_zero(), nf_ds_zero(), nf_ds_zero()};
    for (int e = threadIdx.x; e < own; e += blockDim.x) {
      float cf[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) a[KB_AE + k][e] = cf[k] = P.coef[k][base + e];
      const int i = B.i0 + e / nj, j = e % nj;
      const bool inside = B.in(i, j);
      const float x_ij = xm(i, j);
      const float b = inside ? cf[5] : 0.f;
      const float ax = inside ? cf[4] * x_ij - cf[0] * xm(i + 1, j) - cf[1] * xm(i - 1, j) -
                                    cf[2] * xm(i, j + 1) - cf[3] * xm(i, j - 1)
                              : 0.f;
      const float r0 = b - ax;
      x[e] = x_ij;
      r[e] = r0; rhat[e] = r0; a[KB_V1][e] = 0.f; a[KB_P1][e] = 0.f;
      nf_ds_fma(acc[0], b, b);
      nf_ds_fma(acc[1], r0, r0);
      nf_ds_fma(acc[2], r0, r0);  // (rhat, r) with rhat = r
    }
    nf_cl_wait();
    nf_reduce<3>(C, acc, sc);  // its barriers also order the band writes above
  }
  const float bnorm = sqrtf(sc[0]);
  const float tb = P.tol * fmaxf(bnorm, 1e-30f);
  const float tol2 = tb * tb;
  float rr = sc[1], rho_new = sc[2];
  float rho = 1.f, alpha = 1.f, omega = 1.f;
  bool ok = true;
  for (int k = 0; ok && k < P.maxiter && rr > tol2; ++k) {
    // this iteration's p and v buffers and the last one's
    const bool odd = k & 1;
    float* const p_new = odd ? a[KB_P1] : a[KB_P0];
    float* const v_new = odd ? a[KB_V1] : a[KB_V0];
    const float* const p_old = odd ? a[KB_P0] : a[KB_P1];
    const float* const v_old = odd ? a[KB_V0] : a[KB_V1];
    bool good = fabsf(rho) > eps && fabsf(omega) > eps;
    const float beta =
        good ? (rho_new / (rho == 0.f ? 1.f : rho)) * (alpha / (omega == 0.f ? 1.f : omega)) : 0.f;
    // p on rows i0 - 1 .. i1, the band and its halo (the halo from the
    // owners' operands)
    for (int e = (int)threadIdx.x - nj; e < own + nj; e += (int)blockDim.x) {
      const int i = B.i0 + (e + nj) / nj - 1, j = (e + nj) % nj;
      if (i < 0 || i >= P.ni) continue;
      float rv, pv, vv;
      if (i >= B.i0 && i < B.i1) {
        rv = r[e]; pv = p_old[e]; vv = v_old[e];
      } else {
        rv = B.remote(r, i, j); pv = B.remote(p_old, i, j); vv = B.remote(v_old, i, j);
      }
      p_new[e] = rv + beta * (pv - omega * vv);
    }
    __syncthreads();
    float dn[1];
    {
      NfDS acc[1] = {nf_ds_zero()};
      for (int e = threadIdx.x; e < own; e += blockDim.x) {
        const float vv = B.apply(coef, p_new, B.i0 + e / nj, e % nj, e);
        v_new[e] = vv;
        nf_ds_fma(acc[0], rhat[e], vv);
      }
      nf_reduce<1>(C, acc, dn);
    }
    good = good && fabsf(dn[0]) > eps;
    alpha = good ? rho_new / (dn[0] == 0.f ? 1.f : dn[0]) : 0.f;
    // s on the band and its halo rows
    for (int e = (int)threadIdx.x - nj; e < own + nj; e += (int)blockDim.x) {
      const int i = B.i0 + (e + nj) / nj - 1, j = (e + nj) % nj;
      if (i < 0 || i >= P.ni) continue;
      float rv, vv;
      if (i >= B.i0 && i < B.i1) {
        rv = r[e]; vv = v_new[e];
      } else {
        rv = B.remote(r, i, j); vv = B.remote(v_new, i, j);
      }
      s[e] = rv - alpha * vv;
    }
    __syncthreads();
    float ts[2];
    {
      NfDS acc[2] = {nf_ds_zero(), nf_ds_zero()};
      for (int e = threadIdx.x; e < own; e += blockDim.x) {
        const float tv = B.apply(coef, s, B.i0 + e / nj, e % nj, e);
        t[e] = tv;
        nf_ds_fma(acc[0], tv, tv);
        nf_ds_fma(acc[1], tv, s[e]);
      }
      nf_reduce<2>(C, acc, ts);
    }
    omega = ts[0] > eps ? ts[1] / (ts[0] == 0.f ? 1.f : ts[0]) : 0.f;
    {
      NfDS acc[2] = {nf_ds_zero(), nf_ds_zero()};
      for (int e = threadIdx.x; e < own; e += blockDim.x) {
        x[e] = x[e] + alpha * p_new[e] + omega * s[e];
        const float rv = s[e] - omega * t[e];
        r[e] = rv;
        nf_ds_fma(acc[0], rv, rv);
        nf_ds_fma(acc[1], rhat[e], rv);
      }
      float nr[2];
      nf_reduce<2>(C, acc, nr);
      rr = nr[0];
      rho = rho_new;
      rho_new = nr[1];
    }
    ok = good;
  }
  for (int e = threadIdx.x; e < own; e += blockDim.x)
    P.out[base + e] = B.in(B.i0 + e / nj, e % nj) ? x[e] : P.x0[base + e];
  nf_sync(C);  // no CTA exits while another may still read its shared memory
}

__global__ void __launch_bounds__(NF_CL_THREADS, 1) bicgstab_band_kernel(KbParams P) {
  extern __shared__ __align__(16) float kb_dyn[];
  kb_solve(P, kb_dyn);
}

// B cases: case 0's parameters, every pointer field's case stride in bytes
// (in S, the same fields), the active flags and their stride.
struct KbBatch {
  KbParams P, S;
  const bool* active;
  const bool* active_stride;
};

__global__ void __launch_bounds__(NF_CL_THREADS, 1) bicgstab_band_kernel_batched(KbBatch SB) {
  extern __shared__ __align__(16) float kb_dyn[];
  const int b = (int)blockIdx.y;
  KbParams P = SB.P;
  nf_case_shift(P.x0, SB.S.x0, b);
  for (int k = 0; k < 6; ++k) nf_case_shift(P.coef[k], SB.S.coef[k], b);
  nf_case_shift(P.out, SB.S.out, b);
  const bool* active = SB.active;
  nf_case_shift(active, SB.active_stride, b);
  if (!*active) {  // frozen: x0 back, no cluster barrier
    NfCluster C = nf_cluster(nullptr);
    const int64_t n = (int64_t)P.ni * P.nj;
    for (int64_t g = C.gtid; g < n; g += C.gstride) P.out[g] = P.x0[g];
    return;
  }
  kb_solve(P, kb_dyn);
}

NfClusterCfg& band_cfg() {
  static NfClusterCfg cfg = {};
  return cfg;
}

NfClusterCfg& band_batch_cfg() {
  static NfClusterCfg cfg = {};
  return cfg;
}

// The band kernel's parameters from nf_bicgstab's slots (x0, the six
// coefficient arrays, out) and ip / fp (the batched entry: case 0's, and
// its strides).
void kb_read(KbParams& P, const long long* ptrs, const int* ip, const float* fp) {
  P.x0 = reinterpret_cast<const float*>(ptrs[0]);
  for (int k = 0; k < 6; ++k) P.coef[k] = reinterpret_cast<const float*>(ptrs[1 + k]);
  P.out = reinterpret_cast<float*>(ptrs[7]);
  P.ni = ip[0]; P.nj = ip[1]; P.maxiter = ip[2];
  P.lo_i = ip[3]; P.hi_i = ip[4]; P.lo_j = ip[5]; P.hi_j = ip[6];
  P.tol = fp[0];
}

// Larger fields: krylov.cuh's solve over a cooperative grid, of one field
// (the scalars in every thread's registers, NfKryOne) or of B (NfKryCases).
// The case kernel with B = 1 computes the single kernel's bits, and took
// 10-14% longer on 255^2 and 511^2 fields on an H100 80GB HBM3 at 700 W
// (its scalars go through shared memory and block barriers), so a single
// field keeps its own kernel.
struct GridParams {
  NfKrylov K;
  float* red;
  float tol;
  int maxiter;
};

struct GridCasesParams {
  NfKrylovCases Q;
  float tol;
  int maxiter;
};

// Blocks an SM: at most 64 registers a thread keep 4 blocks of 256 threads
// resident, and both kernels launch no more, so that their block counts,
// and with them each case's order of sums, are equal.
constexpr int KG_BLOCKS_PER_SM = 4;

__global__ void __launch_bounds__(NF_THREADS, KG_BLOCKS_PER_SM)
    bicgstab_grid_kernel(GridParams P) {
  NfCoop C = nf_coop(P.red);
  nf_bicgstab_solve(C, P.K, P.tol, P.maxiter);
}

__global__ void __launch_bounds__(NF_THREADS, KG_BLOCKS_PER_SM)
    bicgstab_grid_kernel_batched(GridCasesParams P) {
  extern __shared__ float kc_dyn[];
  NfCoop C = nf_coop(nullptr);
  nf_bicgstab_solve_cases(C, P.Q, P.tol, P.maxiter, kc_dyn);
}

// One cooperative launch of `kernel` over nf_coop_blocks of an ni x nj
// field's cells, at most KG_BLOCKS_PER_SM an SM, with `smem` bytes of
// dynamic shared memory a block.
template <class Kernel, class Params>
int kg_launch(Kernel kernel, Params& P, int ni, int nj, size_t smem, cudaStream_t stream) {
  if (ni < 1 || nj < 1) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = nf_coop_blocks(kernel, (int64_t)ni * nj, blocks, smem, KG_BLOCKS_PER_SM);
  if (err) return err;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {&P};
  const cudaError_t e = cudaLaunchCooperativeKernel((void*)kernel, dim3((unsigned)blocks),
                                                    dim3(NF_THREADS), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The grid kernel's arrays from nf_bicgstab's slots (x0, the six
// coefficient arrays, out, scratch: six vectors of ni x nj, then the
// partials) and ip / fp (the batched entry: case 0's, and its strides).
void kg_read(NfKrylov& K, float*& red, const long long* ptrs, const int* ip) {
  K.x0 = reinterpret_cast<const float*>(ptrs[0]);
  const float** coef[] = {&K.ae, &K.aw, &K.an, &K.as, &K.ap, &K.src};
  for (int k = 0; k < 6; ++k) *coef[k] = reinterpret_cast<const float*>(ptrs[1 + k]);
  K.x = reinterpret_cast<float*>(ptrs[7]);
  float* scratch = reinterpret_cast<float*>(ptrs[8]);
  K.ni = ip[0]; K.nj = ip[1];
  K.lo_i = ip[3]; K.hi_i = ip[4]; K.lo_j = ip[5]; K.hi_j = ip[6];
  const int64_t n = (int64_t)K.ni * K.nj;
  float** vecs[] = {&K.r, &K.rhat, &K.v, &K.p, &K.s, &K.t};
  for (int k = 0; k < 6; ++k) *vecs[k] = scratch + k * n;
  red = scratch + 6 * n;
}

}  // namespace

// ptrs: x0, a_e, a_w, a_n, a_s, a_p, src, out, scratch (the grid kernel's:
//       6 arrays of ni x nj, r, rhat, v, p, s, t, then the reduction
//       partials, 2 x NF_RED_SLOTS x NF_MAX_BLOCKS floats; 0 for the band
//       kernel)
// ip:   ni, nj, maxiter, lo_i, hi_i, lo_j, hi_j, band (1: the cluster kernel,
//       whose shared memory, kb_smem_floats at its cluster size, must fit
//       NF_CL_SMEM_MAX; 0: the cooperative grid)
// fp:   tol
NF_EXPORT int nf_bicgstab(const long long* ptrs, const int* ip, const float* fp, void* stream) {
  const int ni = ip[0], nj = ip[1];
  if (ni < 1 || nj < 1) return (int)cudaErrorInvalidValue;
  if (ip[7]) {
    KbParams P = {};
    kb_read(P, ptrs, ip, fp);
    int size = 0;
    int err = nf_cluster_size(bicgstab_band_kernel, band_cfg(), size);
    if (err) return err;
    const int64_t floats = kb_smem_floats(ni, nj, size);
    if (4 * floats > NF_CL_SMEM_MAX) return (int)cudaErrorInvalidValue;
    return nf_cluster_launch(bicgstab_band_kernel, size, P, (size_t)(4 * floats),
                             (cudaStream_t)stream);
  }
  if (!ptrs[8]) return (int)cudaErrorInvalidValue;
  GridParams P = {};
  kg_read(P.K, P.red, ptrs, ip);
  P.maxiter = ip[2];
  P.tol = fp[0];
  return kg_launch(bicgstab_grid_kernel, P, ni, nj, 0, (cudaStream_t)stream);
}

// The cluster size K7's band kernel launches with on the current device,
// into *size.
NF_EXPORT int nf_bicgstab_cluster_size(int* size) {
  return nf_cluster_size(bicgstab_band_kernel, band_cfg(), *size);
}

// B cases of one shape in one launch of the band kernel, one cluster a case.
// ptrs: nf_bicgstab's nine slots for case 0 (scratch 0), the cases' active
//       flags (bool), then each of these ten slots' case stride in bytes, in
//       the same order (0: one array shared by every case)
// ip:   nf_bicgstab's eight (band 1), then B
// fp:   tol
NF_EXPORT int nf_bicgstab_batched(const long long* ptrs, const int* ip, const float* fp,
                                  void* stream) {
  KbBatch SB = {};
  kb_read(SB.P, ptrs, ip, fp);
  kb_read(SB.S, ptrs + 10, ip, fp);
  SB.active = reinterpret_cast<const bool*>(ptrs[9]);
  SB.active_stride = reinterpret_cast<const bool*>(ptrs[19]);
  const int ni = ip[0], nj = ip[1], cases = ip[8];
  if (ni < 1 || nj < 1 || !ip[7] || !SB.active) return (int)cudaErrorInvalidValue;
  int size = 0, bsize = 0;
  int err = nf_cluster_size(bicgstab_band_kernel, band_cfg(), size);
  if (!err) err = nf_cluster_size(bicgstab_band_kernel_batched, band_batch_cfg(), bsize, size);
  if (err) return err;
  if (bsize != size) return (int)cudaErrorLaunchOutOfResources;
  const int64_t floats = kb_smem_floats(ni, nj, size);
  if (4 * floats > NF_CL_SMEM_MAX) return (int)cudaErrorInvalidValue;
  return nf_cluster_launch(bicgstab_band_kernel_batched, size, SB, (size_t)(4 * floats),
                           (cudaStream_t)stream, cases);
}

// B cases of one shape in one cooperative launch of the grid kernel's case
// form, at nf_bicgstab's block count.
// ptrs: nf_bicgstab_batched's twenty slots, with each case's scratch (the
//       single launch's: six vectors of ni x nj, then 2 x NF_RED_SLOTS x
//       NF_MAX_BLOCKS floats of partials) in slot 8 and its case stride in
//       slot 18
// ip:   nf_bicgstab's eight (band 0), then B
// fp:   tol
NF_EXPORT int nf_bicgstab_grid_batched(const long long* ptrs, const int* ip, const float* fp,
                                       void* stream) {
  GridCasesParams P = {};
  NfKrylovCases& Q = P.Q;
  float* red_stride = nullptr;
  kg_read(Q.K, Q.red, ptrs, ip);
  kg_read(Q.S, red_stride, ptrs + 10, ip);
  // the strides: each slot's own, not an offset into the scratch
  Q.S.r = Q.S.rhat = Q.S.v = Q.S.p = Q.S.s = Q.S.t = reinterpret_cast<float*>(ptrs[18]);
  Q.red_stride = reinterpret_cast<const float*>(ptrs[18]);
  Q.active = reinterpret_cast<const bool*>(ptrs[9]);
  Q.active_stride = reinterpret_cast<const bool*>(ptrs[19]);
  Q.cases = ip[8];
  P.maxiter = ip[2];
  P.tol = fp[0];
  if (ip[7] || Q.cases < 1 || !ptrs[8] || !Q.active) return (int)cudaErrorInvalidValue;
  return kg_launch(bicgstab_grid_kernel_batched, P, ip[0], ip[1],
                   sizeof(float) * KC_FIELDS * (size_t)Q.cases, (cudaStream_t)stream);
}

// How many clusters of `size` CTAs of the batched K7 (kernel 0), K5 (1) or
// K4 (2) the current device holds at once, into *count.
int mg_case_max_clusters(int kernel, int size, int* count);  // mg.cu

NF_EXPORT int nf_case_max_clusters(int kernel, int size, int* count) {
  if (kernel == 0) return nf_max_active_clusters(bicgstab_band_kernel_batched, size, *count);
  return mg_case_max_clusters(kernel, size, count);
}
