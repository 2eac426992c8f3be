// K3 and K5 on Hopper: one V-cycle (K3) and the whole multigrid solve (K5),
// each in ONE thread-block cluster (cluster.cuh's execution model, as K6).
//
// The hierarchy they take: 9-point Galerkin levels (four colours) below a
// 5- or 9-point level 0 (red-black on 5-point levels), cell-centred
// (nf == 2 nc) or vertex (nf == 2 nc + 1) transfer pairs, f32.  Every cell
// update, residual and transfer is mg.cuh's, with the same operands in the
// same order as the plain cycle (solvers/multigrid._cycle) composes them.
// Where each pass runs and what it reads:
//   * levels 0..Ls-1 (level 0 and every level of more than NF_SMALL_CELLS
//     cells) stay in global memory (the L2 at the sizes the gate admits);
//     their passes are grid-strided over the cluster and end in a cluster
//     barrier (0.71 us on the H100, a cooperative grid barrier 1.1-1.3),
//     and each colour pass visits the cells of its colour only
//     (nf_cl_color_pass);
//   * levels Ls..L-1 live in rank 0's dynamic shared memory.  Their
//     stencils are inputs (the composed Galerkin rebuild writes them), so
//     rank 0 copies them in with cp.async at the start of the launch, and
//     the copies land while the large levels are smoothed (K5 copies them
//     once per solve: its cycles reuse them, and each cycle's restriction
//     rewrites the levels' x and rhs there).  Rank 0 runs
//     their passes alone between __syncthreads(); a vertex restriction
//     stores the fine residual once (nf_cl_restrict_local), a cell-centred
//     one reads each fine residual once anyway (the 2x2 mean);
//   * the coarsest level, where it has at most NF_VC_REG_CELLS cells, is
//     smoothed in one warp's registers: lane l holds cells l + 32 s, its
//     nine stencil entries, rhs and x; neighbours come by __shfl_sync, and
//     there is no barrier between colours (a warp's shuffles are in step);
//   * the restriction into level Ls writes into rank 0's storage, and the
//     prolongation back reads from it, through DSMEM.
// Level 0's iterate is the output; the launch first copies the input
// iterate into it over the cluster.  The cluster's first barrier comes
// before any CTA touches rank 0's shared memory and its last after the
// last such access, so no CTA reads it before rank 0 starts or after it
// exits.
//
// K5 adds the solve loop of solvers/multigrid.multigrid_solve around the
// cycle: ||b||, each check's residual norm and the mean are cluster.cuh's
// nf_reduce (compensated double-single sums, bit-identical in every CTA,
// so every CTA leaves the check loop together); its partials take the
// first NF_CL_RED_FLOATS floats of the dynamic shared memory, the levels
// follow them.
#pragma once

#include "cluster.cuh"

// NfVcPhase: the phases of the timed instantiation (ops/mg.py
// VC_PHASE_NAMES); buf: NF_VC_PHASES sums of ns, NF_VC_PHASES counts, the
// last stamp.
enum NfVcPhase { VC_DOWN = 0, VC_SMALL, VC_COARSEST, VC_UP, NF_VC_PHASES };

// The coarsest level in one warp's registers: at most 32 x NF_VC_SLOTS cells.
constexpr int NF_VC_SLOTS = 2;
constexpr int NF_VC_REG_CELLS = 32 * NF_VC_SLOTS;

// The C entry's integer parameters, in order (then per level ni, nj, five).
enum NfVcIp { VC_IP_L = 0, VC_IP_PRE, VC_IP_POST, VC_IP_COARSEST, VC_IP_LS, VC_IP_LEVELS };
// K5's: NfVcIp's first five, then its own three (then per level ni, nj, five).
enum NfMsIp { MS_IP_MAX_CYCLES = VC_IP_LEVELS, MS_IP_CHECK_EVERY, MS_IP_MEAN, MS_IP_LEVELS };

template <bool PH>
__device__ __forceinline__ void nf_vc_stamp(unsigned long long* buf, int phase) {
  if constexpr (PH) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      const unsigned long long t = nf_globaltimer();
      if (phase >= 0) {
        buf[phase] += t - buf[2 * NF_VC_PHASES];
        buf[NF_VC_PHASES + phase] += 1;
      }
      buf[2 * NF_VC_PHASES] = t;
    }
  }
}

// Floats of rank 0's dynamic shared memory for levels Ls..L-1 of `cells`
// cells each: the residual scratch of a vertex restriction (lv[Ls]'s size),
// then per level nine stencil arrays, x and rhs.
__host__ __device__ inline int64_t nf_vc_smem_floats(const int* cells, int L, int Ls) {
  if (Ls >= L) return 0;
  int64_t n = cells[Ls];
  for (int l = Ls; l < L; ++l) n += 11 * (int64_t)cells[l];
  return n;
}

// Each CTA's view of the hierarchy: M's levels with levels Ls..L-1 pointed
// at rank 0's storage (its own in rank 0, DSMEM elsewhere).  One thread
// per CTA fills `out`; `*scratch` is the residual scratch.
__device__ inline void nf_vc_levels(const NfMG& M, int Ls, float* dyn, NfLevel* out,
                                    float** scratch) {
  float* base = dyn;
  cg::cluster_group cl = cg::this_cluster();
  if (cl.block_rank() != 0) base = cl.map_shared_rank(base, 0);
  *scratch = base;
  if (Ls < M.L) base += (int64_t)M.lv[Ls].ni * M.lv[Ls].nj;
  for (int l = 0; l < M.L; ++l) {
    out[l] = M.lv[l];
    if (l >= Ls) {
      const int64_t n = (int64_t)M.lv[l].ni * M.lv[l].nj;
      for (int k = 0; k < 9; ++k) out[l].st[k] = base + k * n;
      out[l].x = base + 9 * n;
      out[l].rhs = base + 10 * n;
      base += 11 * n;
    }
  }
}

// Rank 0: start the copies of the shared-memory levels' stencils (M's
// global arrays) into their storage; 4-byte cp.async, so any size and
// alignment is taken.  Completed by nf_vc_load_wait.
__device__ inline void nf_vc_load_start(const NfMG& M, int Ls, const NfLevel* lv) {
  for (int l = Ls; l < M.L; ++l) {
    const int n = M.lv[l].ni * M.lv[l].nj;
    const int taps = M.lv[l].five ? 5 : 9;
    for (int k = 0; k < taps; ++k) {
      const float* src = M.lv[l].st[k];
      const unsigned dst = (unsigned)__cvta_generic_to_shared(lv[l].st[k]);
      for (int g = threadIdx.x; g < n; g += blockDim.x)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + 4u * g),
                     "l"(src + g)
                     : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void nf_vc_load_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// F's residual restricted into C's right-hand side, C.x = 0, in rank 0
// alone: vertex pairs through the stored residual (cluster.cuh), cell-
// centred pairs straight (each fine residual feeds one coarse cell), the
// sums of mg.cuh's nf_restrict_pass.
__device__ inline void nf_vc_restrict_local(const NfLevel& F, const NfLevel& C, float* r) {
  if (F.ni == 2 * C.ni + 1) {
    nf_cl_restrict_local(F, C, r);
    return;
  }
  const int nc = C.ni * C.nj;
  for (int g = threadIdx.x; g < nc; g += blockDim.x) {
    const int i = 2 * (g / C.nj), j = 2 * (g % C.nj);
    const float r00 = nf_residual(F, i, j), r10 = nf_residual(F, i + 1, j);
    const float r01 = nf_residual(F, i, j + 1), r11 = nf_residual(F, i + 1, j + 1);
    const_cast<float*>(C.rhs)[g] = 0.5f * (0.5f * (r00 + r10) + 0.5f * (r01 + r11));
    C.x[g] = 0.f;
  }
  __syncthreads();
}

// `sweeps` Gauss-Seidel sweeps of level L (at most NF_VC_REG_CELLS cells,
// in shared memory) by one warp from registers: nf_offdiag's terms in its
// order, an out-of-grid neighbour a zero operand, each colour a pass in
// which the lanes of that colour commit.  Called by all 32 lanes of a warp.
__device__ inline void nf_vc_coarsest_warp(const NfLevel& L, int sweeps, float omega) {
  constexpr int KI[8] = {1, -1, 0, 0, 1, -1, 1, -1};
  constexpr int KJ[8] = {0, 0, 1, -1, 1, 1, -1, -1};
  const int lane = threadIdx.x & 31;
  const int n = L.ni * L.nj, ns = (n + 31) / 32;
  const int taps = L.five ? 4 : 8;
  float st[NF_VC_SLOTS][9], rhs[NF_VC_SLOTS], x[NF_VC_SLOTS], inv[NF_VC_SLOTS];
  int color[NF_VC_SLOTS], src[NF_VC_SLOTS][8];  // source lane | slot << 5, -1 off the grid
#pragma unroll
  for (int s = 0; s < NF_VC_SLOTS; ++s) {
    const int g = lane + 32 * s;
    const bool own = s < ns && g < n;
    const int i = own ? g / L.nj : 0, j = own ? g % L.nj : 0;
    color[s] = !own ? -1 : (L.five ? ((i + j) & 1) : (((i & 1) << 1) | (j & 1)));
#pragma unroll
    for (int k = 0; k < 9; ++k) st[s][k] = own && (k < 5 || !L.five) ? L.st[k][g] : 0.f;
    rhs[s] = own ? L.rhs[g] : 0.f;
    x[s] = own ? L.x[g] : 0.f;
    inv[s] = nf_inv_diag(st[s][0]);
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int ii = i + KI[o], jj = j + KJ[o];
      src[s][o] = (own && ii >= 0 && ii < L.ni && jj >= 0 && jj < L.nj) ? ii * L.nj + jj : -1;
    }
  }
  const int colors = L.five ? 2 : 4;
  for (int sw = 0; sw < sweeps; ++sw)
    for (int c = 0; c < colors; ++c) {
#pragma unroll
      for (int s = 0; s < NF_VC_SLOTS; ++s) {
        if (s >= ns) break;  // warp-uniform
        // a neighbour of a cell of colour c is of another colour, so slot
        // s - 1's commits below never reach what slot s's committing lanes read
        float v[8];
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          const int q = src[s][o];
          float got = __shfl_sync(0xffffffffu, x[0], q & 31);
#pragma unroll
          for (int t = 1; t < NF_VC_SLOTS; ++t) {
            if (t < ns) {  // warp-uniform
              const float xt = __shfl_sync(0xffffffffu, x[t], q & 31);
              if ((q >> 5) == t) got = xt;
            }
          }
          v[o] = q < 0 ? 0.f : got;
        }
        float off = st[s][1] * v[0] + st[s][2] * v[1] + st[s][3] * v[2] + st[s][4] * v[3];
        if (taps == 8)
          off = off + st[s][5] * v[4] + st[s][6] * v[5] + st[s][7] * v[6] + st[s][8] * v[7];
        const float pnew = (rhs[s] - off) * inv[s];
        if (color[s] == c) x[s] = x[s] + omega * (pnew - x[s]);
      }
    }
#pragma unroll
  for (int s = 0; s < NF_VC_SLOTS; ++s) {
    const int g = lane + 32 * s;
    if (s < ns && g < n) L.x[g] = x[s];
  }
}

// The coarse part of the cycle, levels Ls..L-1 in rank 0's shared memory
// (rank 0 alone).  `r`: the residual scratch.
template <bool PH>
__device__ void nf_vc_coarse(const NfMG& M, const NfLevel* lv, int Ls, float* r,
                             unsigned long long* ph) {
  const int L = M.L;
  for (int l = Ls; l < L - 1; ++l) {
    nf_cl_smooth_local(lv[l], M.pre, M.omega);
    nf_vc_restrict_local(lv[l], lv[l + 1], r);
  }
  nf_vc_stamp<PH>(ph, VC_SMALL);
  const NfLevel& Cst = lv[L - 1];
  if (Cst.ni * Cst.nj <= NF_VC_REG_CELLS) {
    if (threadIdx.x < 32) nf_vc_coarsest_warp(Cst, M.coarsest, M.omega);
    __syncthreads();
  } else {
    nf_cl_smooth_local(Cst, M.coarsest, M.omega);
  }
  nf_vc_stamp<PH>(ph, VC_COARSEST);
  for (int l = L - 2; l >= Ls; --l) {
    nf_prolong_pass(lv[l], lv[l + 1], threadIdx.x, blockDim.x);
    __syncthreads();
    nf_cl_smooth_local(lv[l], M.post, M.omega);
  }
  nf_vc_stamp<PH>(ph, VC_SMALL);
}

// The passes of one V-cycle on level 0's iterate in place, over the
// cluster (the copy-in done): the large levels down, rank 0's part (its
// stencil copies waited for: at once after the first time), the large
// levels up.
template <bool PH>
__device__ void nf_vc_passes(NfCluster& C, const NfMG& M, const NfLevel* lv, int Ls, float* r,
                             unsigned long long* ph) {
  const int L = M.L;
  const int top = Ls < L - 1 ? Ls : L - 1;  // global levels with a coarser one below
  for (int l = 0; l < top; ++l) {
    nf_cl_smooth(C, lv[l], M.pre, M.omega);
    nf_restrict_pass(lv[l], lv[l + 1], C.gtid, C.gstride);
    nf_sync(C);
    nf_vc_stamp<PH>(ph, VC_DOWN);
  }
  if (Ls < L) {
    if (C.rank == 0) {
      nf_vc_load_wait();
      nf_vc_coarse<PH>(M, lv, Ls, r, ph);
    }
    nf_sync(C);
  } else {
    nf_cl_smooth(C, lv[L - 1], M.coarsest, M.omega);
    nf_vc_stamp<PH>(ph, VC_COARSEST);
  }
  for (int l = top - 1; l >= 0; --l) {
    nf_prolong_pass(lv[l], lv[l + 1], C.gtid, C.gstride);
    nf_sync(C);
    nf_cl_smooth(C, lv[l], M.post, M.omega);
    nf_vc_stamp<PH>(ph, VC_UP);
  }
}

// One V-cycle (K3): level 0's iterate (the output) from p_in.
template <bool PH>
__device__ void nf_vc_cycle(const NfMG& M, int Ls, const float* p_in, float* dyn,
                            unsigned long long* ph) {
  __shared__ NfLevel lv[NF_MAX_LEVELS];
  __shared__ float* scratch_s;
  NfCluster C = nf_cluster(dyn);
  nf_vc_stamp<PH>(ph, -1);
  if (threadIdx.x == 0) nf_vc_levels(M, Ls, dyn, lv, &scratch_s);
  __syncthreads();
  if (C.rank == 0) nf_vc_load_start(M, Ls, lv);
  const int64_t n0 = (int64_t)M.lv[0].ni * M.lv[0].nj;
  for (int64_t g = C.gtid; g < n0; g += C.gstride) M.lv[0].x[g] = p_in[g];
  nf_sync(C);
  nf_vc_passes<PH>(C, M, lv, Ls, scratch_s, ph);
}

// The whole solve (K5; pallas_mg.mg_solve_value): level 0's iterate (the
// output) from p_in, then `check_every` V-cycles per check while
// cycles < max_cycles and ||b - A p|| / ||b|| >= tol (compensated norms),
// then the mean removed when `mean_normalize`, and the final residual into
// r.  *cycles and *rel are written by one thread.  The partials of the
// reductions take dyn[0, NF_CL_RED_FLOATS), the levels in rank 0's shared
// memory the floats after them.
__device__ inline void nf_vc_mg_solve(const NfMG& M, int Ls, const float* p_in, float* r,
                                      int max_cycles, int check_every, float tol,
                                      bool mean_normalize, int* cycles_out, float* rel_out,
                                      float* dyn) {
  __shared__ NfLevel lv[NF_MAX_LEVELS];
  __shared__ float* scratch_s;
  nf_cl_arrive_relaxed();  // waited for before the first reduction writes to rank 0
  NfCluster C = nf_cluster(dyn);
  if (threadIdx.x == 0) nf_vc_levels(M, Ls, dyn + NF_CL_RED_FLOATS, lv, &scratch_s);
  __syncthreads();
  if (C.rank == 0) nf_vc_load_start(M, Ls, lv);
  const NfLevel& F = M.lv[0];
  const int64_t n = (int64_t)F.ni * F.nj;
  float bn[1];
  {
    NfDS acc[1] = {nf_ds_zero()};
    for (int64_t g = C.gtid; g < n; g += C.gstride) {
      F.x[g] = p_in[g];
      nf_ds_fma(acc[0], F.rhs[g], F.rhs[g]);
    }
    nf_cl_wait();
    nf_reduce<1>(C, acc, bn);  // its barrier also publishes the copy-in
  }
  const float bnorm = sqrtf(bn[0]);
  const float safe_b = bnorm > 0.f ? bnorm : 1.f;
  int k = 0;
  float rel = __int_as_float(0x7f800000);  // +inf
  while (k < max_cycles && rel >= tol) {
    for (int c = 0; c < check_every; ++c) nf_vc_passes<false>(C, M, lv, Ls, scratch_s, nullptr);
    NfDS acc[1] = {nf_residual_pass(F, nullptr, C.gtid, C.gstride)};
    float r2[1];
    nf_reduce<1>(C, acc, r2);
    rel = sqrtf(r2[0]) / safe_b;
    k += check_every;
  }
  if (mean_normalize) {
    NfDS acc[1] = {nf_ds_zero()};
    for (int64_t g = C.gtid; g < n; g += C.gstride) nf_ds_addf(acc[0], F.x[g]);
    float sum[1];
    nf_reduce<1>(C, acc, sum);
    const float mean = sum[0] / (float)n;
    for (int64_t g = C.gtid; g < n; g += C.gstride) F.x[g] = F.x[g] - mean;
    nf_sync(C);
  }
  nf_residual_pass(F, r, C.gtid, C.gstride);
  if (C.rank == 0 && threadIdx.x == 0) {
    *cycles_out = k;
    *rel_out = rel;
  }
  nf_sync(C);  // no CTA exits while another may still read rank 0's partials
}
