// K6's execution model on Hopper: the whole step in ONE thread-block cluster
// (a batched launch: one cluster a case, side by side; nothing here is
// shared between clusters, since rank 0 and DSMEM are per cluster).
//
// A cluster of NF_CL_MAX (16, the non-portable size) or 8 CTAs is
// co-scheduled on neighbouring SMs, has a hardware barrier
// (barrier.cluster.arrive.release / wait.acquire, cg::this_cluster().sync())
// and lets every CTA read and write the others' shared memory (DSMEM).
// K6 uses all three:
//   * passes over the fine (global-memory) levels are grid-strided over the
//     cluster and end in a cluster barrier;
//   * the multigrid levels of <= NF_SMALL_CELLS cells (31^2, 15^2, 7^2 at
//     63^2 and at 255^2) live in CTA rank 0's dynamic shared memory: nine
//     stencil arrays, x and rhs each.  Rank 0 runs the coarse part of every
//     V-cycle there alone between __syncthreads(); a restriction inside
//     shared memory first stores the fine residual once (the same values,
//     summed in the same order, as mg.cuh's restriction, which recomputes
//     each of them for every coarse cell it feeds); the fine -> first
//     coarse restriction writes into rank 0's storage, and the prolongation
//     back reads from it, through DSMEM;
//   * the Galerkin RAP of every coarse level (K4's too) is spread over the
//     cluster, one (coarse cell, offset) entry per work item, the nine of a
//     cell on neighbouring lanes, written straight into the level's
//     storage, one cluster barrier per level; the transfer weights
//     are the vertex taps themselves (1 and 1/2, the boundary slab copied)
//     with no per-tap branch;
//   * a reduction combines each CTA's warps by a shuffle in its warp 0,
//     which writes the CTA's partial into rank 0's shared memory; then one
//     cluster barrier; then warp 0 of every CTA combines the partials in the
//     same fixed order, so every steering scalar is bit-identical in every
//     CTA (the partials ping-pong between two buffers).  One
//     partial per CTA: rank 0's shared memory serves few remote reads.
// Every CTA ends with a cluster barrier: no CTA exits while another may
// still read rank 0's shared memory.
#pragma once

#include "mg.cuh"

// 512 threads a CTA leave each thread 128 registers (ptxas reports 127-128
// and a few hundred bytes of spills per K6 instantiation); 1024 would halve
// that, and 16 x 512 threads already cover a 63^2 field's 4,032 faces.
constexpr int NF_CL_THREADS = 512;
constexpr int NF_CL_WARPS = NF_CL_THREADS / 32;
constexpr int NF_CL_MAX = 16;
// rank 0's partials: two buffers of one slot set per CTA
constexpr int NF_CL_RED_HALF = NF_RED_SLOTS * NF_CL_MAX;
constexpr int NF_CL_RED_FLOATS = 2 * NF_CL_RED_HALF;
// the dynamic shared memory a launch may ask for: the partials, the
// residual scratch and the small levels (at most ~1,400 cells x 12 arrays)
constexpr int NF_CL_SMEM_MAX = 96 * 1024;

struct NfCluster {
  int rank, size;
  int64_t gtid, gstride;
  float* red;  // rank 0's partial buffers (through DSMEM in the other CTAs)
  int phase;   // which half of `red` the next reduction writes
};

// The cluster context of this thread; `dyn` is the dynamic shared memory,
// whose first NF_CL_RED_FLOATS floats hold the partials (null: a kernel
// with no reduction).
__device__ __forceinline__ NfCluster nf_cluster(float* dyn) {
  cg::cluster_group cl = cg::this_cluster();
  NfCluster C;
  C.rank = (int)cl.block_rank();
  C.size = (int)cl.num_blocks();
  C.gtid = (int64_t)C.rank * blockDim.x + threadIdx.x;
  C.gstride = (int64_t)C.size * blockDim.x;
  C.red = dyn ? cl.map_shared_rank(dyn, 0) : nullptr;
  C.phase = 0;
  return C;
}

__device__ __forceinline__ void nf_sync(NfCluster&) { cg::this_cluster().sync(); }

// The cluster barrier split in two, for the launch's first one: arrive at
// the start (relaxed: it orders no memory access), wait just before the
// first access to another CTA's shared memory, so that every CTA has
// started by then and the wait costs little.  Every thread calls both.
__device__ __forceinline__ void nf_cl_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void nf_cl_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// This CTA's sum of N double-single partials (one set per thread), in
// warp 0: each warp's by shuffles, then the warps' by shuffles in warp 0.
template <int N>
__device__ __forceinline__ void nf_cl_block_sum(NfDS (&v)[N], NfDS (&warp_part)[N][NF_CL_WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    NfDS a = v[k];
    for (int off = 16; off > 0; off >>= 1) {
      NfDS b{__shfl_down_sync(0xffffffffu, a.s, off), __shfl_down_sync(0xffffffffu, a.e, off)};
      a = nf_ds_add(a, b);
    }
    if (lane == 0) warp_part[k][warp] = a;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      NfDS a = lane < (int)(blockDim.x >> 5) ? warp_part[k][lane] : nf_ds_zero();
      for (int off = 16; off > 0; off >>= 1) {
        NfDS b{__shfl_down_sync(0xffffffffu, a.s, off), __shfl_down_sync(0xffffffffu, a.e, off)};
        a = nf_ds_add(a, b);
      }
      v[k] = a;  // lane 0: the CTA's sum
    }
  }
}

// Sum N double-single partials (one set per thread) over the cluster; every
// thread of every CTA returns the same N floats.  Every thread of the
// cluster must call it.  Ends with the cluster in step.  (`warp_part` and
// `result` are rewritten by the next call only after its cluster barrier,
// which every thread reaches after reading them.)
template <int N>
__device__ void nf_reduce(NfCluster& C, NfDS (&v)[N], float (&out)[N]) {
  __shared__ NfDS warp_part[N][NF_CL_WARPS];
  __shared__ float result[N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = C.red + C.phase * NF_CL_RED_HALF;
  nf_cl_block_sum<N>(v, warp_part);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      buf[C.rank * NF_RED_SLOTS + 2 * k] = v[k].s;
      buf[C.rank * NF_RED_SLOTS + 2 * k + 1] = v[k].e;
    }
  }
  nf_sync(C);
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      NfDS a = nf_ds_zero();
      if (lane < C.size)
        a = NfDS{buf[lane * NF_RED_SLOTS + 2 * k], buf[lane * NF_RED_SLOTS + 2 * k + 1]};
      for (int off = 16; off > 0; off >>= 1) {
        NfDS b{__shfl_down_sync(0xffffffffu, a.s, off), __shfl_down_sync(0xffffffffu, a.e, off)};
        a = nf_ds_add(a, b);
      }
      if (lane == 0) result[k] = nf_ds_value(a);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = result[k];
  C.phase ^= 1;
}

// The cluster-wide maximum of N floats (one set per thread, NaN-propagating,
// coop.cuh's nf_max_nan), in the same partial buffers; N <= NF_RED_SLOTS.
template <int N>
__device__ void nf_cl_max(NfCluster& C, float (&v)[N], float (&out)[N]) {
  __shared__ float warp_part[N][NF_CL_WARPS];
  __shared__ float result[N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* buf = C.red + C.phase * NF_CL_RED_HALF;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float a = v[k];
    for (int off = 16; off > 0; off >>= 1) a = nf_max_nan(a, __shfl_down_sync(0xffffffffu, a, off));
    if (lane == 0) warp_part[k][warp] = a;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float a = warp_part[k][lane < n_warps ? lane : 0];
      for (int off = 16; off > 0; off >>= 1)
        a = nf_max_nan(a, __shfl_down_sync(0xffffffffu, a, off));
      if (lane == 0) buf[C.rank * NF_RED_SLOTS + k] = a;
    }
  }
  nf_sync(C);
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float a = buf[(lane < C.size ? lane : 0) * NF_RED_SLOTS + k];
      for (int off = 16; off > 0; off >>= 1)
        a = nf_max_nan(a, __shfl_down_sync(0xffffffffu, a, off));
      if (lane == 0) result[k] = a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = result[k];
  C.phase ^= 1;
}

// ---------------------------------------------------------------------------
// Phase timers (the nf_fused_outer_step_phases instantiation, single-case
// only: a batched launch has no timed instantiation): thread 0 of rank 0 reads %globaltimer at each phase boundary and adds the time since
// the last boundary to its phase's slot.  buf: NF_PHASES sums of ns, then
// NF_PHASES counts, then the last stamp (ops/step.py PHASE_NAMES).

enum NfPhase { PH_ASM = 0, PH_U, PH_V, PH_RESID, PH_RHS, PH_RAP, PH_MG_FINE, PH_MG_COARSE,
               PH_CORR, PH_NORMS, NF_PHASES };

__device__ __forceinline__ unsigned long long nf_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool PH>
__device__ __forceinline__ void nf_stamp(unsigned long long* buf, int phase) {
  if constexpr (PH) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      const unsigned long long t = nf_globaltimer();
      if (phase >= 0) {
        buf[phase] += t - buf[2 * NF_PHASES];
        buf[NF_PHASES + phase] += 1;
      }
      buf[2 * NF_PHASES] = t;
    }
  }
}

// ---------------------------------------------------------------------------
// The hierarchy.  lv[0..Ls-1] live in global memory; lv[Ls..L-1] (the levels
// of <= NF_SMALL_CELLS cells below the fine one) in rank 0's shared memory,
// after the partials and a residual scratch of lv[Ls]'s size, level by
// level: st[0..8], x, rhs.

// Each CTA's view of the hierarchy: M's levels with the shared-memory ones
// pointed at rank 0's storage (its own in rank 0, DSMEM elsewhere).  One
// thread per CTA fills `out`.
__device__ inline void nf_cl_levels(const NfMG& M, int Ls, float* dyn, NfLevel* out) {
  float* base = dyn + NF_CL_RED_FLOATS;
  if (Ls < M.L) base += (int64_t)M.lv[Ls].ni * M.lv[Ls].nj;  // the residual scratch
  cg::cluster_group cl = cg::this_cluster();
  if (cl.block_rank() != 0) base = cl.map_shared_rank(base, 0);
  for (int l = 0; l < M.L; ++l) {
    out[l] = M.lv[l];
    if (l >= Ls) {
      const int64_t n = (int64_t)M.lv[l].ni * M.lv[l].nj;
      for (int k = 0; k < 9; ++k) out[l].st[k] = base + k * n;
      out[l].x = base + 9 * n;
      out[l].rhs = base + 10 * n;
      out[l].five = 0;
      base += 11 * n;
    }
  }
}

// One colour of Gauss-Seidel over the cells of that colour only, in place
// (same-colour cells are never neighbours, so this is a true GS update):
// x += omega ((rhs - offdiag) / diag - x), colour (i + j) & 1 on 5-point
// levels, ((i & 1) << 1) | (j & 1) on 9-point ones.
__device__ inline void nf_cl_color_pass(const NfLevel& L, int color, float omega, int start,
                                        int stride) {
  int n, half = 0, oi = 0, oj = 0, cj = 0;
  if (L.five) {  // red-black: colour (i + j) & 1
    half = (L.nj + 1) / 2;
    n = L.ni * half;
  } else {  // four colours: ((i & 1) << 1) | (j & 1)
    oi = color >> 1;
    oj = color & 1;
    cj = (L.nj - oj + 1) / 2;
    n = ((L.ni - oi + 1) / 2) * cj;
  }
  for (int g = start; g < n; g += stride) {
    int i, j;
    if (L.five) {
      i = g / half;
      j = 2 * (g % half) + ((i + color) & 1);
      if (j >= L.nj) continue;
    } else {
      i = 2 * (g / cj) + oi;
      j = 2 * (g % cj) + oj;
    }
    const int64_t c = (int64_t)i * L.nj + j;
    const float pnew = (L.rhs[c] - nf_offdiag(L, i, j, c)) * nf_inv_diag(L.st[0][c]);
    L.x[c] = L.x[c] + omega * (pnew - L.x[c]);
  }
}

// `sweeps` sweeps over a global level, a cluster barrier after each colour.
__device__ inline void nf_cl_smooth(NfCluster& C, const NfLevel& F, int sweeps, float omega) {
  const int colors = F.five ? 2 : 4;
  for (int s = 0; s < sweeps; ++s)
    for (int c = 0; c < colors; ++c) {
      nf_cl_color_pass(F, c, omega, (int)C.gtid, (int)C.gstride);
      nf_sync(C);
    }
}

// The passes over rank 0's shared-memory levels (its block alone), a block
// barrier after each.
__device__ inline void nf_cl_smooth_local(const NfLevel& F, int sweeps, float omega) {
  const int colors = F.five ? 2 : 4;
  for (int s = 0; s < sweeps; ++s)
    for (int c = 0; c < colors; ++c) {
      nf_cl_color_pass(F, c, omega, threadIdx.x, blockDim.x);
      __syncthreads();
    }
}

// F's residual into r once, then the vertex full weighting of r into C's
// right-hand side (mg.cuh's nf_restrict_pass, the same sums); C.x = 0.
__device__ inline void nf_cl_restrict_local(const NfLevel& F, const NfLevel& C, float* r) {
  const int nf = F.ni * F.nj, nc = C.ni * C.nj;
  for (int g = threadIdx.x; g < nf; g += blockDim.x) r[g] = nf_residual(F, g / F.nj, g % F.nj);
  __syncthreads();
  for (int g = threadIdx.x; g < nc; g += blockDim.x) {
    const int i = 2 * (g / C.nj), j = 2 * (g % C.nj);
    float t[3];
#pragma unroll
    for (int b = 0; b < 3; ++b)
      t[b] = 0.25f * r[i * F.nj + j + b] + 0.5f * r[(i + 1) * F.nj + j + b] +
             0.25f * r[(i + 2) * F.nj + j + b];
    const_cast<float*>(C.rhs)[g] = 0.25f * t[0] + 0.5f * t[1] + 0.25f * t[2];
    C.x[g] = 0.f;
  }
  __syncthreads();
}

// The coarse part of a V-cycle, levels Ls..L-1 in rank 0's shared memory
// (rank 0 alone).  `r`: the residual scratch.
__device__ inline void nf_cl_coarse(const NfMG& M, const NfLevel* lv, int Ls, float* r) {
  const int L = M.L;
  for (int l = Ls; l < L - 1; ++l) {
    nf_cl_smooth_local(lv[l], M.pre, M.omega);
    nf_cl_restrict_local(lv[l], lv[l + 1], r);
  }
  nf_cl_smooth_local(lv[L - 1], M.coarsest, M.omega);
  for (int l = L - 2; l >= Ls; --l) {
    nf_prolong_pass(lv[l], lv[l + 1], threadIdx.x, blockDim.x);
    __syncthreads();
    nf_cl_smooth_local(lv[l], M.post, M.omega);
  }
}

// One V-cycle from level 0 (mg.cuh's passes in the plain cycle's order): the
// global levels over the cluster, the shared-memory levels
// Ls..L-1 in rank 0 alone.  The two sides of the coarse part are stamped
// as the multigrid's fine and coarse phases.
template <bool PH>
__device__ void nf_cl_vcycle(NfCluster& C, const NfMG& M, const NfLevel* lv, int Ls, float* r,
                             unsigned long long* ph) {
  const int L = M.L;
  const int top = Ls < L - 1 ? Ls : L - 1;  // global levels with a coarser one below
  for (int l = 0; l < top; ++l) {
    nf_cl_smooth(C, lv[l], M.pre, M.omega);
    nf_restrict_pass(lv[l], lv[l + 1], C.gtid, C.gstride);
    nf_sync(C);
  }
  if (Ls < L) {
    nf_stamp<PH>(ph, PH_MG_FINE);
    if (C.rank == 0) nf_cl_coarse(M, lv, Ls, r);
    nf_sync(C);
    nf_stamp<PH>(ph, PH_MG_COARSE);
  } else {
    nf_cl_smooth(C, lv[L - 1], M.coarsest, M.omega);
  }
  for (int l = top - 1; l >= 0; --l) {
    nf_prolong_pass(lv[l], lv[l + 1], C.gtid, C.gstride);
    nf_sync(C);
    nf_cl_smooth(C, lv[l], M.post, M.omega);
  }
}

// K6's multigrid solve (the loop of solvers/multigrid.multigrid_solve):
// from level 0's iterate, `check_every` V-cycles per check until cycles >=
// max_cycles or ||b - A p|| / ||b|| < tol (compensated norms), the mean
// removed when `mean_normalize`, the final residual into r.  `scratch`:
// rank 0's residual scratch.  Returns the cycle count (the same in every
// CTA).
template <bool PH>
__device__ int nf_cl_mg_solve(NfCluster& C, const NfMG& M, const NfLevel* lv, int Ls,
                              float* scratch, float* r, int max_cycles, int check_every,
                              float tol, bool mean_normalize, unsigned long long* ph) {
  const NfLevel& F = lv[0];
  const int64_t n = (int64_t)F.ni * F.nj;
  float bn[1];
  {
    NfDS acc[1] = {nf_ds_zero()};
    for (int64_t g = C.gtid; g < n; g += C.gstride) nf_ds_fma(acc[0], F.rhs[g], F.rhs[g]);
    nf_reduce<1>(C, acc, bn);
  }
  const float bnorm = sqrtf(bn[0]);
  const float safe_b = bnorm > 0.f ? bnorm : 1.f;
  int k = 0;
  float rel = __int_as_float(0x7f800000);  // +inf
  while (k < max_cycles && rel >= tol) {
    for (int c = 0; c < check_every; ++c) nf_cl_vcycle<PH>(C, M, lv, Ls, scratch, ph);
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
  nf_sync(C);
  nf_stamp<PH>(ph, PH_MG_FINE);
  return k;
}

// ---------------------------------------------------------------------------
// The vertex Galerkin RAP over the cluster (K4's and K6's): A_c = R A P
// entry by entry.  With the per-axis full weighting w = (1/4, 1/2, 1/4) on
// fine rows 2I..2I+2 and the bilinear prolongation weights p(i, I') of
// ops/transfer.prolong_linear, the coarse entry of (I, J) at neighbour
// offset (di, dj) is
//   sum_{a, b in 0..2} w_a w_b sum_{taps k} S_k(2I+a, 2J+b)
//       * p(2I+a+ka, I+di) * p(2J+b+kb, J+dj),
// fine neighbours outside the grid contributing zero (the zero-filled
// shifts of ops/stencil9.apply9), coarse neighbours outside the grid giving
// a zero entry: 81 fine-point/tap pairs an entry, in f32, no comb and no
// matrix product (the TPU's comb + MXU form needed Precision.HIGHEST).
// The prolongation weight of fine line 2I - 1 + e (e = 0..4) to coarse
// line I + d, for a coarse line I of nc and a coarse neighbour I + d
// inside the grid:
//   d = -1: (1, 1/2, 0, 0, 0)
//   d =  0: (0, 1/2, 1, 1/2, 0), the 1/2 at e = 1 a 1 where I = 0 (fine
//           line 0 copies coarse line 0) and the 1/2 at e = 3 a 1 where
//           I = nc - 1 (the last fine line copies the last coarse line)
//   d = +1: (0, 0, 0, 1/2, 1)
// A fine neighbour off the grid always meets a zero weight, and a zero
// weight adds an exact zero, so no tap needs a branch.

__device__ __forceinline__ void nf_cl_axis_weights(int I, int d, int nc, float (&w)[5]) {
  w[0] = d == -1 ? 1.f : 0.f;
  w[1] = d == -1 ? 0.5f : (d == 0 ? (I == 0 ? 1.f : 0.5f) : 0.f);
  w[2] = d == 0 ? 1.f : 0.f;
  w[3] = d == 1 ? 0.5f : (d == 0 ? (I == nc - 1 ? 1.f : 0.5f) : 0.f);
  w[4] = d == 1 ? 1.f : 0.f;
}

// Entries (coarse cell g, offset o) of level C from level F, cell-major
// work items over [start, 9 * cells) with `stride`: the nine entries of a
// cell on neighbouring lanes read the same fine points (one request serves
// them; offset-major items, o = w / cells, were 1.2x slower in K4 and 2.5x
// in K6, whose levels live in rank 0's shared memory).
__device__ inline void nf_cl_rap_pass(const NfLevel& F, const NfLevel& C, int64_t start,
                                      int64_t stride) {
  constexpr int KI[9] = {0, 1, -1, 0, 0, 1, -1, 1, -1};
  constexpr int KJ[9] = {0, 0, 0, 1, -1, 1, 1, -1, -1};
  constexpr float W[3] = {0.25f, 0.5f, 0.25f};
  const int taps = F.five ? 5 : 9;
  const int64_t cells = (int64_t)C.ni * C.nj;
  for (int64_t w = start; w < 9 * cells; w += stride) {
    const int64_t g = w / 9;
    const int o = (int)(w - 9 * g);
    const int I = (int)(g / C.nj), J = (int)(g % C.nj);
    const int Ic = I + KI[o], Jc = J + KJ[o];
    float val = 0.f;
    if (Ic >= 0 && Ic < C.ni && Jc >= 0 && Jc < C.nj) {
      float wi[5], wj[5];
      nf_cl_axis_weights(I, KI[o], C.ni, wi);
      nf_cl_axis_weights(J, KJ[o], C.nj, wj);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float row = 0.f;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int64_t fg = (int64_t)(2 * I + a) * F.nj + (2 * J + b);
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            if (k >= taps) break;
            s = s + F.st[k][fg] * (wi[a + KI[k] + 1] * wj[b + KJ[k] + 1]);
          }
          row = row + W[b] * s;
        }
        val = val + W[a] * row;
      }
    }
    const_cast<float*>(C.st[o])[g] = val;
  }
}

// Every coarse stencil of lv[1..L-1] from lv[0]'s, one cluster pass and
// barrier per level.
__device__ inline void nf_cl_galerkin_rap(NfCluster& C, const NfLevel* lv, int L) {
  for (int l = 1; l < L; ++l) {
    nf_cl_rap_pass(lv[l - 1], lv[l], C.gtid, C.gstride);
    nf_sync(C);
  }
}

// ---------------------------------------------------------------------------
// The launch: one cluster of `size` CTAs of NF_CL_THREADS threads (a
// batched launch: one such cluster a case, `cases` of them along y).  The
// size is chosen once per kernel and device (16 where the occupancy
// calculator fits one such cluster, else 8; `only`: that size or none),
// with the non-portable size and NF_CL_SMEM_MAX bytes of dynamic shared
// memory allowed; later launches reuse it.  Every failure is returned,
// nothing falls back.

struct NfClusterCfg {
  int size[16];  // per device ordinal: 0 = not chosen yet
};

// How many clusters of `size` CTAs of `kernel` the current device holds at
// once (its attributes set first; NF_CL_SMEM_MAX of dynamic shared memory
// each), into `count`: a launch of more clusters runs in waves.
template <class Kernel>
inline int nf_max_active_clusters(Kernel kernel, int size, int& count) {
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               NF_CL_SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t lc = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = size;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  lc.gridDim = dim3(size);
  lc.blockDim = dim3(NF_CL_THREADS);
  lc.dynamicSmemBytes = NF_CL_SMEM_MAX;
  lc.attrs = at;
  lc.numAttrs = 1;
  count = 0;
  return (int)cudaOccupancyMaxActiveClusters(&count, (const void*)kernel, &lc);
}

template <class Kernel>
inline int nf_cluster_size(Kernel kernel, NfClusterCfg& cfg, int& size, int only = 0) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 16) return (int)cudaErrorInvalidDevice;
  if (cfg.size[device] > 0) {
    size = cfg.size[device];
    return 0;
  }
  const int wants[2] = {only > 0 ? only : NF_CL_MAX, 8};
  for (int w = 0; w < (only > 0 ? 1 : 2); ++w) {
    int fit = 0;
    const int e = nf_max_active_clusters(kernel, wants[w], fit);
    if (e) return e;
    if (fit >= 1) {
      cfg.size[device] = size = wants[w];
      return 0;
    }
  }
  return (int)cudaErrorLaunchOutOfResources;  // no cluster of 8 (or `only`) fits
}

// `cases` clusters of `size` CTAs (the attributes already set).
template <class Kernel, class Params>
inline int nf_cluster_launch(Kernel kernel, int size, const Params& params, size_t smem,
                             cudaStream_t stream, int cases = 1) {
  if (smem > (size_t)NF_CL_SMEM_MAX || cases < 1 || cases > 65535)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t lc = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = size;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  lc.gridDim = dim3(size, cases);
  lc.blockDim = dim3(NF_CL_THREADS);
  lc.dynamicSmemBytes = smem;
  lc.stream = stream;
  lc.attrs = at;
  lc.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&lc, kernel, params);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
