// K1: merged power-law assembly + lagged-bound Chebyshev momentum solve of
// both velocity fields, with the d / pressure-operator / Gershgorin folds.
// The kernel and its launch; the entry points are asmcheby.cu and, with
// the phase timers, asmcheby_phases.cu.
//
// Replaces naviflow_tpu/ops/pallas_asmcheby.py:fused_asmcheby_pair (body
// _mk_kernel).  What it computes, per field (u on (nx+1, ny) faces, v on
// (nx, ny+1) faces):
//   coefficients   ops/powerlaw.{u,v}_momentum_coefficients (Practice-B folds)
//   relaxation     ops/powerlaw.relax_coefficients (1e-12 a_p floor)
//   solve          solvers/momentum._chebyshev_iterate, `degree` steps,
//                  interval scalars read from device memory (lagged from
//                  the previous step)
//   residual       unrelaxed, zero outside the solve mask
//   d              ops/powerlaw.d_coefficient
//   Gershgorin     the masked max of sum|a_nb| / a_p over the field
// and, per cell, the 5-array pressure-correction operator
// (ops/poisson.poisson_coefficients of the two d fields).
//
// Bound on the H100: operations more than bytes.  The kernel reads u, v, p
// and writes 11 fields (0.0175 ms of HBM traffic at 1024^2), but each
// face's coefficients cost IEEE divisions F / D and about nine loads, and a
// tile's halo is assembled too.  Design (K9's, csrc/cheby.cu, with the
// assembly in front):
//   * persistent blocks of 512 threads, one an SM, walk 2-D tiles; a
//     region of 64 x 64 faces is the owned tile and a halo of
//     H = degree + 1 on every side, so every region face is assembled once
//     a field (1.40x the owned faces at degree 4; re-assembling them for
//     the residual and the pressure operator, as a plain port does, costs
//     4.7x);
//   * the assembly takes two passes: each face computes the flux and the
//     power-law term D A(F) of its east and north sides into shared
//     memory, and takes its west and south ones from its neighbours after
//     one barrier (the same sums of the same velocities: powerlaw.cuh
//     face_flux), so a face makes two of the four divisions F / D;
//   * each thread owns 8 region faces and keeps their links, relaxed a_p,
//     masked source, mask, mask / a_p, iterate and direction in registers;
//     only the iterate goes through shared memory, double-buffered with a
//     zero border, so a Chebyshev step is one block barrier; the unrelaxed
//     a_p and source of the owned faces wait in shared memory for the
//     residual, which so needs no second assembly;
//   * a block takes the u tile, then the v tile, of the same owned index
//     range, and keeps d of the u faces i..i+1 and the v faces j..j+1 of
//     its cells (the faces i+1 and j+1 of the last row or column lie in
//     the halo it assembled anyway), then writes the pressure operator of
//     its cells from them: no coefficient is rebuilt for it;
//   * each block folds its Gershgorin maxima into the two-float output
//     once, by a signed-int atomicMax on the float's bits: every
//     candidate is >= 0 or loses to the +0.0 the entry sets, so the result
//     is exact and independent of the order;
//   * degree is a template parameter (one instance per degree 1-15), so
//     tile sizes are constants and no loop divides by a runtime pitch.
// Every value comes from the same f32 operations in the same order whatever
// the tiling (coefficients from global indices, the division m / safe_ap
// once a face), so no output depends on the tile shape, and a face of the
// halo gets the bits its owner gets.  Compared on the H100 at 1024^2: the
// 32 x 64 region at 256 threads, two blocks an SM, took longer (its halo
// is 1.72x the owned faces), and so did assembling into shared memory
// before loading the registers, one field body for both fields, and a
// boundary-free copy of the field code for inner tiles (twice the code);
// K1 reads only u, v and p, through the L1, so it stages nothing by
// cp.async.
//
// The case axis (asmcheby_kernel_batched, entry nf_asmcheby_pair_batched
// in asmcheby.cu; the batching rule of ops/asmcheby.py): B cases of one
// shape in one launch.  The same resident blocks walk (case, tile) items,
// case-major; a block moves its shared-memory view of the parameters to a
// case when its walk enters it (every pointer by its case stride, De and
// Dn from the case's conductance row, the interval scalars by address) and
// folds its Gershgorin maxima into the case's pair when it leaves; each
// tile runs the single launch's k1_tile on that view, so each case's bits
// are its single launch's.  A frozen case's tiles write u and v to x* and
// zeros elsewhere.

#pragma once

#include "common.cuh"
#include "powerlaw.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CPL = 2;          // region columns per lane
constexpr int RJ = 32 * CPL;    // 64 region columns
constexpr int PJ = RJ + 2;      // the iterate buffers' pitch: a zero border
constexpr int ROWS = 4;         // region rows per warp
constexpr int RI = WARPS * ROWS;  // 64 region rows
constexpr int CELLS = ROWS * CPL;  // faces a thread

// The owned tile of the region at `degree` (halo degree + 1): 54 x 54 at
// degree 4, 32 x 32 at 15.
__host__ __device__ constexpr int tile_i(int degree) { return RI - 2 * (degree + 1); }
__host__ __device__ constexpr int tile_j(int degree) { return RJ - 2 * (degree + 1); }

// Dynamic shared memory of one block: the two iterate buffers, then eight
// region arrays (the unrelaxed a_p and source, d_u, d_v, and the faces'
// east and north flux terms).
constexpr int SMEM_FLOATS = 2 * (RI + 2) * PJ + 8 * RI * RJ;

// The phases of the timed instantiation (ops/asmcheby.py PHASE_NAMES);
// timers: NF_K1_PHASES sums of ns, NF_K1_PHASES counts, the last stamp.
enum K1Phase { K1_ASSEMBLY = 0, K1_CHEBYSHEV, K1_RESIDUAL, K1_PRESSURE, NF_K1_PHASES };

struct Params {
  const float *u, *v, *p;
  const float *theta_u, *delta_u, *sigma1_u, *theta_v, *delta_v, *sigma1_v;
  float *u_star, *r_u, *v_star, *r_v, *d_u, *d_v, *pe, *pw, *pn, *ps, *pdiag;
  float* gmax;  // [2]: the u and v maxima, combined as int bits
  unsigned long long* timers;
  int nx, ny, variant, tiles_j, tiles;  // variant: 0 consistent, 1 symmetric, 2 reference
  float cFu;    // 0.5 * rho * dy (east/west face flux factor)
  float cFv;    // 0.5 * rho * dx (north/south face flux factor)
  float De;     // mu * dy / dx
  float Dn;     // mu * dx / dy
  float dx, dy, alpha, one_m_alpha, rho;
};

template <bool PH>
__device__ __forceinline__ void k1_stamp(unsigned long long* buf, int phase) {
  if constexpr (PH) {
    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (phase >= 0) {
        buf[phase] += t - buf[2 * NF_K1_PHASES];
        buf[NF_K1_PHASES + phase] += 1;
      }
      buf[2 * NF_K1_PHASES] = t;
    }
  }
}

// One field's region of the tile at (ti0, tj0): assemble, iterate, write
// the owned faces' x*, r and d, keep d of the faces the pressure operator
// needs in `sd`, fold the owned faces' Gershgorin ratios into `gmax`.
template <bool IS_U, int DEG, bool PH>
__device__ __forceinline__ void field_tile(const Params& P, float* sx0, float* sx1,
                                           float* sap_un, float* ssrc_un, float* sd,
                                           float* sflux, int ti0, int tj0, float& gmax) {
  constexpr int H = DEG + 1;
  constexpr int TI = tile_i(DEG), TJ = tile_j(DEG);
  const int NI = IS_U ? P.nx + 1 : P.nx;
  const int NJ = IS_U ? P.ny : P.ny + 1;
  const float* x0g = IS_U ? P.u : P.v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float theta = *(IS_U ? P.theta_u : P.theta_v);
  const float delta = *(IS_U ? P.delta_u : P.delta_v);
  const float sigma1 = *(IS_U ? P.sigma1_u : P.sigma1_v);

  // pass 1: each face's east and north flux terms
  float* sfe = sflux;  // four RI x RJ arrays: Fe, D A(Fe), Fn, D A(Fn)
  float* sdae = sfe + RI * RJ;
  float* sfn = sdae + RI * RJ;
  float* sdan = sfn + RI * RJ;
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int r = warp + WARPS * (c / CPL), q = lane + 32 * (c % CPL);
    const int gi = ti0 - H + r, gj = tj0 - H + q;
    FaceFlux f = {0.f, 0.f, 0.f, 0.f};
    if (gi >= 0 && gi < NI && gj >= 0 && gj < NJ) f = face_flux<IS_U>(P, gi, gj);
    const int k = r * RJ + q;
    sfe[k] = f.Fe; sdae[k] = f.DAe; sfn[k] = f.Fn; sdan[k] = f.DAn;
  }
  __syncthreads();

  // pass 2: the coefficients, the west and south terms from the neighbours
  // (a face of the region's outer ring gets zeros for its missing
  // neighbour: its coefficients only move faces the halo gives up anyway)
  float ae[CELLS], aw[CELLS], an[CELLS], as[CELLS], ap[CELLS], b[CELLS], m[CELLS],
      minv[CELLS], x[CELLS], d[CELLS];
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int r = warp + WARPS * (c / CPL), q = lane + 32 * (c % CPL);
    const int gi = ti0 - H + r, gj = tj0 - H + q;
    ae[c] = aw[c] = an[c] = as[c] = ap[c] = b[c] = m[c] = x[c] = 0.f;
    if (gi >= 0 && gi < NI && gj >= 0 && gj < NJ) {
      const int k = r * RJ + q;
      const FaceFlux o = {sfe[k], sdae[k], sfn[k], sdan[k]};
      const float Fw = r > 0 ? sfe[k - RJ] : 0.f, DAw = r > 0 ? sdae[k - RJ] : 0.f;
      const float Fs = q > 0 ? sfn[k - 1] : 0.f, DAs = q > 0 ? sdan[k - 1] : 0.f;
      Coef cf;
      if constexpr (IS_U) cf = u_coef_flux(P, gi, gj, o, Fw, DAw, Fs, DAs);
      else cf = v_coef_flux(P, gi, gj, o, Fw, DAw, Fs, DAs);
      const float x0 = x0g[(int64_t)gi * NJ + gj];
      const bool mask = gi >= 1 && gi <= NI - 2 && gj >= 1 && gj <= NJ - 2;
      m[c] = mask ? 1.f : 0.f;
      ae[c] = cf.ae; aw[c] = cf.aw; an[c] = cf.an; as[c] = cf.as;
      ap[c] = relax_ap(P, cf.ap);
      b[c] = (cf.src + P.one_m_alpha * ap[c] * x0) * m[c];
      x[c] = x0 * m[c];
      sap_un[r * RJ + q] = cf.ap;
      ssrc_un[r * RJ + q] = cf.src;
    }
    const float safe_ap = ap[c] == 0.f ? 1.f : ap[c];
    minv[c] = m[c] / safe_ap;
    d[c] = 0.f;
    sx0[(r + 1) * PJ + q + 1] = x[c];
  }
  __syncthreads();
  k1_stamp<PH>(P.timers, K1_ASSEMBLY);

  // Chebyshev three-term recurrence (solvers/momentum._chebyshev_iterate);
  // a neighbour outside the region reads the zero border: those faces are
  // in the invalidated halo ring and never reach the owned tile
  float rho_k = 1.f / sigma1;
#pragma unroll
  for (int it = 0; it < DEG; ++it) {
    float c_d = 0.f, c_r = 0.f;
    if (it > 0) {
      const float rho_next = 1.f / (2.f * sigma1 - rho_k);
      c_d = rho_next * rho_k;
      c_r = 2.f * rho_next / delta;
      rho_k = rho_next;
    }
    const float* cur = (it & 1) ? sx1 : sx0;
    float* nxt = (it & 1) ? sx0 : sx1;
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int r = warp + WARPS * (c / CPL), q = lane + 32 * (c % CPL);
      const int s = (r + 1) * PJ + q + 1;
      const float Ax = (ap[c] * x[c] - ae[c] * cur[s + PJ] - aw[c] * cur[s - PJ] -
                        an[c] * cur[s + 1] - as[c] * cur[s - 1]) *
                       m[c];
      const float rr = b[c] - Ax;
      const float rinv = rr * minv[c];
      d[c] = (it == 0) ? rinv / theta : c_d * d[c] + c_r * rinv;
      x[c] = x[c] + d[c];
      nxt[s] = x[c];
    }
    __syncthreads();
  }
  k1_stamp<PH>(P.timers, K1_CHEBYSHEV);

  // x* = mask ? x : x0 into the buffer the last step read (read by nobody
  // since the last barrier), then the owned faces' outputs
  float* fin = (DEG & 1) ? sx0 : sx1;
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int r = warp + WARPS * (c / CPL), q = lane + 32 * (c % CPL);
    const int gi = ti0 - H + r, gj = tj0 - H + q;
    float xf = 0.f;
    if (gi >= 0 && gi < NI && gj >= 0 && gj < NJ)
      xf = m[c] != 0.f ? x[c] : x0g[(int64_t)gi * NJ + gj];
    x[c] = xf;
    fin[(r + 1) * PJ + q + 1] = xf;
  }
  __syncthreads();
  float* xs = IS_U ? P.u_star : P.v_star;
  float* rr = IS_U ? P.r_u : P.r_v;
  float* dd = IS_U ? P.d_u : P.d_v;
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int r = warp + WARPS * (c / CPL), q = lane + 32 * (c % CPL);
    const int gi = ti0 - H + r, gj = tj0 - H + q;
    // the faces whose d the pressure operator of the owned cells reads:
    // the owned faces and one more row (u) or column (v)
    const bool keep = r >= H && q >= H && (IS_U ? (r <= H + TI && q < H + TJ)
                                                : (r < H + TI && q <= H + TJ));
    if (!keep || gi >= NI || gj >= NJ) continue;
    const bool d_row = IS_U ? (gi >= 1 && gi <= P.nx - 1) : (gj >= 1 && gj <= P.ny - 1);
    const float dval = (d_row && fabsf(ap[c]) > 1e-12f) ? (IS_U ? P.dy : P.dx) / ap[c] : 0.f;
    sd[r * RJ + q] = dval;
    if (r >= H + TI || q >= H + TJ) continue;  // the extra row or column
    const int s = (r + 1) * PJ + q + 1;
    const int64_t g = (int64_t)gi * NJ + gj;
    float res = 0.f;
    if (m[c] != 0.f) {
      res = ssrc_un[r * RJ + q] -
            ((((sap_un[r * RJ + q] * x[c] - ae[c] * fin[s + PJ]) - aw[c] * fin[s - PJ]) -
              an[c] * fin[s + 1]) -
             as[c] * fin[s - 1]);
      const float safe_ap = ap[c] == 0.f ? 1.f : ap[c];
      const float nb = fabsf(ae[c]) + fabsf(aw[c]) + fabsf(an[c]) + fabsf(as[c]);
      gmax = fmaxf(gmax, nb / safe_ap);
    }
    xs[g] = x[c];
    rr[g] = res;
    dd[g] = dval;
  }
  // the next field's assembly rewrites the iterate buffers and the a_p /
  // source slots; the pressure operator reads sd
  __syncthreads();
  k1_stamp<PH>(P.timers, K1_RESIDUAL);
}

// One tile t of the walk: both fields' regions, then the pressure operator
// of the owned cells; the owned faces' Gershgorin ratios folded into
// gmax_u, gmax_v.
template <int DEG, bool PH>
__device__ __forceinline__ void k1_tile(const Params& P, float* dyn, int t, float& gmax_u,
                                        float& gmax_v) {
  constexpr int H = DEG + 1;
  constexpr int TI = tile_i(DEG), TJ = tile_j(DEG);
  float* sx0 = dyn;  // two (RI + 2) x PJ iterate buffers
  float* sx1 = sx0 + (RI + 2) * PJ;
  float* sap_un = sx1 + (RI + 2) * PJ;  // RI x RJ each
  float* ssrc_un = sap_un + RI * RJ;
  float* sdu = ssrc_un + RI * RJ;
  float* sdv = sdu + RI * RJ;
  float* sflux = sdv + RI * RJ;  // 4 x RI x RJ
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* const pc[5] = {P.pe, P.pw, P.pn, P.ps, P.pdiag};
  const int ti0 = (t / P.tiles_j) * TI, tj0 = (t % P.tiles_j) * TJ;
  field_tile<true, DEG, PH>(P, sx0, sx1, sap_un, ssrc_un, sdu, sflux, ti0, tj0, gmax_u);
  field_tile<false, DEG, PH>(P, sx0, sx1, sap_un, ssrc_un, sdv, sflux, ti0, tj0, gmax_v);
  // the pressure operator of the owned cells, at the thread's own slots
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int r = warp + WARPS * (c / CPL), q = lane + 32 * (c % CPL);
    const int i = ti0 - H + r, j = tj0 - H + q;
    if (r < H || r >= H + TI || q < H || q >= H + TJ || i >= P.nx || j >= P.ny) continue;
    const int s = r * RJ + q;
    pressure_cell_from_d(P, P.variant, i, j, sdu[s], sdu[s + RJ], sdv[s], sdv[s + 1], pc,
                         (int64_t)i * P.ny + j);
  }
  k1_stamp<PH>(P.timers, K1_PRESSURE);
}

// Zero both iterate buffers once: the borders stay zero, every interior
// slot is rewritten for each field before a barrier lets it be read.
__device__ __forceinline__ void k1_zero_iterates(float* dyn) {
  for (int k = threadIdx.x; k < 2 * (RI + 2) * PJ; k += THREADS) dyn[k] = 0.f;
  __syncthreads();
}

// The block's Gershgorin maxima into the two-float output.
__device__ __forceinline__ void k1_fold_gmax(float* gmax, float gmax_u, float gmax_v) {
  const float gu = nf_block_max(gmax_u);
  if (threadIdx.x == 0) atomicMax(reinterpret_cast<int*>(gmax), __float_as_int(gu));
  __syncthreads();  // nf_block_max reuses one shared scratch
  const float gv = nf_block_max(gmax_v);
  if (threadIdx.x == 0) atomicMax(reinterpret_cast<int*>(gmax) + 1, __float_as_int(gv));
}

template <int DEG, bool PH>
__global__ void __launch_bounds__(THREADS, 1) asmcheby_kernel(Params P) {
  extern __shared__ __align__(16) float dyn[];
  k1_zero_iterates(dyn);
  k1_stamp<PH>(P.timers, -1);
  float gmax_u = 0.f, gmax_v = 0.f;
  for (int t = blockIdx.x; t < P.tiles; t += gridDim.x) k1_tile<DEG, PH>(P, dyn, t, gmax_u, gmax_v);
  k1_fold_gmax(P.gmax, gmax_u, gmax_v);
}

// The case axis: B cases of one shape in one launch.  Case 0's parameters,
// each pointer field's case stride in bytes (the same fields of S), each
// case's viscous conductances (De, Dn, 1 / De, 1 / Dn: powerlaw.py's
// case_conductances rows, De and Dn read) and the active flags, each with
// its stride.
struct K1Batch {
  Params P, S;
  const float* visc;
  const float* visc_stride;
  const bool* active;
  const bool* active_stride;
  int cases;
};

// Case b's view of the parameters into P (thread 0), and whether it is
// active: every pointer moved by b times its stride, De and Dn its own.
__device__ __forceinline__ void k1_case(const K1Batch& SB, int b, Params& P, bool& on) {
  P = SB.P;
  const float** ins[] = {&P.u, &P.v, &P.p, &P.theta_u, &P.delta_u, &P.sigma1_u,
                         &P.theta_v, &P.delta_v, &P.sigma1_v};
  const float* const* sin[] = {&SB.S.u, &SB.S.v, &SB.S.p, &SB.S.theta_u, &SB.S.delta_u,
                               &SB.S.sigma1_u, &SB.S.theta_v, &SB.S.delta_v, &SB.S.sigma1_v};
  for (int k = 0; k < 9; ++k) nf_case_shift(*ins[k], *sin[k], b);
  float** outs[] = {&P.u_star, &P.r_u, &P.v_star, &P.r_v, &P.d_u, &P.d_v, &P.pe,
                    &P.pw, &P.pn, &P.ps, &P.pdiag, &P.gmax};
  float* const* sout[] = {&SB.S.u_star, &SB.S.r_u, &SB.S.v_star, &SB.S.r_v, &SB.S.d_u,
                          &SB.S.d_v, &SB.S.pe, &SB.S.pw, &SB.S.pn, &SB.S.ps, &SB.S.pdiag,
                          &SB.S.gmax};
  for (int k = 0; k < 12; ++k) nf_case_shift(*outs[k], *sout[k], b);
  const float* visc = SB.visc;
  nf_case_shift(visc, SB.visc_stride, b);
  P.De = visc[0];
  P.Dn = visc[1];
  const bool* active = SB.active;
  nf_case_shift(active, SB.active_stride, b);
  on = *active;
}

// A frozen case's tile t: x* = the input field on the owned faces, zero
// residuals, d and pressure operator (its maxima stay the entry's +0.0).
template <int DEG>
__device__ __forceinline__ void k1_frozen_tile(const Params& P, int t) {
  constexpr int TI = tile_i(DEG), TJ = tile_j(DEG);
  const int ti0 = (t / P.tiles_j) * TI, tj0 = (t % P.tiles_j) * TJ;
  for (int k = threadIdx.x; k < TI * TJ; k += THREADS) {
    const int i = ti0 + k / TJ, j = tj0 + k % TJ;
    if (i <= P.nx && j < P.ny) {  // a u face
      const int64_t g = (int64_t)i * P.ny + j;
      P.u_star[g] = P.u[g];
      P.r_u[g] = 0.f;
      P.d_u[g] = 0.f;
    }
    if (i < P.nx && j <= P.ny) {  // a v face
      const int64_t g = (int64_t)i * (P.ny + 1) + j;
      P.v_star[g] = P.v[g];
      P.r_v[g] = 0.f;
      P.d_v[g] = 0.f;
    }
    if (i < P.nx && j < P.ny) {  // a cell
      const int64_t g = (int64_t)i * P.ny + j;
      P.pe[g] = P.pw[g] = P.pn[g] = P.ps[g] = P.pdiag[g] = 0.f;
    }
  }
}

// The persistent blocks walk (case, tile) items, case-major, over the same
// resident grid as the single launch; a block's view moves to a case when
// its walk enters it, and its maxima are folded into a case's slots when
// the walk leaves it.  Each tile runs the single launch's device code on
// its case's view, so each case's bits are its single launch's.
template <int DEG>
__global__ void __launch_bounds__(THREADS, 1) asmcheby_kernel_batched(K1Batch SB) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ Params P;  // the current case's view
  __shared__ bool on;
  k1_zero_iterates(dyn);
  float gmax_u = 0.f, gmax_v = 0.f;
  const int tiles = SB.P.tiles;
  int cur = -1;
  for (int t = blockIdx.x; t < SB.cases * tiles; t += gridDim.x) {
    const int b = t / tiles;
    if (b != cur) {
      if (cur >= 0 && on) k1_fold_gmax(P.gmax, gmax_u, gmax_v);
      gmax_u = gmax_v = 0.f;
      __syncthreads();  // every thread is done with the last case's view
      if (threadIdx.x == 0) k1_case(SB, b, P, on);
      __syncthreads();
      cur = b;
    }
    if (on) k1_tile<DEG, false>(P, dyn, t - b * tiles, gmax_u, gmax_v);
    else k1_frozen_tile<DEG>(P, t - b * tiles);
  }
  if (cur >= 0 && on) k1_fold_gmax(P.gmax, gmax_u, gmax_v);
}

using Kernel = void (*)(Params);

template <bool PH, int DEG>
Kernel kernel_of(int degree) {
  if constexpr (DEG > 15) {
    return nullptr;
  } else {
    return degree == DEG ? asmcheby_kernel<DEG, PH> : kernel_of<PH, DEG + 1>(degree);
  }
}

// Per device ordinal and degree: the blocks a launch runs (0 = not set up).
int g_blocks[16][16];

// Set up `degree`'s instance on the current device once (its shared
// memory, the resident blocks): returns the resident blocks an SM in
// `per_sm` and the blocks a launch runs in `blocks`.
template <bool PH>
cudaError_t setup(int degree, int* per_sm, int* blocks) {
  const Kernel k = kernel_of<PH, 1>(degree);
  if (k == nullptr) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 16) return cudaErrorInvalidDevice;
  const int smem = (int)sizeof(float) * SMEM_FLOATS;
  int n_sm = 0, per = 0;
  err = cudaFuncSetAttribute((const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per < 1) return cudaErrorLaunchOutOfResources;
  *per_sm = per;
  *blocks = per * n_sm;
  return cudaSuccess;
}

// ptrs: u, v, p, theta_u, delta_u, sigma1_u, theta_v, delta_v, sigma1_v
//       (0-d), u*, r_u, v*, r_v, d_u, d_v, pe, pw, pn, ps, pdiag, gmax (2
//       floats), then (timed only) the timer buffer
// ip:   nx, ny, degree (1..15), variant
// fp:   cFu, cFv, De, Dn, dx, dy, alpha, one_m_alpha, rho
// `read` (the batched entry: case 0's slots, then their strides): store the
// parameters there and launch nothing.
template <bool PH>
int launch_asmcheby(const long long* ptrs, const int* ip, const float* fp, void* stream,
                    Params* read = nullptr) {
  Params P;
  const float** ins[] = {&P.u, &P.v, &P.p, &P.theta_u, &P.delta_u, &P.sigma1_u,
                         &P.theta_v, &P.delta_v, &P.sigma1_v};
  for (int k = 0; k < 9; ++k) *ins[k] = reinterpret_cast<const float*>(ptrs[k]);
  float** outs[] = {&P.u_star, &P.r_u, &P.v_star, &P.r_v, &P.d_u, &P.d_v, &P.pe,
                    &P.pw, &P.pn, &P.ps, &P.pdiag, &P.gmax};
  for (int k = 0; k < 12; ++k) *outs[k] = reinterpret_cast<float*>(ptrs[9 + k]);
  P.timers = PH ? reinterpret_cast<unsigned long long*>(ptrs[21]) : nullptr;
  P.nx = ip[0]; P.ny = ip[1];
  const int degree = ip[2];
  P.variant = ip[3];
  P.cFu = fp[0]; P.cFv = fp[1]; P.De = fp[2]; P.Dn = fp[3];
  P.dx = fp[4]; P.dy = fp[5]; P.alpha = fp[6]; P.one_m_alpha = fp[7]; P.rho = fp[8];
  const Kernel k = kernel_of<PH, 1>(degree);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  // the tiles cover the union of both fields' faces: rows 0..nx, columns 0..ny
  P.tiles_j = (P.ny + 1 + tile_j(degree) - 1) / tile_j(degree);
  P.tiles = P.tiles_j * ((P.nx + 1 + tile_i(degree) - 1) / tile_i(degree));
  if (read) {
    *read = P;
    return 0;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 16) return (int)cudaErrorInvalidDevice;
  int& blocks = g_blocks[device][degree];
  if (blocks == 0) {
    int per_sm = 0;
    err = setup<PH>(degree, &per_sm, &blocks);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(P.gmax, 0, 2 * sizeof(float), s);  // +0.0: atomicMax's start
  if (err != cudaSuccess) return (int)err;
  const int grid = P.tiles < blocks ? P.tiles : blocks;
  k<<<grid, THREADS, sizeof(float) * SMEM_FLOATS, s>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace
