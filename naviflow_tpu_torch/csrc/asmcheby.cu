// K1: merged power-law assembly + lagged-bound Chebyshev momentum solve of
// both velocity fields, with the d / pressure-operator / Gershgorin folds.
//
// Replaces naviflow_tpu/ops/pallas_asmcheby.py:fused_asmcheby_pair (body
// _mk_kernel).  What it computes, per field (u on (nx+1, ny) faces, v on
// (nx, ny+1) faces):
//   coefficients   ops/powerlaw.{u,v}_momentum_coefficients (Practice-B folds)
//   relaxation     ops/powerlaw.relax_coefficients (1e-12 a_p floor)
//   solve          solvers/momentum._chebyshev_iterate, `degree` steps,
//                  interval scalars given (lagged from the previous step)
//   residual       unrelaxed, zero outside the solve mask
//   d              ops/powerlaw.d_coefficient
//   Gershgorin     one masked max of sum|a_nb| / a_p per block
// and, per cell, the 5-array pressure-correction operator
// (ops/poisson.poisson_coefficients of the two d fields).
//
// Bound on the H100: the kernel reads u, v, p and writes 11 fields, so
// its floor is ~14 arrays of HBM traffic; the redundant halo assembly
// and the 2 * degree block barriers per tile make it latency- and
// instruction-bound at this first cut.  Design: 2-D tiles of TILE x TILE
// owned faces, each with a recomputed halo of H = degree + 1 faces on every
// side (the TPU strips held whole rows and needed halo rows only).  The
// tile's coefficients and iterate live in shared memory; each stencil apply
// invalidates one more ring, so after `degree` applies plus the residual
// the owned faces are still exact.  Coefficients come from global indices,
// so no boundary special case depends on the tile.  Blocks run in no
// order: each writes its own Gershgorin maximum and the wrapper reduces
// them (the JAX wrapper does the same with its per-strip tiles).
// blockIdx.z picks the part: 0 = u tiles, 1 = v tiles, 2 = pressure
// operator cells.

#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;

struct Params {
  const float* u;
  const float* v;
  const float* p;
  const float* bounds;  // theta_u, delta_u, sigma1_u, theta_v, delta_v, sigma1_v
  float* u_star;
  float* r_u;
  float* v_star;
  float* r_v;
  float* d_u;
  float* d_v;
  float* pe;
  float* pw;
  float* pn;
  float* ps;
  float* pdiag;
  float* gmax_u;
  float* gmax_v;
  int nx, ny, degree, variant;  // variant: 0 consistent, 1 symmetric, 2 reference
  float cFu;    // 0.5 * rho * dy (east/west face flux factor)
  float cFv;    // 0.5 * rho * dx (north/south face flux factor)
  float De;     // mu * dy / dx
  float Dn;     // mu * dx / dy
  float dx, dy, alpha, one_m_alpha, rho;
};

struct Coef {
  float ae, aw, an, as, ap, src;
};

__device__ __forceinline__ float U(const Params& P, int i, int j) {
  return P.u[(int64_t)i * P.ny + j];
}
__device__ __forceinline__ float V(const Params& P, int i, int j) {
  return P.v[(int64_t)i * (P.ny + 1) + j];
}
__device__ __forceinline__ float Pr(const Params& P, int i, int j) {
  return P.p[(int64_t)i * P.ny + j];
}

// ops/powerlaw.power_law_A for a scalar diffusion conductance D
__device__ __forceinline__ float power_law_A(float F, float D) {
  if (!(fabsf(D) > 1e-10f)) return 0.f;
  const float base = fmaxf(1.f - 0.1f * fabsf(F / D), 0.f);
  const float b2 = base * base;
  return b2 * b2 * base;
}

// Unrelaxed u-momentum coefficients of face (i, j); rows 0 and nx are zero.
__device__ Coef u_coef(const Params& P, int i, int j) {
  Coef c = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int nx = P.nx, ny = P.ny;
  if (i <= 0 || i >= nx) return c;
  const float uc = U(P, i, j);
  const float Fe = P.cFu * (U(P, i + 1, j) + uc);
  const float Fw = P.cFu * (U(P, i - 1, j) + uc);
  const float Fn = (j == ny - 1) ? 0.f : P.cFv * (V(P, i, j + 1) + V(P, i - 1, j + 1));
  const float Fs = (j == 0) ? 0.f : P.cFv * (V(P, i, j) + V(P, i - 1, j));
  float ae = P.De * power_law_A(Fe, P.De) + fmaxf(-Fe, 0.f);
  float aw = P.De * power_law_A(Fw, P.De) + fmaxf(Fw, 0.f);
  float an = (j == ny - 1) ? 0.f : P.Dn * power_law_A(Fn, P.Dn) + fmaxf(-Fn, 0.f);
  float as = (j == 0) ? 0.f : P.Dn * power_law_A(Fs, P.Dn) + fmaxf(Fs, 0.f);
  c.ap = ae + aw + an + as + (Fe - Fw) + (Fn - Fs);
  float src = (Pr(P, i - 1, j) - Pr(P, i, j)) * P.dy;
  // Practice B, in the order of ops/powerlaw.py
  if (i == 1) { src = src + aw * U(P, 0, j); aw = 0.f; }
  if (i == nx - 1) { src = src + ae * U(P, nx, j); ae = 0.f; }
  if (j == 1) { src = src + as * U(P, i, 0); as = 0.f; }
  if (j == ny - 2) { src = src + an * U(P, i, ny - 1); an = 0.f; }
  c.ae = ae; c.aw = aw; c.an = an; c.as = as; c.src = src;
  return c;
}

// Unrelaxed v-momentum coefficients of face (i, j); columns 0 and ny are zero.
__device__ Coef v_coef(const Params& P, int i, int j) {
  Coef c = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int nx = P.nx, ny = P.ny;
  if (j <= 0 || j >= ny) return c;
  const float Fe = (i == nx - 1) ? 0.f : P.cFu * (U(P, i + 1, j) + U(P, i + 1, j - 1));
  const float Fw = (i == 0) ? 0.f : P.cFu * (U(P, i, j) + U(P, i, j - 1));
  const float Fn = P.cFv * (V(P, i, j) + V(P, i, j + 1));
  const float Fs = P.cFv * (V(P, i, j - 1) + V(P, i, j));
  float ae = (i == nx - 1) ? 0.f : P.De * power_law_A(Fe, P.De) + fmaxf(-Fe, 0.f);
  float aw = (i == 0) ? 0.f : P.De * power_law_A(Fw, P.De) + fmaxf(Fw, 0.f);
  float an = P.Dn * power_law_A(Fn, P.Dn) + fmaxf(-Fn, 0.f);
  float as = P.Dn * power_law_A(Fs, P.Dn) + fmaxf(Fs, 0.f);
  c.ap = ae + aw + an + as + (Fe - Fw) + (Fn - Fs);
  float src = (Pr(P, i, j - 1) - Pr(P, i, j)) * P.dx;
  if (j == 1) { src = src + as * V(P, i, 0); as = 0.f; }
  if (j == ny - 1) { src = src + an * V(P, i, ny); an = 0.f; }
  if (i == 1) { src = src + aw * V(P, 0, j); aw = 0.f; }
  if (i == nx - 2) { src = src + ae * V(P, nx - 1, j); ae = 0.f; }
  c.ae = ae; c.aw = aw; c.an = an; c.as = as; c.src = src;
  return c;
}

__device__ __forceinline__ float relax_ap(const Params& P, float ap) {
  return (fabsf(ap) > 1e-12f ? ap : 1e-12f) / P.alpha;
}

// ops/powerlaw.d_coefficient, with the consistent-variant face masks of
// ops/poisson.poisson_coefficients folded in when `consistent`
__device__ float d_u_face(const Params& P, int i, int j, bool consistent) {
  if (i < 1 || i > P.nx - 1) return 0.f;
  if (consistent && (j < 1 || j > P.ny - 2)) return 0.f;
  const float ap = relax_ap(P, u_coef(P, i, j).ap);
  return fabsf(ap) > 1e-12f ? P.dy / ap : 0.f;
}

__device__ float d_v_face(const Params& P, int i, int j, bool consistent) {
  if (j < 1 || j > P.ny - 1) return 0.f;
  if (consistent && (i < 1 || i > P.nx - 2)) return 0.f;
  const float ap = relax_ap(P, v_coef(P, i, j).ap);
  return fabsf(ap) > 1e-12f ? P.dx / ap : 0.f;
}

// Pressure-correction operator of cell (i, j).
__device__ void pressure_cell(const Params& P, int i, int j) {
  const int nx = P.nx, ny = P.ny;
  const bool consistent = P.variant == 0;
  float ae = (i < nx - 1) ? P.rho * d_u_face(P, i + 1, j, consistent) * P.dy : 0.f;
  float aw = (i > 0) ? P.rho * d_u_face(P, i, j, consistent) * P.dy : 0.f;
  float an = (j < ny - 1) ? P.rho * d_v_face(P, i, j + 1, consistent) * P.dx : 0.f;
  float as = (j > 0) ? P.rho * d_v_face(P, i, j, consistent) * P.dx : 0.f;
  float dg = 0.f;
  if (P.variant == 2) {  // 'reference' boundary fold
    if (i == 0) dg = dg + ae;
    if (i == nx - 1) dg = dg + aw;
    if (j == 0) dg = dg + an;
    if (j == ny - 1) dg = dg + as;
    if (i == 0) ae = 0.f;
    if (i == nx - 1) aw = 0.f;
    if (j == 0) an = 0.f;
    if (j == ny - 1) as = 0.f;
  }
  const int64_t k = (int64_t)i * ny + j;
  P.pe[k] = ae;
  P.pw[k] = aw;
  P.pn[k] = an;
  P.ps[k] = as;
  P.pdiag[k] = dg + ae + aw + an + as;
}

// One field's tile: assemble on the halo region, iterate, write owned faces.
template <bool IS_U>
__device__ void momentum_tile(const Params& P, float* smem, int ti0, int tj0) {
  const int H = P.degree + 1;
  const int RI = TILE + 2 * H, RJ = TILE + 2 * H, R = RI * RJ;
  const int NI = IS_U ? P.nx + 1 : P.nx;
  const int NJ = IS_U ? P.ny : P.ny + 1;
  const float* x0g = IS_U ? P.u : P.v;
  float* gmax_out = (IS_U ? P.gmax_u : P.gmax_v) + blockIdx.y * gridDim.x + blockIdx.x;
  if (ti0 >= NI || tj0 >= NJ) {  // block-uniform: this field has no tile here
    if (threadIdx.x == 0) *gmax_out = 0.f;
    return;
  }
  const float theta = P.bounds[IS_U ? 0 : 3];
  const float delta = P.bounds[IS_U ? 1 : 4];
  const float sigma1 = P.bounds[IS_U ? 2 : 5];
  float* sae = smem;
  float* saw = sae + R;
  float* san = saw + R;
  float* sas = san + R;
  float* sap = sas + R;  // relaxed a_p
  float* sb = sap + R;   // relaxed source * mask
  float* sx = sb + R;    // iterate
  float* sd = sx + R;    // Chebyshev direction

  auto in_mask = [&](int gi, int gj) {
    return gi >= 1 && gi <= NI - 2 && gj >= 1 && gj <= NJ - 2;
  };

  for (int k = threadIdx.x; k < R; k += blockDim.x) {
    const int gi = ti0 - H + k / RJ, gj = tj0 - H + k % RJ;
    float ae = 0.f, aw = 0.f, an = 0.f, as = 0.f, ap = 0.f, b = 0.f, x = 0.f;
    if (gi >= 0 && gi < NI && gj >= 0 && gj < NJ) {
      const Coef c = IS_U ? u_coef(P, gi, gj) : v_coef(P, gi, gj);
      const float x0 = x0g[(int64_t)gi * NJ + gj];
      const float m = in_mask(gi, gj) ? 1.f : 0.f;
      ae = c.ae; aw = c.aw; an = c.an; as = c.as;
      ap = relax_ap(P, c.ap);
      b = (c.src + P.one_m_alpha * ap * x0) * m;
      x = x0 * m;
    }
    sae[k] = ae; saw[k] = aw; san[k] = an; sas[k] = as;
    sap[k] = ap; sb[k] = b; sx[k] = x; sd[k] = 0.f;
  }
  __syncthreads();

  // Chebyshev three-term recurrence (solvers/momentum._chebyshev_iterate)
  float rho_k = 1.f / sigma1;
  for (int it = 0; it < P.degree; ++it) {
    float c_d = 0.f, c_r = 0.f;
    if (it > 0) {
      const float rho_next = 1.f / (2.f * sigma1 - rho_k);
      c_d = rho_next * rho_k;
      c_r = 2.f * rho_next / delta;
      rho_k = rho_next;
    }
    for (int k = threadIdx.x; k < R; k += blockDim.x) {
      const int a = k / RJ, bb = k % RJ;
      const int gi = ti0 - H + a, gj = tj0 - H + bb;
      const float m = (gi >= 0 && gi < NI && gj >= 0 && gj < NJ && in_mask(gi, gj)) ? 1.f : 0.f;
      // neighbours outside the region read as 0: those faces are in the
      // invalidated halo ring and never reach the owned tile
      const float xE = (a + 1 < RI) ? sx[k + RJ] : 0.f;
      const float xW = (a > 0) ? sx[k - RJ] : 0.f;
      const float xN = (bb + 1 < RJ) ? sx[k + 1] : 0.f;
      const float xS = (bb > 0) ? sx[k - 1] : 0.f;
      const float Ax = (sap[k] * sx[k] - sae[k] * xE - saw[k] * xW - san[k] * xN - sas[k] * xS) * m;
      const float r = sb[k] - Ax;
      const float safe_ap = sap[k] == 0.f ? 1.f : sap[k];
      const float rinv = r * (m / safe_ap);
      sd[k] = (it == 0) ? rinv / theta : c_d * sd[k] + c_r * rinv;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < R; k += blockDim.x) sx[k] = sx[k] + sd[k];
    __syncthreads();
  }

  // owned faces: x* = mask ? x : x0, unrelaxed residual, d, Gershgorin
  float* xs = IS_U ? P.u_star : P.v_star;
  float* rr = IS_U ? P.r_u : P.r_v;
  float* dd = IS_U ? P.d_u : P.d_v;
  auto x_final = [&](int a, int bb) {
    const int gi = ti0 - H + a, gj = tj0 - H + bb;
    if (gi < 0 || gi >= NI || gj < 0 || gj >= NJ) return 0.f;
    return in_mask(gi, gj) ? sx[a * RJ + bb] : x0g[(int64_t)gi * NJ + gj];
  };
  float gmax = 0.f;
  for (int k = threadIdx.x; k < TILE * TILE; k += blockDim.x) {
    const int a = H + k / TILE, bb = H + k % TILE;
    const int gi = ti0 + k / TILE, gj = tj0 + k % TILE;
    if (gi >= NI || gj >= NJ) continue;
    const int s = a * RJ + bb;
    const bool m = in_mask(gi, gj);
    const float xc = x_final(a, bb);
    float r = 0.f;
    if (m) {
      const Coef c = IS_U ? u_coef(P, gi, gj) : v_coef(P, gi, gj);
      r = c.src - ((((c.ap * xc - c.ae * x_final(a + 1, bb)) - c.aw * x_final(a - 1, bb))
                    - c.an * x_final(a, bb + 1)) - c.as * x_final(a, bb - 1));
      const float safe_ap = sap[s] == 0.f ? 1.f : sap[s];
      const float nb = fabsf(sae[s]) + fabsf(saw[s]) + fabsf(san[s]) + fabsf(sas[s]);
      gmax = fmaxf(gmax, nb / safe_ap);
    }
    const int64_t g = (int64_t)gi * NJ + gj;
    xs[g] = xc;
    rr[g] = r;
    const bool d_row = IS_U ? (gi >= 1 && gi <= P.nx - 1) : (gj >= 1 && gj <= P.ny - 1);
    const float ap = sap[s];
    dd[g] = (d_row && fabsf(ap) > 1e-12f) ? (IS_U ? P.dy : P.dx) / ap : 0.f;
  }
  gmax = nf_block_max(gmax);
  if (threadIdx.x == 0) *gmax_out = gmax;
}

__global__ void __launch_bounds__(THREADS) asmcheby_kernel(Params P) {
  extern __shared__ float smem[];
  const int ti0 = blockIdx.y * TILE, tj0 = blockIdx.x * TILE;
  if (blockIdx.z == 0) {
    momentum_tile<true>(P, smem, ti0, tj0);
  } else if (blockIdx.z == 1) {
    momentum_tile<false>(P, smem, ti0, tj0);
  } else {
    for (int k = threadIdx.x; k < TILE * TILE; k += blockDim.x) {
      const int i = ti0 + k / TILE, j = tj0 + k % TILE;
      if (i < P.nx && j < P.ny) pressure_cell(P, i, j);
    }
  }
}

}  // namespace

// ptrs: u, v, p, bounds, u*, r_u, v*, r_v, d_u, d_v, pe, pw, pn, ps, pdiag,
//       gmax_u, gmax_v
// ip:   nx, ny, degree, variant, grid_x, grid_y
// fp:   cFu, cFv, De, Dn, dx, dy, alpha, one_m_alpha, rho
NF_EXPORT int nf_asmcheby_pair(const long long* ptrs, const int* ip, const float* fp,
                               void* stream) {
  Params P;
  P.u = reinterpret_cast<const float*>(ptrs[0]);
  P.v = reinterpret_cast<const float*>(ptrs[1]);
  P.p = reinterpret_cast<const float*>(ptrs[2]);
  P.bounds = reinterpret_cast<const float*>(ptrs[3]);
  float** outs[] = {&P.u_star, &P.r_u, &P.v_star, &P.r_v, &P.d_u, &P.d_v, &P.pe,
                    &P.pw, &P.pn, &P.ps, &P.pdiag, &P.gmax_u, &P.gmax_v};
  for (int k = 0; k < 13; ++k) *outs[k] = reinterpret_cast<float*>(ptrs[4 + k]);
  P.nx = ip[0]; P.ny = ip[1]; P.degree = ip[2]; P.variant = ip[3];
  P.cFu = fp[0]; P.cFv = fp[1]; P.De = fp[2]; P.Dn = fp[3];
  P.dx = fp[4]; P.dy = fp[5]; P.alpha = fp[6]; P.one_m_alpha = fp[7]; P.rho = fp[8];
  const int H = P.degree + 1;
  const size_t smem = sizeof(float) * 8 * (TILE + 2 * H) * (TILE + 2 * H);
  cudaError_t err = cudaFuncSetAttribute(
      asmcheby_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ip[4], ip[5], 3);
  asmcheby_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

NF_EXPORT const char* nf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
