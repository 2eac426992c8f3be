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
#include "powerlaw.cuh"

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
    float* const pc[5] = {P.pe, P.pw, P.pn, P.ps, P.pdiag};
    for (int k = threadIdx.x; k < TILE * TILE; k += blockDim.x) {
      const int i = ti0 + k / TILE, j = tj0 + k % TILE;
      if (i < P.nx && j < P.ny)
        pressure_cell_from_faces(P, P.variant, i, j, pc, (int64_t)i * P.ny + j);
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
