// K8: both momentum fields' power-law coefficient sets in one pass, with the
// Gershgorin maxima and, optionally, the d / pressure-operator fold.
//
// Replaces naviflow_tpu/ops/pallas_assembly.py:fused_assembly_pair (body
// _mk_kernel).  What it computes, per field (u on (nx+1, ny) faces, v on
// (nx, ny+1) faces):
//   coefficients   ops/powerlaw.{u,v}_momentum_coefficients (Practice-B folds)
//   relaxation     ops/powerlaw.relax_coefficients (1e-12 a_p floor)
//   Gershgorin     one masked max of sum|a_nb| / a_p_relaxed per block
// and with the fold (variant >= 0) d_u, d_v (ops/powerlaw.d_coefficient) and
// the 5-array pressure-correction operator (ops/poisson.poisson_coefficients).
// The u grid's last face row I = nx comes out of the same per-face code: its
// links and unrelaxed pair are zero, the relaxed a_p is 1e-12 / alpha and
// src = (1 - alpha) a_p u[nx], as the JAX wrapper appends it.
//
// Bound on the H100: bytes.  It reads u, v, p once and writes 16 arrays
// (23 with the fold), about 0.09 ms (0.13 ms folded) of HBM traffic at
// 2048^2 against ~100 flops a face.  Design: one thread per face, one pass,
// coalesced reads and writes (the TPU's strip windows and DMA are the
// L1/L2's job here); the face math is csrc/powerlaw.cuh's, shared with K1
// and K6.  The pressure operator recomputes the relaxed a_p of its four
// faces instead of reading d back, so no second pass is needed.  Blocks run
// in no order: each writes its own Gershgorin maxima and the wrapper reduces
// them, as the JAX wrapper reduces its per-strip tiles.

#include "common.cuh"
#include "powerlaw.cuh"

namespace {

constexpr int THREADS = 256;

struct AsmParams {
  const float* u;
  const float* v;
  const float* p;
  float* cu[8];  // a_e, a_w, a_n, a_s, a_p, src unrelaxed; a_p, src relaxed
  float* cv[8];
  float* gmax_u;
  float* gmax_v;
  float* d_u;    // the fold (variant >= 0) only
  float* d_v;
  float* pc[5];  // a_e, a_w, a_n, a_s, diag
  int nx, ny, variant;  // variant: -1 no fold, 0 consistent, 1 symmetric, 2 reference
  float cFu, cFv, De, Dn, dx, dy, alpha, one_m_alpha, rho;
};

// One face: write its eight coefficient arrays (and d); return its masked
// Gershgorin ratio (0 outside the solve mask).
template <bool IS_U>
__device__ float assemble_face(const AsmParams& P, int64_t g) {
  const int NJ = IS_U ? P.ny : P.ny + 1;
  const int NI = IS_U ? P.nx + 1 : P.nx;
  const int i = (int)(g / NJ), j = (int)(g % NJ);
  const Coef c = IS_U ? u_coef(P, i, j) : v_coef(P, i, j);
  const float apr = relax_ap(P, c.ap);
  const float x = IS_U ? P.u[g] : P.v[g];
  float* const* out = IS_U ? P.cu : P.cv;
  out[0][g] = c.ae; out[1][g] = c.aw; out[2][g] = c.an; out[3][g] = c.as;
  out[4][g] = c.ap; out[5][g] = c.src;
  out[6][g] = apr;
  out[7][g] = c.src + P.one_m_alpha * apr * x;
  if (P.variant >= 0) {
    const bool row = IS_U ? (i >= 1 && i <= P.nx - 1) : (j >= 1 && j <= P.ny - 1);
    (IS_U ? P.d_u : P.d_v)[g] = (row && fabsf(apr) > 1e-12f) ? (IS_U ? P.dy : P.dx) / apr : 0.f;
  }
  if (i < 1 || i > NI - 2 || j < 1 || j > NJ - 2) return 0.f;
  const float safe = apr == 0.f ? 1.f : apr;
  return (fabsf(c.ae) + fabsf(c.aw) + fabsf(c.an) + fabsf(c.as)) / safe;
}

__global__ void __launch_bounds__(THREADS) assembly_kernel(AsmParams P) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nu = (int64_t)(P.nx + 1) * P.ny, nv = (int64_t)P.nx * (P.ny + 1),
                np = (int64_t)P.nx * P.ny;
  float gu = 0.f, gv = 0.f;
  if (g < nu) gu = assemble_face<true>(P, g);
  if (g < nv) gv = assemble_face<false>(P, g);
  if (P.variant >= 0 && g < np)
    pressure_cell_from_faces(P, P.variant, (int)(g / P.ny), (int)(g % P.ny), P.pc, g);
  gu = nf_block_max(gu);
  __syncthreads();  // nf_block_max's shared scratch is reused
  gv = nf_block_max(gv);
  if (threadIdx.x == 0) {
    P.gmax_u[blockIdx.x] = gu;
    P.gmax_v[blockIdx.x] = gv;
  }
}

}  // namespace

// ptrs: u, v, p, 8 u-coefficient arrays, 8 v-coefficient arrays, gmax_u,
//       gmax_v (one float per block each), then with the fold d_u, d_v and
//       the pressure operator's a_e, a_w, a_n, a_s, diag
// ip:   nx, ny, variant (-1: no fold), blocks
// fp:   cFu, cFv, De, Dn, dx, dy, alpha, one_m_alpha, rho
NF_EXPORT int nf_fused_assembly_pair(const long long* ptrs, const int* ip, const float* fp,
                                     void* stream) {
  AsmParams P = {};
  int k = 0;
  auto next = [&]() { return reinterpret_cast<float*>(ptrs[k++]); };
  P.u = next(); P.v = next(); P.p = next();
  for (int a = 0; a < 8; ++a) P.cu[a] = next();
  for (int a = 0; a < 8; ++a) P.cv[a] = next();
  P.gmax_u = next(); P.gmax_v = next();
  P.nx = ip[0]; P.ny = ip[1]; P.variant = ip[2];
  if (P.variant >= 0) {
    P.d_u = next(); P.d_v = next();
    for (int a = 0; a < 5; ++a) P.pc[a] = next();
  }
  P.cFu = fp[0]; P.cFv = fp[1]; P.De = fp[2]; P.Dn = fp[3];
  P.dx = fp[4]; P.dy = fp[5]; P.alpha = fp[6]; P.one_m_alpha = fp[7]; P.rho = fp[8];
  assembly_kernel<<<ip[3], THREADS, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
