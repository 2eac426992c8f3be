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
//
// The case axis (nf_fused_assembly_pair_batched; the batching rule of
// ops/assembly.py, the vmapped lockstep step of algorithms/batch.py): B
// cases of one shape in one launch, the grid's y axis over the cases, one
// wave of resident CTAs each walking its case's blocks of faces.  Thread 0
// of each CTA moves every pointer of the case-0 parameters by its case's
// stride into a shared-memory copy (asm_case) and takes the case's De and
// Dn from its conductance row (ops/powerlaw.case_conductances: the single
// wrapper's doubles rounded to float, so the same floats), and the single
// launch's block code runs on that view, block by block, so each case's
// bits (the Gershgorin partials too, one a block of faces) are its single
// launch's.  A frozen case's blocks write zeros to every
// output of their faces and cells (links, a_p and src, relaxed or not, d,
// the pressure operator) and to their Gershgorin partials: the composed
// operators downstream guard a zero a_p and a zero diagonal, so a frozen
// case stays finite, and the lockstep loop drops its results.

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

// Block bx's faces and cells (THREADS of each): the coefficient sets, d and
// the pressure operator, and the block's Gershgorin maxima into its two
// partials.
__device__ __forceinline__ void assembly_block(const AsmParams& P, int bx) {
  const int64_t g = (int64_t)bx * THREADS + threadIdx.x;
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
    P.gmax_u[bx] = gu;
    P.gmax_v[bx] = gv;
  }
}

__global__ void __launch_bounds__(THREADS) assembly_kernel(AsmParams P) {
  assembly_block(P, blockIdx.x);
}

// B cases of one shape (the case axis): case 0's parameters, each pointer
// field's case stride in bytes (the same fields of S), each case's
// conductances (De, Dn, 1 / De, 1 / Dn; De and Dn read) and the active
// flags, each with its stride.
struct AsmBatch {
  AsmParams P, S;
  const float* visc;
  const float* visc_stride;
  const bool* active;
  const bool* active_stride;
};

// Case b's view of the parameters into P (thread 0), and whether it is
// active: every pointer moved by b times its stride, De and Dn its own.
__device__ __forceinline__ void asm_case(const AsmBatch& SB, int b, AsmParams& P, bool& on) {
  P = SB.P;
  nf_case_shift(P.u, SB.S.u, b);
  nf_case_shift(P.v, SB.S.v, b);
  nf_case_shift(P.p, SB.S.p, b);
  for (int a = 0; a < 8; ++a) {
    nf_case_shift(P.cu[a], SB.S.cu[a], b);
    nf_case_shift(P.cv[a], SB.S.cv[a], b);
  }
  nf_case_shift(P.gmax_u, SB.S.gmax_u, b);
  nf_case_shift(P.gmax_v, SB.S.gmax_v, b);
  if (P.variant >= 0) {
    nf_case_shift(P.d_u, SB.S.d_u, b);
    nf_case_shift(P.d_v, SB.S.d_v, b);
    for (int a = 0; a < 5; ++a) nf_case_shift(P.pc[a], SB.S.pc[a], b);
  }
  const float* visc = SB.visc;
  nf_case_shift(visc, SB.visc_stride, b);
  P.De = visc[0];
  P.Dn = visc[1];
  const bool* active = SB.active;
  nf_case_shift(active, SB.active_stride, b);
  on = *active;
}

// A frozen case's block bx: zeros in every output of its faces and cells
// and in its two Gershgorin partials.
__device__ __forceinline__ void assembly_frozen(const AsmParams& P, int bx) {
  const int64_t g = (int64_t)bx * THREADS + threadIdx.x;
  const int64_t nu = (int64_t)(P.nx + 1) * P.ny, nv = (int64_t)P.nx * (P.ny + 1),
                np = (int64_t)P.nx * P.ny;
  for (int a = 0; a < 8; ++a) {
    if (g < nu) P.cu[a][g] = 0.f;
    if (g < nv) P.cv[a][g] = 0.f;
  }
  if (P.variant >= 0) {
    if (g < nu) P.d_u[g] = 0.f;
    if (g < nv) P.d_v[g] = 0.f;
    if (g < np)
      for (int a = 0; a < 5; ++a) P.pc[a][g] = 0.f;
  }
  if (threadIdx.x == 0) {
    P.gmax_u[bx] = 0.f;
    P.gmax_v[bx] = 0.f;
  }
}

// Grid (x, B): CTA (x, b) builds case b's view once and runs the single
// launch's blocks x, x + gridDim.x, ... on it (the view's setup, one
// thread's global reads and a barrier, is paid once a CTA, not once a
// block of faces).
__global__ void __launch_bounds__(THREADS) assembly_kernel_batched(AsmBatch SB, int blocks) {
  __shared__ AsmParams P;  // this case's view
  __shared__ bool on;
  if (threadIdx.x == 0) asm_case(SB, (int)blockIdx.y, P, on);
  __syncthreads();
  for (int bx = blockIdx.x; bx < blocks; bx += gridDim.x) {
    if (on)
      assembly_block(P, bx);
    else
      assembly_frozen(P, bx);
    __syncthreads();  // nf_block_max's shared scratch is reused by the next block
  }
}

// nf_fused_assembly_pair's slots, ip and fp into P; returns the number of
// slots read (21, or 28 with the fold).  The batched entry reads case 0's
// slots and then their strides with it.
int read_assembly(const long long* ptrs, const int* ip, const float* fp, AsmParams& P) {
  P = {};
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
  return k;
}

}  // namespace

// ptrs: u, v, p, 8 u-coefficient arrays, 8 v-coefficient arrays, gmax_u,
//       gmax_v (one float per block each), then with the fold d_u, d_v and
//       the pressure operator's a_e, a_w, a_n, a_s, diag
// ip:   nx, ny, variant (-1: no fold), blocks
// fp:   cFu, cFv, De, Dn, dx, dy, alpha, one_m_alpha, rho
NF_EXPORT int nf_fused_assembly_pair(const long long* ptrs, const int* ip, const float* fp,
                                     void* stream) {
  AsmParams P;
  read_assembly(ptrs, ip, fp, P);
  assembly_kernel<<<ip[3], THREADS, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// B cases of one shape in one launch (the case axis; grid (blocks, B)).
// ptrs: nf_fused_assembly_pair's n slots for case 0 (n = 21, 28 with the
//       fold; gmax_u, gmax_v one float per block of the case), the cases'
//       conductances (B, 4: De, Dn, 1 / De, 1 / Dn), the active flags
//       (bool), then each of these n + 2 slots' case stride in bytes, in the
//       same order (0: one array shared by every case)
// ip:   nf_fused_assembly_pair's, then B
// fp:   nf_fused_assembly_pair's (De and Dn unused: each case's own)
NF_EXPORT int nf_fused_assembly_pair_batched(const long long* ptrs, const int* ip,
                                             const float* fp, void* stream) {
  AsmBatch SB;
  const int n = read_assembly(ptrs, ip, fp, SB.P);
  const int half = n + 2;
  read_assembly(ptrs + half, ip, fp, SB.S);
  SB.visc = reinterpret_cast<const float*>(ptrs[n]);
  SB.visc_stride = reinterpret_cast<const float*>(ptrs[half + n]);
  SB.active = reinterpret_cast<const bool*>(ptrs[n + 1]);
  SB.active_stride = reinterpret_cast<const bool*>(ptrs[half + n + 1]);
  const int cases = ip[4], blocks = ip[3];
  if (!SB.visc || !SB.active || cases < 1 || cases > 65535) return (int)cudaErrorInvalidValue;
  // one wave of resident CTAs over the B cases, each walking its case's blocks
  static int resident[16];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 16) return (int)cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, assembly_kernel_batched,
                                                          THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    resident[device] = per_sm * n_sm;
  }
  const int per_case = (resident[device] + cases - 1) / cases;
  const dim3 grid(per_case < blocks ? per_case : blocks, cases);
  assembly_kernel_batched<<<grid, THREADS, 0, (cudaStream_t)stream>>>(SB, blocks);
  return (int)cudaGetLastError();
}
