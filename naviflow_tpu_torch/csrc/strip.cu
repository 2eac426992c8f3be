// K2: temporally blocked fine multigrid levels — strip_down and strip_up.
//
// Replaces naviflow_tpu/ops/pallas_strip.py:strip_down (_mk_down_kernel)
// and :strip_up (_mk_up_kernel).
//   down: `sweeps` Gauss-Seidel sweeps, residual b - A p, and the full 2x2
//         cell-centred restriction of the residual (the TPU left the column
//         half of it to XLA for a VMEM limit that does not apply here);
//   up:   bilinear clamped prolongation of the coarse correction, add, then
//         `sweeps` Gauss-Seidel sweeps.
// Red-black colours (i + j) % 2 on 5-point levels, four colours
// (i % 2, j % 2) on 9-point Galerkin levels, always from GLOBAL indices.
//
// Bound on the H100: a level's sweeps reread the 5 or 9 stencil arrays and
// b for every colour pass, so the kernel is bound by L2/HBM reads of the
// stencil; p itself stays in shared memory through all passes.  Design:
// 2-D tiles of TILE x TILE owned cells with a halo of (colours x sweeps
// (+ 1 for the residual)) cells on every side, held in shared memory.  Each
// colour pass updates the region shrunk by one more ring, so the owned cells
// see exactly the global sweep; cells outside the grid hold 0 and are never
// updated (the zero padding of the composed shifts) — nothing reads outside
// an allocation.

#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;

struct Params {
  const float* p;
  const float* b;
  const float* st[9];  // c, e, w, n, s, ne, nw, se, sw (corners unused on 5-point)
  const float* ec;     // coarse correction (up only)
  float* out_p;
  float* out_rc;       // coarse residual (down only)
  int nx, ny, sweeps, halo;
  float omega;
};

template <int NS>
__device__ __forceinline__ float offdiag(const Params& P, const float* sp, int k, int RJ,
                                         int64_t g) {
  float off = P.st[1][g] * sp[k + RJ] + P.st[2][g] * sp[k - RJ] + P.st[3][g] * sp[k + 1] +
              P.st[4][g] * sp[k - 1];
  if (NS == 9)
    off = off + P.st[5][g] * sp[k + RJ + 1] + P.st[6][g] * sp[k - RJ + 1] +
          P.st[7][g] * sp[k + RJ - 1] + P.st[8][g] * sp[k - RJ - 1];
  return off;
}

// Load p (+ prolongated ec when `up`) on the region; cells off the grid hold 0.
template <bool UP>
__device__ void load_region(const Params& P, float* sp, int i0r, int j0r, int RI, int RJ) {
  for (int k = threadIdx.x; k < RI * RJ; k += blockDim.x) {
    const int gi = i0r + k / RJ, gj = j0r + k % RJ;
    float val = 0.f;
    if (gi >= 0 && gi < P.nx && gj >= 0 && gj < P.ny) {
      val = P.p[(int64_t)gi * P.ny + gj];
      if (UP) val = val + nf_prolong_cc(P.ec, P.nx / 2, P.ny / 2, gi, gj);
    }
    sp[k] = val;
  }
  __syncthreads();
}

// All colour passes of all sweeps; pass n updates region rows/cols [n, R-n).
template <int NS>
__device__ void smooth_region(const Params& P, float* sp, int i0r, int j0r, int RI, int RJ) {
  const int colors = NS == 5 ? 2 : 4;
  int pass = 0;
  for (int s = 0; s < P.sweeps; ++s) {
    for (int c = 0; c < colors; ++c) {
      ++pass;
      const int ni = RI - 2 * pass, nj = RJ - 2 * pass;
      for (int k = threadIdx.x; k < ni * nj; k += blockDim.x) {
        const int a = pass + k / nj, bb = pass + k % nj;
        const int gi = i0r + a, gj = j0r + bb;
        if (gi < 0 || gi >= P.nx || gj < 0 || gj >= P.ny) continue;
        const int color = NS == 5 ? ((gi + gj) & 1) : (((gi & 1) << 1) | (gj & 1));
        if (color != c) continue;
        const int64_t g = (int64_t)gi * P.ny + gj;
        const int kk = a * RJ + bb;
        const float pnew = (P.b[g] - offdiag<NS>(P, sp, kk, RJ, g)) * nf_inv_diag(P.st[0][g]);
        sp[kk] = sp[kk] + P.omega * (pnew - sp[kk]);
      }
      __syncthreads();
    }
  }
}

template <int NS>
__device__ __forceinline__ float residual(const Params& P, const float* sp, int k, int RJ,
                                          int64_t g) {
  float ax = P.st[0][g] * sp[k] + P.st[1][g] * sp[k + RJ] + P.st[2][g] * sp[k - RJ] +
             P.st[3][g] * sp[k + 1] + P.st[4][g] * sp[k - 1];
  if (NS == 9)
    ax = ax + P.st[5][g] * sp[k + RJ + 1] + P.st[6][g] * sp[k - RJ + 1] +
         P.st[7][g] * sp[k + RJ - 1] + P.st[8][g] * sp[k - RJ - 1];
  return P.b[g] - ax;
}

template <int NS>
__global__ void __launch_bounds__(THREADS) strip_down_kernel(Params P) {
  extern __shared__ float sp[];
  const int H = P.halo, RI = TILE + 2 * H, RJ = TILE + 2 * H;
  const int ti0 = blockIdx.y * TILE, tj0 = blockIdx.x * TILE;
  load_region<false>(P, sp, ti0 - H, tj0 - H, RI, RJ);
  smooth_region<NS>(P, sp, ti0 - H, tj0 - H, RI, RJ);
  for (int k = threadIdx.x; k < TILE * TILE; k += blockDim.x) {
    const int gi = ti0 + k / TILE, gj = tj0 + k % TILE;
    if (gi < P.nx && gj < P.ny)
      P.out_p[(int64_t)gi * P.ny + gj] = sp[(H + k / TILE) * RJ + H + k % TILE];
  }
  // residual of the owned cells, restricted 2x2 (axis 0 first, as
  // ops/transfer_cc.restrict_cc)
  constexpr int TC = TILE / 2;
  const int ncj = P.ny / 2;
  for (int k = threadIdx.x; k < TC * TC; k += blockDim.x) {
    const int gi = ti0 + 2 * (k / TC), gj = tj0 + 2 * (k % TC);
    if (gi >= P.nx || gj >= P.ny) continue;
    const int kk = (H + 2 * (k / TC)) * RJ + H + 2 * (k % TC);
    const int64_t g = (int64_t)gi * P.ny + gj;
    const float r00 = residual<NS>(P, sp, kk, RJ, g);
    const float r10 = residual<NS>(P, sp, kk + RJ, RJ, g + P.ny);
    const float r01 = residual<NS>(P, sp, kk + 1, RJ, g + 1);
    const float r11 = residual<NS>(P, sp, kk + RJ + 1, RJ, g + P.ny + 1);
    P.out_rc[(int64_t)(gi / 2) * ncj + gj / 2] =
        0.5f * (0.5f * (r00 + r10) + 0.5f * (r01 + r11));
  }
}

template <int NS>
__global__ void __launch_bounds__(THREADS) strip_up_kernel(Params P) {
  extern __shared__ float sp[];
  const int H = P.halo, RI = TILE + 2 * H, RJ = TILE + 2 * H;
  const int ti0 = blockIdx.y * TILE, tj0 = blockIdx.x * TILE;
  load_region<true>(P, sp, ti0 - H, tj0 - H, RI, RJ);
  smooth_region<NS>(P, sp, ti0 - H, tj0 - H, RI, RJ);
  for (int k = threadIdx.x; k < TILE * TILE; k += blockDim.x) {
    const int gi = ti0 + k / TILE, gj = tj0 + k % TILE;
    if (gi < P.nx && gj < P.ny)
      P.out_p[(int64_t)gi * P.ny + gj] = sp[(H + k / TILE) * RJ + H + k % TILE];
  }
}

int launch(bool down, const long long* ptrs, const int* ip, const float* fp, void* stream) {
  Params P = {};
  const int nx = ip[0], ny = ip[1], five = ip[2], sweeps = ip[3];
  const int ns = five ? 5 : 9;
  P.p = reinterpret_cast<const float*>(ptrs[0]);
  P.b = reinterpret_cast<const float*>(ptrs[1]);
  for (int k = 0; k < ns; ++k) P.st[k] = reinterpret_cast<const float*>(ptrs[2 + k]);
  if (down) {
    P.out_p = reinterpret_cast<float*>(ptrs[2 + ns]);
    P.out_rc = reinterpret_cast<float*>(ptrs[3 + ns]);
  } else {
    P.ec = reinterpret_cast<const float*>(ptrs[2 + ns]);
    P.out_p = reinterpret_cast<float*>(ptrs[3 + ns]);
  }
  P.nx = nx; P.ny = ny; P.sweeps = sweeps; P.omega = fp[0];
  P.halo = (five ? 2 : 4) * sweeps + (down ? 1 : 0);
  const int R = TILE + 2 * P.halo;
  const size_t smem = sizeof(float) * R * R;
  dim3 grid((ny + TILE - 1) / TILE, (nx + TILE - 1) / TILE);
  cudaStream_t s = (cudaStream_t)stream;
  if (down) {
    if (five) strip_down_kernel<5><<<grid, THREADS, smem, s>>>(P);
    else strip_down_kernel<9><<<grid, THREADS, smem, s>>>(P);
  } else {
    if (five) strip_up_kernel<5><<<grid, THREADS, smem, s>>>(P);
    else strip_up_kernel<9><<<grid, THREADS, smem, s>>>(P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: p, b, stencil (5 or 9), out_p, out_rc;  ip: nx, ny, five, sweeps;  fp: omega
NF_EXPORT int nf_strip_down(const long long* ptrs, const int* ip, const float* fp,
                            void* stream) {
  return launch(true, ptrs, ip, fp, stream);
}

// ptrs: p, b, stencil (5 or 9), ec, out_p;  ip: nx, ny, five, sweeps;  fp: omega
NF_EXPORT int nf_strip_up(const long long* ptrs, const int* ip, const float* fp,
                          void* stream) {
  return launch(false, ptrs, ip, fp, stream);
}
