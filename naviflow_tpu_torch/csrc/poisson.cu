// K11: whole-array red-black SOR sweeps (K11a) and the 5-point matvec
// (K11b) of the pressure-correction operator, unpinned.
//
// Replaces naviflow_tpu/ops/pallas_kernels.py:rbgs_sweeps_pallas
// (_rbgs_kernel) and :apply_poisson_pallas (_matvec_kernel).  Both take
// arrays of at most 256^2 cells (PALLAS_MAX_CELLS, the wrapper's rule).
//   K11a: `n_sweeps` sweeps of p + omega * (p_new - p) with
//         p_new = (b + sum(a_nb * p_nb)) * invd, red ((i+j) even) cells
//         first, then black, in one launch;
//   K11b: diag * p - a_e * p_e - a_w * p_w - a_n * p_n - a_s * p_s.
// K11a accumulates the neighbour sum e, w, n, s in that order, as the TPU
// kernel's _nbsum and the plain rbgs_sweep; K11b subtracts term by term in
// the plain apply_poisson's order (the TPU kernel subtracted the whole sum,
// a reassociation within the matvec tolerance).  Cells off the grid read 0
// (the TPU kernels' wrapped rolls are annihilated by the zero boundary
// links).
//
// Bound on the H100: K11b is bound by bytes (one pass over six arrays).
// K11a is a chain of 2 * n_sweeps dependent half-sweeps: every red update
// must land before any black update reads it.  Design: ONE block of 1024
// threads loops over the half-sweeps with __syncthreads() between them,
// reading and writing the iterate in global memory (it stays in L2: 256^2
// floats are 256 KB); a single block needs no grid-wide barrier, at the
// price of using one SM.

#include "common.cuh"

namespace {

constexpr int RBGS_THREADS = 1024;
constexpr int MATVEC_THREADS = 256;

struct Params {
  const float* p;
  const float* b;    // K11a only
  const float* ae;
  const float* aw;
  const float* an;
  const float* as;
  const float* d;    // K11a: invd; K11b: diag
  float* out;
  int nx, ny;
};

// The four neighbours of cell (i, j) of x, 0 off the grid.  x is not
// __restrict__: K11a reads it while it writes the same array, and the
// read-only (non-coherent) cache path would return stale values.
struct Nbrs {
  float e, w, n, s;
};

__device__ __forceinline__ Nbrs nbrs(const Params& P, const float* x, int i, int j, int64_t g) {
  return Nbrs{i + 1 < P.nx ? x[g + P.ny] : 0.f, i > 0 ? x[g - P.ny] : 0.f,
              j + 1 < P.ny ? x[g + 1] : 0.f, j > 0 ? x[g - 1] : 0.f};
}

__device__ __forceinline__ float nbsum(const Params& P, const float* x, int i, int j,
                                       int64_t g) {
  const Nbrs v = nbrs(P, x, i, j, g);
  return P.ae[g] * v.e + P.aw[g] * v.w + P.an[g] * v.n + P.as[g] * v.s;
}

__global__ void __launch_bounds__(RBGS_THREADS) rbgs_kernel(Params P, int n_sweeps,
                                                            float omega) {
  const int cells = P.nx * P.ny;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) P.out[k] = P.p[k];
  __syncthreads();
  const int half_row = (P.ny + 1) / 2;  // cells of one colour in a row, rounded up
  for (int s = 0; s < n_sweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      for (int k = threadIdx.x; k < P.nx * half_row; k += blockDim.x) {
        const int i = k / half_row;
        const int j = 2 * (k % half_row) + ((i + color) & 1);
        if (j >= P.ny) continue;
        const int64_t g = (int64_t)i * P.ny + j;
        const float x = P.out[g];
        const float pnew = (P.b[g] + nbsum(P, P.out, i, j, g)) * P.d[g];
        P.out[g] = x + omega * (pnew - x);
      }
      __syncthreads();  // this colour's updates land before the other reads them
    }
  }
}

__global__ void __launch_bounds__(MATVEC_THREADS) matvec_kernel(Params P) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (int64_t)P.nx * P.ny) return;
  const int i = (int)(g / P.ny), j = (int)(g % P.ny);
  const Nbrs v = nbrs(P, P.p, i, j, g);
  P.out[g] = P.d[g] * P.p[g] - P.ae[g] * v.e - P.aw[g] * v.w - P.an[g] * v.n - P.as[g] * v.s;
}

Params params(const long long* ptrs, const int* ip) {
  Params P = {};
  int k = 0;
  P.p = reinterpret_cast<const float*>(ptrs[k++]);
  P.b = reinterpret_cast<const float*>(ptrs[k++]);
  P.ae = reinterpret_cast<const float*>(ptrs[k++]);
  P.aw = reinterpret_cast<const float*>(ptrs[k++]);
  P.an = reinterpret_cast<const float*>(ptrs[k++]);
  P.as = reinterpret_cast<const float*>(ptrs[k++]);
  P.d = reinterpret_cast<const float*>(ptrs[k++]);
  P.out = reinterpret_cast<float*>(ptrs[k]);
  P.nx = ip[0];
  P.ny = ip[1];
  return P;
}

}  // namespace

// ptrs: p, b, a_e, a_w, a_n, a_s, invd, out;  ip: nx, ny, n_sweeps;  fp: omega
NF_EXPORT int nf_rbgs_sweeps(const long long* ptrs, const int* ip, const float* fp,
                             void* stream) {
  const Params P = params(ptrs, ip);
  rbgs_kernel<<<1, RBGS_THREADS, 0, (cudaStream_t)stream>>>(P, ip[2], fp[0]);
  return (int)cudaGetLastError();
}

// One argument per pointer and integer (the lean call of ops/_cuda.py: the
// wrapper builds no host array per call).
NF_EXPORT int nf_apply_poisson(const float* p, const float* ae, const float* aw,
                               const float* an, const float* as, const float* diag, float* out,
                               int nx, int ny, void* stream) {
  Params P = {};
  P.p = p; P.ae = ae; P.aw = aw; P.an = an; P.as = as; P.d = diag; P.out = out;
  P.nx = nx; P.ny = ny;
  const int64_t cells = (int64_t)P.nx * P.ny;
  const int blocks = (int)((cells + MATVEC_THREADS - 1) / MATVEC_THREADS);
  matvec_kernel<<<blocks, MATVEC_THREADS, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
