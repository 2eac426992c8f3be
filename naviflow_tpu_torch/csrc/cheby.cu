// K9: fixed-degree Chebyshev solve of one momentum field plus its unrelaxed
// residual, from coefficients in device memory.
//
// Replaces naviflow_tpu/ops/pallas_cheby.py:chebyshev_momentum_strips
// (body _mk_kernel).  What it computes, on an (NI, NJ) field whose solve mask
// is 1 <= i <= NI-2, 1 <= j <= NJ-2 (both staggered fields):
//   solve      solvers/momentum._chebyshev_iterate, `degree` steps on the
//              relaxed system, interval scalars (theta, delta, sigma1) read
//              from device memory (no host read between K8 and K9)
//   residual   r = src_un - A_un x*, zero outside the mask, with the
//              relaxed system's links and the unrelaxed (a_p, src)
//   x*         mask ? x : x0 (the last row stays as in x0)
//
// Bound on the H100: bytes.  It reads 9 arrays and writes 2, about 0.055 ms
// of HBM traffic per field at 2048^2.  Design: K1's 2-D halo tiles (TILE x
// TILE owned faces, a halo of H = degree + 1 faces on every side) with the
// coefficients loaded once into shared memory instead of assembled; each
// stencil apply invalidates one more ring of the halo, so after `degree`
// applies the ring next to the owned tile is still exact for the residual.
// The halo is re-read by neighbouring tiles (about (TILE+2H)^2 / TILE^2 =
// 1.7x the owned bytes at degree 4), which the L2 mostly absorbs.

#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;

struct ChebyParams {
  const float *x0, *ae, *aw, *an, *as, *ap, *src, *ap_un, *src_un;
  const float* bounds;  // theta, delta, sigma1
  float *x_out, *r_out;
  int ni, nj, degree;
};

__global__ void __launch_bounds__(THREADS) cheby_kernel(ChebyParams P) {
  extern __shared__ float smem[];
  const int H = P.degree + 1;
  const int RI = TILE + 2 * H, RJ = TILE + 2 * H, R = RI * RJ;
  const int NI = P.ni, NJ = P.nj;
  const int ti0 = blockIdx.y * TILE, tj0 = blockIdx.x * TILE;
  const float theta = P.bounds[0], delta = P.bounds[1], sigma1 = P.bounds[2];
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
      const int64_t g = (int64_t)gi * NJ + gj;
      const float m = in_mask(gi, gj) ? 1.f : 0.f;
      ae = P.ae[g]; aw = P.aw[g]; an = P.an[g]; as = P.as[g]; ap = P.ap[g];
      b = P.src[g] * m;
      x = P.x0[g] * m;
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

  // owned faces: x* = mask ? x : x0 and the unrelaxed residual
  auto x_final = [&](int a, int bb) {
    const int gi = ti0 - H + a, gj = tj0 - H + bb;
    if (gi < 0 || gi >= NI || gj < 0 || gj >= NJ) return 0.f;
    return in_mask(gi, gj) ? sx[a * RJ + bb] : P.x0[(int64_t)gi * NJ + gj];
  };
  for (int k = threadIdx.x; k < TILE * TILE; k += blockDim.x) {
    const int a = H + k / TILE, bb = H + k % TILE;
    const int gi = ti0 + k / TILE, gj = tj0 + k % TILE;
    if (gi >= NI || gj >= NJ) continue;
    const int s = a * RJ + bb;
    const int64_t g = (int64_t)gi * NJ + gj;
    const float xc = x_final(a, bb);
    float r = 0.f;
    if (in_mask(gi, gj))
      r = P.src_un[g] - ((((P.ap_un[g] * xc - sae[s] * x_final(a + 1, bb)) -
                           saw[s] * x_final(a - 1, bb)) - san[s] * x_final(a, bb + 1)) -
                         sas[s] * x_final(a, bb - 1));
    P.x_out[g] = xc;
    P.r_out[g] = r;
  }
}

}  // namespace

// ptrs: x0, a_e, a_w, a_n, a_s, a_p relaxed, src relaxed, a_p unrelaxed,
//       src unrelaxed, bounds (theta, delta, sigma1), x*, r
// ip:   ni, nj, degree, grid_x, grid_y
// fp:   unused
NF_EXPORT int nf_chebyshev_strips(const long long* ptrs, const int* ip, const float* fp,
                                  void* stream) {
  (void)fp;
  ChebyParams P;
  const float** ins[] = {&P.x0, &P.ae, &P.aw, &P.an, &P.as, &P.ap, &P.src, &P.ap_un, &P.src_un,
                         &P.bounds};
  for (int k = 0; k < 10; ++k) *ins[k] = reinterpret_cast<const float*>(ptrs[k]);
  P.x_out = reinterpret_cast<float*>(ptrs[10]);
  P.r_out = reinterpret_cast<float*>(ptrs[11]);
  P.ni = ip[0]; P.nj = ip[1]; P.degree = ip[2];
  const int H = P.degree + 1;
  const size_t smem = sizeof(float) * 8 * (TILE + 2 * H) * (TILE + 2 * H);
  cudaError_t err = cudaFuncSetAttribute(
      cheby_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ip[3], ip[4]);
  cheby_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
