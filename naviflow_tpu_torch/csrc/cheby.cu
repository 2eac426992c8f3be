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
// of HBM traffic per field at 2048^2.  Design: 2-D halo tiles (a tile's
// region of RI x RJ faces is its owned faces and a halo of H = degree + 1
// on every side; each stencil apply invalidates one more ring of the halo,
// so after `degree` applies the ring next to the owned faces is still exact
// for the residual).  Persistent blocks, two an SM, walk the tiles; each
// thread owns a fixed set of a region's faces:
//   * a tile's seven region arrays (x0, the links, a_p, the source) arrive
//     by 4-byte cp.async in a shared-memory stage, each thread copying its
//     own faces, so a thread reads back only what it copied and the stage
//     needs no block barrier;
//   * the thread moves its faces' values into registers (links, a_p,
//     masked source, mask, mask / a_p, iterate, Chebyshev direction) and at
//     once starts the next tile's copies into the stage, so the next tile's
//     loads are in flight through this tile's steps;
//   * only the iterate goes through shared memory, double-buffered with a
//     zero border: a step is one block barrier and no bounds test.
// A region is 32 x 64 faces at degree 4 (256 threads, 8 faces each), so
// the halo re-reads are 1.7x the owned bytes, mostly served by the L2.
// What bounds the loads is the requests an SM keeps in flight: the stage's
// asynchronous copies keep them in flight through the steps.  (Regions of
// 64 x 64, 512 threads and one block an SM, ran 5% slower on the H100.)

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CPL = 2;          // region columns per lane
constexpr int RJ = 32 * CPL;    // 64 region columns
constexpr int PJ = RJ + 2;      // the iterate buffers' pitch: a zero border
constexpr int STAGED = 7;       // arrays in the stage: x0, a_e, a_w, a_n, a_s, a_p, src

// Region rows per warp: 4 (32 rows, 8 faces a thread, two blocks an SM) up
// to degree 7, 8 above (64 rows, so that the owned tile keeps >= 32 rows
// under a halo of up to 16).
__host__ __device__ constexpr int rows_per_warp(int degree) { return degree <= 7 ? 4 : 8; }
__host__ __device__ constexpr int region_i(int degree) { return WARPS * rows_per_warp(degree); }

// The owned tile of the region at `degree` (halo degree + 1).
__host__ __device__ constexpr int tile_i(int degree) { return region_i(degree) - 2 * (degree + 1); }
__host__ __device__ constexpr int tile_j(int degree) { return RJ - 2 * (degree + 1); }

// Dynamic shared memory of one block: the stage and the two iterate buffers.
__host__ __device__ constexpr int smem_floats(int degree) {
  return STAGED * region_i(degree) * RJ + 2 * (region_i(degree) + 2) * PJ;
}

struct ChebyParams {
  const float *x0, *ae, *aw, *an, *as, *ap, *src, *ap_un, *src_un;
  const float *theta, *delta, *sigma1;
  float *x_out, *r_out;
  int ni, nj, tiles_j, tiles;
};

// This thread's faces of tile `t` into the stage (zeros off the grid).
template <int DEG>
__device__ __forceinline__ void stage_tile(const ChebyParams& P, int t, float* stage) {
  constexpr int RI = region_i(DEG), H = DEG + 1, CELLS = rows_per_warp(DEG) * CPL;
  const float* arrays[STAGED] = {P.x0, P.ae, P.aw, P.an, P.as, P.ap, P.src};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ti0 = (t / P.tiles_j) * tile_i(DEG), tj0 = (t % P.tiles_j) * tile_j(DEG);
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    const int r = warp + WARPS * (c / CPL), q = lane + 32 * (c % CPL);
    const int gi = ti0 - H + r, gj = tj0 - H + q;
    const bool in = gi >= 0 && gi < P.ni && gj >= 0 && gj < P.nj;
    const int64_t g = in ? (int64_t)gi * P.nj + gj : 0;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(stage + r * RJ + q);
#pragma unroll
    for (int a = 0; a < STAGED; ++a)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + 4u * a * RI * RJ),
                   "l"(arrays[a] + g), "r"(in ? 4 : 0)
                   : "memory");
    // the unrelaxed a_p and source of the owned faces, read at the tile's
    // end, into the L2 meanwhile
    if (in && r >= H && r < H + tile_i(DEG) && q >= H && q < H + tile_j(DEG)) {
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(P.ap_un + g));
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(P.src_un + g));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int DEG>
__global__ void __launch_bounds__(THREADS, DEG <= 7 ? 2 : 1) cheby_kernel(ChebyParams P) {
  constexpr int H = DEG + 1;
  constexpr int RI = region_i(DEG);              // region rows
  constexpr int CELLS = rows_per_warp(DEG) * CPL;  // faces a thread
  constexpr int TI = tile_i(DEG), TJ = tile_j(DEG);
  extern __shared__ __align__(16) float dyn[];
  float* stage = dyn;                     // STAGED x RI x RJ
  float* sx0 = dyn + STAGED * RI * RJ;    // two (RI + 2) x PJ iterate buffers
  float* sx1 = sx0 + (RI + 2) * PJ;
  const int NI = P.ni, NJ = P.nj;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float theta = *P.theta, delta = *P.delta, sigma1 = *P.sigma1;

  // zero both iterate buffers once: the borders stay zero, every interior
  // slot is rewritten for each tile before a barrier lets it be read
  for (int k = threadIdx.x; k < 2 * (RI + 2) * PJ; k += THREADS) sx0[k] = 0.f;
  int t = blockIdx.x;
  if (t < P.tiles) stage_tile<DEG>(P, t, stage);

  for (; t < P.tiles; t += gridDim.x) {
    const int ti0 = (t / P.tiles_j) * TI, tj0 = (t % P.tiles_j) * TJ;
    float ae[CELLS], aw[CELLS], an[CELLS], as[CELLS], ap[CELLS], b[CELLS], m[CELLS],
        minv[CELLS], x[CELLS], d[CELLS];
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int r = warp + WARPS * (c / CPL), q = lane + 32 * (c % CPL);
      const float* s = stage + r * RJ + q;
      x[c] = s[0];
      ae[c] = s[1 * RI * RJ];
      aw[c] = s[2 * RI * RJ];
      an[c] = s[3 * RI * RJ];
      as[c] = s[4 * RI * RJ];
      ap[c] = s[5 * RI * RJ];
      b[c] = s[6 * RI * RJ];
    }
    // the last tile's reads of the iterate buffers are done, and so are this
    // thread's reads of the stage, which the next tile's copies overwrite:
    // those loads fly through this tile's steps
    __syncthreads();
    if (t + (int)gridDim.x < P.tiles) stage_tile<DEG>(P, t + gridDim.x, stage);
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int r = warp + WARPS * (c / CPL), q = lane + 32 * (c % CPL);
      const int gi = ti0 - H + r, gj = tj0 - H + q;
      const bool mask = gi >= 1 && gi <= NI - 2 && gj >= 1 && gj <= NJ - 2;
      m[c] = mask ? 1.f : 0.f;
      b[c] = b[c] * m[c];
      x[c] = x[c] * m[c];
      const float safe_ap = ap[c] == 0.f ? 1.f : ap[c];
      minv[c] = m[c] / safe_ap;
      d[c] = 0.f;
      sx0[(r + 1) * PJ + q + 1] = x[c];
    }
    __syncthreads();

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

    // x* = mask ? x : x0 into the buffer the last step read (read by nobody
    // since the last barrier), then the owned faces' unrelaxed residual
    float* fin = (DEG & 1) ? sx0 : sx1;
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int r = warp + WARPS * (c / CPL), q = lane + 32 * (c % CPL);
      const int gi = ti0 - H + r, gj = tj0 - H + q;
      float xf = 0.f;
      if (gi >= 0 && gi < NI && gj >= 0 && gj < NJ)
        xf = m[c] != 0.f ? x[c] : P.x0[(int64_t)gi * NJ + gj];
      x[c] = xf;
      fin[(r + 1) * PJ + q + 1] = xf;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      const int r = warp + WARPS * (c / CPL), q = lane + 32 * (c % CPL);
      const int gi = ti0 - H + r, gj = tj0 - H + q;
      if (r < H || r >= H + TI || q < H || q >= H + TJ || gi >= NI || gj >= NJ) continue;
      const int s = (r + 1) * PJ + q + 1;
      const int64_t g = (int64_t)gi * NJ + gj;
      float res = 0.f;
      if (m[c] != 0.f)
        res = P.src_un[g] - ((((P.ap_un[g] * x[c] - ae[c] * fin[s + PJ]) - aw[c] * fin[s - PJ]) -
                              an[c] * fin[s + 1]) -
                             as[c] * fin[s - 1]);
      P.x_out[g] = x[c];
      P.r_out[g] = res;
    }
  }
}

using Kernel = void (*)(ChebyParams);

template <int DEG>
Kernel kernel_of(int degree) {
  if constexpr (DEG > 15) {
    return nullptr;
  } else {
    return degree == DEG ? cheby_kernel<DEG> : kernel_of<DEG + 1>(degree);
  }
}

// Per device ordinal and degree: the blocks a launch runs (0 = not set up).
int g_blocks[16][16];

}  // namespace

// ptrs: x0, a_e, a_w, a_n, a_s, a_p relaxed, src relaxed, a_p unrelaxed,
//       src unrelaxed, theta, delta, sigma1 (0-d), x*, r
// ip:   ni, nj, degree (1..15)
// fp:   unused
NF_EXPORT int nf_chebyshev_strips(const long long* ptrs, const int* ip, const float* fp,
                                  void* stream) {
  (void)fp;
  ChebyParams P;
  const float** ins[] = {&P.x0, &P.ae, &P.aw, &P.an, &P.as, &P.ap, &P.src, &P.ap_un, &P.src_un,
                         &P.theta, &P.delta, &P.sigma1};
  for (int k = 0; k < 12; ++k) *ins[k] = reinterpret_cast<const float*>(ptrs[k]);
  P.x_out = reinterpret_cast<float*>(ptrs[12]);
  P.r_out = reinterpret_cast<float*>(ptrs[13]);
  P.ni = ip[0]; P.nj = ip[1];
  const int degree = ip[2];
  const Kernel k = kernel_of<1>(degree);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  P.tiles_j = (P.nj + tile_j(degree) - 1) / tile_j(degree);
  P.tiles = P.tiles_j * ((P.ni + tile_i(degree) - 1) / tile_i(degree));
  const int smem = (int)sizeof(float) * smem_floats(degree);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 16) return (int)cudaErrorInvalidDevice;
  int& blocks = g_blocks[device][degree];
  if (blocks == 0) {  // once per device and degree: the shared memory, the resident blocks
    int n_sm = 0, per_sm = 0;
    err = cudaFuncSetAttribute((const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    blocks = per_sm * n_sm;
  }
  const int grid = P.tiles < blocks ? P.tiles : blocks;
  k<<<grid, THREADS, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
