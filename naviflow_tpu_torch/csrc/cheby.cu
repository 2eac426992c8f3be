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
//
// The case axis (cheby_kernel_batched, entry nf_chebyshev_strips_batched;
// the batching rule of ops/cheby.py, the vmapped lockstep step of
// algorithms/batch.py): B fields of one shape in one launch.  The same
// resident blocks walk (case, tile) items, case-major.  A block keeps two
// shared-memory views of the parameters, the current item's and the next
// one's: thread 0 fills the next item's (every pointer moved by its case's
// stride, the interval scalars by address with theirs) once every thread
// is past the item before, so the next tile's stage is copied from the
// next case while this tile computes.  Each tile runs the single launch's
// tile code (cheby_tile) on its view, so each case's bits are its single
// launch's.  A frozen case's tiles write x0 to x* and zeros to r on their
// owned faces, and stage nothing.

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

// The interval scalars (theta, delta, sigma1), read from device memory.
struct Interval {
  float theta, delta, sigma1;
};

__device__ __forceinline__ Interval interval_of(const ChebyParams& P) {
  return {*P.theta, *P.delta, *P.sigma1};
}

// One tile t of the walk on the view P with the interval I, its region
// already in the stage: the registers from the stage, then `stage_next()`
// (every thread calls it, after a block barrier: the next tile's copies fly
// through this tile's steps), the Chebyshev steps and the owned faces' x*
// and residual.
template <int DEG, class Next>
__device__ __forceinline__ void cheby_tile(const ChebyParams& P, const Interval& I, int t,
                                           float* stage, float* sx0, float* sx1,
                                           Next stage_next) {
  constexpr int H = DEG + 1;
  constexpr int RI = region_i(DEG);              // region rows
  constexpr int CELLS = rows_per_warp(DEG) * CPL;  // faces a thread
  constexpr int TI = tile_i(DEG), TJ = tile_j(DEG);
  const int NI = P.ni, NJ = P.nj;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float theta = I.theta, delta = I.delta, sigma1 = I.sigma1;
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
  stage_next();
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

// The stage and the two iterate buffers in the dynamic shared memory, both
// iterate buffers zeroed once: the borders stay zero, every interior slot
// is rewritten for each tile before a barrier lets it be read.
template <int DEG>
__device__ __forceinline__ void cheby_smem(float* dyn, float*& stage, float*& sx0, float*& sx1) {
  constexpr int RI = region_i(DEG);
  stage = dyn;                        // STAGED x RI x RJ
  sx0 = dyn + STAGED * RI * RJ;       // two (RI + 2) x PJ iterate buffers
  sx1 = sx0 + (RI + 2) * PJ;
  for (int k = threadIdx.x; k < 2 * (RI + 2) * PJ; k += THREADS) sx0[k] = 0.f;
}

template <int DEG>
__global__ void __launch_bounds__(THREADS, DEG <= 7 ? 2 : 1) cheby_kernel(ChebyParams P) {
  extern __shared__ __align__(16) float dyn[];
  float *stage, *sx0, *sx1;
  cheby_smem<DEG>(dyn, stage, sx0, sx1);
  const Interval I = interval_of(P);
  int t = blockIdx.x;
  if (t < P.tiles) stage_tile<DEG>(P, t, stage);
  for (; t < P.tiles; t += gridDim.x)
    cheby_tile<DEG>(P, I, t, stage, sx0, sx1, [&] {
      if (t + (int)gridDim.x < P.tiles) stage_tile<DEG>(P, t + gridDim.x, stage);
    });
}

// B fields of one shape (the case axis): case 0's parameters, each pointer
// field's case stride in bytes (the same fields of S), the active flags
// and their stride, the case count.
struct ChebyBatch {
  ChebyParams P, S;
  const bool* active;
  const bool* active_stride;
  int cases;
};

// Case b's view of the parameters into P (thread 0), and whether it is
// active: every pointer moved by b times its stride.
__device__ __forceinline__ void cheby_case(const ChebyBatch& SB, int b, ChebyParams& P,
                                           bool& on) {
  P = SB.P;
  const float** ins[] = {&P.x0, &P.ae, &P.aw, &P.an, &P.as, &P.ap, &P.src, &P.ap_un,
                         &P.src_un, &P.theta, &P.delta, &P.sigma1};
  const float* const* sin[] = {&SB.S.x0, &SB.S.ae, &SB.S.aw, &SB.S.an, &SB.S.as, &SB.S.ap,
                               &SB.S.src, &SB.S.ap_un, &SB.S.src_un, &SB.S.theta,
                               &SB.S.delta, &SB.S.sigma1};
  for (int k = 0; k < 12; ++k) nf_case_shift(*ins[k], *sin[k], b);
  nf_case_shift(P.x_out, SB.S.x_out, b);
  nf_case_shift(P.r_out, SB.S.r_out, b);
  const bool* active = SB.active;
  nf_case_shift(active, SB.active_stride, b);
  on = *active;
}

// A frozen case's tile t: x* = x0 and r = 0 on the owned faces.
template <int DEG>
__device__ __forceinline__ void cheby_frozen_tile(const ChebyParams& P, int t) {
  constexpr int TI = tile_i(DEG), TJ = tile_j(DEG);
  const int ti0 = (t / P.tiles_j) * TI, tj0 = (t % P.tiles_j) * TJ;
  for (int k = threadIdx.x; k < TI * TJ; k += THREADS) {
    const int gi = ti0 + k / TJ, gj = tj0 + k % TJ;
    if (gi >= P.ni || gj >= P.nj) continue;
    const int64_t g = (int64_t)gi * P.nj + gj;
    P.x_out[g] = P.x0[g];
    P.r_out[g] = 0.f;
  }
}

// The persistent blocks walk (case, tile) items, case-major; V[s] is the
// current item's view and V[s ^ 1] the next one's.
template <int DEG>
__global__ void __launch_bounds__(THREADS, DEG <= 7 ? 2 : 1) cheby_kernel_batched(ChebyBatch SB) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ ChebyParams V[2];
  __shared__ bool on[2];
  float *stage, *sx0, *sx1;
  cheby_smem<DEG>(dyn, stage, sx0, sx1);
  const int tiles = SB.P.tiles, items = SB.cases * tiles;
  int t = blockIdx.x, s = 0;
  if (threadIdx.x == 0 && t < items) cheby_case(SB, t / tiles, V[0], on[0]);
  __syncthreads();
  if (t < items && on[0]) stage_tile<DEG>(V[0], t % tiles, stage);
  // the next item's view, once every thread is past the item before (the
  // last reader of V[s ^ 1]), then its stage
  auto next = [&] {
    const int n = t + (int)gridDim.x;
    if (threadIdx.x == 0 && n < items) cheby_case(SB, n / tiles, V[s ^ 1], on[s ^ 1]);
    __syncthreads();
    if (n < items && on[s ^ 1]) stage_tile<DEG>(V[s ^ 1], n % tiles, stage);
  };
  for (; t < items; t += gridDim.x, s ^= 1) {
    if (on[s]) {
      cheby_tile<DEG>(V[s], interval_of(V[s]), t % tiles, stage, sx0, sx1, next);
    } else {
      cheby_frozen_tile<DEG>(V[s], t % tiles);
      __syncthreads();
      next();
    }
  }
}

using Kernel = void (*)(ChebyParams);
using BatchKernel = void (*)(ChebyBatch);

template <int DEG>
Kernel kernel_of(int degree) {
  if constexpr (DEG > 15) {
    return nullptr;
  } else {
    return degree == DEG ? cheby_kernel<DEG> : kernel_of<DEG + 1>(degree);
  }
}

template <int DEG>
BatchKernel batch_kernel_of(int degree) {
  if constexpr (DEG > 15) {
    return nullptr;
  } else {
    return degree == DEG ? cheby_kernel_batched<DEG> : batch_kernel_of<DEG + 1>(degree);
  }
}

// Per device ordinal and degree: the blocks a launch runs (0 = not set up),
// of the single kernel [0] and of the batched one [1].
int g_blocks[2][16][16];

// The resident blocks of kernel `k` at `degree` on the current device (set
// up once: its shared memory, its occupancy).
int resident_blocks(const void* k, bool batched, int degree, int smem, int* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 16) return (int)cudaErrorInvalidDevice;
  int& blocks = g_blocks[batched][device][degree];
  if (blocks == 0) {
    int n_sm = 0, per_sm = 0;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    blocks = per_sm * n_sm;
  }
  *out = blocks;
  return 0;
}

// nf_chebyshev_strips' slots and ip into P (the tile walk from the shape
// and degree); the batched entry reads case 0's slots and then their
// strides with it.
void read_cheby(const long long* ptrs, const int* ip, ChebyParams& P) {
  const float** ins[] = {&P.x0, &P.ae, &P.aw, &P.an, &P.as, &P.ap, &P.src, &P.ap_un, &P.src_un,
                         &P.theta, &P.delta, &P.sigma1};
  for (int k = 0; k < 12; ++k) *ins[k] = reinterpret_cast<const float*>(ptrs[k]);
  P.x_out = reinterpret_cast<float*>(ptrs[12]);
  P.r_out = reinterpret_cast<float*>(ptrs[13]);
  P.ni = ip[0]; P.nj = ip[1];
  const int degree = ip[2];
  P.tiles_j = (P.nj + tile_j(degree) - 1) / tile_j(degree);
  P.tiles = P.tiles_j * ((P.ni + tile_i(degree) - 1) / tile_i(degree));
}

}  // namespace

// ptrs: x0, a_e, a_w, a_n, a_s, a_p relaxed, src relaxed, a_p unrelaxed,
//       src unrelaxed, theta, delta, sigma1 (0-d), x*, r
// ip:   ni, nj, degree (1..15)
// fp:   unused
NF_EXPORT int nf_chebyshev_strips(const long long* ptrs, const int* ip, const float* fp,
                                  void* stream) {
  (void)fp;
  ChebyParams P;
  read_cheby(ptrs, ip, P);
  const int degree = ip[2];
  const Kernel k = kernel_of<1>(degree);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * smem_floats(degree);
  int blocks = 0;
  const int err = resident_blocks((const void*)k, false, degree, smem, &blocks);
  if (err) return err;
  const int grid = P.tiles < blocks ? P.tiles : blocks;
  k<<<grid, THREADS, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// B fields of one shape in one launch (the case axis; the resident blocks
// walk (case, tile) items).
// ptrs: nf_chebyshev_strips' 14 slots for case 0, the cases' active flags
//       (bool), then each of these 15 slots' case stride in bytes, in the
//       same order (0: one array or scalar shared by every case)
// ip:   nf_chebyshev_strips', then B;  fp: unused
NF_EXPORT int nf_chebyshev_strips_batched(const long long* ptrs, const int* ip,
                                          const float* fp, void* stream) {
  (void)fp;
  constexpr int N = 14, HALF = N + 1;
  ChebyBatch SB;
  read_cheby(ptrs, ip, SB.P);
  read_cheby(ptrs + HALF, ip, SB.S);
  SB.active = reinterpret_cast<const bool*>(ptrs[N]);
  SB.active_stride = reinterpret_cast<const bool*>(ptrs[HALF + N]);
  SB.cases = ip[3];
  const int degree = ip[2];
  const BatchKernel k = batch_kernel_of<1>(degree);
  if (k == nullptr || !SB.active || SB.cases < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * smem_floats(degree);
  int blocks = 0;
  const int err = resident_blocks((const void*)k, true, degree, smem, &blocks);
  if (err) return err;
  const int items = SB.cases * SB.P.tiles;
  k<<<items < blocks ? items : blocks, THREADS, smem, (cudaStream_t)stream>>>(SB);
  return (int)cudaGetLastError();
}
