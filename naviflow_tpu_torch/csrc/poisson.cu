// K11: whole-array red-black SOR sweeps (K11a) and the 5-point matvec
// (K11b) of the pressure-correction operator, unpinned.
//
// Replaces naviflow_tpu/ops/pallas_kernels.py:rbgs_sweeps_pallas
// (_rbgs_kernel) and :apply_poisson_pallas (_matvec_kernel).  Both take
// arrays of at most 256^2 cells (PALLAS_MAX_CELLS, the wrapper's rule).
//   K11a: `n_sweeps` sweeps of p + omega * (p_new - p) with
//         p_new = (b + sum(a_nb * p_nb)) * invd,
//         invd = 1 / (diag < 1e-15 ? 1 : diag), red ((i+j) even) cells
//         first, then black;
//   K11b: diag * p - a_e * p_e - a_w * p_w - a_n * p_n - a_s * p_s.
// K11a accumulates the neighbour sum e, w, n, s in that order, as the TPU
// kernel's _nbsum and the plain rbgs_sweep, and divides as
// `1.0 / poisson_diagonal(c, pinned=False)` does (an IEEE division: the
// build keeps nvcc's -prec-div default); K11b subtracts term by term in the
// plain apply_poisson's order (the TPU kernel subtracted the whole sum, a
// reassociation within the matvec tolerance).  Cells off the grid read 0
// (the TPU kernels' wrapped rolls are annihilated by the zero boundary
// links).
//
// Bound on the H100: bytes for both (K11a reads seven arrays and writes
// one, K11b reads six and writes one), but at 256^2 (1.8-2.1 MB) a launch's
// own floor is larger than the byte bound.  K11a is a chain of 2 * n_sweeps
// dependent half-sweeps.  Design: temporally blocked tiles, K2a's scheme
// (csrc/strip.cu).  A block owns RB_TI x RB_TJ cells and stages its region
// (the tile and a halo of H = 2 S cells, for S sweeps in the launch) of p,
// b, the four links and diag into shared memory at once by cp.async
// (16-byte copies where every array is 16-byte aligned and ny % 4 == 0,
// the column margin M = H rounded up to 4; 4-byte copies otherwise; zeros
// off the grid); p on the whole region, the others less the outer ring,
// which no pass updates.  It then runs the 2 S colour-compacted passes on
// the region shrunk by one ring a pass, one block barrier each, computing
// invd from the staged diag in the first sweep and keeping it in diag's
// plane, and stores the owned cells (float4 where aligned).  No barrier
// crosses blocks, so a launch of S <= RB_S_MAX sweeps is one kernel on as
// many SMs as tiles; the wrapper chains ceil(n / RB_S_MAX) calls for more
// sweeps, ping-ponging between its output and a second buffer.  Tiles are
// 16 x 16 cells (256 blocks at 256^2): on the H100 small tiles won.  At
// 256^2, 3 sweeps, 16 x 16 and 16 x 32 tied within 3%, and 32 x 32 and
// 32 x 64 took a fifth and three fifths longer; at 63^2, 1 sweep, 16 x 16
// led 16 x 32 by 7-10%.
// Past the launch floor the staging's latency dominates, and smaller
// regions stage in parallel on more SMs.  One thread-block cluster of row
// bands (a cluster barrier a half-sweep) was not built: at 3 sweeps its six
// barriers (4.2 us) and an empty launch (1.8-2.1 us) already exceed this
// kernel's whole time.  K11b is one cell a thread through the read-only
// path in blocks of 256: at 256^2 it runs within a microsecond of an empty
// launch, blocks of 128 ran 4% slower, and four cells a thread (float4
// loads, row neighbours by shuffles) ran no faster.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K11a: the staged tile

// The owned tile and the block's threads.  512 threads take every pass of
// every instance in one round: the widest, pass 1 at S = 4, has 30 x 30 / 2
// cells.
constexpr int RB_TI = 16;
constexpr int RB_TJ = 16;
constexpr int RB_THREADS = 512;
constexpr int RB_S_MAX = 4;  // sweeps a launch
constexpr int RB_ARRAYS = 7;  // p, b, a_e, a_w, a_n, a_s, diag
static_assert(RB_TI % 2 == 0 && RB_TJ % 4 == 0 && RB_THREADS % 32 == 0 && RB_THREADS <= 1024,
              "tile: even rows, columns a multiple of 4, whole warps");

__host__ __device__ constexpr int rb_halo(int s) { return 2 * s; }
__host__ __device__ constexpr int rb_margin(int s) { return (rb_halo(s) + 3) / 4 * 4; }
__host__ __device__ constexpr int rb_rows(int s) { return RB_TI + 2 * rb_halo(s); }
__host__ __device__ constexpr int rb_cols(int s) { return RB_TJ + 2 * rb_margin(s); }
__host__ __device__ constexpr int rb_smem_floats(int s) {
  return RB_ARRAYS * rb_rows(s) * rb_cols(s);
}

// The compile-time shape of the S-sweep instance's staged region (the
// fields nf_stage_region and nf_store_owned read).
template <int S>
struct RbRegion {
  static constexpr int THREADS = RB_THREADS, TI = RB_TI, TJ = RB_TJ;
  static constexpr int H = rb_halo(S), M = rb_margin(S), RI = rb_rows(S), W = rb_cols(S);
  static constexpr int PLANE = RI * W;
  // the arrays after p only where a pass reads them: the region less its
  // outer ring, that ring's columns rounded out to 16-byte chunks
  static constexpr int QLO = (M - H + 1) / 4 * 4, QHI = (M + RB_TJ + H - 1 + 3) / 4 * 4;
};

struct RbParams {
  const float* a[RB_ARRAYS];  // p (this launch's source), b, a_e, a_w, a_n, a_s, diag
  float* out_p;
  int nx, ny, vec;  // vec: every array 16-byte aligned and ny % 4 == 0
  float omega;
};

// One SOR update of region slot k: the plain rbgs_sweep's expression.  In
// the first sweep (`first`) the cell's invd is computed from its staged
// diag and kept in diag's plane for the later sweeps.
template <int PLANE, int W>
__device__ __forceinline__ void rb_update(float* s, int k, float omega, bool first) {
  const float x = s[k];
  const float sum = s[2 * PLANE + k] * s[k + W] + s[3 * PLANE + k] * s[k - W] +
                    s[4 * PLANE + k] * s[k + 1] + s[5 * PLANE + k] * s[k - 1];
  float invd = s[6 * PLANE + k];
  if (first) {
    invd = 1.f / (invd < 1e-15f ? 1.f : invd);
    s[6 * PLANE + k] = invd;
  }
  const float pnew = (s[PLANE + k] + sum) * invd;
  s[k] = x + omega * (pnew - x);
}

// S sweeps over one tile.  The tile starts on an even row and a column
// that is a multiple of 4, H is even and M a multiple of 4, so a slot's
// global parity is (r + q) % 2.  Pass n (colour (n - 1) % 2) updates rows
// [n, RI - n) and the logical columns [M - H + n, M + RB_TJ + H - n), both
// of even length, on its colour's on-grid cells only; a block barrier ends
// each pass.  A cell's first update is in pass 1 or 2 (the ranges shrink).
template <int S>
__global__ void __launch_bounds__(RB_THREADS) rbgs_tile_kernel(RbParams P) {
  using R = RbRegion<S>;
  constexpr int H = R::H, M = R::M, RI = R::RI, W = R::W;
  extern __shared__ __align__(16) float s[];
  const int ti0 = blockIdx.y * RB_TI, tj0 = blockIdx.x * RB_TJ;
  const int i0 = ti0 - H, j0 = tj0 - M;  // the cell of region slot (0, 0)
  nf_stage_region<R, 0, RB_ARRAYS>(P, (unsigned)__cvta_generic_to_shared(s), i0, j0);
  nf_commit_staged();
  nf_wait_staged<0>();
#pragma unroll
  for (int n = 1; n <= 2 * S; ++n) {
    const int c = (n - 1) & 1;
    const int per = (RB_TJ + 2 * H - 2 * n) / 2, q_lo = M - H + n;
    for (int k = threadIdx.x; k < (RI - 2 * n) * per; k += RB_THREADS) {
      const int r = n + k / per, q0 = q_lo + 2 * (k % per);
      const int q = q0 + ((c + r + q0) & 1);
      const int gi = i0 + r, gj = j0 + q;
      if (gi < 0 || gi >= P.nx || gj < 0 || gj >= P.ny) continue;
      rb_update<R::PLANE, W>(s, r * W + q, P.omega, n <= 2);
    }
    __syncthreads();
  }
  nf_store_owned<R>(P, s, ti0, tj0);
}

using RbKernel = void (*)(RbParams);
const RbKernel kRbKernels[RB_S_MAX] = {rbgs_tile_kernel<1>, rbgs_tile_kernel<2>,
                                       rbgs_tile_kernel<3>, rbgs_tile_kernel<4>};

// The dynamic shared memory of every instance, set once per device.
cudaError_t rb_setup() {
  static bool ready[16];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 16) return cudaErrorInvalidDevice;
  if (ready[device]) return cudaSuccess;
  for (int s = 1; s <= RB_S_MAX; ++s) {
    err = cudaFuncSetAttribute((const void*)kRbKernels[s - 1],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(sizeof(float) * rb_smem_floats(s)));
    if (err != cudaSuccess) return err;
  }
  ready[device] = true;
  return cudaSuccess;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---------------------------------------------------------------------------
// K11b

constexpr int MV_THREADS = 256;

struct MvParams {
  const float* __restrict__ p;
  const float* __restrict__ ae;
  const float* __restrict__ aw;
  const float* __restrict__ an;
  const float* __restrict__ as;
  const float* __restrict__ d;
  float* __restrict__ out;
  int nx, ny;
};

// One cell a thread.
__global__ void __launch_bounds__(MV_THREADS) matvec_kernel(MvParams P) {
  const int64_t g = (int64_t)blockIdx.x * MV_THREADS + threadIdx.x;
  if (g >= (int64_t)P.nx * P.ny) return;
  const int i = (int)(g / P.ny), j = (int)(g % P.ny);
  const float pc = __ldg(P.p + g);
  const float e = i + 1 < P.nx ? __ldg(P.p + g + P.ny) : 0.f;
  const float w = i > 0 ? __ldg(P.p + g - P.ny) : 0.f;
  const float n = j + 1 < P.ny ? __ldg(P.p + g + 1) : 0.f;
  const float s = j > 0 ? __ldg(P.p + g - 1) : 0.f;
  P.out[g] = __ldg(P.d + g) * pc - __ldg(P.ae + g) * e - __ldg(P.aw + g) * w -
             __ldg(P.an + g) * n - __ldg(P.as + g) * s;
}

}  // namespace

// K11a: one launch of n_sweeps (1..RB_S_MAX) sweeps of p into out (not p).
// One argument per pointer and parameter (the lean call of ops/_cuda.py).
NF_EXPORT int nf_rbgs_sweeps(const float* p, const float* b, const float* ae, const float* aw,
                             const float* an, const float* as, const float* diag, float* out,
                             int nx, int ny, int n_sweeps, float omega, void* stream) {
  if (n_sweeps < 1 || n_sweeps > RB_S_MAX || nx < 1 || ny < 1 || out == p)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = rb_setup();
  if (err != cudaSuccess) return (int)err;
  RbParams P = {{p, b, ae, aw, an, as, diag}, out, nx, ny, 0, omega};
  bool vec = ny % 4 == 0 && aligned16(out);
  for (int a = 0; a < RB_ARRAYS; ++a) vec = vec && aligned16(P.a[a]);
  P.vec = vec;
  const dim3 grid((ny + RB_TJ - 1) / RB_TJ, (nx + RB_TI - 1) / RB_TI);
  kRbKernels[n_sweeps - 1]<<<grid, RB_THREADS, sizeof(float) * rb_smem_floats(n_sweeps),
                             (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// K11b.  One argument per pointer and integer (the lean call).
NF_EXPORT int nf_apply_poisson(const float* p, const float* ae, const float* aw,
                               const float* an, const float* as, const float* diag, float* out,
                               int nx, int ny, void* stream) {
  const MvParams P = {p, ae, aw, an, as, diag, out, nx, ny};
  const int blocks = (int)(((int64_t)nx * ny + MV_THREADS - 1) / MV_THREADS);
  matvec_kernel<<<blocks, MV_THREADS, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
