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
// Both take 2-D tiles of TILE x DOWN_TJ owned cells with a halo of H =
// colours x sweeps cells (+ 1 for down's residual) on every side.  Each
// colour pass updates the region shrunk by one more ring, so the owned
// cells see exactly the global sweep; cells outside the grid hold 0 and are
// never updated (the zero padding of the composed shifts) — nothing reads
// outside an allocation.
//
// Bound on the H100: bytes.  down reads p, b and the 5 or 9 stencil arrays
// and writes p and the coarse residual (8.25 / 12.25 arrays of a level's
// size), 0.0103 ms at 1024^2 5-point and 0.0038 at 512^2 9-point; up reads
// p, b, the stencil and the coarse correction and writes p, the same
// bytes.  Both kernels run one design: the tile's region of all 7 or 11
// arrays is staged into shared memory at once by 16-byte cp.async (the
// levels' rows are 16-byte aligned, so the region's first column is rounded
// down to a multiple of 4, the column margin M = H rounded up to 4; 4-byte
// copies where an array is not aligned), p on the whole region, b and the
// stencil less its outer ring, which no pass updates; so every request of
// the tile is in flight together and nothing is read from global memory
// twice by a block; each colour pass then runs on the cells of its colour
// only (column first + 2m on 5-point levels, the (i % 2, j % 2) quarter on
// 9-point ones: no lane idles), one block barrier a pass; the owned cells
// are stored as float4.  down's residual and its restriction come from
// shared memory.  up's coarse correction arrives with p, a box of the
// coarse rows and columns the region's prolongation reads (16-byte copies,
// the clamp kept on global coarse indices), in a first copy group; b and
// the stencil follow in a second, and arrive while the prolongation is
// added to p in shared memory (the box beat ec read from L2 during the
// add, and two groups one, by 4-16% on the H100).  Tiles are 32 x 64
// cells: the 1024^2 5-point level is 512 tiles at 512 threads, three an
// SM; the 512^2 9-point level is 128 tiles at 1024 threads, one an SM, in
// one wave.  On the H100 these beat 32 x 32 tiles at 256 threads (the
// columns' 16-byte margins cost less on wider tiles, and a 9-point tile's
// passes are bound by shared-memory requests, which more warps keep in
// flight); a persistent double-buffered variant, a residual stored before
// its restriction and a padded 9-point pitch were slower for down.
// Every value comes from the same operations in the same order as the
// composed sweep (the update of a cell, the residual's sum, the
// restriction's pairs, the prolongation's axis-0-first taps).
//
// The case axis (nf_strip_down_batched, nf_strip_up_batched; the batching
// rules of ops/strip.py, the vmapped lockstep step of algorithms/batch.py):
// B levels of one shape in one launch, the grid's z axis over the cases.
// Thread 0 of each block moves every pointer of the case-0 parameters by
// its case's stride into a shared-memory copy (strip_case), and the single
// launch's tile code runs on that view, so each case's bits are its single
// launch's.  A frozen case's blocks copy p to the output and zero their
// coarse residual (down), and stage nothing.

#include "common.cuh"

namespace {

// The staged region of one (points, sweeps) instance: an owned tile of
// TILE rows by DOWN_TJ columns, TILE + 2 H rows by DOWN_TJ + 2 M columns
// of each of p, b and the NS stencil arrays, M = H rounded up to a
// multiple of 4 (16-byte rows); 512 threads on 5-point levels, 1024 on
// 9-point ones.  down's halo has the residual's ring, up's does not; up
// adds the box of the coarse correction.
constexpr int TILE = 32;
constexpr int DOWN_TJ = 64;
__host__ __device__ constexpr int down_threads(int ns) { return ns == 5 ? 512 : 1024; }
__host__ __device__ constexpr int down_colors(int ns) { return ns == 5 ? 2 : 4; }
__host__ __device__ constexpr int down_halo(int ns, int sweeps) {
  return down_colors(ns) * sweeps + 1;
}
__host__ __device__ constexpr int down_margin(int ns, int sweeps) {
  return (down_halo(ns, sweeps) + 3) / 4 * 4;
}
__host__ __device__ constexpr int down_rows(int ns, int sweeps) {
  return TILE + 2 * down_halo(ns, sweeps);
}
__host__ __device__ constexpr int down_cols(int ns, int sweeps) {
  return DOWN_TJ + 2 * down_margin(ns, sweeps);
}
__host__ __device__ constexpr int down_smem_floats(int ns, int sweeps) {
  return (ns + 2) * down_rows(ns, sweeps) * down_cols(ns, sweeps);
}

__host__ __device__ constexpr int up_halo(int ns, int sweeps) { return down_colors(ns) * sweeps; }
__host__ __device__ constexpr int up_margin(int ns, int sweeps) {
  return (up_halo(ns, sweeps) + 3) / 4 * 4;
}
__host__ __device__ constexpr int up_rows(int ns, int sweeps) {
  return TILE + 2 * up_halo(ns, sweeps);
}
__host__ __device__ constexpr int up_cols(int ns, int sweeps) {
  return DOWN_TJ + 2 * up_margin(ns, sweeps);
}
// the coarse correction's box: coarse rows ti0 / 2 - H / 2 - 1 ..
// ti0 / 2 + TILE / 2 + H / 2, columns from tj0 / 2 + up_box_col0 (a multiple
// of 4) over up_box_cols (the clamp's neighbours included)
__host__ __device__ constexpr int up_box_rows(int ns, int sweeps) {
  return TILE / 2 + up_halo(ns, sweeps) + 2;
}
__host__ __device__ constexpr int up_box_col0(int ns, int sweeps) {
  return -((up_halo(ns, sweeps) / 2 + 1 + 3) / 4 * 4);
}
__host__ __device__ constexpr int up_box_cols(int ns, int sweeps) {
  return (DOWN_TJ / 2 + up_halo(ns, sweeps) / 2 + 1 + 3) / 4 * 4 - up_box_col0(ns, sweeps);
}
// p alone at 0 sweeps (no pass reads b or the stencil)
__host__ __device__ constexpr int up_arrays(int ns, int sweeps) { return sweeps ? ns + 2 : 1; }
__host__ __device__ constexpr int up_smem_floats(int ns, int sweeps) {
  return up_arrays(ns, sweeps) * up_rows(ns, sweeps) * up_cols(ns, sweeps) +
         up_box_rows(ns, sweeps) * up_box_cols(ns, sweeps);
}

// The compile-time shape of one instance's staged region.
template <int NS, int SWEEPS, bool UP>
struct Region {
  static constexpr int THREADS = down_threads(NS), COLORS = down_colors(NS);
  static constexpr int TI = TILE, TJ = DOWN_TJ;
  static constexpr int H = UP ? up_halo(NS, SWEEPS) : down_halo(NS, SWEEPS);
  static constexpr int M = UP ? up_margin(NS, SWEEPS) : down_margin(NS, SWEEPS);
  static constexpr int RI = TILE + 2 * H, W = TJ + 2 * M, PLANE = RI * W;
  static constexpr int A = UP ? up_arrays(NS, SWEEPS) : NS + 2;  // staged arrays
  // b and the stencil only where a pass or the residual reads them: the
  // region less its outer ring, that ring's columns rounded out to 16-byte
  // chunks
  static constexpr int QLO = (M - H + 1) / 4 * 4, QHI = (M + TJ + H - 1 + 3) / 4 * 4;
};

struct StripParams {
  const float* a[11];  // p, b, stencil c, e, w, n, s, ne, nw, se, sw (no corners on 5-point)
  const float* ec;     // coarse correction (up)
  float* out_p;
  float* out_rc;       // coarse residual (down)
  int nx, ny, vec;     // vec: every array 16-byte aligned and ny % 4 == 0
  int ec_vec;          // ec 16-byte aligned and (ny / 2) % 4 == 0
  float omega;
};

// One Gauss-Seidel update of region slot k (the expression of the composed
// sweep); `s` is the staged region: p, b, then the stencil arrays.
template <int NS, int PLANE, int W>
__device__ __forceinline__ void down_update(float* s, int k, float omega) {
  float* sp = s;
  const float* st = s + 2 * PLANE;
  float off = st[1 * PLANE + k] * sp[k + W] + st[2 * PLANE + k] * sp[k - W] +
              st[3 * PLANE + k] * sp[k + 1] + st[4 * PLANE + k] * sp[k - 1];
  if constexpr (NS == 9)
    off = off + st[5 * PLANE + k] * sp[k + W + 1] + st[6 * PLANE + k] * sp[k - W + 1] +
          st[7 * PLANE + k] * sp[k + W - 1] + st[8 * PLANE + k] * sp[k - W - 1];
  const float pnew = (s[PLANE + k] - off) * nf_inv_diag(st[k]);
  sp[k] = sp[k] + omega * (pnew - sp[k]);
}

template <int NS, int PLANE, int W>
__device__ __forceinline__ float down_residual(const float* s, int k) {
  const float* sp = s;
  const float* st = s + 2 * PLANE;
  float ax = st[k] * sp[k] + st[1 * PLANE + k] * sp[k + W] + st[2 * PLANE + k] * sp[k - W] +
             st[3 * PLANE + k] * sp[k + 1] + st[4 * PLANE + k] * sp[k - 1];
  if constexpr (NS == 9)
    ax = ax + st[5 * PLANE + k] * sp[k + W + 1] + st[6 * PLANE + k] * sp[k - W + 1] +
         st[7 * PLANE + k] * sp[k + W - 1] + st[8 * PLANE + k] * sp[k - W - 1];
  return s[PLANE + k] - ax;
}

// The colour passes on their colour's cells only.  The tile starts on an
// even row and column and M is a multiple of 4, so a slot's global
// parities are (r + H, q): pass n updates rows [n, RI - n) and the
// region's logical columns [M - H + n, M + TJ + H - n), both of even
// length.  A block barrier ends each pass.
template <class R, int NS, int SWEEPS>
__device__ __forceinline__ void smooth_region(const StripParams& P, float* s, int i0, int j0) {
  constexpr int H = R::H, M = R::M, RI = R::RI, W = R::W, TJ = R::TJ;
#pragma unroll
  for (int n = 1; n <= R::COLORS * SWEEPS; ++n) {
    const int c = (n - 1) % R::COLORS;
    const int ni = RI - 2 * n, nj = TJ + 2 * H - 2 * n, q_lo = M - H + n;
    if constexpr (NS == 5) {  // (gi + gj) % 2 == c: every other column of each row
      const int per = nj / 2;
      for (int k = threadIdx.x; k < ni * per; k += R::THREADS) {
        const int r = n + k / per, q0 = q_lo + 2 * (k % per);
        const int q = q0 + ((c + r + H + q0) & 1);
        const int gi = i0 + r, gj = j0 + q;
        if (gi < 0 || gi >= P.nx || gj < 0 || gj >= P.ny) continue;
        down_update<NS, R::PLANE, W>(s, r * W + q, P.omega);
      }
    } else {  // (gi % 2, gj % 2) == (c / 2, c % 2): every other row and column
      const int rows = ni / 2, cols = nj / 2;
      const int r_first = n + (((c >> 1) + H + n) & 1), q_first = q_lo + (((c & 1) + q_lo) & 1);
      for (int k = threadIdx.x; k < rows * cols; k += R::THREADS) {
        const int r = r_first + 2 * (k / cols), q = q_first + 2 * (k % cols);
        const int gi = i0 + r, gj = j0 + q;
        if (gi < 0 || gi >= P.nx || gj < 0 || gj >= P.ny) continue;
        down_update<NS, R::PLANE, W>(s, r * W + q, P.omega);
      }
    }
    __syncthreads();
  }
}

template <int NS, int SWEEPS>
__device__ __forceinline__ void strip_down_tile(const StripParams& P, float* s) {
  using R = Region<NS, SWEEPS, false>;
  constexpr int H = R::H, M = R::M, W = R::W, PLANE = R::PLANE, TJ = R::TJ;
  const int ti0 = blockIdx.y * TILE, tj0 = blockIdx.x * TJ;
  const int i0 = ti0 - H, j0 = tj0 - M;  // the cell of region slot (0, 0)
  nf_stage_region<R, 0, R::A>(P, (unsigned)__cvta_generic_to_shared(s), i0, j0);
  nf_commit_staged();
  nf_wait_staged<0>();
  smooth_region<R, NS, SWEEPS>(P, s, i0, j0);
  nf_store_owned<R>(P, s, ti0, tj0);
  // residual of the owned cells, restricted 2x2 (axis 0 first, as
  // ops/transfer_cc.restrict_cc), a coarse cell a thread at a time
  constexpr int TC = TJ / 2;
  for (int k = threadIdx.x; k < TILE / 2 * TC; k += R::THREADS) {
    const int gi = ti0 + 2 * (k / TC), gj = tj0 + 2 * (k % TC);
    if (gi >= P.nx || gj >= P.ny) continue;
    const int kk = (H + 2 * (k / TC)) * W + M + 2 * (k % TC);
    const float r00 = down_residual<NS, PLANE, W>(s, kk);
    const float r10 = down_residual<NS, PLANE, W>(s, kk + W);
    const float r01 = down_residual<NS, PLANE, W>(s, kk + 1);
    const float r11 = down_residual<NS, PLANE, W>(s, kk + W + 1);
    P.out_rc[(int64_t)(gi / 2) * (P.ny / 2) + gj / 2] =
        0.5f * (0.5f * (r00 + r10) + 0.5f * (r01 + r11));
  }
}

template <int NS, int SWEEPS>
__global__ void __launch_bounds__(down_threads(NS)) strip_down_kernel(StripParams P) {
  extern __shared__ __align__(16) float s[];
  strip_down_tile<NS, SWEEPS>(P, s);
}

// up's coarse box (BR rows x BW columns from coarse cell (I0, J0), J0 a
// multiple of 4): 16-byte chunks where P.ec_vec (ncj a multiple of 4, so
// a chunk is on or off the grid), 4-byte copies otherwise; zeros off the
// grid, which the clamp never reads.
template <int BR, int BW, int THREADS>
__device__ __forceinline__ void stage_box(const StripParams& P, unsigned base, int I0, int J0) {
  const int nci = P.nx / 2, ncj = P.ny / 2;
  if (P.ec_vec) {
    constexpr int CH = BW / 4;
    for (int k = threadIdx.x; k < BR * CH; k += THREADS) {
      const int r = k / CH, q = 4 * (k % CH);
      const int gi = I0 + r, gj = J0 + q;
      const bool in = gi >= 0 && gi < nci && gj >= 0 && gj < ncj;
      nf_cp16(base + 4u * (r * BW + q), P.ec + (in ? (int64_t)gi * ncj + gj : 0), in);
    }
  } else {
    for (int k = threadIdx.x; k < BR * BW; k += THREADS) {
      const int gi = I0 + k / BW, gj = J0 + k % BW;
      const bool in = gi >= 0 && gi < nci && gj >= 0 && gj < ncj;
      nf_cp4(base + 4u * k, P.ec + (in ? (int64_t)gi * ncj + gj : 0), in);
    }
  }
}

template <int NS, int SWEEPS>
__device__ __forceinline__ void strip_up_tile(const StripParams& P, float* s) {
  using R = Region<NS, SWEEPS, true>;
  constexpr int H = R::H, M = R::M, W = R::W, TJ = R::TJ;
  constexpr int BR = up_box_rows(NS, SWEEPS), BW = up_box_cols(NS, SWEEPS);
  float* box = s + R::A * R::PLANE;
  const int ti0 = blockIdx.y * TILE, tj0 = blockIdx.x * TJ;
  const int i0 = ti0 - H, j0 = tj0 - M;  // the cell of region slot (0, 0)
  const int I0 = ti0 / 2 - H / 2 - 1, J0 = tj0 / 2 + up_box_col0(NS, SWEEPS);
  const unsigned base = (unsigned)__cvta_generic_to_shared(s);
  // two copy groups: p and the box, then b and the stencil, which arrive
  // while the prolongation is added
  nf_stage_region<R, 0, 1>(P, base, i0, j0);
  stage_box<BR, BW, R::THREADS>(P, base + 4u * R::A * R::PLANE, I0, J0);
  nf_commit_staged();
  nf_stage_region<R, 1, R::A>(P, base, i0, j0);
  nf_commit_staged();
  nf_wait_staged<1>();

  // p + the prolonged correction on the logical region's cells (rows
  // [0, RI), columns [M - H, M + TJ + H): every cell a pass reads), as
  // nf_prolong_cc: the coarse cell and its clamped neighbour on each axis,
  // axis 0 first
  const int nci = P.nx / 2, ncj = P.ny / 2;
  constexpr int LW = TJ + 2 * H;
  for (int k = threadIdx.x; k < R::RI * LW; k += R::THREADS) {
    const int r = k / LW, q = M - H + k % LW;
    const int gi = i0 + r, gj = j0 + q;
    if (gi < 0 || gi >= P.nx || gj < 0 || gj >= P.ny) continue;
    const int I = gi >> 1, J = gj >> 1;
    const int Ia = (gi & 1) ? min(I + 1, nci - 1) : max(I - 1, 0);
    const int Ja = (gj & 1) ? min(J + 1, ncj - 1) : max(J - 1, 0);
    const int bI = (I - I0) * BW, bIa = (Ia - I0) * BW, bJ = J - J0, bJa = Ja - J0;
    s[r * W + q] = s[r * W + q] + nf_prolong_mix(box[bI + bJ], box[bIa + bJ], box[bI + bJa],
                                                  box[bIa + bJa]);
  }
  nf_wait_staged<0>();
  smooth_region<R, NS, SWEEPS>(P, s, i0, j0);
  nf_store_owned<R>(P, s, ti0, tj0);
}

template <int NS, int SWEEPS>
__global__ void __launch_bounds__(down_threads(NS)) strip_up_kernel(StripParams P) {
  extern __shared__ __align__(16) float s[];
  strip_up_tile<NS, SWEEPS>(P, s);
}

// B levels of one shape (the case axis): case 0's parameters, each pointer
// field's case stride in bytes (the same fields of S), the active flags
// and their stride.
struct StripBatch {
  StripParams P, S;
  const bool* active;
  const bool* active_stride;
};

// Case b = blockIdx.z's view of the parameters: every pointer moved by b
// times its stride (a stride of 0 shares one array), into shared memory
// by thread 0; whether the case is active.
__device__ __forceinline__ bool strip_case(const StripBatch& SB, StripParams& P) {
  __shared__ bool on;
  if (threadIdx.x == 0) {
    const int b = (int)blockIdx.z;
    P = SB.P;
    for (int a = 0; a < 11; ++a) nf_case_shift(P.a[a], SB.S.a[a], b);
    nf_case_shift(P.ec, SB.S.ec, b);
    nf_case_shift(P.out_p, SB.S.out_p, b);
    nf_case_shift(P.out_rc, SB.S.out_rc, b);
    const bool* active = SB.active;
    nf_case_shift(active, SB.active_stride, b);
    on = *active;
  }
  __syncthreads();
  return on;
}

// A frozen case's tile: p's owned cells copied to out_p and (down) the
// tile's coarse cells of out_rc zeroed.
template <int THREADS>
__device__ __forceinline__ void strip_frozen(const StripParams& P, bool down) {
  const int ti0 = blockIdx.y * TILE, tj0 = blockIdx.x * DOWN_TJ;
  for (int k = threadIdx.x; k < TILE * DOWN_TJ; k += THREADS) {
    const int gi = ti0 + k / DOWN_TJ, gj = tj0 + k % DOWN_TJ;
    if (gi >= P.nx || gj >= P.ny) continue;
    const int64_t g = (int64_t)gi * P.ny + gj;
    P.out_p[g] = P.a[0][g];
    if (down && gi % 2 == 0 && gj % 2 == 0)
      P.out_rc[(int64_t)(gi / 2) * (P.ny / 2) + gj / 2] = 0.f;
  }
}

template <int NS, int SWEEPS>
__global__ void __launch_bounds__(down_threads(NS)) strip_down_kernel_batched(StripBatch SB) {
  extern __shared__ __align__(16) float s[];
  __shared__ StripParams P;  // this case's view
  if (!strip_case(SB, P)) {
    strip_frozen<down_threads(NS)>(P, true);
    return;
  }
  strip_down_tile<NS, SWEEPS>(P, s);
}

template <int NS, int SWEEPS>
__global__ void __launch_bounds__(down_threads(NS)) strip_up_kernel_batched(StripBatch SB) {
  extern __shared__ __align__(16) float s[];
  __shared__ StripParams P;  // this case's view
  if (!strip_case(SB, P)) {
    strip_frozen<down_threads(NS)>(P, false);
    return;
  }
  strip_up_tile<NS, SWEEPS>(P, s);
}

using Kernel = void (*)(StripParams);
using BatchKernel = void (*)(StripBatch);

// [up][five][sweeps]
const Kernel kKernels[2][2][3] = {
    {{strip_down_kernel<9, 0>, strip_down_kernel<9, 1>, strip_down_kernel<9, 2>},
     {strip_down_kernel<5, 0>, strip_down_kernel<5, 1>, strip_down_kernel<5, 2>}},
    {{strip_up_kernel<9, 0>, strip_up_kernel<9, 1>, strip_up_kernel<9, 2>},
     {strip_up_kernel<5, 0>, strip_up_kernel<5, 1>, strip_up_kernel<5, 2>}}};

Kernel kernel_of(bool up, bool five, int sweeps) {
  return sweeps >= 0 && sweeps <= 2 ? kKernels[up][five ? 1 : 0][sweeps] : nullptr;
}

const BatchKernel kBatchKernels[2][2][3] = {
    {{strip_down_kernel_batched<9, 0>, strip_down_kernel_batched<9, 1>,
      strip_down_kernel_batched<9, 2>},
     {strip_down_kernel_batched<5, 0>, strip_down_kernel_batched<5, 1>,
      strip_down_kernel_batched<5, 2>}},
    {{strip_up_kernel_batched<9, 0>, strip_up_kernel_batched<9, 1>,
      strip_up_kernel_batched<9, 2>},
     {strip_up_kernel_batched<5, 0>, strip_up_kernel_batched<5, 1>,
      strip_up_kernel_batched<5, 2>}}};

size_t smem_bytes(bool up, int ns, int sweeps) {
  return sizeof(float) * (up ? up_smem_floats(ns, sweeps) : down_smem_floats(ns, sweeps));
}

// The shared memory of every instance, set once per device.
cudaError_t setup(int device) {
  static bool ready[16];
  if (device < 0 || device >= 16) return cudaErrorInvalidDevice;
  if (ready[device]) return cudaSuccess;
  for (int up = 0; up < 2; ++up)
    for (int five = 0; five < 2; ++five)
      for (int sweeps = 0; sweeps <= 2; ++sweeps) {
        const int smem = (int)smem_bytes(up, five ? 5 : 9, sweeps);
        cudaError_t err = cudaFuncSetAttribute((const void*)kKernels[up][five][sweeps],
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err == cudaSuccess)
          err = cudaFuncSetAttribute((const void*)kBatchKernels[up][five][sweeps],
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
      }
  ready[device] = true;
  return cudaSuccess;
}

// The tiles of a level: (column tiles, row tiles, cases).
dim3 tile_grid(const StripParams& P, int cases) {
  return dim3((P.ny + DOWN_TJ - 1) / DOWN_TJ, (P.nx + TILE - 1) / TILE, cases);
}

int ready() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = setup(device);
  return (int)err;
}

// Launch one instance over the level's tiles.
int launch(bool up, const StripParams& P, int ns, int sweeps, void* stream) {
  const int err = ready();
  if (err) return err;
  kernel_of(up, ns == 5, sweeps)<<<tile_grid(P, 1), down_threads(ns),
                                   smem_bytes(up, ns, sweeps), (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// nf_strip_down's slots, ip and fp: launch the level, or (`read`, the
// batched entry: case 0's slots, then their strides) store the parameters
// there.
int launch_down(const long long* ptrs, const int* ip, const float* fp, void* stream,
                StripParams* read = nullptr) {
  StripParams P = {};
  const int nx = ip[0], ny = ip[1], five = ip[2], sweeps = ip[3];
  const int ns = five ? 5 : 9;
  if (kernel_of(false, five, sweeps) == nullptr || nx % 2 || ny % 2)
    return (int)cudaErrorInvalidValue;
  bool aligned = ny % 4 == 0;
  for (int a = 0; a < ns + 2; ++a) {
    P.a[a] = reinterpret_cast<const float*>(ptrs[a]);
    aligned = aligned && ptrs[a] % 16 == 0;
  }
  P.out_p = reinterpret_cast<float*>(ptrs[ns + 2]);
  P.out_rc = reinterpret_cast<float*>(ptrs[ns + 3]);
  P.nx = nx; P.ny = ny; P.omega = fp[0];
  P.vec = aligned && ptrs[ns + 2] % 16 == 0;
  if (read) {
    *read = P;
    return 0;
  }
  return launch(false, P, ns, sweeps, stream);
}

// nf_strip_up's, as launch_down.
int launch_up(const long long* ptrs, const int* ip, const float* fp, void* stream,
              StripParams* read = nullptr) {
  StripParams P = {};
  const int nx = ip[0], ny = ip[1], five = ip[2], sweeps = ip[3];
  const int ns = five ? 5 : 9;
  if (kernel_of(true, five, sweeps) == nullptr || nx % 2 || ny % 2)
    return (int)cudaErrorInvalidValue;
  bool aligned = ny % 4 == 0;
  for (int a = 0; a < ns + 2; ++a) {
    P.a[a] = reinterpret_cast<const float*>(ptrs[a]);
    aligned = aligned && ptrs[a] % 16 == 0;
  }
  P.ec = reinterpret_cast<const float*>(ptrs[ns + 2]);
  P.out_p = reinterpret_cast<float*>(ptrs[ns + 3]);
  P.nx = nx; P.ny = ny; P.omega = fp[0];
  P.vec = aligned && ptrs[ns + 3] % 16 == 0;
  P.ec_vec = ptrs[ns + 2] % 16 == 0 && (ny / 2) % 4 == 0;
  if (read) {
    *read = P;
    return 0;
  }
  return launch(true, P, ns, sweeps, stream);
}

// B levels in one launch: nf_strip_down's or nf_strip_up's slots for case
// 0, the active flags, then each of those slots' case stride in bytes;
// ip: the single entry's, then B.
int launch_batched(bool up, const long long* ptrs, const int* ip, const float* fp,
                   void* stream) {
  StripBatch SB = {};
  const int ns = ip[2] ? 5 : 9, sweeps = ip[3];
  const int half = ns + 5;  // the single entry's ns + 4 slots and the flags
  const auto read = up ? launch_up : launch_down;
  int err = read(ptrs, ip, fp, stream, &SB.P);
  if (!err) err = read(ptrs + half, ip, fp, stream, &SB.S);
  if (err) return err;
  SB.active = reinterpret_cast<const bool*>(ptrs[half - 1]);
  SB.active_stride = reinterpret_cast<const bool*>(ptrs[2 * half - 1]);
  const int cases = ip[4];
  if (!SB.active || cases < 1 || cases > 65535) return (int)cudaErrorInvalidValue;
  // 16-byte copies where every case's arrays are aligned: case 0's and
  // the strides (their own "alignment" read the same way)
  SB.P.vec = SB.P.vec && SB.S.vec;
  SB.P.ec_vec = SB.P.ec_vec && SB.S.ec_vec;
  err = ready();
  if (err) return err;
  kBatchKernels[up][ns == 5 ? 1 : 0][sweeps]<<<tile_grid(SB.P, cases), down_threads(ns),
                                               smem_bytes(up, ns, sweeps),
                                               (cudaStream_t)stream>>>(SB);
  return (int)cudaGetLastError();
}

// The resident blocks an SM of one instance on the current device.
int blocks_per_sm(bool up, int five, int sweeps, int* out) {
  const Kernel k = kernel_of(up, five, sweeps);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = setup(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, down_threads(five ? 5 : 9),
                                                        smem_bytes(up, five ? 5 : 9, sweeps));
  return (int)err;
}

}  // namespace

// ptrs: p, b, stencil (5 or 9), out_p, out_rc;  ip: nx, ny, five, sweeps (0..2);  fp: omega
NF_EXPORT int nf_strip_down(const long long* ptrs, const int* ip, const float* fp,
                            void* stream) {
  return launch_down(ptrs, ip, fp, stream);
}

// B levels of one shape in one launch (the case axis; grid z = B).
// ptrs: nf_strip_down's ns + 4 slots for case 0, the cases' active flags
//       (bool), then each of these ns + 5 slots' case stride in bytes, in
//       the same order (0: one array shared by every case)
// ip:   nf_strip_down's, then B;  fp: omega
NF_EXPORT int nf_strip_down_batched(const long long* ptrs, const int* ip, const float* fp,
                                    void* stream) {
  return launch_batched(false, ptrs, ip, fp, stream);
}

// The resident blocks an SM of strip_down's (five, sweeps) instance on the
// current device (a measurement aid: chip_smoke.py's build line).
NF_EXPORT int nf_strip_down_blocks_per_sm(int five, int sweeps, int* out) {
  return blocks_per_sm(false, five, sweeps, out);
}

// ptrs: p, b, stencil (5 or 9), ec, out_p;  ip: nx, ny, five, sweeps (0..2);  fp: omega
NF_EXPORT int nf_strip_up(const long long* ptrs, const int* ip, const float* fp,
                          void* stream) {
  return launch_up(ptrs, ip, fp, stream);
}

// B levels of one shape in one launch (the case axis; grid z = B).
// ptrs: nf_strip_up's ns + 4 slots for case 0, the cases' active flags
//       (bool), then each of these ns + 5 slots' case stride in bytes
// ip:   nf_strip_up's, then B;  fp: omega
NF_EXPORT int nf_strip_up_batched(const long long* ptrs, const int* ip, const float* fp,
                                  void* stream) {
  return launch_batched(true, ptrs, ip, fp, stream);
}

// The same for strip_up's instances.
NF_EXPORT int nf_strip_up_blocks_per_sm(int five, int sweeps, int* out) {
  return blocks_per_sm(true, five, sweeps, out);
}
