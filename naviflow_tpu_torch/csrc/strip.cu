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
// Both take 2-D tiles of owned cells (up: TILE x TILE; down: TILE x
// DOWN_TJ) with a halo of (colours x sweeps (+ 1 for the residual)) cells
// on every side.  Each colour pass
// updates the region shrunk by one more ring, so the owned cells see
// exactly the global sweep; cells outside the grid hold 0 and are never
// updated (the zero padding of the composed shifts) — nothing reads
// outside an allocation.
//
// Bound on the H100: bytes.  down reads p, b and the 5 or 9 stencil arrays
// and writes p and the coarse residual (8.25 / 12.25 arrays of a level's
// size), 0.0103 ms at 1024^2 5-point and 0.0038 at 512^2 9-point.
// down's design: the tile's region of all 7 or 11 arrays is staged into
// shared memory at once by 16-byte cp.async (the levels' rows are 16-byte
// aligned, so the region's first column is rounded down to a multiple of
// 4; 4-byte copies where an array is not aligned), p on the whole region,
// b and the stencil less its outer ring, which no pass updates; so every
// request of the tile is in flight together and nothing is read from
// global memory twice by a block; each colour pass then runs on the cells of its colour only
// (column first + 2m on 5-point levels, the (i % 2, j % 2) quarter on
// 9-point ones: no lane idles), one block barrier a pass; the residual and
// its restriction come from shared memory.  Tiles are 32 x 64 cells: the
// 1024^2 5-point level is 512 tiles of 76.6 KB at 512 threads, three an SM;
// the 512^2 9-point level is 128 tiles of 148 KB at 1024 threads, one an
// SM, in one wave.  On the H100 these beat 32 x 32 tiles at 256 threads
// (the columns' 16-byte margins cost less on wider tiles, and a 9-point
// tile's passes are bound by shared-memory requests, which more warps keep
// in flight); a persistent double-buffered variant, a residual stored
// before its restriction and a padded 9-point pitch were slower.
// Every value comes from the same operations in the same order as the
// composed sweep (the update of a cell, the residual's sum, the
// restriction's pairs).
// up keeps the first design: p (+ the prolonged correction) in shared
// memory, the stencil and b re-read from global memory on every pass.

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

// ---------------------------------------------------------------------------
// strip_down: the staged tile

// The staged region of one (points, sweeps) instance: an owned tile of
// TILE rows by DOWN_TJ columns, TILE + 2 H rows by DOWN_TJ + 2 M columns
// of each of p, b and the NS stencil arrays, M = H rounded up to a
// multiple of 4 (16-byte rows); 512 threads on 5-point levels, 1024 on
// 9-point ones.
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

struct DownParams {
  const float* a[11];  // p, b, stencil c, e, w, n, s, ne, nw, se, sw (no corners on 5-point)
  float* out_p;
  float* out_rc;       // coarse residual
  int nx, ny, vec;     // vec: every array 16-byte aligned and ny % 4 == 0
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

template <int NS, int SWEEPS>
__global__ void __launch_bounds__(down_threads(NS)) strip_down_kernel(DownParams P) {
  constexpr int DT = down_threads(NS);
  constexpr int H = down_halo(NS, SWEEPS), M = down_margin(NS, SWEEPS);
  constexpr int RI = down_rows(NS, SWEEPS), W = down_cols(NS, SWEEPS), PLANE = RI * W;
  constexpr int A = NS + 2, COLORS = down_colors(NS), TJ = DOWN_TJ;
  extern __shared__ __align__(16) float s[];
  const int nx = P.nx, ny = P.ny;
  const int ti0 = blockIdx.y * TILE, tj0 = blockIdx.x * TJ;
  const int i0 = ti0 - H, j0 = tj0 - M;  // the cell of region slot (0, 0)
  const unsigned base = (unsigned)__cvta_generic_to_shared(s);

  // the region of p, zeros off the grid; b and the stencil only where a
  // pass or the residual reads them: the region less its outer ring (QLO,
  // QHI: that ring's columns rounded out to 16-byte chunks)
  constexpr int QLO = (M - H + 1) / 4 * 4, QHI = (M + TJ + H - 1 + 3) / 4 * 4;
  if (P.vec) {  // 16-byte chunks: j0 and ny are multiples of 4, so a chunk is on or off the grid
    constexpr int CH = W / 4;
    for (int k = threadIdx.x; k < RI * CH; k += DT) {
      const int r = k / CH, q = 4 * (k % CH);
      const int gi = i0 + r, gj = j0 + q;
      const bool in = gi >= 0 && gi < nx && gj >= 0 && gj < ny;
      const int64_t g = in ? (int64_t)gi * ny + gj : 0;
      const unsigned dst = base + 4u * (r * W + q);
      const int arrays = (r >= 1 && r < RI - 1 && q >= QLO && q < QHI) ? A : 1;
#pragma unroll
      for (int a = 0; a < A; ++a)
        if (a < arrays)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst + 4u * a * PLANE),
                       "l"(P.a[a] + g), "r"(in ? 16 : 0)
                       : "memory");
    }
  } else {
    for (int k = threadIdx.x; k < PLANE; k += DT) {
      const int r = k / W, q = k % W;
      const int gi = i0 + r, gj = j0 + q;
      const bool in = gi >= 0 && gi < nx && gj >= 0 && gj < ny;
      const int64_t g = in ? (int64_t)gi * ny + gj : 0;
      const unsigned dst = base + 4u * k;
      const int arrays = (r >= 1 && r < RI - 1 && q >= QLO && q < QHI) ? A : 1;
#pragma unroll
      for (int a = 0; a < A; ++a)
        if (a < arrays)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + 4u * a * PLANE),
                       "l"(P.a[a] + g), "r"(in ? 4 : 0)
                       : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // colour passes on their colour's cells only.  ti0 and tj0 are even and
  // M a multiple of 4, so a slot's global parities are (r + H, q): pass n
  // updates rows [n, RI - n) and the region's logical columns
  // [M - H + n, M + TJ + H - n), both of even length.
#pragma unroll
  for (int n = 1; n <= COLORS * SWEEPS; ++n) {
    const int c = (n - 1) % COLORS;
    const int ni = RI - 2 * n, nj = TJ + 2 * H - 2 * n, q_lo = M - H + n;
    if constexpr (NS == 5) {  // (gi + gj) % 2 == c: every other column of each row
      const int per = nj / 2;
      for (int k = threadIdx.x; k < ni * per; k += DT) {
        const int r = n + k / per, q0 = q_lo + 2 * (k % per);
        const int q = q0 + ((c + r + H + q0) & 1);
        const int gi = i0 + r, gj = j0 + q;
        if (gi < 0 || gi >= nx || gj < 0 || gj >= ny) continue;
        down_update<NS, PLANE, W>(s, r * W + q, P.omega);
      }
    } else {  // (gi % 2, gj % 2) == (c / 2, c % 2): every other row and column
      const int rows = ni / 2, cols = nj / 2;
      const int r_first = n + (((c >> 1) + H + n) & 1), q_first = q_lo + (((c & 1) + q_lo) & 1);
      for (int k = threadIdx.x; k < rows * cols; k += DT) {
        const int r = r_first + 2 * (k / cols), q = q_first + 2 * (k % cols);
        const int gi = i0 + r, gj = j0 + q;
        if (gi < 0 || gi >= nx || gj < 0 || gj >= ny) continue;
        down_update<NS, PLANE, W>(s, r * W + q, P.omega);
      }
    }
    __syncthreads();
  }

  // the owned cells
  if (P.vec) {
    for (int k = threadIdx.x; k < TILE * TJ / 4; k += DT) {
      const int r = k / (TJ / 4), q = 4 * (k % (TJ / 4));
      const int gi = ti0 + r, gj = tj0 + q;
      if (gi < nx && gj < ny)
        *reinterpret_cast<float4*>(P.out_p + (int64_t)gi * ny + gj) =
            *reinterpret_cast<const float4*>(s + (H + r) * W + M + q);
    }
  } else {
    for (int k = threadIdx.x; k < TILE * TJ; k += DT) {
      const int gi = ti0 + k / TJ, gj = tj0 + k % TJ;
      if (gi < nx && gj < ny) P.out_p[(int64_t)gi * ny + gj] = s[(H + k / TJ) * W + M + k % TJ];
    }
  }
  // residual of the owned cells, restricted 2x2 (axis 0 first, as
  // ops/transfer_cc.restrict_cc), a coarse cell a thread at a time
  constexpr int TC = TJ / 2;
  for (int k = threadIdx.x; k < TILE / 2 * TC; k += DT) {
    const int gi = ti0 + 2 * (k / TC), gj = tj0 + 2 * (k % TC);
    if (gi >= nx || gj >= ny) continue;
    const int kk = (H + 2 * (k / TC)) * W + M + 2 * (k % TC);
    const float r00 = down_residual<NS, PLANE, W>(s, kk);
    const float r10 = down_residual<NS, PLANE, W>(s, kk + W);
    const float r01 = down_residual<NS, PLANE, W>(s, kk + 1);
    const float r11 = down_residual<NS, PLANE, W>(s, kk + W + 1);
    P.out_rc[(int64_t)(gi / 2) * (ny / 2) + gj / 2] =
        0.5f * (0.5f * (r00 + r10) + 0.5f * (r01 + r11));
  }
}

using DownKernel = void (*)(DownParams);

DownKernel down_kernel_of(bool five, int sweeps) {
  static const DownKernel k[2][3] = {
      {strip_down_kernel<9, 0>, strip_down_kernel<9, 1>, strip_down_kernel<9, 2>},
      {strip_down_kernel<5, 0>, strip_down_kernel<5, 1>, strip_down_kernel<5, 2>}};
  return sweeps >= 0 && sweeps <= 2 ? k[five ? 1 : 0][sweeps] : nullptr;
}

// The shared memory of every instance, set once per device.
bool g_down_ready[16];

cudaError_t down_setup(int device) {
  if (device < 0 || device >= 16) return cudaErrorInvalidDevice;
  if (g_down_ready[device]) return cudaSuccess;
  for (int five = 0; five < 2; ++five)
    for (int sweeps = 0; sweeps <= 2; ++sweeps) {
      const int smem = (int)sizeof(float) * down_smem_floats(five ? 5 : 9, sweeps);
      const cudaError_t err =
          cudaFuncSetAttribute((const void*)down_kernel_of(five, sweeps),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
  g_down_ready[device] = true;
  return cudaSuccess;
}

int launch_down(const long long* ptrs, const int* ip, const float* fp, void* stream) {
  DownParams P = {};
  const int nx = ip[0], ny = ip[1], five = ip[2], sweeps = ip[3];
  const int ns = five ? 5 : 9;
  const DownKernel k = down_kernel_of(five, sweeps);
  if (k == nullptr || nx % 2 || ny % 2) return (int)cudaErrorInvalidValue;
  bool aligned = ny % 4 == 0;
  for (int a = 0; a < ns + 2; ++a) {
    P.a[a] = reinterpret_cast<const float*>(ptrs[a]);
    aligned = aligned && ptrs[a] % 16 == 0;
  }
  P.out_p = reinterpret_cast<float*>(ptrs[ns + 2]);
  P.out_rc = reinterpret_cast<float*>(ptrs[ns + 3]);
  P.nx = nx; P.ny = ny; P.omega = fp[0];
  P.vec = aligned && ptrs[ns + 2] % 16 == 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = down_setup(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((ny + DOWN_TJ - 1) / DOWN_TJ, (nx + TILE - 1) / TILE);
  const size_t smem = sizeof(float) * down_smem_floats(ns, sweeps);
  k<<<grid, down_threads(ns), smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// strip_up

int launch_up(const long long* ptrs, const int* ip, const float* fp, void* stream) {
  Params P = {};
  const int nx = ip[0], ny = ip[1], five = ip[2], sweeps = ip[3];
  const int ns = five ? 5 : 9;
  P.p = reinterpret_cast<const float*>(ptrs[0]);
  P.b = reinterpret_cast<const float*>(ptrs[1]);
  for (int k = 0; k < ns; ++k) P.st[k] = reinterpret_cast<const float*>(ptrs[2 + k]);
  P.ec = reinterpret_cast<const float*>(ptrs[2 + ns]);
  P.out_p = reinterpret_cast<float*>(ptrs[3 + ns]);
  P.nx = nx; P.ny = ny; P.sweeps = sweeps; P.omega = fp[0];
  P.halo = (five ? 2 : 4) * sweeps;
  const int R = TILE + 2 * P.halo;
  const size_t smem = sizeof(float) * R * R;
  dim3 grid((ny + TILE - 1) / TILE, (nx + TILE - 1) / TILE);
  cudaStream_t s = (cudaStream_t)stream;
  if (five) strip_up_kernel<5><<<grid, THREADS, smem, s>>>(P);
  else strip_up_kernel<9><<<grid, THREADS, smem, s>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: p, b, stencil (5 or 9), out_p, out_rc;  ip: nx, ny, five, sweeps (0..2);  fp: omega
NF_EXPORT int nf_strip_down(const long long* ptrs, const int* ip, const float* fp,
                            void* stream) {
  return launch_down(ptrs, ip, fp, stream);
}

// The resident blocks an SM of strip_down's (five, sweeps) instance on the
// current device (a measurement aid: chip_smoke.py's build line).
NF_EXPORT int nf_strip_down_blocks_per_sm(int five, int sweeps, int* out) {
  const DownKernel k = down_kernel_of(five, sweeps);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = down_setup(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, k, down_threads(five ? 5 : 9), sizeof(float) * down_smem_floats(five ? 5 : 9, sweeps));
  return (int)err;
}

// ptrs: p, b, stencil (5 or 9), ec, out_p;  ip: nx, ny, five, sweeps;  fp: omega
NF_EXPORT int nf_strip_up(const long long* ptrs, const int* ip, const float* fp,
                          void* stream) {
  return launch_up(ptrs, ip, fp, stream);
}
