// K8: both momentum fields' power-law coefficient sets in one pass, with the
// Gershgorin maxima and, optionally, the d / pressure-operator fold.
//
// Replaces naviflow_tpu/ops/pallas_assembly.py:fused_assembly_pair (body
// _mk_kernel).  What it computes, per field (u on (nx+1, ny) faces, v on
// (nx, ny+1) faces):
//   coefficients   ops/powerlaw.{u,v}_momentum_coefficients (Practice-B folds)
//   relaxation     ops/powerlaw.relax_coefficients (1e-12 a_p floor)
//   Gershgorin     the masked max of sum|a_nb| / a_p_relaxed over the field
// and with the fold (variant >= 0) d_u, d_v (ops/powerlaw.d_coefficient) and
// the 5-array pressure-correction operator (ops/poisson.poisson_coefficients).
// The u grid's last face row I = nx comes out of the same per-face code: its
// links and unrelaxed pair are zero, the relaxed a_p is 1e-12 / alpha and
// src = (1 - alpha) a_p u[nx], as the JAX wrapper appends it.
//
// Bound on the H100: bytes.  It reads u, v, p once and writes 16 arrays
// (23 with the fold): 0.095 ms (0.130 ms folded) of HBM traffic at 2048^2.
// But a face's coefficients cost IEEE divisions under -fmad=false (F / D
// on its sides, a_p / alpha, the Gershgorin ratio, d), and the arithmetic
// alone takes about as long as the stores (k8_probe.py times both), so it
// has to hide under them.  Design:
//   * a warp owns a strip of 64 columns and `ti` rows (ti <= 31, chosen by
//     the entry) and walks it row by row, lane l on columns j0 + 2 l and
//     j0 + 2 l + 1 of the u rows; it writes each output of the two faces
//     with one 8-byte store where the index is even (every lane alike), so
//     a warp's store covers two whole 128-byte lines;
//   * the v rows are ny + 1 floats long, so a strip on the u columns would
//     store every v row across 128-byte lines.  Where ny % 64 == 0,
//     v row i takes the columns from j0 - s_i, s_i = i % 64, whose flat
//     index starts a line: the strip leans one column to the left a row,
//     and its v stores are whole lines too;
//   * each face computes the flux and power-law term D A(F) of its east
//     and north sides once (powerlaw.cuh face_flux); its west ones are the
//     row before's east ones, kept in registers (where the v strip leans,
//     a lane's first face takes lane l - 1's second face's by a shuffle and
//     its second face its first face's), and its south ones its left
//     neighbour's north ones (the lane's first face's, or lane l - 1's
//     second face's by a shuffle): a face makes two of its four divisions
//     F / D (u_coef_flux / v_coef_flux: u_coef's and v_coef's bits).  The terms
//     lane 0 lacks (its south and, leaning, its west neighbour's) are
//     computed before the walk, one row a lane, into the warp's slots of
//     shared memory, and the first row's west terms directly;
//   * the fold's d are outputs: a second launch reads them back (8% of the
//     fold's bytes) and writes the pressure operator of each cell with
//     pressure_cell_from_d, so no coefficient set is rebuilt for it (d kept
//     in registers would tie the v lanes to the u columns);
//   * no barrier inside a tile; (i, j) come from the tile's origin and the
//     lane, with no division; indices are 32-bit;
//   * persistent blocks of 4 warps walk tiles of 4 strips side by side,
//     and fold their Gershgorin maxima into the two-float output once, by
//     a signed-int atomicMax on the float's bits: every candidate is >= 0
//     or loses to the +0.0 the entry sets, so the result is exact and
//     independent of the order.
// Every value comes from the same f32 operations in the same order as in
// the one-thread-a-face kernel this design replaced (coefficients from
// global indices), so every output keeps that kernel's bits.
//
// The case axis (nf_fused_assembly_pair_batched; the batching rule of
// ops/assembly.py, the vmapped lockstep step of algorithms/batch.py): the
// same resident blocks walk (case, tile) items, case-major, and the
// operator's launch covers every case.  When the walk enters a case, a
// block reads its conductances (ops/powerlaw.case_conductances: the single
// wrapper's doubles rounded to float, so the same floats) and active flag;
// each item moves u, v, p by the case strides and the outputs by the
// case's offset; when the walk leaves a case, the block folds its maxima
// into the case's pair.  Each tile runs the single launch's tile code on
// that view, so each case's bits are its single launch's.  A frozen case's
// tiles write zeros to every output they cover (the same walk, its values
// dropped), so its operator comes out zero, and its maxima stay the
// entry's +0.0: the composed operators downstream guard a zero a_p and a
// zero diagonal, so a frozen case stays finite, and the lockstep loop
// drops its results.

#include "common.cuh"
#include "powerlaw.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CPL = 2;          // columns a lane
constexpr int SW = 32 * CPL;    // a strip's columns: one strip a warp
constexpr int TJ = SW * WARPS;  // a tile's columns
constexpr int TI_MAX = 31;      // a tile's rows (and u row nx): one a lane
// The resident blocks an SM the launch bounds ask for: 64 registers a
// thread, 72 on the case axis (its view is not constant; at 64 it spills).
constexpr int BLOCKS_PER_SM = 8;
constexpr int CASE_BLOCKS_PER_SM = 7;
constexpr unsigned ALL = 0xffffffffu;

struct AsmParams {
  const float* u;
  const float* v;
  const float* p;
  float* cu[8];  // a_e, a_w, a_n, a_s, a_p, src unrelaxed; a_p, src relaxed
  float* cv[8];
  float* gmax;   // [2]: the u and v maxima, combined as int bits
  float* d_u;    // the fold (variant >= 0) only
  float* d_v;
  float* pc[5];  // a_e, a_w, a_n, a_s, diag
  int nx, ny, variant;     // variant: -1 no fold, 0 consistent, 1 symmetric, 2 reference
  int ti, tiles_j, tiles;  // a tile's rows, tiles across, tiles a case
  int lean;                // the v strips lean onto whole lines (ny % SW == 0)
  float cFu, cFv, De, Dn, dx, dy, alpha, one_m_alpha, rho;
};

// The case axis: the inputs' and the outputs' case strides in bytes (the
// outputs are one buffer of case layouts: one stride), each case's
// conductances (De, Dn, 1 / De, 1 / Dn; De and Dn read) and active flag,
// each with its stride.
struct AsmCases {
  long long su, sv, sp, so;
  const float* visc;
  long long svisc;
  const bool* active;
  long long sactive;
  int cases;
};

// What the face code reads (powerlaw.cuh's Prm): one case's fields and
// conductances, the rest the launch's.
struct View {
  const float *u, *v, *p;
  int nx, ny;
  float cFu, cFv, De, Dn, dx, dy, alpha, rho;
};

// One case's fields (powerlaw.cuh's accessors for the view), indexed in 32
// bits: a case holds fewer than 2^31 faces (the entry checks).
__device__ __forceinline__ float U(const View& w, int i, int j) { return w.u[i * w.ny + j]; }
__device__ __forceinline__ float V(const View& w, int i, int j) { return w.v[i * (w.ny + 1) + j]; }
__device__ __forceinline__ float Pr(const View& w, int i, int j) { return w.p[i * w.ny + j]; }

template <class T>
__host__ __device__ __forceinline__ T* shifted(T* p, long long bytes, int b) {
  return reinterpret_cast<T*>(reinterpret_cast<intptr_t>(p) + (intptr_t)b * bytes);
}

// Case b's view (CASES: its conductances de, dn), or the launch's.
template <bool CASES>
__device__ __forceinline__ View view_of(const AsmParams& P, const AsmCases& B, int b, float de,
                                        float dn) {
  if constexpr (CASES) {
    return View{shifted(P.u, B.su, b), shifted(P.v, B.sv, b), shifted(P.p, B.sp, b), P.nx, P.ny,
                P.cFu, P.cFv, de, dn, P.dx, P.dy, P.alpha, P.rho};
  } else {
    return View{P.u, P.v, P.p, P.nx, P.ny, P.cFu, P.cFv, P.De, P.Dn, P.dx, P.dy, P.alpha, P.rho};
  }
}

// How far v row i's strip leans: its lane 0 on column j0 - lean_of(i).
__device__ __forceinline__ int lean_of(const AsmParams& P, int i) {
  return P.lean ? i & (SW - 1) : 0;
}

// Face (i, j)'s outputs: a_e, a_w, a_n, a_s, a_p, src, the relaxed a_p and
// src, and with the fold d.
struct Face {
  float a[9];
};

// Face (i, j) of one field from its own flux terms `o` and its west and
// south neighbours': its outputs, its masked Gershgorin ratio into gmax.
template <bool IS_U, bool FOLD, bool BOUNDS>
__device__ __forceinline__ Face face_of(const AsmParams& P, const View& w, int i, int j,
                                        FaceFlux o, Flux west, Flux south, float& gmax) {
  Coef c;
  if constexpr (IS_U) c = u_coef_flux(w, i, j, o, west.F, west.DA, south.F, south.DA);
  else c = v_coef_flux(w, i, j, o, west.F, west.DA, south.F, south.DA);
  const float apr = relax_ap(w, c.ap);
  const float x = IS_U ? U(w, i, j) : V(w, i, j);
  Face f = {{c.ae, c.aw, c.an, c.as, c.ap, c.src, apr, c.src + P.one_m_alpha * apr * x, 0.f}};
  if (FOLD) {
    const bool row = IS_U ? (i >= 1 && i <= w.nx - 1) : (j >= 1 && j <= w.ny - 1);
    f.a[8] = (row && fabsf(apr) > 1e-12f) ? (IS_U ? w.dy : w.dx) / apr : 0.f;
  }
  const int NI = IS_U ? w.nx + 1 : w.nx, NJ = IS_U ? w.ny : w.ny + 1;
  if (BOUNDS && i >= 1 && i <= NI - 2 && j >= 1 && j <= NJ - 2) {
    const float safe = apr == 0.f ? 1.f : apr;
    gmax = fmaxf(gmax, (fabsf(c.ae) + fabsf(c.aw) + fabsf(c.an) + fabsf(c.as)) / safe);
  }
  return f;
}

// A lane's two faces' outputs at g and g + 1 (each where `in0` / `in1`;
// zeros where ZERO): one 8-byte store an array where g is even (the same
// for every lane of a warp), else one store a face.
template <bool IS_U, bool FOLD, bool ZERO>
__device__ __forceinline__ void store_pair(const AsmParams& P, int g, const Face& f0,
                                           const Face& f1, bool in0, bool in1) {
  float* const* out = IS_U ? P.cu : P.cv;
  float* dd = IS_U ? P.d_u : P.d_v;
  constexpr int N = FOLD ? 9 : 8;
  if ((g & 1) == 0 && in0 && in1) {
#pragma unroll
    for (int a = 0; a < N; ++a)
      *reinterpret_cast<float2*>((a < 8 ? out[a] : dd) + g) =
          ZERO ? make_float2(0.f, 0.f) : make_float2(f0.a[a], f1.a[a]);
    return;
  }
#pragma unroll
  for (int a = 0; a < N; ++a) {
    float* q = (a < 8 ? out[a] : dd) + g;
    if (in0) q[0] = ZERO ? 0.f : f0.a[a];
    if (in1) q[1] = ZERO ? 0.f : f1.a[a];
  }
}

// The lane neighbour's north terms of its second column, lane 0's `h`.
__device__ __forceinline__ Flux south_of(const FaceFlux& o, const Flux& h) {
  const Flux s = {__shfl_up_sync(ALL, o.Fn, 1), __shfl_up_sync(ALL, o.DAn, 1)};
  return (threadIdx.x & 31) == 0 ? h : s;
}

// One warp's strip of the tile at row i0: u faces (i, j0 + 2 l + e) and v
// faces (i, j0 - lean_of(i) + 2 l + e), lane l, e = 0, 1, rows i0 .. i0 +
// rows - 1, and u row nx where the tile holds the grid's last cell row.
// ob: the case's output offset in elements; halo: the warp's 96 slots of
// shared memory (the terms lane 0 lacks, [u south | v south | v west] x
// row).
template <bool FOLD, bool BOUNDS, bool ZERO>
__device__ __forceinline__ void strip(const AsmParams& P, const View& w, int ob, int i0, int j0,
                                      float& gu, float& gv, Flux* halo) {
  const int nx = w.nx, ny = w.ny, lane = threadIdx.x & 31;
  const int j = j0 + CPL * lane;
  const int rows = min(P.ti, nx - i0);
  const int steps = rows + (i0 + rows == nx);
  const FaceFlux none = {0.f, 0.f, 0.f, 0.f};
  // before the walk, lane k on row i0 + k: the terms lane 0 lacks there
  // (the north terms of its first u and v faces' south neighbours, and the
  // east terms of its first leaning v face's west neighbour), into `halo`
  Flux hu = {0.f, 0.f}, hv = {0.f, 0.f}, hw = {0.f, 0.f};
  if (lane < steps) {
    const int i = i0 + lane, c = j0 - lean_of(P, i);
    if (j0 > 0) hu = flux_north<true>(w, i, j0 - 1);
    if (lane < rows) {
      if (c > 0) hv = flux_north<false>(w, i, c - 1);
      if (i > 0 && c >= 0) hw = flux_east<false>(w, i - 1, c);
    }
  }
  __syncwarp();  // the warp's last strip is done with the slots
  halo[lane] = hu;
  halo[32 + lane] = hv;
  halo[64 + lane] = hw;
  __syncwarp();
  // the row before's east terms of each column
  Flux wu0 = {0.f, 0.f}, wu1 = {0.f, 0.f}, wv0 = {0.f, 0.f}, wv1 = {0.f, 0.f};
  int lean_prev = 0;
  for (int k = 0; k < steps; ++k) {
    const int i = i0 + k;
    {  // u row i
      const bool in0 = j < ny, in1 = j + 1 < ny;
      const FaceFlux o0 = in0 ? face_flux<true>(w, i, j) : none;
      const FaceFlux o1 = in1 ? face_flux<true>(w, i, j + 1) : none;
      if (k == 0 && i > 0) {
        if (in0) wu0 = flux_east<true>(w, i - 1, j);
        if (in1) wu1 = flux_east<true>(w, i - 1, j + 1);
      }
      const Flux s0 = south_of(o1, halo[k]), s1 = {o0.Fn, o0.DAn};
      Face f0 = {}, f1 = {};
      if (!ZERO && in0) f0 = face_of<true, FOLD, BOUNDS>(P, w, i, j, o0, wu0, s0, gu);
      if (!ZERO && in1) f1 = face_of<true, FOLD, BOUNDS>(P, w, i, j + 1, o1, wu1, s1, gu);
      store_pair<true, FOLD, ZERO>(P, ob + i * ny + j, f0, f1, in0, in1);
      wu0 = {o0.Fe, o0.DAe};
      wu1 = {o1.Fe, o1.DAe};
    }
    if (k < rows) {  // v row i
      const int lean = lean_of(P, i), c = j0 - lean + CPL * lane;
      const bool in0 = c >= 0 && c <= ny, in1 = c + 1 >= 0 && c + 1 <= ny;
      const FaceFlux o0 = in0 ? face_flux<false>(w, i, c) : none;
      const FaceFlux o1 = in1 ? face_flux<false>(w, i, c + 1) : none;
      Flux w0 = wv0, w1 = wv1;  // the same columns (k > 0, the same lean)
      if (k > 0 && lean == lean_prev + 1) {  // one column to the left
        const Flux l = {__shfl_up_sync(ALL, wv1.F, 1), __shfl_up_sync(ALL, wv1.DA, 1)};
        w0 = lane == 0 ? halo[64 + k] : l;
        w1 = wv0;
      } else if (k == 0 || lean != lean_prev) {  // the first row, or the lean starts over
        w0 = in0 && i > 0 ? flux_east<false>(w, i - 1, c) : Flux{0.f, 0.f};
        w1 = in1 && i > 0 ? flux_east<false>(w, i - 1, c + 1) : Flux{0.f, 0.f};
      }
      const Flux s0 = south_of(o1, halo[32 + k]), s1 = {o0.Fn, o0.DAn};
      Face f0 = {}, f1 = {};
      if (!ZERO && in0) f0 = face_of<false, FOLD, BOUNDS>(P, w, i, c, o0, w0, s0, gv);
      if (!ZERO && in1) f1 = face_of<false, FOLD, BOUNDS>(P, w, i, c + 1, o1, w1, s1, gv);
      store_pair<false, FOLD, ZERO>(P, ob + i * (ny + 1) + c, f0, f1, in0, in1);
      wv0 = {o0.Fe, o0.DAe};
      wv1 = {o1.Fe, o1.DAe};
      lean_prev = lean;
    }
  }
}

// The block's Gershgorin maxima into a two-float output.
__device__ __forceinline__ void fold_gmax(float* gmax, float gu, float gv) {
  gu = nf_block_max(gu);
  if (threadIdx.x == 0) atomicMax(reinterpret_cast<int*>(gmax), __float_as_int(gu));
  __syncthreads();  // nf_block_max reuses one shared scratch
  gv = nf_block_max(gv);
  if (threadIdx.x == 0) atomicMax(reinterpret_cast<int*>(gmax) + 1, __float_as_int(gv));
  __syncthreads();
}

// The persistent blocks walk the tiles (CASES: the (case, tile) items,
// case-major; each case's outputs ob = b * so / 4 elements on, which the
// entry keeps below 2^31), warp w on the tile's strip w.
template <bool FOLD, bool BOUNDS, bool CASES>
__global__ void __launch_bounds__(THREADS, CASES ? CASE_BLOCKS_PER_SM : BLOCKS_PER_SM)
    assembly_kernel(AsmParams P, AsmCases B) {
  __shared__ Flux halos[WARPS * 96];  // each warp's strip's halo slots
  float gu = 0.f, gv = 0.f, de = 0.f, dn = 0.f;
  int cur = -1;
  bool on = true;
  const int items = CASES ? B.cases * P.tiles : P.tiles;
  const int j_warp = SW * (threadIdx.x >> 5);
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const int b = CASES ? t / P.tiles : 0;
    const int tile = t - b * P.tiles;
    if (CASES && b != cur) {  // the walk enters case b
      if (BOUNDS && cur >= 0 && on) fold_gmax(shifted(P.gmax, B.so, cur), gu, gv);
      gu = gv = 0.f;
      const float* visc = shifted(B.visc, B.svisc, b);
      de = visc[0];
      dn = visc[1];
      on = *shifted(B.active, B.sactive, b);
      cur = b;
    }
    const int row = tile / P.tiles_j;
    // a strip past ny (in the last tile across) has no face: its lanes stay
    // idle, and no warp leaves the walk, so the shuffles see whole warps
    const int i0 = row * P.ti, j0 = (tile - row * P.tiles_j) * TJ + j_warp;
    const View w = view_of<CASES>(P, B, b, de, dn);
    const int ob = b * (int)(B.so / 4);
    Flux* halo = halos + 96 * (threadIdx.x >> 5);
    if (CASES && !on) strip<FOLD, BOUNDS, true>(P, w, ob, i0, j0, gu, gv, halo);
    else strip<FOLD, BOUNDS, false>(P, w, ob, i0, j0, gu, gv, halo);
  }
  if (BOUNDS && (int)blockIdx.x < items && on)
    fold_gmax(shifted(P.gmax, B.so, CASES ? cur : 0), gu, gv);
}

// The fold's second launch: the pressure operator of cell (blockIdx.y,
// blockIdx.x * THREADS + threadIdx.x) of case blockIdx.z from the d the
// first launch wrote (a frozen case's zeros give a zero operator).
template <bool CASES>
__global__ void __launch_bounds__(THREADS) pressure_kernel(AsmParams P, AsmCases B) {
  const int i = blockIdx.y, j = blockIdx.x * THREADS + threadIdx.x, ny = P.ny;
  if (j >= ny) return;
  const long long ob = CASES ? (long long)blockIdx.z * (B.so / 4) : 0;
  const float* du = P.d_u + ob + (long long)i * ny + j;
  const float* dv = P.d_v + ob + (long long)i * (ny + 1) + j;
  float* const pc[5] = {P.pc[0] + ob, P.pc[1] + ob, P.pc[2] + ob, P.pc[3] + ob, P.pc[4] + ob};
  pressure_cell_from_d(P, P.variant, i, j, du[0], du[ny], dv[0], dv[1], pc,
                       (long long)i * ny + j);
}

using Kernel = void (*)(AsmParams, AsmCases);

template <bool CASES>
Kernel kernel_of(bool fold, bool bounds) {
  if (fold)
    return bounds ? assembly_kernel<true, true, CASES> : assembly_kernel<true, false, CASES>;
  return bounds ? assembly_kernel<false, true, CASES> : assembly_kernel<false, false, CASES>;
}

// Per device ordinal and instance: the resident blocks (0 = not set up).
int g_resident[16][8];

// A tile's rows: the fewest waves of the resident blocks over the items,
// each costing its rows and about two rows' worth of halo; ties go to the
// taller tile.
int pick_ti(int nx, int tiles_j, long long cases, int resident) {
  int best = TI_MAX;
  long long best_cost = -1;
  for (int ti = TI_MAX; ti >= 4; --ti) {
    const long long items = cases * tiles_j * ((nx + ti - 1) / ti);
    const long long cost = (items + resident - 1) / resident * (ti + 2);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = ti;
    }
  }
  return best;
}

// Launch the instance for P's fold and `bounds`, then with the fold the
// operator's pass; with the maxima, zero each case's pair first (+0.0:
// atomicMax's start).
template <bool CASES>
int launch_one(AsmParams P, const AsmCases& B, bool bounds, cudaStream_t s) {
  const long long cases = CASES ? B.cases : 1;
  const bool fold = P.variant >= 0;
  const Kernel k = kernel_of<CASES>(fold, bounds);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 16) return (int)cudaErrorInvalidDevice;
  int& resident = g_resident[device][4 * CASES + 2 * fold + bounds];
  if (resident == 0) {
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    resident = per_sm * n_sm;
  }
  P.lean = P.ny % SW == 0;
  P.tiles_j = (P.ny / SW + 1 + WARPS - 1) / WARPS;  // strips j0 = 0, SW, ..., <= ny
  P.ti = pick_ti(P.nx, P.tiles_j, cases, resident);
  P.tiles = P.tiles_j * ((P.nx + P.ti - 1) / P.ti);
  const long long items = cases * P.tiles;
  if (items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (bounds) {
    err = CASES ? cudaMemset2DAsync(P.gmax, (size_t)B.so, 0, 2 * sizeof(float), cases, s)
                : cudaMemsetAsync(P.gmax, 0, 2 * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  k<<<(int)(items < resident ? items : resident), THREADS, 0, s>>>(P, B);
  if (fold) {
    const dim3 grid((P.ny + THREADS - 1) / THREADS, P.nx, (unsigned)cases);
    pressure_kernel<CASES><<<grid, THREADS, 0, s>>>(P, B);
  }
  return (int)cudaGetLastError();
}

// Launch the instance for P's fold and `bounds`, then with the fold the
// operator's pass; with the maxima, zero each case's pair first (+0.0:
// atomicMax's start).
// The case axis runs in launches of as many cases as keep every output
// index of a launch below 2^31 (all of them, but for the largest grids).
template <bool CASES>
int launch(AsmParams P, AsmCases B, bool bounds, cudaStream_t s) {
  const long long cases = CASES ? B.cases : 1;
  const long long faces = (long long)(P.nx + 1) * (P.ny + 1);
  if (P.nx < 2 || P.ny < 2 || P.nx > 65535 || cases < 1 ||
      cases > 65535 || faces >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (!CASES) return launch_one<false>(P, B, bounds, s);
  const long long per = B.so / 4;  // a case's outputs, in floats
  const long long chunk = per >= (1LL << 31) - faces ? 1 : ((1LL << 31) - faces) / per;
  for (long long c0 = 0; c0 < cases; c0 += chunk) {
    AsmParams Q = P;
    AsmCases C = B;
    const int c = (int)c0;
    Q.u = shifted(P.u, B.su, c);
    Q.v = shifted(P.v, B.sv, c);
    Q.p = shifted(P.p, B.sp, c);
    float** outs[] = {&Q.gmax, &Q.d_u, &Q.d_v};
    for (float** q : outs) *q = *q ? shifted(*q, B.so, c) : nullptr;
    for (int a = 0; a < 8; ++a) {
      Q.cu[a] = shifted(P.cu[a], B.so, c);
      Q.cv[a] = shifted(P.cv[a], B.so, c);
    }
    for (int a = 0; a < 5; ++a) Q.pc[a] = P.pc[a] ? shifted(P.pc[a], B.so, c) : nullptr;
    C.visc = shifted(B.visc, B.svisc, c);
    C.active = shifted(B.active, B.sactive, c);
    C.cases = (int)(cases - c0 < chunk ? cases - c0 : chunk);
    const int err = launch_one<true>(Q, C, bounds, s);
    if (err) return err;
  }
  return 0;
}

// nf_fused_assembly_pair's slots, ip and fp into P; returns the number of
// slots read (20, or 27 with the fold).  The batched entry reads case 0's
// slots and then their strides with it.
int read_assembly(const long long* ptrs, const int* ip, const float* fp, AsmParams& P) {
  P = {};
  int k = 0;
  auto next = [&]() { return reinterpret_cast<float*>(ptrs[k++]); };
  P.u = next(); P.v = next(); P.p = next();
  for (int a = 0; a < 8; ++a) P.cu[a] = next();
  for (int a = 0; a < 8; ++a) P.cv[a] = next();
  P.gmax = next();
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

// ptrs: u, v, p, the 8 u-coefficient arrays, the 8 v-coefficient arrays,
//       gmax (2 floats, written with the maxima only), then with the fold
//       d_u, d_v and the pressure operator's a_e, a_w, a_n, a_s, diag
// ip:   nx, ny, variant (-1: no fold), bounds (0 / 1)
// fp:   cFu, cFv, De, Dn, dx, dy, alpha, one_m_alpha, rho
NF_EXPORT int nf_fused_assembly_pair(const long long* ptrs, const int* ip, const float* fp,
                                     void* stream) {
  AsmParams P;
  read_assembly(ptrs, ip, fp, P);
  return launch<false>(P, AsmCases{}, ip[3] != 0, (cudaStream_t)stream);
}

// B cases of one shape in one launch (the case axis).
// ptrs: nf_fused_assembly_pair's n slots for case 0 (n = 20, 27 with the
//       fold), the cases' conductances (B, 4: De, Dn, 1 / De, 1 / Dn), the
//       active flags (bool), then each of these n + 2 slots' case stride in
//       bytes, in the same order (0: one array shared by every case; every
//       output's the same: one buffer of case layouts)
// ip:   nf_fused_assembly_pair's, then B
// fp:   nf_fused_assembly_pair's (De and Dn unused: each case's own)
NF_EXPORT int nf_fused_assembly_pair_batched(const long long* ptrs, const int* ip,
                                             const float* fp, void* stream) {
  AsmParams P;
  const int n = read_assembly(ptrs, ip, fp, P);
  const long long* S = ptrs + n + 2;  // the strides
  AsmCases B = {S[0], S[1], S[2], S[3], reinterpret_cast<const float*>(ptrs[n]), S[n],
                reinterpret_cast<const bool*>(ptrs[n + 1]), S[n + 1], ip[4]};
  for (int k = 4; k < n; ++k)
    if (S[k] != B.so) return (int)cudaErrorInvalidValue;
  if (!B.visc || !B.active || B.so < 2 * (long long)sizeof(float) || B.so % 4 != 0)
    return (int)cudaErrorInvalidValue;
  return launch<true>(P, B, ip[3] != 0, (cudaStream_t)stream);
}
