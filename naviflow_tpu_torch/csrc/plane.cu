// K10: the plane-resident fine multigrid level — plane_strip_down (K10a)
// and plane_strip_up (K10b).
//
// Replaces naviflow_tpu/ops/pallas_plane.py:plane_strip_down
// (_mk_down_kernel) and :plane_strip_up (_mk_up_kernel).  The level is held
// as its red ((i+j) even) and black colour planes R, B of shape (m, nc),
// nc = n / 2 (ops/plane.py):
//   down: `sweeps` red-black sweeps on the diagonal-normalised planes
//         (p_new = bh - sum(link_hat * nbr)), the normalised-form residual
//         r = c * (bh - p - sum(link_hat * nbr)), and the row-pair
//         restriction 0.25 * (s[2I] + s[2I+1]) of s = rR + rB, which is the
//         STANDARD-layout coarse residual, plus rc_zdiag (the b term the
//         normalised form drops at zero-diagonal cells);
//   up:   the clamped bilinear prolongation of the coarse correction into
//         both planes, fused into the load (the TPU composed it outside),
//         then `sweeps` sweeps.
//
// Bound on the H100: each half-sweep rereads its colour's five normalised
// planes (and the residual the two c planes), so the kernel is bound by
// L2/HBM reads of the stencil planes; R and B stay in shared memory through
// every pass.  Design: 2-D tiles of TI x TJ owned cells of both planes with
// a halo of 2 * sweeps (+ 1 for the residual) cells on every side.  The
// TPU's windows took whole rows, so only rows needed a halo; a 2-D tile
// needs one in both dimensions, because the n/s neighbours of a plane cell
// sit one plane column left or right.  Each half-sweep updates the region
// shrunk by one more ring, so the owned cells see exactly the global sweep.
// The n/s neighbour map depends on the parity of the GLOBAL row (red and
// black mirrored, ops/plane.py); cells outside the grid hold 0 and are
// never updated (the zero boundary links annihilate the wrapped rolls of
// the plain version), and nothing reads outside an allocation.  Tiles start
// on even global rows, so the coarse rows of a tile are its own.
//
// The case axis (nf_plane_strip_down_batched, nf_plane_strip_up_batched;
// the batching rules of ops/plane_strip.py, the vmapped lockstep step of
// algorithms/batch.py): B levels of one shape in one launch, the grid's z
// axis over the cases.  Thread 0 of each block moves every pointer of the
// case-0 parameters by its case's stride into a shared-memory copy
// (plane_case), and the single launch's tile code runs on that view, so
// each case's bits are its single launch's.  A frozen case's blocks copy R
// and B to the outputs and zero their coarse rows of rc (down).

#include "common.cuh"

namespace {

constexpr int TI = 32;  // owned rows per tile (even)
constexpr int TJ = 32;  // owned plane columns per tile
constexpr int THREADS = 256;

struct Params {
  const float* R;
  const float* B;
  const float* nrm[10];  // bh0, bh1, eh0, wh0, nh0, sh0, eh1, wh1, nh1, sh1
  const float* c0;       // down only: raw diagonal planes
  const float* c1;
  const float* rc_zdiag;  // down only: (m/2, nc)
  const float* ec;        // up only: coarse correction (m/2, nc)
  float* out_R;
  float* out_B;
  float* out_rc;  // down only
  int m, nc, sweeps, halo;
};

// One plane cell's normalised update sum(link_hat * nbr), neighbours from
// the OTHER colour's shared plane `o` at region cell k (row stride RJ).
// Red cells: n -> o[jc + odd], s -> o[jc + odd - 1]; black cells mirrored.
template <bool RED>
__device__ __forceinline__ float link_sum(const float* __restrict__ o, int k, int RJ, bool odd,
                                          float eh, float wh, float nh, float sh) {
  const float e = o[k + RJ], w = o[k - RJ];
  float n, s;
  if (RED) {
    n = odd ? o[k + 1] : o[k];
    s = odd ? o[k] : o[k - 1];
  } else {
    n = odd ? o[k] : o[k + 1];
    s = odd ? o[k - 1] : o[k];
  }
  return eh * e + wh * w + nh * n + sh * s;
}

// Load R and B (+ the prolongated correction when UP) on the region; cells
// off the grid hold 0.
template <bool UP>
__device__ void load_region(const Params& P, float* sR, float* sB, int i0r, int j0r, int RI,
                            int RJ) {
  for (int k = threadIdx.x; k < RI * RJ; k += blockDim.x) {
    const int gi = i0r + k / RJ, gj = j0r + k % RJ;
    float r = 0.f, b = 0.f;
    if (gi >= 0 && gi < P.m && gj >= 0 && gj < P.nc) {
      const int64_t g = (int64_t)gi * P.nc + gj;
      r = P.R[g];
      b = P.B[g];
      if (UP) {
        const int odd = gi & 1;  // red sits at column 2 jc + odd, black at 2 jc + 1 - odd
        r = r + nf_prolong_cc(P.ec, P.m / 2, P.nc, gi, 2 * gj + odd);
        b = b + nf_prolong_cc(P.ec, P.m / 2, P.nc, gi, 2 * gj + 1 - odd);
      }
    }
    sR[k] = r;
    sB[k] = b;
  }
  __syncthreads();
}

// One colour's half-sweep over region rows/cols [pass, R - pass).
template <bool RED>
__device__ void half_sweep(const Params& P, float* mine, const float* other, int i0r, int j0r,
                           int RI, int RJ, int pass) {
  const float* bh = P.nrm[RED ? 0 : 1];
  const float* const* L = P.nrm + (RED ? 2 : 6);  // eh, wh, nh, sh of this colour
  const int ni = RI - 2 * pass, nj = RJ - 2 * pass;
  for (int k = threadIdx.x; k < ni * nj; k += blockDim.x) {
    const int a = pass + k / nj, bc = pass + k % nj;
    const int gi = i0r + a, gj = j0r + bc;
    if (gi < 0 || gi >= P.m || gj < 0 || gj >= P.nc) continue;
    const int64_t g = (int64_t)gi * P.nc + gj;
    const int kk = a * RJ + bc;
    mine[kk] = bh[g] - link_sum<RED>(other, kk, RJ, gi & 1, L[0][g], L[1][g], L[2][g], L[3][g]);
  }
  __syncthreads();
}

__device__ void smooth_region(const Params& P, float* sR, float* sB, int i0r, int j0r, int RI,
                              int RJ) {
  int pass = 0;
  for (int s = 0; s < P.sweeps; ++s) {
    half_sweep<true>(P, sR, sB, i0r, j0r, RI, RJ, ++pass);
    half_sweep<false>(P, sB, sR, i0r, j0r, RI, RJ, ++pass);
  }
}

__device__ void store_owned(const Params& P, const float* sR, const float* sB, int ti0, int tj0,
                            int RJ) {
  const int H = P.halo;
  for (int k = threadIdx.x; k < TI * TJ; k += blockDim.x) {
    const int gi = ti0 + k / TJ, gj = tj0 + k % TJ;
    if (gi < P.m && gj < P.nc) {
      const int kk = (H + k / TJ) * RJ + H + k % TJ;
      P.out_R[(int64_t)gi * P.nc + gj] = sR[kk];
      P.out_B[(int64_t)gi * P.nc + gj] = sB[kk];
    }
  }
}

// rR + rB at one region cell: c * (bh - p - sum(link_hat * nbr)) per colour.
__device__ __forceinline__ float residual_pair(const Params& P, const float* sR, const float* sB,
                                               int kk, int RJ, int64_t g, bool odd) {
  const float* const* N = P.nrm;
  const float rR = P.c0[g] * (N[0][g] - sR[kk] -
                              link_sum<true>(sB, kk, RJ, odd, N[2][g], N[3][g], N[4][g], N[5][g]));
  const float rB = P.c1[g] * (N[1][g] - sB[kk] -
                              link_sum<false>(sR, kk, RJ, odd, N[6][g], N[7][g], N[8][g], N[9][g]));
  return rR + rB;
}

__device__ __forceinline__ void plane_down_tile(const Params& P, float* smem) {
  const int H = P.halo, RI = TI + 2 * H, RJ = TJ + 2 * H;
  float* sR = smem;
  float* sB = smem + RI * RJ;
  const int ti0 = blockIdx.y * TI, tj0 = blockIdx.x * TJ;
  load_region<false>(P, sR, sB, ti0 - H, tj0 - H, RI, RJ);
  smooth_region(P, sR, sB, ti0 - H, tj0 - H, RI, RJ);
  store_owned(P, sR, sB, ti0, tj0, RJ);
  // coarse row I = 0.25 * (s[2I] + s[2I+1]) of s = rR + rB, column jc
  for (int k = threadIdx.x; k < (TI / 2) * TJ; k += blockDim.x) {
    const int li = 2 * (k / TJ), lj = k % TJ;
    const int gi = ti0 + li, gj = tj0 + lj;
    if (gi >= P.m || gj >= P.nc) continue;
    const int kk = (H + li) * RJ + H + lj;
    const int64_t g = (int64_t)gi * P.nc + gj;
    const float s0 = residual_pair(P, sR, sB, kk, RJ, g, false);  // gi even
    const float s1 = residual_pair(P, sR, sB, kk + RJ, RJ, g + P.nc, true);
    const int64_t gc = (int64_t)(gi / 2) * P.nc + gj;
    P.out_rc[gc] = 0.25f * (s0 + s1) + P.rc_zdiag[gc];
  }
}

__device__ __forceinline__ void plane_up_tile(const Params& P, float* smem) {
  const int H = P.halo, RI = TI + 2 * H, RJ = TJ + 2 * H;
  float* sR = smem;
  float* sB = smem + RI * RJ;
  const int ti0 = blockIdx.y * TI, tj0 = blockIdx.x * TJ;
  load_region<true>(P, sR, sB, ti0 - H, tj0 - H, RI, RJ);
  smooth_region(P, sR, sB, ti0 - H, tj0 - H, RI, RJ);
  store_owned(P, sR, sB, ti0, tj0, RJ);
}

__global__ void __launch_bounds__(THREADS) plane_down_kernel(Params P) {
  extern __shared__ float smem[];
  plane_down_tile(P, smem);
}

__global__ void __launch_bounds__(THREADS) plane_up_kernel(Params P) {
  extern __shared__ float smem[];
  plane_up_tile(P, smem);
}

// B levels of one shape (the case axis): case 0's parameters, each pointer
// field's case stride in bytes (the same fields of S), the active flags
// and their stride.
struct PlaneBatch {
  Params P, S;
  const bool* active;
  const bool* active_stride;
};

// Case b = blockIdx.z's view of the parameters (thread 0; a stride of 0
// shares one array) and whether the case is active.
__device__ __forceinline__ bool plane_case(const PlaneBatch& SB, Params& P) {
  __shared__ bool on;
  if (threadIdx.x == 0) {
    const int b = (int)blockIdx.z;
    P = SB.P;
    nf_case_shift(P.R, SB.S.R, b);
    nf_case_shift(P.B, SB.S.B, b);
    for (int k = 0; k < 10; ++k) nf_case_shift(P.nrm[k], SB.S.nrm[k], b);
    nf_case_shift(P.c0, SB.S.c0, b);
    nf_case_shift(P.c1, SB.S.c1, b);
    nf_case_shift(P.rc_zdiag, SB.S.rc_zdiag, b);
    nf_case_shift(P.ec, SB.S.ec, b);
    nf_case_shift(P.out_R, SB.S.out_R, b);
    nf_case_shift(P.out_B, SB.S.out_B, b);
    nf_case_shift(P.out_rc, SB.S.out_rc, b);
    const bool* active = SB.active;
    nf_case_shift(active, SB.active_stride, b);
    on = *active;
  }
  __syncthreads();
  return on;
}

// A frozen case's tile: R and B copied to the outputs on the owned cells,
// and (down) the tile's coarse rows of rc zeroed.
__device__ __forceinline__ void plane_frozen(const Params& P, bool down) {
  const int ti0 = blockIdx.y * TI, tj0 = blockIdx.x * TJ;
  for (int k = threadIdx.x; k < TI * TJ; k += blockDim.x) {
    const int gi = ti0 + k / TJ, gj = tj0 + k % TJ;
    if (gi >= P.m || gj >= P.nc) continue;
    const int64_t g = (int64_t)gi * P.nc + gj;
    P.out_R[g] = P.R[g];
    P.out_B[g] = P.B[g];
    if (down && gi % 2 == 0) P.out_rc[(int64_t)(gi / 2) * P.nc + gj] = 0.f;
  }
}

__global__ void __launch_bounds__(THREADS) plane_down_kernel_batched(PlaneBatch SB) {
  extern __shared__ float smem[];
  __shared__ Params P;  // this case's view
  if (!plane_case(SB, P)) {
    plane_frozen(P, true);
    return;
  }
  plane_down_tile(P, smem);
}

__global__ void __launch_bounds__(THREADS) plane_up_kernel_batched(PlaneBatch SB) {
  extern __shared__ float smem[];
  __shared__ Params P;  // this case's view
  if (!plane_case(SB, P)) {
    plane_frozen(P, false);
    return;
  }
  plane_up_tile(P, smem);
}

// nf_plane_strip_down's / nf_plane_strip_up's slots and ip into P (the
// halo from the sweeps); the batched entry reads case 0's slots and then
// their strides with it.
void read_plane(bool down, const long long* ptrs, const int* ip, Params& P) {
  P = {};
  P.m = ip[0];
  P.nc = ip[1];
  P.sweeps = ip[2];
  auto in = [&](int k) { return reinterpret_cast<const float*>(ptrs[k]); };
  auto out = [&](int k) { return reinterpret_cast<float*>(ptrs[k]); };
  P.R = in(0);
  P.B = in(1);
  for (int k = 0; k < 10; ++k) P.nrm[k] = in(2 + k);
  if (down) {
    P.c0 = in(12);
    P.c1 = in(13);
    P.rc_zdiag = in(14);
    P.out_R = out(15);
    P.out_B = out(16);
    P.out_rc = out(17);
  } else {
    P.ec = in(12);
    P.out_R = out(13);
    P.out_B = out(14);
  }
  P.halo = 2 * P.sweeps + (down ? 1 : 0);
}

size_t plane_smem(const Params& P) {
  return sizeof(float) * 2 * (TI + 2 * P.halo) * (TJ + 2 * P.halo);
}

dim3 plane_grid(const Params& P, int cases) {
  return dim3((P.nc + TJ - 1) / TJ, (P.m + TI - 1) / TI, cases);
}

int launch(bool down, const long long* ptrs, const int* ip, void* stream) {
  Params P;
  read_plane(down, ptrs, ip, P);
  cudaStream_t s = (cudaStream_t)stream;
  if (down)
    plane_down_kernel<<<plane_grid(P, 1), THREADS, plane_smem(P), s>>>(P);
  else
    plane_up_kernel<<<plane_grid(P, 1), THREADS, plane_smem(P), s>>>(P);
  return (int)cudaGetLastError();
}

// B levels in one launch: the single entry's n slots for case 0, the
// active flags, then each of these n + 1 slots' case stride in bytes; ip:
// the single entry's, then B.
int launch_batched(bool down, const long long* ptrs, const int* ip, void* stream) {
  const int half = (down ? 18 : 15) + 1;
  PlaneBatch SB;
  read_plane(down, ptrs, ip, SB.P);
  read_plane(down, ptrs + half, ip, SB.S);
  SB.active = reinterpret_cast<const bool*>(ptrs[half - 1]);
  SB.active_stride = reinterpret_cast<const bool*>(ptrs[2 * half - 1]);
  const int cases = ip[3];
  if (!SB.active || cases < 1 || cases > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = plane_grid(SB.P, cases);
  if (down)
    plane_down_kernel_batched<<<grid, THREADS, plane_smem(SB.P), s>>>(SB);
  else
    plane_up_kernel_batched<<<grid, THREADS, plane_smem(SB.P), s>>>(SB);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: R, B, bh0, bh1, eh0, wh0, nh0, sh0, eh1, wh1, nh1, sh1, c0, c1,
//       rc_zdiag, out_R, out_B, out_rc;  ip: m, nc, sweeps
NF_EXPORT int nf_plane_strip_down(const long long* ptrs, const int* ip, const float* fp,
                                  void* stream) {
  (void)fp;
  return launch(true, ptrs, ip, stream);
}

// ptrs: R, B, bh0, bh1, eh0, wh0, nh0, sh0, eh1, wh1, nh1, sh1, ec, out_R,
//       out_B;  ip: m, nc, sweeps
NF_EXPORT int nf_plane_strip_up(const long long* ptrs, const int* ip, const float* fp,
                                void* stream) {
  (void)fp;
  return launch(false, ptrs, ip, stream);
}

// B levels of one shape in one launch (the case axis; grid z = B).
// ptrs: nf_plane_strip_down's 18 slots for case 0, the cases' active flags
//       (bool), then each of these 19 slots' case stride in bytes, in the
//       same order (0: one array shared by every case)
// ip:   nf_plane_strip_down's, then B
NF_EXPORT int nf_plane_strip_down_batched(const long long* ptrs, const int* ip, const float* fp,
                                          void* stream) {
  (void)fp;
  return launch_batched(true, ptrs, ip, stream);
}

// B levels of one shape in one launch (the case axis; grid z = B).
// ptrs: nf_plane_strip_up's 15 slots for case 0, the active flags, then
//       each of these 16 slots' case stride in bytes
// ip:   nf_plane_strip_up's, then B
NF_EXPORT int nf_plane_strip_up_batched(const long long* ptrs, const int* ip, const float* fp,
                                        void* stream) {
  (void)fp;
  return launch_batched(false, ptrs, ip, stream);
}
