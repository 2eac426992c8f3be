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

__global__ void __launch_bounds__(THREADS) plane_down_kernel(Params P) {
  extern __shared__ float smem[];
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

__global__ void __launch_bounds__(THREADS) plane_up_kernel(Params P) {
  extern __shared__ float smem[];
  const int H = P.halo, RI = TI + 2 * H, RJ = TJ + 2 * H;
  float* sR = smem;
  float* sB = smem + RI * RJ;
  const int ti0 = blockIdx.y * TI, tj0 = blockIdx.x * TJ;
  load_region<true>(P, sR, sB, ti0 - H, tj0 - H, RI, RJ);
  smooth_region(P, sR, sB, ti0 - H, tj0 - H, RI, RJ);
  store_owned(P, sR, sB, ti0, tj0, RJ);
}

int launch(bool down, const long long* ptrs, const int* ip, void* stream) {
  Params P = {};
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
  const size_t smem = sizeof(float) * 2 * (TI + 2 * P.halo) * (TJ + 2 * P.halo);
  dim3 grid((P.nc + TJ - 1) / TJ, (P.m + TI - 1) / TI);
  cudaStream_t s = (cudaStream_t)stream;
  if (down)
    plane_down_kernel<<<grid, THREADS, smem, s>>>(P);
  else
    plane_up_kernel<<<grid, THREADS, smem, s>>>(P);
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
