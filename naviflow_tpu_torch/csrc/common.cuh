// Shared helpers of the port's CUDA kernels.
//
// Every C entry point takes three host arrays and the stream:
//   ptrs  — device pointers (as 64-bit integers) of the tensors it reads
//           and writes, in the order its wrapper documents;
//   ip    — integer parameters;
//   fp    — float parameters;
// launches on the given stream, and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NF_EXPORT extern "C" __attribute__((visibility("default")))

// A batched launch's case view (K1-K5, K7): pointer `p` of case 0 moved by
// b times its case stride in bytes, which the strides' copy of the
// parameters holds in the same field.
template <class T>
__device__ __forceinline__ void nf_case_shift(T*& p, const void* stride, int b) {
  p = reinterpret_cast<T*>(reinterpret_cast<intptr_t>(p) +
                           (intptr_t)b * reinterpret_cast<intptr_t>(stride));
}

// Block-wide max of one float per thread (blockDim.x a multiple of 32,
// at most 1024 threads).  Every thread of the block must call it.
__device__ __forceinline__ float nf_block_max(float v) {
  __shared__ float warp_max[32];
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  v = (threadIdx.x < n_warps) ? warp_max[threadIdx.x] : 0.f;
  if (warp == 0)
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;  // valid in thread 0
}

// cp.async copies of one float (4 bytes) or four (16 bytes, both addresses
// 16-byte aligned) from global into shared memory; `in` false fills the
// slot with zeros and reads nothing (the zero padding off a grid).
__device__ __forceinline__ void nf_cp16(unsigned dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void nf_cp4(unsigned dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void nf_commit_staged() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are pending, then a block barrier.
template <int N>
__device__ __forceinline__ void nf_wait_staged() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  __syncthreads();
}

// The staged tiles of K2 (strip.cu) and K11a (poisson.cu).  A region type R
// gives the block's THREADS, the owned tile's TI x TJ cells, the halo H,
// the column margin M (H rounded up to 4: 16-byte rows), the region's RI x
// W slots (PLANE = RI * W a staged array), and the inner columns
// [QLO, QHI) that arrays after the first are staged on; the parameters P
// give the arrays a[], the output out_p, nx, ny and vec (every array
// 16-byte aligned and ny % 4 == 0).

// Issue the copies of arrays [A0, A1) of region R of the tile whose slot
// (0, 0) is cell (i0, j0): array 0 (p) on the whole region, zeros off the
// grid; the others on rows 1..RI-2, columns QLO..QHI-1.
template <class R, int A0, int A1, class Params>
__device__ __forceinline__ void nf_stage_region(const Params& P, unsigned base, int i0,
                                                int j0) {
  const int nx = P.nx, ny = P.ny;
  if (P.vec) {  // 16-byte chunks: j0 and ny are multiples of 4, so a chunk is on or off the grid
    constexpr int CH = R::W / 4;
    for (int k = threadIdx.x; k < R::RI * CH; k += R::THREADS) {
      const int r = k / CH, q = 4 * (k % CH);
      const int gi = i0 + r, gj = j0 + q;
      const bool in = gi >= 0 && gi < nx && gj >= 0 && gj < ny;
      const int64_t g = in ? (int64_t)gi * ny + gj : 0;
      const unsigned dst = base + 4u * (r * R::W + q);
      const bool ring = !(r >= 1 && r < R::RI - 1 && q >= R::QLO && q < R::QHI);
#pragma unroll
      for (int a = A0; a < A1; ++a)
        if (a == 0 || !ring) nf_cp16(dst + 4u * a * R::PLANE, P.a[a] + g, in);
    }
  } else {
    for (int k = threadIdx.x; k < R::PLANE; k += R::THREADS) {
      const int r = k / R::W, q = k % R::W;
      const int gi = i0 + r, gj = j0 + q;
      const bool in = gi >= 0 && gi < nx && gj >= 0 && gj < ny;
      const int64_t g = in ? (int64_t)gi * ny + gj : 0;
      const unsigned dst = base + 4u * k;
      const bool ring = !(r >= 1 && r < R::RI - 1 && q >= R::QLO && q < R::QHI);
#pragma unroll
      for (int a = A0; a < A1; ++a)
        if (a == 0 || !ring) nf_cp4(dst + 4u * a * R::PLANE, P.a[a] + g, in);
    }
  }
}

// The owned cells of the region's p (the first plane of s) into out_p
// (float4 where P.vec).
template <class R, class Params>
__device__ __forceinline__ void nf_store_owned(const Params& P, const float* s, int ti0,
                                               int tj0) {
  constexpr int TI = R::TI, TJ = R::TJ;
  if (P.vec) {
    for (int k = threadIdx.x; k < TI * TJ / 4; k += R::THREADS) {
      const int r = k / (TJ / 4), q = 4 * (k % (TJ / 4));
      const int gi = ti0 + r, gj = tj0 + q;
      if (gi < P.nx && gj < P.ny)
        *reinterpret_cast<float4*>(P.out_p + (int64_t)gi * P.ny + gj) =
            *reinterpret_cast<const float4*>(s + (R::H + r) * R::W + R::M + q);
    }
  } else {
    for (int k = threadIdx.x; k < TI * TJ; k += R::THREADS) {
      const int gi = ti0 + k / TJ, gj = tj0 + k % TJ;
      if (gi < P.nx && gj < P.ny)
        P.out_p[(int64_t)gi * P.ny + gj] = s[(R::H + k / TJ) * R::W + R::M + k % TJ];
    }
  }
}

// The diagonal guard shared by the multigrid smoothers
// (ops/stencil9.stencil9_diagonal): |c| < 1e-15 counts as 1.
__device__ __forceinline__ float nf_inv_diag(float c) {
  return 1.f / (fabsf(c) < 1e-15f ? 1.f : c);
}

// The cell-centred bilinear mix of a fine cell's coarse cell (I, J) and its
// clamped neighbours Ia (axis 0) and Ja (axis 1): axis 0 first, then axis
// 1, as ops/transfer_cc.prolong_cc.
__device__ __forceinline__ float nf_prolong_mix(float e_IJ, float e_IaJ, float e_IJa,
                                                float e_IaJa) {
  const float t0 = 0.75f * e_IJ + 0.25f * e_IaJ;
  const float t1 = 0.75f * e_IJa + 0.25f * e_IaJa;
  return 0.75f * t0 + 0.25f * t1;
}

// Cell-centred bilinear prolongation of coarse field ec (nci x ncj) at fine
// cell (i, j).
__device__ __forceinline__ float nf_prolong_cc(const float* __restrict__ ec,
                                               int nci, int ncj, int i, int j) {
  const int I = i >> 1, J = j >> 1;
  const int Ia = (i & 1) ? min(I + 1, nci - 1) : max(I - 1, 0);
  const int Ja = (j & 1) ? min(J + 1, ncj - 1) : max(J - 1, 0);
  return nf_prolong_mix(ec[(int64_t)I * ncj + J], ec[(int64_t)Ia * ncj + J],
                        ec[(int64_t)I * ncj + Ja], ec[(int64_t)Ia * ncj + Ja]);
}

// Knuth TwoSum: s + e == a + b exactly (needs -fmad=false, NVCC_FLAGS).
__device__ __forceinline__ void nf_two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// Dekker TwoProduct: p + e == a * b exactly, with the 4097 split of
// ops/compensated._split (no contraction: -fmad=false).
__device__ __forceinline__ void nf_two_prod(float a, float b, float& p, float& e) {
  p = a * b;
  float c = 4097.f * a;
  const float ah = c - (c - a), al = a - ah;
  c = 4097.f * b;
  const float bh = c - (c - b), bl = b - bh;
  e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
}

// A double-single running sum (hi word s, error channel e).
struct NfDS {
  float s, e;
};

__device__ __forceinline__ NfDS nf_ds_zero() { return NfDS{0.f, 0.f}; }

__device__ __forceinline__ NfDS nf_ds_add(NfDS a, NfDS b) {
  float s, c;
  nf_two_sum(a.s, b.s, s, c);
  return NfDS{s, (a.e + b.e) + c};
}

// acc += a * b, the product split exactly (Ogita-Rump-Oishi Dot2)
__device__ __forceinline__ void nf_ds_fma(NfDS& acc, float a, float b) {
  float p, pe, s, c;
  nf_two_prod(a, b, p, pe);
  nf_two_sum(acc.s, p, s, c);
  acc.s = s;
  acc.e = acc.e + (pe + c);
}

// acc += a (exactly, error into the channel)
__device__ __forceinline__ void nf_ds_addf(NfDS& acc, float a) {
  float s, c;
  nf_two_sum(acc.s, a, s, c);
  acc.s = s;
  acc.e = acc.e + c;
}

// The correctly rounded hi word of the pair.
__device__ __forceinline__ float nf_ds_value(NfDS a) {
  float s, c;
  nf_two_sum(a.s, a.e, s, c);
  return s;
}
