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

// The diagonal guard shared by the multigrid smoothers
// (ops/stencil9.stencil9_diagonal): |c| < 1e-15 counts as 1.
__device__ __forceinline__ float nf_inv_diag(float c) {
  return 1.f / (fabsf(c) < 1e-15f ? 1.f : c);
}

// Cell-centred bilinear prolongation of coarse field ec (nci x ncj) at fine
// cell (i, j): axis 0 first, then axis 1, as ops/transfer_cc.prolong_cc.
__device__ __forceinline__ float nf_prolong_cc(const float* __restrict__ ec,
                                               int nci, int ncj, int i, int j) {
  const int I = i >> 1, J = j >> 1;
  const int Ia = (i & 1) ? min(I + 1, nci - 1) : max(I - 1, 0);
  const int Ja = (j & 1) ? min(J + 1, ncj - 1) : max(J - 1, 0);
  const float t0 = 0.75f * ec[(int64_t)I * ncj + J] + 0.25f * ec[(int64_t)Ia * ncj + J];
  const float t1 = 0.75f * ec[(int64_t)I * ncj + Ja] + 0.25f * ec[(int64_t)Ia * ncj + Ja];
  return 0.75f * t0 + 0.25f * t1;
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
