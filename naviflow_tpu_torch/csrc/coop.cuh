// Cooperative-launch helpers of K7's large-field kernels (krylov.cu: one
// field, and B fields in one launch) and of the grid-barrier probe (mg.cu),
// and the reduction slot count and NaN-keeping maximum that cluster.cuh's
// reductions share.
//
// A kernel of this family runs as one cooperative launch of as many blocks
// as fit on the SMs at once.  Its work is a sequence of grid-strided passes,
// each ending in a grid-wide barrier (cooperative_groups grid.sync()).  The
// grid-sync probe (mg.cu) times one such barrier.
//
// Grid-uniform control flow: a data-dependent loop (BiCGSTAB's stopping
// rule) must take the same branch in every block, or blocks leave the loop
// while others wait at a barrier.  So every scalar that steers it comes
// from nf_grid_reduce: each block writes its partial sums, one barrier,
// then every block combines all partials in the same fixed order with the
// same instructions, and so holds bit-identical scalars.  The partials live
// in a ping-pong pair of buffers: a block may write the next reduction's
// partials while a slower block still reads the last one's, never the same
// buffer.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int NF_THREADS = 256;
constexpr int NF_SMALL_CELLS = 1024;
constexpr int NF_MAX_BLOCKS = 1024;
constexpr int NF_RED_SLOTS = 8;  // floats per block and reduction: 4 double-single sums

struct NfCoop {
  cg::grid_group grid;
  int64_t gtid, gstride;
  float* red;  // 2 x NF_RED_SLOTS x NF_MAX_BLOCKS floats (the wrapper's scratch)
  int phase;   // which half of `red` the next reduction writes
};

__device__ __forceinline__ NfCoop nf_coop(float* red) {
  NfCoop C{cg::this_grid(), 0, 0, red, 0};
  C.gtid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  C.gstride = (int64_t)gridDim.x * blockDim.x;
  return C;
}

// One block's part of a grid sum of N double-single partials (one set per
// thread): warp shuffles, then thread 0 adds the warps' sums in order and
// writes them to this block's NF_RED_SLOTS slots of `buf`.  Every thread of
// the block must call it; `warp_part` is free again after the next block
// barrier.
template <int N>
__device__ __forceinline__ void nf_block_sum(NfDS (&v)[N], float* buf) {
  __shared__ NfDS warp_part[N][NF_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    NfDS a = v[k];
    for (int off = 16; off > 0; off >>= 1) {
      NfDS b{__shfl_down_sync(0xffffffffu, a.s, off), __shfl_down_sync(0xffffffffu, a.e, off)};
      a = nf_ds_add(a, b);
    }
    if (lane == 0) warp_part[k][warp] = a;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      NfDS a = warp_part[k][0];
      for (int w = 1; w < n_warps; ++w) a = nf_ds_add(a, warp_part[k][w]);
      buf[(size_t)blockIdx.x * NF_RED_SLOTS + 2 * k] = a.s;
      buf[(size_t)blockIdx.x * NF_RED_SLOTS + 2 * k + 1] = a.e;
    }
  }
}

// The grid's N sums from the `blocks` blocks' slots of `buf`, added by one
// whole warp in a fixed order (lanes stride the blocks, then a shuffle
// tree); lane 0 returns them.
template <int N>
__device__ __forceinline__ void nf_warp_sum(const float* buf, int blocks, float (&out)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    NfDS a = nf_ds_zero();
    for (int b = lane; b < blocks; b += 32)
      a = nf_ds_add(a, NfDS{buf[(size_t)b * NF_RED_SLOTS + 2 * k],
                            buf[(size_t)b * NF_RED_SLOTS + 2 * k + 1]});
    for (int off = 16; off > 0; off >>= 1) {
      NfDS b{__shfl_down_sync(0xffffffffu, a.s, off), __shfl_down_sync(0xffffffffu, a.e, off)};
      a = nf_ds_add(a, b);
    }
    out[k] = nf_ds_value(a);
  }
}

// Sum N double-single partials (one set per thread) over the whole grid;
// every thread of every block returns the same N floats.  Every thread of
// the grid must call it.  Ends with the grid in step.
template <int N>
__device__ void nf_grid_reduce(NfCoop& C, NfDS (&v)[N], float (&out)[N]) {
  __shared__ float result[N];
  float* buf = C.red + (size_t)C.phase * NF_RED_SLOTS * NF_MAX_BLOCKS;
  nf_block_sum<N>(v, buf);
  C.grid.sync();
  if ((threadIdx.x >> 5) == 0) {
    float sum[N];
    nf_warp_sum<N>(buf, (int)gridDim.x, sum);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) result[k] = sum[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = result[k];
  __syncthreads();  // `result` and `warp_part` are reused by the next call
  C.phase ^= 1;
}

// max(a, b) that keeps a NaN of either side (jnp.max propagates NaN).
__device__ __forceinline__ float nf_max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// The context-generic names of the barrier and the sum (krylov.cuh's solve
// is written over them; cluster.cuh gives the cluster's).
__device__ __forceinline__ void nf_sync(NfCoop& C) { C.grid.sync(); }

template <int N>
__device__ __forceinline__ void nf_reduce(NfCoop& C, NfDS (&v)[N], float (&out)[N]) {
  nf_grid_reduce<N>(C, v, out);
}

// The block count of a cooperative launch of `kernel` over `cells`: as
// many blocks as `cells` needs at NF_THREADS a block, and no more than fit
// on the SMs at once (with `smem` bytes of dynamic shared memory a block;
// at most `per_sm_cap` an SM where it is not 0) or than NF_MAX_BLOCKS.
template <class Kernel>
inline int nf_coop_blocks(Kernel kernel, int64_t cells, int& blocks, size_t smem = 0,
                          int per_sm_cap = 0) {
  int device = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NF_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (per_sm_cap > 0 && per_sm > per_sm_cap) per_sm = per_sm_cap;
  int64_t want = (cells + NF_THREADS - 1) / NF_THREADS;
  if (want > (int64_t)per_sm * n_sm) want = (int64_t)per_sm * n_sm;
  if (want > NF_MAX_BLOCKS) want = NF_MAX_BLOCKS;
  if (want < 1) want = 1;
  blocks = (int)want;
  return 0;
}

// Launch `kernel(params)` cooperatively over nf_coop_blocks(kernel, cells).
template <class Kernel, class Params>
inline int nf_coop_launch(Kernel kernel, Params& params, int64_t cells, cudaStream_t stream) {
  int blocks = 0;
  const int e = nf_coop_blocks(kernel, cells, blocks);
  if (e) return e;
  void* args[] = {&params};
  cudaError_t err = cudaLaunchCooperativeKernel((void*)kernel, dim3((unsigned)blocks),
                                                dim3(NF_THREADS), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
