// Cooperative-launch helpers shared by the whole-algorithm kernels (K3-K7).
//
// A kernel of this family runs as one cooperative launch of as many blocks
// as fit on the SMs at once.  Its work is a sequence of passes; a pass over
// more than NF_SMALL_CELLS cells loops over them with a grid stride and ends
// in a grid-wide barrier (cooperative_groups grid.sync()), a pass over a
// smaller level runs in block 0 alone between __syncthreads() and the other
// blocks go on to the next barrier (`pending` records that one is owed).
//
// Grid-uniform control flow: the data-dependent loops (BiCGSTAB's stopping
// rule, the multigrid check loop) must take the same branch in every block,
// or blocks leave a loop while others wait at a barrier.  So every scalar
// that steers a loop comes from nf_grid_reduce: each block writes its
// partial sums, one barrier, then every block combines all partials in the
// same fixed order with the same instructions, and so holds bit-identical
// scalars.  The partials live in a ping-pong pair of buffers: a block may
// write the next reduction's partials while a slower block still reads the
// last one's, never the same buffer.
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
  bool pending;  // block 0 wrote without a grid barrier since
  float* red;    // 2 x NF_RED_SLOTS x NF_MAX_BLOCKS floats (the wrapper's scratch)
  int phase;     // which half of `red` the next reduction writes
};

__device__ __forceinline__ NfCoop nf_coop(float* red) {
  NfCoop C{cg::this_grid(), 0, 0, false, red, 0};
  C.gtid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  C.gstride = (int64_t)gridDim.x * blockDim.x;
  return C;
}

// The barrier owed to block 0's last small pass, before a grid-wide one.
__device__ __forceinline__ void nf_settle(NfCoop& C) {
  if (C.pending) {
    C.grid.sync();
    C.pending = false;
  }
}

// One pass over `cells` cells (uniform over the grid): block 0 alone for
// small levels, the whole grid otherwise.  CALL sees `start` and `stride`.
#define NF_PASS(C, cells, CALL)                    \
  do {                                             \
    if ((cells) <= NF_SMALL_CELLS) {               \
      if (blockIdx.x == 0) {                       \
        const int64_t start = threadIdx.x;         \
        const int64_t stride = blockDim.x;         \
        CALL;                                      \
        __syncthreads();                           \
      }                                            \
      (C).pending = true;                          \
    } else {                                       \
      nf_settle(C);                                \
      const int64_t start = (C).gtid;              \
      const int64_t stride = (C).gstride;          \
      CALL;                                        \
      (C).grid.sync();                             \
    }                                              \
  } while (0)

// Sum N double-single partials (one set per thread) over the whole grid;
// every thread of every block returns the same N floats.  Every thread of
// the grid must call it, after nf_settle.  Ends with the grid in step.
template <int N>
__device__ void nf_grid_reduce(NfCoop& C, NfDS (&v)[N], float (&out)[N]) {
  __shared__ NfDS warp_part[N][NF_THREADS / 32];
  __shared__ float result[N];
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
  float* buf = C.red + (size_t)C.phase * NF_RED_SLOTS * NF_MAX_BLOCKS;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      NfDS a = warp_part[k][0];
      for (int w = 1; w < n_warps; ++w) a = nf_ds_add(a, warp_part[k][w]);
      buf[(size_t)blockIdx.x * NF_RED_SLOTS + 2 * k] = a.s;
      buf[(size_t)blockIdx.x * NF_RED_SLOTS + 2 * k + 1] = a.e;
    }
  }
  C.grid.sync();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      NfDS a = nf_ds_zero();
      for (int b = lane; b < (int)gridDim.x; b += 32)
        a = nf_ds_add(a, NfDS{buf[(size_t)b * NF_RED_SLOTS + 2 * k],
                              buf[(size_t)b * NF_RED_SLOTS + 2 * k + 1]});
      for (int off = 16; off > 0; off >>= 1) {
        NfDS b{__shfl_down_sync(0xffffffffu, a.s, off), __shfl_down_sync(0xffffffffu, a.e, off)};
        a = nf_ds_add(a, b);
      }
      if (lane == 0) result[k] = nf_ds_value(a);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = result[k];
  __syncthreads();  // `result` and `warp_part` are reused by the next call
  C.phase ^= 1;
  C.pending = false;
}

// Launch `kernel(params)` cooperatively: as many blocks as `cells` needs at
// NF_THREADS a block, and no more than fit on the SMs at once.
template <class Kernel, class Params>
inline int nf_coop_launch(Kernel kernel, Params& params, int64_t cells, cudaStream_t stream) {
  int device = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NF_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int64_t blocks = (cells + NF_THREADS - 1) / NF_THREADS;
  if (blocks > (int64_t)per_sm * n_sm) blocks = (int64_t)per_sm * n_sm;
  if (blocks > NF_MAX_BLOCKS) blocks = NF_MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  void* args[] = {&params};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3((unsigned)blocks), dim3(NF_THREADS), args,
                                    0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
