// K1's entry points (the kernel and its launch: asmcheby.cuh), and the
// launch of its case axis (asmcheby.cuh's asmcheby_kernel_batched).

#include "asmcheby.cuh"

namespace {

using BatchKernel = void (*)(K1Batch);

template <int DEG>
BatchKernel batch_kernel_of(int degree) {
  if constexpr (DEG > 15) {
    return nullptr;
  } else {
    return degree == DEG ? asmcheby_kernel_batched<DEG> : batch_kernel_of<DEG + 1>(degree);
  }
}

// Per device ordinal and degree: the blocks a batched launch runs.
int g_batch_blocks[16][16];

// B cases of one shape in one launch (the case axis).
// ptrs: launch_asmcheby's 21 slots for case 0 (no timers), the cases'
//       conductances (B, 4: De, Dn, 1 / De, 1 / Dn), the active flags
//       (bool), then each of these 23 slots' case stride in bytes, in the
//       same order (0: one array shared by every case)
// ip:   launch_asmcheby's, then B
// fp:   launch_asmcheby's (De and Dn unused: each case's own)
int launch_asmcheby_batched(const long long* ptrs, const int* ip, const float* fp,
                            void* stream) {
  constexpr int N = 21, HALF = N + 2;
  K1Batch SB = {};
  int err = launch_asmcheby<false>(ptrs, ip, fp, stream, &SB.P);
  if (!err) err = launch_asmcheby<false>(ptrs + HALF, ip, fp, stream, &SB.S);
  if (err) return err;
  SB.visc = reinterpret_cast<const float*>(ptrs[N]);
  SB.visc_stride = reinterpret_cast<const float*>(ptrs[HALF + N]);
  SB.active = reinterpret_cast<const bool*>(ptrs[N + 1]);
  SB.active_stride = reinterpret_cast<const bool*>(ptrs[HALF + N + 1]);
  SB.cases = ip[4];
  // the cases' outputs must not overlap: the maxima's stride is at least their pair
  const size_t pitch = (size_t)reinterpret_cast<intptr_t>(SB.S.gmax);
  if (!SB.visc || !SB.active || SB.cases < 1 || pitch < 2 * sizeof(float))
    return (int)cudaErrorInvalidValue;
  const int degree = ip[2];
  const BatchKernel k = batch_kernel_of<1>(degree);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device < 0 || device >= 16) return (int)cudaErrorInvalidDevice;
  int& blocks = g_batch_blocks[device][degree];
  if (blocks == 0) {
    const int smem = (int)sizeof(float) * SMEM_FLOATS;
    int n_sm = 0, per = 0;
    e = cudaFuncSetAttribute((const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per < 1) return (int)cudaErrorLaunchOutOfResources;
    blocks = per * n_sm;
  }
  cudaStream_t s = (cudaStream_t)stream;
  // +0.0 in every case's maxima (atomicMax's start): one memset over the B pairs
  e = cudaMemset2DAsync(SB.P.gmax, pitch, 0, 2 * sizeof(float), SB.cases, s);
  if (e != cudaSuccess) return (int)e;
  const int items = SB.cases * SB.P.tiles;
  k<<<items < blocks ? items : blocks, THREADS, sizeof(float) * SMEM_FLOATS, s>>>(SB);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs, ip, fp: launch_asmcheby's (asmcheby.cuh)
NF_EXPORT int nf_asmcheby_pair(const long long* ptrs, const int* ip, const float* fp,
                               void* stream) {
  return launch_asmcheby<false>(ptrs, ip, fp, stream);
}

// ptrs, ip, fp: launch_asmcheby_batched's (asmcheby.cuh): B cases in one
// launch
NF_EXPORT int nf_asmcheby_pair_batched(const long long* ptrs, const int* ip, const float* fp,
                                       void* stream) {
  return launch_asmcheby_batched(ptrs, ip, fp, stream);
}

// The resident blocks an SM of `degree`'s instance on the current device
// (a measurement aid: chip_smoke.py's build line).
NF_EXPORT int nf_asmcheby_blocks_per_sm(int degree, int* out) {
  int blocks = 0;
  return (int)setup<false>(degree, out, &blocks);
}

NF_EXPORT const char* nf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
