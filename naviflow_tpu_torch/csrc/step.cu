// K6's entry points (the kernel and its launch: step.cuh).

#include "step.cuh"

namespace {

// `n` cluster barriers and nothing else: the unit of K6's bound.
__global__ void __launch_bounds__(NF_CL_THREADS, 1) cluster_sync_probe_kernel(int n) {
  cg::cluster_group cl = cg::this_cluster();
  for (int i = 0; i < n; ++i) cl.sync();
}

// Nothing: the floor of one launch's device time.
__global__ void launch_floor_probe_kernel() {}

}  // namespace

NF_EXPORT int nf_fused_outer_step(const long long* ptrs, const int* ip, const float* fp,
                                  void* stream) {
  return launch_step<false>(ptrs, ip, fp, stream);
}

// The cluster size K6's `algo` body launches with on the current device
// (chosen at the first launch or here), into *size.
NF_EXPORT int nf_step_cluster_size(int algo, int* size) {
  switch (algo) {
    case SIMPLE:
      return nf_cluster_size(step_kernel<SIMPLE, false>, step_cfg<SIMPLE, false>(), *size);
    case SIMPLEC:
      return nf_cluster_size(step_kernel<SIMPLEC, false>, step_cfg<SIMPLEC, false>(), *size);
    case PISO: return nf_cluster_size(step_kernel<PISO, false>, step_cfg<PISO, false>(), *size);
    case SIMPLER:
      return nf_cluster_size(step_kernel<SIMPLER, false>, step_cfg<SIMPLER, false>(), *size);
    default: return (int)cudaErrorInvalidValue;
  }
}

// A measurement aid, not a kernel of the solver: `syncs` cluster barriers in
// one cluster of `size` CTAs of K6's width.  ip: size, syncs
NF_EXPORT int nf_cluster_sync_probe(const long long* ptrs, const int* ip, const float* fp,
                                    void* stream) {
  (void)ptrs;
  (void)fp;
  cudaError_t err = cudaFuncSetAttribute((const void*)cluster_sync_probe_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  const int syncs = ip[1];
  return nf_cluster_launch(cluster_sync_probe_kernel, ip[0], syncs, 0, (cudaStream_t)stream);
}

// A measurement aid, not a kernel of the solver: one launch of the empty
// kernel over `blocks` blocks of `threads` threads.
NF_EXPORT int nf_launch_floor_probe(int blocks, int threads, void* stream) {
  launch_floor_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
