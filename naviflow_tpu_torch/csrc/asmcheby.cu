// K1's entry points (the kernel and its launch: asmcheby.cuh).

#include "asmcheby.cuh"

// ptrs, ip, fp: launch_asmcheby's (asmcheby.cuh)
NF_EXPORT int nf_asmcheby_pair(const long long* ptrs, const int* ip, const float* fp,
                               void* stream) {
  return launch_asmcheby<false>(ptrs, ip, fp, stream);
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
