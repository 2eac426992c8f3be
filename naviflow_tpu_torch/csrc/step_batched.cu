// K6 over a batch of cases, one cluster a case, in one launch (the kernel
// and its launch: step.cuh): the lockstep loop of algorithms/batch.py.  A
// source of its own, so that nvcc builds its four instantiations beside
// step.cu's and step_phases.cu's.

#include "step.cuh"

// B cases of one configuration; ptrs, ip and fp as launch_step (step.cuh)
// reads them batched: case 0's slots and the frozen cases' held results,
// the active flags and each case's (De, Dn), then every slot's case stride;
// ip ends with B.
NF_EXPORT int nf_fused_outer_step_batched(const long long* ptrs, const int* ip, const float* fp,
                                          void* stream) {
  return launch_step<false, true>(ptrs, ip, fp, stream);
}

// How many clusters of `size` CTAs of K6's batched `algo` body the current
// device holds at once, into *count: a batch of more cases runs in waves.
NF_EXPORT int nf_step_max_clusters(int algo, int size, int* count) {
  switch (algo) {
    case SIMPLE: return nf_max_active_clusters(step_kernel_batched<SIMPLE>, size, *count);
    case SIMPLEC: return nf_max_active_clusters(step_kernel_batched<SIMPLEC>, size, *count);
    case PISO: return nf_max_active_clusters(step_kernel_batched<PISO>, size, *count);
    case SIMPLER: return nf_max_active_clusters(step_kernel_batched<SIMPLER>, size, *count);
    default: return (int)cudaErrorInvalidValue;
  }
}
