// K6 with the phase timers (the kernel and its launch: step.cuh): a
// measurement aid, chip_smoke.py's phase split; no solve path calls it.

#include "step.cuh"

// The same step with the phase timers (a measurement aid: chip_smoke.py's
// phase split); ptrs as nf_fused_outer_step's, then the timer buffer.
NF_EXPORT int nf_fused_outer_step_phases(const long long* ptrs, const int* ip, const float* fp,
                                         void* stream) {
  return launch_step<true>(ptrs, ip, fp, stream);
}
