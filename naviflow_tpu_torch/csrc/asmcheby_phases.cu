// K1 with the phase timers (the kernel and its launch: asmcheby.cuh): a
// measurement aid, chip_smoke.py's phase split; no solve path calls it.

#include "asmcheby.cuh"

// The same launch with the phase timers: ptrs as nf_asmcheby_pair's, then
// the timer buffer (asmcheby.cuh K1Phase).
NF_EXPORT int nf_asmcheby_pair_phases(const long long* ptrs, const int* ip, const float* fp,
                                      void* stream) {
  return launch_asmcheby<true>(ptrs, ip, fp, stream);
}
