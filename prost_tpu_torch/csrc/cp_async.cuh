// The asynchronous copies into shared memory of the tiled chunks' windows
// (csrc/fused_admm.cu admm_tiled, csrc/fused_deblur.cu deblur_tiled,
// csrc/fused_multilabel.cu ml_tiled, csrc/fused_tight.cu tight_tiled,
// csrc/fused_vol.cu vol_tiled).

#pragma once

#include <cuda_runtime.h>

namespace {

// A 4-byte copy from device to shared memory that does not wait
// (cp.async, sm_80 and later), and the wait for all of a thread's copies;
// a plain copy where the source is compiled for the host.
__device__ __forceinline__ void cp_async4(float* s, const float* g) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
#else
  *s = *g;
#endif
}

__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

}  // namespace
