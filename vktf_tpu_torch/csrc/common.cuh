// Shared helpers of the port's CUDA kernels.
//
// Every kernel is built with --fmad=false, so `a * b + c` is two rounded
// operations, as in PyTorch's elementwise ops. A fused multiply-add appears
// only where the plain PyTorch version calls ops/fmath.fma (the places where
// the JAX reference's XLA build contracts), written here as fma_rn.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define VKTF_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// torch.minimum / torch.maximum: NaN propagates (fminf/fmaxf would drop it).
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
// torch.clamp(v, lo, hi) == minimum(maximum(v, lo), hi)
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return tmin(tmax(v, lo), hi);
}

// The launch's own error (too many threads, too much shared memory) is
// returned to the Python wrapper, which raises on anything but 0.
static inline int launch_status() { return (int)cudaGetLastError(); }
