// Shared helpers of the hand-written kernels (plain C interface, loaded
// with ctypes by dryv_tpu_torch/_build.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define DT_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}
