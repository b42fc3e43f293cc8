// Shared helpers of the hand-written kernels (plain C interface, loaded
// with ctypes by dryv_tpu_torch/_build.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define DT_EXPORT extern "C" __attribute__((visibility("default")))

// MBs (x, y) with x + 2y == d form anti-diagonal d; they are independent
// for intra prediction and for the deblocking filter, and every
// dependency of theirs lies on an earlier diagonal.
struct DiagRange {
  int y0;  // first MB row on the diagonal
  int n;   // number of MBs on it
};

static inline DiagRange diag_range(int d, int mb_w, int mb_h) {
  int lo = d - mb_w + 1;
  int y0 = lo > 0 ? (lo + 1) / 2 : 0;
  int y1 = d / 2 < mb_h - 1 ? d / 2 : mb_h - 1;
  return {y0, y1 - y0 + 1};
}

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}
