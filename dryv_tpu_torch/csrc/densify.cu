// Kernel B1: bitmap + packed int8 values -> dense int16 coefficient rows.
//
// Replaces the Pallas kernel make_densify (dryv_tpu/kernels/densify.py).
// One warp per MB row of 408 coefficients: each lane tests one bit of a
// 32-bit chunk, __ballot_sync gathers the chunk's bits and __popc of the
// bits at or below the lane gives its inclusive rank.  Coefficient c
// takes vals[rank - 1] when its bit is set and rank <= W, else 0.
// Bound by device memory: 51 + W bytes read and 816 written per row.
#include "common.cuh"

namespace {

constexpr int kL = 408;   // coefficients per MB row
constexpr int kNB = 51;   // bitmap bytes per MB row
constexpr int kWarps = 4; // rows per block

__global__ void densify_kernel(const uint8_t* __restrict__ bmp,
                               const int8_t* __restrict__ vals,
                               int16_t* __restrict__ out, int rows, int W) {
  int lane = threadIdx.x & 31;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const uint8_t* b = bmp + (size_t)row * kNB;
  const int8_t* v = vals + (size_t)row * W;
  int16_t* o = out + (size_t)row * kL;
  unsigned le_mask = (2u << lane) - 1u;  // lanes 0..lane
  int base = 0;
  for (int c0 = 0; c0 < kL; c0 += 32) {
    int c = c0 + lane;
    int bit = c < kL ? (b[c >> 3] >> (c & 7)) & 1 : 0;
    unsigned ballot = __ballot_sync(0xffffffffu, bit);
    int rank = base + __popc(ballot & le_mask);
    if (c < kL) o[c] = (bit && rank <= W) ? (int16_t)v[rank - 1] : 0;
    base += __popc(ballot);
  }
}

}  // namespace

DT_EXPORT int dt_densify(const void* bmp, const void* vals, void* out,
                         int rows, int W, void* stream) {
  int blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0)
    densify_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)bmp, (const int8_t*)vals, (int16_t*)out, rows, W);
  return (int)cudaGetLastError();
}

DT_EXPORT const char* dt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
