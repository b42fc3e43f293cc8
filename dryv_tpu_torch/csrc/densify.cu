// Kernel B1: bitmap + packed int8 values -> dense int16 coefficient rows.
//
// Replaces the Pallas kernel make_densify (dryv_tpu/kernels/densify.py).
// Coefficient c of a row takes vals[rank - 1] when its bit is set and
// rank <= W, else 0 (rank: the inclusive count of set bits up to c).
//
// Bound by device memory: 51 + W bytes read and 816 written per row, no
// arithmetic to speak of.  So every access is 16 bytes wide and
// coalesced.  A block takes a tile of 16 rows: its 816 bitmap bytes and
// 16 * W value bytes come into shared memory as 16-byte loads, and one
// bitmap byte is exactly 8 coefficients, i.e. one 16-byte output group;
// bitmap byte i of the tile gives output group i, so a warp's stores
// cover 512 contiguous bytes.  A byte's rank base is the popcount of the
// bytes before it in its row: a half-warp per row sums 4 bytes per lane
// and scans them with __shfl_up_sync.
//
// Needs (checked by the wrapper): rows a multiple of 16, W a multiple of
// 16, every pointer on a 16-byte boundary.
#include "common.cuh"

namespace {

constexpr int kL = 408;       // coefficients per MB row
constexpr int kNB = 51;       // bitmap bytes per MB row
constexpr int kRows = 16;     // rows per tile
constexpr int kItems = kRows * kNB;  // 816 bitmap bytes = output groups
constexpr int kThreads = 256;        // 16 half-warps: one per row

__global__ void __launch_bounds__(kThreads)
densify_kernel(const uint8_t* __restrict__ bmp,
               const int8_t* __restrict__ vals, int16_t* __restrict__ out,
               int W) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const s_bmp = smem;                              // [16][51]
  uint16_t* const s_base = (uint16_t*)(smem + kItems);      // [16][51]
  int8_t* const s_val = (int8_t*)(smem + 3 * kItems);       // [16][W]
  const int t = threadIdx.x;
  const size_t tile = blockIdx.x;
  const uint4* gb = (const uint4*)(bmp + tile * kItems);
  const uint4* gv = (const uint4*)(vals + tile * kRows * W);
  for (int i = t; i < kItems / 16 + W; i += kThreads) {
    if (i < kItems / 16)
      ((uint4*)s_bmp)[i] = __ldcs(gb + i);
    else
      ((uint4*)s_val)[i - kItems / 16] = __ldcs(gv + i - kItems / 16);
  }
  __syncthreads();
  {  // rank base of every bitmap byte: half-warp = row, lane h = 4 bytes
    const int row = t >> 4, h = t & 15;
    const uint8_t* b = s_bmp + row * kNB;
    int c[4], sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * h + k;
      c[k] = j < kNB ? __popc(b[j]) : 0;
      sum += c[k];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d, 16);
      if (h >= d) incl += u;
    }
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * h + k;
      if (j < kNB) s_base[row * kNB + j] = (uint16_t)run;
      run += c[k];
    }
  }
  __syncthreads();
  uint4* go = (uint4*)(out + tile * kRows * kL);
  for (int i = t; i < kItems; i += kThreads) {
    const int8_t* v = s_val + (i / kNB) * W;
    const int byte = s_bmp[i];
    int rank = s_base[i];
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      int lo = 0, hi = 0;
      if ((byte >> k) & 1) {
        ++rank;
        if (rank <= W) lo = v[rank - 1];
      }
      if ((byte >> (k + 1)) & 1) {
        ++rank;
        if (rank <= W) hi = v[rank - 1];
      }
      w[k >> 1] = (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
    }
    __stcs(go + i, make_uint4(w[0], w[1], w[2], w[3]));
  }
}

}  // namespace

DT_EXPORT int dt_densify(const void* bmp, const void* vals, void* out,
                         int rows, int W, void* stream) {
  const int tiles = rows / kRows;
  const size_t smem = 3 * kItems + (size_t)kRows * W;
  if (tiles > 0)
    densify_kernel<<<tiles, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)bmp, (const int8_t*)vals, (int16_t*)out, W);
  return (int)cudaGetLastError();
}

DT_EXPORT const char* dt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
