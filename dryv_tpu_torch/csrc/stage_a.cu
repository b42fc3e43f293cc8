// Kernel B5: stage A -- inverse quantisation and the inverse transforms
// (spec 8.5) of each MB by its own kind, written straight into the int16
// residual rows that kernel B2 reads, clamped to +-255.
//
// It has no Pallas original: every jitted step of the JAX package leaves
// stage A to XLA, which fuses dryv_tpu/kernels/transform.py
// luma_residual_zrows (:398) and chroma_residual_tiles (:461), reached
// through dryv_tpu/kernels/pallas_wavefront.py stage_a_residuals (:641).
// Its plain version is kernels/transform.py stage_a_plain, which
// computes every MB both ways (4x4 and 8x8) and picks one.
//
// Bound by device memory: an MB reads 816 bytes of levels and 16 of kind
// and QPs and writes 768 bytes of residuals, against a few hundred int32
// adds and shifts.  A warp takes one MB, so that the warp's loads and
// stores are whole 16-byte words of one MB's contiguous rows:
//   - I4/I16 (and PCM, and any other kind): lane zb < 16 transforms the
//     z-scan 4x4 block zb from registers (its 16 levels are two 16-byte
//     words); an I16 MB's scaled DC comes from the Hadamard of its 16 DC
//     levels, which each lane computes in full;
//   - I8: 8 lanes a quadrant, a lane a row of it: rows through the 8-point
//     butterfly, a transpose through shared memory, the columns, a second
//     transpose, and each lane stores its row as one 16-byte word;
//   - chroma: lanes 0-7 take (plane, 4x4 block), the 2x2 DC Hadamard
//     computed by each.
// Arithmetic is int32 with arithmetic right shifts, rows before columns,
// as 8.5.12.2 / 8.5.13 fix the order of the interior floor shifts.
//
// The LevelScale rows are read from device memory on every launch: the
// per-picture step takes them as inputs (as the jitted _build does).
// Needs (checked by the wrapper): kind/QP arrays int32 [F, n] contiguous;
// the level segments int16 with rows on 16-byte boundaries; outputs
// contiguous.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ int lo16(uint32_t w) {
  return (int16_t)(w & 0xffffu);
}
__device__ __forceinline__ int hi16(uint32_t w) { return (int16_t)(w >> 16); }

__device__ __forceinline__ void unpack8(uint4 v, int* c) {
  c[0] = lo16(v.x); c[1] = hi16(v.x); c[2] = lo16(v.y); c[3] = hi16(v.y);
  c[4] = lo16(v.z); c[5] = hi16(v.z); c[6] = lo16(v.w); c[7] = hi16(v.w);
}

__device__ __forceinline__ uint32_t pack2(int a, int b) {
  return (uint32_t)(uint16_t)a | ((uint32_t)(uint16_t)b << 16);
}

// prod << (shift - base) when shift >= base, else the rounded right shift
// by base - shift (transform.py _scale)
__device__ __forceinline__ int scale(int prod, int shift, int base) {
  return shift >= base ? prod << (shift - base)
                       : (prod + (1 << (base - 1 - shift))) >> (base - shift);
}

__device__ __forceinline__ void butterfly4(int d0, int d1, int d2, int d3,
                                           int* o) {
  const int e0 = d0 + d2, e1 = d0 - d2;
  const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  o[0] = e0 + e3; o[1] = e1 + e2; o[2] = e1 - e2; o[3] = e0 - e3;
}

// 8.5.12.2 on d[16] (raster 4y + x), in place: rows, columns, (h+32)>>6,
// clamped to +-255
__device__ __forceinline__ void idct4_clamped(int* d) {
  int t[4];
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    butterfly4(d[4 * y], d[4 * y + 1], d[4 * y + 2], d[4 * y + 3], t);
#pragma unroll
    for (int x = 0; x < 4; ++x) d[4 * y + x] = t[x];
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    butterfly4(d[x], d[4 + x], d[8 + x], d[12 + x], t);
#pragma unroll
    for (int y = 0; y < 4; ++y)
      d[4 * y + x] = clip3(-255, 255, (t[y] + 32) >> 6);
  }
}

__device__ __forceinline__ void butterfly8(const int* c, int* o) {
  const int e0 = c[0] + c[4];
  const int e1 = -c[3] + c[5] - c[7] - (c[7] >> 1);
  const int e2 = c[0] - c[4];
  const int e3 = c[1] + c[7] - c[3] - (c[3] >> 1);
  const int e4 = (c[2] >> 1) - c[6];
  const int e5 = -c[1] + c[7] + c[5] + (c[5] >> 1);
  const int e6 = c[2] + (c[6] >> 1);
  const int e7 = c[3] + c[5] + c[1] + (c[1] >> 1);
  const int f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4;
  const int f3 = e3 + (e5 >> 2), f4 = e2 - e4, f5 = (e3 >> 2) - e5;
  const int f6 = e0 - e6, f7 = e7 - (e1 >> 2);
  o[0] = f0 + f7; o[1] = f2 + f5; o[2] = f4 + f3; o[3] = f6 + f1;
  o[4] = f6 - f1; o[5] = f4 - f3; o[6] = f2 - f5; o[7] = f0 - f7;
}

// the 4x4 Hadamard of v[16] (raster 4y + x), rows then columns
__device__ __forceinline__ void hadamard4x4(int* v) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int* a = v + 4 * r;
    const int a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];
    a[0] = a0 + a1 + a2 + a3; a[1] = a0 + a1 - a2 - a3;
    a[2] = a0 - a1 - a2 + a3; a[3] = a0 - a1 + a2 - a3;
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int a0 = v[x], a1 = v[4 + x], a2 = v[8 + x], a3 = v[12 + x];
    v[x] = a0 + a1 + a2 + a3; v[4 + x] = a0 + a1 - a2 - a3;
    v[8 + x] = a0 - a1 - a2 + a3; v[12 + x] = a0 - a1 + a2 - a3;
  }
}

__global__ void __launch_bounds__(kThreads)
stage_a_kernel(const int* __restrict__ kind, const int* __restrict__ qpy,
               const int* __restrict__ qpcb, const int* __restrict__ qpcr,
               const int16_t* __restrict__ lv, const int16_t* __restrict__ ldc,
               const int16_t* __restrict__ cdc,
               const int16_t* __restrict__ cac,
               const int* __restrict__ ls4y, const int* __restrict__ ls4cb,
               const int* __restrict__ ls4cr, const int* __restrict__ ls8y,
               int16_t* __restrict__ yres, int16_t* __restrict__ cres, int F,
               int n, int lv_sf, int lv_sm, int ldc_sf, int ldc_sm,
               int cdc_sf, int cdc_sm, int cac_sf, int cac_sm) {
  // I8 transposes: the row pass's sums, then the clamped residuals
  // (a quadrant's 8 rows of 8 int16, one 16-byte word each)
  __shared__ int s_g[kWarps][4][8][9];
  __shared__ uint4 s_o[kWarps][4][8];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long m = (long long)blockIdx.x * kWarps + w;
  if (m >= (long long)F * n) return;  // uniform over the warp
  const long long f = m / n, i = m % n;
  const int k = kind[m], qp = qpy[m];
  const int q6 = qp / 6, qm = qp % 6;
  const int16_t* L = lv + f * lv_sf + i * lv_sm;
  int16_t* Y = yres + m * 256;

  if (k == 1) {  // I8: quadrant q, row r
    const int q = lane >> 3, r = lane & 7;
    int c[8], g[8];
    unpack8(*(const uint4*)(L + 64 * q + 8 * r), c);
    const int* ls = ls8y + 64 * qm + 8 * r;
#pragma unroll
    for (int x = 0; x < 8; ++x) c[x] = scale(c[x] * __ldg(ls + x), q6, 6);
    butterfly8(c, g);
#pragma unroll
    for (int x = 0; x < 8; ++x) s_g[w][q][r][x] = g[x];
    __syncwarp();
#pragma unroll
    for (int y = 0; y < 8; ++y) c[y] = s_g[w][q][y][r];  // column r
    butterfly8(c, g);
    int16_t* o = (int16_t*)s_o[w][q];
#pragma unroll
    for (int y = 0; y < 8; ++y)
      o[8 * y + r] = (int16_t)clip3(-255, 255, (g[y] + 32) >> 6);
    __syncwarp();
    *(uint4*)(Y + 64 * q + 8 * r) = s_o[w][q][r];
  } else if (lane < 16) {  // 4x4: z-scan block zb
    const int zb = lane;
    int d[16];
    unpack8(*(const uint4*)(L + 16 * zb), d);
    unpack8(*(const uint4*)(L + 16 * zb + 8), d + 8);
    const int* ls = ls4y + 16 * qm;
#pragma unroll
    for (int j = 0; j < 16; ++j) d[j] = scale(d[j] * __ldg(ls + j), q6, 4);
    if (k == 2) {  // I16: the scaled DC of the block's raster position
      int v[16];
      const int16_t* D = ldc + f * ldc_sf + i * ldc_sm;
      unpack8(*(const uint4*)D, v);
      unpack8(*(const uint4*)(D + 8), v + 8);
      hadamard4x4(v);
      const int bx = ((zb >> 2) & 1) * 2 + (zb & 1);
      const int by = ((zb >> 3) & 1) * 2 + ((zb >> 1) & 1);
      d[0] = scale(v[4 * by + bx] * __ldg(ls), q6, 6);
    }
    idct4_clamped(d);
    uint4* o = (uint4*)(Y + 16 * zb);
    o[0] = make_uint4(pack2(d[0], d[1]), pack2(d[2], d[3]), pack2(d[4], d[5]),
                      pack2(d[6], d[7]));
    o[1] = make_uint4(pack2(d[8], d[9]), pack2(d[10], d[11]),
                      pack2(d[12], d[13]), pack2(d[14], d[15]));
  }

  if (lane < 8) {  // chroma: plane p, 4x4 block b (raster in the 2x2)
    const int p = lane >> 2, b = lane & 3;
    const int qc = p ? qpcr[m] : qpcb[m];
    const int cq6 = qc / 6;
    const int* ls = (p ? ls4cr : ls4cb) + 16 * (qc % 6);
    const uint2 dw = *(const uint2*)(cdc + f * cdc_sf + i * cdc_sm + 4 * p);
    const int c0 = lo16(dw.x), c1 = hi16(dw.x), c2 = lo16(dw.y),
              c3 = hi16(dw.y);
    const int h = b == 0 ? c0 + c1 + c2 + c3
                : b == 1 ? c0 - c1 + c2 - c3
                : b == 2 ? c0 + c1 - c2 - c3 : c0 - c1 - c2 + c3;
    int d[16];
    const int16_t* A = cac + f * cac_sf + i * cac_sm + 64 * p + 16 * b;
    unpack8(*(const uint4*)A, d);
    unpack8(*(const uint4*)(A + 8), d + 8);
#pragma unroll
    for (int j = 1; j < 16; ++j) d[j] = scale(d[j] * __ldg(ls + j), cq6, 4);
    d[0] = ((h * __ldg(ls)) << cq6) >> 5;
    idct4_clamped(d);
    int16_t* C = cres + m * 128 + 64 * p + 32 * (b >> 1) + 4 * (b & 1);
#pragma unroll
    for (int y = 0; y < 4; ++y)
      *(uint2*)(C + 8 * y) = make_uint2(pack2(d[4 * y], d[4 * y + 1]),
                                        pack2(d[4 * y + 2], d[4 * y + 3]));
  }
}

}  // namespace

DT_EXPORT int dt_stage_a(const void* kind, const void* qpy, const void* qpcb,
                         const void* qpcr, const void* lv, const void* ldc,
                         const void* cdc, const void* cac, const void* ls4y,
                         const void* ls4cb, const void* ls4cr,
                         const void* ls8y, void* yres, void* cres, int F,
                         int n, int lv_sf, int lv_sm, int ldc_sf, int ldc_sm,
                         int cdc_sf, int cdc_sm, int cac_sf, int cac_sm,
                         void* stream) {
  const long long M = (long long)F * n;
  const int blocks = (int)((M + kWarps - 1) / kWarps);
  if (blocks > 0)
    stage_a_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)kind, (const int*)qpy, (const int*)qpcb,
        (const int*)qpcr, (const int16_t*)lv, (const int16_t*)ldc,
        (const int16_t*)cdc, (const int16_t*)cac, (const int*)ls4y,
        (const int*)ls4cb, (const int*)ls4cr, (const int*)ls8y,
        (int16_t*)yres, (int16_t*)cres, F, n, lv_sf, lv_sm, ldc_sf, ldc_sm,
        cdc_sf, cdc_sm, cac_sf, cac_sm);
  return (int)cudaGetLastError();
}
