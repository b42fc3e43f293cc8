// Kernel B4: motion-compensated prediction (spec 8.4.2) of every 4x4 block.
//
// The JAX package has no Pallas kernel here: dryv_tpu/kernels/inter.py
// mc_frame (:146) runs as an XLA gather of a 9x9 window per block.  This
// kernel computes what mc_frame + wp_combine compute, with the weighted-
// prediction resolve (resolve_wp_blocks_jax, :199) folded in.
//
// One thread per 4x4 luma block (130,560 at 1080p).  For each list the
// block uses it reads its 9x9 luma window with __ldg, clamped into the
// uncropped plane of its stack slot (the whole stack sits in the 50 MB
// L2: 3.1 MB a 1080p picture), builds the 6-tap lattice in registers,
// takes the Table 8-12 phase, then its two 2x2 chroma blocks (eighth-pel
// bilinear on 3x3 windows).  The combine's parameters come from the
// picture's tables, staged in shared memory (explicit [2,32,6] int16,
// implicit [256,2] int16, the two denominators and n_ref1 in misc), and
// from the block's int8 reference indices.  Predictions are clipped to
// 0..255, so they are written as uint8 straight into the MB-tile layout:
// 4-byte luma rows and 2-byte chroma rows.  Blocks that use no list
// (intra MBs) write 0.
//
// Bound: the bytes it must move (predictions out, motion field and slots
// in, each used list's reference area once) over device memory; its
// integer work, a few hundred operations per block and list, takes about
// as long.  This first design leans on L1/L2 for the overlapping windows
// and makes no use of shared memory for them.
//
// The per-block fields are read in place from the packed wire: int16
// vectors (x, y) at a block stride of mv_stride elements, int8 slots and
// reference indices at rs_stride.  NL (lists) is a template parameter: a
// P picture (NL = 1) reads nothing of list 1.  row0 offsets the block rows
// inside the planes, so banded P recon runs the kernel on its extended
// band plane.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e,
                                    int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}
__device__ __forceinline__ int clip255(int v) { return clip3(0, 255, v); }
__device__ __forceinline__ int avg2(int a, int b) { return (a + b + 1) >> 1; }

// Quarter-pel luma of one 4x4 block at (x0, y0), raster out[16].
__device__ __forceinline__ void luma_block(const uint8_t* __restrict__ ref,
                                           int H, int W, int x0, int y0,
                                           int mvx, int mvy, int* out) {
  const int ix = x0 + (mvx >> 2) - 2, iy = y0 + (mvy >> 2) - 2;
  const int fx = mvx & 3, fy = mvy & 3;
  int col[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) col[c] = clip3(0, W - 1, ix + c);
  int win[9][9];
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    const uint8_t* row = ref + (size_t)clip3(0, H - 1, iy + r) * W;
#pragma unroll
    for (int c = 0; c < 9; ++c) win[r][c] = __ldg(row + col[c]);
  }
  if (fx == 0) {
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int G = win[y + 2][x + 2];
        if (fy == 0) {
          out[4 * y + x] = G;
          continue;
        }
        const int h = clip255(
            (tap6(win[y][x + 2], win[y + 1][x + 2], win[y + 2][x + 2],
                  win[y + 3][x + 2], win[y + 4][x + 2], win[y + 5][x + 2]) +
             16) >> 5);
        out[4 * y + x] = fy == 1   ? avg2(G, h)
                         : fy == 2 ? h
                                   : avg2(h, win[y + 3][x + 2]);
      }
    return;
  }
  // horizontal 6-tap of every window row at the block's 4 columns: b
  // (rows 2..5 / 3..6 after rounding) and the input of j
  int br[9][4];
#pragma unroll
  for (int r = 0; r < 9; ++r)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      br[r][x] = tap6(win[r][x], win[r][x + 1], win[r][x + 2], win[r][x + 3],
                      win[r][x + 4], win[r][x + 5]);
#pragma unroll
  for (int y = 0; y < 4; ++y)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int bC = clip255((br[y + 2][x] + 16) >> 5);
      const int bD = clip255((br[y + 3][x] + 16) >> 5);
      // h at the block column (hC) or one to the right (hE), by fx; the
      // column is selected per tap so that the window keeps static
      // indices (a runtime index would put it in local memory)
      int t[6];
#pragma unroll
      for (int k = 0; k < 6; ++k)
        t[k] = fx == 3 ? win[y + k][x + 3] : win[y + k][x + 2];
      const int hv =
          clip255((tap6(t[0], t[1], t[2], t[3], t[4], t[5]) + 16) >> 5);
      int v;
      if (fy == 0) {
        v = fx == 1 ? avg2(win[y + 2][x + 2], bC)
            : fx == 2 ? bC
                      : avg2(bC, win[y + 2][x + 3]);
      } else if (fx != 2 && fy != 2) {   // the diagonal positions
        v = avg2(fy == 1 ? bC : bD, hv);
      } else {
        const int j = clip255(
            (tap6(br[y][x], br[y + 1][x], br[y + 2][x], br[y + 3][x],
                  br[y + 4][x], br[y + 5][x]) + 512) >> 10);
        v = fy == 2 ? (fx == 2 ? j : avg2(hv, j))
            : fy == 1 ? avg2(bC, j)
                      : avg2(j, bD);
      }
      out[4 * y + x] = v;
    }
}

// Eighth-pel chroma of one 2x2 block at (x0, y0), raster out[4].
__device__ __forceinline__ void chroma_block(const uint8_t* __restrict__ ref,
                                             int Hc, int Wc, int x0, int y0,
                                             int mvx, int mvy, int* out) {
  const int ix = x0 + (mvx >> 3), iy = y0 + (mvy >> 3);
  const int fx = mvx & 7, fy = mvy & 7;
  int w[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const uint8_t* row = ref + (size_t)clip3(0, Hc - 1, iy + r) * Wc;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      w[r][c] = __ldg(row + clip3(0, Wc - 1, ix + c));
  }
  const int a = (8 - fx) * (8 - fy), b = fx * (8 - fy), c = (8 - fx) * fy,
            d = fx * fy;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      out[2 * i + j] = (a * w[i][j] + b * w[i][j + 1] + c * w[i + 1][j] +
                        d * w[i + 1][j + 1] + 32) >> 6;
}

struct Wp {
  int w0, o0, w1, o1, d;
};

// 8.4.2.3 combine (wp_combine): bi-predicted, or single from the list used
__device__ __forceinline__ int combine(int p0, int p1, bool u0, bool u1,
                                       const Wp& q) {
  if (u0 && u1)
    return clip255(((p0 * q.w0 + p1 * q.w1 + (1 << q.d)) >> (q.d + 1)) +
                   ((q.o0 + q.o1 + 1) >> 1));
  const int p = u0 ? p0 : p1, w = u0 ? q.w0 : q.w1, o = u0 ? q.o0 : q.o1;
  return clip255(((p * w + ((1 << q.d) >> 1)) >> q.d) + o);
}

template <int NL>
__global__ void __launch_bounds__(kThreads)
inter_mc_kernel(const uint8_t* __restrict__ ref_y,
                const uint8_t* __restrict__ ref_cb,
                const uint8_t* __restrict__ ref_cr,
                const int16_t* __restrict__ mv0,
                const int16_t* __restrict__ mv1,
                const int8_t* __restrict__ rs0, const int8_t* __restrict__ rs1,
                const int8_t* __restrict__ ri0, const int8_t* __restrict__ ri1,
                const int16_t* __restrict__ expl,
                const int16_t* __restrict__ imp,
                const int* __restrict__ misc, uint8_t* __restrict__ pred_y,
                uint8_t* __restrict__ pred_c, int R, int H, int W, int mb_w,
                int mb_h, int row0, int mv_stride, int rs_stride,
                int wp_mode) {
  __shared__ int16_t s_expl[2 * 32 * 6];
  __shared__ int16_t s_imp[256 * 2];
  if (wp_mode == 1)
    for (int i = threadIdx.x; i < 2 * 32 * 6; i += kThreads)
      s_expl[i] = expl[i];
  else if (wp_mode == 2)
    for (int i = threadIdx.x; i < 256 * 2; i += kThreads) s_imp[i] = imp[i];
  __syncthreads();

  const int W4 = 4 * mb_w;
  const int blk = blockIdx.x * kThreads + threadIdx.x;
  if (blk >= W4 * 4 * mb_h) return;
  const int bx4 = blk % W4, by4 = blk / W4;
  const int s0 = rs0[(size_t)blk * rs_stride];
  const int s1 = NL == 2 ? (int)rs1[(size_t)blk * rs_stride] : -1;
  const bool u0 = s0 >= 0, u1 = s1 >= 0;

  const int a = (by4 >> 2) * mb_w + (bx4 >> 2);
  uint8_t* py = pred_y + (size_t)a * 256 + (by4 & 3) * 64 + (bx4 & 3) * 4;
  uint8_t* pc = pred_c + (size_t)a * 128 + (by4 & 3) * 16 + (bx4 & 3) * 2;
  if (!u0 && !u1) {
#pragma unroll
    for (int y = 0; y < 4; ++y) *(uint32_t*)(py + 16 * y) = 0u;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < 2; ++i) *(uint16_t*)(pc + 64 * p + 8 * i) = 0;
    return;
  }

  // weighted-prediction parameters: luma, cb, cr
  Wp q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = Wp{1, 0, 1, 0, 0};
  if (wp_mode == 1) {
    const int i0 = clip3(0, 31, ri0[(size_t)blk * rs_stride]);
    const int i1 =
        NL == 2 ? clip3(0, 31, ri1[(size_t)blk * rs_stride]) : 0;
    const int16_t* e0 = s_expl + 6 * i0;
    const int16_t* e1 = s_expl + 6 * (32 + i1);
    const int dy = misc[0], dc = misc[1];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      q[k] = Wp{e0[2 * k], e0[2 * k + 1], e1[2 * k], e1[2 * k + 1],
                k ? dc : dy};
  } else if (wp_mode == 2) {
    const int r0 = ri0[(size_t)blk * rs_stride];
    const int r1 = NL == 2 ? (int)ri1[(size_t)blk * rs_stride] : -1;
    if (r0 >= 0 && r1 >= 0) {
      const int pair = clip3(0, 255, r0 * misc[2] + r1);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        q[k] = Wp{s_imp[2 * pair], 0, s_imp[2 * pair + 1], 0, 5};
    }
  }

  const size_t plane = (size_t)H * W, cplane = plane / 4;
  const int Hc = H / 2, Wc = W / 2;
  const int x0 = 4 * bx4, y0 = 4 * (by4 + row0);
  int l0[16], l1[16], c0[2][4], c1[2][4];
  if (u0) {
    const int slot = min(s0, R - 1);
    const int mx = mv0[(size_t)blk * mv_stride];
    const int my = mv0[(size_t)blk * mv_stride + 1];
    luma_block(ref_y + slot * plane, H, W, x0, y0, mx, my, l0);
    chroma_block(ref_cb + slot * cplane, Hc, Wc, x0 / 2, y0 / 2, mx, my,
                 c0[0]);
    chroma_block(ref_cr + slot * cplane, Hc, Wc, x0 / 2, y0 / 2, mx, my,
                 c0[1]);
  }
  if (NL == 2 && u1) {
    const int slot = min(s1, R - 1);
    const int mx = mv1[(size_t)blk * mv_stride];
    const int my = mv1[(size_t)blk * mv_stride + 1];
    luma_block(ref_y + slot * plane, H, W, x0, y0, mx, my, l1);
    chroma_block(ref_cb + slot * cplane, Hc, Wc, x0 / 2, y0 / 2, mx, my,
                 c1[0]);
    chroma_block(ref_cr + slot * cplane, Hc, Wc, x0 / 2, y0 / 2, mx, my,
                 c1[1]);
  }
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    uint32_t word = 0;
#pragma unroll
    for (int x = 0; x < 4; ++x)
      word |= (uint32_t)combine(l0[4 * y + x], l1[4 * y + x], u0, u1, q[0])
              << (8 * x);
    *(uint32_t*)(py + 16 * y) = word;
  }
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lo = combine(c0[p][2 * i], c1[p][2 * i], u0, u1, q[1 + p]);
      const int hi =
          combine(c0[p][2 * i + 1], c1[p][2 * i + 1], u0, u1, q[1 + p]);
      *(uint16_t*)(pc + 64 * p + 8 * i) = (uint16_t)(lo | (hi << 8));
    }
}

}  // namespace

DT_EXPORT int dt_inter_mc(const void* ref_y, const void* ref_cb,
                          const void* ref_cr, const void* mv0,
                          const void* mv1, const void* rs0, const void* rs1,
                          const void* ri0, const void* ri1, const void* expl,
                          const void* imp, const void* misc, void* pred_y,
                          void* pred_c, int R, int H, int W, int mb_w,
                          int mb_h, int row0, int mv_stride, int rs_stride,
                          int nlists, int wp_mode, void* stream) {
  const int n4 = 16 * mb_w * mb_h;
  const int blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > 0) {
    auto kernel = nlists == 2 ? inter_mc_kernel<2> : inter_mc_kernel<1>;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)ref_y, (const uint8_t*)ref_cb, (const uint8_t*)ref_cr,
        (const int16_t*)mv0, (const int16_t*)mv1, (const int8_t*)rs0,
        (const int8_t*)rs1, (const int8_t*)ri0, (const int8_t*)ri1,
        (const int16_t*)expl, (const int16_t*)imp, (const int*)misc,
        (uint8_t*)pred_y, (uint8_t*)pred_c, R, H, W, mb_w, mb_h, row0,
        mv_stride, rs_stride, wp_mode);
  }
  return (int)cudaGetLastError();
}
