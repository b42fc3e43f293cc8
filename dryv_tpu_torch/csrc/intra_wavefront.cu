// Kernel B2: intra prediction + residual add along the MB wavefront.
//
// Replaces the Pallas kernel _build_kernel / make_gop_recon_pallas
// (dryv_tpu/kernels/pallas_wavefront.py).  The TPU walks the
// anti-diagonals d = x + 2y sequentially inside one kernel and keeps the
// dependency frontier in VMEM scratch.  Here the host issues one launch
// per diagonal, with one block per (MB of the diagonal, frame); a block
// reads its aprons (left column, above row, above-right row, corner)
// straight from the output planes that earlier launches wrote, so no
// frontier state exists.  Blocks of one launch run in any order: each
// writes only its own MB.
//
// Inside a block a 17x25 shared window holds the luma aprons and the
// MB's samples as they are reconstructed, as the Pallas window W does;
// the 4 I8 quadrants and the 16 I4 blocks run in order with
// __syncthreads between them.  Only the MB's own kind is computed (the
// TPU computes all kinds lane-wise and selects).  Directional modes use
// the tap tables of dryv_tpu/kernels/pred_tables.py (<= 3 taps, a
// rounding constant and a shift per output sample); all arithmetic is
// int32.  The lane packing, int8 matmuls and -128 bias of the TPU
// version are layout devices and have no counterpart.
//
// What bounds it: latency, not bytes or operations (a 1080p MB moves
// ~1 KB).  254 dependent launches at 1080p each wait for their slowest
// block, whose time is the serial chain inside one MB: 16 dependent I4
// blocks with two barriers each.
//
// Banded variant (B2b, the Pallas kernel's banded=True): the planes hold
// one band of MB rows, and the MBs on its first row read their above,
// above-right and corner aprons from the halo, the bottom luma row hy
// [F, 16*mb_w] and the two bottom chroma rows hc [F, 2, 8*mb_w] of the
// band above, instead of from row -1 of the planes.  The TPU packs the
// halo into a lane-shifted block per diagonal; here it stays as rows and
// a block indexes them by column, with the same bounds as plane reads.
// hy == hc == nullptr is B2.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kKindI8 = 1, kKindI16 = 2, kKindPCM = 3;

struct Planes {
  uint8_t* y;
  uint8_t* cb;
  uint8_t* cr;
  const uint8_t* hy;  // halo rows of the band above, or nullptr
  const uint8_t* hc;
  int mb_w, mb_h;
};

// availability source code -> flag: 0 true, 1..4 MB a..d, 5 false
__device__ __forceinline__ bool avail_of(int code, const int* av) {
  return code == 0 ? true : (code == 5 ? false : av[code - 1] != 0);
}

// one directional-mode sample from a tap row (idx0..2, w0..2, r, s)
__device__ __forceinline__ int tap_pred(const uint8_t* __restrict__ t,
                                        const int* sv) {
  int acc = t[3] * sv[t[0]] + t[4] * sv[t[1]] + t[5] * sv[t[2]] + t[6];
  return acc >> t[7];
}

__global__ void __launch_bounds__(kThreads)
intra_diag_kernel(const uint8_t* __restrict__ meta,
                  const int16_t* __restrict__ yres,
                  const int16_t* __restrict__ cres,
                  const uint8_t* __restrict__ tap4,
                  const uint8_t* __restrict__ tap8,
                  const uint8_t* __restrict__ avail4,
                  const uint8_t* __restrict__ avail8, Planes P, int d,
                  int y_first) {
  __shared__ int W[17][25];   // row 0 / col 0: aprons; W[1+y][1+x]: MB
  __shared__ int sv[25];      // sample vector of the current block
  __shared__ int craw[2][17]; // chroma: corner, above 8, left 8
  __shared__ int m[32];       // meta row

  const int t = threadIdx.x;
  const int my = y_first + blockIdx.x;
  const int mx = d - 2 * my;
  const int f = blockIdx.y;
  const int n = P.mb_w * P.mb_h;
  const int mb = f * n + my * P.mb_w + mx;
  const int Wd = 16 * P.mb_w, Hd = 16 * P.mb_h;
  const int Wc = 8 * P.mb_w, Hc = 8 * P.mb_h;
  uint8_t* Y = P.y + (size_t)f * Hd * Wd;
  const int x0 = 16 * mx, y0 = 16 * my;

  for (int i = t; i < 17 * 25; i += kThreads) (&W[0][0])[i] = 0;
  if (t < 32) m[t] = meta[(size_t)mb * 32 + t];
  __syncthreads();
  // the row above the MB: row y0-1 of the planes, or on a band's first
  // MB row the halo (zeros when there is neither)
  const uint8_t* above_y = my > 0 ? Y + (size_t)(y0 - 1) * Wd
                           : P.hy ? P.hy + (size_t)f * Wd : nullptr;
  if (t < 25) {  // corner, above 16, above-right 8
    int col = x0 - 1 + t;
    if (above_y && col >= 0 && col < Wd) W[0][t] = above_y[col];
  } else if (t < 41) {  // left 16
    int r = t - 25;
    if (mx > 0) W[1 + r][0] = Y[(size_t)(y0 + r) * Wd + x0 - 1];
  } else if (t < 59) {  // chroma above 8 and left 8, then corners
    const bool corner = t >= 57;
    int p = corner ? t - 57 : (t - 41) >> 3, i = (t - 41) & 7;
    const uint8_t* C = (p ? P.cr : P.cb) + (size_t)f * Hc * Wc;
    const uint8_t* above_c =
        my > 0 ? C + (size_t)(8 * my - 1) * Wc
               : (P.hc ? P.hc + ((size_t)f * 2 + p) * Wc : nullptr);
    int cx0 = 8 * mx;
    if (corner) {
      craw[p][0] = (mx > 0 && above_c) ? above_c[cx0 - 1] : 0;
    } else {
      craw[p][1 + i] = above_c ? above_c[cx0 + i] : 0;
      craw[p][9 + i] = mx > 0 ? C[(size_t)(8 * my + i) * Wc + cx0 - 1] : 0;
    }
  }
  __syncthreads();

  const int kind = m[0];
  const int av[4] = {m[3], m[4], m[5], m[6]};
  const bool ava = av[0] != 0, avb = av[1] != 0;
  const int16_t* res = yres + (size_t)mb * 256;

  if (kind == kKindPCM || kind == kKindI16) {
    const int mode = m[1];
    int suma = 0, suml = 0, hh = 0, vv = 0;
    for (int i = 0; i < 16; ++i) {
      suma += W[0][1 + i];
      suml += W[1 + i][0];
    }
    const int corner = W[0][0];
    for (int i = 0; i < 8; ++i) {
      hh += (i + 1) * (W[0][9 + i] - (i < 7 ? W[0][7 - i] : corner));
      vv += (i + 1) * (W[9 + i][0] - (i < 7 ? W[7 - i][0] : corner));
    }
    const int b = (5 * hh + 32) >> 6, c = (5 * vv + 32) >> 6;
    const int aa = 16 * (W[0][16] + W[16][0]);
    const int dc = (ava && avb) ? (suma + suml + 16) >> 5
                   : ava        ? (suml + 8) >> 4
                   : avb        ? (suma + 8) >> 4 : 128;
    for (int p = t; p < 256; p += kThreads) {
      int px = p & 15, py = p >> 4;
      // z-row of spatial (px, py): z-block 4q + s, then 4*dy + dx
      int q = ((py >> 3) << 1) | (px >> 3);
      int s = (((py >> 2) & 1) << 1) | ((px >> 2) & 1);
      int r = res[16 * (4 * q + s) + 4 * (py & 3) + (px & 3)];
      int v;
      if (kind == kKindPCM) {
        v = r;
      } else {
        int pred = mode == 0 ? W[0][1 + px]
                 : mode == 1 ? W[1 + py][0]
                 : mode == 2 ? dc
                 : clip3(0, 255, (aa + b * (px - 7) + c * (py - 7) + 16) >> 5);
        v = clip3(0, 255, pred + r);
      }
      Y[(size_t)(y0 + py) * Wd + x0 + px] = (uint8_t)v;
    }
  } else if (kind == kKindI8) {
    for (int blk = 0; blk < 4; ++blk) {
      const int bx = blk & 1, by = blk >> 1, r0 = 8 * by, c0 = 8 * bx;
      const bool aa8 = avail_of(avail8[0 * 4 + blk], av);
      const bool ab8 = avail_of(avail8[1 * 4 + blk], av);
      const bool ac8 = avail_of(avail8[2 * 4 + blk], av);
      const bool ad8 = avail_of(avail8[3 * 4 + blk], av);
      // raw references: corner, above 16 (right half substituted when C
      // is unavailable), left 8
      int raw = 0;
      if (t == 0) raw = W[r0][c0];
      else if (t < 17) raw = (t <= 8 || ac8) ? W[r0][c0 + t] : W[r0][c0 + 8];
      else if (t < 25) raw = W[r0 + 1 + (t - 17)][c0];
      if (t < 25) sv[t] = raw;
      __syncthreads();
      // reference-sample filter (8.3.2.2.1)
      int fv = 0;
      if (t < 25) {
        const int corn = sv[0];
        if (t == 0) {
          const int a0 = sv[1], l0 = sv[17];
          fv = !ad8 ? corn
             : (aa8 && ab8) ? (a0 + 2 * corn + l0 + 2) >> 2
             : ab8 ? (3 * corn + a0 + 2) >> 2
             : aa8 ? (3 * corn + l0 + 2) >> 2 : corn;
        } else if (t < 17) {
          const int x = t - 1;
          int v;
          if (x == 0)
            v = ad8 ? (corn + 2 * sv[1] + sv[2] + 2) >> 2
                    : (3 * sv[1] + sv[2] + 2) >> 2;
          else if (x == 15)
            v = (sv[15] + 3 * sv[16] + 2) >> 2;
          else
            v = (sv[x] + 2 * sv[x + 1] + sv[x + 2] + 2) >> 2;
          fv = ab8 ? v : sv[t];
        } else {
          const int y = t - 17;
          int v;
          if (y == 0)
            v = ad8 ? (corn + 2 * sv[17] + sv[18] + 2) >> 2
                    : (3 * sv[17] + sv[18] + 2) >> 2;
          else if (y == 7)
            v = (sv[23] + 3 * sv[24] + 2) >> 2;
          else
            v = (sv[16 + y] + 2 * sv[17 + y] + sv[18 + y] + 2) >> 2;
          fv = aa8 ? v : sv[t];
        }
      }
      __syncthreads();
      if (t < 25) sv[t] = fv;
      __syncthreads();
      {
        const int px = t & 7, py = t >> 3;
        const int mode = m[23 + blk];
        int pred;
        if (mode == 2) {
          int suma = 0, suml = 0;
          for (int i = 0; i < 8; ++i) {
            suma += sv[1 + i];
            suml += sv[17 + i];
          }
          pred = (aa8 && ab8) ? (suma + suml + 8) >> 4
               : aa8 ? (suml + 4) >> 3
               : ab8 ? (suma + 4) >> 3 : 128;
        } else {
          pred = tap_pred(tap8 + ((mode * 64) + 8 * py + px) * 8, sv);
        }
        int v = clip3(0, 255, pred + res[64 * blk + 8 * py + px]);
        W[r0 + 1 + py][c0 + 1 + px] = v;
        Y[(size_t)(y0 + r0 + py) * Wd + x0 + c0 + px] = (uint8_t)v;
      }
      __syncthreads();
    }
  } else {  // I4
    for (int blk = 0; blk < 16; ++blk) {
      const int q = blk >> 2, s = blk & 3;
      const int bx = ((q & 1) << 1) | (s & 1), by = (q & 2) | ((s >> 1) & 1);
      const int r0 = 4 * by, c0 = 4 * bx;
      const bool aa4 = avail_of(avail4[0 * 16 + blk], av);
      const bool ab4 = avail_of(avail4[1 * 16 + blk], av);
      const bool ac4 = avail_of(avail4[2 * 16 + blk], av);
      if (t == 0) sv[0] = W[r0][c0];
      else if (t < 9) sv[t] = (t <= 4 || ac4) ? W[r0][c0 + t] : W[r0][c0 + 4];
      else if (t < 13) sv[t] = W[r0 + 1 + (t - 9)][c0];
      __syncthreads();
      if (t < 16) {
        const int px = t & 3, py = t >> 2;
        const int mode = m[7 + blk];
        int pred;
        if (mode == 2) {
          const int suma = sv[1] + sv[2] + sv[3] + sv[4];
          const int suml = sv[9] + sv[10] + sv[11] + sv[12];
          pred = (aa4 && ab4) ? (suma + suml + 4) >> 3
               : aa4 ? (suml + 2) >> 2
               : ab4 ? (suma + 2) >> 2 : 128;
        } else {
          pred = tap_pred(tap4 + ((mode * 16) + 4 * py + px) * 8, sv);
        }
        int v = clip3(0, 255, pred + res[16 * blk + 4 * py + px]);
        W[r0 + 1 + py][c0 + 1 + px] = v;
        Y[(size_t)(y0 + r0 + py) * Wd + x0 + c0 + px] = (uint8_t)v;
      }
      __syncthreads();
    }
  }

  // ---- chroma 4:2:0: one thread per sample of each plane ----------------
  {
    const int cx = t & 7, cy = t >> 3;
    const int cmode = m[2];
    for (int p = 0; p < 2; ++p) {
      const int* cw = craw[p];  // [corner, above 0..7, left 0..7]
      const int r = cres[((size_t)mb * 2 + p) * 64 + t];
      int v;
      if (kind == kKindPCM) {
        v = r;
      } else {
        int pred;
        if (cmode == 1) {
          pred = cw[9 + cy];
        } else if (cmode == 2) {
          pred = cw[1 + cx];
        } else if (cmode == 3) {
          int hs = 0, vs = 0;
          for (int i = 0; i < 4; ++i) {
            hs += (i + 1) * (cw[5 + i] - (i <= 2 ? cw[3 - i] : cw[0]));
            vs += (i + 1) * (cw[13 + i] - (i <= 2 ? cw[11 - i] : cw[0]));
          }
          const int b = (34 * hs + 32) >> 6, c = (34 * vs + 32) >> 6;
          const int aa = 16 * (cw[8] + cw[16]);
          pred = clip3(0, 255, (aa + b * (cx - 3) + c * (cy - 3) + 16) >> 5);
        } else {  // DC per 4x4 quadrant
          const int ax = cx >> 2, ly = cy >> 2;
          const int as = cw[1 + 4 * ax] + cw[2 + 4 * ax] + cw[3 + 4 * ax] +
                         cw[4 + 4 * ax];
          const int ls = cw[9 + 4 * ly] + cw[10 + 4 * ly] + cw[11 + 4 * ly] +
                         cw[12 + 4 * ly];
          if (ax == ly)  // (0,0) and (4,4): full fallback chain
            pred = (ava && avb) ? (as + ls + 4) >> 3
                 : ava ? (ls + 2) >> 2 : avb ? (as + 2) >> 2 : 128;
          else if (ax == 1)  // x=4..7, y=0..3 prefers above
            pred = avb ? (as + 2) >> 2 : ava ? (ls + 2) >> 2 : 128;
          else  // x=0..3, y=4..7 prefers left
            pred = ava ? (ls + 2) >> 2 : avb ? (as + 2) >> 2 : 128;
        }
        v = clip3(0, 255, pred + r);
      }
      uint8_t* C = (p ? P.cr : P.cb) + (size_t)f * Hc * Wc;
      C[(size_t)(8 * my + cy) * Wc + 8 * mx + cx] = (uint8_t)v;
    }
  }
}

}  // namespace

DT_EXPORT int dt_intra_wavefront(const void* meta, const void* yres,
                                 const void* cres, const void* tap4,
                                 const void* tap8, const void* avail4,
                                 const void* avail8, void* y, void* cb,
                                 void* cr, const void* hy, const void* hc,
                                 int mb_w, int mb_h, int F, void* stream) {
  Planes P{(uint8_t*)y, (uint8_t*)cb, (uint8_t*)cr, (const uint8_t*)hy,
           (const uint8_t*)hc, mb_w, mb_h};
  const int n_diag = mb_w + 2 * (mb_h - 1);
  for (int d = 0; d < n_diag; ++d) {
    DiagRange r = diag_range(d, mb_w, mb_h);
    intra_diag_kernel<<<dim3(r.n, F), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)meta, (const int16_t*)yres, (const int16_t*)cres,
        (const uint8_t*)tap4, (const uint8_t*)tap8, (const uint8_t*)avail4,
        (const uint8_t*)avail8, P, d, r.y0);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
