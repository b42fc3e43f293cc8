// Kernel B2: intra prediction + residual add along the MB wavefront.
//
// Replaces the Pallas kernel _build_kernel / make_gop_recon_pallas
// (dryv_tpu/kernels/pallas_wavefront.py).  The TPU walks the
// anti-diagonals d = x + 2y sequentially inside one kernel and keeps the
// dependency frontier in VMEM scratch.  Here one persistent launch does a
// whole call (row_sched.cuh): each block takes (frame, MB row) tasks from
// a ticket counter, row 0 of every frame first, and walks its row left to
// right.  Before MB (x, y) reads its above, above-right and corner
// aprons, thread 0 waits until row y-1 of its frame has finished
// min(x + 2, mb_w) MBs; after the MB is written, row y's flag is raised
// to x + 1.  Row 0 waits for nothing: a picture has nothing above it, and
// a band's aprons there come from the halo, complete before the launch.
//
// What bounds it: latency, not bytes or operations (an MB moves ~1.2 KB).
// The critical path is a chain of mb_w + 2 (mb_h - 1) MBs (254 at 1080p),
// each one MB's serial prediction chain plus, where the chain steps down
// a row, one flag hand-off through L2.  The design shortens both:
//
// - Warp 0 reconstructs luma, warp 1 chroma, at the same time (chroma
//   needs only chroma neighbours).  The 16 I4 blocks run as 10 steps of
//   the 4x4 blocks' own wavefront (bx + 2 by), two blocks of 16 samples
//   per step, and the 4 I8 quadrants in order, each with __syncwarp only;
//   the I16 and DC sums are warp reductions.
// - What the block already has stays in shared memory: the left apron is
//   the right column of the MB it finished just before (16 luma, 2 x 8
//   chroma samples), and the tap and availability tables are loaded once
//   per block.  Only the above row comes from device memory, through L2.
// - The next MB's inputs (meta, luma and chroma residuals: 800 B) are
//   copied into a shared double buffer with cp.async while the current
//   MB reconstructs.
//
// Directional modes use the tap tables of kernels/pred_tables.py (<= 3
// taps, a rounding constant and a shift per output sample); all
// arithmetic is int32.  The lane packing, int8 matmuls and -128 bias of
// the TPU version are layout devices and have no counterpart.
//
// Banded variant (B2b, the Pallas kernel's banded=True): the planes hold
// one band of MB rows, and the MBs on its first row read their above,
// above-right and corner aprons from the halo, the bottom luma row hy
// [F, 16*mb_w] and the two bottom chroma rows hc [F, 2, 8*mb_w] of the
// band above, instead of from row -1 of the planes.  hy == hc == nullptr
// is B2.
#include "row_sched.cuh"

namespace {

constexpr int kThreads = 64;  // warp 0: luma, warp 1: chroma
constexpr int kKindI8 = 1, kKindI16 = 2, kKindPCM = 3;
constexpr unsigned kAll = 0xffffffffu;

struct Planes {
  uint8_t* y;
  uint8_t* cb;
  uint8_t* cr;
  const uint8_t* hy;  // halo rows of the band above, or nullptr
  const uint8_t* hc;
  int mb_w, mb_h, F;
};

// One MB's inputs, as they lie in device memory (800 bytes).
struct __align__(16) MbIn {
  uint8_t meta[32];
  int16_t yres[256];
  int16_t cres[128];
};
constexpr int kChunks = sizeof(MbIn) / 16;  // 2 meta + 32 yres + 16 cres

// availability source code -> flag: 0 true, 1..4 MB a..d, 5 false
__device__ __forceinline__ bool avail_of(int code, const uint8_t* m) {
  return code == 0 ? true : (code == 5 ? false : m[2 + code] != 0);
}

__device__ __forceinline__ int sum_warp(int v) {
  return __reduce_add_sync(kAll, v);
}

// Copy MB `mb`'s inputs into `dst` (threads 0..kChunks-1, one chunk each).
__device__ __forceinline__ void prefetch(MbIn* dst, const uint8_t* meta,
                                         const int16_t* yres,
                                         const int16_t* cres, size_t mb,
                                         int t) {
  if (t >= kChunks) return;
  const char* src =
      t < 2    ? (const char*)(meta + mb * 32) + 16 * t
      : t < 34 ? (const char*)(yres + mb * 256) + 16 * (t - 2)
               : (const char*)(cres + mb * 128) + 16 * (t - 34);
  cp_async16((char*)dst + 16 * t, src);
}

// ---- luma (warp 0) ------------------------------------------------------
// W[17][25]: row 0 the above aprons (corner, above 16, above-right 8),
// column 0 the left apron, W[1+y][1+x] the MB's samples.
__device__ void luma_mb(int lane, const MbIn& in, int (*W)[25], int* sv8,
                        const uint8_t* tap4, const uint8_t* tap8,
                        const uint8_t* av4, const uint8_t* av8,
                        const uint8_t* above, uint8_t* Y, int Wd, int mx,
                        int y0) {
  const int x0 = 16 * mx;
  // aprons: the left column is the right column of the MB before, still
  // in W; the above row comes from another block, through L2
  if (lane < 16) W[1 + lane][0] = mx > 0 ? W[1 + lane][16] : 0;
  if (lane < 25) {
    const int col = x0 - 1 + lane;
    W[0][lane] = (above && col >= 0 && col < Wd) ? __ldcg(above + col) : 0;
  }
  __syncwarp();

  const uint8_t* m = in.meta;
  const int kind = m[0];
  const bool ava = m[3] != 0, avb = m[4] != 0;
  const int16_t* res = in.yres;
  uint8_t* out = Y + (size_t)y0 * Wd + x0;

  if (kind == kKindPCM || kind == kKindI16) {
    const int mode = m[1];
    const int corner = W[0][0];
    int ht = 0, vt = 0;
    if (lane < 8) {
      ht = (lane + 1) * (W[0][9 + lane] - (lane < 7 ? W[0][7 - lane] : corner));
      vt = (lane + 1) * (W[9 + lane][0] - (lane < 7 ? W[7 - lane][0] : corner));
    }
    const int suma = sum_warp(lane < 16 ? W[0][1 + lane] : 0);
    const int suml = sum_warp(lane < 16 ? W[1 + lane][0] : 0);
    const int hh = sum_warp(ht), vv = sum_warp(vt);
    const int b = (5 * hh + 32) >> 6, c = (5 * vv + 32) >> 6;
    const int aa = 16 * (W[0][16] + W[16][0]);
    const int dc = (ava && avb) ? (suma + suml + 16) >> 5
                   : ava        ? (suml + 8) >> 4
                   : avb        ? (suma + 8) >> 4 : 128;
    for (int k = 0; k < 8; ++k) {
      const int p = lane + 32 * k, px = p & 15, py = p >> 4;
      // z-row of spatial (px, py): z-block 4q + s, then 4*dy + dx
      const int q = ((py >> 3) << 1) | (px >> 3);
      const int s = (((py >> 2) & 1) << 1) | ((px >> 2) & 1);
      const int r = res[16 * (4 * q + s) + 4 * (py & 3) + (px & 3)];
      int v;
      if (kind == kKindPCM) {
        v = r;
      } else {
        const int pred =
            mode == 0 ? W[0][1 + px]
            : mode == 1 ? W[1 + py][0]
            : mode == 2 ? dc
            : clip3(0, 255, (aa + b * (px - 7) + c * (py - 7) + 16) >> 5);
        v = clip3(0, 255, pred + r);
      }
      W[1 + py][1 + px] = v;
      out[(size_t)py * Wd + px] = (uint8_t)v;
    }
  } else if (kind == kKindI8) {
    for (int blk = 0; blk < 4; ++blk) {
      const int r0 = 8 * (blk >> 1), c0 = 8 * (blk & 1);
      const bool aa8 = avail_of(av8[0 * 4 + blk], m);
      const bool ab8 = avail_of(av8[1 * 4 + blk], m);
      const bool ac8 = avail_of(av8[2 * 4 + blk], m);
      const bool ad8 = avail_of(av8[3 * 4 + blk], m);
      // raw references in lanes: corner, above 16 (right half substituted
      // when C is unavailable), left 8
      int raw = 0;
      if (lane == 0) raw = W[r0][c0];
      else if (lane < 17) raw = (lane <= 8 || ac8) ? W[r0][c0 + lane]
                                                   : W[r0][c0 + 8];
      else if (lane < 25) raw = W[r0 + 1 + (lane - 17)][c0];
      // reference-sample filter (8.3.2.2.1), neighbours by shuffle
      const int prv = __shfl_sync(kAll, raw, lane > 0 ? lane - 1 : 0);
      const int nxt = __shfl_sync(kAll, raw, lane < 31 ? lane + 1 : 31);
      const int corn = __shfl_sync(kAll, raw, 0);
      const int a0 = __shfl_sync(kAll, raw, 1);
      const int l0 = __shfl_sync(kAll, raw, 17);
      int fv = raw;
      if (lane == 0) {
        fv = !ad8 ? corn
           : (aa8 && ab8) ? (a0 + 2 * corn + l0 + 2) >> 2
           : ab8 ? (3 * corn + a0 + 2) >> 2
           : aa8 ? (3 * corn + l0 + 2) >> 2 : corn;
      } else if (lane < 25) {
        const bool above_side = lane < 17;
        const int i = above_side ? lane - 1 : lane - 17, last = above_side ? 15 : 7;
        const int v = i == 0 ? (ad8 ? (corn + 2 * raw + nxt + 2) >> 2
                                    : (3 * raw + nxt + 2) >> 2)
                    : i == last ? (prv + 3 * raw + 2) >> 2
                    : (prv + 2 * raw + nxt + 2) >> 2;
        fv = (above_side ? ab8 : aa8) ? v : raw;
      }
      if (lane < 25) sv8[lane] = fv;
      __syncwarp();
      const int mode = m[23 + blk];
      int dc = 0;
      if (mode == 2) {
        const int suma = sum_warp(lane >= 1 && lane <= 8 ? fv : 0);
        const int suml = sum_warp(lane >= 17 && lane <= 24 ? fv : 0);
        dc = (aa8 && ab8) ? (suma + suml + 8) >> 4
           : aa8 ? (suml + 4) >> 3
           : ab8 ? (suma + 4) >> 3 : 128;
      }
      for (int k = 0; k < 2; ++k) {
        const int px = lane & 7, py = (lane >> 3) + 4 * k;
        int pred = dc;
        if (mode != 2) {
          const uint8_t* tp = tap8 + ((mode * 64) + 8 * py + px) * 8;
          pred = (tp[3] * sv8[tp[0]] + tp[4] * sv8[tp[1]] +
                  tp[5] * sv8[tp[2]] + tp[6]) >> tp[7];
        }
        const int v = clip3(0, 255, pred + res[64 * blk + 8 * py + px]);
        W[r0 + 1 + py][c0 + 1 + px] = v;
        out[(size_t)(r0 + py) * Wd + c0 + px] = (uint8_t)v;
      }
      __syncwarp();
    }
  } else {  // I4: the 4x4 blocks' own wavefront, d = bx + 2 by, 10 steps
    const int half = lane >> 4, s = lane & 15, px = s & 3, py = s >> 2;
    for (int d = 0; d < 10; ++d) {
      const int by_lo = d > 3 ? (d - 2) >> 1 : 0;
      const int by_hi = d >> 1 < 3 ? d >> 1 : 3;
      const int by = by_lo + half, bx = d - 2 * by;
      if (by <= by_hi) {
        const int blk = ((by >> 1) << 3) | ((bx >> 1) << 2) |
                        ((by & 1) << 1) | (bx & 1);  // z-scan index
        const int r0 = 4 * by, c0 = 4 * bx;
        const bool aa4 = avail_of(av4[0 * 16 + blk], m);
        const bool ab4 = avail_of(av4[1 * 16 + blk], m);
        const bool ac4 = avail_of(av4[2 * 16 + blk], m);
        const int mode = m[7 + blk];
        int pred;
        if (mode == 2) {
          const int suma = W[r0][c0 + 1] + W[r0][c0 + 2] + W[r0][c0 + 3] +
                           W[r0][c0 + 4];
          const int suml = W[r0 + 1][c0] + W[r0 + 2][c0] + W[r0 + 3][c0] +
                           W[r0 + 4][c0];
          pred = (aa4 && ab4) ? (suma + suml + 4) >> 3
               : aa4 ? (suml + 2) >> 2
               : ab4 ? (suma + 2) >> 2 : 128;
        } else {
          // sample j of the block's reference vector (corner, above 8
          // with C substitution, left 4), read straight from W
          const uint8_t* tp = tap4 + ((mode * 16) + 4 * py + px) * 8;
          int acc = tp[6];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int j = tp[i];
            const int ref = j == 0 ? W[r0][c0]
                          : j <= 8 ? W[r0][c0 + ((j > 4 && !ac4) ? 4 : j)]
                          : W[r0 + j - 8][c0];
            acc += tp[3 + i] * ref;
          }
          pred = acc >> tp[7];
        }
        const int v = clip3(0, 255, pred + res[16 * blk + 4 * py + px]);
        W[r0 + 1 + py][c0 + 1 + px] = v;
        out[(size_t)(r0 + py) * Wd + c0 + px] = (uint8_t)v;
      }
      __syncwarp();
    }
  }
}

// ---- chroma 4:2:0 (warp 1) ------------------------------------------------
// craw[p]: corner, above 8, left 8 of plane p; the left 8 are the right
// column of the MB before, written at the end of the previous call.
__device__ void chroma_mb(int lane, const MbIn& in, int (*craw)[17],
                          const uint8_t* const* above, uint8_t* const* C,
                          int Wc, int mx, int cy0) {
  const int cx0 = 8 * mx;
  if (mx == 0 && lane < 16) craw[lane >> 3][9 + (lane & 7)] = 0;
  if (lane < 16) {
    const int p = lane >> 3, i = lane & 7;
    craw[p][1 + i] = above[p] ? __ldcg(above[p] + cx0 + i) : 0;
  } else if (lane < 18) {
    const int p = lane - 16;
    craw[p][0] = (mx > 0 && above[p]) ? __ldcg(above[p] + cx0 - 1) : 0;
  }
  __syncwarp();

  const uint8_t* m = in.meta;
  const int kind = m[0], cmode = m[2];
  const bool ava = m[3] != 0, avb = m[4] != 0;
  const int cx = lane & 7;
  int keep[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int idx = lane + 32 * k, p = idx >> 6, t = idx & 63, cy = t >> 3;
    const int* cw = craw[p];  // [corner, above 0..7, left 0..7]
    const int r = in.cres[64 * p + t];
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
    C[p][(size_t)(cy0 + cy) * Wc + cx0 + cx] = (uint8_t)v;
    keep[k] = v;
  }
  __syncwarp();
  if (cx == 7) {  // the right column is the next MB's left apron
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int idx = lane + 32 * k;
      craw[idx >> 6][9 + ((idx & 63) >> 3)] = keep[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
intra_rows_kernel(const uint8_t* __restrict__ meta,
                  const int16_t* __restrict__ yres,
                  const int16_t* __restrict__ cres,
                  const uint8_t* __restrict__ tap4,
                  const uint8_t* __restrict__ tap8,
                  const uint8_t* __restrict__ avail4,
                  const uint8_t* __restrict__ avail8, Planes P,
                  int* __restrict__ sched) {
  __shared__ MbIn in[2];                       // double-buffered inputs
  __shared__ __align__(16) uint8_t s_tap4[9 * 16 * 8];
  __shared__ __align__(16) uint8_t s_tap8[9 * 64 * 8];
  __shared__ uint8_t s_av4[3 * 16], s_av8[4 * 4];
  __shared__ int W[17][25];                    // luma window
  __shared__ int sv8[25];                      // I8 filtered references
  __shared__ int craw[2][17];                  // chroma aprons
  __shared__ int s_ticket;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < (int)sizeof(s_tap4) / 16; i += kThreads)
    ((uint4*)s_tap4)[i] = __ldg((const uint4*)tap4 + i);
  for (int i = t; i < (int)sizeof(s_tap8) / 16; i += kThreads)
    ((uint4*)s_tap8)[i] = __ldg((const uint4*)tap8 + i);
  if (t < 48) s_av4[t] = avail4[t];
  else s_av8[t - 48] = avail8[t - 48];

  const int mb_w = P.mb_w, mb_h = P.mb_h;
  const int Wd = 16 * mb_w, Hd = 16 * mb_h, Wc = 8 * mb_w, Hc = 8 * mb_h;
  int* const flags = sched + 1;
  for (;;) {
    const int task = claim_ticket(sched, &s_ticket);
    if (task >= P.F * mb_h) break;
    const int my = task / P.F, f = task % P.F;
    int* const row_flag = flags + f * mb_h + my;
    const size_t mb0 = ((size_t)f * mb_h + my) * mb_w;
    uint8_t* const Y = P.y + (size_t)f * Hd * Wd;
    uint8_t* const C[2] = {P.cb + (size_t)f * Hc * Wc,
                           P.cr + (size_t)f * Hc * Wc};
    // the row above: row y0-1 of the planes, or on a band's first MB row
    // the halo (nothing when there is neither)
    const uint8_t* const above_y =
        my > 0 ? Y + (size_t)(16 * my - 1) * Wd
               : (P.hy ? P.hy + (size_t)f * Wd : nullptr);
    const uint8_t* const above_c[2] = {
        my > 0 ? C[0] + (size_t)(8 * my - 1) * Wc
               : (P.hc ? P.hc + (size_t)f * 2 * Wc : nullptr),
        my > 0 ? C[1] + (size_t)(8 * my - 1) * Wc
               : (P.hc ? P.hc + ((size_t)f * 2 + 1) * Wc : nullptr)};

    prefetch(&in[0], meta, yres, cres, mb0, t);
    cp_async_commit();
    int seen = 0;  // thread 0: last value seen of the flag of the row above
    for (int mx = 0; mx < mb_w; ++mx) {
      if (mx + 1 < mb_w)
        prefetch(&in[(mx + 1) & 1], meta, yres, cres, mb0 + mx + 1, t);
      cp_async_commit();
      // the wait rule: row y-1 finished up to the above-right MB
      if (t == 0 && my > 0) {
        const int need = mx + 2 < mb_w ? mx + 2 : mb_w;
        if (seen < need) seen = wait_flag(row_flag - 1, need);
      }
      cp_async_wait_prior();  // this MB's inputs have landed ...
      __syncthreads();        // ... for every thread; the row above is ready
      const MbIn& cur = in[mx & 1];
      if (warp == 0)
        luma_mb(lane, cur, W, sv8, s_tap4, s_tap8, s_av4, s_av8, above_y, Y,
                Wd, mx, 16 * my);
      else
        chroma_mb(lane, cur, craw, above_c, C, Wc, mx, 8 * my);
      __syncthreads();  // the MB's samples are written
      if (t == 0) raise_flag(row_flag, mx + 1);
    }
  }
}

}  // namespace

DT_EXPORT int dt_intra_wavefront(const void* meta, const void* yres,
                                 const void* cres, const void* tap4,
                                 const void* tap8, const void* avail4,
                                 const void* avail8, void* y, void* cb,
                                 void* cr, const void* hy, const void* hc,
                                 void* sched, int mb_w, int mb_h, int F,
                                 void* stream) {
  Planes P{(uint8_t*)y, (uint8_t*)cb, (uint8_t*)cr, (const uint8_t*)hy,
           (const uint8_t*)hc, mb_w, mb_h, F};
  cudaError_t err = cudaSuccess;
  const int grid = persistent_grid(intra_rows_kernel, kThreads, F * mb_h,
                                   &err);
  if (err != cudaSuccess) return (int)err;
  intra_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)meta, (const int16_t*)yres, (const int16_t*)cres,
      (const uint8_t*)tap4, (const uint8_t*)tap8, (const uint8_t*)avail4,
      (const uint8_t*)avail8, P, (int*)sched);
  return (int)cudaGetLastError();
}
