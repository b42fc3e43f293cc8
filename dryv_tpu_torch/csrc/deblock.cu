// Kernel B3: the spec 8.7 in-loop filter of all-intra 4:2:0 pictures.
//
// Replaces the Pallas kernel _build_db_kernel / make_deblock_pallas
// (dryv_tpu/kernels/pallas_deblock.py).  The TPU carries the last two
// diagonals' tiles in VMEM and emits finished tiles two diagonals late,
// with permutation matmuls between row- and column-major layouts.  Here
// the finished recon planes are filtered in place: the host issues one
// launch per anti-diagonal d = x + 2y, one block per (MB, frame).  MB
// (x, y) writes its own samples, the left MB's columns 13..15 and the
// above MB's rows 13..15; no two MBs of one diagonal touch a common
// sample, and every sample an MB reads was finished by an earlier
// diagonal, so the result is the spec's MB-raster result.
//
// A block is one warp: lanes 0..15 own a luma line, lanes 16..31 a
// chroma line (8 per plane).  Vertical edges run first (left to right,
// one line per lane), then after __syncthreads the horizontal edges
// (top to bottom, one column per lane).  Edge parameters (bS, alpha,
// beta, tC0) come precomputed as one 192-byte row per MB.
// What bounds it: latency, as for B2: 254 dependent launches at 1080p,
// each as long as one block's 8 sequential edge passes; an MB moves well
// under 1 KB.
#include "common.cuh"

namespace {

constexpr int kPrm = 192;
// byte offsets of the PRE_KEYS rows inside an MB's parameter row
constexpr int kBsv = 0, kTc0v = 16, kAv = 32, kBv = 36;
constexpr int kBsh = 40, kTc0h = 56, kAh = 72, kBh = 76;
constexpr int kBscv = 80, kTc0cv = 96, kAcv = 128, kBcv = 132;
constexpr int kBsch = 136, kTc0ch = 152, kAch = 184, kBch = 188;

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// one luma line across an edge; q points at q0, p samples at -step..
__device__ void filter_luma(uint8_t* q, int step, int bs, int alpha,
                            int beta, int tc0) {
  const int p0 = q[-step], p1 = q[-2 * step], p2 = q[-3 * step],
            p3 = q[-4 * step];
  const int q0 = q[0], q1 = q[step], q2 = q[2 * step], q3 = q[3 * step];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta &&
        iabs(q1 - q0) < beta))
    return;
  const bool ap = iabs(p2 - p0) < beta, aq = iabs(q2 - q0) < beta;
  if (bs == 4) {
    const bool strong = iabs(p0 - q0) < (alpha >> 2) + 2;
    if (ap && strong) {
      q[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
      q[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
      q[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
    } else {
      q[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    }
    if (aq && strong) {
      q[0] = (uint8_t)((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
      q[step] = (uint8_t)((q2 + q1 + q0 + p0 + 2) >> 2);
      q[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
    } else {
      q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    }
  } else {
    const int tc = tc0 + ap + aq;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    const int avg = (p0 + q0 + 1) >> 1;
    q[-step] = (uint8_t)clip3(0, 255, p0 + delta);
    q[0] = (uint8_t)clip3(0, 255, q0 - delta);
    if (ap) q[-2 * step] = (uint8_t)(p1 + clip3(-tc0, tc0, (p2 + avg - 2 * p1) >> 1));
    if (aq) q[step] = (uint8_t)(q1 + clip3(-tc0, tc0, (q2 + avg - 2 * q1) >> 1));
  }
}

__device__ void filter_chroma(uint8_t* q, int step, int bs, int alpha,
                              int beta, int tc0) {
  const int p0 = q[-step], p1 = q[-2 * step], q0 = q[0], q1 = q[step];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta &&
        iabs(q1 - q0) < beta))
    return;
  if (bs == 4) {
    q[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  } else {
    const int tc = tc0 + 1;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    q[-step] = (uint8_t)clip3(0, 255, p0 + delta);
    q[0] = (uint8_t)clip3(0, 255, q0 - delta);
  }
}

__global__ void __launch_bounds__(32)
deblock_diag_kernel(const uint8_t* __restrict__ prm, uint8_t* y,
                    uint8_t* cb, uint8_t* cr, int mb_w, int mb_h, int d,
                    int y_first) {
  __shared__ uint8_t s[kPrm];
  const int t = threadIdx.x;
  const int my = y_first + blockIdx.x;
  const int mx = d - 2 * my;
  const int f = blockIdx.y;
  const int n = mb_w * mb_h;
  const uint8_t* P = prm + ((size_t)f * n + my * mb_w + mx) * kPrm;
  for (int i = t; i < kPrm; i += 32) s[i] = P[i];
  __syncthreads();

  const int Wd = 16 * mb_w, Hd = 16 * mb_h;
  const int Wc = 8 * mb_w, Hc = 8 * mb_h;
  uint8_t* Y = y + (size_t)f * Hd * Wd;
  const int x0 = 16 * mx, y0 = 16 * my;
  const int cx0 = 8 * mx, cy0 = 8 * my;
  const int p = (t - 16) >> 3, li = (t - 16) & 7;  // chroma lanes
  uint8_t* C = (t >= 16) ? (p ? cr : cb) + (size_t)f * Hc * Wc : nullptr;

  // vertical edges, left to right; edge 0 needs a left MB
  if (t < 16) {
    uint8_t* row = Y + (size_t)(y0 + t) * Wd + x0;
    for (int e = (mx > 0 ? 0 : 1); e < 4; ++e) {
      const int bs = s[kBsv + 4 * e + (t >> 2)];
      if (bs > 0)
        filter_luma(row + 4 * e, 1, bs, s[kAv + e], s[kBv + e],
                    s[kTc0v + 4 * e + (t >> 2)]);
    }
  } else {
    uint8_t* row = C + (size_t)(cy0 + li) * Wc + cx0;
    for (int e = (mx > 0 ? 0 : 1); e < 2; ++e) {
      const int bs = s[kBscv + 8 * e + li];
      if (bs > 0)
        filter_chroma(row + 4 * e, 1, bs, s[kAcv + 2 * e + p],
                      s[kBcv + 2 * e + p], s[kTc0cv + 16 * e + 8 * p + li]);
    }
  }
  __syncthreads();
  // horizontal edges, top to bottom; edge 0 needs an above MB
  if (t < 16) {
    uint8_t* col = Y + (size_t)y0 * Wd + x0 + t;
    for (int e = (my > 0 ? 0 : 1); e < 4; ++e) {
      const int bs = s[kBsh + 4 * e + (t >> 2)];
      if (bs > 0)
        filter_luma(col + (size_t)4 * e * Wd, Wd, bs, s[kAh + e], s[kBh + e],
                    s[kTc0h + 4 * e + (t >> 2)]);
    }
  } else {
    uint8_t* col = C + (size_t)cy0 * Wc + cx0 + li;
    for (int e = (my > 0 ? 0 : 1); e < 2; ++e) {
      const int bs = s[kBsch + 8 * e + li];
      if (bs > 0)
        filter_chroma(col + (size_t)4 * e * Wc, Wc, bs, s[kAch + 2 * e + p],
                      s[kBch + 2 * e + p], s[kTc0ch + 16 * e + 8 * p + li]);
    }
  }
}

}  // namespace

DT_EXPORT int dt_deblock(const void* prm, void* y, void* cb, void* cr,
                         int mb_w, int mb_h, int F, void* stream) {
  const int n_diag = mb_w + 2 * (mb_h - 1);
  for (int d = 0; d < n_diag; ++d) {
    DiagRange r = diag_range(d, mb_w, mb_h);
    deblock_diag_kernel<<<dim3(r.n, F), 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)prm, (uint8_t*)y, (uint8_t*)cb, (uint8_t*)cr, mb_w,
        mb_h, d, r.y0);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
