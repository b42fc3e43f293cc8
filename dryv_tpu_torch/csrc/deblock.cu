// Kernel B3: the spec 8.7 in-loop filter of all-intra 4:2:0 pictures.
//
// Replaces the Pallas kernel _build_db_kernel / make_deblock_pallas
// (dryv_tpu/kernels/pallas_deblock.py).  The TPU carries the last two
// diagonals' tiles in VMEM and emits finished tiles two diagonals late,
// with permutation matmuls between row- and column-major layouts.  Here
// the finished recon planes are filtered in place by ONE persistent
// launch per call (row_sched.cuh): each one-warp block takes tickets for
// (frame, MB row, luma or chroma) and walks its row left to right.  Luma
// and chroma never read each other's samples, so they are separate
// tasks with separate progress flags.
//
// Filtering MB (x, y) changes its own samples, the left MB's columns
// 13..15 (chroma: 7) and the above MB's rows 13..15 (chroma: 7), and
// reads the above MB's rows 12..15, whose columns 13..15 (x+1, y-1)'s
// vertical edge 0 changes.  So the wait rule is B2's: row y-1 of the same
// frame and plane finished up to min(x + 2, mb_w) MBs.  The same rule
// keeps row y+1 from writing rows 13..15 of (x, y) before (x+1, y) has
// read them.  The left strip is the MB this warp finished just before.
//
// One MB step, one warp, __syncwarp only:
// - vertical edges first, before the wait (they read no sample of the
//   row above): lane r holds line r of the window (4 left + 16 own luma
//   samples, 4 + 8 chroma) in registers and filters its edges in order;
// - wait for the row above, read its 4 (chroma: 2) bottom rows through
//   L2 (__ldcg: another block wrote them in this launch) into the window
//   in shared memory;
// - horizontal edges: lane c holds column c of the window in registers;
// - store the own MB (16-byte rows; chroma 8), the left strip and the
//   above strip, then raise the row's flag (__syncwarp, then one release
//   store).
// The own samples (written by B2 in an earlier launch, changed by no one
// before this MB) and the 192-byte parameter row of the next MB arrive by
// cp.async into a double buffer while the current MB is filtered.  The
// left strip never leaves the warp: it is the previous MB's last word of
// each row.  Window rows are 20 (chroma 12) bytes, an odd number of
// words, so a lane-per-row walk touches every bank once.
//
// What bounds it: latency, as for B2.  The critical path is mb_w +
// 2 (mb_h - 1) MB steps (254 at 1080p), each one flag hand-off through L2
// plus the MB's horizontal edges and stores; an MB moves under 1 KB.
#include "row_sched.cuh"

namespace {

constexpr int kPrm = 192;
// byte offsets of the PRE_KEYS rows inside an MB's parameter row
constexpr int kBsv = 0, kTc0v = 16, kAv = 32, kBv = 36;
constexpr int kBsh = 40, kTc0h = 56, kAh = 72, kBh = 76;
constexpr int kBscv = 80, kTc0cv = 96, kAcv = 128, kBcv = 132;
constexpr int kBsch = 136, kTc0ch = 152, kAch = 184, kBch = 188;

constexpr int kLs = 20;  // luma window row: cols -4..15, 5 words
constexpr int kCs = 12;  // chroma window row: cols -4..7 (-4, -3 unused)
constexpr int kCrows = 10;  // chroma window rows -2..7, per plane
constexpr int kWin = 20 * kLs;  // >= 2 * kCrows * kCs

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

__device__ __forceinline__ void unpack4(uint32_t w, int* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = (w >> (8 * k)) & 0xff;
}

__device__ __forceinline__ uint32_t pack4(const int* v) {
  return (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16) |
         ((uint32_t)v[3] << 24);
}

// one luma line across an edge, in registers: v[Q] is q0, v[Q-4..Q+3]
// are p3..q3
template <int Q>
__device__ __forceinline__ void luma_edge(int* v, int bs, int alpha,
                                          int beta, int tc0) {
  const int p0 = v[Q - 1], p1 = v[Q - 2], p2 = v[Q - 3], p3 = v[Q - 4];
  const int q0 = v[Q], q1 = v[Q + 1], q2 = v[Q + 2], q3 = v[Q + 3];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta &&
        iabs(q1 - q0) < beta))
    return;
  const bool ap = iabs(p2 - p0) < beta, aq = iabs(q2 - q0) < beta;
  if (bs == 4) {
    const bool strong = iabs(p0 - q0) < (alpha >> 2) + 2;
    if (ap && strong) {
      v[Q - 1] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      v[Q - 2] = (p2 + p1 + p0 + q0 + 2) >> 2;
      v[Q - 3] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      v[Q - 1] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (aq && strong) {
      v[Q] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
      v[Q + 1] = (q2 + q1 + q0 + p0 + 2) >> 2;
      v[Q + 2] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      v[Q] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
  } else {
    const int tc = tc0 + ap + aq;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    const int avg = (p0 + q0 + 1) >> 1;
    v[Q - 1] = clip3(0, 255, p0 + delta);
    v[Q] = clip3(0, 255, q0 - delta);
    if (ap) v[Q - 2] = p1 + clip3(-tc0, tc0, (p2 + avg - 2 * p1) >> 1);
    if (aq) v[Q + 1] = q1 + clip3(-tc0, tc0, (q2 + avg - 2 * q1) >> 1);
  }
}

// one chroma line across an edge: v[Q] is q0, v[Q-2..Q+1] are p1..q1
template <int Q>
__device__ __forceinline__ void chroma_edge(int* v, int bs, int alpha,
                                            int beta, int tc0) {
  const int p1 = v[Q - 2], p0 = v[Q - 1], q0 = v[Q], q1 = v[Q + 1];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta &&
        iabs(q1 - q0) < beta))
    return;
  if (bs == 4) {
    v[Q - 1] = (2 * p1 + p0 + q1 + 2) >> 2;
    v[Q] = (2 * q1 + q0 + p1 + 2) >> 2;
  } else {
    const int tc = tc0 + 1;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    v[Q - 1] = clip3(0, 255, p0 + delta);
    v[Q] = clip3(0, 255, q0 - delta);
  }
}

// luma edges E..3 of a line (window index 4 + 4e is q0 of edge e);
// edge 0 only when the MB has a neighbour on that side
template <int E = 0>
__device__ __forceinline__ void luma_line(int* v, const uint8_t* s,
                                          bool edge0, int bs_at, int tc_at,
                                          int a_at, int b_at, int g) {
  if (E > 0 || edge0) {
    const int bs = s[bs_at + 4 * E + g];
    if (bs)
      luma_edge<4 + 4 * E>(v, bs, s[a_at + E], s[b_at + E],
                           s[tc_at + 4 * E + g]);
  }
  if constexpr (E < 3)
    luma_line<E + 1>(v, s, edge0, bs_at, tc_at, a_at, b_at, g);
}

// the two chroma edges of a line of plane p (q0 of edge e at Q0 + 4e)
template <int Q0>
__device__ __forceinline__ void chroma_line(int* v, const uint8_t* s,
                                            bool edge0, int bs_at, int tc_at,
                                            int a_at, int b_at, int p,
                                            int i) {
  if (edge0) {
    const int bs = s[bs_at + i];
    if (bs)
      chroma_edge<Q0>(v, bs, s[a_at + p], s[b_at + p], s[tc_at + 8 * p + i]);
  }
  const int bs = s[bs_at + 8 + i];
  if (bs)
    chroma_edge<Q0 + 4>(v, bs, s[a_at + 2 + p], s[b_at + 2 + p],
                        s[tc_at + 16 + 8 * p + i]);
}

struct __align__(16) Shared {
  uint8_t prm[2][kPrm];  // parameter rows of this MB and the next
  uint8_t own[2][256];   // own samples of this MB and the next
  uint8_t win[kWin];     // the MB's window
};

// Wait (lane 0) until the row above has finished `need` MBs.
__device__ __forceinline__ void wait_above(int lane, const int* flag,
                                           int need, int* seen) {
  if (lane == 0 && *seen < need) *seen = wait_flag(flag, need);
  __syncwarp();
}

// Publish that `done` MBs of the row are finished.  The warp barrier
// orders every lane's stores before lane 0's release store, and a
// release is cumulative (PTX memory model), so a block that acquires the
// flag sees them all; a __threadfence before it would only add a second
// fence to every MB step.
__device__ __forceinline__ void publish(int lane, int* flag, int done) {
  __syncwarp();
  if (lane == 0) st_release_gpu(flag, done);
}

// One row of luma MBs.  rows: row 0 of the MB row in the plane.
__device__ void luma_row(int lane, Shared& sh, const uint8_t* P,
                         uint8_t* rows, int Wd, int mb_w, int my,
                         int* row_flag) {
  auto prefetch = [&](int mx, int buf) {
    if (lane < 16)
      cp_async16(&sh.own[buf][16 * lane], rows + (size_t)lane * Wd + 16 * mx);
    else if (lane < 16 + kPrm / 16)
      cp_async16(&sh.prm[buf][16 * (lane - 16)],
                 P + (size_t)mx * kPrm + 16 * (lane - 16));
  };
  prefetch(0, 0);
  cp_async_commit();
  uint32_t left = 0;  // lane r: the previous MB's columns 12..15 of row r
  int seen = 0;
  for (int mx = 0; mx < mb_w; ++mx) {
    const int buf = mx & 1, x0 = 16 * mx;
    if (mx + 1 < mb_w) prefetch(mx + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncwarp();
    const uint8_t* s = sh.prm[buf];
    if (lane < 16) {  // vertical edges: lane r owns row r, cols -4..15
      int v[20];
      const uint4 o = ((const uint4*)sh.own[buf])[lane];
      unpack4(left, v);
      unpack4(o.x, v + 4);
      unpack4(o.y, v + 8);
      unpack4(o.z, v + 12);
      unpack4(o.w, v + 16);
      luma_line(v, s, mx > 0, kBsv, kTc0v, kAv, kBv, lane >> 2);
      uint32_t* w = (uint32_t*)(sh.win + (4 + lane) * kLs);
#pragma unroll
      for (int k = 0; k < 5; ++k) w[k] = pack4(v + 4 * k);
    }
    if (my > 0) {
      wait_above(lane, row_flag - 1, mx + 2 < mb_w ? mx + 2 : mb_w, &seen);
      if (lane < 4) {  // rows 12..15 of the MB above -> window rows 0..3
        const uint4 a = __ldcg((const uint4*)(rows - (size_t)(4 - lane) * Wd +
                                              x0));
        uint32_t* w = (uint32_t*)(sh.win + lane * kLs);
        w[1] = a.x;
        w[2] = a.y;
        w[3] = a.z;
        w[4] = a.w;
      }
    }
    __syncwarp();
    if (lane < 16) {  // horizontal edges: lane c owns column c, rows -4..15
      int v[20];
      uint8_t* col = sh.win + 4 + lane;
#pragma unroll
      for (int k = 0; k < 20; ++k) v[k] = col[k * kLs];
      luma_line(v, s, my > 0, kBsh, kTc0h, kAh, kBh, lane >> 2);
#pragma unroll
      for (int k = 1; k < 19; ++k) col[k * kLs] = (uint8_t)v[k];
    }
    __syncwarp();
    if (lane < 16) {  // own row `lane`, and the left MB's cols 12..15
      const uint32_t* w = (const uint32_t*)(sh.win + (4 + lane) * kLs);
      uint8_t* dst = rows + (size_t)lane * Wd + x0;
      *(uint4*)dst = make_uint4(w[1], w[2], w[3], w[4]);
      if (mx > 0) *(uint32_t*)(dst - 4) = w[0];
      left = w[4];
    } else if (lane < 19 && my > 0) {  // rows 13..15 of the MB above
      const int k = lane - 15;
      const uint32_t* w = (const uint32_t*)(sh.win + k * kLs);
      *(uint4*)(rows - (size_t)(4 - k) * Wd + x0) =
          make_uint4(w[1], w[2], w[3], w[4]);
    }
    publish(lane, row_flag, mx + 1);
  }
}

// One row of chroma MBs, both planes: lanes 0..7 Cb lines, 8..15 Cr.
// rows_cb, rows_cr: row 0 of the MB row in each plane.
__device__ void chroma_row(int lane, Shared& sh, const uint8_t* P,
                           uint8_t* rows_cb, uint8_t* rows_cr, int Wc,
                           int mb_w, int my, int* row_flag) {
  const int p = (lane >> 3) & 1, i = lane & 7;
  uint8_t* const rows = p ? rows_cr : rows_cb;  // this lane's plane
  auto prefetch = [&](int mx, int buf) {
    if (lane < 16)
      cp_async8(&sh.own[buf][8 * lane], rows + (size_t)i * Wc + 8 * mx);
    else if (lane < 16 + kPrm / 16)
      cp_async16(&sh.prm[buf][16 * (lane - 16)],
                 P + (size_t)mx * kPrm + 16 * (lane - 16));
  };
  prefetch(0, 0);
  cp_async_commit();
  uint32_t left = 0;  // lane: the previous MB's columns 4..7 of its line
  int seen = 0;
  for (int mx = 0; mx < mb_w; ++mx) {
    const int buf = mx & 1, x0 = 8 * mx;
    if (mx + 1 < mb_w) prefetch(mx + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncwarp();
    const uint8_t* s = sh.prm[buf];
    if (lane < 16) {  // vertical edges: line i of plane p, cols -4..7
      int v[12];
      const uint2 o = ((const uint2*)sh.own[buf])[lane];
      unpack4(left, v);
      unpack4(o.x, v + 4);
      unpack4(o.y, v + 8);
      chroma_line<4>(v, s, mx > 0, kBscv, kTc0cv, kAcv, kBcv, p, i);
      uint32_t* w = (uint32_t*)(sh.win + (p * kCrows + 2 + i) * kCs);
#pragma unroll
      for (int k = 0; k < 3; ++k) w[k] = pack4(v + 4 * k);
    }
    if (my > 0) {
      wait_above(lane, row_flag - 1, mx + 2 < mb_w ? mx + 2 : mb_w, &seen);
      if (lane < 4) {  // rows 6..7 of the MB above -> window rows 0..1
        const int q = lane >> 1, k = lane & 1;
        const uint2 a = __ldcg((const uint2*)((q ? rows_cr : rows_cb) -
                                              (size_t)(2 - k) * Wc + x0));
        uint32_t* w = (uint32_t*)(sh.win + (q * kCrows + k) * kCs);
        w[1] = a.x;
        w[2] = a.y;
      }
    }
    __syncwarp();
    if (lane < 16) {  // horizontal edges: column i of plane p, rows -2..7
      int v[kCrows];
      uint8_t* col = sh.win + p * kCrows * kCs + 4 + i;
#pragma unroll
      for (int k = 0; k < kCrows; ++k) v[k] = col[k * kCs];
      chroma_line<2>(v, s, my > 0, kBsch, kTc0ch, kAch, kBch, p, i);
      // only p0/q0 change: rows -1, 0 (edge 0) and 3, 4 (edge 1)
      col[1 * kCs] = (uint8_t)v[1];
      col[2 * kCs] = (uint8_t)v[2];
      col[5 * kCs] = (uint8_t)v[5];
      col[6 * kCs] = (uint8_t)v[6];
    }
    __syncwarp();
    if (lane < 16) {  // own line, and the left MB's cols 4..7
      const uint32_t* w =
          (const uint32_t*)(sh.win + (p * kCrows + 2 + i) * kCs);
      uint8_t* dst = rows + (size_t)i * Wc + x0;
      *(uint2*)dst = make_uint2(w[1], w[2]);
      if (mx > 0) *(uint32_t*)(dst - 4) = w[0];
      left = w[2];
    } else if (lane < 18 && my > 0) {  // row 7 of the MB above
      const int q = lane - 16;
      const uint32_t* w = (const uint32_t*)(sh.win + (q * kCrows + 1) * kCs);
      *(uint2*)((q ? rows_cr : rows_cb) - (size_t)Wc + x0) =
          make_uint2(w[1], w[2]);
    }
    publish(lane, row_flag, mx + 1);
  }
}

__global__ void __launch_bounds__(32)
deblock_rows_kernel(const uint8_t* __restrict__ prm, uint8_t* y,
                    uint8_t* cb, uint8_t* cr, int mb_w, int mb_h, int F,
                    int* __restrict__ sched) {
  __shared__ Shared sh;
  __shared__ int s_ticket;
  const int lane = threadIdx.x;
  const int Wd = 16 * mb_w, Hd = 16 * mb_h, Wc = 8 * mb_w, Hc = 8 * mb_h;
  // flags: luma rows of every frame, then chroma rows
  int* const flags = sched + 1;
  for (;;) {
    // ticket t: part t & 1 (0 luma, 1 chroma) of MB row (t >> 1) / F of
    // frame (t >> 1) % F, so row 0 of every frame and part comes first
    const int task = claim_ticket(sched, &s_ticket);
    if (task >= 2 * F * mb_h) break;
    const int part = task & 1, my = (task >> 1) / F, f = (task >> 1) % F;
    int* const row_flag = flags + (part * F + f) * mb_h + my;
    const uint8_t* const P = prm + ((size_t)f * mb_h + my) * mb_w * kPrm;
    if (part == 0) {
      luma_row(lane, sh, P, y + ((size_t)f * Hd + 16 * my) * Wd, Wd, mb_w,
               my, row_flag);
    } else {
      const size_t at = ((size_t)f * Hc + 8 * my) * Wc;
      chroma_row(lane, sh, P, cb + at, cr + at, Wc, mb_w, my, row_flag);
    }
  }
}

}  // namespace

DT_EXPORT int dt_deblock(const void* prm, void* y, void* cb, void* cr,
                         void* sched, int mb_w, int mb_h, int F,
                         void* stream) {
  cudaError_t err = cudaSuccess;
  const int grid = persistent_grid(deblock_rows_kernel, 32, 2 * F * mb_h,
                                   &err);
  if (err != cudaSuccess) return (int)err;
  deblock_rows_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)prm, (uint8_t*)y, (uint8_t*)cb, (uint8_t*)cr, mb_w,
      mb_h, F, (int*)sched);
  return (int)cudaGetLastError();
}
