// Kernel B4: motion-compensated prediction (spec 8.4.2) of every
// macroblock of a picture.
//
// The JAX package has no Pallas kernel here: dryv_tpu/kernels/inter.py
// mc_frame (:146) runs as an XLA gather of a 9x9 window per 4x4 block.
// This kernel computes what mc_frame + wp_combine compute, with the
// weighted-prediction resolve (resolve_wp_blocks_jax, :199) folded in,
// bit-exact.
//
// Bound: on real pictures, the bytes it must move (predictions out,
// motion field in, each used list's reference area once), 2-3 µs at
// 1080p; the stack of reference pictures sits in the 50 MB L2 (3.1 MB a
// picture).  What holds the kernel at that size is the instructions a
// warp issues and the round trips it waits on: a kernel that only writes
// the predictions' bytes already takes 1.5x the bound.  Staging each
// partition's window once in shared memory, the first design tried, cost
// more instructions than the samples it saved.
//
// Design: a warp holds two macroblocks and one list, a lane one 4x4
// block (lane & 15) of MB lane / 16, so that a partition's blocks share a
// warp; a B picture gives each MB pair two warps, list 0's and list 1's,
// so that a block's two predictions are computed side by side and not
// one after the other (on small pictures, with fewer warps than the
// card's schedulers, a warp's chain of work is the kernel's time).  Each
// lane reads its block's fields; the CTA stages the picture's
// weighted-prediction table (explicit or implicit) in shared memory in
// the same round trip; a pair whose blocks use no list (intra MBs)
// computes nothing and writes zero tiles.  Control flow is uniform
// across the warp, so that no lane waits on another's path: a warp whose
// blocks are all full-pel in its list copies 4 rows of words; any other
// computes the union of what its blocks' phases need (the horizontal
// 6-tap sums of 5 rows for b, of 9 rows for j; the vertical 6-tap of 9
// rows for h, a column right where fx == 3) and each lane picks its
// sample by Table 8-12 with selects.  A lane reads its rows as aligned
// 4-byte words through L1 and shifts them into place, all of a block's
// rows in one round trip (chroma first), a row above or below the plane
// clamped into it; a warp with a window that crosses the left or right
// edge reads every lane's samples one by one, clamped (the same result
// inside the plane).  Then the eighth-pel bilinear chroma of the block's
// two 2x2 blocks.  List 1's warp leaves its predictions in shared
// memory; list 0's combines (8.4.2.3) per lane, its weights from the
// staged table (without weighted prediction on packed bytes).  The
// predictions, clipped to 0..255, go into the pair's MB tiles in shared
// memory, and the warp writes its two MBs as whole rows: 16 bytes a lane
// of luma, 8 of chroma, uint8 in MB-tile layout.  Blocks that use no
// list predict 0.  A list a block does not use reads slot 0 at (2, 2),
// so that no lane branches around its loads.
//
// The per-block fields are read in place from the packed wire: int16
// vectors (x, y) at a block stride of mv_stride elements, int8 slots and
// reference indices at rs_stride.  NL (lists) and MODE (weighted
// prediction) are template parameters: a P picture (NL = 1) reads
// nothing of list 1.  row0 offsets the block rows inside the planes, so
// banded P recon runs the kernel on its extended band plane.  The planes
// start on 4-byte boundaries and W is a multiple of 16 (the wrapper
// checks), so a plane row's words are aligned.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;       // warps a CTA, two MBs and a list a warp
constexpr unsigned kFull = 0xffffffffu;

// per MB pair: the predictions of its two MBs in MB-tile layout
struct WarpSmem {
  alignas(16) uint8_t tile_y[2][256];
  alignas(16) uint8_t tile_c[2][128];
};

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e,
                                    int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}
__device__ __forceinline__ int clip255(int v) { return clip3(0, 255, v); }
__device__ __forceinline__ int avg2(int a, int b) { return (a + b + 1) >> 1; }
__device__ __forceinline__ int byte_of(uint32_t w, int i) {
  return __byte_perm(w, 0u, 0x4440u | i);
}
__device__ __forceinline__ int byte_in(const uint32_t* w, int i) {
  return byte_of(w[i >> 2], i & 3);
}
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)a | (uint32_t)b << 8 | (uint32_t)c << 16 |
         (uint32_t)d << 24;
}

// Samples x .. x + NEED - 1 of plane row y (clamped into the plane) as
// N = ceil(NEED / 4) words, sample i in byte i % 4 of word i / 4.  IN
// (the columns lie in the plane): the aligned words that hold them,
// shifted into place; else sample by sample, each column clamped.  IN is
// a template parameter so that a block's rows hold no branch and their
// loads go out together.
template <int NEED, bool IN>
struct Row {
  static constexpr int N = (NEED + 3) / 4;
  uint32_t w[N];
  __device__ __forceinline__ Row(const uint8_t* __restrict__ plane, int H,
                                 int W, int y, int x) {
    if (IN) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(
          plane + (size_t)clip3(0, H - 1, y) * W + (x & ~3));
      const int s = x & 3, words = (s + NEED + 3) >> 2;
      uint32_t v[N + 1];
#pragma unroll
      for (int k = 0; k <= N; ++k) v[k] = k < words ? __ldg(p + k) : 0u;
#pragma unroll
      for (int k = 0; k < N; ++k)
        w[k] = __funnelshift_r(v[k], v[k + 1], 8 * s);
      return;
    }
    const uint8_t* row = plane + (size_t)clip3(0, H - 1, y) * W;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      uint32_t v = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * k + t < NEED)
          v |= (uint32_t)__ldg(row + clip3(0, W - 1, x + 4 * k + t))
               << (8 * t);
      w[k] = v;
    }
  }
  __device__ __forceinline__ int operator[](int i) const {
    return byte_of(w[i >> 2], i & 3);
  }
};

// What the phases of a warp's blocks need (8.4.2.2.1, Table 8-12): the
// horizontal sums of 5 rows (b), of 9 rows (j), the vertical 6-tap of 9
// rows (h)
struct Needs {
  bool b, h, j;
};

// The horizontal 6-tap sums of rows y - 2 + t, t = T0 .. T1 - 1, at the
// block's 4 columns (from samples x - 2 .. x + 6): rows 2 .. 6 into bs,
// with the full samples g (x .. x + 3) and s (x + 1 .. x + 4) of rows
// 2 .. 6 and 2 .. 5 as words; and, for j, the vertical 6-tap of them.
template <bool IN, int T0, int T1, bool J>
__device__ __forceinline__ void hsum_rows(const uint8_t* __restrict__ plane,
                                          int H, int W, int x, int y,
                                          uint32_t (&g)[5], uint32_t (&s)[4],
                                          int (&bs)[5][4], int (&ja)[4][4]) {
  constexpr int c[6] = {1, -5, 20, 20, -5, 1};
  uint32_t e[T1 - T0][3];
#pragma unroll
  for (int t = T0; t < T1; ++t) {
    const Row<9, IN> row(plane, H, W, y - 2 + t, x - 2);
#pragma unroll
    for (int i = 0; i < 3; ++i) e[t - T0][i] = row.w[i];
  }
#pragma unroll
  for (int t = T0; t < T1; ++t) {
    const uint32_t* w = e[t - T0];
    int sum[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sum[k] = tap6(byte_in(w, k), byte_in(w, k + 1), byte_in(w, k + 2),
                    byte_in(w, k + 3), byte_in(w, k + 4), byte_in(w, k + 5));
    if (t >= 2 && t <= 6) {
#pragma unroll
      for (int k = 0; k < 4; ++k) bs[t - 2][k] = sum[k];
      g[t - 2] = __funnelshift_r(w[0], w[1], 16);
      if (t <= 5) s[t - 2] = __funnelshift_r(w[0], w[1], 24);
    }
    if (J)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (t - r >= 0 && t - r < 6)
#pragma unroll
          for (int k = 0; k < 4; ++k) ja[r][k] += c[t - r] * sum[k];
  }
}

// The quarter-pel luma prediction (8.4.2.2.1) of a 4x4 block whose
// full-sample position, the vector's integer part included, is (x, y),
// at phase (fx, fy), computing what the warp's phases need.  Rows packed
// 4 samples a word.
template <bool IN>
__device__ __forceinline__ void luma_block(
    const uint8_t* __restrict__ plane, int H, int W, int x, int y, int fx,
    int fy, Needs nd, uint32_t (&out)[4]) {
  uint32_t g[5] = {}, s[4] = {}, hp[4] = {};
  int bs[5][4] = {}, ja[4][4] = {};
  if (nd.h) {
    uint32_t rows[9];
#pragma unroll
    for (int t = 0; t < 9; ++t)
      rows[t] = Row<4, IN>(plane, H, W, y - 2 + t, x + (fx == 3)).w[0];
    constexpr int c[6] = {1, -5, 20, 20, -5, 1};
    int acc[4][4] = {};
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (t - r >= 0 && t - r < 6)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[r][k] += c[t - r] * byte_of(rows[t], k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      hp[r] = pack4(clip255((acc[r][0] + 16) >> 5),
                    clip255((acc[r][1] + 16) >> 5),
                    clip255((acc[r][2] + 16) >> 5),
                    clip255((acc[r][3] + 16) >> 5));
    // the full samples, where no block needs b or j (all have fx == 0)
#pragma unroll
    for (int r = 0; r < 5; ++r) g[r] = rows[r + 2];
  }
  if (nd.j)
    hsum_rows<IN, 0, 9, true>(plane, H, W, x, y, g, s, bs, ja);
  else if (nd.b)
    hsum_rows<IN, 2, 7, false>(plane, H, W, x, y, g, s, bs, ja);
  int v[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int G = byte_of(g[r], k), h = byte_of(hp[r], k);
      const int bC = clip255((bs[r][k] + 16) >> 5);
      const int bD = clip255((bs[r + 1][k] + 16) >> 5);
      const int j = clip255((ja[r][k] + 512) >> 10);
      const int b = fy == 3 ? bD : bC;
      int p;
      if (fy == 0)
        p = fx == 0 ? G : fx == 2 ? bC
                    : avg2(bC, fx == 1 ? G : byte_of(s[r], k));
      else if (fy == 2)
        p = fx == 0 ? h : fx == 2 ? j : avg2(h, j);
      else
        p = fx == 0 ? avg2(h, fy == 1 ? G : byte_of(g[r + 1], k))
            : fx == 2 ? avg2(b, j) : avg2(b, h);
      v[r][k] = p;
    }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    out[r] = pack4(v[r][0], v[r][1], v[r][2], v[r][3]);
}

// The eighth-pel chroma prediction (8.4.2.2.2) of a 2x2 block from its
// rows r0 .. r2 (3 samples each), phase (fx, fy): rows in bytes 0-1 and
// 2-3
__device__ __forceinline__ uint32_t chroma_block(uint32_t r0, uint32_t r1,
                                                 uint32_t r2, int fx,
                                                 int fy) {
  const int a = (8 - fx) * (8 - fy), b = fx * (8 - fy), c = (8 - fx) * fy,
            d = fx * fy;
  const int r[3][3] = {{byte_of(r0, 0), byte_of(r0, 1), byte_of(r0, 2)},
                       {byte_of(r1, 0), byte_of(r1, 1), byte_of(r1, 2)},
                       {byte_of(r2, 0), byte_of(r2, 1), byte_of(r2, 2)}};
  int v[4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      v[2 * i + j] = (a * r[i][j] + b * r[i][j + 1] + c * r[i + 1][j] +
                      d * r[i + 1][j + 1] + 32) >> 6;
  return pack4(v[0], v[1], v[2], v[3]);
}

// One list's prediction of a lane's block: luma at full-sample position
// (x, y), chroma (cb, cr) at (cx, cy), vector (mvx, mvy); `copy`: every
// block of the warp is full-pel.  The chroma rows are read first, so
// that all of the block's loads go out together.
template <bool IN>
__device__ __forceinline__ void predict(
    const uint8_t* __restrict__ py, const uint8_t* __restrict__ pcb,
    const uint8_t* __restrict__ pcr, int H, int W, int x, int y, int cx,
    int cy, int mvx, int mvy, bool copy, Needs nd, uint32_t (&ly)[4],
    uint32_t (&lc)[2]) {
  const int Hc = H >> 1, Wc = W >> 1;
  uint32_t c[2][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    c[0][r] = Row<3, IN>(pcb, Hc, Wc, cy + r, cx).w[0];
    c[1][r] = Row<3, IN>(pcr, Hc, Wc, cy + r, cx).w[0];
  }
  if (copy) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      ly[r] = Row<4, IN>(py, H, W, y + r, x).w[0];
  } else {
    luma_block<IN>(py, H, W, x, y, mvx & 3, mvy & 3, nd, ly);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p)
    lc[p] = chroma_block(c[p][0], c[p][1], c[p][2], mvx & 7, mvy & 7);
}

struct Wp {
  int w0, o0, w1, o1, d;
};

// 8.4.2.3 combine (wp_combine) of 4 packed samples: bi-predicted, or
// single from the list used; 0 for a block that uses no list
template <int MODE>
__device__ __forceinline__ uint32_t combine(uint32_t p0, uint32_t p1,
                                            bool u0, bool u1, const Wp& q) {
  if (!u0 && !u1) return 0u;
  if constexpr (MODE == 0) {
    return u0 && u1 ? __vavgu4(p0, p1) : u0 ? p0 : p1;
  } else {
    int v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int a = byte_of(p0, k), c = byte_of(p1, k);
      v[k] = clip255(u0 && u1 ? ((a * q.w0 + c * q.w1 + (1 << q.d)) >>
                                 (q.d + 1)) + ((q.o0 + q.o1 + 1) >> 1)
                              : (((u0 ? a * q.w0 : c * q.w1) +
                                  ((1 << q.d) >> 1)) >> q.d) +
                                    (u0 ? q.o0 : q.o1));
    }
    return pack4(v[0], v[1], v[2], v[3]);
  }
}

template <int NL, int MODE>
__global__ void __launch_bounds__(32 * kWarps, 4)
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
                int mb_h, int row0, int mv_stride, int rs_stride) {
  // the picture's weighted-prediction table: explicit [2][32][6] or
  // implicit [256][2]
  constexpr int kTab = MODE == 1 ? 2 * 32 * 6 : MODE == 2 ? 256 * 2 : 2;
  constexpr int kPairs = kWarps / NL;     // MB pairs a CTA
  __shared__ int16_t s_tab[kTab];
  __shared__ WarpSmem smem[kPairs];
  // list 1's predictions of each pair's blocks: 4 luma words, then cb
  // and cr, a lane's word in column lane
  __shared__ uint32_t s_l1[NL == 2 ? kPairs : 1][6][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp / NL, l = warp % NL;   // the warp's MBs and list
  const int n = mb_w * mb_h;
  const int a0 = (blockIdx.x * kPairs + pair) * 2;
  const int a = a0 + (lane >> 4);                     // this lane's MB
  const bool live = a < n;
  const int k = lane & 15, bx = k & 3, by = k >> 2;
  const int mbx = live ? a % mb_w : 0, mby = live ? a / mb_w : 0;
  const size_t blk = (size_t)(4 * mby + by) * (4 * mb_w) + 4 * mbx + bx;

  // the block's fields (both lists' slots, the warp's list's vector,
  // the reference indices where this warp combines), then the table, in
  // one round trip
  int s0 = -1, s1 = -1, r0 = -1, r1 = -1, vx = 0, vy = 0;
  if (live) {
    s0 = rs0[blk * rs_stride];
    if (NL == 2) s1 = rs1[blk * rs_stride];
    const int16_t* mv = l ? mv1 : mv0;
    vx = mv[blk * mv_stride];
    vy = mv[blk * mv_stride + 1];
    if (MODE && l == 0) {
      r0 = ri0[blk * rs_stride];
      if (NL == 2) r1 = ri1[blk * rs_stride];
    }
  }
  int m0 = 0, m1 = 0;
  if (MODE) {
    const int16_t* tab = MODE == 1 ? expl : imp;
    for (int i = threadIdx.x; i < kTab; i += 32 * kWarps)
      s_tab[i] = __ldg(tab + i);
    m0 = __ldg(misc + (MODE == 1 ? 0 : 2));     // denom_y, or n_ref1
    if (MODE == 1) m1 = __ldg(misc + 1);        // denom_c
  }
  __syncthreads();

  // the warp's list's prediction of this block: luma rows, cb and cr.
  // A block that does not use the list reads slot 0 at (2, 2), inside
  // any plane, so that no lane branches around its loads nor sends its
  // warp down the edge path.  A pair whose blocks use no list (intra
  // MBs) computes nothing.
  const bool u0 = s0 >= 0, u1 = NL == 2 && s1 >= 0;
  const bool active = __any_sync(kFull, u0 || u1);
  uint32_t py[4] = {}, pc[2] = {};
  if (active) {
    const size_t plane = (size_t)H * W, cplane = plane / 4;
    const int Wc = W >> 1;
    const int mx0 = 16 * mbx, my0 = 16 * mby + 4 * row0;
    const bool u = l ? u1 : u0;
    const int slot = u ? min(l ? s1 : s0, R - 1) : 0;
    const int mvx = u ? vx : 0, mvy = u ? vy : 0;
    const int fx = mvx & 3, fy = mvy & 3;
    const int x = u ? mx0 + 4 * bx + (mvx >> 2) : 2;
    const int y = u ? my0 + 4 * by + (mvy >> 2) : 2;
    const int cx = u ? (mx0 >> 1) + 2 * bx + (mvx >> 3) : 0;
    const int cy = u ? (my0 >> 1) + 2 * by + (mvy >> 3) : 0;
    // warp-uniform: full-pel only, what the phases need, inside the plane
    const bool copy = __all_sync(kFull, fx == 0 && fy == 0);
    const Needs nd{
        __any_sync(kFull, fx && fy != 2) != 0,
        __any_sync(kFull, (fx == 0 && fy) || (fx & fy & 1) ||
                              (fy == 2 && (fx & 1))) != 0,
        __any_sync(kFull, fx && (fy == 2 || (fx == 2 && fy))) != 0};
    const bool in = __all_sync(kFull, x >= 2 && x + 6 < W && cx >= 0 &&
                                          cx + 2 < Wc);
    if (in)
      predict<true>(ref_y + slot * plane, ref_cb + slot * cplane,
                    ref_cr + slot * cplane, H, W, x, y, cx, cy, mvx, mvy,
                    copy, nd, py, pc);
    else
      predict<false>(ref_y + slot * plane, ref_cb + slot * cplane,
                     ref_cr + slot * cplane, H, W, x, y, cx, cy, mvx, mvy,
                     copy, nd, py, pc);
  }
  // list 1's prediction, where list 0's warp combines (a P picture's
  // combine reads list 0's twice and uses one)
  uint32_t qy[4] = {py[0], py[1], py[2], py[3]}, qc[2] = {pc[0], pc[1]};
  if constexpr (NL == 2) {
    if (l == 1 && active) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s_l1[pair][i][lane] = py[i];
#pragma unroll
      for (int i = 0; i < 2; ++i) s_l1[pair][4 + i][lane] = pc[i];
    }
    __syncthreads();
    if (l == 1) return;
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i) qy[i] = s_l1[pair][i][lane];
#pragma unroll
      for (int i = 0; i < 2; ++i) qc[i] = s_l1[pair][4 + i][lane];
    }
  }
  if (!active) {
    if (live) {
      reinterpret_cast<uint4*>(pred_y + (size_t)a0 * 256)[lane] =
          make_uint4(0u, 0u, 0u, 0u);
      reinterpret_cast<uint2*>(pred_c + (size_t)a0 * 128)[lane] =
          make_uint2(0u, 0u);
    }
    return;
  }
  // this block's weights (8.4.2.3) from the table: luma, cb, cr
  Wp q[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) q[p] = Wp{1, 0, 1, 0, 0};
  if constexpr (MODE == 1) {
    const int16_t* e0 = s_tab + 6 * clip3(0, 31, r0);
    const int16_t* e1 = s_tab + 6 * (32 + (NL == 2 ? clip3(0, 31, r1) : 0));
#pragma unroll
    for (int p = 0; p < 3; ++p)
      q[p] = Wp{e0[2 * p], e0[2 * p + 1], e1[2 * p], e1[2 * p + 1],
                p ? m1 : m0};
  } else if constexpr (MODE == 2) {
    if (r0 >= 0 && r1 >= 0) {
      const int pr = clip3(0, 255, r0 * m0 + r1);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        q[p] = Wp{s_tab[2 * pr], 0, s_tab[2 * pr + 1], 0, 5};
    }
  }

  // combine into the pair's MB tiles, then store them whole
  WarpSmem& sm = smem[pair];
  const int hm = lane >> 4;                           // the lane's MB
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<uint32_t*>(&sm.tile_y[hm][(4 * by + r) * 16 + 4 * bx]) =
        combine<MODE>(py[r], qy[r], u0, u1, q[0]);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t c = combine<MODE>(pc[p], qc[p], u0, u1, q[1 + p]);
    uint8_t* t = &sm.tile_c[hm][64 * p + 16 * by + 2 * bx];
    *reinterpret_cast<uint16_t*>(t) = (uint16_t)c;
    *reinterpret_cast<uint16_t*>(t + 8) = (uint16_t)(c >> 16);
  }
  __syncwarp();
  if (live) {
    reinterpret_cast<uint4*>(pred_y + (size_t)a0 * 256)[lane] =
        reinterpret_cast<const uint4*>(sm.tile_y)[lane];
    reinterpret_cast<uint2*>(pred_c + (size_t)a0 * 128)[lane] =
        reinterpret_cast<const uint2*>(sm.tile_c)[lane];
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
  const int pairs = kWarps / (nlists == 2 ? 2 : 1);    // MB pairs a CTA
  const int blocks = (mb_w * mb_h + 2 * pairs - 1) / (2 * pairs);
  if (blocks > 0) {
    auto kernel = nlists == 2 ? (wp_mode == 1   ? inter_mc_kernel<2, 1>
                                 : wp_mode == 2 ? inter_mc_kernel<2, 2>
                                                : inter_mc_kernel<2, 0>)
                              : (wp_mode == 1   ? inter_mc_kernel<1, 1>
                                 : wp_mode == 2 ? inter_mc_kernel<1, 2>
                                                : inter_mc_kernel<1, 0>);
    kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)ref_y, (const uint8_t*)ref_cb, (const uint8_t*)ref_cr,
        (const int16_t*)mv0, (const int16_t*)mv1, (const int8_t*)rs0,
        (const int8_t*)rs1, (const int8_t*)ri0, (const int8_t*)ri1,
        (const int16_t*)expl, (const int16_t*)imp, (const int*)misc,
        (uint8_t*)pred_y, (uint8_t*)pred_c, R, H, W, mb_w, mb_h, row0,
        mv_stride, rs_stride);
  }
  return (int)cudaGetLastError();
}
