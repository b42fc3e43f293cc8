// Kernel B5: stage A -- inverse quantisation and the inverse transforms
// (spec 8.5) of each MB by its own kind, written straight into the int16
// residual rows that kernel B2 reads, clamped to +-255; on request also
// the coded flag of every 4x4 luma block (nz4), which kernel B6 reads.
//
// It has no Pallas original: every jitted step of the JAX package leaves
// stage A to XLA, which fuses dryv_tpu/kernels/transform.py
// luma_residual_zrows (:398) and chroma_residual_tiles (:461), reached
// through dryv_tpu/kernels/pallas_wavefront.py stage_a_residuals (:641);
// nz4 is the expression of dryv_tpu/device_ipb_packed.py :265-276.  Its
// plain version is kernels/transform.py stage_a_plain, which computes
// every MB both ways (4x4 and 8x8) and picks one.
//
// Bound by device memory: an MB reads 816 bytes of levels and 16 of kind
// and QPs and writes 768 bytes of residuals (and 16 flags), against a
// few hundred int32 adds and shifts.  So the kernel streams:
//   - persistent CTAs, kCtasPerSm an SM, each walking tiles of kT
//     consecutive MBs of one picture;
//   - a producer warp keeps a ring of kStages tiles in shared memory
//     filled ahead of use by TMA bulk copies completing on an mbarrier:
//     one copy of kT whole 816-byte rows when the four level segments
//     are column slices of the dense [F, npad, 408] rows, else one copy
//     a segment (their rows contiguous); it loads the tile's kind and
//     QPs itself after issuing the copies;
//   - consumer warps take every lane: a luma warp 2 MBs (16 lanes an
//     MB: a z-scan 4x4 block a lane, or for I8 a row of two quadrants;
//     the tile's I8 MBs go to the first luma warps, so that a warp's two
//     MBs take one path), a chroma warp 4 MBs (8 lanes an MB: plane, 4x4
//     block), so luma and chroma run at once in different warps; an I16
//     MB's Hadamard is computed once by its 16 lanes, a butterfly of
//     shuffles;
//   - they release the ring slot as soon as the levels are in
//     registers, stage the tile's residual rows in shared memory (I8's
//     transposes through padded scratch, every access conflict-free),
//     and one thread stores the rows with two TMA bulk stores.
// Arithmetic is int32 with arithmetic right shifts, rows before columns,
// as 8.5.12.2 / 8.5.13 fix the order of the interior floor shifts.
//
// The LevelScale rows are read from device memory on every launch: the
// per-picture step takes them as inputs (as the jitted _build does).
// Needs (checked by the wrapper): kind/QP arrays int32 [F, n] contiguous;
// the level segments int16, either column slices of one dense [F, npad,
// 408] tensor or each with contiguous rows, frames on 16-byte
// boundaries; outputs contiguous.
#include "common.cuh"

namespace {

constexpr int kT = 16;        // MBs a tile
constexpr int kStages = 3;    // tiles in the ring
constexpr int kCtasPerSm = 2;
constexpr int kLumaWarps = kT / 2;
constexpr int kChromaWarps = kT / 4;
constexpr int kConsumerWarps = kLumaWarps + kChromaWarps;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kRow = 816;                  // bytes of a dense row
// shared memory: barriers, LevelScale rows (ls4y, ls4cb, ls4cr [6][16],
// ls8y [6][64]), the ring (a tile's levels, then its kind and QPs
// [4][kT] and the order of its MBs on the luma warps [kT]), two output
// tiles (yres, then cres), I8's scratch
constexpr int kLsInts = 3 * 96 + 384;
constexpr int kLevelBytes = kT * kRow;
constexpr int kStageBytes = kLevelBytes + (5 * 4 * kT + 127) / 128 * 128;
constexpr int kOutBytes = kT * (512 + 256);
constexpr int kScratch = 304;  // ints an MB: [4][8][9], 304 = 16 mod 32
constexpr int kOffLs = 128;
constexpr int kOffRing = kOffLs + 4 * kLsInts;
constexpr int kOffOut = kOffRing + kStages * kStageBytes;
constexpr int kOffScratch = kOffOut + 2 * kOutBytes;
constexpr int kSmem = kOffScratch + 4 * kT * kScratch;
static_assert(kOffRing % 128 == 0 && kStageBytes % 128 == 0 &&
                  kOutBytes % 128 == 0,
              "bulk copies need 16-byte aligned shared memory");

// a level segment: its int16 offset in a dense row and its width
__device__ __forceinline__ int seg_off(int k) {
  return k == 0 ? 0 : k == 1 ? 256 : k == 2 ? 272 : 280;
}
__device__ __forceinline__ int seg_w(int k) {
  return k == 0 ? 256 : k == 1 ? 16 : k == 2 ? 8 : 128;
}

struct Params {
  const int *kind, *qpy, *qpcb, *qpcr;
  const int16_t *lv, *ldc, *cdc, *cac;
  int lv_sf, lv_sm, ldc_sf, ldc_sm, cdc_sf, cdc_sm, cac_sf, cac_sm;
  const int *ls4y, *ls4cb, *ls4cr, *ls8y;
  int16_t *yres, *cres;
  uint8_t* nz4;  // null: not asked for
  int F, n, mb_w, tiles_per_frame, tiles;
  int dense;  // the segments are column slices of one dense row
};

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

__device__ __forceinline__ uint4 pack8(const int* d) {
  return make_uint4(pack2(d[0], d[1]), pack2(d[2], d[3]), pack2(d[4], d[5]),
                    pack2(d[6], d[7]));
}

__device__ __forceinline__ bool any16(uint4 v) {
  return (v.x | v.y | v.z | v.w) != 0;
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

// the producer warp: fills ring slot `slot` with tile (f, i0, cnt).  The
// copies go first (lane 0 arms `full` with their bytes), then the lanes
// load the tile's kind and QPs, order its MBs for the luma warps and
// arrive
__device__ __forceinline__ void fill(const Params& p, uint8_t* slot,
                                     uint64_t* full, int lane, int f,
                                     int i0, int cnt) {
  if (lane == 0) mbar_arrive_expect_tx(full, cnt * kRow);
  __syncwarp();
  if (p.dense) {
    if (lane == 0)
      bulk_load(slot, p.lv + (long long)f * p.lv_sf + (long long)i0 * p.lv_sm,
                cnt * kRow, full);
  } else if (lane < 4) {  // segment `lane`, its rows contiguous
    const int k = lane;
    const int16_t* base = k == 0 ? p.lv : k == 1 ? p.ldc : k == 2 ? p.cdc
                                                                  : p.cac;
    const int sf = k == 0 ? p.lv_sf : k == 1 ? p.ldc_sf : k == 2 ? p.cdc_sf
                                                                 : p.cac_sf;
    const int w = seg_w(k);
    bulk_load(slot + kT * 2 * seg_off(k),
              base + (long long)f * sf + (long long)i0 * w, cnt * 2 * w, full);
  }
  int* meta = (int*)(slot + kLevelBytes);
  const long long m0 = (long long)f * p.n + i0;
  int k = 0;  // lane j < kT: the kind of MB j
  for (int x = lane; x < 4 * kT; x += 32) {
    const int a = x / kT, j = x % kT;
    const int* src = a == 0 ? p.kind : a == 1 ? p.qpy : a == 2 ? p.qpcb
                                                               : p.qpcr;
    const int v = j < cnt ? src[m0 + j] : 0;
    meta[x] = v;
    if (a == 0) k = v;
  }
  // the luma warps take the tile's I8 MBs first, then the others, so
  // that the two MBs of a warp take one path (one warp at most mixes)
  const bool on = lane < cnt;
  const unsigned m8 = __ballot_sync(0xffffffffu, on && k == 1);
  const unsigned mo = __ballot_sync(0xffffffffu, on && k != 1);
  const unsigned below = (1u << lane) - 1u;
  if (lane < kT)
    meta[4 * kT + (!on ? lane : k == 1 ? __popc(m8 & below)
                              : __popc(m8) + __popc(mo & below))] = lane;
  mbar_arrive(full);
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
stage_a_kernel(const Params p) {
  uint8_t* sm = dyn_smem();
  uint64_t* full = (uint64_t*)sm;
  uint64_t* empty = full + kStages;
  int* s_ls = (int*)(sm + kOffLs);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 33);  // lane 0 arming it, then the 32 lanes
      mbar_init(&empty[s], kConsumerWarps);
    }
  __syncthreads();

  if (w == kConsumerWarps) {  // the producer
    for (int t = blockIdx.x, it = 0; t < p.tiles; t += gridDim.x, ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(&empty[s], (unsigned)(it / kStages - 1) & 1);
      fill(p, sm + kOffRing + s * kStageBytes, &full[s], lane,
           t / p.tiles_per_frame, (t % p.tiles_per_frame) * kT,
           min(kT, p.n - (t % p.tiles_per_frame) * kT));
    }
    return;
  }

  // the consumers: the LevelScale rows while the first tiles arrive
  for (int x = threadIdx.x; x < kLsInts; x += kConsumers)
    s_ls[x] = x < 96 ? p.ls4y[x] : x < 192 ? p.ls4cb[x - 96]
            : x < 288 ? p.ls4cr[x - 192] : p.ls8y[x - 288];
  named_sync(1, kConsumers);
  // a segment's row j in a ring slot: dense rows side by side, or each
  // segment's rows in a run of its own
  const int sb1 = p.dense ? 512 : kT * 512, ss1 = p.dense ? kRow : 32;
  const int sb2 = p.dense ? 544 : kT * 544, ss2 = p.dense ? kRow : 16;
  const int sb3 = p.dense ? 560 : kT * 560, ss3 = p.dense ? kRow : 256;
  const int ss0 = p.dense ? kRow : 512;
  const int H4 = 4 * (p.n / p.mb_w), W4 = 4 * p.mb_w;

  for (int t = blockIdx.x, it = 0; t < p.tiles; t += gridDim.x, ++it) {
    const int s = it % kStages;
    const int f = t / p.tiles_per_frame;
    const int i0 = (t % p.tiles_per_frame) * kT;
    const int cnt = min(kT, p.n - i0);
    uint8_t* slot = sm + kOffRing + s * kStageBytes;
    const int* meta = (const int*)(slot + kLevelBytes);
    uint8_t* oy = sm + kOffOut + (it & 1) * kOutBytes;
    uint8_t* oc = oy + kT * 512;
    mbar_wait(&full[s], (unsigned)(it / kStages) & 1);

    if (w < kLumaWarps) {
      // luma: MB j, 16 lanes; zl the z-scan 4x4 block, or for I8 the row
      // r of quadrants q0 and q0 + 2
      const int h = lane >> 4, zl = lane & 15, pos = 2 * w + h;
      const int j = meta[4 * kT + pos];  // I8 MBs on the first warps
      const unsigned hm = 0xffffu << (16 * h);
      const bool on = pos < cnt;
      const int k = on ? meta[j] : 0, qp = on ? meta[kT + j] : 0;
      const int q0 = zl >> 3, r = zl & 7, hf = (zl >> 2) & 1;
      const uint8_t* L = slot + j * ss0;
      uint4 a = make_uint4(0, 0, 0, 0), b = a;
      int dc = 0;
      if (on) {
        if (k == 1) {
          a = *(const uint4*)(L + 128 * q0 + 16 * r);
          b = *(const uint4*)(L + 128 * (q0 + 2) + 16 * r);
        } else {
          // the two 16-byte halves in the order that keeps a quarter
          // warp's eight reads on distinct banks
          const uint4 u = *(const uint4*)(L + 32 * zl + 16 * hf);
          const uint4 v = *(const uint4*)(L + 32 * zl + 16 * (1 - hf));
          a = hf ? v : u;
          b = hf ? u : v;
          if (k == 2) dc = ((const int16_t*)(slot + sb1 + j * ss1))[zl];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (on) {
        const int q6 = qp / 6, qm = qp % 6;
        int16_t* Y = (int16_t*)(oy + j * 512);
        unsigned zmask;
        if (k == 1) {  // I8: rows, transpose, columns, transpose back
          int* G = (int*)(sm + kOffScratch) + pos * kScratch;
          const int* ls = s_ls + 288 + 64 * qm + 8 * r;
          int c[8], g[8], res[2][8];
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            const int q = q0 + 2 * qq;
            unpack8(qq ? b : a, c);
#pragma unroll
            for (int x = 0; x < 8; ++x) c[x] = scale(c[x] * ls[x], q6, 6);
            butterfly8(c, g);
#pragma unroll
            for (int x = 0; x < 8; ++x) G[72 * q + 9 * r + x] = g[x];
          }
          __syncwarp(hm);
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            const int q = q0 + 2 * qq;
#pragma unroll
            for (int y = 0; y < 8; ++y) c[y] = G[72 * q + 9 * y + r];
            butterfly8(c, g);
#pragma unroll
            for (int y = 0; y < 8; ++y)
              res[qq][y] = clip3(-255, 255, (g[y] + 32) >> 6);
          }
          __syncwarp(hm);
#pragma unroll
          for (int qq = 0; qq < 2; ++qq)
#pragma unroll
            for (int y = 0; y < 8; ++y)
              G[72 * (q0 + 2 * qq) + 9 * y + r] = res[qq][y];
          __syncwarp(hm);
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            const int q = q0 + 2 * qq;
#pragma unroll
            for (int x = 0; x < 8; ++x) c[x] = G[72 * q + 9 * r + x];
            *(uint4*)(Y + 64 * q + 8 * r) = pack8(c);
          }
          const unsigned b0 = __ballot_sync(hm, any16(a)) >> (16 * h);
          const unsigned b2 = __ballot_sync(hm, any16(b)) >> (16 * h);
          zmask = ((b0 & 0xffu) ? 0x000fu : 0u) | ((b0 & 0xff00u) ? 0x00f0u : 0u)
                | ((b2 & 0xffu) ? 0x0f00u : 0u) | ((b2 & 0xff00u) ? 0xf000u : 0u);
        } else {  // 4x4 block zl (I4, I16, PCM, any other kind)
          int d[16];
          unpack8(a, d);
          unpack8(b, d + 8);
          const int* ls = s_ls + 16 * qm;
#pragma unroll
          for (int x = 0; x < 16; ++x) d[x] = scale(d[x] * ls[x], q6, 4);
          if (k == 2) {
            // I16: the DC Hadamard of the 16 raster levels, one value a
            // lane: a butterfly over the lane bits (x: bits 0-1, y: 2-3)
            // leaves natural-order Walsh-Hadamard term (zl >> 2, zl & 3)
            // in lane zl; the spec's rows are the natural ones 0, 2, 3, 1
            int v = dc;
#pragma unroll
            for (int bit = 1; bit < 16; bit <<= 1) {
              const int o = __shfl_xor_sync(hm, v, bit);
              v = (zl & bit) ? o - v : v + o;
            }
            const int bx = ((zl >> 2) & 1) * 2 + (zl & 1);
            const int by = ((zl >> 3) & 1) * 2 + ((zl >> 1) & 1);
            const int nat = 4 * ((0x1320 >> (4 * by)) & 3)
                          + ((0x1320 >> (4 * bx)) & 3);
            v = __shfl_sync(hm, v, (lane & 16) | nat);
            d[0] = scale(v * ls[0], q6, 6);
          }
          idct4_clamped(d);
          const uint4 u = pack8(d), v = pack8(d + 8);
          *(uint4*)(Y + 16 * zl + 8 * hf) = hf ? v : u;
          *(uint4*)(Y + 16 * zl + 8 * (1 - hf)) = hf ? u : v;
          zmask = (__ballot_sync(hm, any16(a) || any16(b)) >> (16 * h))
                & 0xffffu;
        }
        if (p.nz4 != nullptr && zl < 4) {
          // raster row zl of the MB's 4x4 blocks: byte x the flag of
          // z-scan block 8 (y >> 1) + 4 (x >> 1) + 2 (y & 1) + (x & 1)
          const int i = i0 + j, y = zl;
          uint32_t word = 0;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int z = 8 * (y >> 1) + 4 * (x >> 1) + 2 * (y & 1) + (x & 1);
            word |= ((zmask >> z) & 1u) << (8 * x);
          }
          *(uint32_t*)(p.nz4 + ((long long)f * H4 + 4 * (i / p.mb_w) + y) * W4
                       + 4 * (i % p.mb_w)) = word;
        }
      }
    } else {
      // chroma: MB j, 8 lanes; plane pl, 4x4 block bk (raster in the 2x2)
      const int cw = w - kLumaWarps;
      const int j = 4 * cw + (lane >> 3), pl = (lane >> 2) & 1, bk = lane & 3;
      const bool on = j < cnt;
      uint4 a = make_uint4(0, 0, 0, 0), b = a;
      uint2 dw = make_uint2(0, 0);
      const int qc = on ? meta[(2 + pl) * kT + j] : 0;
      if (on) {
        dw = *(const uint2*)(slot + sb2 + j * ss2 + 8 * pl);
        const uint8_t* A = slot + sb3 + j * ss3 + 128 * pl + 32 * bk;
        const uint4 u = *(const uint4*)(A + 16 * pl);
        const uint4 v = *(const uint4*)(A + 16 * (1 - pl));
        a = pl ? v : u;
        b = pl ? u : v;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (on) {
        const int cq6 = qc / 6;
        const int* ls = s_ls + 96 * (1 + pl) + 16 * (qc % 6);
        const int c0 = lo16(dw.x), c1 = hi16(dw.x), c2 = lo16(dw.y),
                  c3 = hi16(dw.y);
        const int hd = bk == 0 ? c0 + c1 + c2 + c3
                     : bk == 1 ? c0 - c1 + c2 - c3
                     : bk == 2 ? c0 + c1 - c2 - c3 : c0 - c1 - c2 + c3;
        int d[16];
        unpack8(a, d);
        unpack8(b, d + 8);
#pragma unroll
        for (int x = 1; x < 16; ++x) d[x] = scale(d[x] * ls[x], cq6, 4);
        d[0] = ((hd * ls[0]) << cq6) >> 5;
        idct4_clamped(d);
        uint2 rows[4];
#pragma unroll
        for (int y = 0; y < 4; ++y)
          rows[y] = make_uint2(pack2(d[4 * y], d[4 * y + 1]),
                               pack2(d[4 * y + 2], d[4 * y + 3]));
        // rows in an order that keeps a half warp's 8-byte stores on
        // distinct banks (planes and MB parity rotate it)
        uint8_t* C = oc + j * 256 + 128 * pl + 64 * (bk >> 1) + 8 * (bk & 1);
        const int rot = 2 * pl + (j & 1);
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          const int y = (st + rot) & 3;
          *(uint2*)(C + 16 * y) = y == 0 ? rows[0] : y == 1 ? rows[1]
                                : y == 2 ? rows[2] : rows[3];
        }
      }
    }
    // the tile's rows are staged: one thread stores them
    fence_async_smem();
    named_sync(1, kConsumers);
    if (threadIdx.x == 0) {
      const long long m0 = (long long)f * p.n + i0;
      bulk_store(p.yres + m0 * 256, oy, cnt * 512);
      bulk_store(p.cres + m0 * 128, oc, cnt * 256);
      bulk_commit();
      bulk_wait_read();  // the other output tile is free for the next
    }
  }
  if (threadIdx.x == 0) bulk_wait();
}

}  // namespace

DT_EXPORT int dt_stage_a(const void* kind, const void* qpy, const void* qpcb,
                         const void* qpcr, const void* lv, const void* ldc,
                         const void* cdc, const void* cac, const void* ls4y,
                         const void* ls4cb, const void* ls4cr,
                         const void* ls8y, void* yres, void* cres, void* nz4,
                         int F, int n, int mb_w, int lv_sf, int lv_sm,
                         int ldc_sf, int ldc_sm, int cdc_sf, int cdc_sm,
                         int cac_sf, int cac_sm, void* stream) {
  if (F <= 0 || n <= 0) return 0;
  const int16_t* L = (const int16_t*)lv;
  Params p{(const int*)kind, (const int*)qpy, (const int*)qpcb,
           (const int*)qpcr, L, (const int16_t*)ldc, (const int16_t*)cdc,
           (const int16_t*)cac, lv_sf, lv_sm, ldc_sf, ldc_sm, cdc_sf, cdc_sm,
           cac_sf, cac_sm, (const int*)ls4y, (const int*)ls4cb,
           (const int*)ls4cr, (const int*)ls8y, (int16_t*)yres,
           (int16_t*)cres, (uint8_t*)nz4, F, n, mb_w, (n + kT - 1) / kT, 0,
           0};
  p.tiles = F * p.tiles_per_frame;
  p.dense = ldc == L + 256 && cdc == L + 272 && cac == L + 280 &&
            lv_sm == 408 && ldc_sm == 408 && cdc_sm == 408 &&
            cac_sm == 408 && ldc_sf == lv_sf && cdc_sf == lv_sf &&
            cac_sf == lv_sf;
  static bool smem_allowed[64];  // per device
  const int rc = allow_dynamic_smem((const void*)stage_a_kernel, kSmem,
                                    smem_allowed);
  if (rc) return rc;
  const int blocks = min(p.tiles, kCtasPerSm * sm_count());
  stage_a_kernel<<<blocks, kThreads, kSmem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
