// Kernel B6: the in-loop filter's edge parameters (spec 8.7.2), boundary
// strength, alpha, beta and tC0 of every edge of every MB, written
// straight into the uint8 parameter rows that kernel B3 reads (192 bytes
// an MB, in PRE_KEYS order).
//
// It has no Pallas original: the JAX package leaves this to XLA inside
// its jitted steps, dryv_tpu/kernels/deblock.py deblock_precompute_jax
// (:410, the inter boundary strengths over a motion field) and
// deblock_precompute_intra_jax (:265, all-intra pictures: bS 4 on MB
// edges, 3 inside).  Its plain version is kernels/deblock.py
// deblock_params_plain, pack_params(deblock_precompute(...)), which
// builds an int32 dict of ~40 tensors first.
//
// Bound by device memory: an MB writes 192 bytes and reads ~24 bytes of
// per-MB fields (intra) or ~13 bytes a 4x4 block of motion (inter);
// its arithmetic is a few hundred compares and table reads.  A warp
// takes one MB at a time, its 32 lanes the MB's 32 luma (direction,
// edge, 4-line segment) boundary strengths, so that even one 1080p
// picture (8160 MBs) spreads over the card:
//   - persistent CTAs, kCtasPerSm an SM and all resident, whose warps
//     walk the MBs with the next MB's loads in flight while they build
//     the current row; the parameter tables sit in shared memory;
//   - inter: lanes 0-23 stage the motion of the MB's 16 blocks and of
//     its 4 left and 4 above neighbours (vectors, reference keys, coded
//     and intra flags) in shared memory, coalesced, and each lane then
//     reads its pair of blocks from there; the intra form is a template
//     that reads no motion (bS 4 on MB edges, 3 inside);
//   - each lane writes its own bytes of the row: its luma bS and tC0
//     (segment 0: the edge's alpha and beta), then, as (chroma edge,
//     plane, segment), the chroma bS it takes by shuffle from the lane
//     of its luma edge and the tC0 of that bS (segment 0: alpha and
//     beta): one chroma QP a lane, no per-thread arrays;
//   - the row is built in shared memory and stored by 12 lanes as
//     16-byte words.
//
// What a row depends on (the plain version's conventions, kept exactly):
// outside the picture the left/above MB's QP (luma and chroma) reads 0
// and its slice id -1, and a missing 4x4 block is not intra, has no
// coefficients, zero vectors and reference keys -1; alpha, beta and tC0
// are written for every edge, bS 0 or not; disable_deblocking_filter_idc
// 2 drops MB edges across slices; PCM filters at QP 0; the 8x8 transform
// drops luma edges 1 and 3; chroma's two edges take luma edges 0 and 2,
// each 4-line segment's bS twice.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// persistent CTAs an SM: 32 warps, all resident at once (the launch
// bounds hold a thread to 64 registers), each walking its MBs
constexpr int kCtasPerSm = 4;
constexpr int kRow = 192;

// where each direction's PRE_KEYS start in a row: luma bS [4 edges][4
// segments], tC0 the same, alpha [4], beta [4]; chroma bS [2][8], tC0
// [2 edges][2 planes][8], alpha [2][2], beta [2][2]
constexpr int kBsV = 0, kBsH = 40, kBsCV = 80, kBsCH = 136;

struct Inputs {
  const int *kind, *qpy, *sid, *dis, *offa, *offb, *t8;
  const uint8_t* nz4;
  const int16_t* mv;   // [F, n4, 2 lists, 2 components]
  const int8_t* rs;    // [F, n4, 4]: reference keys of lists 0 and 1 first
  const int *alpha, *beta, *tc0, *qpc_tab;
  int mb_w, mb_h, c0, c1;
};

// a 4x4 block's motion as staged: both lists' vectors, the two keys
// (bytes 0-1 of `keys`), and flags (bit 0 intra, bit 1 coded)
struct __align__(16) Blk {
  uint32_t mv0, mv1, keys, flags;
};

__device__ __forceinline__ bool intra_kind(int k) { return k <= 3 || k == 11; }

__device__ __forceinline__ int key(uint32_t keys, int l) {
  return (int8_t)(keys >> (8 * l));
}

// |dx| >= 4 or |dy| >= 4 between two packed int16 vectors
__device__ __forceinline__ bool far(uint32_t a, uint32_t b) {
  return abs((int)(int16_t)(a & 0xffffu) - (int)(int16_t)(b & 0xffffu)) >= 4 ||
         abs((int)(int16_t)(a >> 16) - (int)(int16_t)(b >> 16)) >= 4;
}

// kernels/deblock.py _pair_bs (8.7.2.1)
__device__ __forceinline__ int pair_bs(const Blk& p, const Blk& q,
                                       bool mb_edge) {
  if ((p.flags | q.flags) & 1) return mb_edge ? 4 : 3;
  if ((p.flags | q.flags) & 2) return 2;
  const int p0 = key(p.keys, 0), p1 = key(p.keys, 1);
  const int q0 = key(q.keys, 0), q1 = key(q.keys, 1);
  const int np = (p0 >= 0) + (p1 >= 0), nq = (q0 >= 0) + (q1 >= 0);
  if (np != nq || min(p0, p1) != min(q0, q1) || max(p0, p1) != max(q0, q1))
    return 1;
  if (np == 1)
    return far(p0 >= 0 ? p.mv0 : p.mv1, q0 >= 0 ? q.mv0 : q.mv1);
  const bool fa = far(p.mv0, q.mv0) || far(p.mv1, q.mv1);
  const bool fx = far(p.mv0, q.mv1) || far(p.mv1, q.mv0);
  if (p0 == p1) return fa && fx;
  return p0 == q0 ? fa : fx;
}

// the parameter tables in shared memory: alpha [52], beta [52], tC0
// [52][3], then the chroma QP table [22]
constexpr int kTabA = 0, kTabB = 52, kTabT = 104, kTabQ = 260, kTabN = 282;

__device__ __forceinline__ int chroma_qp(int qp, int off, const int* tab) {
  const int q = clip3(0, 51, qp + off);
  return q < 30 ? q : tab[kTabQ + clip3(0, 21, q - 30)];
}

// what a lane reads of one MB: the MB's fields and its neighbour's in
// the lane's direction (kind, QP, slice id), and for lanes 0-23 of the
// inter form their staged block
struct Mb {
  int k, qp, sid, dis, oa, ob, t8, k_nb, qp_nb, sid_nb;
  Blk blk;
};

// a lane's loads for MB (f, mx, my) in direction `dir` (and block `bk`,
// 0-23, of the inter form); nothing waits on them until they are used,
// so a warp has its next MBs' loads in flight while it builds rows
template <bool kInter>
__device__ __forceinline__ Mb load_mb(const Inputs& in, int dir, int bk,
                                      int f, int mx, int my) {
  const int n = in.mb_w * in.mb_h, i = my * in.mb_w + mx;
  const long long base = (long long)f * n;
  const bool has_nb = dir ? my > 0 : mx > 0;
  const long long nb = base + (dir ? i - in.mb_w : i - 1);
  Mb b;
  b.k = in.kind[base + i];
  b.qp = in.qpy[base + i];
  b.sid = in.sid[base + i];
  b.dis = in.dis[base + i];
  b.oa = in.offa[base + i];
  b.ob = in.offb[base + i];
  b.t8 = kInter ? in.t8[base + i] : 0;
  b.k_nb = has_nb ? in.kind[nb] : 0;
  b.qp_nb = has_nb ? in.qpy[nb] : 0;
  b.sid_nb = has_nb ? in.sid[nb] : -1;
  b.blk = Blk{0, 0, 0xffffu, 0};  // outside the picture
  if (kInter && bk < 24) {
    // the block: 16 own in raster order, 4 left, 4 above
    const int r = bk < 16 ? 4 * my + (bk >> 2)
                : bk < 20 ? 4 * my + bk - 16 : 4 * my - 1;
    const int c = bk < 16 ? 4 * mx + (bk & 3)
                : bk < 20 ? 4 * mx - 1 : 4 * mx + bk - 20;
    const bool there = bk < 16 || (bk < 20 ? mx > 0 : my > 0);
    if (there) {
      const int mbi = bk < 16 ? i : bk < 20 ? i - 1 : i - in.mb_w;
      const long long j = ((long long)f * 4 * in.mb_h + r) * 4 * in.mb_w + c;
      const uint2 v = *(const uint2*)(in.mv + 4 * j);
      b.blk = Blk{v.x, v.y, *(const uint32_t*)(in.rs + 4 * j) & 0xffffu,
                  (intra_kind(in.kind[base + mbi]) ? 1u : 0u)
                      | (in.nz4[j] ? 2u : 0u)};
    }
  }
  return b;
}

// The inter form gives an MB the warp's 32 lanes, (direction, edge e,
// segment sg), as its bS changes along an edge.  The intra form's bS is
// one value an edge, so it gives an MB 8 lanes, (direction, edge e),
// each writing its edge's four segments at once, and a warp builds 4
// rows at a time.
template <bool kInter>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
deblock_params_kernel(Inputs in, int F, uint8_t* __restrict__ prm) {
  constexpr int kLanes = kInter ? 32 : 8;  // lanes an MB
  constexpr int kMbs = 32 / kLanes;        // MBs a warp at a time
  // the tables; per warp the staged blocks and the rows
  __shared__ int s_tab[kTabN];
  __shared__ Blk s_blk[kWarps][kInter ? 24 : 1];
  __shared__ __align__(16) uint8_t s_row[kWarps][kMbs * kRow];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int u = lane % kLanes, slot = lane / kLanes;
  const int dir = kInter ? u >> 4 : u >> 2;
  const int e = kInter ? (u >> 2) & 3 : u & 3, sg = kInter ? u & 3 : 0;
  const int mb_w = in.mb_w, mb_h = in.mb_h, n = mb_w * mb_h, M = F * n;
  // the warp's MBs: kMbs from mw, then from mw + stride, ... (F n <
  // 2^31: the wrapper's); the lane's MB m = mw + slot, its (f, my, mx)
  // stepped along without a division a step
  const int stride = gridDim.x * kWarps * kMbs;
  const int sq = stride / mb_w, sr = stride - sq * mb_w;
  int mw = (blockIdx.x * kWarps + w) * kMbs;
  int m = mw + slot;
  int f = m / n, my = (m - f * n) / mb_w, mx = m - f * n - my * mb_w;
  Mb cur{};
  if (m < M) cur = load_mb<kInter>(in, dir, lane, f, mx, my);
  for (int x = threadIdx.x; x < kTabN; x += kThreads)
    s_tab[x] = x < kTabB ? in.alpha[x] : x < kTabT ? in.beta[x - kTabB]
             : x < kTabQ ? in.tc0[x - kTabT] : in.qpc_tab[x - kTabQ];
  __syncthreads();

  for (; mw < M; mw += stride, m += stride) {
    const int cmx = mx, cmy = my;
    mx += sr;
    my += sq;
    if (mx >= mb_w) mx -= mb_w, ++my;
    if (my >= mb_h) f += my / mb_h, my %= mb_h;
    Mb nxt{};
    if (m + stride < M) nxt = load_mb<kInter>(in, dir, lane, f, mx, my);

    int bs = e == 0 ? 4 : 3;
    if (kInter) {
      if (lane < 24) s_blk[w][lane] = cur.blk;
      __syncwarp();
      // q: the block at (segment, edge) or (edge, segment); p: before it
      const int qb = dir ? 4 * e + sg : 4 * sg + e;
      const int pb = e > 0 ? qb - (dir ? 4 : 1) : (dir ? 20 + sg : 16 + sg);
      bs = pair_bs(s_blk[w][pb], s_blk[w][qb], e == 0);
    }
    const bool has_nb = dir ? cmy > 0 : cmx > 0;
    const int qp = cur.k == 3 ? 0 : cur.qp;
    const int qp_nb = cur.k_nb == 3 ? 0 : cur.qp_nb;
    const bool on_self = cur.dis != 1;
    const bool on_e0 =
        on_self && has_nb && !(cur.dis == 2 && cur.sid_nb != cur.sid);
    const bool t8 = cur.k == 1 || cur.t8 != 0;

    // luma: edge e, segment sg (intra: all four)
    uint8_t* o = s_row[w] + slot * kRow;
    uint8_t* L = o + (dir ? kBsH : kBsV);
    const int qpl = e ? qp : (qp_nb + qp + 1) >> 1;
    const int ia = clip3(0, 51, qpl + cur.oa);
    const bool on = e == 0 ? on_e0 : (e & 1) ? on_self && !t8 : on_self;
    const int b = on ? bs : 0;
    const unsigned tl = s_tab[kTabT + 3 * ia + clip3(1, 3, b) - 1];
    if (kInter) {
      L[4 * e + sg] = (uint8_t)b;
      L[16 + 4 * e + sg] = (uint8_t)tl;
    } else {
      *(uint32_t*)(L + 4 * e) = b * 0x01010101u;
      *(uint32_t*)(L + 16 + 4 * e) = tl * 0x01010101u;
    }
    if (sg == 0) {
      L[32 + e] = (uint8_t)s_tab[kTabA + ia];
      L[36 + e] = (uint8_t)s_tab[kTabB + clip3(0, 51, qpl + cur.ob)];
    }

    // chroma: the same lanes as (direction, chroma edge ce, plane pl,
    // segment sg); edge ce takes luma edge 2 ce, whose lane holds its bS
    // (enabled alike: on_e0 or on_self), and segment sg is chroma
    // segments 2 sg and 2 sg + 1 (intra: all eight)
    uint8_t* C = o + (dir ? kBsCH : kBsCV);
    const int ce = kInter ? u >> 3 & 1 : e >> 1;
    const int pl = kInter ? u >> 2 & 1 : e & 1;
    const int bc = __shfl_sync(0xffffffffu, b,
                               kInter ? lane & ~4 : (lane & ~3) | (2 * ce));
    const int off = pl ? in.c1 : in.c0;
    const int qc = chroma_qp(qp, off, s_tab);
    const int qc_nb = has_nb ? chroma_qp(qp_nb, off, s_tab) : 0;
    const int q = ce ? qc : (qc_nb + qc + 1) >> 1;
    const int iac = clip3(0, 51, q + cur.oa);
    const unsigned t = s_tab[kTabT + 3 * iac + clip3(1, 3, bc) - 1];
    if (kInter) {
      if (pl == 0) *(uint16_t*)(C + 8 * ce + 2 * sg) = (uint16_t)(bc * 0x101u);
      *(uint16_t*)(C + 16 + 16 * ce + 8 * pl + 2 * sg) = (uint16_t)(t * 0x101u);
    } else {
      if (pl == 0) *(uint64_t*)(C + 8 * ce) = bc * 0x0101010101010101ull;
      *(uint64_t*)(C + 16 + 16 * ce + 8 * pl) = t * 0x0101010101010101ull;
    }
    if (sg == 0) {
      C[48 + 2 * ce + pl] = (uint8_t)s_tab[kTabA + iac];
      C[52 + 2 * ce + pl] = (uint8_t)s_tab[kTabB + clip3(0, 51, q + cur.ob)];
    }
    __syncwarp();
    // the warp's rows are contiguous: 12 16-byte words a row
    const int words = 12 * min(kMbs, M - mw);
    for (int x = lane; x < words; x += 32)
      ((uint4*)(prm + (long long)mw * kRow))[x] = ((const uint4*)s_row[w])[x];
    __syncwarp();  // the rows and the blocks are free for the next MBs
    cur = nxt;
  }
}

}  // namespace

DT_EXPORT int dt_deblock_params(const void* kind, const void* qpy,
                                const void* sid, const void* dis,
                                const void* offa, const void* offb,
                                const void* t8, const void* nz4,
                                const void* mv, const void* rs,
                                const void* alpha, const void* beta,
                                const void* tc0, const void* qpc_tab,
                                void* prm, int mb_w, int mb_h, int F, int c0,
                                int c1, void* stream) {
  const Inputs in{(const int*)kind,   (const int*)qpy,     (const int*)sid,
                  (const int*)dis,    (const int*)offa,    (const int*)offb,
                  (const int*)t8,     (const uint8_t*)nz4, (const int16_t*)mv,
                  (const int8_t*)rs,  (const int*)alpha,   (const int*)beta,
                  (const int*)tc0,    (const int*)qpc_tab, mb_w,
                  mb_h,               c0,                  c1};
  const long long M = (long long)F * mb_w * mb_h;
  if (M >= (1LL << 31) - (1LL << 24)) return (int)cudaErrorInvalidValue;
  if (M > 0) {
    const long long need = (M + kWarps - 1) / kWarps;
    const int blocks = (int)(need < kCtasPerSm * sm_count()
                                 ? need : kCtasPerSm * sm_count());
    const auto kernel = mv != nullptr ? deblock_params_kernel<true>
                                      : deblock_params_kernel<false>;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(in, F, (uint8_t*)prm);
  }
  return (int)cudaGetLastError();
}
