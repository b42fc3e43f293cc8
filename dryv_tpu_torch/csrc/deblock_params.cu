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
// its arithmetic is a few hundred compares and table reads.  A thread
// takes one MB and builds its row in shared memory; the block then
// stores its 128 rows, which are contiguous, as 16-byte words.
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

constexpr int kThreads = 128;
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

__device__ __forceinline__ int chroma_qp(int qp, int off, const int* tab) {
  const int q = clip3(0, 51, qp + off);
  return q < 30 ? q : __ldg(tab + clip3(0, 21, q - 30));
}

// one 4x4 block's side of an edge: intra, coded coefficients, the
// vectors and reference keys of both lists
struct Blk {
  bool intra, nz;
  int mv[2][2], rk[2];
};

__device__ __forceinline__ bool intra_kind(int k) { return k <= 3 || k == 11; }

__device__ Blk block(const Inputs& in, const int* kind, long long f, int r,
                     int c) {
  Blk b;
  const int W4 = 4 * in.mb_w, H4 = 4 * in.mb_h;
  if (r < 0 || c < 0) {  // outside the picture
    b.intra = b.nz = false;
    b.mv[0][0] = b.mv[0][1] = b.mv[1][0] = b.mv[1][1] = 0;
    b.rk[0] = b.rk[1] = -1;
    return b;
  }
  const long long j = (f * H4 + r) * W4 + c;
  b.intra = intra_kind(kind[(r >> 2) * in.mb_w + (c >> 2)]);
  b.nz = in.nz4[j] != 0;
  const int16_t* v = in.mv + 4 * j;
  b.mv[0][0] = v[0]; b.mv[0][1] = v[1]; b.mv[1][0] = v[2]; b.mv[1][1] = v[3];
  b.rk[0] = in.rs[4 * j];
  b.rk[1] = in.rs[4 * j + 1];
  return b;
}

__device__ __forceinline__ bool far(const int* a, const int* b) {
  return abs(a[0] - b[0]) >= 4 || abs(a[1] - b[1]) >= 4;
}

// kernels/deblock.py _pair_bs (8.7.2.1)
__device__ int pair_bs(const Blk& p, const Blk& q, bool mb_edge) {
  if (p.intra || q.intra) return mb_edge ? 4 : 3;
  if (p.nz || q.nz) return 2;
  const int np = (p.rk[0] >= 0) + (p.rk[1] >= 0);
  const int nq = (q.rk[0] >= 0) + (q.rk[1] >= 0);
  if (np != nq || min(p.rk[0], p.rk[1]) != min(q.rk[0], q.rk[1]) ||
      max(p.rk[0], p.rk[1]) != max(q.rk[0], q.rk[1]))
    return 1;
  if (np == 1)
    return far(p.rk[0] >= 0 ? p.mv[0] : p.mv[1],
               q.rk[0] >= 0 ? q.mv[0] : q.mv[1]);
  const bool fa = far(p.mv[0], q.mv[0]) || far(p.mv[1], q.mv[1]);
  const bool fx = far(p.mv[0], q.mv[1]) || far(p.mv[1], q.mv[0]);
  if (p.rk[0] == p.rk[1]) return fa && fx;
  return p.rk[0] == q.rk[0] ? fa : fx;
}

// one direction (vertical edges: nb = the left MB; horizontal: the
// MB above) of MB i of frame f into row o
__device__ void direction(const Inputs& in, long long f, int i, bool horiz,
                          uint8_t* o) {
  const long long base = f * in.mb_w * in.mb_h;
  const int* kind = in.kind + base;
  const int mx = i % in.mb_w, my = i / in.mb_w;
  const bool has_nb = horiz ? my > 0 : mx > 0;
  const int nb = horiz ? i - in.mb_w : i - 1;
  const int k = kind[i];
  const int qp = k == 3 ? 0 : in.qpy[base + i];
  const int qp_nb = !has_nb ? 0 : kind[nb] == 3 ? 0 : in.qpy[base + nb];
  const int sid = in.sid[base + i];
  const int sid_nb = has_nb ? in.sid[base + nb] : -1;
  const int dis = in.dis[base + i];
  const int oa = in.offa[base + i], ob = in.offb[base + i];
  const bool on_self = dis != 1;
  const bool on_e0 = on_self && has_nb && !(dis == 2 && sid_nb != sid);
  const bool t8 = k == 1 || (in.t8 != nullptr && in.t8[base + i] != 0);

  // bS before the enables, [edge][4-line segment]
  int bs[4][4];
  for (int e = 0; e < 4; ++e)
    for (int s = 0; s < 4; ++s) {
      if (in.mv == nullptr) {
        bs[e][s] = e == 0 ? 4 : 3;
        continue;
      }
      const int r = 4 * my + (horiz ? e : s), c = 4 * mx + (horiz ? s : e);
      bs[e][s] = pair_bs(block(in, kind, f, horiz ? r - 1 : r,
                               horiz ? c : c - 1),
                         block(in, kind, f, r, c), e == 0);
    }

  // luma
  uint8_t* L = o + (horiz ? kBsH : kBsV);
  const int qpav = (qp_nb + qp + 1) >> 1;
  const int ia0 = clip3(0, 51, qpav + oa), ib0 = clip3(0, 51, qpav + ob);
  const int iai = clip3(0, 51, qp + oa), ibi = clip3(0, 51, qp + ob);
  const bool onk = on_self && !t8;
  const bool ons[4] = {on_e0, onk, on_self, onk};
  for (int e = 0; e < 4; ++e) {
    const int ia = e ? iai : ia0;
    for (int s = 0; s < 4; ++s) {
      const int b = ons[e] ? bs[e][s] : 0;
      L[4 * e + s] = (uint8_t)b;
      L[16 + 4 * e + s] = (uint8_t)__ldg(in.tc0 + 3 * ia + clip3(1, 3, b) - 1);
    }
    L[32 + e] = (uint8_t)__ldg(in.alpha + ia);
    L[36 + e] = (uint8_t)__ldg(in.beta + (e ? ibi : ib0));
  }

  // chroma: edges 0 and 1 take luma edges 0 and 2, each segment twice
  uint8_t* C = o + (horiz ? kBsCH : kBsCV);
  int bsc[2][8];
  for (int j = 0; j < 8; ++j) {
    bsc[0][j] = on_e0 ? bs[0][j >> 1] : 0;
    bsc[1][j] = on_self ? bs[2][j >> 1] : 0;
    C[j] = (uint8_t)bsc[0][j];
    C[8 + j] = (uint8_t)bsc[1][j];
  }
  for (int p = 0; p < 2; ++p) {
    const int off = p ? in.c1 : in.c0;
    const int qc = chroma_qp(qp, off, in.qpc_tab);
    const int qc_nb = has_nb ? chroma_qp(qp_nb, off, in.qpc_tab) : 0;
    const int av = (qc_nb + qc + 1) >> 1;
    const int ia[2] = {clip3(0, 51, av + oa), clip3(0, 51, qc + oa)};
    const int ib[2] = {clip3(0, 51, av + ob), clip3(0, 51, qc + ob)};
    for (int ce = 0; ce < 2; ++ce) {
      for (int j = 0; j < 8; ++j)
        C[16 + 16 * ce + 8 * p + j] = (uint8_t)__ldg(
            in.tc0 + 3 * ia[ce] + clip3(1, 3, bsc[ce][j]) - 1);
      C[48 + 2 * ce + p] = (uint8_t)__ldg(in.alpha + ia[ce]);
      C[52 + 2 * ce + p] = (uint8_t)__ldg(in.beta + ib[ce]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
deblock_params_kernel(Inputs in, int F, uint8_t* __restrict__ prm) {
  __shared__ uint4 s_rows[kThreads * kRow / 16];
  const int n = in.mb_w * in.mb_h;
  const long long M = (long long)F * n;
  const long long m0 = (long long)blockIdx.x * kThreads;
  const long long m = m0 + threadIdx.x;
  if (m < M) {
    uint8_t* o = (uint8_t*)s_rows + threadIdx.x * kRow;
    direction(in, m / n, (int)(m % n), false, o);
    direction(in, m / n, (int)(m % n), true, o);
  }
  __syncthreads();
  const long long rows = M - m0 < kThreads ? M - m0 : kThreads;
  uint4* g = (uint4*)(prm + m0 * kRow);
  for (int t = threadIdx.x; t < rows * (kRow / 16); t += kThreads)
    g[t] = s_rows[t];
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
  const int blocks = (int)((M + kThreads - 1) / kThreads);
  if (blocks > 0)
    deblock_params_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        in, F, (uint8_t*)prm);
  return (int)cudaGetLastError();
}
