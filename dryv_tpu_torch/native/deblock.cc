// Copy of dryv_tpu/native/deblock.cc.
// In-loop deblocking filter (H.264 spec 8.7), native scalar implementation.
//
// Port of dryv_tpu/refimpl/deblock.py (the oracle-validated Python
// reference) for the performance path: progressive frames, I/SI/P/B,
// 4:2:0 / 4:2:2 / monochrome, per-slice control, B two-list bS rules.
// The upstream reference decoder has no deblocking at all (README.md:14).

#include <cstdint>
#include <cstdlib>
#include <algorithm>

namespace {

const uint8_t kAlpha[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28,
    32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182,
    203, 226, 255, 255};
const uint8_t kBeta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8,
    9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16,
    17, 17, 18, 18};
const uint8_t kTc0[52][3] = {
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 1},
    {0, 0, 1}, {0, 0, 1}, {0, 0, 1}, {0, 1, 1}, {0, 1, 1}, {1, 1, 1},
    {1, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 2}, {1, 1, 2}, {1, 1, 2},
    {1, 1, 2}, {1, 2, 3}, {1, 2, 3}, {2, 2, 3}, {2, 2, 4}, {2, 3, 4},
    {2, 3, 4}, {3, 3, 5}, {3, 4, 6}, {3, 4, 6}, {4, 5, 7}, {4, 5, 8},
    {4, 6, 9}, {5, 7, 10}, {6, 8, 11}, {6, 8, 13}, {7, 10, 14},
    {8, 11, 16}, {9, 12, 18}, {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

inline int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}
inline int clip1(int v) { return clip3(0, 255, v); }

struct Ctx {
  uint8_t *y, *cb, *cr;
  int mb_w, mb_h, cat;  // chroma_array_type
  const int32_t* qpy;   // [mb] effective luma QP (I_PCM -> 0)
  const int32_t* qpc0;  // [mb]
  const int32_t* qpc1;
  const uint8_t* intra;  // [mb]
  const uint8_t* t8;
  const int32_t* sid;
  const int32_t* ctl;  // [n_slices][3] disable, offA, offB
  const uint8_t* nz4;  // [H4*W4]
  const int32_t* mv;   // [H4*W4*2]
  const int32_t* mv1;
  const int32_t* ref;  // [H4*W4] picture keys; -1 unused/intra
  const int32_t* ref1;
  int W4;

  // boundary strength for the 4x4 pair (8.7.2.1 frames, B mv-set rules)
  int bs(int bpy, int bpx, int bqy, int bqx, bool mb_edge) const {
    int pm = (bpy / 4) * mb_w + bpx / 4;
    int qm = (bqy / 4) * mb_w + bqx / 4;
    if (intra[pm] || intra[qm]) return mb_edge ? 4 : 3;
    int pi = bpy * W4 + bpx, qi = bqy * W4 + bqx;
    if (nz4[pi] || nz4[qi]) return 2;
    int pk[2], qk[2];
    const int32_t* pv[2];
    const int32_t* qv[2];
    int np = 0, nq = 0;
    if (ref[pi] >= 0) { pk[np] = ref[pi]; pv[np++] = &mv[pi * 2]; }
    if (ref1 && ref1[pi] >= 0) { pk[np] = ref1[pi]; pv[np++] = &mv1[pi * 2]; }
    if (ref[qi] >= 0) { qk[nq] = ref[qi]; qv[nq++] = &mv[qi * 2]; }
    if (ref1 && ref1[qi] >= 0) { qk[nq] = ref1[qi]; qv[nq++] = &mv1[qi * 2]; }
    if (np != nq) return 1;
    auto far = [](const int32_t* a, const int32_t* b) {
      return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4;
    };
    if (np == 1) return pk[0] != qk[0] ? 1 : (far(pv[0], qv[0]) ? 1 : 0);
    // two mvs each: compare as sets of (picture, mv)
    if (std::min(pk[0], pk[1]) != std::min(qk[0], qk[1]) ||
        std::max(pk[0], pk[1]) != std::max(qk[0], qk[1]))
      return 1;
    if (pk[0] != pk[1]) {
      const int32_t* q_for_p0 = (qk[0] == pk[0]) ? qv[0] : qv[1];
      const int32_t* q_for_p1 = (qk[0] == pk[0]) ? qv[1] : qv[0];
      return (far(pv[0], q_for_p0) || far(pv[1], q_for_p1)) ? 1 : 0;
    }
    bool d1 = far(pv[0], qv[0]) || far(pv[1], qv[1]);
    bool d2 = far(pv[0], qv[1]) || far(pv[1], qv[0]);
    return (d1 && d2) ? 1 : 0;
  }

  // filter one luma line across an edge; p[0] nearest edge
  static void line_luma(uint8_t* p[4], uint8_t* q[4], int bS, int alpha,
                        int beta, int tc0) {
    int p0 = *p[0], p1 = *p[1], p2 = *p[2], p3 = *p[3];
    int q0 = *q[0], q1 = *q[1], q2 = *q[2], q3 = *q[3];
    if (std::abs(p0 - q0) >= alpha || std::abs(p1 - p0) >= beta ||
        std::abs(q1 - q0) >= beta)
      return;
    int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
    if (bS < 4) {
      int tc = tc0 + (ap < beta) + (aq < beta);
      int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
      *p[0] = (uint8_t)clip1(p0 + delta);
      *q[0] = (uint8_t)clip1(q0 - delta);
      if (ap < beta)
        *p[1] = (uint8_t)(p1 + clip3(-tc0, tc0,
                 (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1));
      if (aq < beta)
        *q[1] = (uint8_t)(q1 + clip3(-tc0, tc0,
                 (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1));
    } else {
      bool small = std::abs(p0 - q0) < (alpha >> 2) + 2;
      if (ap < beta && small) {
        *p[0] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
        *p[1] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
        *p[2] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
      } else {
        *p[0] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
      }
      if (aq < beta && small) {
        *q[0] = (uint8_t)((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
        *q[1] = (uint8_t)((q2 + q1 + q0 + p0 + 2) >> 2);
        *q[2] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
      } else {
        *q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
      }
    }
  }

  static void line_chroma(uint8_t* p[2], uint8_t* q[2], int bS, int alpha,
                          int beta, int tc0) {
    int p0 = *p[0], p1 = *p[1];
    int q0 = *q[0], q1 = *q[1];
    if (std::abs(p0 - q0) >= alpha || std::abs(p1 - p0) >= beta ||
        std::abs(q1 - q0) >= beta)
      return;
    if (bS < 4) {
      int tc = tc0 + 1;
      int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
      *p[0] = (uint8_t)clip1(p0 + delta);
      *q[0] = (uint8_t)clip1(q0 - delta);
    } else {
      *p[0] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
      *q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    }
  }

  void edge_luma(int mx, int my, int e, bool vertical, int offa, int offb) {
    bool mb_edge = e == 0;
    int W = mb_w * 16;
    int pm = mb_edge ? (vertical ? my * mb_w + mx - 1 : (my - 1) * mb_w + mx)
                     : my * mb_w + mx;
    int qm = my * mb_w + mx;
    int bs4[4];
    bool any = false;
    for (int g = 0; g < 4; g++) {
      int v;
      if (vertical) {
        int bqx = mx * 4 + e / 4, by = my * 4 + g;
        v = bs(by, bqx - 1, by, bqx, mb_edge);
      } else {
        int bqy = my * 4 + e / 4, bx = mx * 4 + g;
        v = bs(bqy - 1, bx, bqy, bx, mb_edge);
      }
      bs4[g] = v;
      any |= v != 0;
    }
    if (!any) return;
    int qpav = (qpy[pm] + qpy[qm] + 1) >> 1;
    int ia = clip3(0, 51, qpav + offa);
    int ib = clip3(0, 51, qpav + offb);
    int alpha = kAlpha[ia], beta = kBeta[ib];
    for (int line = 0; line < 16; line++) {
      int bS = bs4[line >> 2];
      if (!bS) continue;
      int tc0 = kTc0[ia][bS - 1];
      uint8_t *p[4], *q[4];
      if (vertical) {
        uint8_t* row = y + (int64_t)(my * 16 + line) * W + mx * 16 + e;
        for (int k = 0; k < 4; k++) { p[k] = row - 1 - k; q[k] = row + k; }
      } else {
        uint8_t* col = y + (int64_t)(my * 16 + e) * W + mx * 16 + line;
        for (int k = 0; k < 4; k++) {
          p[k] = col - (int64_t)(1 + k) * W;
          q[k] = col + (int64_t)k * W;
        }
      }
      line_luma(p, q, bS, alpha, beta, tc0);
    }
  }

  void edge_chroma(int mx, int my, int e, bool vertical, int offa,
                   int offb) {
    bool mb_edge = e == 0;
    int sub_h = cat == 1 ? 2 : 1;
    int cw = 8, ch = cat == 1 ? 8 : 16;
    int CW = mb_w * cw;
    int pm = mb_edge ? (vertical ? my * mb_w + mx - 1 : (my - 1) * mb_w + mx)
                     : my * mb_w + mx;
    int qm = my * mb_w + mx;
    int lines = vertical ? ch : cw;
    for (int c = 0; c < 2; c++) {
      const int32_t* qpc = c == 0 ? qpc0 : qpc1;
      uint8_t* plane = c == 0 ? cb : cr;
      int qpav = (qpc[pm] + qpc[qm] + 1) >> 1;
      int ia = clip3(0, 51, qpav + offa);
      int ib = clip3(0, 51, qpav + offb);
      int alpha = kAlpha[ia], beta = kBeta[ib];
      for (int line = 0; line < lines; line++) {
        int bS;
        if (vertical) {
          int lbx = mx * 4 + (e * 2) / 4;
          int lby = ((my * ch + line) * sub_h) / 4;
          bS = bs(lby, lbx - 1, lby, lbx, mb_edge);
        } else {
          int lby = ((my * ch + e) * sub_h) / 4;
          int lbx = ((mx * cw + line) * 2) / 4;
          bS = bs(lby - 1, lbx, lby, lbx, mb_edge);
        }
        if (!bS) continue;
        int tc0 = kTc0[ia][bS - 1];
        uint8_t *p[2], *q[2];
        if (vertical) {
          uint8_t* row = plane + (int64_t)(my * ch + line) * CW +
                         mx * cw + e;
          p[0] = row - 1; p[1] = row - 2; q[0] = row; q[1] = row + 1;
        } else {
          uint8_t* col = plane + (int64_t)(my * ch + e) * CW +
                         mx * cw + line;
          p[0] = col - CW; p[1] = col - 2 * CW; q[0] = col; q[1] = col + CW;
        }
        line_chroma(p, q, bS, alpha, beta, tc0);
      }
    }
  }

  void run() {
    for (int my = 0; my < mb_h; my++) {
      for (int mx = 0; mx < mb_w; mx++) {
        int m = my * mb_w + mx;
        const int32_t* c = &ctl[sid[m] * 3];
        int dis = c[0], offa = c[1], offb = c[2];
        if (dis == 1) continue;
        auto skip = [&](bool vertical) {
          int pm = vertical ? m - 1 : m - mb_w;
          return dis == 2 && sid[pm] != sid[m];
        };
        for (int vpass = 1; vpass >= 0; vpass--) {
          bool vertical = vpass == 1;
          int step = t8[m] ? 8 : 4;
          for (int e = 0; e < 16; e += step) {
            if (e == 0) {
              if ((vertical && mx == 0) || (!vertical && my == 0)) continue;
              if (skip(vertical)) continue;
            }
            edge_luma(mx, my, e, vertical, offa, offb);
          }
        }
        if (cat == 1 || cat == 2) {
          for (int e = 0; e < 8; e += 4) {
            if (e == 0 && (mx == 0 || skip(true))) continue;
            edge_chroma(mx, my, e, true, offa, offb);
          }
          int hmax = cat == 1 ? 8 : 16;
          for (int e = 0; e < hmax; e += 4) {
            if (e == 0 && (my == 0 || skip(false))) continue;
            edge_chroma(mx, my, e, false, offa, offb);
          }
        }
      }
    }
  }
};

}  // namespace

extern "C" {

int dt_deblock_frame(uint8_t* y, uint8_t* cb, uint8_t* cr, int32_t mb_w,
                     int32_t mb_h, int32_t cat, const int32_t* qpy,
                     const int32_t* qpc0, const int32_t* qpc1,
                     const uint8_t* intra, const uint8_t* t8,
                     const int32_t* sid, const int32_t* ctl,
                     const uint8_t* nz4, const int32_t* mv,
                     const int32_t* mv1, const int32_t* ref,
                     const int32_t* ref1) {
  Ctx c;
  c.y = y; c.cb = cb; c.cr = cr;
  c.mb_w = mb_w; c.mb_h = mb_h; c.cat = cat;
  c.qpy = qpy; c.qpc0 = qpc0; c.qpc1 = qpc1;
  c.intra = intra; c.t8 = t8; c.sid = sid; c.ctl = ctl;
  c.nz4 = nz4; c.mv = mv; c.mv1 = mv1; c.ref = ref; c.ref1 = ref1;
  c.W4 = mb_w * 4;
  c.run();
  return 0;
}

}  // extern "C"
