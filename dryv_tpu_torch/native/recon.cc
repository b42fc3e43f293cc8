// Copy of dryv_tpu/native/recon.cc.
// Native scalar intra reconstruction (CPU path).
//
// Mirror of dryv_tpu/refimpl (itself bit-exact vs libavcodec): inverse
// transforms (spec 8.5) + intra prediction (spec 8.3) + per-MB frame loop.
// Two uses: (a) CPU fallback decode path, (b) the single-threaded
// C++ full-decode baseline that stands in for the reference decoder's
// Rust CPU performance in bench.py (cargo is not available in this image;
// see BASELINE.md).
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum : int { KIND_I4 = 0, KIND_I8 = 1, KIND_I16 = 2, KIND_PCM = 3,
             KIND_P = 4, KIND_P8X8 = 5, KIND_P_SKIP = 6, KIND_B = 7,
             KIND_B8X8 = 8, KIND_B_SKIP = 9, KIND_B_DIRECT = 10,
             KIND_SI = 11 };

struct ZPosR { int x, y; };
constexpr ZPosR kZ[16] = {
  {0,0},{1,0},{0,1},{1,1},{2,0},{3,0},{2,1},{3,1},
  {0,2},{1,2},{0,3},{1,3},{2,2},{3,2},{2,3},{3,3}};

const int kZig4[16] = {0,1,4,8,5,2,3,6,9,12,13,10,7,11,14,15};
const int kZig8[64] = {
  0,1,8,16,9,2,3,10,17,24,32,25,18,11,4,5,
  12,19,26,33,40,48,41,34,27,20,13,6,7,14,21,28,
  35,42,49,56,57,50,43,36,29,22,15,23,30,37,44,51,
  58,59,52,45,38,31,39,46,53,60,61,54,47,55,62,63};

// normAdjust tables (spec 8.5.9), flat-16 weight scale baked in
const int kV4[6][3] = {{10,16,13},{11,18,14},{13,20,16},
                       {14,23,18},{16,25,20},{18,29,23}};
const int kV8[6][6] = {{20,18,32,19,25,24},{22,19,35,21,28,26},
                       {26,23,42,24,33,31},{28,25,45,26,35,33},
                       {32,28,51,30,40,38},{36,32,58,34,46,43}};

int ls4(int m, int i, int j) {
  int cls = (i % 2 == 0 && j % 2 == 0) ? 0 : (i % 2 == 1 && j % 2 == 1) ? 1 : 2;
  return 16 * kV4[m][cls];
}
int ls8(int m, int i, int j) {
  int cls;
  if (i % 4 == 0 && j % 4 == 0) cls = 0;
  else if (i % 2 == 1 && j % 2 == 1) cls = 1;
  else if (i % 4 == 2 && j % 4 == 2) cls = 2;
  else if ((i % 4 == 0 && j % 2 == 1) || (i % 2 == 1 && j % 4 == 0)) cls = 3;
  else if ((i % 4 == 0 && j % 4 == 2) || (i % 4 == 2 && j % 4 == 0)) cls = 4;
  else cls = 5;
  return 16 * kV8[m][cls];
}

const int kQpcTab[22] = {29,30,31,32,32,33,34,34,35,35,36,36,37,
                         37,37,38,38,38,39,39,39,39};
int qpc_from_qpy(int qpy, int off) {
  int qpi = qpy + off;
  if (qpi < 0) qpi = 0;
  if (qpi > 51) qpi = 51;
  return qpi < 30 ? qpi : kQpcTab[qpi - 30];
}

void idct4(int64_t d[4][4], int64_t r[4][4]) {
  int64_t f[4][4];
  for (int i = 0; i < 4; i++) {
    int64_t e0 = d[i][0] + d[i][2], e1 = d[i][0] - d[i][2];
    int64_t e2 = (d[i][1] >> 1) - d[i][3], e3 = d[i][1] + (d[i][3] >> 1);
    f[i][0] = e0 + e3; f[i][1] = e1 + e2; f[i][2] = e1 - e2; f[i][3] = e0 - e3;
  }
  for (int j = 0; j < 4; j++) {
    int64_t g0 = f[0][j] + f[2][j], g1 = f[0][j] - f[2][j];
    int64_t g2 = (f[1][j] >> 1) - f[3][j], g3 = f[1][j] + (f[3][j] >> 1);
    r[0][j] = (g0 + g3 + 32) >> 6;
    r[1][j] = (g1 + g2 + 32) >> 6;
    r[2][j] = (g1 - g2 + 32) >> 6;
    r[3][j] = (g0 - g3 + 32) >> 6;
  }
}

void dequant4(const int32_t* raster, int qp, bool i16_shift, int64_t out[4][4],
              int64_t dc_override, bool has_dc) {
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) {
      int64_t v = raster[i * 4 + j];
      int64_t d;
      if (qp >= 24) d = (v * ls4(qp % 6, i, j)) << (qp / 6 - 4);
      else d = (v * ls4(qp % 6, i, j) + (1 << (3 - qp / 6))) >> (4 - qp / 6);
      out[i][j] = d;
    }
  if (has_dc) out[0][0] = dc_override;
}

void idct8_stage(int64_t m[8][8], bool rows) {
  int64_t tmp[8];
  for (int i = 0; i < 8; i++) {
    int64_t c[8];
    for (int k = 0; k < 8; k++) c[k] = rows ? m[i][k] : m[k][i];
    int64_t e0 = c[0] + c[4];
    int64_t e1 = -c[3] + c[5] - c[7] - (c[7] >> 1);
    int64_t e2 = c[0] - c[4];
    int64_t e3 = c[1] + c[7] - c[3] - (c[3] >> 1);
    int64_t e4 = (c[2] >> 1) - c[6];
    int64_t e5 = -c[1] + c[7] + c[5] + (c[5] >> 1);
    int64_t e6 = c[2] + (c[6] >> 1);
    int64_t e7 = c[3] + c[5] + c[1] + (c[1] >> 1);
    int64_t f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4;
    int64_t f3 = e3 + (e5 >> 2), f4 = e2 - e4, f5 = (e3 >> 2) - e5;
    int64_t f6 = e0 - e6, f7 = e7 - (e1 >> 2);
    tmp[0] = f0 + f7; tmp[1] = f2 + f5; tmp[2] = f4 + f3; tmp[3] = f6 + f1;
    tmp[4] = f6 - f1; tmp[5] = f4 - f3; tmp[6] = f2 - f5; tmp[7] = f0 - f7;
    for (int k = 0; k < 8; k++) { if (rows) m[i][k] = tmp[k]; else m[k][i] = tmp[k]; }
  }
}

struct Plane {
  uint8_t* p;
  int w, h, stride;
  int at(int x, int y) const { return p[y * stride + x]; }
  void set(int x, int y, int v) { p[y * stride + x] = (uint8_t)v; }
};

inline int clip255(int64_t v) { return v < 0 ? 0 : v > 255 ? 255 : (int)v; }

struct Recon {
  // dense inputs (same layout as native/entropy.py Out)
  const int32_t *kind, *qp_y, *cbp, *i16_mode, *chroma_mode;
  const int32_t *modes4, *modes8;
  const int32_t *luma4, *luma8, *luma_dc, *chroma_dc_lv, *chroma_ac;
  const int32_t *pcm_y, *pcm_c, *slice_id;
  const int32_t *transform8 = nullptr;  // [n] inter-MB 8x8-transform flags
  int mb_w, mb_h, qp_off_cb, qp_off_cr;
  Plane Y, Cb, Cr;
  // availability maps
  const uint8_t* blk_done;  // internal
  uint8_t* blk_done_m;
  uint8_t* mb_done_m;

  bool luma_avail(int x, int y, int sid) const {
    if (x < 0 || y < 0 || x >= Y.w || y >= Y.h) return false;
    if (!blk_done_m[(y >> 2) * (mb_w * 4) + (x >> 2)]) return false;
    return slice_id[(y >> 4) * mb_w + (x >> 4)] == sid;
  }
  bool mb_avail(int mx, int my, int sid) const {
    if (mx < 0 || my < 0 || mx >= mb_w || my >= mb_h) return false;
    if (!mb_done_m[my * mb_w + mx]) return false;
    return slice_id[my * mb_w + mx] == sid;
  }

  // ---- predictors (spec 8.3) --------------------------------------
  void pred4(int mode, const int64_t* a, const int64_t* l, int64_t z,
             bool aa, bool ab, int64_t p[4][4]) {
    switch (mode) {
      case 0: for (int y=0;y<4;y++) for (int x=0;x<4;x++) p[y][x]=a[x]; break;
      case 1: for (int y=0;y<4;y++) for (int x=0;x<4;x++) p[y][x]=l[y]; break;
      case 2: {
        int64_t v;
        if (aa && ab) v = (a[0]+a[1]+a[2]+a[3]+l[0]+l[1]+l[2]+l[3]+4)>>3;
        else if (aa) v = (l[0]+l[1]+l[2]+l[3]+2)>>2;
        else if (ab) v = (a[0]+a[1]+a[2]+a[3]+2)>>2;
        else v = 128;
        for (int y=0;y<4;y++) for (int x=0;x<4;x++) p[y][x]=v;
        break; }
      case 3:
        for (int y=0;y<4;y++) for (int x=0;x<4;x++) {
          if (x==3 && y==3) p[y][x]=(a[6]+3*a[7]+2)>>2;
          else { int i=x+y; p[y][x]=(a[i]+2*a[i+1]+a[i+2]+2)>>2; }
        }
        break;
      case 4:
        for (int y=0;y<4;y++) for (int x=0;x<4;x++) {
          if (x>y){int i=x-y; int64_t s2=i>=2?a[i-2]:z; p[y][x]=(s2+2*a[i-1]+a[i]+2)>>2;}
          else if (x<y){int i=y-x; int64_t s2=i>=2?l[i-2]:z; p[y][x]=(s2+2*l[i-1]+l[i]+2)>>2;}
          else p[y][x]=(a[0]+2*z+l[0]+2)>>2;
        }
        break;
      case 5:
        for (int y=0;y<4;y++) for (int x=0;x<4;x++) {
          int zvr=2*x-y;
          if (zvr>=0 && zvr%2==0){int i=x-(y>>1); p[y][x]=((i==0?z:a[i-1])+a[i]+1)>>1;}
          else if (zvr>=0){int i=x-(y>>1); int64_t s0=i>=2?a[i-2]:z; int64_t s1=i>=1?a[i-1]:z; p[y][x]=(s0+2*s1+a[i]+2)>>2;}
          else if (zvr==-1) p[y][x]=(l[0]+2*z+a[0]+2)>>2;
          else {int64_t s3=y>=3?l[y-3]:z; p[y][x]=(l[y-1]+2*l[y-2]+s3+2)>>2;}
        }
        break;
      case 6:
        for (int y=0;y<4;y++) for (int x=0;x<4;x++) {
          int zhd=2*y-x;
          if (zhd>=0 && zhd%2==0){int i=y-(x>>1); p[y][x]=((i==0?z:l[i-1])+l[i]+1)>>1;}
          else if (zhd>=0){int i=y-(x>>1); int64_t s0=i>=2?l[i-2]:z; int64_t s1=i>=1?l[i-1]:z; p[y][x]=(s0+2*s1+l[i]+2)>>2;}
          else if (zhd==-1) p[y][x]=(a[0]+2*z+l[0]+2)>>2;
          else {int64_t s3=x>=3?a[x-3]:z; p[y][x]=(a[x-1]+2*a[x-2]+s3+2)>>2;}
        }
        break;
      case 7:
        for (int y=0;y<4;y++) for (int x=0;x<4;x++) {
          int i=x+(y>>1);
          if (y%2==0) p[y][x]=(a[i]+a[i+1]+1)>>1;
          else p[y][x]=(a[i]+2*a[i+1]+a[i+2]+2)>>2;
        }
        break;
      default:
        for (int y=0;y<4;y++) for (int x=0;x<4;x++) {
          int zhu=x+2*y;
          if (zhu<5 && zhu%2==0){int i=y+(x>>1); p[y][x]=(l[i]+l[i+1]+1)>>1;}
          else if (zhu<5){int i=y+(x>>1); p[y][x]=(l[i]+2*l[i+1]+l[i+2]+2)>>2;}
          else if (zhu==5) p[y][x]=(l[2]+3*l[3]+2)>>2;
          else p[y][x]=l[3];
        }
        break;
    }
  }

  void pred8(int mode, const int64_t* a, const int64_t* l, int64_t z,
             bool aa, bool ab, int64_t p[8][8]) {
    switch (mode) {
      case 0: for (int y=0;y<8;y++) for (int x=0;x<8;x++) p[y][x]=a[x]; break;
      case 1: for (int y=0;y<8;y++) for (int x=0;x<8;x++) p[y][x]=l[y]; break;
      case 2: {
        int64_t sa=0, sl=0;
        for (int i=0;i<8;i++){sa+=a[i]; sl+=l[i];}
        int64_t v;
        if (aa&&ab) v=(sa+sl+8)>>4; else if (aa) v=(sl+4)>>3;
        else if (ab) v=(sa+4)>>3; else v=128;
        for (int y=0;y<8;y++) for (int x=0;x<8;x++) p[y][x]=v;
        break; }
      case 3:
        for (int y=0;y<8;y++) for (int x=0;x<8;x++) {
          if (x==7&&y==7) p[y][x]=(a[14]+3*a[15]+2)>>2;
          else {int i=x+y; p[y][x]=(a[i]+2*a[i+1]+a[i+2]+2)>>2;}
        }
        break;
      case 4:
        for (int y=0;y<8;y++) for (int x=0;x<8;x++) {
          if (x>y){int i=x-y; int64_t s2=i>=2?a[i-2]:z; p[y][x]=(s2+2*a[i-1]+a[i]+2)>>2;}
          else if (x<y){int i=y-x; int64_t s2=i>=2?l[i-2]:z; int64_t s1=i>=1?l[i-1]:z; p[y][x]=(s2+2*s1+l[i]+2)>>2;}
          else p[y][x]=(a[0]+2*z+l[0]+2)>>2;
        }
        break;
      case 5:
        for (int y=0;y<8;y++) for (int x=0;x<8;x++) {
          int zvr=2*x-y;
          if (zvr>=0 && zvr%2==0){int i=x-(y>>1); p[y][x]=((i==0?z:a[i-1])+a[i]+1)>>1;}
          else if (zvr>=0){int i=x-(y>>1); int64_t s0=i>=2?a[i-2]:z; int64_t s1=i>=1?a[i-1]:z; p[y][x]=(s0+2*s1+a[i]+2)>>2;}
          else if (zvr==-1) p[y][x]=(l[0]+2*z+a[0]+2)>>2;
          else {int i=y-2*x; int64_t s3=i>=3?l[i-3]:z; p[y][x]=(l[i-1]+2*l[i-2]+s3+2)>>2;}
        }
        break;
      case 6:
        for (int y=0;y<8;y++) for (int x=0;x<8;x++) {
          int zhd=2*y-x;
          if (zhd>=0 && zhd%2==0){int i=y-(x>>1); p[y][x]=((i==0?z:l[i-1])+l[i]+1)>>1;}
          else if (zhd>=0){int i=y-(x>>1); int64_t s0=i>=2?l[i-2]:z; int64_t s1=i>=1?l[i-1]:z; p[y][x]=(s0+2*s1+l[i]+2)>>2;}
          else if (zhd==-1) p[y][x]=(a[0]+2*z+l[0]+2)>>2;
          else {int i=x-2*y; int64_t s3=i>=3?a[i-3]:z; p[y][x]=(a[i-1]+2*a[i-2]+s3+2)>>2;}
        }
        break;
      case 7:
        for (int y=0;y<8;y++) for (int x=0;x<8;x++) {
          int i=x+(y>>1);
          if (y%2==0) p[y][x]=(a[i]+a[i+1]+1)>>1;
          else p[y][x]=(a[i]+2*a[i+1]+a[i+2]+2)>>2;
        }
        break;
      default:
        for (int y=0;y<8;y++) for (int x=0;x<8;x++) {
          int zhu=x+2*y;
          if (zhu<13 && zhu%2==0){int i=y+(x>>1); p[y][x]=(l[i]+l[i+1]+1)>>1;}
          else if (zhu<13){int i=y+(x>>1); p[y][x]=(l[i]+2*l[i+1]+l[i+2]+2)>>2;}
          else if (zhu==13) p[y][x]=(l[6]+3*l[7]+2)>>2;
          else p[y][x]=l[7];
        }
        break;
    }
  }

  void recon_i4(int addr, int mx, int my, int sid) {
    int qp = qp_y[addr];
    for (int blk = 0; blk < 16; blk++) {
      int bx = mx * 4 + kZ[blk].x, by = my * 4 + kZ[blk].y;
      int x0 = bx * 4, y0 = by * 4;
      bool aa = luma_avail(x0 - 1, y0, sid);
      bool ab = luma_avail(x0, y0 - 1, sid);
      bool ac = luma_avail(x0 + 4, y0 - 1, sid);
      bool ad = luma_avail(x0 - 1, y0 - 1, sid);
      int64_t a[8] = {0}, l[4] = {0}, z = 0;
      if (ab) {
        for (int i = 0; i < 4; i++) a[i] = Y.at(x0 + i, y0 - 1);
        for (int i = 4; i < 8; i++)
          a[i] = ac ? Y.at(x0 + i, y0 - 1) : a[3];
      }
      if (aa) for (int i = 0; i < 4; i++) l[i] = Y.at(x0 - 1, y0 + i);
      if (ad) z = Y.at(x0 - 1, y0 - 1);
      int64_t d[4][4], r[4][4], p[4][4];
      dequant4(luma4 + ((int64_t)addr * 16 + blk) * 16, qp, false, d, 0, false);
      idct4(d, r);
      pred4(modes4[addr * 16 + blk], a, l, z, aa, ab, p);
      for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++)
          Y.set(x0 + j, y0 + i, clip255(p[i][j] + r[i][j]));
      blk_done_m[by * (mb_w * 4) + bx] = 1;
    }
  }

  void recon_i8(int addr, int mx, int my, int sid) {
    int qp = qp_y[addr];
    for (int blk = 0; blk < 4; blk++) {
      int x0 = mx * 16 + (blk & 1) * 8, y0 = my * 16 + (blk >> 1) * 8;
      bool aa = luma_avail(x0 - 1, y0, sid);
      bool ab = luma_avail(x0, y0 - 1, sid);
      bool ac = luma_avail(x0 + 8, y0 - 1, sid);
      bool ad = luma_avail(x0 - 1, y0 - 1, sid);
      int64_t a[16] = {0}, l[8] = {0}, z = 0;
      if (ab) {
        for (int i = 0; i < 8; i++) a[i] = Y.at(x0 + i, y0 - 1);
        for (int i = 8; i < 16; i++) a[i] = ac ? Y.at(x0 + i, y0 - 1) : a[7];
      }
      if (aa) for (int i = 0; i < 8; i++) l[i] = Y.at(x0 - 1, y0 + i);
      if (ad) z = Y.at(x0 - 1, y0 - 1);
      // filter (8.3.2.2.1)
      int64_t fa[16], fl[8], fz = z;
      std::memcpy(fa, a, sizeof(fa));
      std::memcpy(fl, l, sizeof(fl));
      if (ab) {
        fa[0] = ad ? (z + 2*a[0] + a[1] + 2) >> 2 : (3*a[0] + a[1] + 2) >> 2;
        for (int x = 1; x < 15; x++) fa[x] = (a[x-1] + 2*a[x] + a[x+1] + 2) >> 2;
        fa[15] = (a[14] + 3*a[15] + 2) >> 2;
      }
      if (ad) {
        if (aa && ab) fz = (a[0] + 2*z + l[0] + 2) >> 2;
        else if (ab) fz = (3*z + a[0] + 2) >> 2;
        else if (aa) fz = (3*z + l[0] + 2) >> 2;
      }
      if (aa) {
        fl[0] = ad ? (z + 2*l[0] + l[1] + 2) >> 2 : (3*l[0] + l[1] + 2) >> 2;
        for (int y = 1; y < 7; y++) fl[y] = (l[y-1] + 2*l[y] + l[y+1] + 2) >> 2;
        fl[7] = (l[6] + 3*l[7] + 2) >> 2;
      }
      // dequant + idct8 (coefficients arrive raster order)
      int64_t d[8][8];
      const int32_t* c = luma8 + ((int64_t)addr * 4 + blk) * 64;
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
          int64_t v = c[i * 8 + j];
          if (qp >= 36) d[i][j] = (v * ls8(qp % 6, i, j)) << (qp / 6 - 6);
          else d[i][j] = (v * ls8(qp % 6, i, j) + (1 << (5 - qp / 6))) >> (6 - qp / 6);
        }
      idct8_stage(d, true);
      idct8_stage(d, false);
      int64_t p[8][8];
      pred8(modes8[addr * 4 + blk], fa, fl, fz, aa, ab, p);
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
          Y.set(x0 + j, y0 + i, clip255(p[i][j] + ((d[i][j] + 32) >> 6)));
      int bby = y0 / 4, bbx = x0 / 4;
      for (int i = 0; i < 2; i++)
        for (int j = 0; j < 2; j++)
          blk_done_m[(bby + i) * (mb_w * 4) + bbx + j] = 1;
    }
  }

  void recon_i16(int addr, int mx, int my, int sid) {
    int qp = qp_y[addr];
    int x0 = mx * 16, y0 = my * 16;
    bool aa = mb_avail(mx - 1, my, sid);
    bool ab = mb_avail(mx, my - 1, sid);
    bool ad = mb_avail(mx - 1, my - 1, sid);
    int64_t a[16] = {0}, l[16] = {0}, z = 0;
    if (ab) for (int i = 0; i < 16; i++) a[i] = Y.at(x0 + i, y0 - 1);
    if (aa) for (int i = 0; i < 16; i++) l[i] = Y.at(x0 - 1, y0 + i);
    if (ad) z = Y.at(x0 - 1, y0 - 1);
    int64_t pred[16][16];
    int mode = i16_mode[addr];
    if (mode == 0) {
      for (int y = 0; y < 16; y++) for (int x = 0; x < 16; x++) pred[y][x] = a[x];
    } else if (mode == 1) {
      for (int y = 0; y < 16; y++) for (int x = 0; x < 16; x++) pred[y][x] = l[y];
    } else if (mode == 2) {
      int64_t sa = 0, sl = 0;
      for (int i = 0; i < 16; i++) { sa += a[i]; sl += l[i]; }
      int64_t v = (aa && ab) ? (sa + sl + 16) >> 5 : aa ? (sl + 8) >> 4
                   : ab ? (sa + 8) >> 4 : 128;
      for (int y = 0; y < 16; y++) for (int x = 0; x < 16; x++) pred[y][x] = v;
    } else {
      int64_t hh = 0, vv = 0;
      for (int x = 0; x < 8; x++) hh += (x + 1) * (a[8 + x] - (x < 7 ? a[6 - x] : z));
      for (int y = 0; y < 8; y++) vv += (y + 1) * (l[8 + y] - (y < 7 ? l[6 - y] : z));
      int64_t b = (5 * hh + 32) >> 6, cc = (5 * vv + 32) >> 6;
      int64_t av = 16 * (a[15] + l[15]);
      for (int y = 0; y < 16; y++)
        for (int x = 0; x < 16; x++)
          pred[y][x] = clip255((av + b * (x - 7) + cc * (y - 7) + 16) >> 5);
    }
    // DC hadamard (levels arrive raster order)
    int64_t dcz[16];
    for (int k = 0; k < 16; k++) dcz[k] = luma_dc[(int64_t)addr * 16 + k];
    int64_t t[4][4], dcv[4][4];
    static const int H[4][4] = {{1,1,1,1},{1,1,-1,-1},{1,-1,-1,1},{1,-1,1,-1}};
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) {
        int64_t s = 0;
        for (int k = 0; k < 4; k++)
          for (int mI = 0; mI < 4; mI++)
            s += (int64_t)H[i][k] * dcz[k * 4 + mI] * H[mI][j];
        int ls00 = ls4(qp % 6, 0, 0);
        if (qp >= 36) dcv[i][j] = (s * ls00) << (qp / 6 - 6);
        else dcv[i][j] = (s * ls00 + (1 << (5 - qp / 6))) >> (6 - qp / 6);
      }
    for (int blk = 0; blk < 16; blk++) {
      int bx = kZ[blk].x, by = kZ[blk].y;
      int64_t d[4][4], r[4][4];
      dequant4(luma4 + ((int64_t)addr * 16 + blk) * 16, qp, true, d,
               dcv[by][bx], true);
      idct4(d, r);
      for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++) {
          int yy = by * 4 + i, xx = bx * 4 + j;
          Y.set(x0 + xx, y0 + yy, clip255(pred[yy][xx] + r[i][j]));
        }
    }
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++)
        blk_done_m[(my * 4 + i) * (mb_w * 4) + mx * 4 + j] = 1;
  }

  void recon_chroma(int addr, int mx, int my, int sid) {
    int x0 = mx * 8, y0 = my * 8;
    bool aa = mb_avail(mx - 1, my, sid);
    bool ab = mb_avail(mx, my - 1, sid);
    bool ad = mb_avail(mx - 1, my - 1, sid);
    for (int ci = 0; ci < 2; ci++) {
      Plane& P = ci == 0 ? Cb : Cr;
      int qpc = qpc_from_qpy(qp_y[addr], ci == 0 ? qp_off_cb : qp_off_cr);
      int64_t a[8] = {0}, l[8] = {0}, z = 0;
      if (ab) for (int i = 0; i < 8; i++) a[i] = P.at(x0 + i, y0 - 1);
      if (aa) for (int i = 0; i < 8; i++) l[i] = P.at(x0 - 1, y0 + i);
      if (ad) z = P.at(x0 - 1, y0 - 1);
      int64_t pred[8][8];
      int mode = chroma_mode[addr];
      if (mode == 1) {
        for (int y = 0; y < 8; y++) for (int x = 0; x < 8; x++) pred[y][x] = l[y];
      } else if (mode == 2) {
        for (int y = 0; y < 8; y++) for (int x = 0; x < 8; x++) pred[y][x] = a[x];
      } else if (mode == 3) {
        int64_t hs = 0, vs = 0;
        for (int x = 0; x < 4; x++) hs += (x + 1) * (a[4 + x] - (x <= 2 ? a[2 - x] : z));
        for (int y = 0; y < 4; y++) vs += (y + 1) * (l[4 + y] - (y <= 2 ? l[2 - y] : z));
        int64_t b = (34 * hs + 32) >> 6, cc = (34 * vs + 32) >> 6;
        int64_t av = 16 * (a[7] + l[7]);
        for (int y = 0; y < 8; y++)
          for (int x = 0; x < 8; x++)
            pred[y][x] = clip255((av + b * (x - 3) + cc * (y - 3) + 16) >> 5);
      } else {
        for (int qy = 0; qy < 2; qy++)
          for (int qx = 0; qx < 2; qx++) {
            int64_t sa = 0, sl = 0;
            for (int i = 0; i < 4; i++) { sa += a[qx * 4 + i]; sl += l[qy * 4 + i]; }
            int64_t v;
            bool corner = (qx == 0 && qy == 0) || (qx == 1 && qy == 1);
            if (corner) {
              if (aa && ab) v = (sa + sl + 4) >> 3;
              else if (aa) v = (sl + 2) >> 2;
              else if (ab) v = (sa + 2) >> 2;
              else v = 128;
            } else if (qx == 1) {
              v = ab ? (sa + 2) >> 2 : aa ? (sl + 2) >> 2 : 128;
            } else {
              v = aa ? (sl + 2) >> 2 : ab ? (sa + 2) >> 2 : 128;
            }
            for (int y = 0; y < 4; y++)
              for (int x = 0; x < 4; x++)
                pred[qy * 4 + y][qx * 4 + x] = v;
          }
      }
      // chroma DC 2x2
      const int32_t* dcl = chroma_dc_lv + ((int64_t)addr * 2 + ci) * 8;
      int64_t f00 = dcl[0] + dcl[1] + dcl[2] + dcl[3];
      int64_t f01 = dcl[0] - dcl[1] + dcl[2] - dcl[3];
      int64_t f10 = dcl[0] + dcl[1] - dcl[2] - dcl[3];
      int64_t f11 = dcl[0] - dcl[1] - dcl[2] + dcl[3];
      int ls00 = ls4(qpc % 6, 0, 0);
      int64_t dcv[4] = {
        ((f00 * ls00) << (qpc / 6)) >> 5, ((f01 * ls00) << (qpc / 6)) >> 5,
        ((f10 * ls00) << (qpc / 6)) >> 5, ((f11 * ls00) << (qpc / 6)) >> 5};
      for (int j = 0; j < 4; j++) {
        int bx = j & 1, by = j >> 1;
        int64_t d[4][4], r[4][4];
        dequant4(chroma_ac + (((int64_t)addr * 2 + ci) * 8 + j) * 16, qpc,
                 true, d, dcv[j], true);
        idct4(d, r);
        for (int i = 0; i < 4; i++)
          for (int jj = 0; jj < 4; jj++)
            P.set(x0 + bx * 4 + jj, y0 + by * 4 + i,
                  clip255(pred[by * 4 + i][bx * 4 + jj] + r[i][jj]));
      }
    }
  }

  void run() {
    int n = mb_w * mb_h;
    for (int addr = 0; addr < n; addr++) {
      int mx = addr % mb_w, my = addr / mb_w;
      int sid = slice_id[addr];
      int k = kind[addr];
      if (k == KIND_PCM) {
        for (int i = 0; i < 16; i++)
          for (int j = 0; j < 16; j++)
            Y.set(mx * 16 + j, my * 16 + i, pcm_y[(int64_t)addr * 256 + i * 16 + j]);
        for (int i = 0; i < 8; i++)
          for (int j = 0; j < 8; j++) {
            Cb.set(mx * 8 + j, my * 8 + i, pcm_c[(int64_t)addr * 128 + i * 8 + j]);
            Cr.set(mx * 8 + j, my * 8 + i, pcm_c[(int64_t)addr * 128 + 64 + i * 8 + j]);
          }
        for (int i = 0; i < 4; i++)
          for (int j = 0; j < 4; j++)
            blk_done_m[(my * 4 + i) * (mb_w * 4) + mx * 4 + j] = 1;
        mb_done_m[addr] = 1;
        continue;
      }
      if (k == KIND_I16) recon_i16(addr, mx, my, sid);
      else if (k == KIND_I8) recon_i8(addr, mx, my, sid);
      else recon_i4(addr, mx, my, sid);
      recon_chroma(addr, mx, my, sid);
      mb_done_m[addr] = 1;
    }
  }
};

// ===== inter reconstruction (spec 8.4) — port of refimpl/inter.py =====

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// two-list motion state at 4x4 granularity (refimpl MotionState)
struct MS {
  int W4, H4;
  std::vector<int32_t> mv[2];   // [H4*W4*2]
  std::vector<int32_t> ref[2];  // [H4*W4]
  std::vector<uint8_t> dec;
  std::vector<int32_t> sid;     // slice id per block (6.4.8: a neighbor
                                // in another slice is unavailable)
  int cur_sid = -1;

  void init(int w4, int h4) {
    W4 = w4; H4 = h4;
    for (int l = 0; l < 2; l++) {
      mv[l].assign((size_t)w4 * h4 * 2, 0);
      ref[l].assign((size_t)w4 * h4, -1);
    }
    dec.assign((size_t)w4 * h4, 0);
    sid.assign((size_t)w4 * h4, -2);
  }
  bool blk(int bx, int by, int which, int64_t out[2], int* r) const {
    out[0] = out[1] = 0; *r = -1;
    if (bx < 0 || by < 0 || bx >= W4 || by >= H4) return false;
    size_t i = (size_t)by * W4 + bx;
    if (!dec[i] || sid[i] != cur_sid) return false;
    out[0] = mv[which][i * 2];
    out[1] = mv[which][i * 2 + 1];
    *r = ref[which][i];
    return true;
  }
  void set(int bx0, int by0, int w4, int h4, const int64_t m[2], int r,
           int which) {
    for (int y = by0; y < by0 + h4; y++)
      for (int x = bx0; x < bx0 + w4; x++) {
        size_t i = (size_t)y * W4 + x;
        dec[i] = 1;
        sid[i] = cur_sid;
        ref[which][i] = r;
        mv[which][i * 2] = (int32_t)m[0];
        mv[which][i * 2 + 1] = (int32_t)m[1];
      }
  }
  void set_intra(int mx, int my, int s) {
    for (int y = my * 4; y < my * 4 + 4; y++)
      for (int x = mx * 4; x < mx * 4 + 4; x++) {
        size_t i = (size_t)y * W4 + x;
        dec[i] = 1;
        sid[i] = s;
        ref[0][i] = -1;
        ref[1][i] = -1;
      }
  }
};

// parameters for one inter picture (mirrors ctypes InterParams)
struct InterParams {
  int32_t is_b;            // any B slices (direct machinery needed)
  int32_t direct_spatial;
  int32_t n_ref0, n_ref1;
  const uint8_t** ref0_y; const uint8_t** ref0_cb; const uint8_t** ref0_cr;
  const uint8_t** ref1_y; const uint8_t** ref1_cb; const uint8_t** ref1_cr;
  const int32_t* list0_keys; const int32_t* list1_keys;
  // co-located picture (ref_list1[0]) exported motion
  const int32_t* col_mv0; const int32_t* col_mv1;
  const int32_t* col_refidx0; const int32_t* col_refidx1;
  const int32_t* col_refkey0; const int32_t* col_refkey1;
  int32_t col_shortterm;
  int32_t col_default_key;  // key of col pic's list0[0] (intra col blocks)
  // temporal-direct scaling table per col reference key
  int32_t n_tk;
  const int32_t* tkeys; const int32_t* t_ref0;
  const int32_t* t_ident; const int32_t* t_dsf;
  // weighted prediction (0 none, 1 explicit, 2 implicit)
  int32_t wp_mode, wp_denom_y, wp_denom_c;
  const int32_t* wp_expl;  // [2][nref][6] = wy,oy,wcb,ocb,wcr,ocr
  int32_t wp_stride;       // nref*6 (entries per list)
  const int32_t* wp_imp;   // [n_ref0*n_ref1*2] = w0,w1
  // outputs (exported motion for DPB storage / deblock)
  int32_t* out_mv0; int32_t* out_mv1;
  int32_t* out_refidx0; int32_t* out_refidx1;
  int32_t* out_refkey0; int32_t* out_refkey1;
  uint8_t* out_nz4;
  // 1 = derive motion/nz only (no pixel work): the device MC pipeline
  // consumes the exported dense motion field instead of host MC
  int32_t motion_only;
};

struct InterRecon {
  Recon* rec;              // shared planes + intra machinery + inputs
  const InterParams* ip;
  const int32_t *mb_type_code, *sub_mb_type, *ref_idx, *mvd;
  MS ms;
  int mb_w, mb_h;

  // ---- neighbor-based MV prediction (8.4.1.3) ----------------------
  void neighbors(int bx0, int by0, int w4, int which, int64_t amv[2],
                 int* ar, bool* aa, int64_t bmv[2], int* br, bool* ab,
                 int64_t cmv[2], int* cr, bool* ac) {
    *aa = ms.blk(bx0 - 1, by0, which, amv, ar);
    *ab = ms.blk(bx0, by0 - 1, which, bmv, br);
    *ac = ms.blk(bx0 + w4, by0 - 1, which, cmv, cr);
    if (!*ac) *ac = ms.blk(bx0 - 1, by0 - 1, which, cmv, cr);
  }

  static int64_t med3(int64_t a, int64_t b, int64_t c) {
    int64_t mx = a > b ? a : b, mn = a > b ? b : a;
    return c > mx ? mx : (c < mn ? mn : c);
  }

  void median_pred(int bx0, int by0, int w4, int refv, int which,
                   int64_t out[2]) {
    int64_t amv[2], bmv[2], cmv[2];
    int ar, br, cr;
    bool aa, ab, ac;
    neighbors(bx0, by0, w4, which, amv, &ar, &aa, bmv, &br, &ab, cmv, &cr,
              &ac);
    if (!ab && !ac && aa) { out[0] = amv[0]; out[1] = amv[1]; return; }
    int hits = 0;
    const int64_t* hit = nullptr;
    if (aa && ar == refv) { hits++; hit = amv; }
    if (ab && br == refv) { hits++; hit = bmv; }
    if (ac && cr == refv) { hits++; hit = cmv; }
    if (hits == 1) { out[0] = hit[0]; out[1] = hit[1]; return; }
    out[0] = med3(amv[0], bmv[0], cmv[0]);
    out[1] = med3(amv[1], bmv[1], cmv[1]);
  }

  // shape: 0 other, 1 = 16x8, 2 = 8x16 (directional rules)
  void mv_pred(int shape, int bx0, int by0, int w4, int refv, int pidx,
               int which, int64_t out[2]) {
    if (shape == 1 || shape == 2) {
      int64_t amv[2], bmv[2], cmv[2];
      int ar, br, cr;
      bool aa, ab, ac;
      neighbors(bx0, by0, w4, which, amv, &ar, &aa, bmv, &br, &ab, cmv,
                &cr, &ac);
      if (shape == 1) {
        if (pidx == 0 && ab && br == refv) { out[0]=bmv[0]; out[1]=bmv[1]; return; }
        if (pidx == 1 && aa && ar == refv) { out[0]=amv[0]; out[1]=amv[1]; return; }
      } else {
        if (pidx == 0 && aa && ar == refv) { out[0]=amv[0]; out[1]=amv[1]; return; }
        if (pidx == 1 && ac && cr == refv) { out[0]=cmv[0]; out[1]=cmv[1]; return; }
      }
    }
    median_pred(bx0, by0, w4, refv, which, out);
  }

  void mv_skip(int addr, int64_t out[2]) {
    int mx = addr % mb_w, my = addr / mb_w;
    int bx0 = mx * 4, by0 = my * 4;
    out[0] = out[1] = 0;
    if (mx == 0 || my == 0) return;
    int64_t amv[2], bmv[2];
    int ar, br;
    bool aa = ms.blk(bx0 - 1, by0, 0, amv, &ar);
    bool ab = ms.blk(bx0, by0 - 1, 0, bmv, &br);
    if (aa && ar == 0 && amv[0] == 0 && amv[1] == 0) return;
    if (ab && br == 0 && bmv[0] == 0 && bmv[1] == 0) return;
    median_pred(bx0, by0, 4, 0, 0, out);
  }

  // ---- B direct modes ----------------------------------------------
  struct DQuad { int r0, r1; int64_t mv0[2], mv1[2]; };

  static int min_positive(int a, int b) {
    if (a >= 0 && b >= 0) return a < b ? a : b;
    return a > b ? a : b;
  }

  void derive_direct(int addr, DQuad q[4]) {
    if (ip->direct_spatial) spatial_direct(addr, q);
    else temporal_direct(addr, q);
  }

  void spatial_direct(int addr, DQuad out[4]) {
    int mx = addr % mb_w, my = addr / mb_w;
    int bx0 = mx * 4, by0 = my * 4;
    int refs[2];
    for (int which = 0; which < 2; which++) {
      int64_t amv[2], bmv[2], cmv[2];
      int ar, br, cr;
      bool aa, ab, ac;
      neighbors(bx0, by0, 4, which, amv, &ar, &aa, bmv, &br, &ab, cmv,
                &cr, &ac);
      refs[which] = min_positive(min_positive(aa ? ar : -1, ab ? br : -1),
                                 ac ? cr : -1);
    }
    int r0 = refs[0], r1 = refs[1];
    if (r0 < 0 && r1 < 0) {
      for (int k = 0; k < 4; k++) {
        out[k].r0 = 0; out[k].r1 = 0;
        out[k].mv0[0] = out[k].mv0[1] = 0;
        out[k].mv1[0] = out[k].mv1[1] = 0;
      }
      return;
    }
    int64_t m0[2] = {0, 0}, m1[2] = {0, 0};
    if (r0 >= 0) median_pred(bx0, by0, 4, r0, 0, m0);
    if (r1 >= 0) median_pred(bx0, by0, 4, r1, 1, m1);
    static const int kCorner[4][2] = {{0, 0}, {3, 0}, {0, 3}, {3, 3}};
    for (int k = 0; k < 4; k++) {
      bool zero = false;
      if (ip->col_shortterm) {
        size_t ci = (size_t)(by0 + kCorner[k][1]) * ms.W4 +
                    (bx0 + kCorner[k][0]);
        int cref = ip->col_refidx0[ci];
        const int32_t* cmv = &ip->col_mv0[ci * 2];
        if (cref < 0) {
          cref = ip->col_refidx1 ? ip->col_refidx1[ci] : -1;
          cmv = ip->col_mv1 ? &ip->col_mv1[ci * 2] : cmv;
        }
        if (cref >= 0)
          zero = cref == 0 && std::abs(cmv[0]) <= 1 && std::abs(cmv[1]) <= 1;
      }
      out[k].r0 = r0; out[k].r1 = r1;
      out[k].mv0[0] = (zero && r0 == 0) ? 0 : m0[0];
      out[k].mv0[1] = (zero && r0 == 0) ? 0 : m0[1];
      out[k].mv1[0] = (zero && r1 == 0) ? 0 : m1[0];
      out[k].mv1[1] = (zero && r1 == 0) ? 0 : m1[1];
    }
  }

  void temporal_direct(int addr, DQuad out[4]) {
    int mx = addr % mb_w, my = addr / mb_w;
    int bx0 = mx * 4, by0 = my * 4;
    static const int kCorner[4][2] = {{0, 0}, {3, 0}, {0, 3}, {3, 3}};
    for (int k = 0; k < 4; k++) {
      size_t ci = (size_t)(by0 + kCorner[k][1]) * ms.W4 +
                  (bx0 + kCorner[k][0]);
      int64_t cmv[2];
      int key;
      if (ip->col_refkey0[ci] >= 0) {
        key = ip->col_refkey0[ci];
        cmv[0] = ip->col_mv0[ci * 2]; cmv[1] = ip->col_mv0[ci * 2 + 1];
      } else if (ip->col_refkey1 && ip->col_refkey1[ci] >= 0) {
        key = ip->col_refkey1[ci];
        cmv[0] = ip->col_mv1[ci * 2]; cmv[1] = ip->col_mv1[ci * 2 + 1];
      } else {  // intra co-located: mvCol = 0, refIdxCol = 0
        key = ip->col_default_key;
        cmv[0] = cmv[1] = 0;
      }
      int ti = -1;
      for (int t = 0; t < ip->n_tk; t++)
        if (ip->tkeys[t] == key) { ti = t; break; }
      // (key always present: table built from the col picture's ref maps)
      out[k].r0 = ip->t_ref0[ti];
      out[k].r1 = 0;
      if (ip->t_ident[ti]) {
        out[k].mv0[0] = cmv[0]; out[k].mv0[1] = cmv[1];
        out[k].mv1[0] = 0; out[k].mv1[1] = 0;
      } else {
        int64_t dsf = ip->t_dsf[ti];
        for (int c = 0; c < 2; c++) {
          out[k].mv0[c] = (dsf * cmv[c] + 128) >> 8;
          out[k].mv1[c] = out[k].mv0[c] - cmv[c];
        }
      }
    }
  }

  // ---- interpolation (8.4.2.2) -------------------------------------
  void luma_mc(const uint8_t* ref, int px, int py, int w, int h, int mvx,
               int mvy, int64_t* out, int os) {
    int W = rec->Y.w, H = rec->Y.h;
    int ix = mvx >> 2, iy = mvy >> 2, fx = mvx & 3, fy = mvy & 3;
    int bx = px + ix, by = py + iy;
    int ww = w + 5, wh = h + 5;
    std::vector<int64_t> win((size_t)ww * wh);
    for (int r = 0; r < wh; r++) {
      int yy = clampi(by - 2 + r, 0, H - 1);
      for (int c = 0; c < ww; c++) {
        int xx = clampi(bx - 2 + c, 0, W - 1);
        win[(size_t)r * ww + c] = ref[(size_t)yy * W + xx];
      }
    }
    auto W6 = [&](int r, int c) { return win[(size_t)r * ww + c]; };
    if (fx == 0 && fy == 0) {
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) out[r * os + c] = W6(r + 2, c + 2);
      return;
    }
    auto tap6 = [](int64_t a, int64_t b, int64_t c, int64_t d, int64_t e,
                   int64_t f) { return a - 5*b + 20*c + 20*d - 5*e + f; };
    // bmat[r][c]: horizontal 6-tap at window row r (r in 0..h+4), col c
    std::vector<int64_t> bmat((size_t)wh * w);
    for (int r = 0; r < wh; r++)
      for (int c = 0; c < w; c++)
        bmat[(size_t)r * w + c] = tap6(W6(r, c), W6(r, c+1), W6(r, c+2),
                                       W6(r, c+3), W6(r, c+4), W6(r, c+5));
    auto B = [&](int r, int c) {  // clipped half-pel b at window row r
      return (int64_t)clip255((bmat[(size_t)r * w + c] + 16) >> 5);
    };
    // hmat[r][c]: vertical 6-tap at window col c (c in 0..w+4)
    std::vector<int64_t> hmat((size_t)h * ww);
    for (int r = 0; r < h; r++)
      for (int c = 0; c < ww; c++)
        hmat[(size_t)r * ww + c] = tap6(W6(r, c), W6(r+1, c), W6(r+2, c),
                                        W6(r+3, c), W6(r+4, c), W6(r+5, c));
    auto Hh = [&](int r, int c) {  // clipped half-pel h at window col c
      return (int64_t)clip255((hmat[(size_t)r * ww + c] + 16) >> 5);
    };
    auto J = [&](int r, int c) {  // center half-pel from unclipped bmat
      int64_t j = tap6(bmat[(size_t)(r + 0) * w + c],
                       bmat[(size_t)(r + 1) * w + c],
                       bmat[(size_t)(r + 2) * w + c],
                       bmat[(size_t)(r + 3) * w + c],
                       bmat[(size_t)(r + 4) * w + c],
                       bmat[(size_t)(r + 5) * w + c]);
      return (int64_t)clip255((j + 512) >> 10);
    };
    auto avg = [](int64_t p, int64_t q) { return (p + q + 1) >> 1; };
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        int64_t G = W6(r + 2, c + 2), Hs = W6(r + 2, c + 3),
                M = W6(r + 3, c + 2);
        int64_t v;
        if (fy == 0) {
          v = fx == 1 ? avg(G, B(r + 2, c))
              : fx == 2 ? B(r + 2, c) : avg(B(r + 2, c), Hs);
        } else if (fx == 0) {
          v = fy == 1 ? avg(G, Hh(r, c + 2))
              : fy == 2 ? Hh(r, c + 2) : avg(Hh(r, c + 2), M);
        } else if (fx == 2 && fy == 2) {
          v = J(r, c);
        } else if (fx == 2) {
          v = fy == 1 ? avg(B(r + 2, c), J(r, c))
                      : avg(J(r, c), B(r + 3, c));
        } else if (fy == 2) {
          v = fx == 1 ? avg(Hh(r, c + 2), J(r, c))
                      : avg(J(r, c), Hh(r, c + 3));
        } else {
          int64_t bs = fy == 1 ? B(r + 2, c) : B(r + 3, c);
          int64_t hs = fx == 1 ? Hh(r, c + 2) : Hh(r, c + 3);
          v = avg(bs, hs);
        }
        out[r * os + c] = v;
      }
  }

  void chroma_mc(const uint8_t* ref, int cx0, int cy0, int w, int h,
                 int mvx, int mvy, int64_t* out, int os) {
    int W = rec->Cb.w, H = rec->Cb.h;
    int ix = mvx >> 3, iy = mvy >> 3, fx = mvx & 7, fy = mvy & 7;
    int bx = cx0 + ix, by = cy0 + iy;
    for (int r = 0; r < h; r++) {
      int y0c = clampi(by + r, 0, H - 1), y1c = clampi(by + r + 1, 0, H - 1);
      for (int c = 0; c < w; c++) {
        int x0c = clampi(bx + c, 0, W - 1), x1c = clampi(bx + c + 1, 0, W - 1);
        int64_t A = ref[(size_t)y0c * W + x0c], Bv = ref[(size_t)y0c * W + x1c];
        int64_t C = ref[(size_t)y1c * W + x0c], D = ref[(size_t)y1c * W + x1c];
        out[r * os + c] = ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * Bv +
                           (8 - fx) * fy * C + fx * fy * D + 32) >> 6;
      }
    }
  }

  // ---- weighted combine (8.4.2.3) ----------------------------------
  static int64_t wp_single(int64_t p, int d, int wv, int o) {
    if (d >= 1) return clip255((((p * wv + (1 << (d - 1))) >> d) + o));
    return clip255(p * wv + o);
  }
  static int64_t wp_bi(int64_t p0, int64_t p1, int d, int w0, int o0,
                       int w1, int o1) {
    return clip255(((p0 * w0 + p1 * w1 + ((int64_t)1 << d)) >> (d + 1)) +
                   ((o0 + o1 + 1) >> 1));
  }

  // one partition's MC into the MB pred buffers, with WP combine.
  // used: bitmask of lists; mvs/ridx per list.
  void mc_part(int ox4, int oy4, int w4, int h4, int used,
               const int64_t mvs[2][2], const int ridx[2], int mbx, int mby,
               int64_t predY[16][16], int64_t predCb[8][8],
               int64_t predCr[8][8]) {
    if (ip->motion_only) return;
    int px = mbx * 16 + ox4 * 4, py = mby * 16 + oy4 * 4;
    int pw = w4 * 4, ph = h4 * 4;
    int64_t py_[2][16 * 16], pcb[2][8 * 8], pcr[2][8 * 8];
    int lists[2], nl = 0;
    for (int which = 0; which < 2; which++) {
      if (!(used & (1 << which))) continue;
      const uint8_t* ry = which == 0 ? ip->ref0_y[ridx[which]]
                                     : ip->ref1_y[ridx[which]];
      const uint8_t* rcb = which == 0 ? ip->ref0_cb[ridx[which]]
                                      : ip->ref1_cb[ridx[which]];
      const uint8_t* rcr = which == 0 ? ip->ref0_cr[ridx[which]]
                                      : ip->ref1_cr[ridx[which]];
      luma_mc(ry, px, py, pw, ph, (int)mvs[which][0], (int)mvs[which][1],
              py_[nl], pw);
      chroma_mc(rcb, px / 2, py / 2, pw / 2, ph / 2, (int)mvs[which][0],
                (int)mvs[which][1], pcb[nl], pw / 2);
      chroma_mc(rcr, px / 2, py / 2, pw / 2, ph / 2, (int)mvs[which][0],
                (int)mvs[which][1], pcr[nl], pw / 2);
      lists[nl++] = which;
    }
    for (int r = 0; r < ph; r++)
      for (int c = 0; c < pw; c++) {
        int64_t v;
        if (nl == 1) {
          v = py_[0][r * pw + c];
          if (ip->wp_mode == 1) {
            const int32_t* e = ip->wp_expl + lists[0] * ip->wp_stride +
                               ridx[lists[0]] * 6;
            v = wp_single(v, ip->wp_denom_y, e[0], e[1]);
          }
        } else if (ip->wp_mode == 1) {
          const int32_t* e0 = ip->wp_expl + 0 * ip->wp_stride + ridx[0] * 6;
          const int32_t* e1 = ip->wp_expl + 1 * ip->wp_stride + ridx[1] * 6;
          v = wp_bi(py_[0][r * pw + c], py_[1][r * pw + c], ip->wp_denom_y,
                    e0[0], e0[1], e1[0], e1[1]);
        } else if (ip->wp_mode == 2) {
          const int32_t* iw = ip->wp_imp +
                              ((size_t)ridx[0] * ip->n_ref1 + ridx[1]) * 2;
          v = wp_bi(py_[0][r * pw + c], py_[1][r * pw + c], 5, iw[0], 0,
                    iw[1], 0);
        } else {
          v = (py_[0][r * pw + c] + py_[1][r * pw + c] + 1) >> 1;
        }
        predY[oy4 * 4 + r][ox4 * 4 + c] = v;
      }
    int cw = pw / 2, chh = ph / 2;
    for (int ci = 0; ci < 2; ci++) {
      int64_t (*pc)[8 * 8] = ci == 0 ? pcb : pcr;
      for (int r = 0; r < chh; r++)
        for (int c = 0; c < cw; c++) {
          int64_t v;
          if (nl == 1) {
            v = pc[0][r * cw + c];
            if (ip->wp_mode == 1) {
              const int32_t* e = ip->wp_expl + lists[0] * ip->wp_stride +
                                 ridx[lists[0]] * 6;
              v = wp_single(v, ip->wp_denom_c, e[2 + ci * 2],
                            e[3 + ci * 2]);
            }
          } else if (ip->wp_mode == 1) {
            const int32_t* e0 = ip->wp_expl + 0 * ip->wp_stride +
                                ridx[0] * 6;
            const int32_t* e1 = ip->wp_expl + 1 * ip->wp_stride +
                                ridx[1] * 6;
            v = wp_bi(pc[0][r * cw + c], pc[1][r * cw + c],
                      ip->wp_denom_c, e0[2 + ci * 2], e0[3 + ci * 2],
                      e1[2 + ci * 2], e1[3 + ci * 2]);
          } else if (ip->wp_mode == 2) {
            const int32_t* iw = ip->wp_imp +
                                ((size_t)ridx[0] * ip->n_ref1 + ridx[1]) * 2;
            v = wp_bi(pc[0][r * cw + c], pc[1][r * cw + c], 5, iw[0], 0,
                      iw[1], 0);
          } else {
            v = (pc[0][r * cw + c] + pc[1][r * cw + c] + 1) >> 1;
          }
          if (ci == 0) predCb[oy4 * 2 + r][ox4 * 2 + c] = v;
          else predCr[oy4 * 2 + r][ox4 * 2 + c] = v;
        }
    }
  }

  void direct_quad(int q, const DQuad* dq, int mbx, int mby,
                   int64_t predY[16][16], int64_t predCb[8][8],
                   int64_t predCr[8][8]) {
    int qx = (q & 1) * 2, qy = (q >> 1) * 2;
    int bx0 = mbx * 4, by0 = mby * 4;
    int used = 0;
    int64_t mvs[2][2];
    int ridx[2] = {0, 0};
    const int64_t zero[2] = {0, 0};
    const DQuad& d = dq[q];
    if (d.r0 >= 0) {
      used |= 1; ridx[0] = d.r0;
      mvs[0][0] = d.mv0[0]; mvs[0][1] = d.mv0[1];
      ms.set(bx0 + qx, by0 + qy, 2, 2, d.mv0, d.r0, 0);
    } else {
      ms.set(bx0 + qx, by0 + qy, 2, 2, zero, -1, 0);
    }
    if (d.r1 >= 0) {
      used |= 2; ridx[1] = d.r1;
      mvs[1][0] = d.mv1[0]; mvs[1][1] = d.mv1[1];
      ms.set(bx0 + qx, by0 + qy, 2, 2, d.mv1, d.r1, 1);
    } else {
      ms.set(bx0 + qx, by0 + qy, 2, 2, zero, -1, 1);
    }
    mc_part(qx, qy, 2, 2, used, mvs, ridx, mbx, mby, predY, predCb,
            predCr);
  }

  // ---- residual add + plane store ----------------------------------
  void add_residuals(int addr, int mbx, int mby, int64_t predY[16][16],
                     int64_t predCb[8][8], int64_t predCr[8][8],
                     bool skip) {
    if (ip->motion_only) return;
    Recon& R = *rec;
    int qp = R.qp_y[addr];
    int x0 = mbx * 16, y0 = mby * 16;
    int cbp = skip ? 0 : R.cbp[addr];
    int64_t resid[16][16];
    std::memset(resid, 0, sizeof(resid));
    if (cbp & 0x0F) {
      if (R.transform8 && R.transform8[addr]) {
        // inter MB with transform_size_8x8_flag: 8x8 IQ+IDCT (8.5.13)
        for (int blk = 0; blk < 4; blk++) {
          if (!((cbp >> blk) & 1)) continue;
          int64_t d[8][8];
          const int32_t* c = R.luma8 + ((int64_t)addr * 4 + blk) * 64;
          for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++) {
              int64_t v = c[i * 8 + j];
              if (qp >= 36) d[i][j] = (v * ls8(qp % 6, i, j))
                                      << (qp / 6 - 6);
              else d[i][j] = (v * ls8(qp % 6, i, j)
                              + (1 << (5 - qp / 6))) >> (6 - qp / 6);
            }
          idct8_stage(d, true);
          idct8_stage(d, false);
          int bx = (blk & 1) * 8, by = (blk >> 1) * 8;
          for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++)
              resid[by + i][bx + j] = (d[i][j] + 32) >> 6;
        }
      } else {
        for (int blk = 0; blk < 16; blk++) {
          if (!((cbp >> (blk >> 2)) & 1)) continue;
          int64_t d[4][4], r4[4][4];
          dequant4(R.luma4 + ((int64_t)addr * 16 + blk) * 16, qp, false, d,
                   0, false);
          idct4(d, r4);
          int bx = kZ[blk].x, by = kZ[blk].y;
          for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++)
              resid[by * 4 + i][bx * 4 + j] = r4[i][j];
        }
      }
    }
    for (int i = 0; i < 16; i++)
      for (int j = 0; j < 16; j++)
        R.Y.set(x0 + j, y0 + i, clip255(predY[i][j] + resid[i][j]));
    int cx0 = mbx * 8, cy0 = mby * 8;
    for (int ci = 0; ci < 2; ci++) {
      Plane& P = ci == 0 ? R.Cb : R.Cr;
      int64_t (*pred)[8] = ci == 0 ? predCb : predCr;
      int qpc = qpc_from_qpy(qp, ci == 0 ? R.qp_off_cb : R.qp_off_cr);
      int64_t cres[8][8];
      std::memset(cres, 0, sizeof(cres));
      if (!skip && (cbp & 0x30)) {
        const int32_t* dcl = R.chroma_dc_lv + ((int64_t)addr * 2 + ci) * 8;
        int64_t f00 = dcl[0] + dcl[1] + dcl[2] + dcl[3];
        int64_t f01 = dcl[0] - dcl[1] + dcl[2] - dcl[3];
        int64_t f10 = dcl[0] + dcl[1] - dcl[2] - dcl[3];
        int64_t f11 = dcl[0] - dcl[1] - dcl[2] + dcl[3];
        int ls00 = ls4(qpc % 6, 0, 0);
        int64_t dcv[4] = {
          ((f00 * ls00) << (qpc / 6)) >> 5, ((f01 * ls00) << (qpc / 6)) >> 5,
          ((f10 * ls00) << (qpc / 6)) >> 5, ((f11 * ls00) << (qpc / 6)) >> 5};
        for (int j = 0; j < 4; j++) {
          int bx = j & 1, by = j >> 1;
          int64_t d[4][4], r4[4][4];
          dequant4(R.chroma_ac + (((int64_t)addr * 2 + ci) * 8 + j) * 16,
                   qpc, true, d, dcv[j], true);
          idct4(d, r4);
          for (int i = 0; i < 4; i++)
            for (int jj = 0; jj < 4; jj++)
              cres[by * 4 + i][bx * 4 + jj] = r4[i][jj];
        }
      }
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
          P.set(cx0 + j, cy0 + i, clip255(pred[i][j] + cres[i][j]));
    }
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++)
        R.blk_done_m[(mby * 4 + i) * (mb_w * 4) + mbx * 4 + j] = 1;
    R.mb_done_m[addr] = 1;
  }

  // ---- partition walk ----------------------------------------------
  void recon_inter(int addr) {
    Recon& R = *rec;
    ms.cur_sid = R.slice_id[addr];
    int mbx = addr % mb_w, mby = addr / mb_w;
    int bx0 = mbx * 4, by0 = mby * 4;
    int k = R.kind[addr];
    int64_t predY[16][16], predCb[8][8], predCr[8][8];
    bool skip = k == KIND_P_SKIP || k == KIND_B_SKIP;
    if (k == KIND_P_SKIP) {
      int64_t mv[2];
      mv_skip(addr, mv);
      ms.set(bx0, by0, 4, 4, mv, 0, 0);
      int64_t mvs[2][2] = {{mv[0], mv[1]}, {0, 0}};
      int ridx[2] = {0, 0};
      mc_part(0, 0, 4, 4, 1, mvs, ridx, mbx, mby, predY, predCb, predCr);
    } else if (k == KIND_B_SKIP || k == KIND_B_DIRECT) {
      DQuad dq[4];
      derive_direct(addr, dq);
      for (int q = 0; q < 4; q++)
        direct_quad(q, dq, mbx, mby, predY, predCb, predCr);
    } else {
      // partitions: (ox4, oy4, w4, h4, pred, quad, anchor, shape, pidx)
      // pred: 0 L0, 1 L1, 2 BI, 3 DIRECT
      struct Part { int ox4, oy4, w4, h4, pred, quad, anchor, shape, pidx; };
      Part parts[16];
      int np = 0;
      bool is_b = k == KIND_B || k == KIND_B8X8;
      if (k == KIND_P || k == KIND_B) {
        int code = mb_type_code[addr];
        // B table: {nparts, geom(0 16x16 / 1 16x8 / 2 8x16), pred0, pred1}
        static const int8_t kBT[22][4] = {
          {1,0,3,-1},{1,0,0,-1},{1,0,1,-1},{1,0,2,-1},
          {2,1,0,0},{2,2,0,0},{2,1,1,1},{2,2,1,1},
          {2,1,0,1},{2,2,0,1},{2,1,1,0},{2,2,1,0},
          {2,1,0,2},{2,2,0,2},{2,1,1,2},{2,2,1,2},
          {2,1,2,0},{2,2,2,0},{2,1,2,1},{2,2,2,1},
          {2,1,2,2},{2,2,2,2}};
        static const int8_t kPT[3][4] = {
          {1,0,0,-1},{2,1,0,0},{2,2,0,0}};
        const int8_t* t = is_b ? kBT[code] : kPT[code];
        int n = t[0], geom = t[1];
        for (int p = 0; p < n; p++) {
          int pr = t[2 + p];
          if (n == 1)
            parts[np++] = {0, 0, 4, 4, pr, 0, 0, 0, 0};
          else if (geom == 1)
            parts[np++] = {0, p * 2, 4, 2, pr, p * 2, p == 0 ? 0 : 8, 1, p};
          else
            parts[np++] = {p * 2, 0, 2, 4, pr, p, p == 0 ? 0 : 4, 2, p};
        }
      } else {  // P_8x8 / B_8x8
        // sub tables: {nparts, w4, h4, pred}
        static const int8_t kPS[4][4] = {
          {1,2,2,0},{2,2,1,0},{2,1,2,0},{4,1,1,0}};
        static const int8_t kBS[13][4] = {
          {1,2,2,3},{1,2,2,0},{1,2,2,1},{1,2,2,2},
          {2,2,1,0},{2,1,2,0},{2,2,1,1},{2,1,2,1},
          {2,2,1,2},{2,1,2,2},{4,1,1,0},{4,1,1,1},{4,1,1,2}};
        for (int q = 0; q < 4; q++) {
          int qx = (q & 1) * 2, qy = (q >> 1) * 2;
          int st = sub_mb_type[addr * 4 + q];
          const int8_t* t = is_b ? kBS[st] : kPS[st];
          int n = t[0], w4 = t[1], h4 = t[2], pr = t[3];
          if (is_b && st == 0) {  // B_Direct_8x8
            parts[np++] = {qx, qy, 2, 2, 3, q, 4 * q, 0, q};
            continue;
          }
          for (int p = 0; p < n; p++) {
            int ox = qx, oy = qy, anchor = 4 * q;
            if (w4 == 2 && h4 == 1) { oy += p; anchor += p == 0 ? 0 : 2; }
            else if (w4 == 1 && h4 == 2) { ox += p; anchor += p; }
            else if (w4 == 1 && h4 == 1) {
              ox += p & 1; oy += p >> 1; anchor += p;
            }
            parts[np++] = {ox, oy, w4, h4, pr, q, anchor, 0, q};
          }
        }
      }
      DQuad dq[4];
      bool have_dq = false;
      for (int pi = 0; pi < np; pi++) {
        const Part& P = parts[pi];
        if (P.pred == 3) {  // direct quadrant
          if (!have_dq) { derive_direct(addr, dq); have_dq = true; }
          direct_quad(P.quad, dq, mbx, mby, predY, predCb, predCr);
          continue;
        }
        int used = 0;
        int64_t mvs[2][2];
        int ridx[2] = {0, 0};
        for (int which = 0; which < 2; which++) {
          bool uses = P.pred == 2 || P.pred == which;
          if (!uses) continue;
          int rv = ref_idx[((int64_t)addr * 2 + which) * 4 + P.quad];
          int64_t mvp[2];
          mv_pred(P.shape, bx0 + P.ox4, by0 + P.oy4, P.w4, rv, P.pidx,
                  which, mvp);
          const int32_t* md = mvd +
              (((int64_t)addr * 2 + which) * 16 + P.anchor) * 2;
          mvs[which][0] = mvp[0] + md[0];
          mvs[which][1] = mvp[1] + md[1];
          ridx[which] = rv;
          used |= 1 << which;
        }
        const int64_t zero[2] = {0, 0};
        for (int which = 0; which < 2; which++) {
          if (used & (1 << which))
            ms.set(bx0 + P.ox4, by0 + P.oy4, P.w4, P.h4, mvs[which],
                   ridx[which], which);
          else if (is_b)
            ms.set(bx0 + P.ox4, by0 + P.oy4, P.w4, P.h4, zero, -1, which);
        }
        mc_part(P.ox4, P.oy4, P.w4, P.h4, used, mvs, ridx, mbx, mby,
                predY, predCb, predCr);
      }
    }
    add_residuals(addr, mbx, mby, predY, predCb, predCr, skip);
    // export nz4 for deblock (inter MBs; z-scan blk -> raster pos)
    int cbp = skip ? 0 : R.cbp[addr];
    for (int blk = 0; blk < 16; blk++) {
      bool nz = false;
      if ((cbp >> (blk >> 2)) & 1) {
        if (R.transform8 && R.transform8[addr]) {
          // 8x8 transform: each 4x4 inherits its 8x8 block's nz status
          const int32_t* c = R.luma8 + ((int64_t)addr * 4 + (blk >> 2)) * 64;
          for (int i = 0; i < 64 && !nz; i++) nz = c[i] != 0;
        } else {
          const int32_t* c = R.luma4 + ((int64_t)addr * 16 + blk) * 16;
          for (int i = 0; i < 16 && !nz; i++) nz = c[i] != 0;
        }
      }
      ip->out_nz4[(size_t)(mby * 4 + kZ[blk].y) * (mb_w * 4) +
                  mbx * 4 + kZ[blk].x] = nz;
    }
  }

  void run() {
    int n = mb_w * mb_h;
    ms.init(mb_w * 4, mb_h * 4);
    for (int addr = 0; addr < n; addr++) {
      int mx = addr % mb_w, my = addr / mb_w;
      int sid = rec->slice_id[addr];
      int k = rec->kind[addr];
      if (k == KIND_I16 || k == KIND_I4 || k == KIND_I8 || k == KIND_PCM) {
        if (ip->motion_only) {
          // no pixel work; intra MBs only mark the motion field
        } else if (k == KIND_PCM) {
          for (int i = 0; i < 16; i++)
            for (int j = 0; j < 16; j++)
              rec->Y.set(mx * 16 + j, my * 16 + i,
                         rec->pcm_y[(int64_t)addr * 256 + i * 16 + j]);
          for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++) {
              rec->Cb.set(mx * 8 + j, my * 8 + i,
                          rec->pcm_c[(int64_t)addr * 128 + i * 8 + j]);
              rec->Cr.set(mx * 8 + j, my * 8 + i,
                          rec->pcm_c[(int64_t)addr * 128 + 64 + i * 8 + j]);
            }
          for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++)
              rec->blk_done_m[(my * 4 + i) * (mb_w * 4) + mx * 4 + j] = 1;
        } else {
          if (k == KIND_I16) rec->recon_i16(addr, mx, my, sid);
          else if (k == KIND_I8) rec->recon_i8(addr, mx, my, sid);
          else rec->recon_i4(addr, mx, my, sid);
          rec->recon_chroma(addr, mx, my, sid);
        }
        rec->mb_done_m[addr] = 1;
        ms.set_intra(mx, my, sid);
      } else {
        recon_inter(addr);
      }
    }
    // export motion (list indices + picture keys)
    size_t n4 = (size_t)mb_w * 4 * mb_h * 4;
    for (size_t i = 0; i < n4; i++) {
      ip->out_mv0[i * 2] = ms.mv[0][i * 2];
      ip->out_mv0[i * 2 + 1] = ms.mv[0][i * 2 + 1];
      ip->out_mv1[i * 2] = ms.mv[1][i * 2];
      ip->out_mv1[i * 2 + 1] = ms.mv[1][i * 2 + 1];
      int r0 = ms.ref[0][i], r1 = ms.ref[1][i];
      ip->out_refidx0[i] = r0;
      ip->out_refidx1[i] = r1;
      ip->out_refkey0[i] = r0 >= 0 ? ip->list0_keys[r0] : -1;
      ip->out_refkey1[i] = r1 >= 0 ? ip->list1_keys[r1] : -1;
    }
  }
};

}  // namespace

extern "C" {

// Reconstruct a 4:2:0 8-bit intra picture from the dense entropy outputs.
int dt_reconstruct_islices(
    const int32_t* kind, const int32_t* qp_y, const int32_t* cbp,
    const int32_t* i16_mode, const int32_t* chroma_mode,
    const int32_t* modes4, const int32_t* modes8, const int32_t* luma4,
    const int32_t* luma8, const int32_t* luma_dc, const int32_t* chroma_dc,
    const int32_t* chroma_ac, const int32_t* pcm_y, const int32_t* pcm_c,
    const int32_t* slice_id, int32_t mb_w, int32_t mb_h, int32_t qp_off_cb,
    int32_t qp_off_cr, uint8_t* out_y, uint8_t* out_cb, uint8_t* out_cr) {
  Recon r;
  r.kind = kind; r.qp_y = qp_y; r.cbp = cbp; r.i16_mode = i16_mode;
  r.chroma_mode = chroma_mode; r.modes4 = modes4; r.modes8 = modes8;
  r.luma4 = luma4; r.luma8 = luma8; r.luma_dc = luma_dc;
  r.chroma_dc_lv = chroma_dc; r.chroma_ac = chroma_ac;
  r.pcm_y = pcm_y; r.pcm_c = pcm_c; r.slice_id = slice_id;
  r.mb_w = mb_w; r.mb_h = mb_h;
  r.qp_off_cb = qp_off_cb; r.qp_off_cr = qp_off_cr;
  int W = mb_w * 16, H = mb_h * 16;
  r.Y = {out_y, W, H, W};
  r.Cb = {out_cb, W / 2, H / 2, W / 2};
  r.Cr = {out_cr, W / 2, H / 2, W / 2};
  std::vector<uint8_t> blk_done(mb_w * 4 * mb_h * 4, 0);
  std::vector<uint8_t> mb_done(mb_w * mb_h, 0);
  r.blk_done_m = blk_done.data();
  r.mb_done_m = mb_done.data();
  r.run();
  return 0;
}

// Reconstruct a full 4:2:0 8-bit picture (intra + P/B inter MBs) from the
// dense entropy outputs; exports the motion field for DPB storage.
int dt_recon_picture(
    const int32_t* kind, const int32_t* qp_y, const int32_t* cbp,
    const int32_t* i16_mode, const int32_t* chroma_mode,
    const int32_t* modes4, const int32_t* modes8, const int32_t* luma4,
    const int32_t* luma8, const int32_t* luma_dc, const int32_t* chroma_dc,
    const int32_t* chroma_ac, const int32_t* pcm_y, const int32_t* pcm_c,
    const int32_t* slice_id, const int32_t* mb_type_code,
    const int32_t* sub_mb_type, const int32_t* ref_idx, const int32_t* mvd,
    const int32_t* transform8,
    int32_t mb_w, int32_t mb_h, int32_t qp_off_cb, int32_t qp_off_cr,
    uint8_t* out_y, uint8_t* out_cb, uint8_t* out_cr,
    const InterParams* ip) {
  Recon r;
  r.transform8 = transform8;
  r.kind = kind; r.qp_y = qp_y; r.cbp = cbp; r.i16_mode = i16_mode;
  r.chroma_mode = chroma_mode; r.modes4 = modes4; r.modes8 = modes8;
  r.luma4 = luma4; r.luma8 = luma8; r.luma_dc = luma_dc;
  r.chroma_dc_lv = chroma_dc; r.chroma_ac = chroma_ac;
  r.pcm_y = pcm_y; r.pcm_c = pcm_c; r.slice_id = slice_id;
  r.mb_w = mb_w; r.mb_h = mb_h;
  r.qp_off_cb = qp_off_cb; r.qp_off_cr = qp_off_cr;
  int W = mb_w * 16, H = mb_h * 16;
  r.Y = {out_y, W, H, W};
  r.Cb = {out_cb, W / 2, H / 2, W / 2};
  r.Cr = {out_cr, W / 2, H / 2, W / 2};
  std::vector<uint8_t> blk_done(mb_w * 4 * mb_h * 4, 0);
  std::vector<uint8_t> mb_done(mb_w * mb_h, 0);
  r.blk_done_m = blk_done.data();
  r.mb_done_m = mb_done.data();
  InterRecon ir;
  ir.rec = &r;
  ir.ip = ip;
  ir.mb_type_code = mb_type_code;
  ir.sub_mb_type = sub_mb_type;
  ir.ref_idx = ref_idx;
  ir.mvd = mvd;
  ir.mb_w = mb_w;
  ir.mb_h = mb_h;
  ir.run();
  return 0;
}

}  // extern "C"
