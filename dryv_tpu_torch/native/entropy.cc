// Copy of dryv_tpu/native/entropy.cc (one comment names the reference by its repo path).
// TPU-native AVC host entropy stage: CABAC I-slice decoder producing dense
// per-frame syntax arrays for the device reconstruction pipeline.
//
// Behavioural mirror of dryv_tpu/cabac/{engine,syntax}.py (itself validated
// bit-exactly against libavcodec), re-implemented in C++ for the host hot
// path (SURVEY.md §7: "CABAC is a bit-serial feedback loop - keep it on
// host CPU, multithreaded across slices/frames").  Slices decode in
// parallel: CABAC contexts are per-slice and neighbor availability stops at
// slice boundaries, so there is no shared mutable state.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread entropy.cc -o libdryv_entropy.so
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

#include "tables_data.h"
#ifdef DT_RDTSC
#include <x86intrin.h>
#include <atomic>
namespace { std::atomic<unsigned long long> g_tsc[8]; }
extern "C" void dt_get_tsc(unsigned long long* o) { for (int i=0;i<8;i++){o[i]=g_tsc[i].exchange(0);} }
#define TSC_BEGIN unsigned long long _t0 = __rdtsc()
#define TSC_END(k) do { g_tsc[k] += __rdtsc() - _t0; g_tsc[4 + (k)]++; } while (0)
#else
#define TSC_BEGIN
#define TSC_END(k)
#endif
#include "cavlc_tables.h"

namespace {

// Persistent worker pool for slice-parallel decode: spawning and joining
// one std::thread per slice costs ~1-2 ms/frame at 17 slices; a resident
// pool makes per-frame dispatch ~free.  run_parallel(n, f) executes
// f(0..n-1) across the pool (including the calling thread) and returns
// when all are done.
class SlicePool {
 public:
  static SlicePool& inst() {
    static SlicePool p;
    return p;
  }

  void run_parallel(int n, const std::function<void(int)>& f) {
    std::unique_lock<std::mutex> lk(m_);
    task_ = &f;
    n_tasks_ = n;
    next_.store(0, std::memory_order_relaxed);
    pending_.store(n, std::memory_order_relaxed);
    gen_++;
    cv_.notify_all();
    lk.unlock();
    work();  // caller participates
    lk.lock();
    // wait for completion AND worker quiescence: no worker may still be
    // inside work() when we return (it could otherwise observe the next
    // generation's state mid-publication)
    done_cv_.wait(lk, [&] {
      return pending_.load(std::memory_order_acquire) == 0 && running_ == 0;
    });
    task_ = nullptr;
  }

 private:
  SlicePool() {
    int n = (int)std::thread::hardware_concurrency();
    if (n < 2) n = 2;
    for (int i = 0; i < n - 1; i++)
      workers_.emplace_back([this] { worker_loop(); });
  }
  ~SlicePool() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
      cv_.notify_all();
    }
    for (auto& t : workers_) t.join();
  }

  void work() {
    while (true) {
      int i = next_.fetch_add(1, std::memory_order_relaxed);
      if (i >= n_tasks_) return;
      (*task_)(i);
      pending_.fetch_sub(1, std::memory_order_acq_rel);
    }
  }

  void worker_loop() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(m_);
    while (true) {
      cv_.wait(lk, [&] { return stop_ || gen_ != seen; });
      if (stop_) return;
      seen = gen_;
      running_++;
      lk.unlock();
      work();
      lk.lock();
      running_--;
      if (running_ == 0 &&
          pending_.load(std::memory_order_acquire) == 0)
        done_cv_.notify_all();
    }
  }

  std::vector<std::thread> workers_;
  std::mutex m_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int)>* task_ = nullptr;
  int n_tasks_ = 0;
  std::atomic<int> next_{0};
  std::atomic<int> pending_{0};
  int running_ = 0;
  uint64_t gen_ = 0;
  bool stop_ = false;
};

constexpr int kCtxCount = 1031;

// ctxIdx bases (spec Table 9-11 layout; see cabac/tables.py)
enum : int {
  CTX_MB_TYPE_SI_PRE = 0,
  CTX_MB_TYPE_I = 3,
  CTX_MB_SKIP_P = 11,
  CTX_MB_TYPE_P_PRE = 14,
  CTX_MB_TYPE_P_SUF = 17,
  CTX_SUB_MB_TYPE_P = 21,
  CTX_MB_SKIP_B = 24,
  CTX_MB_TYPE_B_PRE = 27,
  CTX_MB_TYPE_B_SUF = 32,
  CTX_SUB_MB_TYPE_B = 36,
  CTX_MVD_X = 40,
  CTX_MVD_Y = 47,
  CTX_REF_IDX = 54,
  CTX_MB_QP_DELTA = 60,
  CTX_INTRA_CHROMA_PRED_MODE = 64,
  CTX_PREV_INTRA_PRED_MODE_FLAG = 68,
  CTX_REM_INTRA_PRED_MODE = 69,
  CTX_CBP_LUMA = 73,
  CTX_CBP_CHROMA = 77,
  CTX_TERMINATE = 276,
  CTX_TRANSFORM_SIZE_8X8_FLAG = 399,
};

// slice types (SliceType enum)
enum : int { ST_P = 0, ST_B = 1, ST_I = 2, ST_SP = 3, ST_SI = 4 };

// residual categories
enum : int { CAT_LUMA_DC = 0, CAT_LUMA_AC, CAT_LUMA_4X4, CAT_CHROMA_DC,
             CAT_CHROMA_AC, CAT_LUMA_8X8 };

const int kCbfBase[6] = {85, 89, 93, 97, 101, 1012};
const int kSigFrame[6] = {105, 120, 134, 149, 152, 402};
const int kLastFrame[6] = {166, 181, 195, 210, 213, 417};
const int kAbsBase[6] = {227, 237, 247, 257, 266, 426};

// MB kinds: 0..3 match the device numbering (coeffs.py: I4, I8, I16, PCM;
// transform8x8 folded into the I8 kind); 4+ extend it for inter/SI.
enum : int { KIND_I4 = 0, KIND_I8 = 1, KIND_I16 = 2, KIND_PCM = 3,
             KIND_P = 4, KIND_P8X8 = 5, KIND_P_SKIP = 6,
             KIND_B = 7, KIND_B8X8 = 8, KIND_B_SKIP = 9,
             KIND_B_DIRECT = 10, KIND_SI = 11 };

inline bool kind_is_intra(int k) {
  return k <= KIND_PCM || k == KIND_SI;
}
inline bool kind_is_inter(int k) {
  return k >= KIND_P && k <= KIND_B_DIRECT;
}

// z-scan 4x4 position tables
struct ZPos { int x, y; };
constexpr ZPos kZPos[16] = {
  {0,0},{1,0},{0,1},{1,1},{2,0},{3,0},{2,1},{3,1},
  {0,2},{1,2},{0,3},{1,3},{2,2},{3,2},{2,3},{3,3}};
int kPosToZ[4][4];
struct ZInit {
  ZInit() {
    for (int i = 0; i < 16; i++) kPosToZ[kZPos[i].y][kZPos[i].x] = i;
  }
} zinit;

// zig-zag scans (spec 8.5.6/8.5.7): scan position -> raster index.
// Coefficients are emitted de-zigzagged (raster order) so the device
// pipeline consumes them without a host repack pass.
const int kZig4[16] = {0,1,4,8,5,2,3,6,9,12,13,10,7,11,14,15};
const int kZig8[64] = {
  0,1,8,16,9,2,3,10,17,24,32,25,18,11,4,5,
  12,19,26,33,40,48,41,34,27,20,13,6,7,14,21,28,
  35,42,49,56,57,50,43,36,29,22,15,23,30,37,44,51,
  58,59,52,45,38,31,39,46,53,60,61,54,47,55,62,63};
// identity map for chroma DC (coded raster)
const int kIdent8[8] = {0,1,2,3,4,5,6,7};
// AC maps: scan position i -> raster of zigzag index i+1
struct AcMaps {
  int ac4[15];
  AcMaps() { for (int i = 0; i < 15; i++) ac4[i] = kZig4[i + 1]; }
} kAc;

// packed-state transition tables: next ctx_state byte for MPS/LPS paths
// (state 0 LPS flips valMPS; transLps[0] == 0)
struct PackedTransTab {
  uint8_t mps[128], lps[128];
  // fused per-state record: byte0 = packed state, bytes1-4 = LPS range
  // per quarter — lets decision() resolve state AND the LPS lookup with
  // ONE dependent load instead of two chained ones (the hot path reads
  // ONLY mrec/lrec; mps/lps stay for the bypass-run and init paths)
  uint64_t rec[128], mrec[128], lrec[128];
  PackedTransTab() {
    // scratch tables local to table construction (not part of the hot
    // const object's cache footprint)
    uint8_t lpsp[512];
    for (int s = 0; s < 128; s++) {
      int st = s >> 1, m = s & 1;
      mps[s] = (uint8_t)((kTransMps[st] << 1) | m);
      lps[s] = (uint8_t)((kTransLps[st] << 1) | (st == 0 ? m ^ 1 : m));
      for (int q = 0; q < 4; q++) lpsp[s * 4 + q] = kRangeLps[st * 4 + q];
    }
    for (int s = 0; s < 128; s++) {
      uint64_t r = (uint64_t)s;
      for (int q = 0; q < 4; q++)
        r |= (uint64_t)lpsp[s * 4 + q] << (8 + 8 * q);
      rec[s] = r;
    }
    for (int s = 0; s < 128; s++) {
      mrec[s] = rec[mps[s]];
      lrec[s] = rec[lps[s]];
    }
  }
};
const PackedTransTab kPackedTrans;

// precomputed significance-map context indices per residual category
// (kills the per-bin branches of sig_ctx in the hottest loop).
// ctxIdx = tab[cat][scan_pos]; chroma DC depends on chroma_array_type.
struct SigCtxTabs {
  uint16_t sig[6][64], last[6][64];      // chroma_dc slot = 4:2:0 variant
  uint16_t sig_cdc2[8], last_cdc2[8];    // chroma_dc, 4:2:2
  SigCtxTabs() {
    for (int cat = 0; cat < 6; cat++) {
      int n = (cat == CAT_LUMA_8X8) ? 63 : (cat == CAT_CHROMA_DC ? 8 : 15);
      for (int i = 0; i < n; i++) {
        int sinc, linc;
        if (cat == CAT_CHROMA_DC) {
          sinc = linc = i < 3 ? i : 2;  // 4:2:0: i / 1 clamped
        } else if (cat == CAT_LUMA_8X8) {
          sinc = kSig8x8[i * 3 + 0];
          linc = kSig8x8[i * 3 + 2];
        } else {
          sinc = linc = i;
        }
        sig[cat][i] = (uint16_t)(kSigFrame[cat] + sinc);
        last[cat][i] = (uint16_t)(kLastFrame[cat] + linc);
      }
    }
    for (int i = 0; i < 8; i++) {  // 4:2:2 chroma DC: inc = min(i/2, 2)
      int inc = (i >> 1) < 2 ? (i >> 1) : 2;
      sig_cdc2[i] = (uint16_t)(kSigFrame[CAT_CHROMA_DC] + inc);
      last_cdc2[i] = (uint16_t)(kLastFrame[CAT_CHROMA_DC] + inc);
    }
  }
};
const SigCtxTabs kSigCtx;

struct Engine {
  const uint8_t* data;
  int64_t pos;      // raw-read bit cursor (PCM samples, CAVLC); while the
                    // CABAC engine runs, the consumed-bit position is
                    // derived as fetch_pos - lowbits (see cabac_pos())
  int64_t bit_len;
  int32_t range;
  int64_t bins = 0;  // decoded bin counter (reference cabac/mod.rs:68)
#ifdef DT_COUNT_LPS
  int64_t lps_count = 0, mps_renorm = 0, byp = 0;
#endif
  // scaled-low arithmetic state: the top bits of `low` hold the
  // conceptual CABAC offset, followed by `lowbits` buffered future
  // input bits (so renormalisation is just `lowbits -= n`; input is
  // fetched 32 bits at a time)
  uint64_t low = 0;
  int lowbits = 0;
  int64_t fetch_pos = 0;  // bit position of the next unbuffered input bit
  // windowed bit cache for raw (PCM) reads: high bits of `win` hold the
  // next unread bits
  uint64_t win = 0;
  int win_bits = 0;
  // packed context record: kPackedTrans.rec[(pStateIdx << 1) | valMPS]
  // (state byte + the 4 quarter LPS ranges) — one load per bin resolves
  // both the state and the LPS table row
  uint64_t ctx_rec[kCtxCount];

  // 64-bit big-endian window starting at `bitpos`; past-the-end is zero.
  uint64_t fetch64(int64_t bitpos) const {
    int64_t nbytes = (bit_len + 7) >> 3;
    int64_t byte_pos = bitpos >> 3;
    uint64_t w;
    if (byte_pos + 8 <= nbytes) {
      std::memcpy(&w, data + byte_pos, 8);
      w = __builtin_bswap64(w);
    } else {
      w = 0;
      int sh = 56;
      for (int i = 0; i < 8 && sh >= 0; i++, sh -= 8) {
        uint64_t b = (byte_pos + i < nbytes) ? data[byte_pos + i] : 0;
        w |= b << sh;
      }
    }
    return w << (bitpos & 7);
  }

  __attribute__((always_inline)) inline void refill_low() {
    low = (low << 32) | (uint32_t)(fetch64(fetch_pos) >> 32);
    lowbits += 32;
    fetch_pos += 32;
  }

  void refill() {
    // rebuild the raw-read window from `pos` (fetch64 already applies
    // the sub-byte shift; >= 57 valid bits, claim 56)
    win = fetch64(pos);
    win_bits = 56;
  }

  int read_bit() {
    if (win_bits < 1) refill();
    int b = (int)(win >> 63);
    win <<= 1;
    win_bits -= 1;
    pos += 1;
    return b;
  }
  int read_bits(int n) {
    int v = 0;
    while (n > 0) {
      if (win_bits < 1) refill();
      int take = n < win_bits ? n : win_bits;
      v = (v << take) | (int)(win >> (64 - take));
      win <<= take;
      win_bits -= take;
      pos += take;
      n -= take;
    }
    return v;
  }
  void init_contexts(int qp, int mode) {
    if (qp < 0) qp = 0;
    if (qp > 51) qp = 51;
    for (int i = 0; i < kCtxCount; i++) {
      int m = kCtxInit[(i * 4 + mode) * 2];
      int n = kCtxInit[(i * 4 + mode) * 2 + 1];
      int pre = ((m * qp) >> 4) + n;
      if (pre < 1) pre = 1;
      if (pre > 126) pre = 126;
      int s = (pre <= 63) ? ((63 - pre) << 1) : (((pre - 64) << 1) | 1);
      ctx_rec[i] = kPackedTrans.rec[s];
    }
  }
  void init_engine() {
    win_bits = 0;  // invalidate raw window (pos may have changed)
    range = 510;
    // seed: conceptual offset = next 9 bits, with 39 more buffered
    low = fetch64(pos) >> 16;  // 48 bits starting at pos
    lowbits = 39;
    fetch_pos = pos + 48;
    pos += 9;
  }
  // consumed-bit position of the CABAC engine (== the old `pos` chain:
  // init leaves fetch_pos - lowbits == pos + 9, every renorm/bypass
  // decrements lowbits by the bits consumed, refill moves both by 32)
  int64_t cabac_pos() const { return fetch_pos - lowbits; }
  __attribute__((always_inline)) inline void renorm() {
    // branchless shift count: range in [2, 510]; clz==23 -> 0 shift
    int n = __builtin_clz((unsigned)range) - 23;
    range <<= n;
    lowbits -= n;
    if (__builtin_expect(lowbits < 8, 0)) refill_low();
  }
  __attribute__((always_inline)) inline int decision(int ctx) {
    // Branchy MPS fast path: CABAC bins are heavily MPS-skewed, so a
    // predicted branch lets the out-of-order core speculate past the
    // per-bin range/low dependency chain (a fully branchless select
    // pays the whole chain latency on every bin — measured slower).
    bins++;
    uint64_t r = ctx_rec[ctx];
    unsigned s = (unsigned)r & 0xff;
    uint32_t lps =
        (uint32_t)(r >> (8 + (((uint32_t)range >> 3) & 24))) & 0xff;
    uint32_t mps_rng = (uint32_t)range - lps;
    uint64_t scaled = (uint64_t)mps_rng << lowbits;
    if (__builtin_expect(low < scaled, 1)) {  // MPS
      ctx_rec[ctx] = kPackedTrans.mrec[s];
      if (__builtin_expect(mps_rng >= 256, 1)) {
        range = (int32_t)mps_rng;
        return s & 1;
      }
      int n = __builtin_clz(mps_rng) - 23;
      range = (int32_t)(mps_rng << n);
      lowbits -= n;
      if (__builtin_expect(lowbits < 8, 0)) refill_low();
#ifdef DT_COUNT_LPS
      mps_renorm++;
#endif
      return s & 1;
    }
#ifdef DT_COUNT_LPS
    lps_count++;
#endif
    low -= scaled;  // LPS
    ctx_rec[ctx] = kPackedTrans.lrec[s];
    int n = __builtin_clz(lps) - 23;
    range = (int32_t)(lps << n);
    lowbits -= n;
    if (__builtin_expect(lowbits < 8, 0)) refill_low();
    return (int)((s & 1) ^ 1);
  }
  __attribute__((always_inline)) inline int bypass() {
    bins++;
    lowbits--;
    uint64_t scaled = (uint64_t)range << lowbits;
    uint64_t b = (uint64_t)(low >= scaled);
    low -= scaled & (0 - b);
    if (__builtin_expect(lowbits < 8, 0)) refill_low();
    return (int)b;
  }
  // n bypass bins MSB-first with a single refill guard (n <= 16:
  // keeps lowbits + 9 < 64 after a refill at lowbits <= 23)
  __attribute__((always_inline)) inline int bypass_n(int n) {
    bins += n;
    if (lowbits < n + 8) refill_low();
    int v = 0;
    for (int i = 0; i < n; i++) {
      lowbits--;
      uint64_t scaled = (uint64_t)range << lowbits;
      uint64_t b = (uint64_t)(low >= scaled);
      low -= scaled & (0 - b);
      v = (v << 1) | (int)b;
    }
    if (__builtin_expect(lowbits < 8, 0)) refill_low();
    return v;
  }
  __attribute__((always_inline)) inline int terminate() {
    bins++;
    range -= 2;
    if (low >= (uint64_t)range << lowbits) return 1;
    renorm();
    return 0;
  }
  void byte_align() {
    pos = (pos + 7) & ~7LL;
    win_bits = 0;  // window no longer aligned with pos
  }
};

// Register-resident mirror of the engine's per-bin state.  Inside the
// hottest loops (significance map + level decode) the compiler cannot
// keep Engine fields in registers because `this` escapes through the
// surrounding code, so every bin pays ~4 stores + ~4 reloads of
// range/low/lowbits/bins at block boundaries.  Copying the state into a
// local EngHot (no escaping pointer) lets GCC registerize the whole
// loop; only the ctx_rec[] update (normative context adaptation) and
// the rare input refill touch memory.
struct EngHot {
  uint64_t low;
  uint32_t range;
  int32_t lowbits;
  int64_t fetch_pos;
  int64_t bins;
};
__attribute__((always_inline)) inline EngHot eng_adopt(Engine& e) {
  return EngHot{e.low, (uint32_t)e.range, e.lowbits, e.fetch_pos, e.bins};
}
__attribute__((always_inline)) inline void eng_release(Engine& e,
                                                       const EngHot& h) {
  e.low = h.low;
  e.range = (int32_t)h.range;
  e.lowbits = h.lowbits;
  e.fetch_pos = h.fetch_pos;
  e.bins = h.bins;
}
__attribute__((always_inline, cold)) inline void refill_low_h(EngHot& h,
                                                              const Engine& e) {
  h.low = (h.low << 32) | (uint32_t)(e.fetch64(h.fetch_pos) >> 32);
  h.lowbits += 32;
  h.fetch_pos += 32;
}
__attribute__((always_inline)) inline int decision_h(EngHot& h, Engine& e,
                                                     int ctx) {
  h.bins++;
  uint64_t r = e.ctx_rec[ctx];
  unsigned s = (unsigned)r & 0xff;
  uint32_t lps = (uint32_t)(r >> (8 + ((h.range >> 3) & 24))) & 0xff;
  uint32_t mps_rng = h.range - lps;
  uint64_t scaled = (uint64_t)mps_rng << h.lowbits;
  if (__builtin_expect(h.low < scaled, 1)) {  // MPS
    e.ctx_rec[ctx] = kPackedTrans.mrec[s];
    if (__builtin_expect(mps_rng >= 256, 1)) {
      h.range = mps_rng;
      return s & 1;
    }
    int n = __builtin_clz(mps_rng) - 23;
    h.range = mps_rng << n;
    h.lowbits -= n;
    if (__builtin_expect(h.lowbits < 8, 0)) refill_low_h(h, e);
    return s & 1;
  }
  h.low -= scaled;  // LPS
  e.ctx_rec[ctx] = kPackedTrans.lrec[s];
  int n = __builtin_clz(lps) - 23;
  h.range = lps << n;
  h.lowbits -= n;
  if (__builtin_expect(h.lowbits < 8, 0)) refill_low_h(h, e);
  return (int)((s & 1) ^ 1);
}
// Branchless (CMOV) variant for poorly-predicted bins.  The MPS/LPS
// resolve costs a deterministic ~13 cycles instead of branchy's ~6
// predicted / ~24 mispredicted, so it wins exactly where prediction is
// poor: significance-map and level-prefix bins, whose values are
// near-random at mid QP.  Skewed bins (cbf, skip, mb_type prefixes)
// stay on the branchy decision_h.
__attribute__((always_inline)) inline int decision_bl_h(EngHot& h, Engine& e,
                                                        int ctx) {
  h.bins++;
  uint64_t r = e.ctx_rec[ctx];
  unsigned s = (unsigned)r & 0xff;
  uint32_t lps = (uint32_t)(r >> (8 + ((h.range >> 3) & 24))) & 0xff;
  uint32_t mps_rng = h.range - lps;
  uint64_t scaled = (uint64_t)mps_rng << h.lowbits;
  uint64_t is_lps = (uint64_t)(h.low >= scaled);
  h.low -= scaled & (0 - is_lps);
  uint32_t nrange = is_lps ? lps : mps_rng;
  const uint64_t* tab = is_lps ? kPackedTrans.lrec : kPackedTrans.mrec;
  e.ctx_rec[ctx] = tab[s];
  int n = __builtin_clz(nrange) - 23;
  h.range = nrange << n;
  h.lowbits -= n;
  if (__builtin_expect(h.lowbits < 8, 0)) refill_low_h(h, e);
  return (int)((s & 1) ^ (unsigned)is_lps);
}
__attribute__((always_inline)) inline int bypass_h(EngHot& h,
                                                   const Engine& e) {
  h.bins++;
  h.lowbits--;
  uint64_t scaled = (uint64_t)h.range << h.lowbits;
  uint64_t b = (uint64_t)(h.low >= scaled);
  h.low -= scaled & (0 - b);
  if (__builtin_expect(h.lowbits < 8, 0)) refill_low_h(h, e);
  return (int)b;
}
__attribute__((always_inline)) inline int bypass_n_h(EngHot& h,
                                                     const Engine& e, int n) {
  h.bins += n;
  if (h.lowbits < n + 8) refill_low_h(h, e);
  int v = 0;
  for (int i = 0; i < n; i++) {
    h.lowbits--;
    uint64_t scaled = (uint64_t)h.range << h.lowbits;
    uint64_t b = (uint64_t)(h.low >= scaled);
    h.low -= scaled & (0 - b);
    v = (v << 1) | (int)b;
  }
  if (__builtin_expect(h.lowbits < 8, 0)) refill_low_h(h, e);
  return v;
}

// Per-MB syntax state needed for neighbor contexts.
struct MB {
  int8_t kind = KIND_I4;
  int8_t transform8 = 0;
  int8_t chroma_mode = 0;
  int8_t i16_mode = 0;
  int16_t cbp = 0;
  int16_t qp_delta = 0;
  int16_t qp_y = 0;
  int8_t modes4[16];
  int8_t modes8[4];
  uint8_t cbf[3][17];  // [comp][blk], 16 = DC
  // inter syntax state (neighbor contexts)
  int8_t mb_type_code = 0;
  int8_t sub_mb_type[4] = {-1, -1, -1, -1};
  int8_t ref_idx[2][4] = {};
  int16_t mvd[2][16][2] = {};
};

struct PicParams {
  int32_t mb_w, mb_h;
  int32_t chroma_array_type;
  int32_t transform_8x8_mode_flag;
  int32_t bit_depth_luma, bit_depth_chroma;
  int32_t direct_8x8_inference_flag;
};

// partition tables (Table 7-13/7-14): pred modes per partition
enum : int { PRED_L0 = 0, PRED_L1 = 1, PRED_BI = 2, PRED_DIRECT = 3 };
struct PartInfo { int n; int wh; int pred[2]; };  // wh: 0=16x16,1=16x8,2=8x16
const PartInfo kPParts[4] = {
  {1, 0, {PRED_L0, PRED_L0}}, {2, 1, {PRED_L0, PRED_L0}},
  {2, 2, {PRED_L0, PRED_L0}}, {4, 0, {PRED_L0, PRED_L0}}};
const PartInfo kBParts[23] = {
  {1, 0, {PRED_DIRECT, 0}}, {1, 0, {PRED_L0, 0}}, {1, 0, {PRED_L1, 0}},
  {1, 0, {PRED_BI, 0}},
  {2, 1, {PRED_L0, PRED_L0}}, {2, 2, {PRED_L0, PRED_L0}},
  {2, 1, {PRED_L1, PRED_L1}}, {2, 2, {PRED_L1, PRED_L1}},
  {2, 1, {PRED_L0, PRED_L1}}, {2, 2, {PRED_L0, PRED_L1}},
  {2, 1, {PRED_L1, PRED_L0}}, {2, 2, {PRED_L1, PRED_L0}},
  {2, 1, {PRED_L0, PRED_BI}}, {2, 2, {PRED_L0, PRED_BI}},
  {2, 1, {PRED_L1, PRED_BI}}, {2, 2, {PRED_L1, PRED_BI}},
  {2, 1, {PRED_BI, PRED_L0}}, {2, 2, {PRED_BI, PRED_L0}},
  {2, 1, {PRED_BI, PRED_L1}}, {2, 2, {PRED_BI, PRED_L1}},
  {2, 1, {PRED_BI, PRED_BI}}, {2, 2, {PRED_BI, PRED_BI}},
  {4, 0, {PRED_L0, PRED_L0}}};
// sub types (Table 7-17/7-18): n parts, shape (0=8x8,1=8x4,2=4x8,3=4x4), pred
struct SubInfo { int n; int shape; int pred; };
const SubInfo kPSub[4] = {
  {1, 0, PRED_L0}, {2, 1, PRED_L0}, {2, 2, PRED_L0}, {4, 3, PRED_L0}};
const SubInfo kBSub[13] = {
  {4, 3, PRED_DIRECT}, {1, 0, PRED_L0}, {1, 0, PRED_L1}, {1, 0, PRED_BI},
  {2, 1, PRED_L0}, {2, 2, PRED_L0}, {2, 1, PRED_L1}, {2, 2, PRED_L1},
  {2, 1, PRED_BI}, {2, 2, PRED_BI}, {4, 3, PRED_L0}, {4, 3, PRED_L1},
  {4, 3, PRED_BI}};
// partition -> covered 4x4 z-blocks
const int kPart16x8[2][8] = {{0, 1, 4, 5, 2, 3, 6, 7},
                             {8, 9, 12, 13, 10, 11, 14, 15}};
const int kPart8x16[2][8] = {{0, 2, 8, 10, 1, 3, 9, 11},
                             {4, 6, 12, 14, 5, 7, 13, 15}};
// sub-part -> blocks within quadrant (offsets from 4*q)
const int kSub8x4[2][2] = {{0, 1}, {2, 3}};
const int kSub4x8[2][2] = {{0, 2}, {1, 3}};

// dense outputs (SoA), caller-allocated
struct Out {
  int32_t* kind;        // [n]
  int32_t* qp_y;        // [n]
  int32_t* cbp;         // [n]
  int32_t* i16_mode;    // [n]
  int32_t* chroma_mode; // [n]
  int32_t* modes4;      // [n*16]
  int32_t* modes8;      // [n*4]
  int32_t* luma4;       // [n*16*16]  raster 4x4 blocks (I16 AC: slot 0 zero)
  int32_t* luma8;       // [n*4*64]   raster 8x8 blocks
  int32_t* luma_dc;     // [n*16]     raster 4x4 DC grid
  int32_t* chroma_dc;   // [n*2*8]    raster
  int32_t* chroma_ac;   // [n*2*8*16] raster 4x4 blocks, slot 0 zero
  int32_t* pcm_y;       // [n*256]
  int32_t* pcm_c;       // [n*128]
  int32_t* slice_id;    // [n] prefilled by caller
  int64_t* bin_count;   // [n_slices] CABAC bins decoded per slice
  // inter syntax outputs (may be null for intra-only decode)
  int32_t* mb_type_code;  // [n]
  int32_t* sub_mb_type;   // [n*4]
  int32_t* ref_idx;       // [n*2*4]
  int32_t* mvd;           // [n*2*16*2]
  int32_t* transform8;    // [n] (inter MBs; intra folds it into kind)
};

// ---------------------------------------------------------------------------
// Device bitmap-ABI pack (shared by the standalone dt_pack_frame pass and
// the fused decode path below).  Layout of the 408-coeff row per MB:
//   [0:256)  luma levels (luma8 rows for 8x8-transform MBs, else luma4)
//   [256:272) luma DC    [272:280) chroma DC (first 4 of each channel)
//   [280:408) chroma AC  (first 4 blocks of each channel, 16 coeffs each)
// Per MB the nonzero values are emitted in flat-row order into vals[a*W..],
// clipped to +/-127; |v|>127 spills an (index, delta) exception pair; an MB
// with more than W nonzeros ships its whole dense int16 row through the
// overflow channel instead.
// ---------------------------------------------------------------------------
constexpr int kMetaStride = 19;  // must match gop_pipeline.U8_STRIDE

// shared pack state: input metadata arrays + output buffers + batch-wide
// atomics (threads pack disjoint MB ranges; only the counters are shared)
struct PackJob {
  const int32_t *kind, *qp_y, *i16_mode, *chroma_mode, *modes4, *modes8;
  const int32_t *slice_id, *luma4, *luma8, *luma_dc, *chroma_dc, *chroma_ac;
  // inter pictures only (nullable): transform_size_8x8 flags — an inter
  // MB with t8 stores its residual in luma8 rows (intra folds t8 into
  // kind so the flag is redundant there)
  const int32_t* transform8 = nullptr;
  int32_t W;
  const int32_t* dbctl;
  uint8_t* bmp;
  int8_t* vals;
  int32_t* cnt;
  uint8_t* u8meta;
  int32_t* exc_idx;
  int16_t* exc_delta;
  int32_t ecap;
  // heavy-MB overflow channel: an MB with > W nonzeros ships its whole
  // dense 408-coeff int16 row instead of bitmap+vals
  int32_t* ovf_idx;    // [ovcap] MB indices
  int16_t* ovf_rows;   // [ovcap][408]
  int32_t ovcap;
  std::atomic<int> maxnz{0};
  std::atomic<int> nexc{0};
  std::atomic<int> novf{0};
  std::atomic<int> has_pcm{0};
};

#if defined(__AVX2__)
// 8-lane left-pack shuffle masks: kCompress.t[mask][k] = index of the
// k-th set bit of mask (0x80 zero-fill past the population count)
struct CompressLUT {
  alignas(16) uint8_t t[256][8];
  CompressLUT() {
    for (int m = 0; m < 256; m++) {
      int k = 0;
      for (int j = 0; j < 8; j++)
        if ((m >> j) & 1) t[m][k++] = (uint8_t)j;
      for (; k < 8; k++) t[m][k] = 0x80;
    }
  }
};
const CompressLUT kCompress;
#endif

// Emit one MB's bitmap/vals/exc/ovf + u8meta rows from a contiguous
// 408-lane coefficient view.  The fused decode path calls this straight
// off its L1-resident lane buffer right after entropy-decoding the MB —
// the dense per-frame coefficient arena (~27 MB of writes + a cold
// re-read per 1080p frame) is skipped entirely on the hot path.
inline void pack_mb_lanes(PackJob& pj, int a, const int32_t* L,
                          int& local_max) {
  const int W = pj.W;
  uint8_t* brow = pj.bmp + (int64_t)a * 51;
  int8_t* vrow = pj.vals + (int64_t)a * W;
  uint8_t lb[51];
  int8_t lv8[408 + 8];   // +8: the vector emit overstores one group
  int32_t lexc_lane[408];
  int16_t lexc_delta[408];
  int w = 0, nlex = 0;
  // scan one byte-aligned run of 8 coefficients: emit the bitmap byte
  // and left-pack the clipped nonzero values in one shot (saturating
  // int32->int8 pack + LUT byte shuffle; |v|>127 spills to the scalar
  // exception path, which also fixes the -128 saturation edge to the
  // ABI's -127 clip)
  for (int byte = 0; byte < 51; byte++) {
    const int32_t* r8 = L + byte * 8;
#if defined(__AVX2__)
    __m256i v = _mm256_loadu_si256((const __m256i*)r8);
    __m256i z = _mm256_cmpeq_epi32(v, _mm256_setzero_si256());
    unsigned bits =
        (~(unsigned)_mm256_movemask_ps(_mm256_castsi256_ps(z))) & 0xFF;
    lb[byte] = (uint8_t)bits;
    if (!bits) continue;
    __m128i p16 = _mm_packs_epi32(_mm256_castsi256_si128(v),
                                  _mm256_extracti128_si256(v, 1));
    __m128i p8 = _mm_packs_epi16(p16, p16);
    p8 = _mm_max_epi8(p8, _mm_set1_epi8(-127));
    __m128i sh = _mm_loadl_epi64((const __m128i*)kCompress.t[bits]);
    _mm_storel_epi64((__m128i*)(lv8 + w), _mm_shuffle_epi8(p8, sh));
    // |v| > 127 exceptions (rare): scalar fix-up per offending lane
    __m256i big = _mm256_cmpgt_epi32(_mm256_abs_epi32(v),
                                     _mm256_set1_epi32(127));
    unsigned ebits =
        (unsigned)_mm256_movemask_ps(_mm256_castsi256_ps(big)) & 0xFF;
    if (__builtin_expect(ebits != 0, 0)) {
      unsigned rem = bits;
      int k = 0;
      while (rem) {
        int j = __builtin_ctz(rem);
        rem &= rem - 1;
        if ((ebits >> j) & 1) {
          int32_t vj = r8[j];
          int8_t c8 = (int8_t)(vj > 127 ? 127 : -127);
          lv8[w + k] = c8;
          lexc_lane[nlex] = byte * 8 + j;
          lexc_delta[nlex] = (int16_t)(vj - c8);
          nlex++;
        }
        k++;
      }
    }
    w += __builtin_popcount(bits);
#else
    unsigned bits = 0;
    for (int j = 0; j < 8; j++) bits |= (r8[j] != 0) << j;
    lb[byte] = (uint8_t)bits;
    unsigned rem = bits;
    while (rem) {
      int j = __builtin_ctz(rem);
      rem &= rem - 1;
      int32_t vj = r8[j];
      int8_t c8 = (int8_t)(vj > 127 ? 127 : (vj < -127 ? -127 : vj));
      if (w < 408) lv8[w] = c8;
      if (vj > 127 || vj < -127) {
        lexc_lane[nlex] = byte * 8 + j;
        lexc_delta[nlex] = (int16_t)(vj - c8);
        nlex++;
      }
      w++;
    }
#endif
  }
  if (w <= W) {
    std::memcpy(brow, lb, 51);
    std::memcpy(vrow, lv8, w);
    if (w < W) std::memset(vrow + w, 0, W - w);
    for (int e0 = 0; e0 < nlex; e0++) {
      int e = pj.nexc.fetch_add(1, std::memory_order_relaxed);
      if (e < pj.ecap) {
        pj.exc_idx[e] = a * 408 + lexc_lane[e0];
        pj.exc_delta[e] = lexc_delta[e0];
      }
    }
    pj.cnt[a] = w;
  } else {
    // overflow: empty bitmap row; the dense int16 row rides ovf_rows
    std::memset(brow, 0, 51);
    std::memset(vrow, 0, W);
    pj.cnt[a] = 0;
    int o = pj.novf.fetch_add(1, std::memory_order_relaxed);
    if (o < pj.ovcap) {
      pj.ovf_idx[o] = a;
      int16_t* r = pj.ovf_rows + (int64_t)o * 408;
      for (int i = 0; i < 408; i++) r[i] = (int16_t)L[i];
    }
  }
  // true max nonzeros/MB over ALL MBs (overflowing ones included): the
  // caller uses it to grow the sticky vals stride W when a high-density
  // stream would otherwise push most MBs through the 816-byte-per-MB
  // overflow channel (the round-4 e2e wire-size cliff)
  if (w > local_max) local_max = w;
  // per-MB metadata row (nibble-packed intra modes: modes fit 4 bits);
  // inter MBs (native kinds 4..10) carry stale intra-mode arena slots —
  // zero them so the device unpack never gathers with garbage indices
  uint8_t* m = pj.u8meta + (int64_t)a * kMetaStride;
  int kk = pj.kind[a];
  bool inter = kk >= 4 && kk <= 10;
  // bit 6 of the kind byte carries the inter transform-size flag (intra
  // folds it into the kind, so the bit stays 0 on the intra paths)
  int t8f = (pj.transform8 && pj.transform8[a]) ? 0x40 : 0;
  m[0] = (uint8_t)(kk | t8f);
  m[1] = (uint8_t)pj.qp_y[a];
  if (inter) {
    std::memset(m + 2, 0, 12);
  } else {
    m[2] = (uint8_t)pj.i16_mode[a];
    m[3] = (uint8_t)pj.chroma_mode[a];
    const int32_t* m4 = pj.modes4 + (int64_t)a * 16;
    for (int i = 0; i < 8; i++)
      m[4 + i] =
          (uint8_t)((m4[2 * i] & 0xF) | ((m4[2 * i + 1] & 0xF) << 4));
    const int32_t* m8 = pj.modes8 + (int64_t)a * 4;
    m[12] = (uint8_t)((m8[0] & 0xF) | ((m8[1] & 0xF) << 4));
    m[13] = (uint8_t)((m8[2] & 0xF) | ((m8[3] & 0xF) << 4));
  }
  int sid = pj.slice_id[a];
  m[14] = (uint8_t)(sid & 0xFF);
  m[15] = (uint8_t)((sid >> 8) & 0xFF);
  m[16] = (uint8_t)pj.dbctl[sid * 3 + 0];
  m[17] = (uint8_t)(pj.dbctl[sid * 3 + 1] + 12);
  m[18] = (uint8_t)(pj.dbctl[sid * 3 + 2] + 12);
}

struct SliceCtx {
  Engine eng;
  const PicParams* pp;
  Out* out;
  std::vector<MB>* mbs;
  int slice_id;
  int curr;
  int prev_addr = -1;
  int qpy_prev;
  int slice_type = ST_I;
  int nref_l0 = 0, nref_l1 = 0;  // num_ref_idx_lX_active_minus1

  // fused direct-pack mode (4:2:0 intra): residual coefficients land in
  // the L1-resident `lanes` buffer in device-ABI order instead of the
  // dense per-frame arena, and each completed MB is packed straight from
  // it (pack_mb_lanes) — no arena memsets/stores, no cold pack rescan
  PackJob* pj = nullptr;
  int pack_local_max = 0;
  int32_t lanes[408] = {};

  MB unavailable_intra;
  MB unavailable_inter;

  SliceCtx() {
    std::memset(&unavailable_intra, 0, sizeof(MB));
    unavailable_intra.cbp = 0x0F;
    std::memset(unavailable_intra.cbf, 1, sizeof(unavailable_intra.cbf));
    std::memset(&unavailable_inter, 0, sizeof(MB));
  }

  MB* mb_at(int addr) {
    if (addr < 0 || addr >= (int)mbs->size()) return &unavailable_intra;
    if (out->slice_id[addr] != slice_id || addr >= curr ||
        addr < 0)
      return &unavailable_intra;
    return &(*mbs)[addr];
  }
  bool mb_avail(int addr) { return mb_at(addr) != &unavailable_intra; }

  MB* cur() { return &(*mbs)[curr]; }

  MB* nb(char dir) {
    int w = pp->mb_w;
    int x = curr % w;
    switch (dir) {
      case 'A': return x > 0 ? mb_at(curr - 1) : &unavailable_intra;
      case 'B': return mb_at(curr - w);
      case 'C': return x + 1 < w ? mb_at(curr - w + 1) : &unavailable_intra;
      default:  return x > 0 ? mb_at(curr - w - 1) : &unavailable_intra;
    }
  }

  // 4x4 z-block neighbor: returns MB + blk index
  MB* nb_blk4(char dir, int blk, int* nb_blk) {
    int x = kZPos[blk].x, y = kZPos[blk].y;
    if (dir == 'A') {
      if (x > 0) { *nb_blk = kPosToZ[y][x - 1]; return cur(); }
      *nb_blk = kPosToZ[y][3];
      return nb('A');
    }
    if (y > 0) { *nb_blk = kPosToZ[y - 1][x]; return cur(); }
    *nb_blk = kPosToZ[3][x];
    return nb('B');
  }
  MB* nb_blk8(char dir, int blk, int* nb_blk) {
    int x = blk & 1, y = blk >> 1;
    if (dir == 'A') {
      if (x > 0) { *nb_blk = y * 2; return cur(); }
      *nb_blk = y * 2 + 1;
      return nb('A');
    }
    if (y > 0) { *nb_blk = x; return cur(); }
    *nb_blk = 2 + x;
    return nb('B');
  }
  MB* nb_blkc(char dir, int blk, int* nb_blk) {
    int h = 2 * pp->chroma_array_type;
    int x = blk & 1, y = blk >> 1;
    if (dir == 'A') {
      if (x > 0) { *nb_blk = y * 2; return cur(); }
      *nb_blk = y * 2 + 1;
      return nb('A');
    }
    if (y > 0) { *nb_blk = (y - 1) * 2 + x; return cur(); }
    *nb_blk = (h - 1) * 2 + x;
    return nb('B');
  }

  // ---- syntax elements ------------------------------------------------
  void mb_type_i(MB* mb, const int* slots /* 7 entries, [1] unused */) {
    if (eng.decision(slots[0]) == 0) {
      mb->kind = KIND_I4;  // refined by transform_size flag
      return;
    }
    if (eng.terminate()) { mb->kind = KIND_PCM; return; }
    mb->kind = KIND_I16;
    int cbp_luma = eng.decision(slots[2]);
    int cbp_chroma = 0;
    if (eng.decision(slots[3]))
      cbp_chroma = 1 + eng.decision(slots[4]);
    int hi = eng.decision(slots[5]);
    int lo = eng.decision(slots[6]);
    mb->i16_mode = (hi << 1) | lo;
    mb->cbp = (cbp_chroma << 4) | (cbp_luma ? 0x0F : 0);
  }

  void i_slots(int* slots) {
    MB* a = nb('A');
    MB* b = nb('B');
    int inc = (a != &unavailable_intra && a->kind != KIND_I4 &&
               a->kind != KIND_I8) +
              (b != &unavailable_intra && b->kind != KIND_I4 &&
               b->kind != KIND_I8);
    int s[7] = {CTX_MB_TYPE_I + inc, -1, CTX_MB_TYPE_I + 3,
                CTX_MB_TYPE_I + 4, CTX_MB_TYPE_I + 5, CTX_MB_TYPE_I + 6,
                CTX_MB_TYPE_I + 7};
    std::memcpy(slots, s, sizeof(s));
  }

  int mb_skip_flag() {
    int base = (slice_type == ST_P || slice_type == ST_SP) ? CTX_MB_SKIP_P
                                                           : CTX_MB_SKIP_B;
    MB* a = nb('A');
    MB* b = nb('B');
    int inc = (a != &unavailable_intra && a->kind != KIND_P_SKIP &&
               a->kind != KIND_B_SKIP) +
              (b != &unavailable_intra && b->kind != KIND_P_SKIP &&
               b->kind != KIND_B_SKIP);
    return eng.decision(base + inc);
  }

  void mb_type_p(MB* mb) {
    const int base = CTX_MB_TYPE_P_PRE;
    static const int psuf[7] = {CTX_MB_TYPE_P_SUF, -1, CTX_MB_TYPE_P_SUF + 1,
                                CTX_MB_TYPE_P_SUF + 2, CTX_MB_TYPE_P_SUF + 2,
                                CTX_MB_TYPE_P_SUF + 3, CTX_MB_TYPE_P_SUF + 3};
    if (eng.decision(base)) { mb_type_i(mb, psuf); return; }
    int code;
    if (eng.decision(base + 1) == 0)
      code = eng.decision(base + 2) ? 3 : 0;
    else
      code = eng.decision(base + 3) ? 1 : 2;
    mb->mb_type_code = code;
    mb->kind = (code == 3) ? KIND_P8X8 : KIND_P;
  }

  void mb_type_b(MB* mb) {
    const int base = CTX_MB_TYPE_B_PRE;
    static const int bsuf[7] = {CTX_MB_TYPE_B_SUF, -1, CTX_MB_TYPE_B_SUF + 1,
                                CTX_MB_TYPE_B_SUF + 2, CTX_MB_TYPE_B_SUF + 2,
                                CTX_MB_TYPE_B_SUF + 3, CTX_MB_TYPE_B_SUF + 3};
    MB* a = nb('A');
    MB* b = nb('B');
    int inc = (a != &unavailable_intra && a->kind != KIND_B_SKIP &&
               a->kind != KIND_B_DIRECT) +
              (b != &unavailable_intra && b->kind != KIND_B_SKIP &&
               b->kind != KIND_B_DIRECT);
    if (eng.decision(base + inc) == 0) {
      mb->mb_type_code = 0;
      mb->kind = KIND_B_DIRECT;
      return;
    }
    if (eng.decision(base + 3) == 0) {
      mb->mb_type_code = 1 + eng.decision(base + 5);
      mb->kind = KIND_B;
      return;
    }
    if (eng.decision(base + 4) == 0) {
      int v = 0;
      for (int i = 0; i < 3; i++) v = (v << 1) | eng.decision(base + 5);
      mb->mb_type_code = 3 + v;
      mb->kind = KIND_B;
      return;
    }
    if (eng.decision(base + 5) == 0) {  // tail 0xxx -> 12..19
      int v = 0;
      for (int i = 0; i < 3; i++) v = (v << 1) | eng.decision(base + 5);
      mb->mb_type_code = 12 + v;
      mb->kind = KIND_B;
      return;
    }
    if (eng.decision(base + 5) == 0) {
      if (eng.decision(base + 5) == 0) {  // tail 100b
        mb->mb_type_code = 20 + eng.decision(base + 5);
        mb->kind = KIND_B;
      } else {  // tail 101 -> I escape
        mb_type_i(mb, bsuf);
      }
      return;
    }
    if (eng.decision(base + 5) == 0) {
      mb->mb_type_code = 11;
      mb->kind = KIND_B;
    } else {
      mb->mb_type_code = 22;
      mb->kind = KIND_B8X8;
    }
  }

  void sub_mb_types(MB* mb) {
    if (slice_type == ST_P || slice_type == ST_SP) {
      const int base = CTX_SUB_MB_TYPE_P;
      for (int i = 0; i < 4; i++) {
        if (eng.decision(base)) mb->sub_mb_type[i] = 0;
        else if (eng.decision(base + 1) == 0) mb->sub_mb_type[i] = 1;
        else if (eng.decision(base + 2)) mb->sub_mb_type[i] = 2;
        else mb->sub_mb_type[i] = 3;
      }
    } else {
      const int base = CTX_SUB_MB_TYPE_B;
      for (int i = 0; i < 4; i++) {
        if (eng.decision(base) == 0) { mb->sub_mb_type[i] = 0; continue; }
        if (eng.decision(base + 1) == 0) {
          mb->sub_mb_type[i] = 1 + eng.decision(base + 3);
          continue;
        }
        if (eng.decision(base + 2) == 0) {
          int v = (eng.decision(base + 3) << 1) | eng.decision(base + 3);
          mb->sub_mb_type[i] = 3 + v;
          continue;
        }
        if (eng.decision(base + 3) == 0) {
          int v = (eng.decision(base + 3) << 1) | eng.decision(base + 3);
          mb->sub_mb_type[i] = 7 + v;
        } else {
          mb->sub_mb_type[i] = 11 + eng.decision(base + 3);
        }
      }
    }
  }

  int ref_idx_se(MB* mb, int blk8, int which, int max_ref) {
    if (max_ref == 0) { mb->ref_idx[which][blk8] = 0; return 0; }
    int ia, ib;
    MB* a = nb_blk8('A', blk8, &ia);
    MB* b = nb_blk8('B', blk8, &ib);
    int cond = (a->ref_idx[which][ia] > 0) + 2 * (b->ref_idx[which][ib] > 0);
    int ctx0 = CTX_REF_IDX + cond;
    int v = 0;
    while (eng.decision(v == 0 ? ctx0 : (v == 1 ? CTX_REF_IDX + 4
                                                : CTX_REF_IDX + 5))) {
      if (++v > 63) break;
    }
    mb->ref_idx[which][blk8] = (int8_t)v;
    return v;
  }

  int mvd_se(MB* mb, int blk4, int comp, int which) {
    int base = comp ? CTX_MVD_Y : CTX_MVD_X;
    int ia, ib;
    MB* a = nb_blk4('A', blk4, &ia);
    MB* b = nb_blk4('B', blk4, &ib);
    int sum = std::abs((int)a->mvd[which][ia][comp]) +
              std::abs((int)b->mvd[which][ib][comp]);
    int inc = sum < 3 ? 0 : (sum <= 32 ? 1 : 2);
    int ctxs[5] = {base + inc, base + 3, base + 4, base + 5, base + 6};
    int pre = 0;
    while (pre < 9 && eng.decision(ctxs[pre < 4 ? pre : 4])) pre++;
    int v = pre;
    if (pre >= 9) {  // UEG3 suffix
      int k = 3;
      while (eng.bypass()) { v += 1 << k; k++; }
      if (k <= 16) v += eng.bypass_n(k);
      else
        while (k > 0) { k--; if (eng.bypass()) v += 1 << k; }
    }
    if (v != 0 && eng.bypass()) v = -v;
    mb->mvd[which][blk4][comp] = (int16_t)v;
    return v;
  }

  void mb_pred_inter(MB* mb) {
    const PartInfo& pi = (slice_type == ST_B) ? kBParts[mb->mb_type_code]
                                              : kPParts[mb->mb_type_code];
    for (int which = 0; which < 2; which++) {
      int nref = which ? nref_l1 : nref_l0;
      for (int p = 0; p < pi.n; p++) {
        int pred = pi.pred[p];
        bool uses = which == 0 ? (pred == PRED_L0 || pred == PRED_BI)
                               : (pred == PRED_L1 || pred == PRED_BI);
        if (!uses) continue;
        int q0 = pi.wh == 0 ? 0 : (pi.wh == 1 ? (p ? 2 : 0) : (p ? 1 : 0));
        int v = ref_idx_se(mb, q0, which, nref);
        if (pi.wh == 0) {
          for (int q = 0; q < 4; q++) mb->ref_idx[which][q] = (int8_t)v;
        } else if (pi.wh == 1) {
          mb->ref_idx[which][p * 2] = (int8_t)v;
          mb->ref_idx[which][p * 2 + 1] = (int8_t)v;
        } else {
          mb->ref_idx[which][p] = (int8_t)v;
          mb->ref_idx[which][p + 2] = (int8_t)v;
        }
      }
    }
    for (int which = 0; which < 2; which++) {
      for (int p = 0; p < pi.n; p++) {
        int pred = pi.pred[p];
        bool uses = which == 0 ? (pred == PRED_L0 || pred == PRED_BI)
                               : (pred == PRED_L1 || pred == PRED_BI);
        if (!uses) continue;
        const int* blks;
        int nblk, anchor;
        static const int all16[16] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                                      12, 13, 14, 15};
        if (pi.wh == 0) { blks = all16; nblk = 16; anchor = 0; }
        else if (pi.wh == 1) { blks = kPart16x8[p]; nblk = 8; anchor = blks[0]; }
        else { blks = kPart8x16[p]; nblk = 8; anchor = blks[0]; }
        for (int comp = 0; comp < 2; comp++) {
          int v = mvd_se(mb, anchor, comp, which);
          for (int i = 0; i < nblk; i++)
            mb->mvd[which][blks[i]][comp] = (int16_t)v;
        }
      }
    }
  }

  void sub_mb_pred(MB* mb) {
    bool isb = slice_type == ST_B;
    for (int which = 0; which < 2; which++) {
      int nref = which ? nref_l1 : nref_l0;
      for (int q = 0; q < 4; q++) {
        const SubInfo& si = isb ? kBSub[mb->sub_mb_type[q]]
                                : kPSub[mb->sub_mb_type[q]];
        bool uses = which == 0 ? (si.pred == PRED_L0 || si.pred == PRED_BI)
                               : (si.pred == PRED_L1 || si.pred == PRED_BI);
        if (!uses) continue;
        ref_idx_se(mb, q, which, nref);
      }
    }
    for (int which = 0; which < 2; which++) {
      for (int q = 0; q < 4; q++) {
        const SubInfo& si = isb ? kBSub[mb->sub_mb_type[q]]
                                : kPSub[mb->sub_mb_type[q]];
        bool uses = which == 0 ? (si.pred == PRED_L0 || si.pred == PRED_BI)
                               : (si.pred == PRED_L1 || si.pred == PRED_BI);
        if (!uses) continue;
        for (int part = 0; part < si.n; part++) {
          int sub0;
          int subs[4];
          int nsub;
          if (si.shape == 0) { subs[0] = 0; subs[1] = 1; subs[2] = 2;
            subs[3] = 3; nsub = 4; }
          else if (si.shape == 1) { subs[0] = kSub8x4[part][0];
            subs[1] = kSub8x4[part][1]; nsub = 2; }
          else if (si.shape == 2) { subs[0] = kSub4x8[part][0];
            subs[1] = kSub4x8[part][1]; nsub = 2; }
          else { subs[0] = part; nsub = 1; }
          sub0 = 4 * q + subs[0];
          for (int comp = 0; comp < 2; comp++) {
            int v = mvd_se(mb, sub0, comp, which);
            for (int i = 0; i < nsub; i++)
              mb->mvd[which][4 * q + subs[i]][comp] = (int16_t)v;
          }
        }
      }
    }
  }

  void transform_size_flag(MB* mb) {
    int inc = nb('A')->transform8 + nb('B')->transform8;
    mb->transform8 = eng.decision(CTX_TRANSFORM_SIZE_8X8_FLAG + inc);
    if (mb->transform8) mb->kind = KIND_I8;
  }

  // neighbor intra mode; -1 = neighbor MB unavailable
  int nb_mode4(char dir, int blk) {
    int nbb;
    MB* m = nb_blk4(dir, blk, &nbb);
    if (m == cur()) return m->modes4[nbb];
    if (m == &unavailable_intra) return -1;
    if (m->kind != KIND_I4 && m->kind != KIND_I8) return 2;
    if (m->kind == KIND_I8) return m->modes8[nbb >> 2];
    return m->modes4[nbb];
  }
  int nb_mode8(char dir, int blk) {
    int nbb;
    MB* m = nb_blk8(dir, blk, &nbb);
    if (m == cur()) return m->modes8[nbb];
    if (m == &unavailable_intra) return -1;
    if (m->kind != KIND_I4 && m->kind != KIND_I8) return 2;
    if (m->kind == KIND_I8) return m->modes8[nbb];
    return m->modes4[4 * nbb + (dir == 'A' ? 1 : 2)];
  }

  void intra4_modes(MB* mb) {
    for (int blk = 0; blk < 16; blk++) {
      int ma = nb_mode4('A', blk), mbv = nb_mode4('B', blk);
      int pred = (ma < 0 || mbv < 0) ? 2 : (ma < mbv ? ma : mbv);
      if (eng.decision(CTX_PREV_INTRA_PRED_MODE_FLAG)) {
        mb->modes4[blk] = pred;
      } else {
        int rem = 0;
        for (int i = 0; i < 3; i++)
          rem |= eng.decision(CTX_REM_INTRA_PRED_MODE) << i;
        mb->modes4[blk] = rem < pred ? rem : rem + 1;
      }
    }
  }
  void intra8_modes(MB* mb) {
    for (int blk = 0; blk < 4; blk++) {
      int ma = nb_mode8('A', blk), mbv = nb_mode8('B', blk);
      int pred = (ma < 0 || mbv < 0) ? 2 : (ma < mbv ? ma : mbv);
      int mode;
      if (eng.decision(CTX_PREV_INTRA_PRED_MODE_FLAG)) {
        mode = pred;
      } else {
        int rem = 0;
        for (int i = 0; i < 3; i++)
          rem |= eng.decision(CTX_REM_INTRA_PRED_MODE) << i;
        mode = rem < pred ? rem : rem + 1;
      }
      mb->modes8[blk] = mode;
      for (int s = 0; s < 4; s++) mb->modes4[4 * blk + s] = mode;
    }
  }

  void chroma_mode(MB* mb) {
    int inc = (nb('A')->chroma_mode != 0) + (nb('B')->chroma_mode != 0);
    int v = 0;
    while (v < 3 &&
           eng.decision(v == 0 ? CTX_INTRA_CHROMA_PRED_MODE + inc
                               : CTX_INTRA_CHROMA_PRED_MODE + 3))
      v++;
    mb->chroma_mode = v;
  }

  void cbp(MB* mb) {
    int bits[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
      int ia, ib;
      MB* a = nb_blk8('A', i, &ia);
      MB* b = nb_blk8('B', i, &ib);
      int bit_a = (a == cur()) ? bits[ia] : ((a->cbp >> ia) & 1);
      int bit_b = (b == cur()) ? bits[ib] : ((b->cbp >> ib) & 1);
      bits[i] = eng.decision(CTX_CBP_LUMA + (1 - bit_a) + 2 * (1 - bit_b));
    }
    if (pp->chroma_array_type == 1 || pp->chroma_array_type == 2) {
      int ca = nb('A')->cbp >> 4, cb = nb('B')->cbp >> 4;
      bits[4] = eng.decision(CTX_CBP_CHROMA + (ca > 0) + 2 * (cb > 0));
      if (bits[4])
        bits[5] = eng.decision(CTX_CBP_CHROMA + 4 + (ca > 1) + 2 * (cb > 1));
    }
    int v = bits[0] | bits[1] << 1 | bits[2] << 2 | bits[3] << 3;
    if (bits[4]) v |= 0x10 << bits[5];
    mb->cbp = v;
  }

  void qp_delta(MB* mb) {
    MB* prev = (prev_addr >= 0 && out->slice_id[prev_addr] == slice_id)
                   ? &(*mbs)[prev_addr] : nullptr;
    int c0 = CTX_MB_QP_DELTA + ((prev && prev->qp_delta != 0) ? 1 : 0);
    int tmp = 0;
    while (eng.decision(tmp == 0 ? c0
                        : (tmp == 1 ? CTX_MB_QP_DELTA + 2
                                    : CTX_MB_QP_DELTA + 3))) {
      if (++tmp > 87) break;
    }
    mb->qp_delta = (tmp & 1) ? (tmp + 1) >> 1 : -(tmp >> 1);
  }

  int coded_block_flag(int cat, int idx) {
    MB* c = cur();
    int comp, ridx = idx;
    MB *a, *b;
    int ia = 16, ib = 16;
    switch (cat) {
      case CAT_LUMA_DC:
        comp = 0; a = nb('A'); b = nb('B'); break;
      case CAT_LUMA_AC: case CAT_LUMA_4X4:
        comp = 0; a = nb_blk4('A', idx, &ia); b = nb_blk4('B', idx, &ib);
        break;
      case CAT_LUMA_8X8:
        comp = 0; a = nb_blk8('A', idx, &ia); b = nb_blk8('B', idx, &ib);
        ia *= 4; ib *= 4; break;
      case CAT_CHROMA_DC:
        comp = idx + 1; a = nb('A'); b = nb('B'); break;
      default:  // CAT_CHROMA_AC
        comp = (idx >> 3) + 1; ridx = idx & 7;
        a = nb_blkc('A', ridx, &ia); b = nb_blkc('B', ridx, &ib); break;
    }
    if (kind_is_inter(cur()->kind)) {
      if (a == &unavailable_intra) a = &unavailable_inter;
      if (b == &unavailable_intra) b = &unavailable_inter;
    }
    int cond = a->cbf[comp][ia] + 2 * b->cbf[comp][ib];
    int v = eng.decision(kCbfBase[cat] + cond);
    switch (cat) {
      case CAT_LUMA_DC: c->cbf[0][16] = v; break;
      case CAT_LUMA_AC: case CAT_LUMA_4X4: c->cbf[0][idx] = v; break;
      case CAT_LUMA_8X8:
        for (int k = 0; k < 4; k++) c->cbf[0][idx * 4 + k] = v;
        break;
      case CAT_CHROMA_DC: c->cbf[comp][16] = v; break;
      default: c->cbf[comp][ridx] = v; break;
    }
    return v;
  }

  __attribute__((always_inline)) inline void residual_block(int cat, int idx, int32_t* coeffs, const int* remap,
                      int out_size, int start, int end, int maxnumcoeff,
                      bool coded) {
    MB* c = cur();
    int cbf;
    TSC_BEGIN;
    if (coded) {
      if (maxnumcoeff != 64 || pp->chroma_array_type == 3) {
        cbf = coded_block_flag(cat, idx);
      } else {
        cbf = 1;
        for (int k = 0; k < 4; k++) c->cbf[0][idx * 4 + k] = 1;
      }
    } else {
      cbf = 0;
      switch (cat) {
        case CAT_LUMA_DC: c->cbf[0][16] = 0; break;
        case CAT_LUMA_AC: case CAT_LUMA_4X4: c->cbf[0][idx] = 0; break;
        case CAT_LUMA_8X8:
          for (int k = 0; k < 4; k++) c->cbf[0][idx * 4 + k] = 0;
          break;
        case CAT_CHROMA_DC: c->cbf[idx + 1][16] = 0; break;
        default: c->cbf[(idx >> 3) + 1][idx & 7] = 0; break;
      }
    }
    TSC_END(0);
    if (!pj) std::memset(coeffs, 0, out_size * sizeof(int32_t));
    if (!cbf) return;

    const uint16_t* sigtab = kSigCtx.sig[cat];
    const uint16_t* lasttab = kSigCtx.last[cat];
    if (cat == CAT_CHROMA_DC && pp->chroma_array_type == 2) {
      sigtab = kSigCtx.sig_cdc2;
      lasttab = kSigCtx.last_cdc2;
    }
    // significant positions gathered into a compact local list; decoded
    // magnitudes buffered locally so the engine state stays in registers
    // (stores through `coeffs` would force reloads); the engine state
    // itself runs register-resident via EngHot for the whole block
    uint8_t sigpos[64];
    int32_t vals[64];
    int nsig = 0;
    int numcoeff = end + 1;
    EngHot h = eng_adopt(eng);
    { TSC_BEGIN;
    // NOTE: an explicitly software-pipelined two-bin scan (speculating
    // the next bin's LPS extraction across both outcomes) was tried in
    // round 5 and measured 12-16% SLOWER than this loop on the bench
    // host: the 0-skewed last-flag branch predicts well enough that the
    // out-of-order core already overlaps adjacent bins' resolve chains,
    // and the 4-way (state x context) candidate arithmetic only added
    // issue pressure.  Keep the simple form.
    for (int i = start; i < numcoeff - 1; i++) {
      if (decision_bl_h(h, eng, sigtab[i])) {
        sigpos[nsig++] = (uint8_t)i;
        // last-flag is 1 at most once per block (the loop exits there),
        // so it is heavily 0-skewed: the branchy predicted path beats
        // the deterministic-latency CMOV variant here
        if (decision_h(h, eng, lasttab[i])) { numcoeff = i + 1; goto levels; }
      }
    }
    sigpos[nsig++] = (uint8_t)(numcoeff - 1);
  levels:;
    TSC_END(1); }
    { TSC_BEGIN;
      int num1 = 0, numgt1 = 0;
      const int base = kAbsBase[cat];
      const int clampv = (cat == CAT_CHROMA_DC) ? 3 : 4;
      // sticky register-cached context records: c0 walks base+1..base+4
      // then pins at base+0 after the first gt1; c1 walks base+5..
      // base+5+clamp then pins.  Both sequences are monotone with
      // disjoint ranges, so each record lives in a register between
      // (rare) context switches instead of a load+store per coefficient.
      int c0 = base + 1, c1 = base + 5;
      uint64_t r0 = eng.ctx_rec[c0], r1 = eng.ctx_rec[c1];
      // one branchless bin against a local record (CMOV; identical
      // arithmetic to decision_bl_h)
      auto bin_rec = [&](uint64_t& r) -> unsigned {
        unsigned s = (unsigned)r & 0xff;
        uint32_t lps = (uint32_t)(r >> (8 + ((h.range >> 3) & 24))) & 0xff;
        uint32_t mps_rng = h.range - lps;
        uint64_t scaled = (uint64_t)mps_rng << h.lowbits;
        uint64_t is_lps = (uint64_t)(h.low >= scaled);
        h.low -= scaled & (0 - is_lps);
        uint32_t nrange = is_lps ? lps : mps_rng;
        r = is_lps ? kPackedTrans.lrec[s] : kPackedTrans.mrec[s];
        int nn = __builtin_clz(nrange) - 23;
        h.range = nrange << nn;
        h.lowbits -= nn;
        if (__builtin_expect(h.lowbits < 8, 0)) refill_low_h(h, eng);
        h.bins++;
        return (s & 1) ^ (unsigned)is_lps;
      };
      // branchy-MPS variant of bin_rec for skewed bins (the TU prefix
      // continuation: once a level's context adapts, continuation bins
      // are well predicted, so speculation beats the CMOV chain latency)
      auto bin_rec_br = [&](uint64_t& r) -> unsigned {
        h.bins++;
        unsigned s = (unsigned)r & 0xff;
        uint32_t lps = (uint32_t)(r >> (8 + ((h.range >> 3) & 24))) & 0xff;
        uint32_t mps_rng = h.range - lps;
        uint64_t scaled = (uint64_t)mps_rng << h.lowbits;
        if (__builtin_expect(h.low < scaled, 1)) {  // MPS
          r = kPackedTrans.mrec[s];
          if (__builtin_expect(mps_rng >= 256, 1)) {
            h.range = mps_rng;
            return s & 1;
          }
          int nn = __builtin_clz(mps_rng) - 23;
          h.range = mps_rng << nn;
          h.lowbits -= nn;
          if (__builtin_expect(h.lowbits < 8, 0)) refill_low_h(h, eng);
          return s & 1;
        }
        h.low -= scaled;
        r = kPackedTrans.lrec[s];
        int nn = __builtin_clz(lps) - 23;
        h.range = lps << nn;
        h.lowbits -= nn;
        if (__builtin_expect(h.lowbits < 8, 0)) refill_low_h(h, eng);
        return (s & 1) ^ 1u;
      };
      for (int j = nsig - 1; j >= 0; j--) {
        int pre = 0;
        if (bin_rec(r0)) {
          pre = 1;
          while (pre < 14 && bin_rec_br(r1)) pre++;
        }
        int mag = pre;
        int s;
        if (__builtin_expect(pre >= 14, 0)) {  // UEG0 suffix (+ sign)
          int k = 0;
          while (bypass_h(h, eng)) { mag += 1 << k; k++; }
          if (k <= 15) {
            int v = bypass_n_h(h, eng, k + 1);  // suffix bits + sign fused
            mag += v >> 1;
            s = v & 1;
          } else {
            while (k > 0) { k--; if (bypass_h(h, eng)) mag += 1 << k; }
            s = bypass_h(h, eng);
          }
        } else {
          s = bypass_h(h, eng);
        }
        vals[j] = s ? -(mag + 1) : mag + 1;
        if (mag != 0) {
          if (numgt1 == 0) {        // c0 pins at base+0
            eng.ctx_rec[c0] = r0;
            c0 = base;
            r0 = eng.ctx_rec[c0];
          }
          numgt1++;
          int nc1 = base + 5 + (numgt1 > clampv ? clampv : numgt1);
          if (nc1 != c1) {
            eng.ctx_rec[c1] = r1;
            c1 = nc1;
            r1 = eng.ctx_rec[c1];
          }
        } else if (numgt1 == 0) {
          num1++;
          int nc0 = base + (num1 >= 4 ? 4 : num1 + 1);
          if (nc0 != c0) {
            eng.ctx_rec[c0] = r0;
            c0 = nc0;
            r0 = eng.ctx_rec[c0];
          }
        }
      }
      eng.ctx_rec[c0] = r0;
      eng.ctx_rec[c1] = r1;
      for (int j = 0; j < nsig; j++) coeffs[remap[sigpos[j]]] = vals[j];
      TSC_END(2);
    }
    eng_release(eng, h);
  }

  __attribute__((always_inline)) inline void residual(MB* mb, int addr) {
    Out* o = out;
    int64_t a = addr;
    // direct-pack mode: write into the 408-lane device-ABI row instead
    // of the dense arena (lane layout documented at pack_mb_lanes; the
    // chroma DC lanes hold only the 4 coeffs of each 4:2:0 channel)
    int32_t* lum = pj ? lanes : nullptr;
    if (mb->kind == KIND_I16) {
      residual_block(CAT_LUMA_DC, 0, pj ? lanes + 256 : o->luma_dc + a * 16,
                     kZig4, 16, 0, 15, 16, true);
      for (int i = 0; i < 16; i++)
        residual_block(CAT_LUMA_AC, i,
                       pj ? lum + i * 16 : o->luma4 + (a * 16 + i) * 16,
                       kAc.ac4, 16, 0, 14, 15, (mb->cbp >> (i >> 2)) & 1);
    } else if (mb->kind == KIND_I8 || mb->transform8) {
      mb->cbf[0][16] = 0;
      for (int i = 0; i < 4; i++)
        residual_block(CAT_LUMA_8X8, i,
                       pj ? lum + i * 64 : o->luma8 + (a * 4 + i) * 64,
                       kZig8, 64, 0, 63, 64, (mb->cbp >> i) & 1);
    } else {
      mb->cbf[0][16] = 0;
      for (int i = 0; i < 16; i++)
        residual_block(CAT_LUMA_4X4, i,
                       pj ? lum + i * 16 : o->luma4 + (a * 16 + i) * 16,
                       kZig4, 16, 0, 15, 16, (mb->cbp >> (i >> 2)) & 1);
    }
    int catc = pp->chroma_array_type;
    if (catc == 1 || catc == 2) {
      int nc = 4 * catc;
      for (int c2 = 0; c2 < 2; c2++)
        residual_block(CAT_CHROMA_DC, c2,
                       pj ? lanes + 272 + c2 * 4
                          : o->chroma_dc + (a * 2 + c2) * 8,
                       kIdent8, 8, 0, nc - 1, nc, (mb->cbp & 0x30) != 0);
      for (int c2 = 0; c2 < 2; c2++)
        for (int j = 0; j < nc; j++)
          residual_block(CAT_CHROMA_AC, c2 * 8 + j,
                         pj ? lanes + 280 + c2 * 64 + j * 16
                            : o->chroma_ac + ((a * 2 + c2) * 8 + j) * 16,
                         kAc.ac4, 16, 0, 14, 15, (mb->cbp & 0x20) != 0);
    }
  }

  void pcm(MB* mb, int addr) {
    eng.pos = eng.cabac_pos();  // raw cursor takes over from CABAC state
    eng.byte_align();
    int bd_l = pp->bit_depth_luma;
    int bd_c = pp->bit_depth_chroma;
    for (int i = 0; i < 256; i++)
      out->pcm_y[(int64_t)addr * 256 + i] = eng.read_bits(bd_l);
    if (pp->chroma_array_type) {
      // output stride is sized for 4:2:0 (128 samples); 4:2:2/4:4:4 PCM
      // falls back to the Python entropy path
      int n = 64 << pp->chroma_array_type;
      for (int i = 0; i < n; i++) {
        int v = eng.read_bits(bd_c);
        if (i < 128) out->pcm_c[(int64_t)addr * 128 + i] = v;
      }
    }
    eng.init_engine();
    mb->qp_delta = 0;
    mb->transform8 = 0;
    mb->cbp = 0x2F;
    mb->chroma_mode = 0;
    std::memset(mb->cbf, 1, sizeof(mb->cbf));
    for (int i = 0; i < 16; i++) mb->modes4[i] = 2;
    for (int i = 0; i < 4; i++) mb->modes8[i] = 2;
  }

  void macroblock_layer(int addr) {
    MB* mb = cur();
    *mb = MB();
    for (int i = 0; i < 16; i++) mb->modes4[i] = 2;
    for (int i = 0; i < 4; i++) mb->modes8[i] = 2;
    if (slice_type == ST_I) {
      int slots[7];
      i_slots(slots);
      mb_type_i(mb, slots);
    } else if (slice_type == ST_SI) {
      MB* a = nb('A');
      MB* b = nb('B');
      int inc = (a != &unavailable_intra && a->kind != KIND_SI) +
                (b != &unavailable_intra && b->kind != KIND_SI);
      if (eng.decision(CTX_MB_TYPE_SI_PRE + inc) == 0) {
        mb->kind = KIND_SI;
      } else {
        int slots[7];
        i_slots(slots);
        mb_type_i(mb, slots);
      }
    } else if (slice_type == ST_P || slice_type == ST_SP) {
      mb_type_p(mb);
    } else {
      mb_type_b(mb);
    }

    if (mb->kind == KIND_PCM) {
      pcm(mb, addr);
    } else {
      bool intra = kind_is_intra(mb->kind);
      bool no_small = true;
      if (mb->kind == KIND_P8X8 || mb->kind == KIND_B8X8) {
        sub_mb_types(mb);
        bool isb = slice_type == ST_B;
        for (int q = 0; q < 4; q++) {
          const SubInfo& si = isb ? kBSub[mb->sub_mb_type[q]]
                                  : kPSub[mb->sub_mb_type[q]];
          if (si.pred == PRED_DIRECT) {
            if (!pp->direct_8x8_inference_flag) no_small = false;
          } else if (si.shape != 0) {
            no_small = false;
          }
        }
        sub_mb_pred(mb);
        mb->chroma_mode = 0;
      } else {
        if ((mb->kind == KIND_I4 || mb->kind == KIND_I8) &&
            pp->transform_8x8_mode_flag)
          transform_size_flag(mb);
        if (mb->kind == KIND_I8) intra8_modes(mb);
        else if (mb->kind == KIND_I4 || mb->kind == KIND_SI)
          intra4_modes(mb);
        if (intra &&
            (pp->chroma_array_type == 1 || pp->chroma_array_type == 2))
          chroma_mode(mb);
        if (mb->kind == KIND_P || mb->kind == KIND_B) mb_pred_inter(mb);
      }

      if (mb->kind != KIND_I16) {
        cbp(mb);
        if (!intra && (mb->cbp & 0x0F) && pp->transform_8x8_mode_flag &&
            no_small &&
            (mb->kind != KIND_B_DIRECT || pp->direct_8x8_inference_flag)) {
          int inc = nb('A')->transform8 + nb('B')->transform8;
          mb->transform8 = eng.decision(CTX_TRANSFORM_SIZE_8X8_FLAG + inc);
        }
      }
      if (mb->cbp != 0 || mb->kind == KIND_I16) qp_delta(mb);
      else mb->qp_delta = 0;
      residual(mb, addr);
    }
    int off = 6 * (pp->bit_depth_luma - 8);
    mb->qp_y = ((qpy_prev + mb->qp_delta + 52 + 2 * off) % (52 + off)) - off;
    qpy_prev = mb->qp_y;
  }
};

struct SliceParams {
  int64_t rbsp_off, rbsp_len, bit_off;
  int32_t first_mb, slice_qp, slice_type, cabac_init_idc;
  int32_t nref_l0, nref_l1;
};

void decode_one_slice(const uint8_t* rbsp, const SliceParams& sp,
                      int last_mb, int slice_id, const PicParams* pp,
                      Out* o, std::vector<MB>* mbs, int slice_index,
                      PackJob* pj = nullptr,
                      const int32_t* mb_next = nullptr) {
  SliceCtx s;
  s.pj = pj;
  s.pp = pp;
  s.out = o;
  s.mbs = mbs;
  s.slice_id = slice_id;
  s.curr = sp.first_mb;
  s.qpy_prev = sp.slice_qp;
  s.slice_type = sp.slice_type;
  s.nref_l0 = sp.nref_l0;
  s.nref_l1 = sp.nref_l1;
  s.eng.data = rbsp;
  s.eng.pos = sp.bit_off;
  s.eng.bit_len = sp.rbsp_len * 8;
  bool is_intra = sp.slice_type == ST_I || sp.slice_type == ST_SI;
  s.eng.init_contexts(sp.slice_qp,
                      is_intra ? 0 : 1 + sp.cabac_init_idc);
  s.eng.init_engine();
  int n = pp->mb_w * pp->mb_h;
  while (true) {
    bool skipped = false;
    if (!is_intra && s.mb_skip_flag()) {
      MB* mb = s.cur();
      *mb = MB();
      for (int i = 0; i < 16; i++) mb->modes4[i] = 2;
      for (int i = 0; i < 4; i++) mb->modes8[i] = 2;
      mb->kind = (sp.slice_type == ST_B) ? KIND_B_SKIP : KIND_P_SKIP;
      mb->qp_y = (int16_t)s.qpy_prev;
      skipped = true;
    } else {
      s.macroblock_layer(s.curr);
    }
    // publish dense outputs
    MB* mb = s.cur();
    int a = s.curr;
    o->kind[a] = mb->kind;
    o->qp_y[a] = mb->qp_y;
    o->cbp[a] = mb->cbp;
    o->i16_mode[a] = mb->i16_mode;
    o->chroma_mode[a] = mb->chroma_mode;
    for (int i = 0; i < 16; i++) o->modes4[(int64_t)a * 16 + i] = mb->modes4[i];
    for (int i = 0; i < 4; i++) o->modes8[(int64_t)a * 4 + i] = mb->modes8[i];
    if (o->transform8) o->transform8[a] = mb->transform8;
    // the fused direct-pack path is intra-only: skip the ~80 dead
    // inter-syntax stores per MB (nothing downstream reads them there)
    if (o->mb_type_code && !pj) {
      o->mb_type_code[a] = mb->mb_type_code;
      for (int i = 0; i < 4; i++)
        o->sub_mb_type[(int64_t)a * 4 + i] = mb->sub_mb_type[i];
      for (int w = 0; w < 2; w++)
        for (int q = 0; q < 4; q++)
          o->ref_idx[((int64_t)a * 2 + w) * 4 + q] = mb->ref_idx[w][q];
      for (int w = 0; w < 2; w++)
        for (int b = 0; b < 16; b++)
          for (int c = 0; c < 2; c++)
            o->mvd[(((int64_t)a * 2 + w) * 16 + b) * 2 + c] =
                mb->mvd[w][b][c];
    }
    (void)skipped;
    if (pj) {
      // fused pack: the MB's lanes are L1-hot right after its residual
      // decode; emit the device-ABI rows now and re-zero the buffer
      if (mb->kind == KIND_PCM) {
        pj->has_pcm.store(1, std::memory_order_relaxed);
      } else {
        pack_mb_lanes(*pj, a, s.lanes, s.pack_local_max);
      }
      std::memset(s.lanes, 0, sizeof(s.lanes));
    }
    s.prev_addr = s.curr;
    // advance: raster by default; FMO walks the slice group's own
    // next-address chain (spec 8.2.2.8; -1 ends the group).  mb_at's
    // `addr < curr` availability stays correct because decode order is
    // raster-ascending WITHIN a slice group and cross-group neighbors
    // are excluded by the slice-id gate.
    int nxt = mb_next ? mb_next[s.curr] : s.curr + 1;
    s.curr = (nxt < 0) ? n : nxt;
    int end = s.eng.terminate();
    if (end || s.curr >= n || (last_mb >= 0 && s.curr > last_mb)) break;
  }
  if (pj) {
    int prev = pj->maxnz.load(std::memory_order_relaxed);
    while (s.pack_local_max > prev &&
           !pj->maxnz.compare_exchange_weak(prev, s.pack_local_max)) {}
  }
  if (o->bin_count) o->bin_count[slice_index] = s.eng.bins;
#ifdef DT_COUNT_LPS
  fprintf(stderr, "slice %d: bins=%lld lps=%lld mps_renorm=%lld\n",
          slice_index, (long long)s.eng.bins, (long long)s.eng.lps_count,
          (long long)s.eng.mps_renorm);
#endif
}

// publish one decoded MB into the dense outputs (shared CABAC/CAVLC)
void publish_mb(SliceCtx& s, Out* o) {
  MB* mb = s.cur();
  int64_t a = s.curr;
  o->kind[a] = mb->kind;
  o->qp_y[a] = mb->qp_y;
  o->cbp[a] = mb->cbp;
  o->i16_mode[a] = mb->i16_mode;
  o->chroma_mode[a] = mb->chroma_mode;
  for (int i = 0; i < 16; i++) o->modes4[a * 16 + i] = mb->modes4[i];
  for (int i = 0; i < 4; i++) o->modes8[a * 4 + i] = mb->modes8[i];
  if (o->transform8) o->transform8[a] = mb->transform8;
  if (o->mb_type_code) {
    o->mb_type_code[a] = mb->mb_type_code;
    for (int i = 0; i < 4; i++)
      o->sub_mb_type[a * 4 + i] = mb->sub_mb_type[i];
    for (int w = 0; w < 2; w++)
      for (int q = 0; q < 4; q++)
        o->ref_idx[(a * 2 + w) * 4 + q] = mb->ref_idx[w][q];
    for (int w = 0; w < 2; w++)
      for (int b = 0; b < 16; b++)
        for (int c = 0; c < 2; c++)
          o->mvd[((a * 2 + w) * 16 + b) * 2 + c] = mb->mvd[w][b][c];
  }
}

// ===== CAVLC slice decode (spec 9.2) — mirror of cavlc/syntax.py =====

struct CavlcCtx : SliceCtx {
  int64_t stop_bit = 0;  // bit index of the rbsp stop-one-bit
  bool p8x8ref0 = false;

  int rbit() { return eng.read_bit(); }
  int rbits(int n) { return n ? eng.read_bits(n) : 0; }
  int rue() {
    int zeros = 0;
    while (rbit() == 0) zeros++;
    return (1 << zeros) - 1 + rbits(zeros);
  }
  int rse() {
    int k = rue();
    return (k & 1) ? (k + 1) >> 1 : -(k >> 1);
  }
  int rte(int maxv) { return maxv == 1 ? 1 - rbit() : rue(); }
  bool more_data() { return eng.pos < stop_bit; }

  int vlc(const VlcTable& t) {
    int acc = 0;
    for (int n = 1; n <= 19; n++) {
      acc = (acc << 1) | rbit();
      for (int i = 0; i < t.n; i++)
        if (t.e[i].len == n && t.e[i].bits == acc) return t.e[i].val;
    }
    return 0;  // corrupt stream
  }

  void coeff_token(int nc, int* tc, int* t1) {
    if (nc >= 8) {
      int v = rbits(6);
      if (v == 3) { *tc = 0; *t1 = 0; }
      else { *tc = (v >> 2) + 1; *t1 = v & 3; }
      return;
    }
    const VlcTable* t;
    if (nc == -1) t = &kCtDcTabs[0];
    else if (nc == -2) t = &kCtDcTabs[1];
    else if (nc < 2) t = &kCtTabs[0];
    else if (nc < 4) t = &kCtTabs[1];
    else t = &kCtTabs[2];
    int v = vlc(*t);
    *tc = v >> 2;
    *t1 = v & 3;
  }

  bool navail(MB* m) {
    return m != &unavailable_intra && m != &unavailable_inter;
  }

  int nc_for(int cat, int idx) {
    if (cat == CAT_CHROMA_DC) return -pp->chroma_array_type;
    int comp = 0, blk = idx;
    MB *a, *b;
    int ia, ib;
    if (cat == CAT_LUMA_DC) blk = 0;
    if (cat == CAT_CHROMA_AC) {
      comp = (idx >> 3) + 1;
      blk = idx & 7;
      a = nb_blkc('A', blk, &ia);
      b = nb_blkc('B', blk, &ib);
    } else {
      a = nb_blk4('A', blk, &ia);
      b = nb_blk4('B', blk, &ib);
    }
    bool av_a = navail(a), av_b = navail(b);
    int na = av_a ? a->cbf[comp][ia] : 0;
    int nb_ = av_b ? b->cbf[comp][ib] : 0;
    if (av_a && av_b) return (na + nb_ + 1) >> 1;
    if (av_a) return na;
    if (av_b) return nb_;
    return 0;
  }

  void store_count(int cat, int idx, int count) {
    MB* c = cur();
    if (cat == CAT_LUMA_DC) return;
    if (cat == CAT_LUMA_AC || cat == CAT_LUMA_4X4)
      c->cbf[0][idx] = (uint8_t)count;
    else if (cat == CAT_CHROMA_AC)
      c->cbf[(idx >> 3) + 1][idx & 7] = (uint8_t)count;
  }

  const VlcTable& tz_table(int cat, int tc) {
    if (cat == CAT_CHROMA_DC)
      return pp->chroma_array_type == 1 ? kTzCTabs[tc - 1]
                                        : kTzQTabs[tc - 1];
    return kTzTabs[tc - 1];
  }

  // one 4x4-family CAVLC block -> raster coefficients via remap
  void block4(int cat, int idx, int32_t* coeffs, const int* remap,
              int out_size, int end, bool coded, int scan_mul = 1,
              int scan_off = 0, bool clear = true) {
    if (clear) std::memset(coeffs, 0, out_size * sizeof(int32_t));
    if (!coded) { store_count(cat, idx, 0); return; }
    int nc = nc_for(cat, idx);
    int tc, t1;
    coeff_token(nc, &tc, &t1);
    store_count(cat, idx, tc);
    if (tc == 0) return;
    int ncoeff = end + 1;
    int suffix_len = (tc > 10 && t1 < 3) ? 1 : 0;
    int levels[16];
    for (int i = 0; i < tc; i++) {
      if (i < t1) { levels[i] = 1 - 2 * rbit(); continue; }
      int prefix = 0;
      while (rbit() == 0) prefix++;
      int size = suffix_len;
      if (prefix == 14 && suffix_len == 0) size = 4;
      else if (prefix >= 15) size = prefix - 3;
      int code = (prefix < 15 ? prefix : 15) << suffix_len;
      code += rbits(size);
      if (prefix >= 15 && suffix_len == 0) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (i == t1 && t1 < 3) code += 2;
      int level = (code % 2 == 0) ? (code + 2) >> 1 : -((code + 1) >> 1);
      if (suffix_len == 0) suffix_len = 1;
      if (std::abs(level) > (3 << (suffix_len - 1)) && suffix_len < 6)
        suffix_len++;
      levels[i] = level;
    }
    int total_zeros = (tc < ncoeff) ? vlc(tz_table(cat, tc)) : 0;
    int zeros_left = total_zeros;
    int pos = tc + total_zeros - 1;
    for (int i = 0; i < tc; i++) {
      coeffs[remap[pos * scan_mul + scan_off]] = levels[i];
      if (i == tc - 1) break;
      int run = 0;
      if (zeros_left > 0)
        run = vlc(kRunTabs[(zeros_left < 7 ? zeros_left : 7) - 1]);
      zeros_left -= run;
      pos -= 1 + run;
    }
  }

  void residual_cavlc(MB* mb, int addr) {
    Out* o = out;
    int64_t a = addr;
    if (mb->kind == KIND_I16) {
      block4(CAT_LUMA_DC, 0, o->luma_dc + a * 16, kZig4, 16, 15, true);
      for (int i = 0; i < 16; i++)
        block4(CAT_LUMA_AC, i, o->luma4 + (a * 16 + i) * 16, kAc.ac4, 16,
               14, (mb->cbp >> (i >> 2)) & 1);
    } else if (mb->kind == KIND_I8 || mb->transform8) {
      // four interleaved 4x4 blocks: sub b -> 8x8 scan positions 4k+b
      for (int i = 0; i < 4; i++) {
        int32_t* dst = o->luma8 + (a * 4 + i) * 64;
        std::memset(dst, 0, 64 * sizeof(int32_t));
        for (int b = 0; b < 4; b++)
          block4(CAT_LUMA_4X4, i * 4 + b, dst, kZig8, 64, 15,
                 (mb->cbp >> i) & 1, 4, b, false);
      }
    } else {
      for (int i = 0; i < 16; i++)
        block4(CAT_LUMA_4X4, i, o->luma4 + (a * 16 + i) * 16, kZig4, 16,
               15, (mb->cbp >> (i >> 2)) & 1);
    }
    int catc = pp->chroma_array_type;
    if (catc == 1 || catc == 2) {
      int nc = 4 * catc;
      for (int c2 = 0; c2 < 2; c2++)
        block4(CAT_CHROMA_DC, c2, o->chroma_dc + (a * 2 + c2) * 8, kIdent8,
               8, nc - 1, (mb->cbp & 0x30) != 0);
      for (int c2 = 0; c2 < 2; c2++)
        for (int j = 0; j < nc; j++)
          block4(CAT_CHROMA_AC, c2 * 8 + j,
                 o->chroma_ac + ((a * 2 + c2) * 8 + j) * 16, kAc.ac4, 16,
                 14, (mb->cbp & 0x20) != 0);
    }
  }

  void mb_type_cavlc(MB* mb) {
    p8x8ref0 = false;
    int v = rue();
    int iv;
    if (slice_type == ST_I) {
      iv = v;
    } else if (slice_type == ST_P || slice_type == ST_SP) {
      if (v < 5) {
        if (v >= 3) {
          mb->kind = KIND_P8X8;
          mb->mb_type_code = 3;
          p8x8ref0 = v == 4;
        } else {
          mb->kind = KIND_P;
          mb->mb_type_code = (int8_t)v;
        }
        return;
      }
      iv = v - 5;
    } else if (slice_type == ST_SI) {
      if (v == 0) { mb->kind = KIND_SI; return; }
      iv = v - 1;
    } else {  // B
      if (v < 23) {
        mb->kind = v == 0 ? KIND_B_DIRECT : (v == 22 ? KIND_B8X8 : KIND_B);
        mb->mb_type_code = (int8_t)v;
        return;
      }
      iv = v - 23;
    }
    if (iv == 0) mb->kind = KIND_I4;
    else if (iv == 25) mb->kind = KIND_PCM;
    else {
      mb->kind = KIND_I16;
      int c1 = iv - 1;
      mb->i16_mode = (int8_t)(c1 % 4);
      mb->cbp = (int16_t)((((c1 / 4) % 3) << 4) | (c1 >= 12 ? 15 : 0));
    }
  }

  void intra_modes_cavlc(MB* mb, bool eight) {
    int n = eight ? 4 : 16;
    for (int blk = 0; blk < n; blk++) {
      int ma = eight ? nb_mode8('A', blk) : nb_mode4('A', blk);
      int mbv = eight ? nb_mode8('B', blk) : nb_mode4('B', blk);
      int pred = (ma < 0 || mbv < 0) ? 2 : (ma < mbv ? ma : mbv);
      int mode;
      if (rbit()) mode = pred;
      else {
        int rem = rbits(3);
        mode = rem < pred ? rem : rem + 1;
      }
      if (eight) mb->modes8[blk] = (int8_t)mode;
      else mb->modes4[blk] = (int8_t)mode;
    }
  }

  void mb_pred_inter_cavlc(MB* mb) {
    const PartInfo& pi = (slice_type == ST_B) ? kBParts[mb->mb_type_code]
                                              : kPParts[mb->mb_type_code];
    for (int which = 0; which < 2; which++) {
      int nref = which ? nref_l1 : nref_l0;
      for (int p = 0; p < pi.n; p++) {
        int pred = pi.pred[p];
        bool uses = which == 0 ? (pred == PRED_L0 || pred == PRED_BI)
                               : (pred == PRED_L1 || pred == PRED_BI);
        if (!uses) continue;
        int v = (nref == 0 || p8x8ref0) ? 0 : rte(nref);
        if (pi.wh == 0) {
          for (int q = 0; q < 4; q++) mb->ref_idx[which][q] = (int8_t)v;
        } else if (pi.wh == 1) {
          mb->ref_idx[which][p * 2] = (int8_t)v;
          mb->ref_idx[which][p * 2 + 1] = (int8_t)v;
        } else {
          mb->ref_idx[which][p] = (int8_t)v;
          mb->ref_idx[which][p + 2] = (int8_t)v;
        }
      }
    }
    for (int which = 0; which < 2; which++) {
      for (int p = 0; p < pi.n; p++) {
        int pred = pi.pred[p];
        bool uses = which == 0 ? (pred == PRED_L0 || pred == PRED_BI)
                               : (pred == PRED_L1 || pred == PRED_BI);
        if (!uses) continue;
        static const int all16[16] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                      10, 11, 12, 13, 14, 15};
        const int* blks;
        int nblk;
        if (pi.wh == 0) { blks = all16; nblk = 16; }
        else if (pi.wh == 1) { blks = kPart16x8[p]; nblk = 8; }
        else { blks = kPart8x16[p]; nblk = 8; }
        for (int comp = 0; comp < 2; comp++) {
          int v = rse();
          for (int b = 0; b < nblk; b++)
            mb->mvd[which][blks[b]][comp] = (int16_t)v;
        }
      }
    }
  }

  void sub_mb_pred_cavlc(MB* mb) {
    bool is_b = slice_type == ST_B;
    for (int which = 0; which < 2; which++) {
      int nref = which ? nref_l1 : nref_l0;
      for (int q = 0; q < 4; q++) {
        const SubInfo& si = is_b ? kBSub[mb->sub_mb_type[q]]
                                 : kPSub[mb->sub_mb_type[q]];
        bool uses = which == 0 ? (si.pred == PRED_L0 || si.pred == PRED_BI)
                               : (si.pred == PRED_L1 || si.pred == PRED_BI);
        if (!uses) continue;
        int v = (nref == 0 || p8x8ref0) ? 0 : rte(nref);
        mb->ref_idx[which][q] = (int8_t)v;
      }
    }
    for (int which = 0; which < 2; which++) {
      for (int q = 0; q < 4; q++) {
        const SubInfo& si = is_b ? kBSub[mb->sub_mb_type[q]]
                                 : kPSub[mb->sub_mb_type[q]];
        bool uses = which == 0 ? (si.pred == PRED_L0 || si.pred == PRED_BI)
                               : (si.pred == PRED_L1 || si.pred == PRED_BI);
        if (!uses) continue;
        for (int part = 0; part < si.n; part++) {
          int subs[4];
          int nsub;
          if (si.shape == 0) { subs[0] = 0; subs[1] = 1; subs[2] = 2;
            subs[3] = 3; nsub = 4; }
          else if (si.shape == 1) { subs[0] = kSub8x4[part][0];
            subs[1] = kSub8x4[part][1]; nsub = 2; }
          else if (si.shape == 2) { subs[0] = kSub4x8[part][0];
            subs[1] = kSub4x8[part][1]; nsub = 2; }
          else { subs[0] = part; nsub = 1; }
          for (int comp = 0; comp < 2; comp++) {
            int v = rse();
            for (int k = 0; k < nsub; k++)
              mb->mvd[which][4 * q + subs[k]][comp] = (int16_t)v;
          }
        }
      }
    }
  }

  void layer_cavlc(int addr) {
    MB* mb = cur();
    *mb = MB();
    for (int i = 0; i < 16; i++) mb->modes4[i] = 2;
    for (int i = 0; i < 4; i++) mb->modes8[i] = 2;
    mb_type_cavlc(mb);
    if (mb->kind == KIND_PCM) {
      pcm_cavlc(mb, addr);
      mb->qp_y = (int16_t)qpy_prev;
      return;
    }
    bool intra = mb->kind == KIND_I4 || mb->kind == KIND_I8 ||
                 mb->kind == KIND_I16 || mb->kind == KIND_SI;
    bool no_small = true;
    if (mb->kind == KIND_P8X8 || mb->kind == KIND_B8X8) {
      bool is_b = slice_type == ST_B;
      for (int i = 0; i < 4; i++) mb->sub_mb_type[i] = (int8_t)rue();
      for (int q = 0; q < 4; q++) {
        const SubInfo& si = is_b ? kBSub[mb->sub_mb_type[q]]
                                 : kPSub[mb->sub_mb_type[q]];
        if (is_b && mb->sub_mb_type[q] == 0) {
          if (!pp->direct_8x8_inference_flag) no_small = false;
        } else if (si.shape != 0) {
          no_small = false;
        }
      }
      sub_mb_pred_cavlc(mb);
      mb->chroma_mode = 0;
    } else {
      if (mb->kind == KIND_I4 && pp->transform_8x8_mode_flag) {
        mb->transform8 = (int8_t)rbit();
        if (mb->transform8) mb->kind = KIND_I8;
      }
      if (mb->kind == KIND_I4 || mb->kind == KIND_I8 ||
          mb->kind == KIND_SI)
        intra_modes_cavlc(mb, mb->kind == KIND_I8);
      if (intra && (pp->chroma_array_type == 1 ||
                    pp->chroma_array_type == 2))
        mb->chroma_mode = (int8_t)rue();
      if (mb->kind == KIND_P || mb->kind == KIND_B)
        mb_pred_inter_cavlc(mb);
    }
    if (mb->kind != KIND_I16) {
      bool gray = !(pp->chroma_array_type == 1 ||
                    pp->chroma_array_type == 2);
      bool intra_nxn = mb->kind == KIND_I4 || mb->kind == KIND_I8 ||
                       mb->kind == KIND_SI;
      int g = rue();
      const uint8_t* map =
          intra_nxn ? (gray ? k_golomb_to_intra_cbp_gray
                            : k_golomb_to_intra_cbp)
                    : (gray ? k_golomb_to_inter_cbp_gray
                            : k_golomb_to_inter_cbp);
      mb->cbp = (int16_t)map[g];
      if (!intra && (mb->cbp & 0x0F) && pp->transform_8x8_mode_flag &&
          no_small &&
          (mb->kind != KIND_B_DIRECT || pp->direct_8x8_inference_flag))
        mb->transform8 = (int8_t)rbit();
    }
    if (mb->cbp != 0 || mb->kind == KIND_I16) mb->qp_delta = (int16_t)rse();
    else mb->qp_delta = 0;
    residual_cavlc(mb, addr);
    int off = 6 * (pp->bit_depth_luma - 8);
    mb->qp_y = ((qpy_prev + mb->qp_delta + 52 + 2 * off) % (52 + off)) - off;
    qpy_prev = mb->qp_y;
    // resolved 8x8 modes propagate to 4x4 slots for neighbor prediction
    if (mb->kind == KIND_I8)
      for (int i = 0; i < 16; i++) mb->modes4[i] = mb->modes8[i >> 2];
  }

  void pcm_cavlc(MB* mb, int addr) {
    eng.byte_align();
    int bd_l = pp->bit_depth_luma, bd_c = pp->bit_depth_chroma;
    for (int i = 0; i < 256; i++)
      out->pcm_y[(int64_t)addr * 256 + i] = rbits(bd_l);
    if (pp->chroma_array_type) {
      int n = 64 << pp->chroma_array_type;
      for (int i = 0; i < n; i++)
        out->pcm_c[(int64_t)addr * 128 + i] = rbits(bd_c);
    }
    mb->qp_delta = 0;
    mb->transform8 = 0;
    mb->cbp = 0x2F;
    mb->chroma_mode = 0;
    std::memset(mb->cbf, 16, sizeof(mb->cbf));  // nC of I_PCM is 16
    for (int i = 0; i < 16; i++) mb->modes4[i] = 2;
    for (int i = 0; i < 4; i++) mb->modes8[i] = 2;
  }
};

void decode_one_slice_cavlc(const uint8_t* rbsp, const SliceParams& sp,
                            int last_mb, int slice_id, const PicParams* pp,
                            Out* o, std::vector<MB>* mbs, int slice_index) {
  CavlcCtx s;
  s.pp = pp;
  s.out = o;
  s.mbs = mbs;
  s.slice_id = slice_id;
  s.curr = sp.first_mb;
  s.qpy_prev = sp.slice_qp;
  s.slice_type = sp.slice_type;
  s.nref_l0 = sp.nref_l0;
  s.nref_l1 = sp.nref_l1;
  s.eng.data = rbsp;
  s.eng.pos = sp.bit_off;
  s.eng.bit_len = sp.rbsp_len * 8;
  // stop bit: the lowest set bit of the last nonzero byte
  int64_t k = sp.rbsp_len - 1;
  while (k >= 0 && rbsp[k] == 0) k--;
  s.stop_bit = 0;
  if (k >= 0) {
    int b = rbsp[k], t = 0;
    while (!((b >> t) & 1)) t++;
    s.stop_bit = k * 8 + (7 - t);
  }
  bool is_intra = sp.slice_type == ST_I || sp.slice_type == ST_SI;
  int n = pp->mb_w * pp->mb_h;
  while (true) {
    if (!is_intra) {
      int run = s.rue();  // mb_skip_run
      for (int i = 0; i < run && s.curr < n; i++) {
        MB* mb = s.cur();
        *mb = MB();
        for (int j = 0; j < 16; j++) mb->modes4[j] = 2;
        for (int j = 0; j < 4; j++) mb->modes8[j] = 2;
        mb->kind = (sp.slice_type == ST_B) ? KIND_B_SKIP : KIND_P_SKIP;
        mb->qp_y = (int16_t)s.qpy_prev;
        publish_mb(s, o);
        s.prev_addr = s.curr;
        s.curr++;
      }
      if (run > 0 && !s.more_data()) break;
    }
    if (s.curr >= n || (last_mb >= 0 && s.curr > last_mb)) break;
    s.layer_cavlc(s.curr);
    publish_mb(s, o);
    s.prev_addr = s.curr;
    s.curr++;
    if (!s.more_data()) break;
    if (s.curr >= n || (last_mb >= 0 && s.curr > last_mb)) break;
  }
  if (o->bin_count) o->bin_count[slice_index] = 0;
}

}  // namespace

extern "C" {

// ABI guard for out-of-tree users of the raw entry points (prof_main.cc):
// layout drift in the parameter structs is caught at startup instead of
// silently corrupting the harness.
int dt_abi_sizes(int32_t* sp, int32_t* pp, int32_t* out) {
  *sp = (int32_t)sizeof(SliceParams);
  *pp = (int32_t)sizeof(PicParams);
  *out = (int32_t)sizeof(Out);
  return 1;
}

// Decode all slices of one picture (I/SI/P/B CABAC syntax).
// rbsp_all: concatenated EPB-stripped slice rbsps; sp: per-slice params.
// Returns 0 on success.
int dt_decode_picture_slices(
    const uint8_t* rbsp_all, const SliceParams* sp, int32_t n_slices,
    PicParams pp, Out o, int32_t n_threads) {
  int n = pp.mb_w * pp.mb_h;
  std::vector<MB> mbs(n);
  // prefill slice ids: slice k covers [first_mb[k], first_mb[k+1])
  for (int k = 0; k < n_slices; k++) {
    int lo = sp[k].first_mb;
    int hi = (k + 1 < n_slices) ? sp[k + 1].first_mb : n;
    for (int a = lo; a < hi; a++) o.slice_id[a] = k;
  }
  std::function<void(int)> work = [&](int k) {
    int last = (k + 1 < n_slices) ? sp[k + 1].first_mb - 1 : n - 1;
    decode_one_slice(rbsp_all + sp[k].rbsp_off, sp[k], last, k, &pp, &o,
                     &mbs, k);
  };
  if (n_threads <= 1 || n_slices == 1) {
    for (int k = 0; k < n_slices; k++) work(k);
  } else {
    SlicePool::inst().run_parallel(n_slices, work);
  }
  return 0;
}

// FMO variant: `sgmap` [n] gives each MB's slice group; slice k covers
// slice group k (one slice per group), walking the group's MBs in
// raster order among themselves (map types 0-6 all reduce to this walk,
// spec 8.2.2.8).  Slices still decode in parallel — FMO groups write
// disjoint MB sets.  The reference initializes all seven map types
// (the reference's src/video/avcc/pps.rs:145-300) but its decode loop
// never walks them.
int dt_decode_picture_slices_fmo(
    const uint8_t* rbsp_all, const SliceParams* sp, int32_t n_slices,
    PicParams pp, Out o, int32_t n_threads, const int32_t* sgmap) {
  int n = pp.mb_w * pp.mb_h;
  std::vector<MB> mbs(n);
  std::vector<int32_t> mb_next(n, -1);
  // slice k covers the group of its first MB (slices arrive in NAL
  // order, which need not match group numbering — e.g. a foreground box
  // group whose first MB is not MB 0)
  int max_g = 0;
  for (int a = 0; a < n; a++) max_g = sgmap[a] > max_g ? sgmap[a] : max_g;
  std::vector<int32_t> slice_of_grp(max_g + 1, -1);
  for (int k = 0; k < n_slices; k++)
    slice_of_grp[sgmap[sp[k].first_mb]] = k;
  std::vector<int32_t> prev(max_g + 1, -1);
  for (int a = 0; a < n; a++) {
    int g = sgmap[a];
    o.slice_id[a] = slice_of_grp[g];
    if (prev[g] >= 0) mb_next[prev[g]] = a;
    prev[g] = a;
  }
  std::function<void(int)> work = [&](int k) {
    decode_one_slice(rbsp_all + sp[k].rbsp_off, sp[k], -1, k, &pp, &o,
                     &mbs, k, nullptr, mb_next.data());
  };
  if (n_threads <= 1 || n_slices == 1) {
    for (int k = 0; k < n_slices; k++) work(k);
  } else {
    SlicePool::inst().run_parallel(n_slices, work);
  }
  return 0;
}

// Decode all slices of one picture with CAVLC entropy coding
// (entropy_coding_mode_flag == 0); same contract as the CABAC entry.
int dt_decode_picture_slices_cavlc(
    const uint8_t* rbsp_all, const SliceParams* sp, int32_t n_slices,
    PicParams pp, Out o, int32_t n_threads) {
  int n = pp.mb_w * pp.mb_h;
  std::vector<MB> mbs(n);
  for (int k = 0; k < n_slices; k++) {
    int lo = sp[k].first_mb;
    int hi = (k + 1 < n_slices) ? sp[k + 1].first_mb : n;
    for (int a = lo; a < hi; a++) o.slice_id[a] = k;
  }
  std::function<void(int)> work = [&](int k) {
    int last = (k + 1 < n_slices) ? sp[k + 1].first_mb - 1 : n - 1;
    decode_one_slice_cavlc(rbsp_all + sp[k].rbsp_off, sp[k], last, k, &pp,
                           &o, &mbs, k);
  };
  if (n_threads <= 1 || n_slices == 1) {
    for (int k = 0; k < n_slices; k++) work(k);
  } else {
    SlicePool::inst().run_parallel(n_slices, work);
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Device bitmap-ABI pack: one picture's dense entropy outputs -> the compact
// host->device buffers consumed by the Pallas densify kernel
// (dryv_tpu/kernels/densify.py).  Replaces the per-frame numpy
// memset+packbits+flatnonzero rescan that dominated the round-3 pipeline
// (VERDICT r3 item 1).  Layout of the 408-coeff row per MB:
//   [0:256)  luma levels (luma8 rows for 8x8-transform MBs, else luma4)
//   [256:272) luma DC    [272:280) chroma DC (first 4 of each channel)
//   [280:408) chroma AC  (first 4 blocks of each channel, 16 coeffs each)
// Per MB the nonzero values are emitted in flat-row order into vals[a*W..],
// clipped to +/-127; |v|>127 spills an (index, delta) exception pair.
// Returns the max nonzero count per MB (caller re-packs with a larger W
// if it exceeds W), or -1 if the picture contains PCM macroblocks.
// ---------------------------------------------------------------------------
namespace {

// Standalone pack pass over the dense arena (used by the growth-repack
// and PCM-fallback paths; the hot fused path packs inside
// decode_one_slice instead): assemble each MB's 408-lane view from the
// scattered arrays and emit via the shared pack_mb_lanes.
void pack_mb_range(PackJob& pj, int lo, int hi) {
  const int kNkI8 = 1, kNkPcm = 3, kNkPSkip = 6, kNkBSkip = 9;
  int local_max = 0;
  int32_t L[408];
  const int32_t Lz[408] = {};
  for (int a = lo; a < hi; a++) {
    int k = pj.kind[a];
    if (k == kNkPcm) { pj.has_pcm.store(1); return; }
    if (k == kNkPSkip || k == kNkBSkip) {
      // skip MBs carry no residual; their arena coefficient slots are
      // stale under buffer reuse — emit an empty row
      pack_mb_lanes(pj, a, Lz, local_max);
      continue;
    }
    bool use8 = (k == kNkI8) || (pj.transform8 && pj.transform8[a]);
    const int32_t* lv = use8 ? pj.luma8 + (int64_t)a * 256
                             : pj.luma4 + (int64_t)a * 256;
    std::memcpy(L, lv, 256 * sizeof(int32_t));
    std::memcpy(L + 256, pj.luma_dc + (int64_t)a * 16, 16 * sizeof(int32_t));
    std::memcpy(L + 272, pj.chroma_dc + (int64_t)a * 2 * 8,
                4 * sizeof(int32_t));
    std::memcpy(L + 276, pj.chroma_dc + ((int64_t)a * 2 + 1) * 8,
                4 * sizeof(int32_t));
    for (int c2 = 0; c2 < 2; c2++)
      std::memcpy(L + 280 + c2 * 64,
                  pj.chroma_ac + ((int64_t)a * 2 + c2) * 8 * 16,
                  64 * sizeof(int32_t));
    pack_mb_lanes(pj, a, L, local_max);
  }
  int prev = pj.maxnz.load(std::memory_order_relaxed);
  while (local_max > prev &&
         !pj.maxnz.compare_exchange_weak(prev, local_max)) {}
}

}  // namespace

extern "C" int dt_pack_frame(
    const int32_t* kind, const int32_t* qp_y, const int32_t* i16_mode,
    const int32_t* chroma_mode, const int32_t* modes4, const int32_t* modes8,
    const int32_t* slice_id, const int32_t* luma4, const int32_t* luma8,
    const int32_t* luma_dc, const int32_t* chroma_dc,
    const int32_t* chroma_ac, const int32_t* transform8 /* nullable */,
    int32_t n, int32_t W,
    const int32_t* dbctl /* [n_slices*3] disable_idc, offa, offb */,
    uint8_t* bmp /* [n*51] */, int8_t* vals /* [n*W] */,
    int32_t* cnt /* [n] */, uint8_t* u8meta /* [n*kMetaStride] */,
    int32_t* exc_idx /* [ecap] */, int16_t* exc_delta, int32_t ecap,
    int32_t* ovf_idx /* [ovcap] */, int16_t* ovf_rows /* [ovcap*408] */,
    int32_t ovcap, int32_t* n_exc_out, int32_t* n_ovf_out,
    int32_t n_threads) {
  PackJob pj{kind, qp_y, i16_mode, chroma_mode, modes4, modes8,
             slice_id, luma4, luma8, luma_dc, chroma_dc, chroma_ac,
             transform8,
             W, dbctl, bmp, vals, cnt, u8meta, exc_idx, exc_delta, ecap,
             ovf_idx, ovf_rows, ovcap};
  int nt = n_threads > 0 ? n_threads : 2;
  if (nt <= 1) {
    pack_mb_range(pj, 0, n);
  } else {
    int chunks = nt * 4;
    int step = (n + chunks - 1) / chunks;
    std::function<void(int)> work = [&](int i) {
      int lo = i * step;
      int hi = lo + step < n ? lo + step : n;
      if (lo < hi) pack_mb_range(pj, lo, hi);
    };
    SlicePool::inst().run_parallel(chunks, work);
  }
  *n_exc_out = pj.nexc.load();
  *n_ovf_out = pj.novf.load();
  if (pj.has_pcm.load()) return -1;
  return pj.maxnz.load();
}

// Fused decode+pack: for 4:2:0 each slice worker emits the device ABI
// rows per MB straight from an L1-resident lane buffer while decoding
// (the dense coefficient arena is never written — skipping ~27 MB of
// stores + memsets + a cold re-read per 1080p frame); other chroma
// formats decode into the arena and pack per slice range.  Same packed
// outputs as dt_decode_picture_slices followed by dt_pack_frame (but
// the arena coefficient arrays are NOT filled on the 4:2:0 path — a
// caps-growth retry must re-decode); pack results return via
// pack_out[4] = {maxnz|-1, n_exc, has_pcm, n_ovf}.
extern "C" int dt_decode_pack_picture_slices(
    const uint8_t* rbsp_all, const SliceParams* sp, int32_t n_slices,
    PicParams pp, Out o, int32_t n_threads, int32_t W,
    const int32_t* dbctl, uint8_t* bmp, int8_t* vals, int32_t* cnt,
    uint8_t* u8meta, int32_t* exc_idx, int16_t* exc_delta, int32_t ecap,
    int32_t* ovf_idx, int16_t* ovf_rows, int32_t ovcap,
    int32_t* pack_out /* [4]: maxnz|-1, n_exc, has_pcm, n_ovf */) {
  int n = pp.mb_w * pp.mb_h;
  std::vector<MB> mbs(n);
  for (int k = 0; k < n_slices; k++) {
    int lo = sp[k].first_mb;
    int hi = (k + 1 < n_slices) ? sp[k + 1].first_mb : n;
    for (int a = lo; a < hi; a++) o.slice_id[a] = k;
  }
  PackJob pj{o.kind, o.qp_y, o.i16_mode, o.chroma_mode, o.modes4,
             o.modes8, o.slice_id, o.luma4, o.luma8, o.luma_dc,
             o.chroma_dc, o.chroma_ac, nullptr, W, dbctl, bmp, vals, cnt,
             u8meta, exc_idx, exc_delta, ecap, ovf_idx, ovf_rows, ovcap};
  // direct-pack only covers the 4:2:0 lane layout; other chroma formats
  // decode into the arena and pack with the standalone pass
  bool direct = pp.chroma_array_type == 1;
  std::function<void(int)> work = [&](int k) {
    int lo = sp[k].first_mb;
    int hi = (k + 1 < n_slices) ? sp[k + 1].first_mb : n;
    decode_one_slice(rbsp_all + sp[k].rbsp_off, sp[k], hi - 1, k, &pp, &o,
                     &mbs, k, direct ? &pj : nullptr);
    if (!direct) pack_mb_range(pj, lo, hi);
  };
  if (n_threads <= 1 || n_slices == 1) {
    for (int k = 0; k < n_slices; k++) work(k);
  } else {
    SlicePool::inst().run_parallel(n_slices, work);
  }
  pack_out[0] = pj.has_pcm.load() ? -1 : pj.maxnz.load();
  pack_out[1] = pj.nexc.load();
  pack_out[2] = pj.has_pcm.load();
  pack_out[3] = pj.novf.load();
  return 0;
}
