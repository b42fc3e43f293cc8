// A CPU stand-in for the CUDA runtime, enough to run the port's kernels
// under g++ in tests (tests/test_torch_inter_emulated.py,
// tests/test_torch_stage_a_emulated.py).  A launch runs
// its grid one block at a time, a thread of the block per std::thread;
// __syncthreads is a barrier of the block, a named barrier one of its
// count, and each warp's collectives (__syncwarp, __ballot_sync,
// __any_sync, __all_sync, __shfl_sync, __shfl_xor_sync) meet at a
// barrier of the lanes in their mask.  __shared__ becomes static: one
// block's shared memory at a time; the dynamic shared memory is one
// buffer of the launch's size.  The Hopper helpers of csrc/common.cuh
// (compiled out by DT_CUDA_EMU) have stand-ins here: an mbarrier is a
// phase counter under a mutex, a TMA bulk copy or store a memcpy at
// issue, the SM count DT_EMU_SMS.
#pragma once
#define DT_CUDA_EMU 1
#include <barrier>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#ifndef DT_EMU_SMS
#define DT_EMU_SMS 4
#endif

using std::abs;
using std::max;
using std::min;

struct dim3 {
  int x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
constexpr int cudaErrorInvalidValue = 1;

struct uint2 {
  uint32_t x, y;
};
struct uint4 {
  uint32_t x, y, z, w;
};
inline uint2 make_uint2(uint32_t a, uint32_t b) { return uint2{a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return uint4{a, b, c, d};
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t sh) {
  sh &= 31;
  return sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
}
inline uint32_t __vavgu4(uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= ((((a >> 8 * i) & 255) + ((b >> 8 * i) & 255) + 1) >> 1) << 8 * i;
  return r;
}

struct EmuWarp {
  std::barrier<> bar{32};
  uint64_t slot[32];
  std::mutex mu;
  std::map<unsigned, std::unique_ptr<std::barrier<>>> sub;
  // the barrier of the lanes in `mask`
  std::barrier<>& of(unsigned mask) {
    if (mask == 0xffffffffu) return bar;
    std::lock_guard<std::mutex> g(mu);
    auto& b = sub[mask];
    if (!b) b.reset(new std::barrier<>(__builtin_popcount(mask)));
    return *b;
  }
};
inline thread_local EmuWarp* emu_warp;
inline std::barrier<>* emu_block;

inline void __syncthreads() { emu_block->arrive_and_wait(); }
inline void __syncwarp(unsigned m = 0xffffffffu) {
  emu_warp->of(m).arrive_and_wait();
}
// every lane of `m` posts a value, then each reads them
template <class F>
inline auto emu_exchange(unsigned m, uint64_t mine, F&& read) {
  emu_warp->slot[threadIdx.x & 31] = mine;
  emu_warp->of(m).arrive_and_wait();
  auto r = read(emu_warp->slot);
  emu_warp->of(m).arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned m, int p) {
  return emu_exchange(m, p != 0, [m](const uint64_t* s) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i)
      if (m >> i & 1) r |= (unsigned)(s[i] != 0) << i;
    return r;
  });
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __all_sync(unsigned m, int p) {
  return __ballot_sync(m, !p) == 0;
}
inline int __shfl_sync(unsigned m, int v, int src) {
  return emu_exchange(m, (uint32_t)v, [src](const uint64_t* s) {
    return (int)(uint32_t)s[src & 31];
  });
}
inline int __shfl_xor_sync(unsigned m, int v, int x) {
  return __shfl_sync(m, v, (threadIdx.x & 31) ^ x);
}

// named barriers of the running launch, by id
inline std::mutex emu_named_mu;
inline std::map<int, std::unique_ptr<std::barrier<>>> emu_named;
inline void named_sync(int id, int count) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> g(emu_named_mu);
    auto& p = emu_named[id];
    if (!p) p.reset(new std::barrier<>(count));
    b = p.get();
  }
  b->arrive_and_wait();
}

// the launch's dynamic shared memory
inline std::vector<uint64_t> emu_dyn;
inline uint8_t* dyn_smem() { return (uint8_t*)emu_dyn.data(); }

// mbarriers of the running launch, by address: arrivals still due and
// bytes of copies still due in the current phase
struct EmuMbar {
  std::mutex mu;
  std::condition_variable cv;
  int count = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;  // completed phases
  void settle() {      // under mu
    if (pending == 0 && tx == 0) {
      ++phase;
      pending = count;
      cv.notify_all();
    }
  }
};
inline std::mutex emu_mbar_mu;
inline std::map<const void*, std::unique_ptr<EmuMbar>> emu_mbars;
inline EmuMbar& emu_mbar(const void* a) {
  std::lock_guard<std::mutex> g(emu_mbar_mu);
  auto& p = emu_mbars[a];
  if (!p) p.reset(new EmuMbar);
  return *p;
}
inline void mbar_init(uint64_t* bar, unsigned count) {
  EmuMbar& b = emu_mbar(bar);
  std::lock_guard<std::mutex> g(b.mu);
  b.count = b.pending = (int)count;
  b.tx = 0;
  b.phase = 0;
}
inline void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  EmuMbar& b = emu_mbar(bar);
  std::lock_guard<std::mutex> g(b.mu);
  b.tx += bytes;
  --b.pending;
  b.settle();
}
inline void mbar_arrive(uint64_t* bar) { mbar_arrive_expect_tx(bar, 0); }
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  EmuMbar& b = emu_mbar(bar);
  std::unique_lock<std::mutex> g(b.mu);
  b.cv.wait(g, [&] { return (b.phase & 1) != parity; });
}
inline void bulk_load(void* dst, const void* src, unsigned bytes,
                      uint64_t* bar) {
  if ((uintptr_t)dst % 16 || (uintptr_t)src % 16 || bytes % 16) std::abort();
  std::memcpy(dst, src, bytes);
  EmuMbar& b = emu_mbar(bar);
  std::lock_guard<std::mutex> g(b.mu);
  b.tx -= bytes;
  b.settle();
}
inline void fence_async_smem() {}
inline void bulk_store(void* dst, const void* src, unsigned bytes) {
  if ((uintptr_t)dst % 16 || (uintptr_t)src % 16 || bytes % 16) std::abort();
  std::memcpy(dst, src, bytes);
}
inline void bulk_commit() {}
inline void bulk_wait_read() {}
inline void bulk_wait() {}
inline int sm_count() { return DT_EMU_SMS; }
inline int allow_dynamic_smem(const void*, int, bool*) { return 0; }

// kernel<<<grid, block, smem, stream>>>(args...), rewritten by the test
// as emu_launch(kernel, grid, block, smem, stream, args...)
template <class F, class... A>
void emu_launch(F kernel, int grid, int block, int smem, cudaStream_t,
                A... args) {
  std::barrier<> blk(block);
  emu_block = &blk;
  emu_named.clear();
  emu_mbars.clear();
  emu_dyn.assign((smem + 7) / 8, 0);
  gridDim.x = grid;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  for (int w = 0; w < (block + 31) / 32; ++w)
    warps.emplace_back(new EmuWarp);
  std::vector<std::thread> threads;
  for (int t = 0; t < block; ++t)
    threads.emplace_back([&, t] {
      emu_warp = warps[t / 32].get();
      threadIdx.x = t;
      for (int b = 0; b < grid; ++b) {
        blockIdx.x = b;
        kernel(args...);
        blk.arrive_and_wait();
      }
    });
  for (auto& th : threads) th.join();
}

// byte i of the result: byte (s >> 4 i) & 7 of {y, x} (x bytes 0-3)
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (uint32_t)(v >> (8 * ((s >> (4 * i)) & 7)) & 255) << (8 * i);
  return r;
}
