// A CPU stand-in for the CUDA runtime, enough to run the port's kernels
// under g++ in tests (tests/test_torch_inter_emulated.py).  A launch runs
// its grid one block at a time, a thread of the block per std::thread;
// __syncthreads is a barrier of the block, and each warp's collectives
// (__syncwarp, __ballot_sync, __any_sync, __all_sync) meet at a barrier
// of its 32 threads.  __shared__ becomes static: one block's shared
// memory at a time.
#pragma once
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

struct dim3 {
  int x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx, blockIdx;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }

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
};
inline thread_local EmuWarp* emu_warp;
inline std::barrier<>* emu_block;

inline void __syncthreads() { emu_block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp->bar.arrive_and_wait();
}
// every lane posts a value, then each reads all 32
template <class F>
inline auto emu_exchange(uint64_t mine, F&& read) {
  emu_warp->slot[threadIdx.x & 31] = mine;
  emu_warp->bar.arrive_and_wait();
  auto r = read(emu_warp->slot);
  emu_warp->bar.arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, int p) {
  return emu_exchange(p != 0, [](const uint64_t* s) {
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= (unsigned)(s[i] != 0) << i;
    return m;
  });
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __all_sync(unsigned m, int p) {
  return __ballot_sync(m, !p) == 0;
}

// kernel<<<grid, block, smem, stream>>>(args...), rewritten by the test
// as emu_launch(kernel, grid, block, smem, stream, args...)
template <class F, class... A>
void emu_launch(F kernel, int grid, int block, int, cudaStream_t,
                A... args) {
  std::barrier<> blk(block);
  emu_block = &blk;
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
