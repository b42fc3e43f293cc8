// Shared helpers of the hand-written kernels (plain C interface, loaded
// with ctypes by dryv_tpu_torch/_build.py).
//
// The Hopper primitives sit behind small functions here: the TMA bulk
// copy into shared memory and the bulk store out of it, the mbarrier
// that a bulk copy completes, the proxy fence between them, a named
// barrier, the kernel's dynamic shared memory and the card's SM count.
// tests/cuda_emu/cuda_runtime.h defines DT_CUDA_EMU and a stand-in of
// each (a memcpy, a barrier, a fixed SM count), so that the kernels'
// own logic runs on the CPU under g++.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define DT_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

#ifndef DT_CUDA_EMU

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the block's dynamic shared memory (the launch's third argument)
__device__ __forceinline__ uint8_t* dyn_smem() {
  extern __shared__ __align__(128) uint8_t dt_dyn_smem[];
  return dt_dyn_smem;
}

// an mbarrier expecting `count` arrivals a phase; one thread inits it,
// then the block synchronises before any other thread uses it
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also makes the current phase wait for `bytes` more
// of bulk copies (made before the copies are issued)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state)
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// one arrival (release: the thread's earlier writes are seen by every
// thread that waits the phase out)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
               : "=l"(state)
               : "r"(smem_addr(bar))
               : "memory");
}

// waits until the phase of parity `parity` has completed; a wait of
// seconds can only be a broken protocol: it traps, so the launch fails
// with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  long long tries = 0;
  do {
    if (++tries == (1LL << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// generic-proxy writes to shared memory made visible to the bulk store
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// TMA bulk store of `bytes` (a multiple of 16, 16-byte aligned) from
// shared memory to device memory, in the thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// closes the thread's bulk group
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// the thread's bulk stores have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// a barrier of `count` threads (whole warps) of the block, on hardware
// barrier `id` (0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// the current device's SM count, read once per device
inline int sm_count() {
  static int counts[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 1;
  }
  return counts[dev];
}

// lets `kernel` take `bytes` of dynamic shared memory on the current
// device (above 48 KB only after this), once per device: done[device]
// are the caller's flags for this kernel; 0 or the error
inline int allow_dynamic_smem(const void* kernel, int bytes, bool* done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (done[dev]) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done[dev] = rc == 0;
  return rc;
}

#endif  // DT_CUDA_EMU
