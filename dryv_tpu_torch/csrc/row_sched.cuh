// Persistent MB-row walkers ordered by progress flags in device memory.
//
// A wavefront over MB rows (each MB needs the row above finished up to
// its above-right neighbour) runs as ONE launch: every block takes
// (frame, MB row) tasks from an atomic ticket counter and walks its row
// left to right; before an MB reads the row above, one thread waits for
// that row's progress flag (MBs finished), and after the MB's samples are
// written the row's own flag is raised.
//
// Tickets are claimed in order, and a task only ever waits on a task with
// an earlier ticket (the row above, in the same frame), whose block is
// therefore already resident: no grid size or launch order can deadlock.
// The grid is what fits on the card at once (occupancy x SMs), at most
// one block per task.
//
// Scratch (int32, zeroed by the caller before the launch, allocated by
// the wrapper): sched[0] is the ticket counter, then one flag per task
// row (B2: row y of frame f at sched[1 + f * rows + y]; B3 keeps one such
// array for luma and one for chroma).  The Python mirror of the ticket
// orders and the wait rule is dryv_tpu_torch/kernels/wavefront.py
// (row_tickets, apron_wait) and kernels/deblock.py (deblock_tickets); the
// CPU tests simulate them.
//
// Memory order: the flag store is a release at GPU scope, after a block
// (or warp) barrier that orders every thread's sample writes before it
// (B2 adds a __threadfence; B3 relies on the release being cumulative);
// the wait is an acquire load.  L1 is not coherent
// across SMs, so a block reads samples that another block wrote in this
// launch with __ldcg (L2), never with cached loads.
#pragma once

#include "common.cuh"

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Spin (one thread) until *flag >= need, with a short capped backoff: the
// row above is usually one MB from the value waited for.  Returns the
// value seen, which the caller keeps to skip later waits it already meets.
// A wait of seconds can only be a broken schedule: it traps, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ int wait_flag(const int* flag, int need) {
  int v = ld_acquire_gpu(flag);
  unsigned ns = 32;
  for (long long spins = 0; v < need; ++spins) {
    if (spins == (1LL << 24)) __trap();
    __nanosleep(ns);
    if (ns < 256) ns <<= 1;
    v = ld_acquire_gpu(flag);
  }
  return v;
}

// Publish that `done` MBs of a row are finished: every thread of the
// block must have written its samples (the caller's __syncthreads).
__device__ __forceinline__ void raise_flag(int* flag, int done) {
  __threadfence();
  st_release_gpu(flag, done);
}

// The block's next ticket (thread 0 draws, all threads get it).
__device__ __forceinline__ int claim_ticket(int* counter, int* slot) {
  __syncthreads();  // every thread has read the previous ticket
  if (threadIdx.x == 0) *slot = atomicAdd(counter, 1);
  __syncthreads();
  return *slot;
}

// 16-byte asynchronous copy global -> shared (cp.async, bypassing L1).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

// 8-byte asynchronous copy global -> shared (cp.async.ca: only for
// bytes that no block changes in this launch before they are read).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until all but the most recent committed group have landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Blocks of a persistent launch: as many as are resident at once, at
// most one per task.  0 on a CUDA error (the caller returns it).
template <typename Kernel>
static int persistent_grid(Kernel kernel, int threads, int tasks,
                           cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev)) != cudaSuccess ||
      (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, 0)) != cudaSuccess)
    return 0;
  const int g = sms * per_sm;
  return g < tasks ? g : tasks;
}
