// Copies between the cards of a mesh, for the sharded paths
// (parallel/mesh.py peer_copy).  Counterpart of the halo and apron moves
// that dryv_tpu/parallel/bands.py makes with jax.lax.ppermute over ICI.
//
// A raw cudaMemcpyAsync over unified addresses on the sending card's
// stream: no event, no stream of the receiving card, no allocation, so it
// can be captured into the sending card's CUDA graph as a memcpy node (a
// PyTorch copy between cards synchronises with the receiving card's
// current stream, which fails a capture).  Bound by bytes over NVLink
// (450 GB/s each way on an H100 SXM host); a halo is a few KB, so the
// pipeline sees the copy's latency, not its bandwidth.
#include "common.cuh"

DT_EXPORT int dt_peer_copy(const void* src, void* dst, int nbytes,
                           void* stream) {
  cudaMemcpyAsync(dst, src, (size_t)nbytes, cudaMemcpyDefault,
                  (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// Lets card `dev` reach card `peer`'s memory directly (NVLink or PCIe),
// as a copy captured on `dev` into `peer`'s memory needs.  An access
// already on is no error.  The calling thread's current card is restored.
DT_EXPORT int dt_enable_peer_access(int dev, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}
