// Copies between the cards of a mesh, for the sharded paths
// (graphs.py peer_copy).  Counterpart of the halo and apron moves
// that dryv_tpu/parallel/bands.py makes with jax.lax.ppermute over ICI.
//
// A raw cudaMemcpy2DAsync over unified addresses on the given stream of
// either card (the sender's for a halo or a group's planes, the
// receiver's for a ghost band it pulls): no event, no stream of the other
// card, no allocation, so it can be captured into that card's CUDA graph
// as a memcpy node (a PyTorch copy between cards synchronises with the
// other card's current stream, which fails a capture).  It copies
// `height` rows of `width` bytes that lie `spitch` / `dpitch` bytes apart
// (a band's rows of every frame of a plane stack; one row for a
// contiguous tensor).  Bound by bytes over NVLink (450 GB/s each way on
// an H100 SXM host); a halo is a few KB, so the pipeline sees the copy's
// latency, not its bandwidth.
#include "common.cuh"

DT_EXPORT int dt_peer_copy(const void* src, void* dst, int width, int height,
                           int spitch, int dpitch, void* stream) {
  cudaMemcpy2DAsync(dst, (size_t)dpitch, src, (size_t)spitch, (size_t)width,
                    (size_t)height, cudaMemcpyDefault, (cudaStream_t)stream);
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
