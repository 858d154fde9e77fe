// A reasoned suppression in a CUDA source (after //): zero findings.
#include <cuda_runtime.h>

extern "C" {

int pq_copy_to_host(float* dst, const float* src, int n) {
  // repro: ignore[RS101] a host copy by contract, never on a hot path
  cudaMemcpy(dst, src, n * sizeof(float), cudaMemcpyDeviceToHost);
  return (int)cudaGetLastError();
}

}  // extern "C"
