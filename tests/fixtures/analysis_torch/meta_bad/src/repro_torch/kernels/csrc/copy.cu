// A reasonless suppression in a CUDA source still suppresses (RS001).
#include <cuda_runtime.h>

extern "C" {

int pq_copy_to_host(float* dst, const float* src, int n) {
  cudaMemcpy(dst, src, n * sizeof(float), cudaMemcpyDeviceToHost);  // repro: ignore[RS101]
  return (int)cudaGetLastError();
}

}  // extern "C"
