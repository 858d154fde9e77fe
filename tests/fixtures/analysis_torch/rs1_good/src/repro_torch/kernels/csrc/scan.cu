// The clean equivalent: the copy stays on the caller's stream.
#include <cuda_runtime.h>

extern "C" {

int pq_scan(const float* x, float* out, int n, cudaStream_t stream) {
  cudaMemcpyAsync(out, x, n * sizeof(float), cudaMemcpyDeviceToDevice,
                  stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
