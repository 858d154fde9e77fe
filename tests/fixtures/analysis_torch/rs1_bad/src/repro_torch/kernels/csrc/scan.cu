// Seeded RS101 in the kernel library's host code.
#include <cuda_runtime.h>

extern "C" {

int pq_scan(const float* x, float* out, int n, cudaStream_t stream) {
  cudaMemcpyAsync(out, x, n * sizeof(float), cudaMemcpyDeviceToDevice,
                  stream);
  cudaStreamSynchronize(stream);  // RS101: the host waits in the library
  return (int)cudaGetLastError();
}

}  // extern "C"
