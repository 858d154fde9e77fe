// Mini kernel library: the goodk entry point.
#include <cuda_runtime.h>

__global__ void goodk_kernel(const float* x, float* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 2.0f * x[i];
}

extern "C" {

int pq_goodk(const float* x, float* out, int n, cudaStream_t stream) {
  goodk_kernel<<<(n + 127) / 128, 128, 0, stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
