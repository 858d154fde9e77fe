// Mini kernel library: goodk and badk; nolib's entry point is missing.
#include <cuda_runtime.h>

__global__ void scale_kernel(const float* x, float* out, int n, float s) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = s * x[i];
}

extern "C" {

int pq_goodk(const float* x, float* out, int n, cudaStream_t stream) {
  scale_kernel<<<(n + 127) / 128, 128, 0, stream>>>(x, out, n, 2.0f);
  return (int)cudaGetLastError();
}

int pq_badk(const float* x, float* out, int n, cudaStream_t stream) {
  scale_kernel<<<(n + 127) / 128, 128, 0, stream>>>(x, out, n, 3.0f);
  return (int)cudaGetLastError();
}

}  // extern "C"
