// Starlet (a-trous B3) cascade and its exact adjoint, for Hopper (sm_90a).
//
// Replaces the TPU kernel lightcurver_tpu/ops/starlet_pallas.py
// (_starlet_kernel, launched by starlet_transform_pallas) and the jnp
// linear transpose that serves as its backward
// (lightcurver_tpu/ops/starlet_op.py, _bwd).
//
// What bounds it: the cascade does 10 flops per pixel and level and is
// latency- and bandwidth-bound. It reads one (m, m) plane and writes
// J + 1 planes (the adjoint reads J + 1 and writes one); everything in
// between is traffic between levels.
//
// What the design does about it: one block per image keeps the whole
// cascade in shared memory -- two planes, the running coarse plane and
// the row-pass result, 8 m^2 bytes (32 KB at m = 64, 128 KB at m = 128,
// above 48 KB by opt-in). Device memory sees only the one input read and
// the coalesced per-level output writes. The TPU kernel padded the image
// once by 2 (2^J - 1); at m = 128 that is a 636^2 plane, which no SM
// holds, so each tap here reflects its own index instead
// (i < 0 -> -1 - i, i >= m -> 2m - 1 - i). One reflection suffices since
// 2^J <= m, and that holds for any m, a power of two or not.
//
// The adjoint: the mirror-boundary B3 smoothing S_j is a symmetric
// matrix, so the transpose of the cascade is the same stencil run in
// reverse: b = g_J - g_{J-1}; for j = J-1 .. 0: b = S_j(b) + g_j - g_{j-1}
// with g_{-1} = 0.
//
// Interface: plain C, bound with ctypes. Each launch runs on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() as an int.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kW0 = 1.0f / 16.0f;
constexpr float kW1 = 4.0f / 16.0f;
constexpr float kW2 = 6.0f / 16.0f;

__device__ __forceinline__ int mirror(int i, int m) {
  i = i < 0 ? -1 - i : i;
  return i >= m ? 2 * m - 1 - i : i;
}

// dst[y][x] = sum_k w_k src[y][mirror(x + (k - 2) d)]  (both in shared memory)
__device__ __forceinline__ void row_pass(const float* src, float* dst, int m,
                                         int d) {
  const int n = m * m;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int y = p / m;
    const int x = p - y * m;
    const float* r = src + y * m;
    float acc = kW0 * r[mirror(x - 2 * d, m)];
    acc += kW1 * r[mirror(x - d, m)];
    acc += kW2 * r[x];
    acc += kW1 * r[mirror(x + d, m)];
    acc += kW0 * r[mirror(x + 2 * d, m)];
    dst[p] = acc;
  }
}

// sum_k w_k src[mirror(y + (k - 2) d)][x]
__device__ __forceinline__ float col_tap(const float* src, int y, int x,
                                         int m, int d) {
  float acc = kW0 * src[mirror(y - 2 * d, m) * m + x];
  acc += kW1 * src[mirror(y - d, m) * m + x];
  acc += kW2 * src[y * m + x];
  acc += kW1 * src[mirror(y + d, m) * m + x];
  acc += kW0 * src[mirror(y + 2 * d, m) * m + x];
  return acc;
}

// x: (B, m, m) -> out: (B, J + 1, m, m); one block per image.
__global__ void __launch_bounds__(kThreads)
starlet_forward_kernel(const float* __restrict__ x, float* __restrict__ out,
                       int m, int n_scales) {
  extern __shared__ float smem[];
  const int n = m * m;
  float* cur = smem;       // running coarse plane c_j
  float* tmp = smem + n;   // row-smoothed c_j
  const float* img = x + static_cast<size_t>(blockIdx.x) * n;
  float* o = out + static_cast<size_t>(blockIdx.x) * (n_scales + 1) * n;

  for (int p = threadIdx.x; p < n; p += blockDim.x) cur[p] = img[p];
  __syncthreads();
  for (int j = 0; j < n_scales; ++j) {
    const int d = 1 << j;
    row_pass(cur, tmp, m, d);
    __syncthreads();
    // column pass in place: a thread reads tmp and only its own cur pixel
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int y = p / m;
      const int xx = p - y * m;
      const float s = col_tap(tmp, y, xx, m, d);
      o[static_cast<size_t>(j) * n + p] = cur[p] - s;
      cur[p] = s;
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    o[static_cast<size_t>(n_scales) * n + p] = cur[p];
}

// g: (B, J + 1, m, m) -> out: (B, m, m); one block per image.
__global__ void __launch_bounds__(kThreads)
starlet_adjoint_kernel(const float* __restrict__ g, float* __restrict__ out,
                       int m, int n_scales) {
  extern __shared__ float smem[];
  const int n = m * m;
  float* b = smem;         // running cotangent
  float* tmp = smem + n;   // row-smoothed b
  const float* gi = g + static_cast<size_t>(blockIdx.x) * (n_scales + 1) * n;
  float* o = out + static_cast<size_t>(blockIdx.x) * n;

  const float* g_last = gi + static_cast<size_t>(n_scales) * n;
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    b[p] = n_scales > 0 ? g_last[p] - g_last[p - n] : g_last[p];
  __syncthreads();
  for (int j = n_scales - 1; j >= 0; --j) {
    const int d = 1 << j;
    row_pass(b, tmp, m, d);
    __syncthreads();
    const float* gj = gi + static_cast<size_t>(j) * n;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int y = p / m;
      const int xx = p - y * m;
      float v = col_tap(tmp, y, xx, m, d) + gj[p];
      if (j > 0) v -= gj[p - n];
      b[p] = v;
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < n; p += blockDim.x) o[p] = b[p];
}

// Raise the dynamic shared-memory cap of `kernel` to `bytes` when needed.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* configured) {
  if (bytes <= 48 * 1024 || bytes <= *configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *configured = bytes;
  return e;
}

int g_forward_smem = 0;
int g_adjoint_smem = 0;

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may opt in to on `device`, in
// bytes, or -1 on error.
int starlet_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

const char* starlet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int starlet_forward(const float* x, float* out, int batch, int m,
                    int n_scales, void* stream) {
  const int smem = 2 * m * m * static_cast<int>(sizeof(float));
  cudaError_t e = allow_smem(starlet_forward_kernel, smem, &g_forward_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  starlet_forward_kernel<<<batch, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, out, m, n_scales);
  return static_cast<int>(cudaGetLastError());
}

int starlet_adjoint(const float* g, float* out, int batch, int m,
                    int n_scales, void* stream) {
  const int smem = 2 * m * m * static_cast<int>(sizeof(float));
  cudaError_t e = allow_smem(starlet_adjoint_kernel, smem, &g_adjoint_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  starlet_adjoint_kernel<<<batch, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      g, out, m, n_scales);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
