// Starlet (a-trous B3) cascade and its exact adjoint, for Hopper (sm_90a).
//
// Replaces the TPU kernel lightcurver_tpu/ops/starlet_pallas.py
// (_starlet_kernel, launched by starlet_transform_pallas) and the jnp
// linear transpose that serves as its backward
// (lightcurver_tpu/ops/starlet_op.py, _bwd).
//
// What bounds it: the cascade does 10 flops per pixel and level. It reads
// one (m, m) plane and writes J + 1 planes (the adjoint reads J + 1 and
// writes one): 0.18 us of device memory at m 128 and batch 1, the shape of
// every stage-2 iteration. What takes the time at that shape is the chain
// of 2J dependent passes: a level's column pass needs its whole row pass,
// and the next level needs the whole column pass. One block on one SM (the
// first design) spent 76 us on it, issue-bound on one SM of 132 and
// waiting at 15 block barriers.
//
// The design: one image is spread over a thread-block cluster of C CTAs on
// neighbouring SMs (the wrapper picks C from m and the batch; C = 1, for
// large batches, is one CTA an image, launched without a cluster, with
// block barriers and plain shared-memory loads). CTA r owns
// rows [r R, min((r + 1) R, m)), R = ceil(m / C), and keeps in its shared
// memory its band of the running plane (c_j forward, b adjoint), two
// buffers for its band of the row-smoothed plane, used in turns by level,
// and a table that maps a row index i in [-m, 2m) through the mirror to
// (owning CTA, row in its band): 3 R m floats and 3 m ints, 13.5 KB at m
// 128 with C 16, 51 KB at m 256, 198 KB at m 512 (m <= 544 fits an H100).
// A thread owns one column x and walks the band's rows. One level:
//   1. the row pass reads the CTA's own band only. The thread's five
//      column indices are mirrored once a level, so the pixel loop has no
//      branch and no select, at the edges as in the interior;
//   2. cluster.sync(): every band of the level's row-smoothed plane is
//      complete and visible to the cluster;
//   3. the column pass reads the taps' rows y +- d, y +- 2d from the CTAs
//      that own them, through distributed shared memory (map_shared_rank),
//      coalesced along x. It writes the detail plane to device memory
//      (forward), or adds g_j - g_{j-1} (adjoint), and updates its own band
//      of the running plane;
//   4. __syncthreads(): the next row pass reads what other threads of the
//      CTA just wrote.
// The row-smoothed buffers alternate, so a CTA may start level j + 1's row
// pass while others still read its level-j buffer: one cluster barrier a
// level (J = 7 at m 128), and a last one before exit, since no CTA may
// leave while another still reads its shared memory. No division by a
// runtime size in the pixel loops.
//
// Mirror boundary: the TPU kernel padded the image once by 2 (2^J - 1); at
// m = 128 that is a 636^2 plane, so each tap here reflects its own index
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kW0 = 1.0f / 16.0f;
constexpr float kW1 = 4.0f / 16.0f;
constexpr float kW2 = 6.0f / 16.0f;

__device__ __forceinline__ int mirror(int i, int m) {
  i = i < 0 ? -1 - i : i;
  return i >= m ? 2 * m - 1 - i : i;
}

// sum_k w_k t_k, k = 0 .. 4 in that order, as the plain twin sums
__device__ __forceinline__ float b3(float t0, float t1, float t2, float t3,
                                    float t4) {
  float acc = kW0 * t0;
  acc += kW1 * t1;
  acc += kW2 * t2;
  acc += kW1 * t3;
  acc += kW0 * t4;
  return acc;
}

// The bands of one image: across a cluster of C > 1 CTAs (kCluster), or
// all in one CTA (C = 1, launched without a cluster: plain barriers and
// shared-memory loads)
template <bool kCluster>
struct Bands {
  // the barrier between a level's row pass and its column pass
  __device__ __forceinline__ static void sync() {
    if constexpr (kCluster)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }
  // row `entry` of the row-smoothed buffer `t`, in the shared memory of the
  // CTA that owns it; entry = owner << 16 | row in its band
  __device__ __forceinline__ static const float* row(float* t, int entry,
                                                     int m) {
    if constexpr (kCluster)
      return cg::this_cluster().map_shared_rank(t + (entry & 0xffff) * m,
                                                entry >> 16);
    else
      return t + entry * m;
  }
};

// One level at dilation d: the row pass of the band `cur` into `t`, the
// barrier, then the column pass; `epilogue(p, s)` takes the smoothed value
// s of the band's pixel p = yy m + x.
template <bool kCluster, typename Epilogue>
__device__ __forceinline__ void level(const float* cur, float* t,
                                      const int* owner, int m, int y0,
                                      int rows, int d, Epilogue epilogue) {
  using B = Bands<kCluster>;
  const int x = threadIdx.x;
  if (x < m) {
    const int c0 = mirror(x - 2 * d, m), c1 = mirror(x - d, m);
    const int c3 = mirror(x + d, m), c4 = mirror(x + 2 * d, m);
    for (int yy = threadIdx.y; yy < rows; yy += blockDim.y) {
      const float* r = cur + yy * m;
      t[yy * m + x] = b3(r[c0], r[c1], r[x], r[c3], r[c4]);
    }
  }
  B::sync();
  if (x < m) {
    for (int yy = threadIdx.y; yy < rows; yy += blockDim.y) {
      const int y = y0 + yy;
      const float s = b3(B::row(t, owner[y - 2 * d], m)[x],
                         B::row(t, owner[y - d], m)[x], t[yy * m + x],
                         B::row(t, owner[y + d], m)[x],
                         B::row(t, owner[y + 2 * d], m)[x]);
      epilogue(yy * m + x, s);
    }
  }
  __syncthreads();
}

// Forward: in (B, m, m) -> out (B, J + 1, m, m). Adjoint: in (B, J + 1, m,
// m) -> out (B, m, m). One cluster of C CTAs per image, bands of R rows;
// with kCluster false one CTA per image, R = m.
template <bool kAdjoint, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
starlet_bands(const float* __restrict__ in, float* __restrict__ out, int m,
              int n_scales, int R) {
  extern __shared__ float smem[];
  int rank = 0;
  size_t image = blockIdx.x;
  if constexpr (kCluster) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    image = blockIdx.x / cg::this_cluster().dim_blocks().x;
  }
  const int y0 = rank * R;
  const int rows = max(0, min(R, m - y0));
  const size_t n = static_cast<size_t>(m) * m;
  const size_t band = static_cast<size_t>(y0) * m;
  float* cur = smem;
  float* tmp = smem + R * m;   // level j: tmp + (j & 1) R m
  int* owner = reinterpret_cast<int*>(smem + 3 * R * m) + m;   // [-m, 2m)

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  for (int i = tid - m; i < 2 * m; i += n_threads) {
    const int r = mirror(i, m);
    const int o = r / R;
    owner[i] = o << 16 | (r - o * R);
  }
  const int x = threadIdx.x;
  const int ys = threadIdx.y, dy = blockDim.y;
  if constexpr (!kAdjoint) {
    const float* img = in + image * n + band;
    float* o = out + image * (n_scales + 1) * n + band;   // plane j: o + j n
    if (x < m)
      for (int yy = ys; yy < rows; yy += dy) cur[yy * m + x] = img[yy * m + x];
    __syncthreads();
    for (int j = 0; j < n_scales; ++j) {
      float* oj = o + j * n;
      float* t = tmp + (j & 1) * R * m;
      level<kCluster>(cur, t, owner, m, y0, rows, 1 << j, [=](int p, float s) {
        oj[p] = cur[p] - s;
        cur[p] = s;
      });
    }
    if (x < m)
      for (int yy = ys; yy < rows; yy += dy)
        o[n_scales * n + yy * m + x] = cur[yy * m + x];
  } else {
    const float* g = in + image * (n_scales + 1) * n + band;   // g_j: g + j n
    if (x < m) {
      const float* g_last = g + n_scales * n;
      const float* g_prev = g_last - n;
      for (int yy = ys; yy < rows; yy += dy) {
        const int p = yy * m + x;
        cur[p] = n_scales > 0 ? g_last[p] - g_prev[p] : g_last[p];
      }
    }
    __syncthreads();
    for (int j = n_scales - 1; j >= 0; --j) {
      const float* gj = g + j * n;
      const float* g_prev = gj - n;   // read only for j > 0
      float* t = tmp + (j & 1) * R * m;
      level<kCluster>(cur, t, owner, m, y0, rows, 1 << j, [=](int p, float s) {
        float v = s + gj[p];
        if (j > 0) v -= g_prev[p];
        cur[p] = v;
      });
    }
    if (x < m) {
      float* o = out + image * n + band;
      for (int yy = ys; yy < rows; yy += dy) o[yy * m + x] = cur[yy * m + x];
    }
  }
  if constexpr (kCluster)
    cg::this_cluster().sync();   // no CTA leaves while another reads its bands
}

// Shared memory of one CTA: the band of the running plane, two of the
// row-smoothed plane, the row table
int cta_bytes(int m, int cluster) {
  const int R = (m + cluster - 1) / cluster;
  return static_cast<int>(sizeof(float)) * (3 * R * m + 3 * m);
}

// A kernel's attributes are set at its first launch, to the card's largest
// opt-in shared memory and, for the cluster kernels, clusters of up to 16
// CTAs (8 is the portable maximum), so that no later launch, inside a
// CUDA-graph capture for instance, sets any; one bit per device.
template <bool kAdjoint, bool kCluster>
cudaError_t configure() {
  static unsigned configured = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (device & 31);
  if (configured & bit) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(starlet_bands<kAdjoint, kCluster>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return e;
  if constexpr (kCluster) {
    e = cudaFuncSetAttribute(starlet_bands<kAdjoint, kCluster>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
  }
  configured |= bit;
  return cudaSuccess;
}

// batch clusters of `cluster` CTAs (C = 1: batch CTAs, no cluster); a CTA
// has one thread per column (m rounded up to 32) times as many rows as fit
// 1024 threads, at most R
template <bool kAdjoint, bool kCluster>
cudaError_t launch(const float* in, float* out, int batch, int m,
                   int n_scales, int cluster, cudaStream_t stream) {
  cudaError_t e = configure<kAdjoint, kCluster>();
  if (e != cudaSuccess) return e;
  const int bx = (m + 31) / 32 * 32;
  const int R = (m + cluster - 1) / cluster;
  const int by = R < kMaxThreads / bx ? R : kMaxThreads / bx;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * cluster);
  cfg.blockDim = dim3(bx, by);
  cfg.dynamicSmemBytes = cta_bytes(m, cluster);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, starlet_bands<kAdjoint, kCluster>, in, out, m,
                         n_scales, R);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool kAdjoint>
int launch_any(const float* in, float* out, int batch, int m, int n_scales,
               int cluster, void* stream) {
  if (cluster < 1 || cluster > 16 || m < 1 || (m + 31) / 32 * 32 > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      cluster > 1
          ? launch<kAdjoint, true>(in, out, batch, m, n_scales, cluster, s)
          : launch<kAdjoint, false>(in, out, batch, m, n_scales, 1, s));
}

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

// Dynamic shared memory of one CTA at side m with `cluster` CTAs an image
int starlet_cta_bytes(int m, int cluster) { return cta_bytes(m, cluster); }

const char* starlet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (batch, m, m) -> out (batch, n_scales + 1, m, m), `cluster` CTAs an image
int starlet_forward(const float* x, float* out, int batch, int m,
                    int n_scales, int cluster, void* stream) {
  return launch_any<false>(x, out, batch, m, n_scales, cluster, stream);
}

// g (batch, n_scales + 1, m, m) -> out (batch, m, m)
int starlet_adjoint(const float* g, float* out, int batch, int m,
                    int n_scales, int cluster, void* stream) {
  return launch_any<true>(g, out, batch, m, n_scales, cluster, stream);
}

}  // extern "C"
