// The fused render of the deconvolution model (K2), forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel lightcurver_tpu/ops/experimental/fused_render.py
// (_fwd_kernel, launched by _fused_render_fwd_impl) and adds the backward
// that the JAX package never built. Per epoch e, with 2M = C rank-1 terms:
//
//   spec   = sum_c u[c] (x) v[c]                        (L, Lh), complex
//   X      = spec * (t_hat * r_hat) [+ h_hat * (t_hat * (pc + i ps))]
//   A + iB = (Ayp + i Byp) X                            (n, Lh)
//   out    = Re{(A + iB)(Cxp + i Sxp)} = A Cxp - B Sxp  (n, n)
//
// The backward, with G the (n, n) cotangent of the epoch:
//   dA = G Cxp^T, dB = -G Sxp^T
//   dXr = Ayp^T dA + Byp^T dB,  dXi = Ayp^T dB - Byp^T dA
//   dspec = dX * conj(t_hat * r_hat)
//   du_re[c] = sum_j dspec_re[:, j] v[c, j],  du_im likewise with dspec_im
//   dv[c]    = sum_k dspec_re[k] u_re[c, k] + dspec_im[k] u_im[c, k]
//   dh_hat   = sum_e dX_e * conj(t_hat_e * (pc + i ps))   (across epochs)
//
// What bounds it: per epoch 4 n L Lh + 2 n^2 Lh + 2 C L Lh multiply-adds
// (10.6 M at n = 64, L = 256, C = 8; 1.1 G for 100 epochs) against one read
// of the epoch's t_hat (264 KB): compute, on the CUDA cores, in float32.
// TF32 tensor cores are off limits (the reduced-precision flux systematic
// of the JAX package), so the products are fp32 FMAs.
//
// What the design does about it. One epoch's complex spectrum (264 KB at
// L = 256) does not fit an SM, so a block takes one epoch and one tile of
// kTile = 32 columns of the half axis j (one column per lane) and builds
// X[:, tile] in shared memory from u, v, t_hat, r_hat and h_hat: the
// spectrum never reaches device memory. Stage 1 gives A + iB for the tile
// in full (it contracts over k, which the block holds whole), stage 2 the
// tile's share of the (n, n) output. The shares of the tiles are written
// per tile and summed in a fixed order by a second kernel (sum_middle).
// The backward mirrors it: a block turns G into dA, dB for its tile, then
// dX and dspec for all k, and writes dv for its columns (complete), its
// share of du (summed over tiles afterwards) and, with h, the epoch's
// share of dh_hat (summed over epochs afterwards, in epoch order). No
// float atomics anywhere: every result is the same from run to run. The
// backward keeps G and the Cxp/Sxp tiles in the memory that dspec takes
// over later (101 KB a block at n = 64, L = 256: two blocks per SM), and
// each warp owns 8 contiguous rows of dX, so Ayp and Byp arrive as float4.
//
// Interface: plain C, bound with ctypes. Each call runs on the caller's
// stream, allocates nothing (the wrapper passes the scratch), does not
// synchronise, and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;           // half-axis columns per block, one per lane
constexpr int kTileP = kTile + 1;   // row stride of buffers also read along k
constexpr int kRows = 8;            // rows per warp and pass in the block GEMMs

int fwd_smem_floats(int C, int L, int n) {
  // u_re, u_im (C, L); v tile (C, kTile); X re, im (L, kTile); A, B (n, kTile)
  return 2 * C * L + C * kTile + 2 * L * kTile + 2 * n * kTile;
}

// The backward's last region holds G (n, n) and the Cxp, Sxp tiles
// (n, kTileP) until dA, dB are built, then dspec re, im (L, kTileP).
int bwd_region_floats(int L, int n) {
  const int early = 2 * n * kTileP + n * n;
  const int late = 2 * L * kTileP;
  return early > late ? early : late;
}

int bwd_smem_floats(int C, int L, int n) {
  // u_re, u_im (C, L); v tile (C, kTile); dA, dB (n, kTile); the region
  return 2 * C * L + C * kTile + 2 * n * kTile + bwd_region_floats(L, n);
}

// Epoch blockIdx.y, columns j0 = blockIdx.x * kTile ... of the half axis.
// partial: (N, n_tiles, n, n), this tile's share of the epoch's render.
__global__ void __launch_bounds__(kThreads)
k2_forward_tile(const float* __restrict__ u_re, const float* __restrict__ u_im,
                const float* __restrict__ v, const float* __restrict__ t_re,
                const float* __restrict__ t_im,
                const float* __restrict__ r_hat, const float* __restrict__ pc,
                const float* __restrict__ ps, const float* __restrict__ h_re,
                const float* __restrict__ h_im, const float* __restrict__ ayp,
                const float* __restrict__ byp, const float* __restrict__ cxp,
                const float* __restrict__ sxp, float* __restrict__ partial,
                int C, int L, int Lh, int n, int include_h) {
  extern __shared__ float smem[];
  const int e = blockIdx.y;
  const int tile = blockIdx.x;
  const int j0 = tile * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = j0 + lane;
  const bool j_in = j < Lh;

  float* su_re = smem;
  float* su_im = su_re + C * L;
  float* sv = su_im + C * L;
  float* sxr = sv + C * kTile;
  float* sxi = sxr + L * kTile;
  float* sa = sxi + L * kTile;
  float* sb = sa + n * kTile;

  const size_t ue = static_cast<size_t>(e) * C * L;
  for (int p = threadIdx.x; p < C * L; p += kThreads) {
    su_re[p] = u_re[ue + p];
    su_im[p] = u_im[ue + p];
  }
  for (int c = warp; c < C; c += kWarps)
    sv[c * kTile + lane] =
        j_in ? v[(static_cast<size_t>(e) * C + c) * Lh + j] : 0.f;
  __syncthreads();

  // X[:, tile]: warp w builds rows k = w, w + 8, ...; lane = column
  const size_t te = static_cast<size_t>(e) * L * Lh;
  for (int k = warp; k < L; k += kWarps) {
    float xr = 0.f, xi = 0.f;
    if (j_in) {
      float sr = 0.f, si = 0.f;
      for (int c = 0; c < C; ++c) {
        const float vc = sv[c * kTile + lane];
        sr = fmaf(su_re[c * L + k], vc, sr);
        si = fmaf(su_im[c * L + k], vc, si);
      }
      const size_t q = static_cast<size_t>(k) * Lh + j;
      const float tr = t_re[te + q], ti = t_im[te + q], r = r_hat[q];
      const float pr = tr * r, pi = ti * r;
      xr = sr * pr - si * pi;
      xi = sr * pi + si * pr;
      if (include_h) {
        const float gr = tr * pc[q] - ti * ps[q];
        const float gi = tr * ps[q] + ti * pc[q];
        const float hr = h_re[q], hi = h_im[q];
        xr += hr * gr - hi * gi;
        xi += hr * gi + hi * gr;
      }
    }
    sxr[k * kTile + lane] = xr;
    sxi[k * kTile + lane] = xi;
  }
  __syncthreads();

  // stage 1: A + iB = (Ayp + i Byp) X[:, tile]; warp w takes rows
  // y0 + w + 8 i, the Ayp/Byp loads are uniform across the warp
  for (int y0 = 0; y0 < n; y0 += kWarps * kRows) {
    float acc_a[kRows], acc_b[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc_a[i] = acc_b[i] = 0.f;
    for (int k = 0; k < L; ++k) {
      const float xr = sxr[k * kTile + lane], xi = sxi[k * kTile + lane];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int y = y0 + warp + kWarps * i;
        if (y < n) {
          const float ay = __ldg(ayp + static_cast<size_t>(y) * L + k);
          const float by = __ldg(byp + static_cast<size_t>(y) * L + k);
          acc_a[i] = fmaf(ay, xr, fmaf(-by, xi, acc_a[i]));
          acc_b[i] = fmaf(ay, xi, fmaf(by, xr, acc_b[i]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int y = y0 + warp + kWarps * i;
      if (y < n) {
        sa[y * kTile + lane] = acc_a[i];
        sb[y * kTile + lane] = acc_b[i];
      }
    }
  }
  __syncthreads();

  // stage 2, this tile's share: sum over its columns of A Cxp - B Sxp
  const int jn = min(kTile, Lh - j0);
  float* out = partial + (static_cast<size_t>(e) * gridDim.x + tile) * n * n;
  for (int p = threadIdx.x; p < n * n; p += kThreads) {
    const int y = p / n;
    const int x = p - y * n;
    float acc = 0.f;
    for (int jj = 0; jj < jn; ++jj) {
      const size_t q = static_cast<size_t>(j0 + jj) * n + x;
      acc = fmaf(sa[y * kTile + jj], cxp[q], acc);
      acc = fmaf(-sb[y * kTile + jj], sxp[q], acc);
    }
    out[p] = acc;
  }
}

// Epoch blockIdx.y, columns j0 = blockIdx.x * kTile ... of the half axis.
// du_part: (2, N, n_tiles, C, L), this tile's share of du_re and du_im;
// dv: (N, C, Lh); dh_part: (2, N, L, Lh), the epoch's share of dh_hat.
__global__ void __launch_bounds__(kThreads, 2)
k2_backward_tile(const float* __restrict__ g, const float* __restrict__ u_re,
                 const float* __restrict__ u_im, const float* __restrict__ v,
                 const float* __restrict__ t_re,
                 const float* __restrict__ t_im,
                 const float* __restrict__ r_hat,
                 const float* __restrict__ pc, const float* __restrict__ ps,
                 const float* __restrict__ ayp, const float* __restrict__ byp,
                 const float* __restrict__ cxp, const float* __restrict__ sxp,
                 float* __restrict__ du_part, float* __restrict__ dv,
                 float* __restrict__ dh_part, int C, int L, int Lh, int n,
                 int include_h) {
  extern __shared__ float smem[];
  const int N = gridDim.y;
  const int e = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int j0 = tile * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = j0 + lane;
  const bool j_in = j < Lh;

  float* su_re = smem;
  float* su_im = su_re + C * L;
  float* sv = su_im + C * L;
  float* sda = sv + C * kTile;
  float* sdb = sda + n * kTile;
  float* sdsr = sdb + n * kTile;      // the region: dspec once dA, dB exist
  float* sdsi = sdsr + L * kTileP;
  float* scx = sdsr;                  // before: the Cxp, Sxp tiles and G
  float* ssx = scx + n * kTileP;
  float* sg = ssx + n * kTileP;

  const float* ge = g + static_cast<size_t>(e) * n * n;
  for (int p = threadIdx.x; p < n * n; p += kThreads) sg[p] = ge[p];
  const size_t ue = static_cast<size_t>(e) * C * L;
  for (int p = threadIdx.x; p < C * L; p += kThreads) {
    su_re[p] = u_re[ue + p];
    su_im[p] = u_im[ue + p];
  }
  for (int c = warp; c < C; c += kWarps)
    sv[c * kTile + lane] =
        j_in ? v[(static_cast<size_t>(e) * C + c) * Lh + j] : 0.f;
  for (int p = threadIdx.x; p < n * kTile; p += kThreads) {
    const int jj = p / n;
    const int x = p - jj * n;
    const bool in = j0 + jj < Lh;
    const size_t q = static_cast<size_t>(j0 + jj) * n + x;
    scx[x * kTileP + jj] = in ? cxp[q] : 0.f;
    ssx[x * kTileP + jj] = in ? sxp[q] : 0.f;
  }
  __syncthreads();

  // dA[y, jj] = sum_x G[y, x] Cxp[j, x];  dB[y, jj] = -sum_x G[y, x] Sxp[j, x]
  for (int y0 = 0; y0 < n; y0 += kWarps * kRows) {
    float acc_a[kRows], acc_b[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc_a[i] = acc_b[i] = 0.f;
    for (int x = 0; x < n; ++x) {
      const float cx = scx[x * kTileP + lane], sx = ssx[x * kTileP + lane];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int y = y0 + warp + kWarps * i;
        if (y < n) {
          const float gv = sg[y * n + x];
          acc_a[i] = fmaf(gv, cx, acc_a[i]);
          acc_b[i] = fmaf(-gv, sx, acc_b[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int y = y0 + warp + kWarps * i;
      if (y < n) {
        sda[y * kTile + lane] = acc_a[i];
        sdb[y * kTile + lane] = acc_b[i];
      }
    }
  }
  __syncthreads();   // G and the Cxp/Sxp tiles are dead from here on

  // dX for the kRows contiguous rows k = k0 + 8 w ... of warp w (L is a
  // multiple of kRows and Ayp, Byp are 16-byte aligned: two float4 loads
  // per matrix and y), then dspec and the epoch's share of dh_hat
  const size_t te = static_cast<size_t>(e) * L * Lh;
  const size_t plane = static_cast<size_t>(L) * Lh;
  for (int k0 = 0; k0 < L; k0 += kWarps * kRows) {
    const int kb = k0 + warp * kRows;
    if (kb >= L) continue;   // uniform across the warp; no barrier inside
    float dxr[kRows], dxi[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) dxr[i] = dxi[i] = 0.f;
    for (int y = 0; y < n; ++y) {
      const float da = sda[y * kTile + lane], db = sdb[y * kTile + lane];
      const float4* ar =
          reinterpret_cast<const float4*>(ayp + static_cast<size_t>(y) * L + kb);
      const float4* br =
          reinterpret_cast<const float4*>(byp + static_cast<size_t>(y) * L + kb);
      const float4 a0 = __ldg(ar), a1 = __ldg(ar + 1);
      const float4 b0 = __ldg(br), b1 = __ldg(br + 1);
      const float ay[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float by[kRows] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        dxr[i] = fmaf(ay[i], da, fmaf(by[i], db, dxr[i]));
        dxi[i] = fmaf(ay[i], db, fmaf(-by[i], da, dxi[i]));
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int k = kb + i;
      float dsr = 0.f, dsi = 0.f;
      if (j_in) {
        const size_t q = static_cast<size_t>(k) * Lh + j;
        const float tr = t_re[te + q], ti = t_im[te + q], r = r_hat[q];
        const float pr = tr * r, pi = ti * r;
        dsr = dxr[i] * pr + dxi[i] * pi;
        dsi = dxi[i] * pr - dxr[i] * pi;
        if (include_h) {
          const float gr = tr * pc[q] - ti * ps[q];
          const float gi = tr * ps[q] + ti * pc[q];
          dh_part[te + q] = dxr[i] * gr + dxi[i] * gi;
          dh_part[N * plane + te + q] = dxi[i] * gr - dxr[i] * gi;
        }
      }
      sdsr[k * kTileP + lane] = dsr;
      sdsi[k * kTileP + lane] = dsi;
    }
  }
  __syncthreads();

  // dv[e, c, j] = sum_k dspec_re[k, jj] u_re[c, k] + dspec_im[k, jj] u_im[c, k]
  for (int c = warp; c < C; c += kWarps) {
    float acc = 0.f;
    for (int k = 0; k < L; ++k)
      acc = fmaf(sdsr[k * kTileP + lane], su_re[c * L + k],
                 fmaf(sdsi[k * kTileP + lane], su_im[c * L + k], acc));
    if (j_in) dv[(static_cast<size_t>(e) * C + c) * Lh + j] = acc;
  }

  // this tile's share of du[e, c, k] = sum_jj dspec[k, jj] v[c, jj]
  const size_t cl = static_cast<size_t>(C) * L;
  float* dur = du_part + (static_cast<size_t>(e) * n_tiles + tile) * cl;
  float* dui = dur + static_cast<size_t>(N) * n_tiles * cl;
  for (int p = threadIdx.x; p < C * L; p += kThreads) {
    const int c = p / L;
    const int k = p - c * L;
    float ar = 0.f, ai = 0.f;
    for (int jj = 0; jj < kTile; ++jj) {
      const float vc = sv[c * kTile + jj];
      ar = fmaf(sdsr[k * kTileP + jj], vc, ar);
      ai = fmaf(sdsi[k * kTileP + jj], vc, ai);
    }
    dur[p] = ar;
    dui[p] = ai;
  }
}

// out[o, i] = sum_t in[o, t, i] for t = 0 .. mid - 1, in that order.
__global__ void sum_middle(const float* __restrict__ in,
                           float* __restrict__ out, int outer, int mid,
                           int inner) {
  const size_t total = static_cast<size_t>(outer) * inner;
  for (size_t p = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < total; p += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t o = p / inner;
    const size_t i = p - o * inner;
    const float* src = in + o * mid * inner + i;
    float acc = 0.f;
    for (int t = 0; t < mid; ++t) acc += src[static_cast<size_t>(t) * inner];
    out[p] = acc;
  }
}

cudaError_t launch_sum_middle(const float* in, float* out, int outer,
                              int mid, int inner, cudaStream_t stream) {
  const long long total = static_cast<long long>(outer) * inner;
  const int blocks = static_cast<int>(
      total / 256 + 1 < 132 * 16 ? total / 256 + 1 : 132 * 16);
  sum_middle<<<blocks, 256, 0, stream>>>(in, out, outer, mid, inner);
  return cudaGetLastError();
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
int g_backward_smem = 0;

}  // namespace

extern "C" {

int k2_tile_width() { return kTile; }

// Largest dynamic shared memory a block may opt in to on `device`, in
// bytes, or -1 on error.
int k2_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Dynamic shared memory of one block of the forward (backward = 0) or
// backward (backward = 1) tile kernel, in bytes.
int k2_smem_bytes(int backward, int C, int L, int n) {
  const int floats = backward ? bwd_smem_floats(C, L, n)
                              : fwd_smem_floats(C, L, n);
  return floats * static_cast<int>(sizeof(float));
}

const char* k2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// partial: scratch (N, ceil(Lh / kTile), n, n); out: (N, n, n).
// h_re, h_im are not read when include_h is 0.
int k2_forward(const float* u_re, const float* u_im, const float* v,
               const float* t_re, const float* t_im, const float* r_hat,
               const float* pc, const float* ps, const float* h_re,
               const float* h_im, const float* ayp, const float* byp,
               const float* cxp, const float* sxp, float* partial,
               float* out, int N, int C, int L, int Lh, int n, int include_h,
               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = k2_smem_bytes(0, C, L, n);
  cudaError_t e = allow_smem(k2_forward_tile, smem, &g_forward_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (Lh + kTile - 1) / kTile;
  k2_forward_tile<<<dim3(n_tiles, N), kThreads, smem, s>>>(
      u_re, u_im, v, t_re, t_im, r_hat, pc, ps, h_re, h_im, ayp, byp, cxp,
      sxp, partial, C, L, Lh, n, include_h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_sum_middle(partial, out, N, n_tiles, n * n,
                                            s));
}

// du_part: scratch (2, N, n_tiles, C, L); du: (2, N, C, L) = du_re, du_im;
// dv: (N, C, Lh); dh_part: scratch (2, N, L, Lh); dh: (2, L, Lh) = dh_re,
// dh_im. dh_part and dh are not touched when include_h is 0.
int k2_backward(const float* g, const float* u_re, const float* u_im,
                const float* v, const float* t_re, const float* t_im,
                const float* r_hat, const float* pc, const float* ps,
                const float* ayp, const float* byp, const float* cxp,
                const float* sxp, float* du_part, float* du, float* dv,
                float* dh_part, float* dh, int N, int C, int L, int Lh, int n,
                int include_h, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = k2_smem_bytes(1, C, L, n);
  cudaError_t e = allow_smem(k2_backward_tile, smem, &g_backward_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (Lh + kTile - 1) / kTile;
  k2_backward_tile<<<dim3(n_tiles, N), kThreads, smem, s>>>(
      g, u_re, u_im, v, t_re, t_im, r_hat, pc, ps, ayp, byp, cxp, sxp,
      du_part, dv, dh_part, C, L, Lh, n, include_h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // du over tiles, for re and im at once: outer 2 N
  e = launch_sum_middle(du_part, du, 2 * N, n_tiles, C * L, s);
  if (e != cudaSuccess || !include_h) return static_cast<int>(e);
  // dh_hat over epochs, in epoch order
  return static_cast<int>(launch_sum_middle(dh_part, dh, 2, N, L * Lh, s));
}

}  // extern "C"
