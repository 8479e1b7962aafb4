// Native host-side preprocessing kernels for lightcurver_tpu.
//
// The reference pipeline delegates its per-frame host preprocessing to the
// C library `sep` (background mesh estimation + source extraction;
// reference lightcurver/processes/background_estimation.py:25,
// star_extraction.py:23). This translation unit provides the same
// capability natively: a sigma-clipped mesh background model and a
// flood-fill source extractor with second-moment shape measurements.
// Exposed through a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC -o liblightcurver_native.so
//        lightcurver_native.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct BoxStats {
  float mode;
  float rms;
};

// numpy-compatible median (average of the two central values for even n).
double median_of(std::vector<float>& values) {
  size_t n = values.size();
  std::nth_element(values.begin(), values.begin() + n / 2, values.end());
  double med = values[n / 2];
  if (n % 2 == 0) {
    // the other central element is the max of the lower partition
    float lower = *std::max_element(values.begin(), values.begin() + n / 2);
    med = 0.5 * (med + lower);
  }
  return med;
}

void mean_std_of(const std::vector<float>& values, double* mean,
                 double* std) {
  size_t n = values.size();
  double m = 0.0;
  for (float v : values) m += v;
  m /= n;
  double s = 0.0;
  for (float v : values) s += (v - m) * (v - m);
  *mean = m;
  *std = std::sqrt(s / n);
}

// SExtractor-style clipped mode estimate of one mesh box.  Mirrors the
// Python fallback (processes/background_estimation._sigma_clip_box):
// stats are recomputed on the FINAL surviving sample after the clipping
// loop, and an empty box reports NaN (the caller fills with the global
// median, matching the fallback's convention).
BoxStats clipped_mode(std::vector<float>& values) {
  const float kNan = std::numeric_limits<float>::quiet_NaN();
  if (values.empty()) return {kNan, kNan};
  // 3 iterations of 3-sigma clipping about the median
  for (int iter = 0; iter < 3; ++iter) {
    double med = median_of(values);
    double mean, std;
    mean_std_of(values, &mean, &std);
    if (std == 0.0) break;
    std::vector<float> kept;
    kept.reserve(values.size());
    for (float v : values)
      if (std::fabs(v - med) <= 3.0 * std) kept.push_back(v);
    if (kept.size() == values.size() || kept.empty()) break;
    values.swap(kept);
  }
  double med = median_of(values);
  double mean, std;
  mean_std_of(values, &mean, &std);
  double mode = 2.5 * med - 1.5 * mean;
  if (std == 0.0 || std::fabs(med - mean) / (std + 1e-30) > 0.3) mode = med;
  return {static_cast<float>(mode), static_cast<float>(std)};
}

// --- L.A.Cosmic building blocks (double precision, mirroring the
// scipy-based fallback in processes/cosmics.py exactly: same mirror
// boundary convention as ndimage mode="mirror", same numpy median
// definition, same zero-padded 3x3 dilation as ndimage.binary_dilation).

// scipy mode="mirror": reflect about the edge pixel center
// (index -1 -> 1, index n -> n-2).
inline int mirror_idx(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

inline void cmp_swap(double& a, double& b) {
  const double lo = std::min(a, b), hi = std::max(a, b);
  a = lo;
  b = hi;
}

// Paeth's 19-exchange median-of-9 network (exact element selection, so
// bit-identical to a sort-based median).
inline double median9(double* v) {
  cmp_swap(v[1], v[2]); cmp_swap(v[4], v[5]); cmp_swap(v[7], v[8]);
  cmp_swap(v[0], v[1]); cmp_swap(v[3], v[4]); cmp_swap(v[6], v[7]);
  cmp_swap(v[1], v[2]); cmp_swap(v[4], v[5]); cmp_swap(v[7], v[8]);
  cmp_swap(v[0], v[3]); cmp_swap(v[5], v[8]); cmp_swap(v[4], v[7]);
  cmp_swap(v[3], v[6]); cmp_swap(v[1], v[4]); cmp_swap(v[2], v[5]);
  cmp_swap(v[4], v[7]); cmp_swap(v[4], v[2]); cmp_swap(v[6], v[4]);
  cmp_swap(v[4], v[2]);
  return v[4];
}

// branchless rank: number of window elements strictly below v (the
// auto-vectorizable inner loop that replaces binary search — binary
// search's branch misses dominated the first implementation).
inline int rank_of(const double* S, int m, double v) {
  int c = 0;
  for (int i = 0; i < m; ++i) c += (S[i] < v);
  return c;
}

// k x k median filter with mirror boundary (k odd, k <= 7).  A sorted
// window S slides along each row: per step the k leaving values are
// replaced by the k entering ones (rank scan + memmove between the two
// ranks).  Medians are exact element selections, so the result is
// bit-identical to scipy.ndimage.median_filter(mode="mirror").
// k == 3 short-circuits to the median-of-9 network (faster than any
// window maintenance at that size).
void median_filter_k(const double* src, double* dst, int ny, int nx,
                     int k) {
  const int h = k / 2, m = k * k, mid = m / 2;
  if (k == 3) {
    double w[9];
    for (int y = 0; y < ny; ++y) {
      const double* r0 = src + static_cast<int64_t>(
          mirror_idx(y - 1, ny)) * nx;
      const double* r1 = src + static_cast<int64_t>(y) * nx;
      const double* r2 = src + static_cast<int64_t>(
          mirror_idx(y + 1, ny)) * nx;
      for (int x = 0; x < nx; ++x) {
        const int xl = mirror_idx(x - 1, nx), xr = mirror_idx(x + 1, nx);
        w[0] = r0[xl]; w[1] = r0[x]; w[2] = r0[xr];
        w[3] = r1[xl]; w[4] = r1[x]; w[5] = r1[xr];
        w[6] = r2[xl]; w[7] = r2[x]; w[8] = r2[xr];
        dst[static_cast<int64_t>(y) * nx + x] = median9(w);
      }
    }
    return;
  }
  const double* rows[7];
  double S[49];
  for (int y = 0; y < ny; ++y) {
    for (int dy = -h; dy <= h; ++dy)
      rows[dy + h] = src + static_cast<int64_t>(
          mirror_idx(y + dy, ny)) * nx;
    int c = 0;
    for (int dx = -h; dx <= h; ++dx) {
      const int xx = mirror_idx(dx, nx);
      for (int r = 0; r < k; ++r) S[c++] = rows[r][xx];
    }
    std::sort(S, S + m);
    dst[static_cast<int64_t>(y) * nx] = S[mid];
    for (int x = 1; x < nx; ++x) {
      const int leave = mirror_idx(x - 1 - h, nx);
      const int enter = mirror_idx(x + h, nx);
      if (leave != enter) {
        for (int r = 0; r < k; ++r) {
          const double out = rows[r][leave], in = rows[r][enter];
          if (out == in) continue;
          // rank_of(out) is the first index holding a value == out
          // (out is guaranteed present in S)
          if (in > out) {
            const int p = rank_of(S, m, out), q = rank_of(S, m, in);
            std::memmove(S + p, S + p + 1,
                         (q - 1 - p) * sizeof(double));
            S[q - 1] = in;
          } else {
            const int p = rank_of(S, m, out), q = rank_of(S, m, in);
            std::memmove(S + q + 1, S + q, (p - q) * sizeof(double));
            S[q] = in;
          }
        }
      }
      dst[static_cast<int64_t>(y) * nx + x] = S[mid];
    }
  }
}

// Positive part of the 2x-supersampled Laplacian, block-averaged back
// to the original grid (processes/cosmics._supersampled_laplacian).
// The upsampled image is u(i, j) = img[i / 2, j / 2] on a
// (2 ny, 2 nx) grid; the 5-point Laplacian stencil with mirror
// boundary is evaluated there, clamped at zero, and the 2x2 block
// mean is returned.
void supersampled_laplacian(const double* img, double* lap, int ny,
                            int nx) {
  const int uy = 2 * ny, ux = 2 * nx;
  auto up = [&](int i, int j) -> double {
    return img[static_cast<int64_t>(mirror_idx(i, uy) >> 1) * nx
               + (mirror_idx(j, ux) >> 1)];
  };
  for (int y = 0; y < ny; ++y) {
    for (int x = 0; x < nx; ++x) {
      double acc = 0.0;
      for (int sy = 0; sy < 2; ++sy) {
        for (int sx = 0; sx < 2; ++sx) {
          const int i = 2 * y + sy, j = 2 * x + sx;
          // accumulation order matches scipy ndimage.convolve
          // bit-for-bit (verified on random doubles): the -0.25
          // weights multiply each neighbour BEFORE summing, in
          // top, left, centre, right, bottom order
          const double v = (-0.25 * up(i - 1, j)
                            + -0.25 * up(i, j - 1))
                           + up(i, j)
                           + -0.25 * up(i, j + 1)
                           + -0.25 * up(i + 1, j);
          acc += std::max(v, 0.0);
        }
      }
      lap[static_cast<int64_t>(y) * nx + x] = 0.25 * acc;
    }
  }
}

}  // namespace

extern "C" {

// L.A.Cosmic (van Dokkum 2001) cosmic-ray detection — native twin of
// processes/cosmics.detect_cosmics (which replaces the reference's
// astroscrappy.detect_cosmics call, reference
// lightcurver/processes/cutout_making.py:85).  `var` is the per-pixel
// noise VARIANCE (may be nullptr -> |data| + 1).  Writes the boolean
// cosmic mask (1 = cosmic) and the median-cleaned image.
void lc_detect_cosmics(const double* data, const double* var, int ny,
                       int nx, double sigclip, double sigfrac,
                       double objlim, int niter, uint8_t* mask_out,
                       double* cleaned_out) {
  const int64_t npix = static_cast<int64_t>(ny) * nx;
  std::vector<double> img(data, data + npix);
  std::vector<double> noise(npix);
  for (int64_t i = 0; i < npix; ++i) {
    const double v = var ? var[i] : std::fabs(data[i]) + 1.0;
    noise[i] = std::sqrt(std::max(v, 1e-12));
  }

  std::vector<double> lap(npix), snr(npix), snr_med(npix);
  std::vector<double> med3(npix), med7(npix), fine(npix);
  std::vector<uint8_t> total(npix, 0), cand(npix, 0);

  for (int it = 0; it < std::max(niter, 1); ++it) {
    supersampled_laplacian(img.data(), lap.data(), ny, nx);
    for (int64_t i = 0; i < npix; ++i) snr[i] = lap[i] / (2.0 * noise[i]);
    // remove smooth large-scale structure from the SNR map
    median_filter_k(snr.data(), snr_med.data(), ny, nx, 5);
    for (int64_t i = 0; i < npix; ++i) snr[i] -= snr_med[i];

    // fine-structure image: med3 - med7(med3), floored at 0.01
    median_filter_k(img.data(), med3.data(), ny, nx, 3);
    median_filter_k(med3.data(), med7.data(), ny, nx, 7);
    for (int64_t i = 0; i < npix; ++i)
      fine[i] = std::max(med3[i] - med7[i], 0.01);

    for (int64_t i = 0; i < npix; ++i)
      cand[i] = (snr[i] > sigclip && lap[i] / fine[i] > objlim) ? 1 : 0;

    // 3x3 dilation (zero-padded, as ndimage.binary_dilation) + reduced
    // threshold for the grown neighbours
    bool any_new = false;
    const double grow_thresh = sigclip * sigfrac;
    for (int y = 0; y < ny; ++y) {
      for (int x = 0; x < nx; ++x) {
        const int64_t i = static_cast<int64_t>(y) * nx + x;
        if (total[i]) continue;
        bool near = false;
        for (int dy = -1; dy <= 1 && !near; ++dy) {
          const int yy = y + dy;
          if (yy < 0 || yy >= ny) continue;
          for (int dx = -1; dx <= 1; ++dx) {
            const int xx = x + dx;
            if (xx < 0 || xx >= nx) continue;
            if (cand[static_cast<int64_t>(yy) * nx + xx]) {
              near = true;
              break;
            }
          }
        }
        if (near && snr[i] > grow_thresh) {
          total[i] = 2;  // staged: flip to 1 after the scan so the
                         // dilation of THIS pass sees only `cand`
          any_new = true;
        }
      }
    }
    for (int64_t i = 0; i < npix; ++i)
      if (total[i] == 2) total[i] = 1;
    if (!any_new) break;
    // replace every detected pixel with the current 3x3 median for the
    // next detection pass (same as the fallback: img[total] = med3[total])
    for (int64_t i = 0; i < npix; ++i)
      if (total[i]) img[i] = med3[i];
  }

  // cleaned image: original data with masked pixels median(5)-replaced
  std::vector<double> med5(npix);
  median_filter_k(data, med5.data(), ny, nx, 5);
  for (int64_t i = 0; i < npix; ++i) {
    mask_out[i] = total[i];
    cleaned_out[i] = total[i] ? med5[i] : data[i];
  }
}

// Mesh background: per-box clipped mode + rms over a (gy, gx) grid.
// mask: optional (may be nullptr), nonzero = excluded pixel.
void lc_background_mesh(const float* image, const uint8_t* mask, int ny,
                        int nx, int gy, int gx, float* back_grid,
                        float* rms_grid) {
  std::vector<float> box;
  for (int by = 0; by < gy; ++by) {
    int y0 = static_cast<int>(static_cast<int64_t>(by) * ny / gy);
    int y1 = static_cast<int>(static_cast<int64_t>(by + 1) * ny / gy);
    for (int bx = 0; bx < gx; ++bx) {
      int x0 = static_cast<int>(static_cast<int64_t>(bx) * nx / gx);
      int x1 = static_cast<int>(static_cast<int64_t>(bx + 1) * nx / gx);
      box.clear();
      for (int y = y0; y < y1; ++y)
        for (int x = x0; x < x1; ++x) {
          if (mask && mask[y * nx + x]) continue;
          float v = image[y * nx + x];
          if (std::isfinite(v)) box.push_back(v);
        }
      BoxStats st = clipped_mode(box);
      back_grid[by * gx + bx] = st.mode;
      rms_grid[by * gx + bx] = st.rms;
    }
  }
}

// Source extraction: connected components above threshold * sigma with
// flood fill (8-connectivity), flux-weighted centroids and second
// moments. Output layout per source (8 floats):
//   [x, y, flux, a, b, npix, peak, sum_positive]
// Returns the number of sources found (capped at max_sources).
int lc_extract_sources(const float* image, const float* variance, int ny,
                       int nx, float threshold, int min_area,
                       float* out, int max_sources, int32_t* seg_map) {
  const int64_t npix = static_cast<int64_t>(ny) * nx;
  std::vector<int32_t> seg_local;
  int32_t* seg = seg_map;
  if (!seg) {
    seg_local.assign(npix, 0);
    seg = seg_local.data();
  } else {
    std::memset(seg, 0, npix * sizeof(int32_t));
  }

  std::vector<int64_t> stack;
  int n_sources = 0;
  int label = 0;

  auto above = [&](int64_t idx) {
    float v = image[idx];
    float var = variance[idx];
    return std::isfinite(v) && var > 0.0f &&
           v > threshold * std::sqrt(var);
  };

  for (int64_t start = 0; start < npix; ++start) {
    if (seg[start] != 0 || !above(start)) continue;
    ++label;
    // flood fill this component
    stack.clear();
    stack.push_back(start);
    seg[start] = label;
    std::vector<int64_t> members;
    while (!stack.empty()) {
      int64_t idx = stack.back();
      stack.pop_back();
      members.push_back(idx);
      int y = static_cast<int>(idx / nx), x = static_cast<int>(idx % nx);
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          if (!dy && !dx) continue;
          int yy = y + dy, xx = x + dx;
          if (yy < 0 || yy >= ny || xx < 0 || xx >= nx) continue;
          int64_t j = static_cast<int64_t>(yy) * nx + xx;
          if (seg[j] == 0 && above(j)) {
            seg[j] = label;
            stack.push_back(j);
          }
        }
    }
    if (static_cast<int>(members.size()) < min_area) {
      for (int64_t idx : members) seg[idx] = -1;  // too small: drop
      continue;
    }
    if (n_sources >= max_sources) break;

    // moments (weights: positive part of the image)
    double wsum = 0, xs = 0, ysum = 0, flux = 0, peak = -1e30;
    for (int64_t idx : members) {
      double v = image[idx];
      flux += v;
      peak = std::max(peak, v);
      double w = std::max(v, 0.0);
      wsum += w;
      xs += w * (idx % nx);
      ysum += w * (idx / nx);
    }
    if (wsum <= 0) continue;
    double xc = xs / wsum, yc = ysum / wsum;
    double x2 = 0, y2 = 0, xy = 0;
    for (int64_t idx : members) {
      double w = std::max(static_cast<double>(image[idx]), 0.0);
      double dx = (idx % nx) - xc, dy = (idx / nx) - yc;
      x2 += w * dx * dx;
      y2 += w * dy * dy;
      xy += w * dx * dy;
    }
    x2 /= wsum; y2 /= wsum; xy /= wsum;
    double t = 0.5 * (x2 + y2);
    double d = std::sqrt(std::max(0.25 * (x2 - y2) * (x2 - y2) + xy * xy,
                                  0.0));
    float* row = out + 8 * n_sources;
    row[0] = static_cast<float>(xc);
    row[1] = static_cast<float>(yc);
    row[2] = static_cast<float>(flux);
    row[3] = static_cast<float>(std::sqrt(std::max(t + d, 1e-12)));
    row[4] = static_cast<float>(std::sqrt(std::max(t - d, 1e-12)));
    row[5] = static_cast<float>(members.size());
    row[6] = static_cast<float>(peak);
    row[7] = static_cast<float>(wsum);
    ++n_sources;
  }
  return n_sources;
}

}  // extern "C"
