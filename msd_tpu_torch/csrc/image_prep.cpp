// Native image preprocessing for the serving path.
//
// The reference preprocesses with PIL in Python (LLaVA/llava/mm_utils.py:
// expand2square + CLIPImageProcessor bicubic resize + normalize) — ~5-10ms
// of single-threaded Python per image. This implements the same pipeline in
// C++ (OpenMP over rows): uint8 HWC -> pad-to-square with mean color ->
// bicubic resize (Catmull-Rom a=-0.5, PIL-compatible support-2 filter with
// edge clamping) -> scale to [0,1] -> per-channel normalize -> float CHW.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline double cubic_weight(double x) {
  // PIL's bicubic kernel (a = -0.5)
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Taps {
  int first;
  std::vector<double> w;  // normalized weights
};

// Precompute resize taps per output coordinate (PIL-style: support scales
// with the downscale ratio).
void build_taps(int in_size, int out_size, std::vector<Taps>& taps) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  taps.resize(out_size);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
    int xmax = static_cast<int>(
        std::min<double>(in_size, std::ceil(center + support)));
    Taps& t = taps[xx];
    t.first = xmin;
    t.w.resize(xmax - xmin);
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      double wv = cubic_weight((x + 0.5 - center) / filterscale);
      t.w[x - xmin] = wv;
      total += wv;
    }
    if (total != 0.0)
      for (double& wv : t.w) wv /= total;
  }
}

}  // namespace

extern "C" {

// in:  img  uint8 [h, w, 3]
// out: dst  float32 [3, out_size, out_size], CLIP-normalized
// pad_square: expand to square with the channel-mean color first
int image_prep(const uint8_t* img, int h, int w, int out_size,
               int pad_square, const float* mean, const float* stdv,
               float* dst) {
  if (h <= 0 || w <= 0 || out_size <= 0) return -1;

  // ---- expand2square with mean fill ----
  int side = pad_square ? std::max(h, w) : 0;
  std::vector<float> sq;  // HWC float
  int sh = h, sw = w;
  const uint8_t* src8 = img;
  std::vector<float> srcf;
  if (pad_square && h != w) {
    double csum[3] = {0, 0, 0};
    const int64_t n = static_cast<int64_t>(h) * w;
    for (int64_t i = 0; i < n; ++i)
      for (int c = 0; c < 3; ++c) csum[c] += img[i * 3 + c];
    float fill[3];
    for (int c = 0; c < 3; ++c)
      fill[c] = static_cast<float>(csum[c] / n);
    sq.assign(static_cast<size_t>(side) * side * 3, 0.f);
    for (int64_t i = 0; i < static_cast<int64_t>(side) * side; ++i)
      for (int c = 0; c < 3; ++c) sq[i * 3 + c] = fill[c];
    const int yoff = (side - h) / 2, xoff = (side - w) / 2;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        for (int c = 0; c < 3; ++c)
          sq[((static_cast<int64_t>(y + yoff)) * side + (x + xoff)) * 3 + c] =
              img[(static_cast<int64_t>(y) * w + x) * 3 + c];
    sh = sw = side;
  } else {
    srcf.resize(static_cast<size_t>(h) * w * 3);
    for (size_t i = 0; i < srcf.size(); ++i) srcf[i] = img[i];
    sq.swap(srcf);
  }

  // ---- bicubic resize (horizontal then vertical), per channel ----
  std::vector<Taps> htaps, vtaps;
  build_taps(sw, out_size, htaps);
  build_taps(sh, out_size, vtaps);

  // horizontal pass: [sh, out_size, 3]
  std::vector<float> tmp(static_cast<size_t>(sh) * out_size * 3);
#pragma omp parallel for
  for (int y = 0; y < sh; ++y) {
    for (int xx = 0; xx < out_size; ++xx) {
      const Taps& t = htaps[xx];
      double acc[3] = {0, 0, 0};
      for (size_t k = 0; k < t.w.size(); ++k) {
        const float* p = &sq[((static_cast<int64_t>(y)) * sw +
                              (t.first + static_cast<int>(k))) * 3];
        for (int c = 0; c < 3; ++c) acc[c] += t.w[k] * p[c];
      }
      for (int c = 0; c < 3; ++c)
        tmp[((static_cast<int64_t>(y)) * out_size + xx) * 3 + c] =
            static_cast<float>(acc[c]);
    }
  }

  // vertical pass + normalize + CHW
  const int64_t plane = static_cast<int64_t>(out_size) * out_size;
#pragma omp parallel for
  for (int yy = 0; yy < out_size; ++yy) {
    const Taps& t = vtaps[yy];
    for (int xx = 0; xx < out_size; ++xx) {
      double acc[3] = {0, 0, 0};
      for (size_t k = 0; k < t.w.size(); ++k) {
        const float* p = &tmp[((static_cast<int64_t>(t.first + k)) * out_size +
                               xx) * 3];
        for (int c = 0; c < 3; ++c) acc[c] += t.w[k] * p[c];
      }
      for (int c = 0; c < 3; ++c) {
        // PIL rounds the resampled result back to uint8 per pixel
        float v = static_cast<float>(
            std::nearbyint(std::min(255.0, std::max(0.0, acc[c]))));
        v = v / 255.0f;
        dst[c * plane + static_cast<int64_t>(yy) * out_size + xx] =
            (v - mean[c]) / stdv[c];
      }
    }
  }
  return 0;
}

}  // extern "C"
