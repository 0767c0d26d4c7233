// Host-side image preprocessing for the data pipeline (the port's copy of
// cmh_tpu/native/image_ops.cpp, the same C ABI).
//
// The reference's torchvision transforms (dataset/transformer_dataset.py:
// RandomHorizontalFlip, RandomResizedCrop or Resize, ToTensor, Normalize) in
// one pass: crop -> resize (bilinear/bicubic) -> horizontal flip -> [0,1]
// scale -> mean/std normalize, from uint8 HWC RGB to float32 HWC, with no
// intermediate image beyond the one horizontal-pass strip. Bound through
// ctypes (native/image_ops.py).
//
// The resampler is BIT-EXACT with PIL's (Pillow src/libImaging/Resample.c):
//  * support-scaled triangle / Catmull-Rom(a=-0.5) filters;
//  * coefficients quantized to int32 at PRECISION_BITS = 22;
//  * horizontal pass first, then vertical, each accumulating in int32 from
//    a half-unit bias and CLIPPING BACK TO uint8 between passes (clip8).
// The inter-pass uint8 quantization is load-bearing: bicubic overshoot
// regions clipped once per pass differ from a keep-it-in-double
// implementation by up to ~10 uint8 levels. The final normalize runs in
// float32 exactly like ToTensor (u8/255.f) followed by Normalize's float32
// sub/div. The coefficients are computed in double with no contracted
// multiply-add (native/_build.py builds with -ffp-contract=off), so their
// int32 rounding does not depend on the host's instruction set.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // PIL PRECISION_BITS == 22

inline uint8_t clip8(int32_t in) {
  // PIL clip8: clamp the pre-shift accumulator, then drop the fraction
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

inline double triangle_filter(double x) {
  x = std::abs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

inline double bicubic_filter(double x) {
  // PIL's bicubic kernel with a = -0.5
  constexpr double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Weights {
  // for each output coordinate: first source index + count + int32
  // fixed-point coefficients (ksize per output, row-major)
  std::vector<int> first;
  std::vector<int> count;
  std::vector<int32_t> k;
  int ksize = 0;
};

// Precompute 1-D resampling weights over a source span [src_lo, src_hi)
// mapped to out_size samples — PIL precompute_coeffs + normalize_coeffs_8bpc.
Weights compute_weights(int out_size, double src_lo, double src_hi,
                        int src_limit, int mode) {
  double support_base = mode == 1 ? 2.0 : 1.0;
  double scale = (src_hi - src_lo) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = support_base * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  Weights w;
  w.first.resize(out_size);
  w.count.resize(out_size);
  w.k.assign(static_cast<size_t>(out_size) * ksize, 0);
  w.ksize = ksize;

  std::vector<double> prek(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = src_lo + (xx + 0.5) * scale;
    double ss = 1.0 / filterscale;
    // PIL rounds the window bounds with +0.5, clamped to the image
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > src_limit) xmax = src_limit;
    int n = xmax - xmin;
    double total = 0.0;
    for (int i = 0; i < n; ++i) {
      double arg = (xmin + i - center + 0.5) * ss;
      double v = mode == 1 ? bicubic_filter(arg) : triangle_filter(arg);
      prek[i] = v;
      total += v;
    }
    int32_t* kk = &w.k[static_cast<size_t>(xx) * ksize];
    for (int i = 0; i < n; ++i) {
      double v = total != 0.0 ? prek[i] / total : prek[i];
      v *= 1 << kPrecisionBits;
      kk[i] = static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
    }
    w.first[xx] = xmin;
    w.count[xx] = n;
  }
  return w;
}

}  // namespace

extern "C" {

// src: uint8 HWC RGB (sh, sw, 3); crop box rows [cy, cy+ch), cols [cx, cx+cw)
// dst: float32 HWC (dh, dw, 3) = normalize(resize(crop(flip?(src))))
// mode: 0 = bilinear, 1 = bicubic. With flip != 0 the crop box addresses the
// horizontally-flipped source (torchvision applies the flip before the crop).
void crop_resize_normalize(const uint8_t* src, int sh, int sw, int cy, int cx,
                           int ch, int cw, float* dst, int dh, int dw,
                           int mode, const float* mean, const float* stdv,
                           int flip) {
  Weights wx = compute_weights(dw, cx, cx + static_cast<double>(cw), sw, mode);
  Weights wy = compute_weights(dh, cy, cy + static_cast<double>(ch), sh, mode);

  // only the source rows the vertical pass will touch
  int ymin_all = 1 << 30, ymax_all = 0;
  for (int y = 0; y < dh; ++y) {
    ymin_all = std::min(ymin_all, wy.first[y]);
    ymax_all = std::max(ymax_all, wy.first[y] + wy.count[y]);
  }
  int rows = ymax_all - ymin_all;
  std::vector<uint8_t> tmp(static_cast<size_t>(rows) * dw * 3);

  // horizontal pass: uint8 in → uint8 strip (PIL ResampleHorizontal_8bpc)
  for (int y = 0; y < rows; ++y) {
    const uint8_t* srow = src + (static_cast<size_t>(ymin_all + y) * sw) * 3;
    for (int x = 0; x < dw; ++x) {
      const int32_t* kk = &wx.k[static_cast<size_t>(x) * wx.ksize];
      int x0 = wx.first[x], n = wx.count[x];
      int32_t acc0 = 1 << (kPrecisionBits - 1);
      int32_t acc1 = acc0, acc2 = acc0;
      for (int i = 0; i < n; ++i) {
        int col = x0 + i;
        if (flip) col = sw - 1 - col;
        const uint8_t* px = srow + static_cast<size_t>(col) * 3;
        acc0 += kk[i] * px[0];
        acc1 += kk[i] * px[1];
        acc2 += kk[i] * px[2];
      }
      uint8_t* t = &tmp[(static_cast<size_t>(y) * dw + x) * 3];
      t[0] = clip8(acc0);
      t[1] = clip8(acc1);
      t[2] = clip8(acc2);
    }
  }

  // vertical pass + float32 ToTensor/Normalize chain
  for (int y = 0; y < dh; ++y) {
    const int32_t* kk = &wy.k[static_cast<size_t>(y) * wy.ksize];
    int y0 = wy.first[y] - ymin_all, n = wy.count[y];
    for (int x = 0; x < dw; ++x) {
      int32_t acc0 = 1 << (kPrecisionBits - 1);
      int32_t acc1 = acc0, acc2 = acc0;
      for (int i = 0; i < n; ++i) {
        const uint8_t* t = &tmp[(static_cast<size_t>(y0 + i) * dw + x) * 3];
        acc0 += kk[i] * t[0];
        acc1 += kk[i] * t[1];
        acc2 += kk[i] * t[2];
      }
      const uint8_t u[3] = {clip8(acc0), clip8(acc1), clip8(acc2)};
      float* d = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = static_cast<float>(u[c]) / 255.0f;  // ToTensor
        d[c] = (v - mean[c]) / stdv[c];               // Normalize, float32
      }
    }
  }
}

void resize_normalize(const uint8_t* src, int sh, int sw, float* dst, int dh,
                      int dw, int mode, const float* mean, const float* stdv,
                      int flip) {
  crop_resize_normalize(src, sh, sw, 0, 0, sh, sw, dst, dh, dw, mode, mean,
                        stdv, flip);
}

}  // extern "C"
