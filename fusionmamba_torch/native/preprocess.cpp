// Native preprocessing kernels for the data pipeline (C++/OpenMP, ctypes ABI).
//
// The reference's data pipeline does its hot work (bicubic resize, RGB->gray,
// /255 normalize) in Python workers (`TaskFusion_dataset.py:242-302`,
// 16-process DataLoader). Here the same math runs in-process in C++ threads,
// GIL-free, with PIL-exact semantics so outputs are bit-comparable:
//
//  * resize_bicubic_*: PIL's separable convolution resampling with the
//    bicubic kernel (a = -0.5) and PIL's downscale support widening
//    (filterscale = in/out when > 1), matching Image.resize(..., BICUBIC).
//  * rgb_to_gray: ITU-R BT.601 luma, cv2.COLOR_RGB2GRAY rounding.
//  * normalize_u8_to_f32: /255 with optional transpose-free channel expand.
//
// Build: see native/Makefile (g++ -O3 -march=native -fopenmp -shared -fPIC).
// Python binding: fusionmamba_tpu/data/native.py (ctypes, with pure-Python
// fallback when the .so is absent).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// PIL bicubic kernel, a = -0.5 (PIL's _i2f BICUBIC filter)
inline double bicubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct FilterBank {
  // For each output pixel: first input index + normalized weights
  std::vector<int> bounds_min;
  std::vector<int> bounds_size;
  std::vector<double> weights;  // row-major [out, ksize]
  int ksize;
};

// Mirrors PIL's precompute_coeffs (ImagingResampleHorizontal logic)
FilterBank build_filter(int in_size, int out_size) {
  constexpr double support_base = 2.0;  // bicubic support
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = support_base * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  FilterBank fb;
  fb.ksize = ksize;
  fb.bounds_min.resize(out_size);
  fb.bounds_size.resize(out_size);
  fb.weights.assign(static_cast<size_t>(out_size) * ksize, 0.0);

  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &fb.weights[static_cast<size_t>(xx) * ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double w = bicubic((x + xmin - center + 0.5) / filterscale);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0) {
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    }
    fb.bounds_min[xx] = xmin;
    fb.bounds_size[xx] = xmax;
  }
  return fb;
}

inline uint8_t clip8(double v) {
  if (v <= 0.0) return 0;
  if (v >= 255.0) return 255;
  return static_cast<uint8_t>(v + 0.5);
}

}  // namespace

extern "C" {

// Resize a single-channel (or interleaved multi-channel) uint8 image with
// PIL-BICUBIC semantics. src: (in_h, in_w, ch) row-major; dst likewise.
void resize_bicubic_u8(const uint8_t* src, int in_h, int in_w, int ch,
                       uint8_t* dst, int out_h, int out_w) {
  FilterBank fh = build_filter(in_w, out_w);
  FilterBank fv = build_filter(in_h, out_h);

  // horizontal pass (PIL resamples horizontal first and stores the
  // intermediate as clipped uint8 -- overshoot from the bicubic negative
  // lobes is clamped between passes, which is observable at hard edges)
  std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * ch);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * in_w * ch;
    uint8_t* trow = &tmp[static_cast<size_t>(y) * out_w * ch];
    for (int xx = 0; xx < out_w; ++xx) {
      const double* k = &fh.weights[static_cast<size_t>(xx) * fh.ksize];
      int xmin = fh.bounds_min[xx];
      int xsz = fh.bounds_size[xx];
      for (int c = 0; c < ch; ++c) {
        double acc = 0.0;
        for (int x = 0; x < xsz; ++x) {
          acc += srow[(xmin + x) * ch + c] * k[x];
        }
        trow[xx * ch + c] = clip8(acc);
      }
    }
  }

  // vertical pass
#pragma omp parallel for schedule(static)
  for (int yy = 0; yy < out_h; ++yy) {
    const double* k = &fv.weights[static_cast<size_t>(yy) * fv.ksize];
    int ymin = fv.bounds_min[yy];
    int ysz = fv.bounds_size[yy];
    uint8_t* drow = dst + static_cast<size_t>(yy) * out_w * ch;
    for (int xx = 0; xx < out_w * ch; ++xx) {
      double acc = 0.0;
      for (int y = 0; y < ysz; ++y) {
        acc += tmp[static_cast<size_t>(ymin + y) * out_w * ch + xx] * k[y];
      }
      drow[xx] = clip8(acc);
    }
  }
}

// ITU-R BT.601 luma with cv2-style rounding: (H, W, 3) u8 -> (H, W) u8
void rgb_to_gray_u8(const uint8_t* rgb, int h, int w, uint8_t* gray) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < h * w; ++i) {
    double v = 0.299 * rgb[i * 3] + 0.587 * rgb[i * 3 + 1] +
               0.114 * rgb[i * 3 + 2];
    gray[i] = clip8(v);
  }
}

// u8 -> f32 / 255
void normalize_u8_to_f32(const uint8_t* src, int n, float* dst) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    dst[i] = src[i] * (1.0f / 255.0f);
  }
}

// fused path: resize(gray or rgb->gray) + /255 expand to (out_h, out_w, 1)
void preprocess_pair_item(const uint8_t* rgb, int rh, int rw,
                          const uint8_t* ir, int ih, int iw,
                          int out_h, int out_w,
                          float* vis_y_out, float* ir_out) {
  std::vector<uint8_t> rgb_rs(static_cast<size_t>(out_h) * out_w * 3);
  std::vector<uint8_t> ir_rs(static_cast<size_t>(out_h) * out_w);
  std::vector<uint8_t> gray(static_cast<size_t>(out_h) * out_w);
  resize_bicubic_u8(rgb, rh, rw, 3, rgb_rs.data(), out_h, out_w);
  resize_bicubic_u8(ir, ih, iw, 1, ir_rs.data(), out_h, out_w);
  rgb_to_gray_u8(rgb_rs.data(), out_h, out_w, gray.data());
  normalize_u8_to_f32(gray.data(), out_h * out_w, vis_y_out);
  normalize_u8_to_f32(ir_rs.data(), out_h * out_w, ir_out);
}

int preprocess_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
