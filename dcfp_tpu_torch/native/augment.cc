// Native data-path kernels for the input pipeline.
//
// The reference's augmentation tail (datasets/Base.py:91-96 input_transform
// + :184-201 crop_img + :255-258 flip) makes ~6 full passes over the image
// (float cast, BGR reverse, /255, -mean, /std, copyMakeBorder, crop copy,
// flip copy) with intermediate allocations.  fused_crop_normalize does the
// whole thing in ONE pass that only touches the output crop:
//
//   out[y, x, c] = ((img[y+off_h, W(x), 2-c] / 255) - mean[c]) / std[c]
//   (out-of-bounds source pixels -> 0.0, the reference's pad value applied
//    post-normalization; W mirrors x when flip)
//
// Bitwise-identical to the numpy float32 path (same op order, f32
// throughout).  Built at first use by dcfp_tpu_torch/native/__init__.py
// with g++ -O3; bound via ctypes (no pybind11 dependency).

#include <cstdint>

extern "C" {

// img: uint8 HWC, BGR (OpenCV layout), h x w x 3
// out: float32 crop_h x crop_w x 3, RGB normalized
void fused_crop_normalize(const uint8_t* img, int64_t h, int64_t w,
                          int64_t off_h, int64_t off_w,
                          int64_t crop_h, int64_t crop_w, int flip,
                          const float* mean, const float* stddev,
                          float* out) {
  const float inv255 = 0.0f;  // unused; division kept for bit-exactness
  (void)inv255;
  for (int64_t y = 0; y < crop_h; ++y) {
    const int64_t sy = y + off_h;
    float* orow = out + y * crop_w * 3;
    if (sy < 0 || sy >= h) {
      for (int64_t x = 0; x < crop_w * 3; ++x) orow[x] = 0.0f;
      continue;
    }
    const uint8_t* srow = img + sy * w * 3;
    for (int64_t x = 0; x < crop_w; ++x) {
      const int64_t ox = flip ? (crop_w - 1 - x) : x;
      const int64_t sx = x + off_w;
      float* opix = orow + ox * 3;
      if (sx < 0 || sx >= w) {
        opix[0] = opix[1] = opix[2] = 0.0f;
        continue;
      }
      const uint8_t* spix = srow + sx * 3;
      // BGR -> RGB, /255, -mean, /std — all f32, matching numpy op order
      for (int c = 0; c < 3; ++c) {
        float v = static_cast<float>(spix[2 - c]);
        v = v / 255.0f;
        v = v - mean[c];
        v = v / stddev[c];
        opix[c] = v;
      }
    }
  }
}

// label: int64 h x w; out: int64 crop_h x crop_w with pad -> ignore_label
void fused_crop_label(const int64_t* label, int64_t h, int64_t w,
                      int64_t off_h, int64_t off_w,
                      int64_t crop_h, int64_t crop_w, int flip,
                      int64_t ignore_label, int64_t* out) {
  for (int64_t y = 0; y < crop_h; ++y) {
    const int64_t sy = y + off_h;
    int64_t* orow = out + y * crop_w;
    for (int64_t x = 0; x < crop_w; ++x) {
      const int64_t ox = flip ? (crop_w - 1 - x) : x;
      const int64_t sx = x + off_w;
      orow[ox] = (sy < 0 || sy >= h || sx < 0 || sx >= w)
                     ? ignore_label
                     : label[sy * w + sx];
    }
  }
}

// 256-entry LUT remap of a uint8 label map to int64 train ids
// (the id2trainId hot path, datasets/CSdatasets.py:71-79)
void label_lut_remap(const uint8_t* label, int64_t n, const int64_t* lut,
                     int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = lut[label[i]];
}

// Atomic add of one to a call counter that may live in memory shared
// with forked processes (the decode workers of the data loaders).
void count_call(int64_t* slot) {
  __atomic_fetch_add(slot, 1, __ATOMIC_RELAXED);
}

}  // extern "C"
