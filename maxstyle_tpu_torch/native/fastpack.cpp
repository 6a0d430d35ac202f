// Host-side data-path kernels for the input pipeline.
//
// The reference's host pipeline is pure Python/torchsample; this framework
// moves stochastic augmentation onto the TPU and reduces the host loop to
// slice gathering + crop-or-pad + per-slice normalization. These are the
// remaining host hot spots, implemented natively and loaded via ctypes
// (maxstyle_tpu/native/__init__.py) with a transparent numpy fallback.
//
// Build: g++ -O3 -march=native -shared -fPIC fastpack.cpp -o libfastpack.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>

extern "C" {

// Center crop-or-pad a [S,H,W] float volume into [S,TH,TW]
// (basic_operations.crop_or_pad semantics: centered, zero fill).
void crop_or_pad_f32(const float* src, int64_t s, int64_t h, int64_t w,
                     float* dst, int64_t th, int64_t tw, float pad_value) {
  const int64_t src_y0 = std::max<int64_t>((h - th) / 2, 0);
  const int64_t src_x0 = std::max<int64_t>((w - tw) / 2, 0);
  const int64_t dst_y0 = std::max<int64_t>((th - h) / 2, 0);
  const int64_t dst_x0 = std::max<int64_t>((tw - w) / 2, 0);
  const int64_t cy = std::min(h, th);
  const int64_t cx = std::min(w, tw);
  for (int64_t k = 0; k < s; ++k) {
    float* dslice = dst + k * th * tw;
    const float* sslice = src + k * h * w;
    std::fill(dslice, dslice + th * tw, pad_value);
    for (int64_t y = 0; y < cy; ++y) {
      std::memcpy(dslice + (dst_y0 + y) * tw + dst_x0,
                  sslice + (src_y0 + y) * w + src_x0, cx * sizeof(float));
    }
  }
}

void crop_or_pad_i32(const int32_t* src, int64_t s, int64_t h, int64_t w,
                     int32_t* dst, int64_t th, int64_t tw, int32_t pad_value) {
  const int64_t src_y0 = std::max<int64_t>((h - th) / 2, 0);
  const int64_t src_x0 = std::max<int64_t>((w - tw) / 2, 0);
  const int64_t dst_y0 = std::max<int64_t>((th - h) / 2, 0);
  const int64_t dst_x0 = std::max<int64_t>((tw - w) / 2, 0);
  const int64_t cy = std::min(h, th);
  const int64_t cx = std::min(w, tw);
  for (int64_t k = 0; k < s; ++k) {
    int32_t* dslice = dst + k * th * tw;
    const int32_t* sslice = src + k * h * w;
    std::fill(dslice, dslice + th * tw, pad_value);
    for (int64_t y = 0; y < cy; ++y) {
      std::memcpy(dslice + (dst_y0 + y) * tw + dst_x0,
                  sslice + (src_y0 + y) * w + src_x0, cx * sizeof(int32_t));
    }
  }
}

// Per-slice min-max normalization to [0,1] of a [S,H,W] volume in place.
void minmax_norm_slices_f32(float* vol, int64_t s, int64_t hw, float eps) {
  for (int64_t k = 0; k < s; ++k) {
    float* sl = vol + k * hw;
    float mn = std::numeric_limits<float>::infinity();
    float mx = -std::numeric_limits<float>::infinity();
    for (int64_t i = 0; i < hw; ++i) {
      mn = std::min(mn, sl[i]);
      mx = std::max(mx, sl[i]);
    }
    const float inv = 1.0f / (mx - mn + eps);
    for (int64_t i = 0; i < hw; ++i) sl[i] = (sl[i] - mn) * inv;
  }
}

// Gather selected [H,W] slices from a set of equally-shaped volumes into a
// packed batch: for each i, copy volumes[vol_idx[i]][slice_idx[i]] into
// out[i]. `volumes` is an array of base pointers.
void gather_pack_f32(const float* const* volumes, const int64_t* vol_idx,
                     const int64_t* slice_idx, int64_t n, int64_t h, int64_t w,
                     float* out) {
  const int64_t hw = h * w;
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * hw, volumes[vol_idx[i]] + slice_idx[i] * hw,
                hw * sizeof(float));
  }
}

}  // extern "C"
