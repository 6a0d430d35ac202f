// Fused augmentation warp for Hopper (sm_90a): for every output pixel, a
// 4-tap bilinear sample of the image and a nearest sample of the label at a
// float source coordinate.
//
// Replaces maxstyle_tpu/ops/warp_pallas.py::_warp_kernel (launched by
// warp_bilinear_nearest). The TPU kernel turned each gather into two-hot
// matrix products on the MXU because TPU gathers are slow; Hopper gathers
// from L2 directly, so this kernel is one thread per output pixel with
// plain loads.
//
// Semantics (those of the Pallas kernel): y0 = clip(floor(y), 0, H-1),
// y1 = clip(floor(y) + 1, 0, H-1), the same for x; the image value is zero
// outside [0, H-1] x [0, W-1]; the label takes row y1 when frac(y) >= 0.5
// (round half up) and is zero outside [-0.5, H-0.5] x [-0.5, W-0.5]. The
// arithmetic uses explicitly rounded float ops (no fused multiply-add) in
// the order of the plain PyTorch version, so the two agree bit for bit.
//
// Bound: device-memory bytes. Per call it reads the source images and
// labels (N*H*W*8 bytes) and the coordinates (N*h*w*8) once and writes
// N*h*w*8 bytes; one 224^2 source slice is 200 KB, so the four taps of
// neighbouring threads hit L2, not device memory.
//
// The entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_bilinear_nearest_kernel(const float* __restrict__ img, const int* __restrict__ lab,
                             const float* __restrict__ sy, const float* __restrict__ sx,
                             float* __restrict__ out_img, int* __restrict__ out_lab,
                             long long total, int src_h, int src_w, int out_hw) {
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (t >= total) return;
  const long long n = t / out_hw;
  const float y = __ldg(sy + t);
  const float x = __ldg(sx + t);

  const float y0f = floorf(y);
  const float x0f = floorf(x);
  const float wy = __fsub_rn(y, y0f);
  const float wx = __fsub_rn(x, x0f);
  const float hm1 = (float)(src_h - 1);
  const float wm1 = (float)(src_w - 1);
  const int y0 = (int)fminf(fmaxf(y0f, 0.0f), hm1);
  const int y1 = (int)fminf(fmaxf(__fadd_rn(y0f, 1.0f), 0.0f), hm1);
  const int x0 = (int)fminf(fmaxf(x0f, 0.0f), wm1);
  const int x1 = (int)fminf(fmaxf(__fadd_rn(x0f, 1.0f), 0.0f), wm1);

  const long long plane = n * (long long)src_h * src_w;
  const float* im = img + plane;
  const float v00 = __ldg(im + y0 * src_w + x0);
  const float v01 = __ldg(im + y0 * src_w + x1);
  const float v10 = __ldg(im + y1 * src_w + x0);
  const float v11 = __ldg(im + y1 * src_w + x1);
  const float uy = __fsub_rn(1.0f, wy);
  const float ux = __fsub_rn(1.0f, wx);
  // rows first, then columns: the order of the plain version
  const float r0 = __fadd_rn(__fmul_rn(uy, v00), __fmul_rn(wy, v10));
  const float r1 = __fadd_rn(__fmul_rn(uy, v01), __fmul_rn(wy, v11));
  const float val = __fadd_rn(__fmul_rn(r0, ux), __fmul_rn(r1, wx));
  const bool inside_b = (y >= 0.0f) && (y <= hm1) && (x >= 0.0f) && (x <= wm1);
  out_img[t] = inside_b ? val : 0.0f;

  const int yn = wy >= 0.5f ? y1 : y0;
  const int xn = wx >= 0.5f ? x1 : x0;
  const bool inside_n = (y >= -0.5f) && (y <= (float)src_h - 0.5f) &&
                        (x >= -0.5f) && (x <= (float)src_w - 0.5f);
  out_lab[t] = inside_n ? __ldg(lab + plane + yn * src_w + xn) : 0;
}

}  // namespace

extern "C" {

// img: [N, H, W] float32; lab: [N, H, W] int32; sy, sx: [N, h, w] float32;
// out_img: [N, h, w] float32; out_lab: [N, h, w] int32.
int warp_bilinear_nearest(const void* img, const void* lab, const void* sy, const void* sx,
                          void* out_img, void* out_lab, int n, int src_h, int src_w,
                          int out_h, int out_w, void* stream) {
  const long long total = (long long)n * out_h * out_w;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  warp_bilinear_nearest_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int*>(lab),
      static_cast<const float*>(sy), static_cast<const float*>(sx),
      static_cast<float*>(out_img), static_cast<int*>(out_lab), total, src_h, src_w,
      out_h * out_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
