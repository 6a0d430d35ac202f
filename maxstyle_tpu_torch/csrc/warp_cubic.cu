// Cubic augmentation warp for Hopper (sm_90a): for every output pixel, a
// 16-tap cubic B-spline sample of prefiltered spline coefficients and a
// nearest sample of the label at a float source coordinate.
//
// Replaces maxstyle_tpu/ops/warp_pallas.py::_warp_cubic_kernel (launched by
// warp_cubic_nearest, after the spline prefilter). The TPU kernel built
// four-hot interpolation matrices and ran the taps as MXU products because
// TPU gathers are slow; Hopper gathers from L2, so this kernel is one thread
// per output pixel with 16 plain loads.
//
// Semantics (those of the Pallas kernel and of ops/spline.sample_cubic):
// taps at floor-1 .. floor+2 on each axis, mirrored at the rim
// (idx < 0 -> -idx, idx > n-1 -> 2(n-1) - idx, then clipped); the image is
// zero outside [0, H-1] x [0, W-1]; the label takes
// clip(floor(y) + (frac(y) >= 0.5), 0, H-1) (round half up) and is zero
// outside [-0.5, H-0.5] x [-0.5, W-0.5]. floor is held to [-2, n+1] before
// it becomes an index, so far-outside coordinates index safely (they are
// masked). Where two taps mirror onto one index their terms add one by one;
// the TPU's four-hot matrix summed their weights first. The arithmetic uses
// explicitly rounded float ops (no fused multiply-add) in the order of the
// plain PyTorch version, so the two agree bit for bit.
//
// Bound: device-memory bytes. Per call it reads the coefficients and labels
// (N*H*W*8 bytes) and the coordinates (N*h*w*8) once and writes N*h*w*8
// bytes; one 288^2 coefficient plane is 324 KB, so the 16 taps of
// neighbouring threads hit L2, not device memory.
//
// The entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kSixth = 1.0f / 6.0f;

__device__ __forceinline__ void bspline_weights(float t, float w[4]) {
  const float t2 = __fmul_rn(t, t);
  const float t3 = __fmul_rn(t2, t);
  // ((1 - 3t) + 3t^2) - t^3, (4 - 6t^2) + 3t^3, ((1 + 3t) + 3t^2) - 3t^3, t^3
  w[0] = __fmul_rn(__fsub_rn(__fadd_rn(__fsub_rn(1.0f, __fmul_rn(3.0f, t)),
                                       __fmul_rn(3.0f, t2)), t3), kSixth);
  w[1] = __fmul_rn(__fadd_rn(__fsub_rn(4.0f, __fmul_rn(6.0f, t2)), __fmul_rn(3.0f, t3)),
                   kSixth);
  w[2] = __fmul_rn(__fsub_rn(__fadd_rn(__fadd_rn(1.0f, __fmul_rn(3.0f, t)),
                                       __fmul_rn(3.0f, t2)), __fmul_rn(3.0f, t3)), kSixth);
  w[3] = __fmul_rn(t3, kSixth);
}

__device__ __forceinline__ int reflect(int idx, int n) {
  idx = idx < 0 ? -idx : idx;
  idx = idx > n - 1 ? 2 * (n - 1) - idx : idx;
  return min(max(idx, 0), n - 1);
}

__global__ void __launch_bounds__(kThreads)
warp_cubic_nearest_kernel(const float* __restrict__ coef, const int* __restrict__ lab,
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
  const float fy = __fsub_rn(y, y0f);
  const float fx = __fsub_rn(x, x0f);
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)(src_h + 1));
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)(src_w + 1));
  float wy[4], wx[4];
  bspline_weights(fy, wy);
  bspline_weights(fx, wx);

  const long long plane = n * (long long)src_h * src_w;
  const float* c = coef + plane;
  int cols[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) cols[j] = reflect(x0 + j - 1, src_w);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* row = c + (long long)reflect(y0 + i - 1, src_h) * src_w;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wy[i], wx[j]), __ldg(row + cols[j])));
  }
  const bool inside_c = (y >= 0.0f) && (y <= (float)(src_h - 1)) &&
                        (x >= 0.0f) && (x <= (float)(src_w - 1));
  out_img[t] = inside_c ? acc : 0.0f;

  const int yn = min(max(y0 + (fy >= 0.5f ? 1 : 0), 0), src_h - 1);
  const int xn = min(max(x0 + (fx >= 0.5f ? 1 : 0), 0), src_w - 1);
  const bool inside_n = (y >= -0.5f) && (y <= (float)src_h - 0.5f) &&
                        (x >= -0.5f) && (x <= (float)src_w - 0.5f);
  out_lab[t] = inside_n ? __ldg(lab + plane + (long long)yn * src_w + xn) : 0;
}

}  // namespace

extern "C" {

// coef: [N, H, W] float32 spline coefficients; lab: [N, H, W] int32;
// sy, sx: [N, h, w] float32; out_img: [N, h, w] float32; out_lab: [N, h, w] int32.
int warp_cubic_nearest(const void* coef, const void* lab, const void* sy, const void* sx,
                       void* out_img, void* out_lab, int n, int src_h, int src_w, int out_h,
                       int out_w, void* stream) {
  const long long total = (long long)n * out_h * out_w;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  warp_cubic_nearest_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coef), static_cast<const int*>(lab),
      static_cast<const float*>(sy), static_cast<const float*>(sx),
      static_cast<float*>(out_img), static_cast<int*>(out_lab), total, src_h, src_w,
      out_h * out_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
