// Cubic augmentation warp for Hopper (sm_90a): for every output pixel, a
// 16-tap cubic B-spline sample of prefiltered spline coefficients and a
// nearest sample of the label at a float source coordinate.
//
// Replaces maxstyle_tpu/ops/warp_pallas.py::_warp_cubic_kernel (launched by
// warp_cubic_nearest, after the spline prefilter). The TPU kernel built
// four-hot interpolation matrices and ran the taps as MXU products because
// TPU gathers are slow; on Hopper the taps are plain loads.
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
// bytes.
//
// Design: besides its bytes, a pixel costs 17 gathers through L1 and some
// two hundred instructions of weights and mirrored indices, so the kernel
// keeps work in flight: a block of 32 x 4 threads takes a 32 x 8 tile of
// one image's output, two pixels a thread (rows ty and ty + 4), so both
// pixels' 17 loads are in flight at once and a warp's taps fall on a few
// neighbouring source rows. A pixel outside the label range has both
// outputs masked and reads nothing. Staging each tile's source window in
// shared memory (cp.async, then every tap from there) measured slower on
// the H100 at the augmentation's coordinates (PERF.md, section 6).
//
// The entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;                    // output columns a block (one warp)
constexpr int kRowsPerPass = 4;               // warps a block
constexpr int kPixels = 2;                    // output pixels a thread, kRowsPerPass rows apart
constexpr int kTileH = kRowsPerPass * kPixels;
constexpr int kThreads = kTileW * kRowsPerPass;
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

__device__ __forceinline__ bool inside_label(float y, float x, int h, int w) {
  return (y >= -0.5f) && (y <= (float)h - 0.5f) && (x >= -0.5f) && (x <= (float)w - 0.5f);
}

// The image sample and the label of one pixel at (y, x) of the plane whose
// coefficients start at c and labels at l.
__device__ __forceinline__ void sample_pixel(const float* __restrict__ c,
                                             const int* __restrict__ l, float y, float x,
                                             int src_h, int src_w, float& img, int& label) {
  img = 0.0f;
  label = 0;
  if (!inside_label(y, x, src_h, src_w)) return;  // both outputs masked: read nothing
  const float y0f = floorf(y);
  const float x0f = floorf(x);
  const float fy = __fsub_rn(y, y0f);
  const float fx = __fsub_rn(x, x0f);
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)(src_h + 1));
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)(src_w + 1));
  float wy[4], wx[4];
  bspline_weights(fy, wy);
  bspline_weights(fx, wx);
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
  img = inside_c ? acc : 0.0f;
  const int yn = min(max(y0 + (fy >= 0.5f ? 1 : 0), 0), src_h - 1);
  const int xn = min(max(x0 + (fx >= 0.5f ? 1 : 0), 0), src_w - 1);
  label = __ldg(l + (long long)yn * src_w + xn);
}

__global__ void __launch_bounds__(kThreads)
warp_cubic_nearest_kernel(const float* __restrict__ coef, const int* __restrict__ lab,
                          const float* __restrict__ sy, const float* __restrict__ sx,
                          float* __restrict__ out_img, int* __restrict__ out_lab, int src_h,
                          int src_w, int out_h, int out_w) {
  const int n = blockIdx.z;
  const int ox = blockIdx.x * kTileW + threadIdx.x;
  const long long src_plane = (long long)n * src_h * src_w;
  float y[kPixels], x[kPixels];
  long long t[kPixels];
  bool valid[kPixels];
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const int oy = blockIdx.y * kTileH + threadIdx.y + k * kRowsPerPass;
    valid[k] = ox < out_w && oy < out_h;
    t[k] = ((long long)n * out_h + oy) * out_w + ox;
    y[k] = valid[k] ? __ldg(sy + t[k]) : -1.0f;  // -1 lies outside the label range
    x[k] = valid[k] ? __ldg(sx + t[k]) : -1.0f;
  }
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    float img;
    int label;
    sample_pixel(coef + src_plane, lab + src_plane, y[k], x[k], src_h, src_w, img, label);
    if (valid[k]) {
      out_img[t[k]] = img;
      out_lab[t[k]] = label;
    }
  }
}

}  // namespace

extern "C" {

// coef: [N, H, W] float32 spline coefficients; lab: [N, H, W] int32;
// sy, sx: [N, h, w] float32; out_img: [N, h, w] float32; out_lab: [N, h, w] int32.
int warp_cubic_nearest(const void* coef, const void* lab, const void* sy, const void* sx,
                       void* out_img, void* out_lab, int n, int src_h, int src_w, int out_h,
                       int out_w, void* stream) {
  if (n <= 0 || n > 65535 || src_h <= 0 || src_w <= 0 || out_h <= 0 || out_w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((out_w + kTileW - 1) / kTileW, (out_h + kTileH - 1) / kTileH, n);
  warp_cubic_nearest_kernel<<<grid, dim3(kTileW, kRowsPerPass), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coef), static_cast<const int*>(lab),
      static_cast<const float*>(sy), static_cast<const float*>(sx),
      static_cast<float*>(out_img), static_cast<int*>(out_lab), src_h, src_w, out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
