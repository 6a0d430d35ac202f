// Fused augmentation warp for Hopper (sm_90a): for every output pixel, a
// 4-tap bilinear sample of the image and a nearest sample of the label at a
// float source coordinate.
//
// Replaces maxstyle_tpu/ops/warp_pallas.py::_warp_kernel (launched by
// warp_bilinear_nearest). The TPU kernel turned each gather into two-hot
// matrix products on the MXU because TPU gathers are slow; Hopper gathers
// from L1 and L2 directly, so the taps are plain loads.
//
// Two entry points share one kernel template and its sampling functions:
//
// * warp_bilinear_nearest takes the source coordinates sy, sx [N, h, w]
//   (the JAX kernel's contract);
// * warp_bilinear_nearest_affine composes each pixel's coordinates in
//   registers from the inverse affine [N, 2, 3], the crop offsets oy, ox
//   [N] and, when given, the smoothed elastic field [N, 2, H, W] times
//   alpha [N] times the gate [N], so the coordinates never reach device
//   memory. This is what the augmentation's "kernel" backend runs.
//
// Semantics (those of the Pallas kernel): y0 = clip(floor(y), 0, H-1),
// y1 = clip(floor(y) + 1, 0, H-1), the same for x; the image value is zero
// outside [0, H-1] x [0, W-1]; the label takes row y1 when frac(y) >= 0.5
// (round half up) and is zero outside [-0.5, H-0.5] x [-0.5, W-0.5]. A pixel
// outside the label range reads nothing. The arithmetic uses explicitly
// rounded float ops (no fused multiply-add) in the order of the plain
// PyTorch versions (ops/warp_kernels.py: compose_coords, then
// warp_bilinear_nearest_plain), so the two agree bit for bit.
//
// Bound: device-memory bytes. Per call it reads the source images and
// labels (N*H*W*8 bytes), the coordinates or the field's crop window
// (N*h*w*8) and writes N*h*w*8 bytes; one 224^2 source slice is 200 KB, so
// the four taps of neighbouring threads hit L1 or L2, not device memory.
//
// Design: a block of 256 threads takes a 64-column tile of kThreads/(64/PX)
// rows of one image's output, PX consecutive pixels a thread, indexed from
// blockIdx (no 64-bit division). A thread first loads all its coordinates
// (as one vector where the row's alignment allows) or field values, then
// computes all its taps, then issues all 5*PX gathers before it blends, so
// its memory trips overlap. PX is fixed for each entry, the fastest measured
// on the H100 (PERF.md, section 6): 1 at given coordinates, 4 composed.
//
// The composed entry clamps the origin of its field window to the source (the
// crop window must lie inside it, as the augmentation's draws make it), so an
// offset out of range reads no memory outside the field.
//
// The entry points return cudaGetLastError() right after their launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 64;       // output columns a block
constexpr int kCoordsPx = 1;     // pixels a thread, coordinate entry
constexpr int kComposedPx = 4;   // pixels a thread, composed entry

struct Params {
  const float* img;  // [N, H, W]
  const int* lab;    // [N, H, W]
  // coordinate entry
  const float* sy;  // [N, h, w]
  const float* sx;
  // composed entry
  const float* mat;      // [N, 2, 3]
  const long long* oy;   // [N]
  const long long* ox;   // [N]
  const float* sm;       // [N, 2, H, W] or null: no elastic term
  const float* alpha;    // [N]
  const float* gate;     // [N]
  float* out_img;        // [N, h, w]
  int* out_lab;          // [N, h, w]
  int src_h, src_w, out_h, out_w;
  float cy, cx;  // the source's centre, (H - 1) / 2 and (W - 1) / 2
  bool vec;      // out_w % PX == 0 and every per-pixel pointer aligned to PX floats
};

// Offsets and weights of one pixel's taps.
struct Taps {
  int o00, o01, o10, o11, on;
  float wy, wx;
  bool in_b, in_n;
};

struct Gathered {
  float v00, v01, v10, v11;
  int l;
};

__device__ __forceinline__ Taps taps_at(float y, float x, int src_h, int src_w) {
  Taps t;
  const float y0f = floorf(y);
  const float x0f = floorf(x);
  t.wy = __fsub_rn(y, y0f);
  t.wx = __fsub_rn(x, x0f);
  const float hm1 = (float)(src_h - 1);
  const float wm1 = (float)(src_w - 1);
  const int y0 = (int)fminf(fmaxf(y0f, 0.0f), hm1);
  const int y1 = (int)fminf(fmaxf(__fadd_rn(y0f, 1.0f), 0.0f), hm1);
  const int x0 = (int)fminf(fmaxf(x0f, 0.0f), wm1);
  const int x1 = (int)fminf(fmaxf(__fadd_rn(x0f, 1.0f), 0.0f), wm1);
  t.o00 = y0 * src_w + x0;
  t.o01 = y0 * src_w + x1;
  t.o10 = y1 * src_w + x0;
  t.o11 = y1 * src_w + x1;
  t.on = (t.wy >= 0.5f ? y1 : y0) * src_w + (t.wx >= 0.5f ? x1 : x0);
  t.in_b = (y >= 0.0f) && (y <= hm1) && (x >= 0.0f) && (x <= wm1);
  t.in_n = (y >= -0.5f) && (y <= (float)src_h - 0.5f) && (x >= -0.5f) &&
           (x <= (float)src_w - 0.5f);
  return t;
}

__device__ __forceinline__ Gathered gather(const float* __restrict__ im,
                                           const int* __restrict__ lb, const Taps& t) {
  Gathered g{0.0f, 0.0f, 0.0f, 0.0f, 0};
  if (t.in_n) {  // the label range holds the image range
    g.v00 = __ldg(im + t.o00);
    g.v01 = __ldg(im + t.o01);
    g.v10 = __ldg(im + t.o10);
    g.v11 = __ldg(im + t.o11);
    g.l = __ldg(lb + t.on);
  }
  return g;
}

// rows first, then columns: the order of the plain version
__device__ __forceinline__ float blend(const Taps& t, const Gathered& g) {
  const float uy = __fsub_rn(1.0f, t.wy);
  const float ux = __fsub_rn(1.0f, t.wx);
  const float r0 = __fadd_rn(__fmul_rn(uy, g.v00), __fmul_rn(t.wy, g.v10));
  const float r1 = __fadd_rn(__fmul_rn(uy, g.v01), __fmul_rn(t.wy, g.v11));
  const float val = __fadd_rn(__fmul_rn(r0, ux), __fmul_rn(r1, t.wx));
  return t.in_b ? val : 0.0f;
}

template <int PX> struct Vec;
template <> struct Vec<1> { using F = float; using I = int; };
template <> struct Vec<4> { using F = float4; using I = int4; };

template <int PX>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float v[PX]) {
  const typename Vec<PX>::F t = __ldg(reinterpret_cast<const typename Vec<PX>::F*>(p));
  memcpy(v, &t, sizeof(t));
}

template <int PX>
__device__ __forceinline__ void store_row(float* p, const float v[PX], int* q, const int l[PX]) {
  typename Vec<PX>::F t;
  typename Vec<PX>::I u;
  memcpy(&t, v, sizeof(t));
  memcpy(&u, l, sizeof(u));
  *reinterpret_cast<typename Vec<PX>::F*>(p) = t;
  *reinterpret_cast<typename Vec<PX>::I*>(q) = u;
}

// A coordinate far outside every range: the pixel reads and writes nothing.
constexpr float kFar = -1e30f;

template <int PX, bool kComposed>
__global__ void __launch_bounds__(kThreads) warp_bilinear_nearest_kernel(const Params p) {
  constexpr int kCols = kTileW / PX;       // threads along a row
  constexpr int kRows = kThreads / kCols;  // rows a block
  const int n = blockIdx.z;
  const int i = blockIdx.y * kRows + threadIdx.x / kCols;
  const int j0 = blockIdx.x * kTileW + (threadIdx.x % kCols) * PX;
  if (i >= p.out_h || j0 >= p.out_w) return;
  const long long out_off = ((long long)n * p.out_h + i) * p.out_w + j0;
  const bool whole = p.vec;  // all PX pixels exist and the row is aligned

  // 1. coordinates
  float y[PX], x[PX];
  if constexpr (kComposed) {
    const float* m = p.mat + 6 * n;
    const float m00 = __ldg(m), m01 = __ldg(m + 1), m02 = __ldg(m + 2);
    const float m10 = __ldg(m + 3), m11 = __ldg(m + 4), m12 = __ldg(m + 5);
    const long long oyi = __ldg(p.oy + n);
    const long long oxi = __ldg(p.ox + n);
    const float oy = (float)oyi;
    const float ox = (float)oxi;
    float fy[PX], fx[PX];
    float a = 0.0f, g = 0.0f;
    if (p.sm != nullptr) {
      a = __ldg(p.alpha + n);
      g = __ldg(p.gate + n);
      const long long plane = (long long)p.src_h * p.src_w;
      // the window's origin, clamped so that the window lies inside the field
      const long long wy = min(max(oyi, 0LL), (long long)(p.src_h - p.out_h));
      const long long wx = min(max(oxi, 0LL), (long long)(p.src_w - p.out_w));
      const float* f0 = p.sm + 2 * n * plane + (wy + i) * p.src_w + wx + j0;
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const bool ok = whole || j0 + k < p.out_w;
        fy[k] = ok ? __ldg(f0 + k) : 0.0f;
        fx[k] = ok ? __ldg(f0 + plane + k) : 0.0f;
      }
    }
    // ty_c = (i + oy) - cy; sy = ((m00 ty_c + m01 tx_c) + m02) + cy
    const float tyc = __fsub_rn(__fadd_rn((float)i, oy), p.cy);
    const float ay = __fmul_rn(m00, tyc);
    const float ax = __fmul_rn(m10, tyc);
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      const float txc = __fsub_rn(__fadd_rn((float)(j0 + k), ox), p.cx);
      float yy = __fadd_rn(__fadd_rn(__fadd_rn(ay, __fmul_rn(m01, txc)), m02), p.cy);
      float xx = __fadd_rn(__fadd_rn(__fadd_rn(ax, __fmul_rn(m11, txc)), m12), p.cx);
      if (p.sm != nullptr) {  // + (field * alpha) * gate
        yy = __fadd_rn(yy, __fmul_rn(__fmul_rn(fy[k], a), g));
        xx = __fadd_rn(xx, __fmul_rn(__fmul_rn(fx[k], a), g));
      }
      const bool ok = whole || j0 + k < p.out_w;
      y[k] = ok ? yy : kFar;
      x[k] = ok ? xx : kFar;
    }
  } else {
    if (whole) {
      load_row<PX>(p.sy + out_off, y);
      load_row<PX>(p.sx + out_off, x);
    } else {
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const bool ok = j0 + k < p.out_w;
        y[k] = ok ? __ldg(p.sy + out_off + k) : kFar;
        x[k] = ok ? __ldg(p.sx + out_off + k) : kFar;
      }
    }
  }

  // 2. taps, 3. every gather, 4. blend
  const long long src_off = (long long)n * p.src_h * p.src_w;
  const float* im = p.img + src_off;
  const int* lb = p.lab + src_off;
  Taps t[PX];
  Gathered g[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) t[k] = taps_at(y[k], x[k], p.src_h, p.src_w);
#pragma unroll
  for (int k = 0; k < PX; ++k) g[k] = gather(im, lb, t[k]);
  float v[PX];
  int l[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    v[k] = blend(t[k], g[k]);
    l[k] = g[k].l;
  }

  if (whole) {
    store_row<PX>(p.out_img + out_off, v, p.out_lab + out_off, l);
  } else {
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      if (j0 + k < p.out_w) {
        p.out_img[out_off + k] = v[k];
        p.out_lab[out_off + k] = l[k];
      }
    }
  }
}

template <int PX, bool kComposed>
int launch(const Params& p, int n, cudaStream_t stream) {
  constexpr int kRows = kThreads / (kTileW / PX);
  const dim3 grid((p.out_w + kTileW - 1) / kTileW, (p.out_h + kRows - 1) / kRows, n);
  warp_bilinear_nearest_kernel<PX, kComposed><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, int px) {
  return reinterpret_cast<std::uintptr_t>(ptr) % (sizeof(float) * px) == 0;
}

template <int PX, bool kComposed>
int dispatch(Params p, int n, void* stream) {
  if (n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  p.cy = (float)((p.src_h - 1) / 2.0);
  p.cx = (float)((p.src_w - 1) / 2.0);
  p.vec = p.out_w % PX == 0 && aligned(p.out_img, PX) && aligned(p.out_lab, PX) &&
          (kComposed || (aligned(p.sy, PX) && aligned(p.sx, PX)));
  return launch<PX, kComposed>(p, n, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// img: [N, H, W] float32; lab: [N, H, W] int32; sy, sx: [N, h, w] float32;
// out_img: [N, h, w] float32; out_lab: [N, h, w] int32.
int warp_bilinear_nearest(const void* img, const void* lab, const void* sy, const void* sx,
                          void* out_img, void* out_lab, int n, int src_h, int src_w,
                          int out_h, int out_w, void* stream) {
  Params p{};
  p.img = static_cast<const float*>(img);
  p.lab = static_cast<const int*>(lab);
  p.sy = static_cast<const float*>(sy);
  p.sx = static_cast<const float*>(sx);
  p.out_img = static_cast<float*>(out_img);
  p.out_lab = static_cast<int*>(out_lab);
  p.src_h = src_h;
  p.src_w = src_w;
  p.out_h = out_h;
  p.out_w = out_w;
  return dispatch<kCoordsPx, false>(p, n, stream);
}

// img, lab, out_img, out_lab as above; mat: [N, 2, 3] float32 (target ->
// source, centred coordinates); oy, ox: [N] int64 crop offsets, with
// 0 <= oy, oy + h <= H, 0 <= ox and ox + w <= W; sm: [N, 2, H, W] float32 smoothed field, or
// null for none (then alpha and gate are not read); alpha, gate: [N] float32.
int warp_bilinear_nearest_affine(const void* img, const void* lab, const void* mat,
                                 const void* oy, const void* ox, const void* sm,
                                 const void* alpha, const void* gate, void* out_img,
                                 void* out_lab, int n, int src_h, int src_w, int out_h,
                                 int out_w, void* stream) {
  Params p{};
  p.img = static_cast<const float*>(img);
  p.lab = static_cast<const int*>(lab);
  p.mat = static_cast<const float*>(mat);
  p.oy = static_cast<const long long*>(oy);
  p.ox = static_cast<const long long*>(ox);
  p.sm = static_cast<const float*>(sm);
  p.alpha = static_cast<const float*>(alpha);
  p.gate = static_cast<const float*>(gate);
  p.out_img = static_cast<float*>(out_img);
  p.out_lab = static_cast<int*>(out_lab);
  p.src_h = src_h;
  p.src_w = src_w;
  p.out_h = out_h;
  p.out_w = out_w;
  return dispatch<kComposedPx, true>(p, n, stream);
}

}  // extern "C"
