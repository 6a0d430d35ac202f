// Fused 3x3 convolution + BatchNorm statistics for Hopper (sm_90a): a
// same-padding, stride-1 3x3 convolution with bias, NCHW float32, whose
// epilogue sums y and y^2 per output channel.
//
// Replaces scripts/proto_conv_bn_fusion.py::_kernel (launched by
// conv3x3_bn_stats_pallas). The Pallas grid ran its batch steps in order and
// carried the channel sums from step to step in its output block; on Hopper
// blocks run in no order, so each block reduces its own partial sums (warp
// shuffles, then shared memory) and adds them into a zeroed [2, Cout] float64
// buffer with one atomicAdd per channel and sum. Float64 accumulation keeps
// the run-to-run order of those additions below float32 rounding, and keeps
// E[y^2] - mean^2 free of cancellation at 737k values a channel.
//
// Design (simple and correct first): a block computes a 16x16 output tile of
// one image for 16 output channels, one pixel per thread, 16 accumulators a
// thread. Input channels are staged in chunks of 8: the 18x18 input stripe
// with its 1-pixel halo (zero outside the image) and the chunk's weights,
// laid out [ci][tap][co] so that every thread reads the same weights
// (shared-memory broadcast, as float4).
//
// Bound: operations. 2 * 9 * Cin * Cout * B * H * W float32 multiply-adds
// on the CUDA cores (3.40 GFLOP at each of the prototype's shapes) against
// tens of MB of bytes. Tensor cores are left for a later change.
//
// The entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;             // output tile side
constexpr int kThreads = kTile * kTile;
constexpr int kHalo = kTile + 2;
constexpr int kCoT = 16;              // output channels per block
constexpr int kCiT = 8;               // input channels per staged chunk
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
conv3x3_bn_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ y,
                        double* __restrict__ sums, int cin, int cout, int height, int width,
                        int tiles_w) {
  __shared__ float xs[kCiT][kHalo][kHalo];
  __shared__ float4 ws[kCiT][9][kCoT / 4];
  __shared__ float red[kWarps][2][kCoT];

  const int tid = threadIdx.x;
  const int ty = tid / kTile;
  const int tx = tid % kTile;
  const int tile_y = (blockIdx.x / tiles_w) * kTile;
  const int tile_x = (blockIdx.x % tiles_w) * kTile;
  const int co0 = blockIdx.y * kCoT;
  const int b = blockIdx.z;
  const long long plane = (long long)height * width;
  const float* xb = x + (long long)b * cin * plane;

  float acc[kCoT];
#pragma unroll
  for (int co = 0; co < kCoT; ++co) acc[co] = 0.0f;

  for (int ci0 = 0; ci0 < cin; ci0 += kCiT) {
    for (int i = tid; i < kCiT * kHalo * kHalo; i += kThreads) {
      const int ci = i / (kHalo * kHalo);
      const int r = (i / kHalo) % kHalo;
      const int c = i % kHalo;
      const int gy = tile_y + r - 1;
      const int gx = tile_x + c - 1;
      const bool ok = ci0 + ci < cin && gy >= 0 && gy < height && gx >= 0 && gx < width;
      xs[ci][r][c] = ok ? __ldg(xb + (ci0 + ci) * plane + (long long)gy * width + gx) : 0.0f;
    }
    float* wsf = reinterpret_cast<float*>(ws);
    for (int i = tid; i < kCiT * 9 * kCoT; i += kThreads) {
      const int co = i % kCoT;
      const int tap = (i / kCoT) % 9;
      const int ci = i / (9 * kCoT);
      const bool ok = co0 + co < cout && ci0 + ci < cin;
      wsf[i] = ok ? __ldg(w + ((long long)(co0 + co) * cin + ci0 + ci) * 9 + tap) : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < kCiT; ++ci) {
      float v[9];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) v[dy * 3 + dx] = xs[ci][ty + dy][tx + dx];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
        for (int q = 0; q < kCoT / 4; ++q) {
          const float4 wv = ws[ci][tap][q];
          acc[4 * q + 0] = fmaf(v[tap], wv.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v[tap], wv.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v[tap], wv.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v[tap], wv.w, acc[4 * q + 3]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: bias, store, and the per-channel sums of this block
  const int oy = tile_y + ty;
  const int ox = tile_x + tx;
  const bool inside = oy < height && ox < width;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int co = 0; co < kCoT; ++co) {
    float val = 0.0f;
    if (co0 + co < cout) {
      val = acc[co] + __ldg(bias + co0 + co);
      if (inside) y[((long long)b * cout + co0 + co) * plane + (long long)oy * width + ox] = val;
    }
    val = inside ? val : 0.0f;
    const float s = warp_sum(val);
    const float q = warp_sum(val * val);
    if (lane == 0) {
      red[warp][0][co] = s;
      red[warp][1][co] = q;
    }
  }
  __syncthreads();
  if (tid < 2 * kCoT) {
    const int k = tid / kCoT;
    const int co = tid % kCoT;
    if (co0 + co < cout) {
      double total = 0.0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) total += (double)red[i][k][co];
      atomicAdd(sums + k * cout + co0 + co, total);
    }
  }
}

}  // namespace

extern "C" {

// x: [B, Cin, H, W] float32; w: [Cout, Cin, 3, 3] float32; bias: [Cout];
// y: [B, Cout, H, W] float32; sums: zeroed [2, Cout] float64 (sum y, sum y^2).
int conv3x3_bn_stats(const void* x, const void* w, const void* bias, void* y, void* sums,
                     int batch, int cin, int cout, int height, int width, void* stream) {
  const int tiles_w = (width + kTile - 1) / kTile;
  const int tiles_h = (height + kTile - 1) / kTile;
  const dim3 grid(tiles_w * tiles_h, (cout + kCoT - 1) / kCoT, batch);
  conv3x3_bn_stats_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), static_cast<double*>(sums),
      cin, cout, height, width, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
