// MaxStyle kernels for Hopper (sm_90a): per-plane statistics, the folded
// affine map, and its backward pass.
//
// Replaces maxstyle_tpu/ops/maxstyle_pallas.py:
//   ms_stats (maxstyle_stats_kernel) -> _stats_kernel (launched by _batched_stats)
//   ms_apply (maxstyle_apply_kernel) -> _apply_kernel (launched by _batched_apply)
//   ms_bwd   (maxstyle_bwd_kernel)   -> _bwd_kernel   (launched by _batched_bwd)
//
// Layout: x is NCHW float32, so each (b, c) plane of HW values is contiguous.
// The TPU kernels repacked [HW, C] into 128-lane rows; here a plane already
// streams as 16-byte float4 loads, so no repacking is needed.
//
// Bound: all three are bound by device-memory bytes. Each reads its inputs
// once (stats: x; apply: x; bwd: g and x) and writes its outputs once
// (apply: out; bwd: dx); the per-plane sums are a few KB. Design: a 2-D grid
// of (plane, chunk) blocks of 256 threads, each thread issuing float4 loads
// over a 4096-value chunk of its plane, so even the 20-plane hook at 192^2
// launches 180 blocks; partial sums reduce by warp shuffles and shared memory
// and land in a zeroed [B, 2, C] output with one atomicAdd per block and sum.
// Arithmetic is float32 throughout, accumulation included.
//
// Every entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 4 * 4;  // values of one plane per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sum of two values; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32];
  __shared__ float sb[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sa[lane] : 0.0f;
    b = lane < kThreads / 32 ? sb[lane] : 0.0f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

// Chunk [begin, end) of plane `plane`; float4 loads are used when every
// plane starts on a 16-byte boundary (hw % 4 == 0).
struct Span {
  long long base;  // offset of the plane's first value
  int begin;
  int end;
  bool vec;
};

__device__ __forceinline__ Span chunk_span(int hw) {
  Span s;
  const long long plane = blockIdx.x;
  s.base = plane * (long long)hw;
  s.begin = blockIdx.y * kChunk;
  s.end = min(hw, s.begin + kChunk);
  s.vec = (hw & 3) == 0;
  return s;
}

__device__ __forceinline__ void add_sums(float* sums, int channels, float a, float b) {
  // sums is [B, 2, C]; plane p = b * C + c.
  const int plane = blockIdx.x;
  const int bi = plane / channels;
  const int ci = plane - bi * channels;
  atomicAdd(sums + (long long)bi * 2 * channels + ci, a);
  atomicAdd(sums + (long long)bi * 2 * channels + channels + ci, b);
}

__global__ void __launch_bounds__(kThreads)
maxstyle_stats_kernel(const float* __restrict__ x, float* __restrict__ sums, int hw, int channels) {
  const Span s = chunk_span(hw);
  const float* p = x + s.base;
  float acc = 0.0f, acc2 = 0.0f;
  if (s.vec) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    for (int i = s.begin / 4 + threadIdx.x; i < s.end / 4; i += kThreads) {
      const float4 v = __ldg(p4 + i);
      acc += (v.x + v.y) + (v.z + v.w);
      acc2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
  } else {
    for (int i = s.begin + threadIdx.x; i < s.end; i += kThreads) {
      const float v = __ldg(p + i);
      acc += v;
      acc2 += v * v;
    }
  }
  block_sum2(acc, acc2);
  if (threadIdx.x == 0) add_sums(sums, channels, acc, acc2);
}

__global__ void __launch_bounds__(kThreads)
maxstyle_apply_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, float* __restrict__ out, int hw) {
  const Span s = chunk_span(hw);
  const float a = scale[blockIdx.x];
  const float b = shift[blockIdx.x];
  const float* p = x + s.base;
  float* o = out + s.base;
  if (s.vec) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int i = s.begin / 4 + threadIdx.x; i < s.end / 4; i += kThreads) {
      float4 v = __ldg(p4 + i);
      v.x = v.x * a + b;
      v.y = v.y * a + b;
      v.z = v.z * a + b;
      v.w = v.w * a + b;
      o4[i] = v;
    }
  } else {
    for (int i = s.begin + threadIdx.x; i < s.end; i += kThreads) o[i] = __ldg(p + i) * a + b;
  }
}

__global__ void __launch_bounds__(kThreads)
maxstyle_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                    const float* __restrict__ scale, float* __restrict__ dx,
                    float* __restrict__ sums, int hw, int channels) {
  const Span s = chunk_span(hw);
  const float a = scale[blockIdx.x];
  const float* gp = g + s.base;
  const float* xp = x + s.base;
  float* dp = dx + s.base;
  float sg = 0.0f, sgx = 0.0f;
  if (s.vec) {
    const float4* g4 = reinterpret_cast<const float4*>(gp);
    const float4* x4 = reinterpret_cast<const float4*>(xp);
    float4* d4 = reinterpret_cast<float4*>(dp);
    for (int i = s.begin / 4 + threadIdx.x; i < s.end / 4; i += kThreads) {
      const float4 gv = __ldg(g4 + i);
      const float4 xv = __ldg(x4 + i);
      d4[i] = make_float4(gv.x * a, gv.y * a, gv.z * a, gv.w * a);
      sg += (gv.x + gv.y) + (gv.z + gv.w);
      sgx += (gv.x * xv.x + gv.y * xv.y) + (gv.z * xv.z + gv.w * xv.w);
    }
  } else {
    for (int i = s.begin + threadIdx.x; i < s.end; i += kThreads) {
      const float gv = __ldg(gp + i);
      dp[i] = gv * a;
      sg += gv;
      sgx += gv * __ldg(xp + i);
    }
  }
  block_sum2(sg, sgx);
  if (threadIdx.x == 0) add_sums(sums, channels, sg, sgx);
}

inline dim3 grid_for(int planes, int hw) { return dim3(planes, (hw + kChunk - 1) / kChunk); }

}  // namespace

extern "C" {

// x: [planes = B*C, hw] float32; sums: zeroed [B, 2, C] float32.
int ms_stats(const void* x, void* sums, int planes, int hw, int channels, void* stream) {
  maxstyle_stats_kernel<<<grid_for(planes, hw), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(sums), hw, channels);
  return static_cast<int>(cudaGetLastError());
}

// out[p, i] = x[p, i] * scale[p] + shift[p]; scale/shift: [planes].
int ms_apply(const void* x, const void* scale, const void* shift, void* out, int planes,
             int hw, void* stream) {
  maxstyle_apply_kernel<<<grid_for(planes, hw), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<float*>(out), hw);
  return static_cast<int>(cudaGetLastError());
}

// dx[p, i] = g[p, i] * scale[p]; sums (zeroed [B, 2, C]) += [sum g, sum g*x].
int ms_bwd(const void* g, const void* x, const void* scale, void* dx, void* sums, int planes,
           int hw, int channels, void* stream) {
  maxstyle_bwd_kernel<<<grid_for(planes, hw), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(x),
      static_cast<const float*>(scale), static_cast<float*>(dx), static_cast<float*>(sums), hw,
      channels);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
