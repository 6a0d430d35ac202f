// MaxStyle kernels for Hopper (sm_90a): per-plane moments, the style map
// (its coefficients folded and applied), and its backward pass.
//
// Replaces maxstyle_tpu/ops/maxstyle_pallas.py:
//   ms_moments     (maxstyle_stats_kernel) -> _stats_kernel (launched by _batched_stats),
//                                             finished as at maxstyle_pallas.py:266-270
//   ms_style_apply (maxstyle_apply_kernel) -> _coefficients and _apply_kernel
//                                             (launched by _batched_apply); under data
//                                             parallelism it reads the global moments at
//                                             the rank's first global row
//   ms_bwd         (maxstyle_bwd_kernel)   -> _bwd_kernel   (launched by _batched_bwd)
//
// Layout: x is NCHW float32, so each (b, c) plane of HW values is contiguous.
// The TPU kernels repacked [HW, C] into 128-lane rows; here a plane already
// streams as 16-byte float4 loads, so no repacking is needed.
//
// Bound: all three are bound by device-memory bytes. Each reads its inputs
// once (moments: x; apply: x; bwd: g and x) and writes its outputs once
// (apply: out; bwd: dx); the per-plane inputs and results are a few KB.
//
// Moments and bwd reduce each plane to two sums. Design: one plane is one
// thread-block cluster of k blocks (k in {1, 2, 4, 8}, launched with
// cudaLaunchKernelEx and the cluster-dimension attribute); rank r streams
// values [r * per_rank, min(hw, (r + 1) * per_rank)) of it. The wrapper
// picks (k, per_rank) (`_plane_tiling` in ops/maxstyle_kernels.py) so that
// the 20-plane hook still fills the card and the 320-plane hooks run in one
// wave. Each thread of a block (512 threads; 1024 for bwd's long shares)
// keeps at least four float4 loads in flight: moments issues all
// kStatsUnroll loads of a step before it accumulates any; bwd issues the
// next step's kBwdUnroll loads each of g and x before this step's
// arithmetic and dx stores. A block reduces by
// warp shuffles; each other rank then stores its partial into rank 0's
// shared memory (distributed shared memory), and thread 0 of rank 0 adds
// them in rank order and writes the result with plain stores. No atomics
// and no zeroed output: one launch a call, and the same bits on every call.
// Moments finish in the epilogue (mu, the unbiased variance clamped at 0,
// sig = sqrt(var + eps)).
//
// The cluster barrier is what this design pays for the reduction, so only
// rank 0's thread 0 waits on it (cluster_sum2), and the 320-plane hooks run
// one block a plane with no barrier at all.
//
// Apply folds the MaxStyle chain into a per-plane (scale, shift) itself, in
// _coefficients' order with one rounding a step, so the forward call needs
// no elementwise launches around it. Block (chunk, plane) of a 2-D grid
// streams kApplyUnroll * 256 vector elements of one plane: each thread
// issues its kApplyUnroll loads of x first, so the dependent
// perm -> mu[perm] loads of the coefficients wait behind them, not in front
// of them; then it folds the plane's coefficients (every thread of the
// block the same ones) and stores. The plane's first thread writes its
// scale, shift, mu[perm] and sig[perm] for the backward pass. Grids sized
// to one wave of the card, each thread walking a flat run of elements and
// folding again at each plane it enters, were slower on the H100, and
// evict-first stores of out gained nothing (the next convolution reads it).
// Arithmetic is float32 throughout, accumulation included.
//
// Every entry point returns cudaGetLastError() (or the launch's own error)
// right after its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kApplyThreads = 256;         // apply
constexpr int kApplyUnroll = 4;             // apply: loads of x in flight per thread
constexpr int kPlaneThreads = 512;          // moments and bwd
constexpr int kStatsUnroll = 8;             // float4 loads of x in flight per thread
constexpr int kBwdUnroll = 2;               // float4 loads each of g and x per step
constexpr int kMaxCluster = 8;              // the portable cluster size
// bwd over a share of at least kLongShare values (the full-size 16-channel
// hooks) runs 1024-thread blocks with evict-first dx stores: on the H100
// that was faster there, and slower on the shorter shares
constexpr int kLongShare = 32768;
constexpr int kLongShareThreads = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sum of two values over T threads; the result is valid in
// thread 0.
template <int T>
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[T / 32];
  __shared__ float sb[T / 32];
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
    a = lane < T / 32 ? sa[lane] : 0.0f;
    b = lane < T / 32 ? sb[lane] : 0.0f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

// The cluster barrier (PTX barrier.cluster) in its split form. A wait
// returns once every thread of the cluster that has not exited has arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// Cluster-wide sum of two values, added in rank order; returns true in the
// one thread (thread 0 of rank 0) that holds the result. A kernel with
// k > 1 calls cluster_arrive_relaxed() when it starts, so that the first
// wait here (long complete by then) shows that rank 0 is running before
// any rank writes to its shared memory. Each other rank's thread 0 then
// stores its partial into rank 0's shared memory, arrives with release
// semantics and exits; every other thread exits at once. Only rank 0's
// thread 0 waits for the partials: one barrier latency, not two syncs of
// every thread.
template <int T>
__device__ __forceinline__ bool cluster_sum2(float& a, float& b, unsigned k) {
  __shared__ float2 parts[kMaxCluster];
  block_sum2<T>(a, b);
  if (k == 1) return threadIdx.x == 0;
  cluster_wait();
  if (threadIdx.x != 0) return false;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  if (rank != 0) {
    *cluster.map_shared_rank(&parts[rank], 0) = make_float2(a, b);
    cluster_arrive_release();
    return false;
  }
  cluster_arrive_release();
  cluster_wait();  // every other rank's partial has landed
#pragma unroll
  for (unsigned r = 1; r < kMaxCluster; ++r)
    if (r < k) {
      a += parts[r].x;
      b += parts[r].y;
    }
  return true;
}

// This block's share of its plane: values [begin, end) of plane `plane`,
// which starts at `base`. float4 loads are used when every plane and every
// share starts on a 16-byte boundary (hw % 4 == 0; per_rank is a multiple
// of 4).
struct Span {
  long long plane;
  long long base;
  int begin;
  int end;
  bool vec;
};

// moments and bwd: rank r of the plane's cluster of k blocks.
__device__ __forceinline__ Span rank_span(int hw, int per_rank) {
  cg::cluster_group cluster = cg::this_cluster();
  Span s;
  s.plane = blockIdx.x / cluster.num_blocks();
  s.base = s.plane * (long long)hw;
  s.begin = (int)min((long long)hw, (long long)cluster.block_rank() * per_rank);
  s.end = min(hw, s.begin + per_rank);
  s.vec = (hw & 3) == 0;
  return s;
}

__global__ void __launch_bounds__(kPlaneThreads)
maxstyle_stats_kernel(const float* __restrict__ x, float* __restrict__ mu,
                      float* __restrict__ sig, int hw, int per_rank, float eps) {
  const unsigned k = cg::this_cluster().num_blocks();
  if (k > 1) cluster_arrive_relaxed();
  const Span s = rank_span(hw, per_rank);
  const float* p = x + s.base;
  float acc = 0.0f, acc2 = 0.0f;
  if (s.vec) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const int end4 = s.end / 4;
    for (int i0 = s.begin / 4 + threadIdx.x; i0 < end4; i0 += kStatsUnroll * kPlaneThreads) {
      float4 v[kStatsUnroll];
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        const int i = i0 + u * kPlaneThreads;
        v[u] = i < end4 ? __ldg(p4 + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        acc += (v[u].x + v[u].y) + (v[u].z + v[u].w);
        acc2 += (v[u].x * v[u].x + v[u].y * v[u].y) + (v[u].z * v[u].z + v[u].w * v[u].w);
      }
    }
  } else {
    for (int i0 = s.begin + threadIdx.x; i0 < s.end; i0 += kStatsUnroll * kPlaneThreads) {
      float v[kStatsUnroll];
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        const int i = i0 + u * kPlaneThreads;
        v[u] = i < s.end ? __ldg(p + i) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        acc += v[u];
        acc2 += v[u] * v[u];
      }
    }
  }
  if (cluster_sum2<kPlaneThreads>(acc, acc2, k)) {
    // as at maxstyle_pallas.py:267-270: mu, the unbiased variance (single
    // pass, clamped at 0) and sig = sqrt(var + eps). Each step rounds on its
    // own (no fused multiply-add), so a constant plane gets var 0 exactly.
    const float n = static_cast<float>(hw);
    const float m = __fdiv_rn(acc, n);
    const float unbias = static_cast<float>(static_cast<double>(hw) / max(hw - 1, 1));
    const float dev = __fsub_rn(__fdiv_rn(acc2, n), __fmul_rn(m, m));
    const float var = __fmul_rn(fmaxf(dev, 0.0f), unbias);
    mu[s.plane] = m;
    sig[s.plane] = sqrtf(__fadd_rn(var, eps));
  }
}

// The inputs of the style map, as _FusedStyle receives them. x holds rows
// [row0, row0 + B) of a global batch of G rows (G = B, row0 = 0 on one
// device): lmda, gn and bn are the B local rows; mu, sig, perm and [G, C]
// spreads are global, so a row's partner may be another rank's row.
struct StyleArgs {
  const float* lmda;      // [B]
  const float* gn;        // gamma noise [B, C]
  const float* bn;        // beta noise [B, C]
  const float* mu;        // [G, C]
  const float* sig;       // [G, C]
  const long long* perm;  // [G], global rows
  const float* gstd;      // spreads: [1, C] (spread_stride 0) or [G, C] (stride C)
  const float* bstd;
  const float* gate;      // [1]
  float* coefs;           // out: [4, B, C] = scale, shift, mu[perm], sig[perm]
  int spread_stride;
  int planes;             // B * C
  int channels;
  int row0;
  int mix_style;
  int no_noise;
};

// (scale, shift) of local plane p = b * C + c, in the order of _coefficients
// (ops/maxstyle_kernels.py): every step rounds on its own, so scale and
// shift are bit-equal to the plain torch ops on the same card. `first`:
// also write them (and the permuted moments) for the backward pass.
__device__ __forceinline__ float2 style_coefficients(const StyleArgs& a, int p, bool first) {
  const int b = p / a.channels;
  const int c = p - b * a.channels;
  const int row = a.row0 + b;  // the plane's global row
  const int own = row * a.channels + c;
  const int q = static_cast<int>(a.perm[row]) * a.channels + c;
  const float mu = a.mu[own], sig = a.sig[own], mu2 = a.mu[q], sig2 = a.sig[q];
  float sig_mix = sig, mu_mix = mu;
  if (a.mix_style) {
    const float lm = fminf(fmaxf(a.lmda[b], 0.0f), 1.0f);
    const float keep = __fsub_rn(1.0f, lm);
    sig_mix = __fadd_rn(__fmul_rn(sig, keep), __fmul_rn(sig2, lm));
    mu_mix = __fadd_rn(__fmul_rn(mu, keep), __fmul_rn(mu2, lm));
  }
  float scale, shift;
  if (a.no_noise) {
    scale = __fdiv_rn(sig_mix, sig);
    shift = __fsub_rn(mu_mix, __fmul_rn(mu, scale));
  } else {
    const int s = row * a.spread_stride + c;
    scale = __fdiv_rn(__fadd_rn(sig_mix, __fmul_rn(a.gn[p], a.gstd[s])), sig);
    shift = __fsub_rn(__fadd_rn(mu_mix, __fmul_rn(a.bn[p], a.bstd[s])), __fmul_rn(mu, scale));
  }
  // the gate folds into the map: off -> identity
  const float g = a.gate[0];
  scale = __fadd_rn(__fmul_rn(g, scale), __fsub_rn(1.0f, g));
  shift = __fmul_rn(g, shift);
  if (first) {
    a.coefs[p] = scale;
    a.coefs[a.planes + p] = shift;
    a.coefs[2 * a.planes + p] = mu2;
    a.coefs[3 * a.planes + p] = sig2;
  }
  return make_float2(scale, shift);
}

__device__ __forceinline__ float4 affine(float4 v, float2 k) {
  return make_float4(__fmaf_rn(v.x, k.x, k.y), __fmaf_rn(v.y, k.x, k.y),
                     __fmaf_rn(v.z, k.x, k.y), __fmaf_rn(v.w, k.x, k.y));
}
__device__ __forceinline__ float affine(float v, float2 k) { return __fmaf_rn(v, k.x, k.y); }

// V is float4 (hw % 4 == 0) or float; hw_v vector elements a plane. Block
// (chunk, plane) covers elements [chunk * kApplyUnroll * T, +kApplyUnroll * T)
// of its plane; thread t takes every T-th of them from t on.
template <typename V>
__global__ void __launch_bounds__(kApplyThreads)
maxstyle_apply_kernel(const V* __restrict__ x, V* __restrict__ out, const StyleArgs a,
                      unsigned hw_v) {
  const int p = blockIdx.y;
  const V* xp = x + static_cast<size_t>(p) * hw_v;
  V* op = out + static_cast<size_t>(p) * hw_v;
  const unsigned begin = blockIdx.x * kApplyUnroll * kApplyThreads + threadIdx.x;
  V v[kApplyUnroll];
#pragma unroll
  for (int u = 0; u < kApplyUnroll; ++u) {
    const unsigned i = begin + u * kApplyThreads;
    if (i < hw_v) v[u] = __ldg(xp + i);
  }
  const float2 k = style_coefficients(a, p, blockIdx.x == 0 && threadIdx.x == 0);
#pragma unroll
  for (int u = 0; u < kApplyUnroll; ++u) {
    const unsigned i = begin + u * kApplyThreads;
    if (i < hw_v) op[i] = affine(v[u], k);
  }
}

// T threads a block; kStream stores dx evict-first (st.global.cs).
template <int T, bool kStream>
__global__ void __launch_bounds__(T)
maxstyle_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                    const float* __restrict__ scale, float* __restrict__ dx,
                    float* __restrict__ sums, int hw, int per_rank, int channels) {
  const unsigned k = cg::this_cluster().num_blocks();
  if (k > 1) cluster_arrive_relaxed();
  const Span s = rank_span(hw, per_rank);
  const float a = scale[s.plane];
  const float* gp = g + s.base;
  const float* xp = x + s.base;
  float* dp = dx + s.base;
  float sg = 0.0f, sgx = 0.0f;
  if (s.vec) {
    const float4* g4 = reinterpret_cast<const float4*>(gp);
    const float4* x4 = reinterpret_cast<const float4*>(xp);
    float4* d4 = reinterpret_cast<float4*>(dp);
    const int end4 = s.end / 4;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // software-pipelined: the next step's loads are issued before this
    // step's arithmetic and stores, so loads stay in flight throughout
    float4 gv[kBwdUnroll], xv[kBwdUnroll];
    int i0 = s.begin / 4 + threadIdx.x;
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int i = i0 + u * T;
      gv[u] = i < end4 ? __ldg(g4 + i) : zero;
      xv[u] = i < end4 ? __ldg(x4 + i) : zero;
    }
    for (; i0 < end4; i0 += kBwdUnroll * T) {
      float4 gn[kBwdUnroll], xn[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int i = i0 + (kBwdUnroll + u) * T;
        gn[u] = i < end4 ? __ldg(g4 + i) : zero;
        xn[u] = i < end4 ? __ldg(x4 + i) : zero;
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int i = i0 + u * T;
        const float4 d = make_float4(gv[u].x * a, gv[u].y * a, gv[u].z * a, gv[u].w * a);
        if (i < end4) {
          if (kStream)
            __stcs(d4 + i, d);
          else
            d4[i] = d;
        }
        sg += (gv[u].x + gv[u].y) + (gv[u].z + gv[u].w);
        sgx += (gv[u].x * xv[u].x + gv[u].y * xv[u].y) + (gv[u].z * xv[u].z + gv[u].w * xv[u].w);
        gv[u] = gn[u];
        xv[u] = xn[u];
      }
    }
  } else {
    for (int i0 = s.begin + threadIdx.x; i0 < s.end; i0 += kBwdUnroll * T) {
      float gv[kBwdUnroll], xv[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int i = i0 + u * T;
        gv[u] = i < s.end ? __ldg(gp + i) : 0.0f;
        xv[u] = i < s.end ? __ldg(xp + i) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int i = i0 + u * T;
        if (i < s.end) dp[i] = gv[u] * a;
        sg += gv[u];
        sgx += gv[u] * xv[u];
      }
    }
  }
  if (cluster_sum2<T>(sg, sgx, k)) {
    // sums is [B, 2, C]; plane p = b * C + c
    const long long bi = s.plane / channels;
    const long long ci = s.plane - bi * channels;
    sums[bi * 2 * channels + ci] = sg;
    sums[bi * 2 * channels + channels + ci] = sgx;
  }
}

// A tiling the kernels can run: k a cluster size they take, every rank's
// share 16-byte aligned where the float4 path runs, the plane covered.
inline bool tiling_ok(int planes, int hw, int k, int per_rank) {
  if (planes <= 0 || hw <= 0 || per_rank <= 0) return false;
  if (k != 1 && k != 2 && k != 4 && k != 8) return false;
  if ((hw & 3) == 0 && (per_rank & 3) != 0) return false;
  if ((long long)per_rank * k < hw) return false;
  return (long long)planes * k <= 0x7fffffffLL;
}

// Launch `kernel` over planes * k blocks of `threads` in clusters of k.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int planes, int k, int threads,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(planes * k));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [planes = B*C, hw] float32 -> mu, sig: [planes] float32; (k, per_rank)
// from _plane_tiling.
int ms_moments(const void* x, void* mu, void* sig, int planes, int hw, int k, int per_rank,
               float eps, void* stream) {
  if (!tiling_ok(planes, hw, k, per_rank)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_clusters(maxstyle_stats_kernel, planes, k, kPlaneThreads,
                         static_cast<cudaStream_t>(stream),
                         static_cast<const float*>(x), static_cast<float*>(mu),
                         static_cast<float*>(sig), hw, per_rank, eps);
}

// out[p, i] = x[p, i] * scale[p] + shift[p] with (scale, shift) folded
// from the style inputs (StyleArgs; x's rows start at global row row0);
// coefs ([4, planes]) receives scale, shift, mu[perm] and sig[perm].
int ms_style_apply(const void* x, void* out, const void* lmda, const void* gn, const void* bn,
                   const void* mu, const void* sig, const void* perm, const void* gstd,
                   const void* bstd, int spread_stride, const void* gate, void* coefs,
                   int planes, int hw, int channels, int row0, int mix_style, int no_noise,
                   void* stream) {
  if (planes <= 0 || planes > 65535 || hw <= 0 || channels <= 0 || planes % channels != 0 ||
      row0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const StyleArgs a = {static_cast<const float*>(lmda), static_cast<const float*>(gn),
                       static_cast<const float*>(bn), static_cast<const float*>(mu),
                       static_cast<const float*>(sig), static_cast<const long long*>(perm),
                       static_cast<const float*>(gstd), static_cast<const float*>(bstd),
                       static_cast<const float*>(gate), static_cast<float*>(coefs),
                       spread_stride, planes, channels, row0, mix_style, no_noise};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (hw & 3) == 0;
  const unsigned hw_v = vec ? hw / 4 : hw;
  const dim3 grid((hw_v + kApplyUnroll * kApplyThreads - 1) / (kApplyUnroll * kApplyThreads),
                  planes);
  if (vec)
    maxstyle_apply_kernel<<<grid, kApplyThreads, 0, s>>>(static_cast<const float4*>(x),
                                                         static_cast<float4*>(out), a, hw_v);
  else
    maxstyle_apply_kernel<<<grid, kApplyThreads, 0, s>>>(static_cast<const float*>(x),
                                                         static_cast<float*>(out), a, hw_v);
  return static_cast<int>(cudaGetLastError());
}

// dx[p, i] = g[p, i] * scale[p]; sums ([B, 2, C], every entry written) =
// [sum g, sum g*x] per plane; (k, per_rank) from _plane_tiling.
int ms_bwd(const void* g, const void* x, const void* scale, void* dx, void* sums, int planes,
           int hw, int channels, int k, int per_rank, void* stream) {
  if (!tiling_ok(planes, hw, k, per_rank) || channels <= 0 || planes % channels != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(scale);
  float* dp = static_cast<float*>(dx);
  float* out = static_cast<float*>(sums);
  if (per_rank >= kLongShare)
    return launch_clusters(maxstyle_bwd_kernel<kLongShareThreads, true>, planes, k,
                           kLongShareThreads, s, gp, xp, sp, dp, out, hw, per_rank, channels);
  return launch_clusters(maxstyle_bwd_kernel<kPlaneThreads, false>, planes, k, kPlaneThreads, s,
                         gp, xp, sp, dp, out, hw, per_rank, channels);
}

}  // extern "C"
