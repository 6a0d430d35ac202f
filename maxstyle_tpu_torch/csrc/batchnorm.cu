// BatchNorm kernels for Hopper (sm_90a): the forward and backward pass of a
// float32 [N, C, *spatial] tensor normalised with the batch's own
// statistics, the "train" and "frozen" passes of models/layers.BatchNorm.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA. Before
// these kernels the port called F.batch_norm, which on the card runs
// cuDNN's NCHW "1C11" kernels (bn_fw_tr_1C11_kernel_NCHW,
// bn_bw_1C11_kernel_new). Those reduce each channel inside one thread block:
// at 16 channels that is 16 blocks on 132 SMs, and the traced training steps
// spent 63-68 device ms a step in them at about a tenth of their bytes bound.
//
//   bn_fwd (batchnorm_fwd_kernel) -> y = x * scale + shift with the batch's
//                                    mean and biased variance; writes
//                                    stats [2, C] = (mean, 1 / sqrt(var + eps))
//                                    and, for "train", updates the running
//                                    mean and the Bessel-corrected running
//                                    variance with the momentum
//   bn_bwd (batchnorm_bwd_kernel) -> dx = w * invstd * (dy - sum(dy) / M
//                                    - xhat * sum(dy * xhat) / M), and
//                                    dweight = sum(dy * xhat), dbias = sum(dy)
//                                    where the caller asks for them
//   bn_fwd_rows, bn_bwd_rows      -> the same two on a channels-last tensor
//   (batchnorm_{fwd,bwd}_rows_kernel)  (the section below them)
//
// Layout: in an NCHW-contiguous tensor channel c is a flat run of M = N * S
// values (S the spatial size), N contiguous segments of S values at a
// stride of C * S. A float4 never crosses a segment when S % 4 == 0, so
// that path streams 16-byte loads; any other S, or a pointer off 16 bytes,
// takes the scalar path. A channels-last tensor (UNETR's image decoder, the
// STN's shape path) is R = N * S rows of C values; its kernels read rows.
//
// Bound: all four kernels are bound by device-memory bytes. The least
// traffic is 8 bytes a value forward (read x, write y) and 12 backward
// (read x and dy, write dx). Each has to see every value of a channel
// before it can write any output, so each reads its inputs twice: once to
// reduce, once to write. Two things keep the second read off device memory:
// each block keeps the head of its share (up to kCacheBytes, 96 KB, of each
// input) in shared memory as the first pass reads it, and the second pass
// runs over the share in reverse order, so it starts on the tail that the
// first pass read last and the 50 MB L2 most likely still holds. A thread
// walks its vectors kThreads apart with a Cursor, so no address costs a
// division.
//
// Work split: a channel is one thread-block cluster of k blocks (1 to 16;
// above 8 needs the non-portable cluster size, which Hopper allows), and
// rank r reduces values [r * per_rank, (r + 1) * per_rank) of the flat run.
// The wrapper's planner (`plan` in ops/batchnorm_kernels.py) takes the
// largest k at which every channel's cluster still runs in one wave, by
// CUDA's occupancy calculator (bn_max_clusters), and each rank keeps at
// least 2048 values. Two 512-thread blocks fit an SM, but a cluster takes
// its SMs from one GPC, so clusters of k leave some idle: the H100 runs 30
// clusters of 8 and 14 of 16, not 33 and 16. Channels left for a second
// wave run nearly alone at the end: at [20, 16, 192^2] the forward took
// 37% longer in clusters of 13 (two waves) than of 12. So 16 channels
// at 192^2 run 16 x 12 blocks, 32 at 96^2 32 x 7, 128 at 24^2 128 x 2, and
// 768 channels one block each: few, wide channels fill the card as many
// narrow ones do.
//
// Reduction: each thread folds the values of each step (kUnroll loads) into
// a (count, mean, M2) of centred sums and merges it into its own by Chan's
// formula; warps, then the block, merge the same way in a fixed tree. Each
// rank's thread 0 stores its block's triple into every rank's shared memory
// (distributed shared memory); after the cluster barrier every block merges
// the k triples in rank order, so all ranks hold the same bits, and no
// float atomics are used: two runs on one input are bitwise equal. The
// backward pass reduces sum(dy) and sum(dy * (x - mean)), centred on the
// forward's saved mean, the same way. Arithmetic is float32 throughout.
//
// Every entry point returns the launch's error, or cudaGetLastError(),
// right after its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // vector loads of each input in flight per thread and step
constexpr int kMaxCluster = 16;  // Hopper's non-portable cluster limit
// shared memory a block keeps the head of its share in, so that two blocks
// fit an SM; at [20, 16, 192^2] 48 KB took 5% longer, 160 KB (one block an
// SM) 11-17% longer
constexpr int kCacheBytes = 96 * 1024;

struct Moments {
  float n;
  float mean;
  float m2;  // sum of squared deviations from mean
};

// a <- a merged with b (Chan et al.'s parallel update); a side with no
// values leaves the other as it is.
__device__ __forceinline__ void merge(Moments& a, const Moments& b) {
  const float tot = a.n + b.n;
  if (tot > 0.0f) {
    const float f = __fdividef(b.n, tot);
    const float d = b.mean - a.mean;
    a.mean = fmaf(d, f, a.mean);
    a.m2 = a.m2 + b.m2 + d * d * a.n * f;
    a.n = tot;
  }
}

__device__ __forceinline__ Moments warp_combine(Moments a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments b = {__shfl_down_sync(0xffffffffu, a.n, off),
                       __shfl_down_sync(0xffffffffu, a.mean, off),
                       __shfl_down_sync(0xffffffffu, a.m2, off)};
    merge(a, b);
  }
  return a;
}

__device__ __forceinline__ float2 warp_combine(float2 a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a.x += __shfl_down_sync(0xffffffffu, a.x, off);
    a.y += __shfl_down_sync(0xffffffffu, a.y, off);
  }
  return a;
}

__device__ __forceinline__ void combine(Moments& a, const Moments& b) { merge(a, b); }
__device__ __forceinline__ void combine(float2& a, const float2& b) {
  a.x += b.x;
  a.y += b.y;
}

// The cluster barrier (PTX barrier.cluster) in its split form. A wait
// returns once every thread of the cluster has arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The channel's total of every thread's partial P, returned to every
// thread of every rank with the same bits. Warps combine by shuffles, warp
// 0 combines the warps, and thread 0 stores the block's partial into slot
// `rank` of every rank's `parts`; once the cluster barrier has passed,
// each thread combines the k slots in rank order. A kernel with k > 1
// calls cluster_arrive_relaxed() when it starts, so the first wait here
// shows that every rank is running before any rank writes to another's
// shared memory; every access to another rank's memory comes before the
// second barrier, so a block may exit as soon as it has passed it.
template <typename P>
__device__ __forceinline__ P cluster_allreduce(P a, unsigned k) {
  __shared__ P warp_parts[kWarps];
  __shared__ P parts[kMaxCluster];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_combine(a);
  if (lane == 0) warp_parts[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = warp_parts[lane < kWarps ? lane : 0];
    if (lane >= kWarps) a = P{};
    a = warp_combine(a);
  }
  if (k == 1) {
    if (threadIdx.x == 0) parts[0] = a;
    __syncthreads();
    return parts[0];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();
  if (threadIdx.x == 0)
    for (unsigned r = 0; r < k; ++r) *cluster.map_shared_rank(&parts[cluster.block_rank()], r) = a;
  cluster_arrive_release();
  cluster_wait();
  P t = parts[0];
  for (unsigned r = 1; r < k; ++r) combine(t, parts[r]);
  return t;
}

// The shape of a call: N, C, S, each rank's share of a channel in values
// (a multiple of 4 on the float4 path), and how many vectors of each input
// at the head of its share a block keeps in shared memory.
struct Shape {
  int n;
  int c;
  int s;
  int per_rank;
  int cache;
};

// This block's share of its channel in vectors of V (four floats on the
// float4 path): [begin, end) of the flat run, whose vector j lies at
// (j / s_v) * cs_v + base_v + j % s_v. A thread walks vectors kThreads
// apart; `step` and `wrap` move a Cursor by one such step without a
// division.
struct Share {
  int channel;
  int begin;
  int end;
  int s_v;
  int step_rem;        // kThreads % s_v
  long long cs_v;
  long long base_v;
  long long step;      // (kThreads / s_v) * cs_v + kThreads % s_v
  long long wrap;      // cs_v - s_v
};

template <typename V>
__device__ __forceinline__ Share block_share(const Shape& sh, unsigned k, unsigned rank) {
  constexpr int w = sizeof(V) / sizeof(float);
  Share s;
  s.channel = static_cast<int>(blockIdx.x / k);
  s.s_v = sh.s / w;
  s.cs_v = static_cast<long long>(sh.c) * s.s_v;
  s.base_v = static_cast<long long>(s.channel) * s.s_v;
  s.step_rem = kThreads % s.s_v;
  s.step = static_cast<long long>(kThreads / s.s_v) * s.cs_v + s.step_rem;
  s.wrap = s.cs_v - s.s_v;
  const long long m_v = static_cast<long long>(sh.n) * s.s_v;
  const long long per_v = sh.per_rank / w;
  s.begin = static_cast<int>(min(m_v, rank * per_v));
  s.end = static_cast<int>(min(m_v, s.begin + per_v));
  return s;
}

// Vector j of a share: its offset in the tensor and j % s_v.
struct Cursor {
  long long off;
  int rem;
};

__device__ __forceinline__ Cursor cursor_at(const Share& s, int j) {
  const int seg = j / s.s_v;
  const int rem = j - seg * s.s_v;
  return {seg * s.cs_v + s.base_v + rem, rem};
}

// j -> j + kThreads
__device__ __forceinline__ void step_up(Cursor& c, const Share& s) {
  c.rem += s.step_rem;
  c.off += s.step;
  if (c.rem >= s.s_v) {
    c.rem -= s.s_v;
    c.off += s.wrap;
  }
}

// j -> j - kThreads
__device__ __forceinline__ void step_down(Cursor& c, const Share& s) {
  c.rem -= s.step_rem;
  c.off -= s.step;
  if (c.rem < 0) {
    c.rem += s.s_v;
    c.off -= s.wrap;
  }
}

__device__ __forceinline__ float hsum(float4 v) { return (v.x + v.y) + (v.z + v.w); }
__device__ __forceinline__ float hsum(float v) { return v; }
__device__ __forceinline__ float hdev2(float4 v, float m) {
  const float a = v.x - m, b = v.y - m, c = v.z - m, d = v.w - m;
  return (a * a + b * b) + (c * c + d * d);
}
__device__ __forceinline__ float hdev2(float v, float m) {
  const float a = v - m;
  return a * a;
}
// sum of g * (x - m)
__device__ __forceinline__ float hdot(float4 g, float4 x, float m) {
  return (g.x * (x.x - m) + g.y * (x.y - m)) + (g.z * (x.z - m) + g.w * (x.w - m));
}
__device__ __forceinline__ float hdot(float g, float x, float m) { return g * (x - m); }
__device__ __forceinline__ float4 affine(float4 v, float a, float b) {
  return make_float4(fmaf(v.x, a, b), fmaf(v.y, a, b), fmaf(v.z, a, b), fmaf(v.w, a, b));
}
__device__ __forceinline__ float affine(float v, float a, float b) { return fmaf(v, a, b); }
// a * (g - k1 - (x - m) * k2)
__device__ __forceinline__ float bwd1(float g, float x, float a, float k1, float k2, float m) {
  return a * (g - k1 - (x - m) * k2);
}
__device__ __forceinline__ float4 bwd1(float4 g, float4 x, float a, float k1, float k2, float m) {
  return make_float4(bwd1(g.x, x.x, a, k1, k2, m), bwd1(g.y, x.y, a, k1, k2, m),
                     bwd1(g.z, x.z, a, k1, k2, m), bwd1(g.w, x.w, a, k1, k2, m));
}

// The thread's last vector of the share, for the reverse second pass
// (-1, below every index, where the thread has none).
__device__ __forceinline__ int last_index(const Share& s) {
  const int first = s.begin + static_cast<int>(threadIdx.x);
  if (first >= s.end) return -1;
  return first + ((s.end - 1 - first) / kThreads) * kThreads;
}

template <typename V>
__global__ void __launch_bounds__(kThreads, 2)
batchnorm_fwd_kernel(const V* __restrict__ x, V* __restrict__ y, const float* __restrict__ weight,
                     const float* __restrict__ bias, float* __restrict__ stats,
                     float* __restrict__ running_mean, float* __restrict__ running_var,
                     float momentum, float eps, const Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* cache = reinterpret_cast<V*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned k = cluster.num_blocks();
  if (k > 1) cluster_arrive_relaxed();
  constexpr float w = sizeof(V) / sizeof(float);
  const Share s = block_share<V>(sh, k, cluster.block_rank());
  const int lo = s.begin + static_cast<int>(threadIdx.x);
  Moments acc = {0.0f, 0.0f, 0.0f};
  Cursor cur = cursor_at(s, lo);
  for (int j = lo; j < s.end; j += kUnroll * kThreads) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = j + u * kThreads;
      if (i < s.end) {
        v[u] = __ldg(x + cur.off);
        if (i - s.begin < sh.cache) cache[i - s.begin] = v[u];
      }
      step_up(cur, s);
    }
    float cnt = 0.0f, sum = 0.0f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * kThreads < s.end) {
        cnt += w;
        sum += hsum(v[u]);
      }
    const float m = __fdividef(sum, cnt);
    float m2 = 0.0f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * kThreads < s.end) m2 += hdev2(v[u], m);
    merge(acc, Moments{cnt, m, m2});
  }
  const Moments t = cluster_allreduce(acc, k);
  const float count = static_cast<float>(static_cast<long long>(sh.n) * sh.s);
  const float var = t.m2 / count;
  const float invstd = 1.0f / sqrtf(var + eps);
  const float scale = weight[s.channel] * invstd;
  const float shift = fmaf(-t.mean, scale, bias[s.channel]);
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    stats[s.channel] = t.mean;
    stats[sh.c + s.channel] = invstd;
    if (running_mean != nullptr) {
      const long long m = static_cast<long long>(sh.n) * sh.s;
      const float unbiased = var * static_cast<float>(static_cast<double>(m) / (m - 1));
      running_mean[s.channel] = fmaf(momentum, t.mean, (1.0f - momentum) * running_mean[s.channel]);
      running_var[s.channel] = fmaf(momentum, unbiased, (1.0f - momentum) * running_var[s.channel]);
    }
  }
  // the second pass, backwards: the uncached tail (read last, so the most
  // likely to be in L2) first, then the head from shared memory
  const int last = last_index(s);
  cur = cursor_at(s, max(last, 0));
  for (int j = last; j >= lo; j -= kUnroll * kThreads) {
    V v[kUnroll];
    long long o[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = j - u * kThreads;
      o[u] = cur.off;
      if (i >= lo) v[u] = i - s.begin < sh.cache ? cache[i - s.begin] : __ldg(x + cur.off);
      step_down(cur, s);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j - u * kThreads >= lo) y[o[u]] = affine(v[u], scale, shift);
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads, 2)
batchnorm_bwd_kernel(const V* __restrict__ dy, const V* __restrict__ x,
                     const float* __restrict__ weight, const float* __restrict__ stats,
                     V* __restrict__ dx, float* __restrict__ dweight, float* __restrict__ dbias,
                     const Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* gcache = reinterpret_cast<V*>(smem);
  V* xcache = gcache + sh.cache;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned k = cluster.num_blocks();
  if (k > 1) cluster_arrive_relaxed();
  const Share s = block_share<V>(sh, k, cluster.block_rank());
  const int lo = s.begin + static_cast<int>(threadIdx.x);
  const float mean = stats[s.channel];
  const float invstd = stats[sh.c + s.channel];
  float2 acc = make_float2(0.0f, 0.0f);  // sum dy, sum dy * (x - mean)
  Cursor cur = cursor_at(s, lo);
  for (int j = lo; j < s.end; j += kUnroll * kThreads) {
    V g[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = j + u * kThreads;
      if (i < s.end) {
        g[u] = __ldg(dy + cur.off);
        v[u] = __ldg(x + cur.off);
        if (i - s.begin < sh.cache) {
          gcache[i - s.begin] = g[u];
          xcache[i - s.begin] = v[u];
        }
      }
      step_up(cur, s);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * kThreads < s.end) {
        acc.x += hsum(g[u]);
        acc.y += hdot(g[u], v[u], mean);
      }
  }
  const float2 t = cluster_allreduce(acc, k);
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    if (dweight != nullptr) dweight[s.channel] = t.y * invstd;
    if (dbias != nullptr) dbias[s.channel] = t.x;
  }
  if (dx == nullptr) return;
  const float count = static_cast<float>(static_cast<long long>(sh.n) * sh.s);
  const float a = weight[s.channel] * invstd;
  const float k1 = t.x / count;
  const float k2 = t.y * invstd * invstd / count;
  const int last = last_index(s);
  cur = cursor_at(s, max(last, 0));
  for (int j = last; j >= lo; j -= kUnroll * kThreads) {
    V g[kUnroll], v[kUnroll];
    long long o[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = j - u * kThreads;
      o[u] = cur.off;
      if (i >= lo) {
        if (i - s.begin < sh.cache) {
          g[u] = gcache[i - s.begin];
          v[u] = xcache[i - s.begin];
        } else {
          g[u] = __ldg(dy + cur.off);
          v[u] = __ldg(x + cur.off);
        }
      }
      step_down(cur, s);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j - u * kThreads >= lo) dx[o[u]] = bwd1(g[u], v[u], a, k1, k2, mean);
  }
}

// ---------------------------------------------------------------------------
// Channels-last layout ([N, *spatial, C] in memory: R = N * S rows of C
// values). A thread owns one vector of channels (V: four floats where
// C % 4 == 0) and walks the rows; a block covers `cvn` channel vectors and
// `rp` rows a pass, the blocks of a channel chunk split the rows into `rg`
// groups, and the grid is one cooperative wave: each block writes its
// partials to `scratch`, the grid synchronises once, and every block
// merges all groups' partials in group order (the same bits in every
// block), then writes its rows, last read first as above; it keeps no
// shared-memory copy. A cluster cannot hold these: all of a channel's
// rows would go to at most 16 blocks, where one wave of clusters split by
// channel reads 16-byte pieces of 64-byte rows.
//
// Why a second pair and not a copy to NCHW: UNETR's image decoder works on
// channels-last views of its token maps. Copying them to NCHW around the
// cluster kernels added 340 launches a UNETR training step, and making the
// maps NCHW throughout moved cuDNN's decoder convolutions to FFT
// algorithms, 499 more; this pair keeps the layout and the launch count
// cuDNN's NHWC kernels had. It is slower than those at 24^2 and 48^2
// (17.5 against 12.8 us forward at [20, 64, 24^2]); at 96^2 and 192^2 it
// is faster.
// ---------------------------------------------------------------------------

constexpr int kRowUnroll = 4;     // rows a thread loads a step, forward
constexpr int kRowUnrollBwd = 2;  // and backward (two inputs a row)

struct Rows {
  int rows;       // N * S
  int c;          // channels
  int cvn;        // channel vectors a block covers
  int rp;         // rows a pass of the block covers (kThreads / cvn)
  int nchunk;     // channel chunks: blocks across the channels
  int rg;         // row groups: blocks along the rows
  int per_group;  // rows a group
};

template <typename V>
struct Lanes {
  static constexpr int n = sizeof(V) / sizeof(float);
};

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane(float v, int) { return v; }
__device__ __forceinline__ void set_lane(float4& v, int j, float f) {
  if (j == 0)
    v.x = f;
  else if (j == 1)
    v.y = f;
  else if (j == 2)
    v.z = f;
  else
    v.w = f;
}
__device__ __forceinline__ void set_lane(float& v, int, float f) { v = f; }

// Merge a block's per-thread partials part[t][j] over the rp rows of a
// pass, in a fixed tree; the totals land in the threads of row 0.
template <typename P, int L>
__device__ __forceinline__ void rows_tree(P (*part)[L], int rr, int rp, int cvn) {
  __syncthreads();
  for (int s = 1; s < rp; s <<= 1) {
    if (rr % (2 * s) == 0 && rr + s < rp) {
      const int t = threadIdx.x;
#pragma unroll
      for (int j = 0; j < L; ++j) combine(part[t][j], part[t + s * cvn][j]);
    }
    __syncthreads();
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads, 2)
batchnorm_fwd_rows_kernel(const V* __restrict__ x, V* __restrict__ y,
                          const float* __restrict__ weight, const float* __restrict__ bias,
                          float* __restrict__ stats, float* __restrict__ running_mean,
                          float* __restrict__ running_var, Moments* __restrict__ scratch,
                          float momentum, float eps, const Rows sh) {
  constexpr int L = Lanes<V>::n;
  __shared__ Moments part[kThreads][L];
  const int chunk = blockIdx.x % sh.nchunk;
  const int group = blockIdx.x / sh.nchunk;
  const int lane_cv = threadIdx.x % sh.cvn;
  const int rr = threadIdx.x / sh.cvn;
  const int cv_all = sh.c / L;
  const int cv = chunk * sh.cvn + lane_cv;
  const bool on = rr < sh.rp && cv < cv_all;
  const int r0 = group * sh.per_group;
  const int r1 = min(sh.rows, r0 + sh.per_group);
  const int step = sh.rp * kRowUnroll;
  Moments acc[L];
#pragma unroll
  for (int j = 0; j < L; ++j) acc[j] = Moments{0.0f, 0.0f, 0.0f};
  if (on) {
    for (int r = r0 + rr; r < r1; r += step) {
      V v[kRowUnroll];
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u)
        if (r + u * sh.rp < r1) {
          v[u] = __ldg(x + static_cast<long long>(r + u * sh.rp) * cv_all + cv);
          ++cnt;
        }
      const float n = static_cast<float>(cnt);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        float sum = 0.0f;
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u)
          if (u < cnt) sum += lane(v[u], j);
        const float m = __fdividef(sum, n);
        float m2 = 0.0f;
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u)
          if (u < cnt) {
            const float d = lane(v[u], j) - m;
            m2 += d * d;
          }
        merge(acc[j], Moments{n, m, m2});
      }
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) part[threadIdx.x][j] = acc[j];
  rows_tree(part, rr, sh.rp, sh.cvn);
  if (rr == 0 && cv < cv_all)
#pragma unroll
    for (int j = 0; j < L; ++j)
      scratch[static_cast<long long>(group) * sh.c + cv * L + j] = part[threadIdx.x][j];
  cg::this_grid().sync();
  // every block: the groups' partials of its channels, merged in group order
#pragma unroll
  for (int j = 0; j < L; ++j) acc[j] = Moments{0.0f, 0.0f, 0.0f};
  if (on)
    for (int g = rr; g < sh.rg; g += sh.rp)
#pragma unroll
      for (int j = 0; j < L; ++j)
        merge(acc[j], scratch[static_cast<long long>(g) * sh.c + cv * L + j]);
#pragma unroll
  for (int j = 0; j < L; ++j) part[threadIdx.x][j] = acc[j];
  rows_tree(part, rr, sh.rp, sh.cvn);
  const float count = static_cast<float>(sh.rows);
  float scale[L], shift[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const Moments tot = part[lane_cv][j];
    const int ch = min(cv, cv_all - 1) * L + j;
    const float var = tot.m2 / count;
    const float invstd = 1.0f / sqrtf(var + eps);
    scale[j] = weight[ch] * invstd;
    shift[j] = fmaf(-tot.mean, scale[j], bias[ch]);
    if (group == 0 && rr == 0 && cv < cv_all) {
      stats[ch] = tot.mean;
      stats[sh.c + ch] = invstd;
      if (running_mean != nullptr) {
        const float unbiased =
            var * static_cast<float>(static_cast<double>(sh.rows) / (sh.rows - 1));
        running_mean[ch] = fmaf(momentum, tot.mean, (1.0f - momentum) * running_mean[ch]);
        running_var[ch] = fmaf(momentum, unbiased, (1.0f - momentum) * running_var[ch]);
      }
    }
  }
  if (!on || r0 + rr >= r1) return;
  // the second pass, backwards: the rows read last first
  const int last = r0 + rr + ((r1 - 1 - r0 - rr) / sh.rp) * sh.rp;
  for (int r = last; r >= r0 + rr; r -= sh.rp) {
    const long long o = static_cast<long long>(r) * cv_all + cv;
    V v = __ldg(x + o);
#pragma unroll
    for (int j = 0; j < L; ++j) set_lane(v, j, fmaf(lane(v, j), scale[j], shift[j]));
    y[o] = v;
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads, 2)
batchnorm_bwd_rows_kernel(const V* __restrict__ dy, const V* __restrict__ x,
                          const float* __restrict__ weight, const float* __restrict__ stats,
                          V* __restrict__ dx, float* __restrict__ dweight,
                          float* __restrict__ dbias, float2* __restrict__ scratch,
                          const Rows sh) {
  constexpr int L = Lanes<V>::n;
  __shared__ float2 part[kThreads][L];
  const int chunk = blockIdx.x % sh.nchunk;
  const int group = blockIdx.x / sh.nchunk;
  const int lane_cv = threadIdx.x % sh.cvn;
  const int rr = threadIdx.x / sh.cvn;
  const int cv_all = sh.c / L;
  const int cv = chunk * sh.cvn + lane_cv;
  const bool on = rr < sh.rp && cv < cv_all;
  const int r0 = group * sh.per_group;
  const int r1 = min(sh.rows, r0 + sh.per_group);
  const int step = sh.rp * kRowUnrollBwd;
  float mean[L], invstd[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int ch = min(cv, cv_all - 1) * L + j;
    mean[j] = stats[ch];
    invstd[j] = stats[sh.c + ch];
  }
  float2 acc[L];
#pragma unroll
  for (int j = 0; j < L; ++j) acc[j] = make_float2(0.0f, 0.0f);
  if (on) {
    for (int r = r0 + rr; r < r1; r += step) {
      V g[kRowUnrollBwd], v[kRowUnrollBwd];
#pragma unroll
      for (int u = 0; u < kRowUnrollBwd; ++u)
        if (r + u * sh.rp < r1) {
          const long long o = static_cast<long long>(r + u * sh.rp) * cv_all + cv;
          g[u] = __ldg(dy + o);
          v[u] = __ldg(x + o);
        }
#pragma unroll
      for (int u = 0; u < kRowUnrollBwd; ++u)
        if (r + u * sh.rp < r1)
#pragma unroll
          for (int j = 0; j < L; ++j) {
            acc[j].x += lane(g[u], j);
            acc[j].y += lane(g[u], j) * (lane(v[u], j) - mean[j]);
          }
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) part[threadIdx.x][j] = acc[j];
  rows_tree(part, rr, sh.rp, sh.cvn);
  if (rr == 0 && cv < cv_all)
#pragma unroll
    for (int j = 0; j < L; ++j)
      scratch[static_cast<long long>(group) * sh.c + cv * L + j] = part[threadIdx.x][j];
  cg::this_grid().sync();
#pragma unroll
  for (int j = 0; j < L; ++j) acc[j] = make_float2(0.0f, 0.0f);
  if (on)
    for (int gi = rr; gi < sh.rg; gi += sh.rp)
#pragma unroll
      for (int j = 0; j < L; ++j)
        combine(acc[j], scratch[static_cast<long long>(gi) * sh.c + cv * L + j]);
#pragma unroll
  for (int j = 0; j < L; ++j) part[threadIdx.x][j] = acc[j];
  rows_tree(part, rr, sh.rp, sh.cvn);
  const float count = static_cast<float>(sh.rows);
  float a[L], k1[L], k2[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float2 tot = part[lane_cv][j];
    const int ch = min(cv, cv_all - 1) * L + j;
    a[j] = weight[ch] * invstd[j];
    k1[j] = tot.x / count;
    k2[j] = tot.y * invstd[j] * invstd[j] / count;
    if (group == 0 && rr == 0 && cv < cv_all) {
      if (dweight != nullptr) dweight[ch] = tot.y * invstd[j];
      if (dbias != nullptr) dbias[ch] = tot.x;
    }
  }
  if (!on || dx == nullptr || r0 + rr >= r1) return;
  const int last = r0 + rr + ((r1 - 1 - r0 - rr) / sh.rp) * sh.rp;
  for (int r = last; r >= r0 + rr; r -= sh.rp) {
    const long long o = static_cast<long long>(r) * cv_all + cv;
    const V gv = __ldg(dy + o);
    V v = __ldg(x + o);
#pragma unroll
    for (int j = 0; j < L; ++j)
      set_lane(v, j, bwd1(lane(gv, j), lane(v, j), a[j], k1[j], k2[j], mean[j]));
    dx[o] = v;
  }
}

// A shape and tiling the kernels can run: every value of every channel in
// some rank's share, k a cluster size they take, 32-bit indices, a cache
// within the shared memory the kernels are set up for.
inline bool shape_ok(const Shape& sh, int k) {
  if (sh.n <= 0 || sh.c <= 0 || sh.s <= 0 || sh.per_rank <= 0) return false;
  if (k < 1 || k > kMaxCluster) return false;
  const long long m = static_cast<long long>(sh.n) * sh.s;
  if (m < 2 || static_cast<long long>(sh.per_rank) * k < m) return false;
  return m * sh.c <= INT_MAX && static_cast<long long>(sh.c) * k <= INT_MAX;
}

inline bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Let a kernel run in clusters of 16 and with kCacheBytes of dynamic
// shared memory.
template <typename K>
cudaError_t allow_large(K* kernel) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kCacheBytes);
  return err;
}

// allow_large for two kernels.
template <typename K1, typename K2>
cudaError_t allow_large(K1* a, K2* b) {
  const cudaError_t err = allow_large(a);
  return err == cudaSuccess ? allow_large(b) : err;
}

// Launch `kernel` over c * k blocks in clusters of k, each block caching
// up to kCacheBytes of its `inputs` inputs (the cache is set in `sh`).
template <typename V, typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), Shape& sh, int k, int inputs,
                    cudaStream_t stream, Args... args) {
  const long long share_v = sh.per_rank / static_cast<long long>(sizeof(V) / sizeof(float));
  sh.cache = static_cast<int>(
      std::min(share_v, kCacheBytes / static_cast<long long>(inputs * sizeof(V))));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(sh.c * k));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(sh.cache) * inputs * sizeof(V);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args..., sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The grid of a channels-last call over `rows` rows of c channels (lanes
// floats a vector) with at most max_blocks blocks: each thread at least
// four steps of rows (one step a thread measured slower over UNETR's
// channels-last shapes as a whole), and no more blocks than fit at once.
inline Rows rows_plan(int rows, int c, int lanes, int unroll, int max_blocks) {
  Rows sh;
  sh.rows = rows;
  sh.c = c;
  const int cv = c / lanes;
  sh.cvn = std::min(cv, kThreads);
  sh.nchunk = (cv + sh.cvn - 1) / sh.cvn;
  sh.rp = kThreads / sh.cvn;
  const int rows_a_block = sh.rp * unroll * 4;
  sh.rg = std::max(1, std::min((rows + rows_a_block - 1) / rows_a_block,
                               max_blocks / sh.nchunk));
  sh.per_group = (rows + sh.rg - 1) / sh.rg;
  return sh;
}

inline bool rows_ok(int rows, int c, int scratch_groups) {
  return rows >= 2 && c >= 1 && scratch_groups >= 1 &&
         static_cast<long long>(rows) * c <= INT_MAX;
}

// Blocks of `kernel` the card runs at once.
template <typename K>
int coresident(K* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// Launch `kernel` over `blocks` blocks as one cooperative grid (all
// resident at once, so grid.sync() may wait for every block).
template <typename... Params, typename... Args>
int launch_cooperative(void (*kernel)(Params...), int blocks, cudaStream_t stream,
                       Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: [n, c, s] float32; weight, bias: [c]; stats: [2, c] receives
// (mean, 1 / sqrt(biased var + eps)); running_mean and running_var ([c])
// are updated with `momentum` unless both are null. (k, per_rank) from the
// wrapper's planner, per_rank in values; each block keeps up to
// kCacheBytes of x in shared memory between its two passes.
int bn_fwd(const void* x, void* y, const void* weight, const void* bias, void* stats,
           void* running_mean, void* running_var, int n, int c, int s, int k, int per_rank,
           float momentum, float eps, void* stream) {
  static const cudaError_t ready =
      allow_large(batchnorm_fwd_kernel<float4>, batchnorm_fwd_kernel<float>);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  Shape sh = {n, c, s, per_rank, 0};
  if (!shape_ok(sh, k) || (running_mean == nullptr) != (running_var == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  float* sp = static_cast<float*>(stats);
  float* rm = static_cast<float*>(running_mean);
  float* rv = static_cast<float*>(running_var);
  if (s % 4 == 0 && per_rank % 4 == 0 && aligned(x) && aligned(y))
    return launch_clusters<float4>(batchnorm_fwd_kernel<float4>, sh, k, 1, st,
                                   static_cast<const float4*>(x), static_cast<float4*>(y), w, b,
                                   sp, rm, rv, momentum, eps);
  return launch_clusters<float>(batchnorm_fwd_kernel<float>, sh, k, 1, st,
                                static_cast<const float*>(x), static_cast<float*>(y), w, b, sp,
                                rm, rv, momentum, eps);
}

// dy, x, dx: [n, c, s] float32; weight: [c]; stats: the forward's [2, c].
// dx, dweight and dbias ([c]) may each be null: that output is not written.
// Each block keeps up to kCacheBytes of dy and x in shared memory.
int bn_bwd(const void* dy, const void* x, const void* weight, const void* stats, void* dx,
           void* dweight, void* dbias, int n, int c, int s, int k, int per_rank,
           void* stream) {
  static const cudaError_t ready =
      allow_large(batchnorm_bwd_kernel<float4>, batchnorm_bwd_kernel<float>);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  Shape sh = {n, c, s, per_rank, 0};
  if (!shape_ok(sh, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weight);
  const float* sp = static_cast<const float*>(stats);
  float* dw = static_cast<float*>(dweight);
  float* db = static_cast<float*>(dbias);
  if (s % 4 == 0 && per_rank % 4 == 0 && aligned(dy) && aligned(x) && aligned(dx))
    return launch_clusters<float4>(batchnorm_bwd_kernel<float4>, sh, k, 2, st,
                                   static_cast<const float4*>(dy), static_cast<const float4*>(x),
                                   w, sp, static_cast<float4*>(dx), dw, db);
  return launch_clusters<float>(batchnorm_bwd_kernel<float>, sh, k, 2, st,
                                static_cast<const float*>(dy), static_cast<const float*>(x), w,
                                sp, static_cast<float*>(dx), dw, db);
}

// *out = how many clusters of k blocks, each with kCacheBytes of dynamic
// shared memory, the card runs at once: the fewer of the two kernels'.
int bn_max_clusters(int k, int* out) {
  if (k < 1 || k > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_large(batchnorm_fwd_kernel<float4>, batchnorm_bwd_kernel<float4>);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(k));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(kCacheBytes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fwd = 0, bwd = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&fwd, batchnorm_fwd_kernel<float4>, &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&bwd, batchnorm_bwd_kernel<float4>, &cfg);
  *out = std::min(fwd, bwd);
  return static_cast<int>(err);
}

// The channels-last pair: x, y (dy, x, dx) hold `rows` rows of c values;
// the rest as bn_fwd (bn_bwd). scratch holds scratch_groups x c partials
// (3 floats each forward, 2 backward), written before they are read.
int bn_fwd_rows(const void* x, void* y, const void* weight, const void* bias, void* stats,
                void* running_mean, void* running_var, void* scratch, int scratch_groups,
                int rows, int c, float momentum, float eps, void* stream) {
  if (!rows_ok(rows, c, scratch_groups) || (running_mean == nullptr) != (running_var == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static const int vec_blocks = coresident(batchnorm_fwd_rows_kernel<float4>);
  static const int scalar_blocks = coresident(batchnorm_fwd_rows_kernel<float>);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  float* sp = static_cast<float*>(stats);
  float* rm = static_cast<float*>(running_mean);
  float* rv = static_cast<float*>(running_var);
  Moments* part = static_cast<Moments*>(scratch);
  if (c % 4 == 0 && aligned(x) && aligned(y)) {
    const Rows sh = rows_plan(rows, c, 4, kRowUnroll, std::min(vec_blocks, scratch_groups));
    return launch_cooperative(batchnorm_fwd_rows_kernel<float4>, sh.nchunk * sh.rg, st,
                              static_cast<const float4*>(x), static_cast<float4*>(y), w, b, sp,
                              rm, rv, part, momentum, eps, sh);
  }
  const Rows sh = rows_plan(rows, c, 1, kRowUnroll, std::min(scalar_blocks, scratch_groups));
  return launch_cooperative(batchnorm_fwd_rows_kernel<float>, sh.nchunk * sh.rg, st,
                            static_cast<const float*>(x), static_cast<float*>(y), w, b, sp, rm,
                            rv, part, momentum, eps, sh);
}

int bn_bwd_rows(const void* dy, const void* x, const void* weight, const void* stats, void* dx,
                void* dweight, void* dbias, void* scratch, int scratch_groups, int rows, int c,
                void* stream) {
  if (!rows_ok(rows, c, scratch_groups)) return static_cast<int>(cudaErrorInvalidValue);
  static const int vec_blocks = coresident(batchnorm_bwd_rows_kernel<float4>);
  static const int scalar_blocks = coresident(batchnorm_bwd_rows_kernel<float>);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weight);
  const float* sp = static_cast<const float*>(stats);
  float* dw = static_cast<float*>(dweight);
  float* db = static_cast<float*>(dbias);
  float2* part = static_cast<float2*>(scratch);
  if (c % 4 == 0 && aligned(dy) && aligned(x) && aligned(dx)) {
    const Rows sh = rows_plan(rows, c, 4, kRowUnrollBwd, std::min(vec_blocks, scratch_groups));
    return launch_cooperative(batchnorm_bwd_rows_kernel<float4>, sh.nchunk * sh.rg, st,
                              static_cast<const float4*>(dy), static_cast<const float4*>(x), w,
                              sp, static_cast<float4*>(dx), dw, db, part, sh);
  }
  const Rows sh = rows_plan(rows, c, 1, kRowUnrollBwd, std::min(scalar_blocks, scratch_groups));
  return launch_cooperative(batchnorm_bwd_rows_kernel<float>, sh.nchunk * sh.rg, st,
                            static_cast<const float*>(dy), static_cast<const float*>(x), w, sp,
                            static_cast<float*>(dx), dw, db, part, sh);
}

// *out = the most blocks a channels-last launch takes: the scratch a
// caller gives holds that many groups.
int bn_rows_max_blocks(int* out) {
  *out = std::min(std::min(coresident(batchnorm_fwd_rows_kernel<float4>),
                           coresident(batchnorm_fwd_rows_kernel<float>)),
                  std::min(coresident(batchnorm_bwd_rows_kernel<float4>),
                           coresident(batchnorm_bwd_rows_kernel<float>)));
  return *out > 0 ? 0 : static_cast<int>(cudaErrorInvalidDevice);
}

}  // extern "C"
