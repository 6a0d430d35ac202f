// Fused 3x3 convolution + BatchNorm statistics for Hopper (sm_90a): a
// same-padding, stride-1 3x3 convolution with bias, NCHW float32, whose
// epilogue sums y and y^2 per output channel.
//
// Replaces scripts/proto_conv_bn_fusion.py::_kernel (launched by
// conv3x3_bn_stats_pallas), whose grid ran its batch steps in order and
// carried the channel sums in its output block. Here blocks run in no order:
// each reduces its own sums (shuffles, then shared memory) and adds them into
// a zeroed [2, Cout] float64 buffer, one atomicAdd a channel and sum.
// Float64 keeps the run-to-run order of those additions below float32
// rounding and keeps E[y^2] - mean^2 free of cancellation.
//
// Design: an implicit GEMM on the tensor cores (wgmma), M = pixels, N = the
// block's output channels, K = 9 taps x 8-channel chunks. A persistent block
// keeps its channels' weights in shared memory, split once into TF32 B tiles;
// x streams through a ring of three slots, one TMA box (8 channels of a tile
// with its 1-pixel halo, zero outside the image) a chunk, two chunks ahead.
// Each tap is a shifted view of that box: a warp loads its A fragment from
// shared memory and splits it in registers; nothing is written as im2col.
//
// Why 3xTF32: one TF32 product keeps about 3 decimal digits, far outside the
// prototype's tolerance on y (tests/test_torch_port_conv_bn_stats.py emulates
// both). Each operand is split as hi = rna(v), lo = rna(v - hi), and the
// product is lo*hi + hi*lo + hi*hi: products of two TF32 values are exact in
// float32, so the error left is the dropped lo*lo term (~2^-22) and the
// summation. The tensor cores' float32 accumulation does not round to
// nearest, and summing every tap there biased the channel means. So the
// tensor cores sum only the three taps of one column shift, from zero, and a
// float32 round-to-nearest addition takes each such sum.
//
// Bound: 2 * 9 * Cin * Cout products a pixel, three times over for the
// split, at 495 TFLOP/s of dense TF32, against the bytes of x and y at
// 3.35 TB/s: bytes at 192^2 x 16 channels, products at 96^2 x 32 and
// 48^2 x 64 (PERF.md, kernel table).
//
// Two tile shapes, both 16 x 16 pixels: Cfg<32, 2, 2> (32 output channels,
// two warpgroups) wherever Cout > 16 and 32 channels' weights fit, which
// covers the encoder's 32 and 64 channels; Cfg<16, 4, 1> otherwise.
//
// nvcc -Xptxas -v for sm_90a (CUDA 12.8, as chip_smoke.py prints it): 128 /
// 149 registers for Cfg<16, 4, 1> / <32, 2, 2>, one barrier, no stack frame,
// no spills, no static shared memory. Dynamic shared memory (three x slots,
// the resident B tiles, the reduction scratch and three mbarriers): 65.8 KiB
// at 192^2 x 16 channels (Cfg<16, 4, 1>), 121.3 KiB at 96^2 x 32 and
// 193.3 KiB at 48^2 x 64 (Cfg<32, 2, 2>; at Cin = 64 a block holds 32 output
// channels, so two blocks stage each x box).
//
// The entry point returns a CUDA error code right after its launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCi = 8;        // input channels per staged chunk: the product's K
constexpr size_t kWeightBudget = 150 * 1024;   // bytes of resident B tiles a block may hold

// N output channels a block computes (its channel group); WG warpgroups a
// block, MT m-tiles of 64 pixels (4 rows x 16, one row a warp) a warpgroup.
// A tile is 16 x 16 pixels.
template <int N_, int MT_, int WG_>
struct Cfg {
  static constexpr int N = N_, MT = MT_, WG = WG_;
  static constexpr int kTW = 16;
  static constexpr int kTH = 4 * MT * WG;
  static_assert(kTH == 16, "the row pitch below keeps A reads conflict-free for 16-row tiles");
  static constexpr int kWarps = 4 * WG;
  static constexpr int kThreads = 32 * kWarps;
  // smem column s <-> image column tile_x - 4 + s; the taps read s = 3 .. 20.
  // A box starts on a 16-byte boundary of its row (a 20-column box at
  // tile_x - 2 stopped the kernel with an illegal instruction on an H100),
  // and rows of 28 floats make a plane of 18 * 28 = 24 mod 32 floats, so the
  // 32 lanes' A reads (8 pixels x 4 channels) fall on 32 banks; rows of 24
  // floats would not.
  static constexpr int kRow = 28;
  static constexpr int kPlane = (kTH + 2) * kRow;
  static constexpr int kXStage = kCi * kPlane;         // floats of one x slot (one TMA box)
  static constexpr int kBTile = N * kCi;               // floats of one tap's hi (or lo) B tile
  static constexpr int kBChunk = 18 * kBTile;          // floats of one chunk's B tiles
  // shared memory for `nchunks` chunks of resident weights
  static size_t smem(int nchunks) {
    return 4 * ((size_t)3 * kXStage + (size_t)nchunks * kBChunk + kWarps * 2 * N) + 3 * 8;
  }
};

// v = hi + lo in TF32 parts. hi is v rounded to TF32, to nearest with ties
// away from zero, as cvt.rna.tf32.f32 rounds a finite value (which sm_90
// emulates in four instructions; two integer ones do it here). lo = v - hi
// is exact in float32; it is rounded the same way by adding half of its 13
// dropped bits, since the tensor cores ignore those bits of an operand.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers that an asynchronous product reads or writes stay where they are
// until this point.
__device__ __forceinline__ void hold(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void hold(uint32_t& v) { asm volatile("" : "+r"(v)::"memory"); }

// Shared-memory matrix descriptor of a K-major B tile without swizzling:
// core matrices of 8 output channels x 4 TF32 values (128 bytes), the two
// K halves 128 bytes apart, groups of 8 channels 256 bytes apart.
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3ffff) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// The A fragment of one warp's 16 rows (pixels g and g + 8, channels t and
// t + 4 of the chunk), split into TF32 hi and lo parts.
__device__ __forceinline__ void load_a(uint32_t (&ah)[4], uint32_t (&al)[4], const float* p,
                                       int plane) {
  split_tf32(p[0], ah[0], al[0]);
  split_tf32(p[8], ah[1], al[1]);
  split_tf32(p[4 * plane], ah[2], al[2]);
  split_tf32(p[4 * plane + 8], ah[3], al[3]);
}

// A 4-byte copy; with ok == false it writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
// One TMA copy of the box at (x0, y0, c0, b) of the [B, C, H, W] tensor map
// into dst; out-of-bounds elements are zeros. Completes on `bar`.
__device__ __forceinline__ void tma_load_box(float* dst, const CUtensorMap* map, int x0, int y0,
                                             int c0, int b, uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(y0), "r"(c0), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

struct Args {
  const float* x;
  const float* w;
  const float* bias;
  float* y;
  double* sums;
  int batch, cin, cout, height, width, tiles_x, tiles_y, nchunks;
  bool tma;   // x streams by TMA (W % 4 == 0, x 16-byte aligned: 16-byte global strides),
              // else by 4-byte cp.async
};

// A persistent block computes output channels [N * blockIdx.y, + N) for the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ... of all images. It splits
// its channels' weights into TF32 B tiles once and keeps them in shared
// memory; only x streams, one 8-channel chunk of one tile at a time,
// through a ring of three slots filled two chunks ahead: one TMA box a
// chunk, or 4-byte cp.async copies where the tensor map cannot describe x.
// Each channel group stages its own boxes: the group blocks of a tile run at
// about the same time, so the second read of a box comes from L2 (sharing
// it by cluster multicast measured slower on an H100; PERF.md §6).
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    conv3x3_bn_stats_kernel(const Args a, const __grid_constant__ CUtensorMap xmap) {
  constexpr int N = C::N, MT = C::MT, kTW = C::kTW, kTH = C::kTH, NT = N / 8;
  extern __shared__ __align__(128) float smem[];
  float* xs = smem;                                          // [3][kCi][kPlane]
  float* bt = xs + 3 * C::kXStage;                           // [nchunks][9][hi, lo][kBTile]
  float* red = bt + a.nchunks * C::kBChunk;                  // [kWarps][2][N]
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + C::kWarps * 2 * N);   // [3], one per x slot

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;     // the fragment's row group
  const int t = lane & 3;      // the thread in its group
  const int warp = tid >> 5;
  const int wg = warp / 4;
  const int wl = warp % 4;
  const int cin = a.cin, cout = a.cout, height = a.height, width = a.width;
  const int nchunks = a.nchunks;
  const int co0 = blockIdx.y * N;
  const long long plane = (long long)height * width;
  const int tiles = a.batch * a.tiles_y * a.tiles_x;
  const int my_tiles = tiles > (int)blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int items = my_tiles * nchunks;

  // Stage chunk (item % nchunks) of tile (item / nchunks) into x slot
  // item % 3: 8 channel planes of the tile with a 1-pixel halo, zero
  // outside the image.
  auto stage = [&](int item) {
    const int tile = blockIdx.x + (item / nchunks) * gridDim.x;
    const int ci0 = (item % nchunks) * kCi;
    const int tile_x = (tile % a.tiles_x) * kTW;
    const int tile_y = (tile / a.tiles_x % a.tiles_y) * kTH;
    const int b = tile / (a.tiles_x * a.tiles_y);
    float* xd = xs + (item % 3) * C::kXStage;
    if (a.tma) {
      if (tid == 0)
        tma_load_box(xd, &xmap, tile_x - 4, tile_y - 1, ci0, b, bar + item % 3, 4 * C::kXStage);
      return;
    }
    // the columns the taps read: smem 3 .. kTW + 4 <-> image tile_x - 1 .. tile_x + kTW;
    // consecutive threads copy consecutive columns, so a warp's copies coalesce
    const float* xb = a.x + (long long)b * cin * plane;
    constexpr int kC = kTW + 2;
#pragma unroll 1
    for (int i = tid; i < kCi * (kTH + 2) * kC; i += C::kThreads) {
      const int c = i % kC;
      const int row = i / kC;
      const int ci = row / (kTH + 2);
      const int r = row - ci * (kTH + 2);
      const int gy = tile_y - 1 + r;
      const int gx = tile_x - 1 + c;
      const bool ok = ci0 + ci < cin && gy >= 0 && gy < height && gx >= 0 && gx < width;
      cp_async4(xd + ci * C::kPlane + r * C::kRow + c + 3,
                ok ? xb + (ci0 + ci) * plane + (long long)gy * width + gx : a.x, ok);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (items > 0) stage(0);
  cp_async_commit();
  if (items > 1) stage(1);
  cp_async_commit();

  // The B tiles of every chunk, read once from device memory: chunk, tap,
  // hi/lo, then K-major core matrices of 8 channels x 4 input channels
  // (128 bytes). Channels at or above Cout and input channels at or above
  // Cin are zero.
#pragma unroll 1
  for (int i = tid; i < nchunks * N * kCi; i += C::kThreads) {
    const int ci = i % kCi;
    const int n = (i / kCi) % N;
    const int c = i / (kCi * N);
    const bool ok = co0 + n < cout && c * kCi + ci < cin;
    const float* src = a.w + ((long long)(co0 + n) * cin + c * kCi + ci) * 9;
    float* dst = bt + c * C::kBChunk + (n / 8) * 64 + (ci / 4) * 32 + (n % 8) * 4 + (ci % 4);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t hi, lo;
      split_tf32(ok ? __ldg(src + tap) : 0.0f, hi, lo);
      dst[(2 * tap) * C::kBTile] = __uint_as_float(hi);
      dst[(2 * tap + 1) * C::kBTile] = __uint_as_float(lo);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  float bb[NT][2], s1[NT][2], s2[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = co0 + n * 8 + 2 * t + j;
      bb[n][j] = co < cout ? __ldg(a.bias + co) : 0.0f;
      s1[n][j] = 0.0f;
      s2[n][j] = 0.0f;
    }
  float acc[MT][N / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.0f;

#pragma unroll 1
  for (int item = 0; item < items; ++item) {
    // this item has landed (the next may be in flight); every warp is done
    // with the slot the item after next will fill
    if (a.tma) mbar_wait(bar + item % 3, (item / 3) & 1);
    else cp_async_wait<1>();
    __syncthreads();
    if (item + 2 < items) stage(item + 2);
    cp_async_commit();

    const int k = item % nchunks;
    const float* btk = bt + k * C::kBChunk;
    const float* xsl = xs + (item % 3) * C::kXStage + t * C::kPlane + (wg * MT * 4 + wl) * C::kRow + g + 3;
    // Group q = (dx, m) holds the three taps of column shift dx for m-tile
    // m: the tensor cores sum their products from zero (lo*hi, hi*lo and
    // hi*hi for each tap) while the warps load the next group's A
    // fragments; the float32 accumulator takes the sum once the group is
    // done. Two groups are in flight, each with its own sum and A registers.
    float sum[2][N / 2];
    uint32_t ah[2][3][4], al[2][3][4];
#pragma unroll
    for (int q = 0; q <= 3 * MT; ++q) {
      const int cur = q & 1;
      if (q < 3 * MT) {
        const int dx = q / MT, m = q % MT;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
          load_a(ah[cur][dy], al[cur][dy], xsl + (m * 4 + dy) * C::kRow + dx, C::kPlane);
        wgmma_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int tap = dy * 3 + dx;
          const uint64_t dh = b_desc(btk + (2 * tap) * C::kBTile);
          const uint64_t dl = b_desc(btk + (2 * tap + 1) * C::kBTile);
          wgmma_tf32<N>(sum[cur], al[cur][dy], dh, dy);
          wgmma_tf32<N>(sum[cur], ah[cur][dy], dl, 1);
          wgmma_tf32<N>(sum[cur], ah[cur][dy], dh, 1);
        }
        wgmma_commit();
      }
      if (q > 0) {
        // group q - 1 is done once at most one group is pending
        const int prev = cur ^ 1;
        if (q < 3 * MT) wgmma_wait<1>(); else wgmma_wait<0>();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hold(ah[prev][dy][i]);
            hold(al[prev][dy][i]);
          }
        const int m = (q - 1) % MT;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          hold(sum[prev][i]);
          acc[m][i] += sum[prev][i];
        }
      }
    }

    if (k == nchunks - 1) {
      // the tile is done: bias, store, and this thread's share of the
      // channel sums. Thread (g, t) of a warp holds pixels g and g + 8 of
      // its row in each m-tile for channels 2t and 2t + 1 of each group of 8.
      const int tile = blockIdx.x + (item / nchunks) * gridDim.x;
      const int tile_x = (tile % a.tiles_x) * kTW;
      const int tile_y = (tile / a.tiles_x % a.tiles_y) * kTH;
      const int b = tile / (a.tiles_x * a.tiles_y);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int oy = tile_y + (wg * MT + m) * 4 + wl;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ox = tile_x + g + 8 * h;
          const bool inside = oy < height && ox < width;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int co = co0 + n * 8 + 2 * t + j;
              const float val = acc[m][4 * n + 2 * h + j] + bb[n][j];
              if (inside && co < cout)
                a.y[((long long)b * cout + co) * plane + (long long)oy * width + ox] = val;
              if (inside) {
                s1[n][j] += val;
                s2[n][j] += val * val;
              }
            }
        }
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.0f;
      }
    }
  }

  // the block's channel sums: shuffles over the 8 threads of a channel,
  // then the warps in shared memory, then one float64 atomicAdd a channel
  // and sum
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[n][j] += __shfl_xor_sync(0xffffffffu, s1[n][j], off);
        s2[n][j] += __shfl_xor_sync(0xffffffffu, s2[n][j], off);
      }
      if (g == 0) {
        const int c = n * 8 + 2 * t + j;
        red[(warp * 2 + 0) * N + c] = s1[n][j];
        red[(warp * 2 + 1) * N + c] = s2[n][j];
      }
    }
  __syncthreads();
  for (int i = tid; i < 2 * N; i += C::kThreads) {
    const int k = i / N;
    const int c = i % N;
    if (co0 + c < cout) {
      double total = 0.0;
      for (int w = 0; w < C::kWarps; ++w) total += (double)red[(w * 2 + k) * N + c];
      atomicAdd(a.sums + k * cout + co0 + c, total);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, found through the runtime (no
// link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <class C>
int run(Args a, int groups, cudaStream_t stream) {
  CUtensorMap xmap{};
  if (a.tma) {
    // x as [B, C, H, W], boxes of 1 image x 8 channels x (kTH + 2) rows x 28 columns
    const EncodeTiled encode = encode_tiled();
    if (!encode) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[4] = {(cuuint64_t)a.width, (cuuint64_t)a.height, (cuuint64_t)a.cin,
                                (cuuint64_t)a.batch};
    const cuuint64_t strides[3] = {(cuuint64_t)a.width * 4, (cuuint64_t)a.width * a.height * 4,
                                   (cuuint64_t)a.width * a.height * a.cin * 4};
    const cuuint32_t box[4] = {C::kRow, C::kTH + 2, kCi, 1};
    const cuuint32_t estrides[4] = {1, 1, 1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(a.x), dims, strides,
               box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = C::smem(a.nchunks);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv3x3_bn_stats_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_bn_stats_kernel<C>,
                                                        C::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  a.tiles_x = (a.width + C::kTW - 1) / C::kTW;
  a.tiles_y = (a.height + C::kTH - 1) / C::kTH;
  const int tiles = a.batch * a.tiles_x * a.tiles_y;
  const int blocks = max(1, min(tiles, sms * per_sm / groups));
  conv3x3_bn_stats_kernel<C><<<dim3(blocks, groups), C::kThreads, smem, stream>>>(a, xmap);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

extern "C" {

// x: [B, Cin, H, W] float32; w: [Cout, Cin, 3, 3] float32; bias: [Cout];
// y: [B, Cout, H, W] float32; sums: zeroed [2, Cout] float64 (sum y, sum y^2).
// Returns cudaErrorInvalidValue for a shape the kernel does not take: an
// empty dimension, or more input channels than the resident B tiles of a
// 16-channel group fit in kWeightBudget (Cin > 128).
int conv3x3_bn_stats(const void* x, const void* w, const void* bias, void* y, void* sums,
                     int batch, int cin, int cout, int height, int width, void* stream) {
  if (batch <= 0 || cin <= 0 || cout <= 0 || height <= 0 || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (cin + kCi - 1) / kCi;
  // a group of 32 output channels (the encoder's 32 and 64); 16 where Cout
  // is at most 16 or 32 channels' B tiles do not fit
  const auto fits = [&](int n) { return (size_t)nchunks * 18 * n * kCi * 4 <= kWeightBudget; };
  const int n = cout > 16 && fits(32) ? 32 : 16;
  if (!fits(n)) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (cout + n - 1) / n;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  Args a{static_cast<const float*>(x), static_cast<const float*>(w),
         static_cast<const float*>(bias), static_cast<float*>(y), static_cast<double*>(sums),
         batch, cin, cout, height, width, 0, 0, nchunks, aligned(x) && width % 4 == 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 32) return run<Cfg<32, 2, 2>>(a, groups, s);
  return run<Cfg<16, 4, 1>>(a, groups, s);
}

}  // extern "C"
