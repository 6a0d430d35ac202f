// Float32 GEMM for Hopper (sm_90a) on the tensor cores, at float32's
// accuracy: C(p, q) = sum_r A(p, r) B(q, r) (+ bias), the three products of
// a linear layer (ops/linear_kernels.py maps each onto it):
//
//   forward  Y = X W^T (+ b)      dX = dY W      dW = dY^T X, db = sum_m dY
//
// Replaces cuBLAS's float32 sgemm (the FFMA kernels `sm80_xmma_gemm_f32f32_*`
// and `cutlass_80_simt_sgemm_*`) under layers.Linear; it replaces no TPU
// kernel: the JAX package's Dense is an XLA dot.
//
// Why split TF32 (3xTF32). One TF32 product keeps about 3 decimal digits,
// which fails the float32 training's checks. Each operand is split as
// hi = rna(v), lo = rna(v - hi) (TF32, rounded to nearest with ties away from
// zero), and the product is lo*hi + hi*lo + hi*hi: products of two TF32
// values are exact in float32, |lo| <= 2^-12 |v|, so the dropped lo*lo term
// and lo's own rounding are near 2^-24 of a product. The tensor cores'
// float32 accumulation truncates, and summing a long contraction there
// biases the result (PR 3's finding on the conv kernel; Ootomo & Yokota,
// IJHPCA 2022). So the tensor cores sum only one k-block of 32 from zero
// (4 steps of 8, three products each), and a float32 round-to-nearest
// addition carries each block into the accumulator
// (tests/test_torch_port_linear_kernels.py emulates the scheme).
//
// Bound: 3 x 2 P Q R operations at 495 TFLOP/s of dense TF32 against the
// bytes of A, B and C at 3.35 TB/s. The ViT-B/16 products (P or Q = 2880
// tokens, the others 768 to 3072) are bound by the operations; Swin-UNETR's
// first stages (up to 192080 tokens by 48 to 192 features) by the bytes.
//
// Tile plans (ops/linear_kernels.plan, from the shape): the ViT's forwards
// and dX take 144 columns with the 2880 tokens as C's columns (the 768 to
// 3072 features as its rows: 120 to 480 tiles, near whole waves of 132
// SMs), its dW 144 columns with the 90 k-blocks of the tokens cut into 6 to
// 7 shares; Swin's first stages (K or N = 48 to 192) take the tokens as
// C's rows and 48, 96 or 144 columns, whole in N, and their dW cuts up to
// 6003 k-blocks into up to 128 shares, which fills the card where C is a
// single 48 x 48 tile.
//
// Design. A block is a producer warpgroup and two consumer warpgroups and
// owns 128 rows of C by BQ columns (BQ = 48, 96 or 144, chosen from the
// shape by ops/linear_kernels.plan; a contraction can be split over blocks
// for dW, whose partial sums are then added with atomics into a zeroed C).
// Blocks are persistent and walk the tiles (q fastest, so the blocks that
// run together share A's rows in L2). Warp 0 of the producer issues TMA
// loads of A's 128 x 32 and B's BQ x 32 tiles into a ring of stages;
// warps 1-3 split B in place in shared memory into TF32 hi and lo tiles in
// the 128-byte-swizzled K-major layout that wgmma reads; each consumer
// warpgroup loads its 64 rows of A into registers, splits them there, and
// runs the twelve m64nBQk8 products of a k-block. Per k-block the block
// moves its two tiles from L2 (34 KB at 144 columns), which holds it near
// half of the tensor cores' rate at the ViT's shapes (PERF.md, rows 9-10).
// A may be stored with its contraction index as its row index (dX's W^T,
// dW's dY^T): it is then read from 64-byte-swizzled 16 x 32 boxes, as the
// registers take any layout. B is always K-major, since wgmma reads TF32
// from shared memory only so: the wrapper hands in X^T for dW and W^T for
// dX with the tokens as C's rows (a transposing split in shared memory ran
// those products at a third of the rate).
//
// The entry point returns a CUDA error code right after its launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kBK = 32;             // contraction values a k-block: one 128-byte row
constexpr int kBP = 128;            // rows of C a tile: two consumer warpgroups of 64
constexpr int kThreads = 384;       // the producer warpgroup and two consumers
constexpr int kMaxStages = 8;
constexpr int kSmem = 227 * 1024;   // shared memory a block may use
constexpr int kATile = kBP * kBK * 4;   // bytes of one stage's A tile

struct Args {
  const float* bias;   // [Q] or [P] (bias_on_p), or null
  float* c;            // C(p, q) at c[p * sp + q * sq]
  float* db;           // [P]: the row sums of A, or null
  long long sp, sq;
  int P, Q, R;
  int a_mn;           // 1 where A is stored [R, P], else [P, R]; B is stored [Q, R]
  int bias_on_p;
  int p_tiles, q_tiles, kb_total, kb_per, units;
  int stages, stage_bytes;
};

// v = hi + lo in TF32 parts, hi rounded to nearest with ties away from zero
// (cvt.rna.tf32.f32); lo = v - hi is exact in float32 and is rounded the
// same way by adding half of its 13 dropped bits, which the tensor cores
// ignore.
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
__device__ __forceinline__ void wgmma_tf32<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t desc,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t desc,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<144>(float (&d)[72], const uint32_t (&a)[4], uint64_t desc,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71}, "
      "{%72, %73, %74, %75}, %76, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Registers that an asynchronous product reads or writes stay where they are
// until this point.
__device__ __forceinline__ void hold(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void hold(uint32_t& v) { asm volatile("" : "+r"(v)::"memory"); }

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle
// (rows of 32 TF32 values, 8-row groups 1024 bytes apart; the tile starts
// on a 1024-byte boundary). Step k of 8 starts 32 bytes further.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
// One TMA copy of the box at (x0, x1) of a 2-D tensor map into dst;
// out-of-bounds elements are zeros. Completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x0, int x1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(x1), "r"(smem_u32(bar))
      : "memory");
}

// The k-blocks of this block's tiles, in order: tile `unit` (q fastest,
// then p, then the contraction's split) and its k-blocks [kb, kb_end).
struct Cursor {
  int unit, kb, kb_end, item;
  __device__ void seek(const Args& a) {
    for (; unit < a.units; unit += gridDim.x) {
      kb = unit / (a.q_tiles * a.p_tiles) * a.kb_per;
      kb_end = min(a.kb_total, kb + a.kb_per);
      if (kb < kb_end) return;
    }
  }
  __device__ void start(const Args& a) {
    unit = blockIdx.x;
    item = 0;
    seek(a);
  }
  // true where the k-block just done was its tile's last
  __device__ bool next(const Args& a) {
    ++item;
    if (++kb < kb_end) return false;
    unit += gridDim.x;
    seek(a);
    return true;
  }
};

template <int BQ>
__global__ void __launch_bounds__(kThreads, 1)
    linear_gemm_kernel(const Args a, const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap) {
  constexpr int kBTile = BQ * kBK * 4;   // bytes of one B tile (hi or lo)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.stages * a.stage_bytes);
  uint64_t* ready = full + kMaxStages;
  uint64_t* empty = ready + kMaxStages;
  // stage s: A tile, B tile as loaded and then its hi part in place, B lo
  auto a_tile = [&](int s) { return smem + s * a.stage_bytes; };
  auto b_hi = [&](int s) { return a_tile(s) + kATile; };
  auto b_lo = [&](int s) { return b_hi(s) + kBTile; };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = tid / 32 % 4;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 1);
      mbar_init(empty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    Cursor cur;
    cur.start(a);
    if (warp == 0) {
      // the loader: one thread keeps every stage's TMA copies in flight
      if (lane != 0) return;
      const uint32_t bytes = kATile + kBTile;
      while (cur.unit < a.units) {
        const int s = cur.item % a.stages;
        if (cur.item >= a.stages) mbar_wait(empty + s, ((cur.item / a.stages) & 1) ^ 1);
        const int p0 = cur.unit / a.q_tiles % a.p_tiles * kBP;
        const int q0 = cur.unit % a.q_tiles * BQ;
        const int r0 = cur.kb * kBK;
        mbar_expect(full + s, bytes);
        if (a.a_mn) {
          for (int b = 0; b < kBP / 16; ++b)
            tma_load(a_tile(s) + b * 2048, &amap, p0 + 16 * b, r0, full + s);
        } else {
          tma_load(a_tile(s), &amap, r0, p0, full + s);
        }
        tma_load(b_hi(s), &bmap, r0, q0, full + s);
        cur.next(a);
      }
      return;
    }
    // the splitters (warps 1-3): B's tile into TF32 hi (in place) and lo
    // tiles, both in the layout TMA loaded: K-major in the 128-byte swizzle
    const int st = tid - 32;
    while (cur.unit < a.units) {
      const int s = cur.item % a.stages;
      mbar_wait(full + s, (cur.item / a.stages) & 1);
      uint4* hi = reinterpret_cast<uint4*>(b_hi(s));
      uint4* lo = reinterpret_cast<uint4*>(b_lo(s));
#pragma unroll 1
      for (int i = st; i < BQ * 8; i += 96) {
        uint4 v = hi[i];
        uint4 l;
        split_tf32(__uint_as_float(v.x), v.x, l.x);
        split_tf32(__uint_as_float(v.y), v.y, l.y);
        split_tf32(__uint_as_float(v.z), v.z, l.z);
        split_tf32(__uint_as_float(v.w), v.w, l.w);
        hi[i] = v;
        lo[i] = l;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 96;\n" ::: "memory");
      if (st == 0) mbar_arrive(ready + s);
      cur.next(a);
    }
    return;
  }

  // a consumer warpgroup: rows 64 * cw .. + 64 of each tile; thread (g, t)
  // of warp w holds rows 16 w + g and + 8, columns 8 j + 2 t and + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int g = lane / 4;
  const int t = lane % 4;
  float acc[BQ / 2], tmp[BQ / 2];
  float rs[2];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) tmp[i] = 0.0f;
  Cursor cur;
  cur.start(a);
  while (cur.unit < a.units) {
    const int unit = cur.unit;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) acc[i] = 0.0f;
    rs[0] = rs[1] = 0.0f;
    bool last = false;
    while (!last) {
      const int s = cur.item % a.stages;
      const uint32_t parity = (cur.item / a.stages) & 1;
      mbar_wait(full + s, parity);
      mbar_wait(ready + s, parity);
      // A's fragments of the k-block: v[k][0..3] = A(g, 8k + t), A(g + 8, 8k + t),
      // A(g, 8k + t + 4), A(g + 8, 8k + t + 4) of the warp's 16 rows
      const float* at = reinterpret_cast<const float*>(a_tile(s));
      float v[4][4];
      if (a.a_mn) {
        // box 4 cw + w of 16 rows p; (p, r) at r * 16 + ((p / 4) ^ (r / 2 % 4)) * 4 + p % 4
        const float* box = at + (cw * 4 + warp) * 512;
        const int x0 = t / 2, x1 = 2 + t / 2;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float* r0 = box + (8 * k + t) * 16 + g % 4;
          const float* r1 = r0 + 4 * 16;
          v[k][0] = r0[((g / 4) ^ x0) * 4];
          v[k][1] = r0[((2 + g / 4) ^ x0) * 4];
          v[k][2] = r1[((g / 4) ^ x1) * 4];
          v[k][3] = r1[((2 + g / 4) ^ x1) * 4];
        }
      } else {
        // rows of 32 in the 128-byte swizzle: (p, r) at p * 32 + ((r / 4) ^ (p % 8)) * 4 + r % 4
        const float* r0 = at + (cw * 64 + warp * 16 + g) * 32 + t;
        const float* r1 = r0 + 8 * 32;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c0 = ((2 * k) ^ g) * 4, c1 = ((2 * k + 1) ^ g) * 4;
          v[k][0] = r0[c0];
          v[k][1] = r1[c0];
          v[k][2] = r0[c1];
          v[k][3] = r1[c1];
        }
      }
      uint32_t ah[4][4], al[4][4];
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s0 += v[k][0] + v[k][2];
        s1 += v[k][1] + v[k][3];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[k][i], ah[k][i], al[k][i]);
      }
      rs[0] += s0;
      rs[1] += s1;
      const uint64_t dh = sw128_desc(smem_u32(b_hi(s)));
      const uint64_t dl = sw128_desc(smem_u32(b_lo(s)));
      // the small products first, so that the accumulator truncates at
      // their scale; then hi * hi, which truncates at the block's
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_tf32<BQ>(tmp, al[k], dh + 2 * k, k);
        wgmma_tf32<BQ>(tmp, ah[k], dl + 2 * k, 1);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_tf32<BQ>(tmp, ah[k], dh + 2 * k, 1);
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hold(ah[k][i]);
          hold(al[k][i]);
        }
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) hold(tmp[i]);
      if (tid % 128 == 0) mbar_arrive(empty + s);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) acc[i] += tmp[i];
      last = cur.next(a);
    }

    // the tile is done: bias, then C (added atomically where the
    // contraction is split), and the row sums of A
    const int split = unit / (a.q_tiles * a.p_tiles);
    const int p_base = unit / a.q_tiles % a.p_tiles * kBP + cw * 64 + warp * 16 + g;
    const int q_base = unit % a.q_tiles * BQ + 2 * t;
    const bool atomic = a.kb_per < a.kb_total;
    const float* bias = split == 0 ? a.bias : nullptr;
    const bool pairs = !atomic && a.sq == 1 && a.sp % 2 == 0;
    // the bias, all of it loaded before the first store: the compiler cannot
    // tell that C does not overlap it, and would wait for each store before
    // the next load
    if (bias && a.bias_on_p) {
      const float b0 = p_base < a.P ? __ldg(bias + p_base) : 0.0f;
      const float b1 = p_base + 8 < a.P ? __ldg(bias + p_base + 8) : 0.0f;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        acc[4 * j] += b0;
        acc[4 * j + 1] += b0;
        acc[4 * j + 2] += b1;
        acc[4 * j + 3] += b1;
      }
    } else if (bias) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int q = q_base + 8 * j;
        const float b0 = q < a.Q ? __ldg(bias + q) : 0.0f;
        const float b1 = q + 1 < a.Q ? __ldg(bias + q + 1) : 0.0f;
        acc[4 * j] += b0;
        acc[4 * j + 1] += b1;
        acc[4 * j + 2] += b0;
        acc[4 * j + 3] += b1;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p_base + 8 * h;
      if (p >= a.P) continue;
      float* crow = a.c + p * a.sp;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int q = q_base + 8 * j;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (pairs && q + 1 < a.Q) {
          *reinterpret_cast<float2*>(crow + q) = make_float2(v0, v1);
        } else if (atomic) {
          if (q < a.Q) atomicAdd(crow + q * a.sq, v0);
          if (q + 1 < a.Q) atomicAdd(crow + (q + 1) * a.sq, v1);
        } else {
          if (q < a.Q) crow[q * a.sq] = v0;
          if (q + 1 < a.Q) crow[(q + 1) * a.sq] = v1;
        }
      }
    }
    if (a.db && unit % a.q_tiles == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = rs[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int p = p_base + 8 * h;
        if (t == 0 && p < a.P) {
          if (atomic) atomicAdd(a.db + p, v);
          else a.db[p] = v;
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using CtxGetCurrent = CUresult (*)(CUcontext*);
using DeviceGet = CUresult (*)(CUdevice*, int);
using PrimaryCtxRetain = CUresult (*)(CUcontext*, CUdevice);
using CtxSetCurrent = CUresult (*)(CUcontext);

// A function of the CUDA driver, found through the runtime (no link against
// libcuda), or null
template <typename Fn>
Fn driver(const char* name) {
  void* p = nullptr;
#if CUDART_VERSION >= 12050
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q) != cudaSuccess ||
      q != cudaDriverEntryPointSuccess)
    p = nullptr;
#else
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault) != cudaSuccess) p = nullptr;
#endif
  return reinterpret_cast<Fn>(p);
}

// The driver encodes tensor maps in the calling thread's current context.
// A thread whose CUDA work so far went through the runtime's device setting
// alone (the autograd engine's, where this product is the first node of a
// backward) may have none: make the device's primary context, the one the
// runtime uses, current there. Returns a CUresult.
int bind_context(int dev) {
  static const auto get = driver<CtxGetCurrent>("cuCtxGetCurrent");
  static const auto device = driver<DeviceGet>("cuDeviceGet");
  static const auto retain = driver<PrimaryCtxRetain>("cuDevicePrimaryCtxRetain");
  static const auto set = driver<CtxSetCurrent>("cuCtxSetCurrent");
  if (!get || !device || !retain || !set) return CUDA_ERROR_NOT_SUPPORTED;
  CUcontext ctx = nullptr;
  CUresult r = get(&ctx);
  if (r != CUDA_SUCCESS || ctx) return r;
  CUdevice d;
  r = device(&d, dev);
  if (r == CUDA_SUCCESS) r = retain(&ctx, d);   // held for the process, as the runtime holds it
  if (r == CUDA_SUCCESS) r = set(ctx);
  return r;
}

// A [rows, cols] float32 matrix with row stride ld (values), read by boxes
// of 32 columns x `rows_box` rows in the 128-byte swizzle (K-major: cols is
// the contraction) or 16 columns x 32 rows in the 64-byte swizzle (rows is
// the contraction).
CUresult encode(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
                bool contraction_rows, int rows_box) {
  static const auto encode_tiled = driver<EncodeTiled>("cuTensorMapEncodeTiled");
  if (!encode_tiled) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {contraction_rows ? 16u : (cuuint32_t)kBK,
                             contraction_rows ? (cuuint32_t)kBK : (cuuint32_t)rows_box};
  const cuuint32_t estrides[2] = {1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
                      strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      contraction_rows ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BQ>
int run(Args a, const void* A, int lda, const void* B, int ldb, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int r = bind_context(dev);
  CUtensorMap amap{}, bmap{};
  if (r == CUDA_SUCCESS)
    r = encode(&amap, A, a.a_mn ? a.R : a.P, a.a_mn ? a.P : a.R, lda, a.a_mn, kBP);
  if (r == CUDA_SUCCESS) r = encode(&bmap, B, a.Q, a.R, ldb, false, BQ);
  if (r != CUDA_SUCCESS) return -r;
  a.stage_bytes = kATile + 2 * BQ * kBK * 4;
  a.stages = min(kMaxStages, (kSmem - 1024 - 3 * kMaxStages * 8) / a.stage_bytes);
  const int smem = 1024 + a.stages * a.stage_bytes + 3 * kMaxStages * 8;
  static int sms[16] = {0};
  if (dev >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  if (!sms[dev]) {
    // once a device: the card's SMs, and the kernel's shared-memory limit
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    for (auto fn : {linear_gemm_kernel<48>, linear_gemm_kernel<96>, linear_gemm_kernel<144>})
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[dev] = n;
  }
  const int blocks = min(a.units, sms[dev]);
  linear_gemm_kernel<BQ><<<blocks, kThreads, smem, stream>>>(a, amap, bmap);
  return static_cast<int>(cudaGetLastError());
}

// out[c * ld + r] = in[r * cols + c] for in [rows, cols]: the B operand that
// the wrapper hands in transposed. One 32 x 32 tile a block of 32 x 8
// threads, through shared memory, so that the reads and the writes are both
// runs of 32 values.
__global__ void __launch_bounds__(256)
    linear_transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int rows,
                            int cols, long long ld) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = in[static_cast<long long>(r) * cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < cols && r < rows) out[c * ld + r] = tile[threadIdx.x][i];
  }
}

}  // namespace

extern "C" {

// C(p, q) = sum_r A(p, r) B(q, r) (+ bias[q], or bias[p] with bias_on_p) at
// c[p * sp + q * sq], and with db the row sums db[p] = sum_r A(p, r).
// The arguments come packed in v, sixteen 64-bit values (one ctypes array
// from the caller, which costs it less host time than sixteen arguments):
//   v[0..4]   a, b, c, bias, db: device addresses, 0 for no bias or db
//   v[5..9]   P, Q, R, lda, ldb
//   v[10..11] sp, sq
//   v[12..15] a_mn, bias_on_p, bq, kb_per
// A is stored [P, R] (a_mn = 0) or [R, P] (a_mn = 1) with row stride lda;
// B [Q, R] with row stride ldb. The tiles are 128 rows by bq = 48, 96 or 144
// columns; the contraction is cut into blocks of kb_per k-blocks of 32, and
// where that cuts it more than once, c must be a contiguous [P, Q] or [Q, P]
// (sp = Q, sq = 1 or sp = 1, sq = P): it and db are zeroed here and the
// blocks' sums added to them.
// Returns cudaErrorInvalidValue for what the kernel does not take: an empty
// dimension, a row stride that is not a multiple of 4 values, an operand not
// on a 16-byte boundary; and minus the CUresult where the driver could not
// bind a context or encode a tensor map.
int linear_gemm(const long long* v, void* stream) {
  (void)cudaGetLastError();   // an error another caller left on this thread is not this launch's
  const void* a = reinterpret_cast<const void*>(v[0]);
  const void* b = reinterpret_cast<const void*>(v[1]);
  void* c = reinterpret_cast<void*>(v[2]);
  const float* bias = reinterpret_cast<const float*>(v[3]);
  float* db = reinterpret_cast<float*>(v[4]);
  const int P = static_cast<int>(v[5]), Q = static_cast<int>(v[6]), R = static_cast<int>(v[7]);
  const int lda = static_cast<int>(v[8]), ldb = static_cast<int>(v[9]);
  const long long sp = v[10], sq = v[11];
  const int a_mn = static_cast<int>(v[12]), bias_on_p = static_cast<int>(v[13]);
  const int bq = static_cast<int>(v[14]), kb_per = static_cast<int>(v[15]);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (P <= 0 || Q <= 0 || R <= 0 || kb_per <= 0 || lda % 4 || ldb % 4 || !aligned(a) ||
      !aligned(b))
    return static_cast<int>(cudaErrorInvalidValue);
  Args args{bias, static_cast<float*>(c), db, sp, sq, P, Q, R, a_mn, bias_on_p};
  args.p_tiles = (P + kBP - 1) / kBP;
  args.q_tiles = (Q + bq - 1) / bq;
  args.kb_total = (R + kBK - 1) / kBK;
  args.kb_per = kb_per;
  args.units = args.p_tiles * args.q_tiles * ((args.kb_total + kb_per - 1) / kb_per);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kb_per < args.kb_total) {
    if (!(sp == Q && sq == 1) && !(sp == 1 && sq == P))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaMemsetAsync(c, 0, (size_t)P * Q * 4, s);
    if (err == cudaSuccess && db) err = cudaMemsetAsync(db, 0, (size_t)P * 4, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (bq) {
    case 48: return run<48>(args, a, lda, b, ldb, s);
    case 96: return run<96>(args, a, lda, b, ldb, s);
    case 144: return run<144>(args, a, lda, b, ldb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [cols, ld] = in [rows, cols] transposed (columns r >= rows of out
// untouched), both float32 on the stream's device. Returns a CUDA error
// code.
int linear_transpose(const void* in, void* out, int rows, int cols, long long ld, void* stream) {
  (void)cudaGetLastError();
  if (rows <= 0 || cols <= 0 || ld < rows || (cols + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + 31) / 32, (cols + 31) / 32);
  linear_transpose_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), rows, cols, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
