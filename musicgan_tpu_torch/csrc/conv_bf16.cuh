// K1 bf16 and K3 bf16: the fused 3x3 'SAME' conv (K = 3) and the sub-pixel
// up-conv conv3x3(up2x(x)) (K = 2, four phase convs of 2x2 kernels), each
// with bias, LeakyReLU and PixelNorm, with bf16 activations and weights and a
// bf16 output (float32 bias, accumulation and epilogue, the output rounded
// once to nearest even).  Replace musicgan_tpu/ops/conv.py::fused_conv3x3
// (Pallas _kernel) and ::fused_upconv3x3 (Pallas _upconv_kernel, whose
// packed-pair interleave exists for its bf16 output) called with bf16 x and
// out_dtype=bfloat16: the JAX package's "pallas_bf16", "pallas_up_bf16" and
// "pallas_block_bf16" paths.  Instantiated in conv3x3_bf16.cu (K = 3) and
// upconv3x3_bf16.cu (K = 2).
//
// The output type O: bf16, or float32 for the JAX functions' mixed call
// (bf16 x, out_dtype=float32: the same exact products summed in float32 and
// the float32 epilogue, stored unrounded), and for K2 with bf16 x
// (fused_conv3x3_msq, float32 y and its mean-square map), instantiated in
// conv3x3_bf16_f32.cu and upconv3x3_bf16_f32.cu.  A float32 tile leaves
// through the bf16 tile's staging region in two halves of its channels
// (stage_out_f32), so the plan is the same at both types and the float32
// output rounded to bf16 is the bf16 output, bit for bit.
//
// What bounds them on an H100: bytes at every large shape of synthesis (in
// bf16 one k16 product does the work of six of 3xTF32's k8 ones, so the
// products are far below the card's rate; K1 at 32 channels, 256 x 2560:
// 0.061 ms of products at 989 TFLOP/s against 0.125 ms of bytes at 3.35
// TB/s), and at the small ones the latency of a chain of chunks.  So the
// design keeps the bytes moved once and wide, and leaves the products to the
// tensor cores with no work around them:
//
// - an implicit GEMM, M = 64 output positions a wgmma, N = the block's
//   output channels, K = 16 input channels x taps, in bf16 wgmma m64nNk16
//   with BOTH operands read from shared memory by descriptor (no A fragments
//   in registers);
// - a tile is a window of the input: nb images (nb > 1 only for whole
//   images, which fold the batch into one tile), th rows and tc columns of
//   each (tc a multiple of 16), with a halo of one row above and below each
//   image and of one column left and sw - tc - 1 = 7 right: window row i *
//   (th + 2) + 1 + r is image b0 + i's row r0 + r, window column c is image
//   column c0 - 1 + c.  A chunk of it (16 channels) lands by TMA (one box an
//   image, zero outside the image and past cin) as [row][channel][rw],
//   image columns c0 - 8 .. c0 + tc + 15, rw = tc + 24 (a box starts on 16
//   bytes: one starting at column c0 - 1 faults on an H100; rw / 8 odd puts
//   the 8 channel rows an ldmatrix reads in distinct banks), and the warpgroup
//   transposes it in shared memory (ldmatrix.trans, then stmatrix: 4 of each
//   a warp moves 512 bytes) to channels innermost, [octet][position][8
//   channels], position = row * sw + column, the columns outside the window
//   to a spare slot.  There the A operand of tap (dy, dx) for m64 block u is
//   the 64 positions from 64u + dy * sw + dx on: a start address of 16-byte
//   units, the core matrices 8 positions x 16 bytes, K-major, no swizzle.
//   Output position sw + 1 + 64u + m (window row 1, column 1 on) of every
//   m64 block is computed; positions of halo rows and of the columns right
//   of tc are junk and are not stored;
// - B, the weights (ops/conv_bf16.py::tc_weights: [split][chunk][tap]
//   [octet][n][8], wgmma's K-major core matrices), stays resident in shared
//   memory for the whole persistent launch where it fits beside two stages
//   (at synthesis: K1 at blocks 0 and 3-7, K3 at 0 and 5-7), copied once by
//   one bulk copy; otherwise a chunk's taps come with the chunk's window, by
//   one bulk copy;
// - no producer warpgroup: each consumer warpgroup's first thread issues
//   the copies of its chunk q + stages into the slot chunk q frees, on the
//   slot's mbarrier, so the copies of the next tiles fly while a tile
//   computes and stores;
// - a block holds two warpgroups that walk their own tiles (one in its
//   epilogue while the other multiplies) and share the resident weights,
//   one where every block gets one tile or PixelNorm meets across a
//   cluster;
// - the epilogue (bias, LeakyReLU, PixelNorm; past 128 channels the
//   cluster's blocks in rank order) runs from the registers, rounds to bf16
//   and writes the tile by stmatrix.trans to shared memory as 16-byte runs
//   of 8 positions of one channel (K3: of one phase), from where they leave
//   as 16-byte stores along the output rows (K3: both column phases of a
//   row interleaved, 32 bytes a run);
// - the size rule (plan_cb, mirrored by ops/conv_bf16.py::plan) picks the
//   tile from the sizes and the SM count: the least modelled time over
//   every width, height and image count that fits, routes small_bf16_tc
//   (whole images) and large_bf16_tc (row bands).
//
// Sum order, the same on every route and that of conv_tile.cuh's
// tensor-core route (and so of K4 bf16, block_bf16.cuh, which gives K1 bf16
// then K3 bf16's bits): chunks of 16 input channels in order; in a chunk,
// the kernel rows dy in order, each row's column taps dx in order into a
// fresh accumulator (one wgmma chain), then added to the tile's in float32
// (round to nearest); bias, LeakyReLU and PixelNorm as conv_tile.cuh's
// pieces (bias_lrelu, pn_sums, pn_cluster_sums, pn_scale), which this header
// calls.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is reached through the runtime)

#include "conv_tile.cuh"

namespace mg {
namespace cb {

// bf16 wgmma m64nNk16 with A and B from shared memory (descriptors), K-major
// both, float32 accumulation.
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<80> {
  static __device__ __forceinline__ void mma(float (&d)[40], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "%40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<112> {
  static __device__ __forceinline__ void mma(float (&d)[56], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
        "%56, %57, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};


// ---- Shared memory, barriers, copies.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// Waits for the phase of this parity to complete; traps (a launch error,
// not a hung card) if it has not after about two seconds.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}
// A box of the input's tensor map, coordinates (column, channel, row,
// image), zero outside the tensor.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
// bytes (a multiple of 16) from device memory to shared memory, both 16-byte
// aligned.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r[0]),
               "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r[0]),
               "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- Geometry: per tile at N output channels a block (ops/conv_bf16.py::
// geometry).  MB m64 blocks of positions; PPB sub-pixel phases (K3: all four
// up to 32 channels, else the two of one output row parity); TAPS a phase;
// WTAPS the weight taps a tile reads, TAPS_ALL a chunk's; DP the phases whose
// fresh accumulators are held at once (K3 past 64 channels: one, so that the
// registers hold the tile's two phases' sums and one fresh set).
struct Geom {
  int mb, ppb, taps, wtaps, taps_all, dp;
};
__host__ __device__ constexpr int acc_tiles(int n) { return n <= 16 ? 8 : n <= 32 ? 4 : n <= 64 ? 2 : 1; }
__host__ __device__ constexpr Geom geom(int K, int N) {
  return K == 3 ? Geom{acc_tiles(N), 1, 9, 9, 9, 1}
                : Geom{acc_tiles(N) / (N <= 32 ? 4 : 2) > 0 ? acc_tiles(N) / (N <= 32 ? 4 : 2) : 1,
                       N <= 32 ? 4 : 2, 4, N <= 32 ? 16 : 8, 16, N <= 32 ? 4 : N <= 64 ? 2 : 1};
}

// What a launch needs besides the tensor map (all sizes in elements unless
// named bytes; shared-memory offsets in bytes from its start).
struct CbArgs {
  const bf16* x;
  const bf16* w;
  const float* bias;
  void* y;     // of the kernel's output type O
  float* msq;  // K2: (B, 1, H, W), or null
  int B, cin, cout, H, W;
  int nsplit, nchunks, tc, sw, th, nb, ntx, nty, nph, ntiles;
  int stages, resident, tma, vec, nwg, rows_w, rw, ptrans;
  uint32_t raw_bytes, stage_bytes, wchunk_bytes, wres_bytes, wg_off, wg_bytes, part_off, bar_off;
  float slope, eps;
  int use_slope, pixel_norm;
};

struct CbTile {
  int b0, r0, c0, oy;
};

// The window's chunk of 16 channels into raw ([row][channel][rw] bf16,
// image columns c0 - 8 on, as the TMA box lands) by the warpgroup's
// threads, one element at a time: where TMA cannot describe x (W not a
// multiple of 8, or x not 16-byte aligned).
__device__ __forceinline__ void fill_raw(unsigned short* raw, const CbArgs& a, const CbTile& tl, int ci0, int lt) {
  const unsigned short* x = reinterpret_cast<const unsigned short*>(a.x);
  const int n = a.rows_w * 16 * a.rw;
  for (int e = lt; e < n; e += 128) {
    const int col = e % a.rw, rest = e / a.rw, ch = rest % 16, sr = rest / 16;
    const int img = sr / (a.th + 2), lr = sr - img * (a.th + 2) - 1;
    const int b = tl.b0 + img, r = tl.r0 + lr, c = ci0 + ch, gc = tl.c0 - 8 + col;
    const bool ok = b < a.B && c < a.cin && r >= 0 && r < a.H && gc >= 0 && gc < a.W;
    raw[e] = ok ? x[(((size_t)b * a.cin + c) * a.H + r) * a.W + gc] : (unsigned short)0;
  }
}

// raw [row][16 channels][rw] -> trans [octet][ptrans positions][8 channels]:
// each 8 x 8 matrix (8 channels of one octet x 8 columns of one row) read
// transposed by ldmatrix.trans (a lane gets channels 2t, 2t + 1 of column g)
// and written by stmatrix, a row (a position's 8 channels, 16 bytes) to the
// address its lane gives.  A warp moves 4 matrices at a time; past the last
// matrix a lane repeats it (the same bytes to the same place).  Raw column
// j is window column j - 7; columns outside the window go to the spare
// slot, position ptrans - 1 (past every position a stored output reads).
// Warp wq takes the rows (window row, octet) wq, wq + 4, ..; in a row,
// four matrices (32 raw columns) at a time, lane group j of 8 the j-th.
__device__ __forceinline__ void transpose(uint32_t raw, uint32_t trans, const CbArgs& a, int wq, int lane) {
  const int kq = a.rw / 8, r = lane & 7, j = lane >> 3;
  for (int row = wq; row < 2 * a.rows_w; row += 4) {
    const int sr = row >> 1, o = row & 1;
    const uint32_t src = raw + 2u * (uint32_t)((sr * 16 + o * 8 + r) * a.rw);
    const uint32_t dst = trans + 16u * (uint32_t)(o * a.ptrans);
    for (int k0 = 0; k0 < kq; k0 += 4) {
      const int k = min(k0 + j, kq - 1);
      uint32_t v[4];
      ldmatrix_x4_trans(src + 16u * k, v);
      // Row r of the lane's own matrix goes to window column 8k + r - 7
      // of row sr.
      const int wc = 8 * k + r - 7;
      stmatrix_x4(dst + 16u * (uint32_t)(wc >= 0 && wc < a.sw ? sr * a.sw + wc : a.ptrans - 1), v);
    }
  }
}

// A chunk's products into the tile's sums, K1: for each kernel row dy, each
// m64 block's three column taps into its fresh accumulator (one chain),
// then the fresh sums added in float32.  ad: the A descriptor at position 0
// (a position is one 16-byte unit); bd: the B descriptor at the chunk's tap
// 0 (a tap is 32N bytes).
template <int N, int MB>
__device__ __forceinline__ void products_k1(float (&acc)[MB][N / 2], float (&d)[MB][N / 2], uint64_t ad,
                                            uint64_t bd, int sw) {
  fence_tiles(d);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        WgmmaSS<N>::mma(d[m], ad + (uint64_t)(64 * m + dy * sw + dx), bd + (uint64_t)((dy * 3 + dx) * 2 * N));
    wgmma_commit();
    wgmma_wait<0>();
    add_fresh(acc, d);
  }
}

// K3: phase (oy, ox) of m64 block m is tile m * PPB + p (p the phase in the
// block's PPB; oy = p >> 1 where a tile holds four, else the tile's oy);
// tap (dy, dx) reads the window at (oy + dy, ox + dx); its weights are tap
// p' * 4 + dy * 2 + dx from bd on, p' = p with four phases a tile, else ox
// (bd then at the tile's oy's phases).  For each dy, DP phases at a time:
// their chains, then their fresh sums added.
template <int N, int MB, int PPB, int DP>
__device__ __forceinline__ void products_k3(float (&acc)[MB * PPB][N / 2], float (&d)[MB * DP][N / 2],
                                            uint64_t ad, uint64_t bd, int sw, int oy_tile) {
  fence_tiles(d);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int grp = 0; grp < PPB / DP; ++grp) {
      wgmma_fence();
#pragma unroll
      for (int pl = 0; pl < DP; ++pl) {
        const int p = grp * DP + pl, ox = p & 1, oy = PPB == 4 ? p >> 1 : oy_tile;
        const int pw = PPB == 4 ? p : ox;
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx)
            WgmmaSS<N>::mma(d[m * DP + pl], ad + (uint64_t)(64 * m + (oy + dy) * sw + ox + dx),
                            bd + (uint64_t)((pw * 4 + dy * 2 + dx) * 2 * N));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int pl = 0; pl < DP; ++pl)
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int k = 0; k < N / 2; ++k) {
            float& f = d[m * DP + pl][k];
            fence_operand(f);
            acc[m * PPB + grp * DP + pl][k] += f;
            f = 0.f;
            fence_operand(f);
          }
    }
}

// The tile's bf16 outputs into region: tile u (m64 block u / PPB, phase u %
// PPB) as [phase][channel][8 MB + 1 groups][8 positions] (the odd group
// count keeps stmatrix.trans's 8 channel rows in distinct banks).  Group
// 8m + 2wq + i holds positions 64m + 16wq + 8i .. + 7.
template <int N, int MB, int PPB>
__device__ __forceinline__ void stage_out(const float (&acc)[MB * PPB][N / 2], uint32_t region, int wq,
                                          int lane) {
  constexpr int G1 = 8 * MB + 1;
  const int mm = lane >> 3, c = lane & 7;
#pragma unroll
  for (int u = 0; u < MB * PPB; ++u) {
    const int m = u / PPB, p = u % PPB;
#pragma unroll
    for (int j0 = 0; j0 < N / 8; j0 += 2) {
      const int co = 8 * (j0 + (mm >> 1)) + c, grp = 8 * m + 2 * wq + (mm & 1);
      const uint32_t r[4] = {pack_bf16(acc[u][4 * j0], acc[u][4 * j0 + 1]),
                             pack_bf16(acc[u][4 * j0 + 2], acc[u][4 * j0 + 3]),
                             pack_bf16(acc[u][4 * j0 + 4], acc[u][4 * j0 + 5]),
                             pack_bf16(acc[u][4 * j0 + 6], acc[u][4 * j0 + 7])};
      stmatrix_x4_trans(region + 16u * (uint32_t)((p * N + co) * G1 + grp), r);
    }
  }
}

// Where a thread's group of 8 output positions lies in every tile: a
// thread stores group lt % G of each tile (G = 8 MB divides 128), for the
// channels (and K3's row parities) lt / G, lt / G + 128 / G, ..; the image
// in the tile, the row in its band and the first column, or img < 0 where
// the group holds no stored output (halo rows, columns right of tc).
struct StoreMap {
  int img, lr, col;
};
__device__ __forceinline__ StoreMap store_map(const CbArgs& a, int grp) {
  const int p0 = a.sw + 1 + 8 * grp, sr = p0 / a.sw, sc = p0 - sr * a.sw;
  const int img = sr / (a.th + 2), lr = sr - img * (a.th + 2) - 1;
  const bool ok = sc - 1 < a.tc && img < a.nb && lr >= 0 && lr < a.th;
  return StoreMap{ok ? img : -1, lr, sc - 1};
}

// region's groups to y: K1 (B, cout, H, W), a group 8 output columns of one
// row and channel; K3 (B, cout, 2H, 2W), the two column phases of a group
// interleaved into 16 columns of output row 2r + oy.  16-byte stores where
// the run lies inside the row and y's rows allow (vec), else 2-byte ones.
template <int K, int N, int MB, int PPB>
__device__ __forceinline__ void store_out(const unsigned char* region, const CbArgs& a, const CbTile& tl,
                                          int co_base, int lt, const StoreMap& sm) {
  constexpr int G = 8 * MB, G1 = G + 1, NOY = K == 3 ? 1 : PPB / 2, ITEMS = NOY * N * G / 128;
  static_assert(128 % G == 0 && NOY * N * G % 128 == 0, "a thread's groups and channels");
  if (sm.img < 0) return;
  const int b = tl.b0 + sm.img, r = tl.r0 + sm.lr, c = tl.c0 + sm.col;
  if (b >= a.B || r >= a.H || c >= a.W) return;
  const int nv = min(8, a.W - c), grp = lt % G;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int rest = lt / G + it * (128 / G), co = rest % N, oyl = rest / N;
    const int gco = co_base + co;
    if (gco >= a.cout) continue;
    if constexpr (K == 3) {
      const uint4 v = *reinterpret_cast<const uint4*>(region + 16 * (co * G1 + grp));
      bf16* dst = static_cast<bf16*>(a.y) + (((size_t)b * a.cout + gco) * a.H + r) * a.W + c;
      if (a.vec && nv == 8) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const bf16* s = reinterpret_cast<const bf16*>(&v);
        for (int k = 0; k < nv; ++k) dst[k] = s[k];
      }
    } else {
      const int oy = PPB == 4 ? oyl : tl.oy;
      const int pa = PPB == 4 ? 2 * oyl : 0;  // the row's ox = 0 phase in region
      const uint4 v0 = *reinterpret_cast<const uint4*>(region + 16 * ((pa * N + co) * G1 + grp));
      const uint4 v1 = *reinterpret_cast<const uint4*>(region + 16 * (((pa + 1) * N + co) * G1 + grp));
      bf16* dst = static_cast<bf16*>(a.y) + (((size_t)b * a.cout + gco) * 2 * a.H + 2 * r + oy) * 2 * a.W + 2 * c;
      const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&v0);
      const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&v1);
      uint32_t o[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[2 * k] = __byte_perm(w0[k], w1[k], 0x5410);
        o[2 * k + 1] = __byte_perm(w0[k], w1[k], 0x7632);
      }
      if (a.vec && nv == 8) {
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
      } else {
        const bf16* s = reinterpret_cast<const bf16*>(o);
        for (int k = 0; k < 2 * nv; ++k) dst[k] = s[k];
      }
    }
  }
}

// A float32 output (the mixed call bf16 in, float32 out: the JAX kernel's
// float32 epilogue stored unrounded) leaves through the same region in two
// halves of the block's channels, HF = 0 then 1: half HF's N / 2 channels
// as [phase][N / 2 channels][8 MB + 1 groups][8 positions] of floats, the
// bytes stage_out's bf16 layout of all N takes, so the plan and the layout
// are the bf16 output's.  Each thread writes its own floats (position 16 wq
// + g + 8 i of m64 block m, channel 8 j + 2 t + e); a warp's store covers 8
// positions of 4 channels (two of them share banks).
template <int N, int MB, int PPB, int HF>
__device__ __forceinline__ void stage_out_f32(const float (&acc)[MB * PPB][N / 2], float* region, int wq,
                                              int lane) {
  constexpr int G1 = 8 * MB + 1, NH = N / 2, JH = N / 16;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < MB * PPB; ++u) {
    const int m = u / PPB, p = u % PPB;
#pragma unroll
    for (int jl = 0; jl < JH; ++jl)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          region[((p * NH + 8 * jl + 2 * t + e) * G1 + 8 * m + 2 * wq + i) * 8 + g] =
              acc[u][4 * (HF * JH + jl) + 2 * i + e];
  }
}

// 8 staged columns of both column phases of a K3 output row (s0: ox = 0,
// s1: ox = 1, 8 floats each) interleaved into 16 floats at dst: four
// 16-byte stores where vec and all 8 lie in the row, else 2 nv single ones.
__device__ __forceinline__ void store_phases_f32(float* dst, const float* s0, const float* s1, int nv, int vec) {
  if (vec && nv == 8) {
    const float4 v0a = reinterpret_cast<const float4*>(s0)[0], v0b = reinterpret_cast<const float4*>(s0)[1];
    const float4 v1a = reinterpret_cast<const float4*>(s1)[0], v1b = reinterpret_cast<const float4*>(s1)[1];
    float4* d4 = reinterpret_cast<float4*>(dst);
    d4[0] = make_float4(v0a.x, v1a.x, v0a.y, v1a.y);
    d4[1] = make_float4(v0a.z, v1a.z, v0a.w, v1a.w);
    d4[2] = make_float4(v0b.x, v1b.x, v0b.y, v1b.y);
    d4[3] = make_float4(v0b.z, v1b.z, v0b.w, v1b.w);
  } else {
    for (int k = 0; k < nv; ++k) {
      dst[2 * k] = s0[k];
      dst[2 * k + 1] = s1[k];
    }
  }
}

// region's float32 groups of one half (channels co_base .. co_base + N / 2
// - 1) to y, as store_out stores bf16 ones: K1 8 output columns of one row
// and channel (two 16-byte stores), K3 the two column phases interleaved
// into 16 columns (four).
template <int K, int N, int MB, int PPB>
__device__ __forceinline__ void store_out_f32(const unsigned char* region, const CbArgs& a, const CbTile& tl,
                                              int co_base, int lt, const StoreMap& sm) {
  constexpr int G = 8 * MB, G1 = G + 1, NH = N / 2, NOY = K == 3 ? 1 : PPB / 2;
  constexpr int ITEMS = (NOY * NH * G + 127) / 128;
  static_assert(128 % G == 0, "a thread's groups");
  if (sm.img < 0) return;
  const int b = tl.b0 + sm.img, r = tl.r0 + sm.lr, c = tl.c0 + sm.col;
  if (b >= a.B || r >= a.H || c >= a.W) return;
  const int nv = min(8, a.W - c), grp = lt % G;
  const float* rf = reinterpret_cast<const float*>(region);
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int rest = lt / G + it * (128 / G), co = rest % NH, oyl = rest / NH;
    const int gco = co_base + co;
    if (oyl >= NOY || gco >= a.cout) continue;
    if constexpr (K == 3) {
      const float4* s = reinterpret_cast<const float4*>(rf + (co * G1 + grp) * 8);
      float* dst = static_cast<float*>(a.y) + (((size_t)b * a.cout + gco) * a.H + r) * a.W + c;
      if (a.vec && nv == 8) {
        reinterpret_cast<float4*>(dst)[0] = s[0];
        reinterpret_cast<float4*>(dst)[1] = s[1];
      } else {
        const float* sv = reinterpret_cast<const float*>(s);
        for (int k = 0; k < nv; ++k) dst[k] = sv[k];
      }
    } else {
      const int oy = PPB == 4 ? oyl : tl.oy;
      const int pa = PPB == 4 ? 2 * oyl : 0;  // the row's ox = 0 phase in region
      const float* s0 = rf + ((pa * NH + co) * G1 + grp) * 8;
      const float* s1 = rf + (((pa + 1) * NH + co) * G1 + grp) * 8;
      store_phases_f32(static_cast<float*>(a.y) + (((size_t)b * a.cout + gco) * 2 * a.H + 2 * r + oy) * 2 * a.W
                           + 2 * c, s0, s1, nv, a.vec);
    }
  }
}

// K2: the pre-norm mean_c(u^2) of the thread's pixel (m64 block u, row i
// of its pair), m, into msq (B, 1, H, W) where the pixel is a stored output
// (not a halo row or column, not past tc).
__device__ __forceinline__ void store_msq(const CbArgs& a, const CbTile& tl, int u, int i, int wq, int g,
                                          float m) {
  const int p = a.sw + 1 + 64 * u + 16 * wq + g + 8 * i, sr = p / a.sw, sc = p - sr * a.sw;
  const int img = sr / (a.th + 2), lr = sr - img * (a.th + 2) - 1;
  if (sc < 1 || sc - 1 >= a.tc || img >= a.nb || lr < 0 || lr >= a.th) return;
  const int b = tl.b0 + img, r = tl.r0 + lr, c = tl.c0 + sc - 1;
  if (b < a.B && r < a.H && c < a.W) a.msq[((size_t)b * a.H + r) * a.W + c] = m;
}

// Block x = cluster * nsplit + split: output channels [split * N, split * N
// + N).  Warpgroup wg walks the tiles cluster + (k * nwg + wg) * clusters,
// k = 0, 1, .. (columns fastest, after K3's two row parities), each
// nchunks chunks of 16 input channels; its chunk q lands in slot q % stages
// on mbarrier full[q % stages].  O: the output's type, bf16 or float32 (the
// same plan, sums and epilogue; float32 stored unrounded, and for K2 the
// mean-square map beside it).
template <int K, int N, typename O>
__global__ void __launch_bounds__(256, 1) conv_bf16_kernel(const __grid_constant__ CUtensorMap tm, const CbArgs a) {
  constexpr Geom GM = geom(K, N);
  constexpr int MB = GM.mb, PPB = GM.ppb, NT = MB * PPB, ND = N / 2, DP = K == 3 ? MB : MB * GM.dp;
  extern __shared__ __align__(1024) unsigned char cb_smem[];
  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127, lane = tid & 31, wq = lt >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint64_t* bars = reinterpret_cast<uint64_t*>(cb_smem + a.bar_off);
  uint64_t* full = bars + 4 * wg;
  uint64_t* wbar = bars + 4 * a.nwg;
  if (tid == 0) {
    for (int k = 0; k < 4 * a.nwg + 1; ++k) mbar_init(&bars[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int split = blockIdx.x % a.nsplit, cid = blockIdx.x / a.nsplit, ncl = gridDim.x / a.nsplit;
  const int slots = ncl * a.nwg, first = cid + wg * ncl;
  const int my_tiles = first < a.ntiles ? (a.ntiles - first + slots - 1) / slots : 0;
  const int total = my_tiles * a.nchunks;
  const int co_base = split * N;
  const bf16* wsplit = a.w + (size_t)split * a.nchunks * GM.taps_all * 16 * N;
  unsigned char* wgbase = cb_smem + a.wg_off + wg * a.wg_bytes;
  const bool clustered = a.pixel_norm && a.nsplit > 1;

  auto tile_of = [&](int it) {
    const int tl = first + it * slots;
    const int oy = tl % a.nph, rest = tl / a.nph, tx = rest % a.ntx, rest2 = rest / a.ntx;
    return CbTile{(rest2 / a.nty) * a.nb, (rest2 % a.nty) * a.th, tx * a.tc, oy};
  };
  // The weight taps a tile of row parity oy reads: all, or K3's two phases.
  auto tap0 = [&](int oy) { return K == 2 && PPB == 2 ? 8 * oy : 0; };
  // Chunk q's window (by TMA) and, where the weights stream, its taps.
  auto issue = [&](int q) {
    const CbTile tq = tile_of(q / a.nchunks);
    const int kc = q % a.nchunks, s = q % a.stages;
    unsigned char* st = wgbase + s * a.stage_bytes;
    mbar_expect_tx(&full[s], (a.tma ? a.raw_bytes : 0u) + (a.resident ? 0u : a.wchunk_bytes));
    if (a.tma)
      for (int i = 0; i < a.nb; ++i)
        tma_load_4d(st + (size_t)i * (a.th + 2) * 32 * a.rw, &tm, &full[s], tq.c0 - 8, kc * 16, tq.r0 - 1,
                    tq.b0 + i);
    if (!a.resident)
      bulk_load(st + a.raw_bytes, wsplit + ((size_t)kc * GM.taps_all + tap0(tq.oy)) * 16 * N, a.wchunk_bytes,
                &full[s]);
  };

  if (tid == 0 && a.resident) {
    mbar_expect_tx(wbar, a.wres_bytes);
    bulk_load(cb_smem, wsplit, a.wres_bytes, wbar);
  }
  if (lt == 0)
    for (int k = 0; k < a.stages && k < total; ++k) issue(k);
  if (a.resident && total > 0) mbar_wait(wbar, 0);

  const int wgbar = 1 + wg;
  const StoreMap sm = store_map(a, lt % (8 * MB));
  unsigned char* region = wgbase + a.stages * a.stage_bytes;
  const uint32_t region_a = smem_u32(region);
  const uint64_t ad = smem_desc(region, a.ptrans * 16, 128);
  float* part = reinterpret_cast<float*>(cb_smem + a.part_off);  // PixelNorm's cluster sums
  for (int it = 0; it < my_tiles; ++it) {
    const CbTile tl = tile_of(it);
    float acc[NT][ND], d[DP][ND];
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int k = 0; k < ND; ++k) acc[u][k] = 0.f;
#pragma unroll
    for (int u = 0; u < DP; ++u)
#pragma unroll
      for (int k = 0; k < ND; ++k) d[u][k] = 0.f;

    for (int kc = 0; kc < a.nchunks; ++kc) {
      const int q = it * a.nchunks + kc, s = q % a.stages;
      unsigned char* st = wgbase + s * a.stage_bytes;
      mbar_wait(&full[s], (q / a.stages) & 1);
      if (!a.tma) {
        fill_raw(reinterpret_cast<unsigned short*>(st), a, tl, kc * 16, lt);
        bar_sync(wgbar, 128);
      }
      transpose(smem_u32(st), region_a, a, wq, lane);
      fence_proxy_async();  // the transposed window is read by wgmma
      bar_sync(wgbar, 128);
      const unsigned char* wb =
          a.resident ? cb_smem + ((size_t)kc * GM.taps_all + tap0(tl.oy)) * 32 * N : st + a.raw_bytes;
      const uint64_t bd = smem_desc(wb, 16 * N, 128);
      if constexpr (K == 3)
        products_k1<N, MB>(acc, d, ad, bd, a.sw);
      else
        products_k3<N, MB, PPB, DP / MB>(acc, d, ad, bd, a.sw, tl.oy);
      // A warp's wgmma.wait_group covers its own quarter of the products
      // (its SM sub-partition's 16 rows), so the warpgroup meets before the
      // window is overwritten or slot s refilled: its window transposed,
      // its weights multiplied by every warp.
      bar_sync(wgbar, 128);
      if (lt == 0 && q + a.stages < total) issue(q + a.stages);
    }

    // Epilogue in float32, from the registers.
    bias_lrelu<NT, N>(acc, a.bias, co_base, a.cout, t, a.slope, a.use_slope);
    if (a.pixel_norm) {
      float sum[NT][2];
      pn_sums<NT, N>(acc, sum);
      if (clustered) pn_cluster_sums<NT>(sum, part + (it & 1) * (NT * TC_W), 0, wq, g, t, a.nsplit);
#pragma unroll
      for (int u = 0; u < NT; ++u)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m = sum[u][i] / (float)a.cout;
          // K2: the cluster's sums (past 128 channels) are whole here.
          if constexpr (K == 3 && std::is_same<O, float>::value)
            if (a.msq != nullptr && t == 0 && split == 0) store_msq(a, tl, u, i, wq, g, m);
          pn_scale<NT, N>(acc, u, i, m, a.eps);
        }
    }
    if constexpr (std::is_same<O, bf16>::value) {
      stage_out<N, MB, PPB>(acc, region_a, wq, lane);
      bar_sync(wgbar, 128);
      store_out<K, N, MB, PPB>(region, a, tl, co_base, lt, sm);
    } else {
      stage_out_f32<N, MB, PPB, 0>(acc, reinterpret_cast<float*>(region), wq, lane);
      bar_sync(wgbar, 128);
      store_out_f32<K, N, MB, PPB>(region, a, tl, co_base, lt, sm);
      bar_sync(wgbar, 128);  // every warp's reads of the first half
      stage_out_f32<N, MB, PPB, 1>(acc, reinterpret_cast<float*>(region), wq, lane);
      bar_sync(wgbar, 128);
      store_out_f32<K, N, MB, PPB>(region, a, tl, co_base + N / 2, lt, sm);
    }
    bar_sync(wgbar, 128);  // region is the next chunk's transposed window
  }
  // A block's shared memory must outlive the other blocks' reads of it.
  if (clustered) coop::this_cluster().sync();
}

// ---- The plan (ops/conv_bf16.py::plan, integer for integer).

constexpr int ROUTE_SMALL = 1, ROUTE_LARGE = 2;
constexpr int MAX_TC = 224, SMEM_BUDGET = 232448 - 1024, TILE_FIXED_CLK = 2500;

struct CbPlan {
  int route, tc, sw, th, nb, ntx, nty, nbz, nph, ntiles, resident, stages, nwg, blocks;
  int n, nsplit, cluster, nchunks, mb, ppb;
  long long smem, cost;
};

inline long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

// Bytes of a block's shared memory (ops/conv_bf16.py::_smem): raw, a
// stage's window as it lands ([row][16 channels][sw + 16]); ptrans, the
// transposed window's positions (every position an m64 block reads, and a
// spare one past the window's); region, the transposed window or the
// tile's staged outputs; stage, raw and (streamed) a chunk's weights;
// wres, the resident weights; part, PixelNorm's cluster sums.
struct CbLayout {
  long long raw, wchunk, ptrans, region, stage, wres, part, total;
};
inline CbLayout cb_layout(int K, int n, const Geom& g, int nwg, int sw, int rows_w, bool resident, int stages,
                          int nchunks, bool clustered) {
  CbLayout l;
  l.raw = 32LL * rows_w * (sw + 16);
  l.wchunk = 32LL * n * g.wtaps;
  l.ptrans = round_up(std::max<long long>((long long)rows_w * sw + 1, 64LL * g.mb + 2 * sw + 2), 8);
  const long long out = (long long)g.ppb * n * (8 * g.mb + 1) * 16;
  l.region = round_up(std::max(32 * l.ptrans, out), 128);
  l.stage = round_up(l.raw + (resident ? 0 : l.wchunk), 128);
  l.wres = resident ? (long long)nchunks * 32 * n * (K == 3 ? 9 : 16) : 0;
  l.part = clustered ? 2LL * g.mb * g.ppb * 64 * 4 : 0;
  l.total = l.wres + nwg * (stages * l.stage + l.region) + l.part + 8LL * (nwg * 4 + 1);
  return l;
}

inline int plan_cb(int K, int B, int cin, int cout, int H, int W, int pixel_norm, int sms, int route, int tc_force,
                   CbPlan* out) {
  if (B < 1 || cin < 1 || cout < 1 || H < 1 || W < 1 || (K != 2 && K != 3) || route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  const int groups = ceil_div(cout, 16), nsplit = ceil_div(groups, 8), n = 16 * ceil_div(groups, nsplit);
  if (pixel_norm && nsplit > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const bool clustered = pixel_norm && nsplit > 1;
  const Geom g = geom(K, n);
  const int nchunks = ceil_div(cin, 16), budget = 64 * g.mb, nph = g.ppb == 2 ? 2 : 1;
  const long long wclk4 = std::max(2 * n, 64 + n);
  bool found = false;
  CbPlan best{};
  for (int tc = std::min(MAX_TC, (int)round_up(W, 16)); tc > 0; tc -= 16) {
    if (tc_force && tc != tc_force) continue;
    const int sw = tc + 8, ntx = ceil_div(W, tc);
    const bool whole = tc >= W;
    for (int th = std::min(H, budget / sw + 1); th > 0; --th) {
      for (int nb = whole && th == H ? B : 1; nb > 0; --nb) {
        const long long span = ((long long)(nb - 1) * (th + 2) + th - 1) * sw + tc;
        const int rt = whole && th == H ? ROUTE_SMALL : ROUTE_LARGE;
        if (span > budget || (route && rt != route)) continue;
        const int rows_w = nb * (th + 2);
        const long long ntiles = (long long)ntx * ceil_div(H, th) * ceil_div(B, nb) * nph;
        if (ntiles > 0x3fffffffLL) continue;
        const long long ncl = std::min<long long>(ntiles, std::max(1, sms / nsplit));
        const int nwg = clustered || ntiles <= ncl ? 1 : 2;
        bool fit = false, resident = false;
        int stages = 0;
        CbLayout l{};
        for (int res = 1; res >= 0 && !fit; --res)
          for (int s = 4; s >= 2 && !fit; --s) {
            l = cb_layout(K, n, g, nwg, sw, rows_w, res, s, nchunks, clustered);
            if (l.total <= SMEM_BUDGET) {
              fit = true;
              resident = res;
              stages = s;
            }
          }
        if (!fit) continue;
        const long long rw = sw + 16;
        const long long work = (long long)g.mb * g.ppb * g.taps * wclk4 + 12LL * rows_w * rw;
        const long long copies = 4LL * ((long long)rows_w * rw + (resident ? 0 : (long long)g.wtaps * n));
        const long long outputs = (long long)nb * th * std::min(tc, W);
        const long long tile4 =
            nchunks * std::max(work, copies) + outputs * g.ppb * n / 8 + 4LL * TILE_FIXED_CLK;
        const long long cost = (ntiles * nsplit + sms - 1) / sms * tile4;
        if (!found || cost < best.cost) {
          found = true;
          best = CbPlan{rt, tc, sw, th, nb, ntx, ceil_div(H, th), ceil_div(B, nb), nph, (int)ntiles, resident ? 1 : 0,
                        stages, nwg, (int)(ncl * nsplit), n, nsplit, clustered ? nsplit : 1, nchunks, g.mb, g.ppb,
                        l.total, cost};
        }
      }
    }
  }
  if (!found) return (int)cudaErrorInvalidValue;
  *out = best;
  return 0;
}

namespace {

// cuTensorMapEncodeTiled, reached through the runtime (no link against the
// driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

}  // namespace

// Error codes past the runtime's: a driver error of the tensor-map encoder.
constexpr int CB_ENCODE_ERROR = 10000;

// x (B, cin, H, W) as a 4-d view (column, channel, row, image), so that a
// box of (sw + 16, 16, th + 2, 1) lands as [row][channel][sw + 16].
inline int encode_input_map(const bf16* x, int B, int cin, int H, int W, int sw, int th, CUtensorMap* m) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t hw = (cuuint64_t)H * W;
  const cuuint64_t dim[4] = {(cuuint64_t)W, (cuuint64_t)cin, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t str[3] = {2ull * hw, 2ull * W, 2ull * hw * cin};
  const cuuint32_t box[4] = {(cuuint32_t)sw + 16, 16, (cuuint32_t)th + 2, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x), dim, str, box, ones,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : CB_ENCODE_ERROR + (int)r;
}

template <int K, int N, typename O>
int launch_cb(const CbPlan& p, const CbArgs& a, const CUtensorMap& tm, int dev, const DeviceInfo& info,
              cudaStream_t stream) {
  // Above 48 KB a kernel gets dynamic shared memory by request only: once
  // for this kernel on this device.
  static bool opted_in[MAX_DEVICES] = {};
  if (p.smem > info.smem_optin) return (int)cudaErrorInvalidValue;
  if (!opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(conv_bf16_kernel<K, N, O>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, info.smem_optin);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.blocks);
  cfg.blockDim = dim3(128 * p.nwg);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, conv_bf16_kernel<K, N, O>, tm, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// x: (B, cin, H, W) bf16; w: ops/conv_bf16.py::tc_weights; bias (cout,)
// float32 or null; y: (B, cout, H, W) (K = 3) or (B, cout, 2H, 2W) (K = 2)
// of O, bf16 or float32; msq: null, or (K2: K = 3, O float32, PixelNorm)
// (B, 1, H, W) float32 for the pre-norm mean over channels of u^2; route and
// tc: 0, or a forced route and tile width (measurements and tests).
template <int K, typename O>
int launch_conv_bf16(const bf16* x, const bf16* w, const float* bias, O* y, float* msq, int B, int cin, int cout,
                     int H, int W, float slope, int use_slope, int pixel_norm, float eps, int route, int tc,
                     cudaStream_t stream) {
  if (msq != nullptr && !(K == 3 && std::is_same<O, float>::value && pixel_norm)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const DeviceInfo* info = nullptr;
  int err = current_device(&dev, &info);
  if (err != 0) return err;
  CbPlan p;
  err = plan_cb(K, B, cin, cout, H, W, pixel_norm, info->sms, route, tc, &p);
  if (err != 0) return err;
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0) return (int)cudaErrorInvalidValue;
  const Geom g = geom(K, p.n);
  const bool clustered = pixel_norm && p.nsplit > 1;
  const CbLayout l = cb_layout(K, p.n, g, p.nwg, p.sw, p.nb * (p.th + 2), p.resident, p.stages, p.nchunks, clustered);
  CbArgs a;
  a.x = x;
  a.w = w;
  a.bias = bias;
  a.y = y;
  a.msq = msq;
  a.B = B;
  a.cin = cin;
  a.cout = cout;
  a.H = H;
  a.W = W;
  a.nsplit = p.nsplit;
  a.nchunks = p.nchunks;
  a.tc = p.tc;
  a.sw = p.sw;
  a.th = p.th;
  a.nb = p.nb;
  a.ntx = p.ntx;
  a.nty = p.nty;
  a.nph = p.nph;
  a.ntiles = p.ntiles;
  a.stages = p.stages;
  a.resident = p.resident;
  a.tma = (W % 8) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  a.vec = (K == 3 ? W % 8 : W % 4) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  a.nwg = p.nwg;
  a.rows_w = p.nb * (p.th + 2);
  a.rw = p.sw + 16;
  a.ptrans = (int)l.ptrans;
  a.raw_bytes = (uint32_t)l.raw;
  a.stage_bytes = (uint32_t)l.stage;
  a.wchunk_bytes = (uint32_t)l.wchunk;
  a.wres_bytes = (uint32_t)l.wres;
  a.wg_off = (uint32_t)l.wres;
  a.wg_bytes = (uint32_t)(p.stages * l.stage + l.region);
  a.part_off = clustered ? a.wg_off + p.nwg * a.wg_bytes : 0;
  a.bar_off = a.wg_off + p.nwg * a.wg_bytes + (uint32_t)l.part;
  a.slope = slope;
  a.eps = eps;
  a.use_slope = use_slope;
  a.pixel_norm = pixel_norm;
  CUtensorMap tm = {};
  if (a.tma) {
    err = encode_input_map(x, B, cin, H, W, p.sw, p.th, &tm);
    if (err != 0) return err;
  }
#define MG_CB(NN) \
  case NN:        \
    return launch_cb<K, NN, O>(p, a, tm, dev, *info, stream)
  switch (p.n) {
    MG_CB(16); MG_CB(32); MG_CB(48); MG_CB(64); MG_CB(80); MG_CB(96); MG_CB(112); MG_CB(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MG_CB
}

// The plan at these sizes on the current device, for the wrapper and tests:
// out = {route, tc, th, nb, tiles, resident, stages, warpgroups a block,
// blocks, shared-memory bytes, N, nsplit, cluster, mb, ppb, SMs}.
inline int conv_bf16_plan_out(int K, int B, int cin, int cout, int H, int W, int pixel_norm, int route, int tc,
                              int* out) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  int err = current_device(&dev, &info);
  if (err != 0) return err;
  CbPlan p;
  err = plan_cb(K, B, cin, cout, H, W, pixel_norm, info->sms, route, tc, &p);
  if (err != 0) return err;
  const int v[16] = {p.route, p.tc,     p.th, p.nb,     p.ntiles,  p.resident, p.stages, p.nwg,
                     p.blocks, (int)p.smem, p.n, p.nsplit, p.cluster, p.mb,       p.ppb,    info->sms};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
  return 0;
}

}  // namespace cb
}  // namespace mg
