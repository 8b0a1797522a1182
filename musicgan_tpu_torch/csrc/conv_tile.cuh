// Direct 3x3 convolution with a fused bias / LeakyReLU / PixelNorm epilogue,
// in two shapes: large images as an implicit GEMM on the tensor cores in
// 3xTF32, small images in float32 on the CUDA cores.
//
// One template serves three kernels:
//   K = 3: the 3x3 'SAME' conv, and the same also storing the pre-PixelNorm
//          mean-square map                         (conv3x3.cu,   K1, K2)
//   K = 2: conv3x3(up2x(x)) as four sub-pixel phase convs with 2x2 kernels
//                                                  (upconv3x3.cu, K3)
// Replaces musicgan_tpu/ops/conv.py::_kernel (K1, K2 with emit_msq) and
// ::_upconv_kernel (K3).  PixelNorm reduces over the channels of one output
// pixel, and each output pixel belongs to exactly one phase, so phase
// results go straight to (2i+a, 2j+b); the 4x-sized upsampled tensor never
// exists.
//
// Weights come in the kernel layout of ops/conv.py::kernel_weights:
// (nphase, cin, K*K, coutp), coutp = cout rounded up to 16 with zeros, so
// the weights of one input channel and one tap for a block's channels are
// one contiguous run.
//
// Output channels go to a block 16 at a time (a channel group, CO), up to 8
// groups.  Past 8 * 16 = 128 channels the groups are split over nsplit
// blocks of the same pixels.  PixelNorm needs every channel of a pixel:
// those blocks form one thread-block cluster, and each adds the others'
// per-pixel sums of u^2 through distributed shared memory, in rank order,
// so the result does not depend on scheduling.  PixelNorm therefore takes
// any cout up to 8 * 128 (a portable cluster of 8).
//
// Two shapes, chosen by plan_conv from the sizes (no timing, so a launch
// sums in the same order run after run):
//
//   large images (conv_tc_kernel; taken once its tiles fill half the SMs,
//     from 32x32 at the train step's widths): an implicit GEMM, M = 64
//     pixels of one image row, N = the block's output channels, K = taps x
//     input channels, in warpgroup products (wgmma m64nNk8, TF32).  What
//     bounds it: operations, 3 TF32 products per float32 product against
//     the card's 495 TFLOP/s (K3 at 512 x 5120: bytes).  The design:
//     - no im2col: for a tap (dy, dx) the A operand is the staged halo tile
//       shifted by (dy, dx) (for K3, by the phase's offset too); input
//       channels are staged as planes [8][rows + 2][72], the image columns
//       c0-4 .. c0+67, so that 16-byte copies stay aligned;
//     - 3xTF32 for float32 accuracy (plain TF32 keeps about 3 digits, and
//       the penalty regularises an input gradient): each operand is split
//       into big = tf32(v) and small = tf32(v - big), both rounded to
//       nearest, and a product is big*big + big*small + small*big.  A comes
//       from registers: a thread loads its fragment (4 channels x 2 pixels)
//       from the planes, conflict-free (a plane is 8 words mod 32), splits
//       it there, and the fragment of one input row and column shift serves
//       every accumulator tile (row, phase) that needs it.  B, K-major as
//       wgmma wants tf32, is [tap][channel quad][n][4] in shared memory,
//       no swizzle, big and small planes;
//     - the tensor cores' additions truncate: a chain of 27 * cin / 8
//       products into one accumulator drifts towards zero (on an H100 at
//       cin 272 by 4.7e-4, 9x the float32 plain version's error against
//       float64).  So the products of each fragment row (up to 3 taps x 3
//       terms a tile) go to a fresh accumulator
//       that is then added to the tile's in float32, round to nearest: on
//       the H100 the kernel is then nearer float64 than cuDNN's float32
//       conv (1.5e-5 against 5.4e-5 at cin 272), at 10-17% of its time
//       against a fresh accumulator a chunk of 8 channels;
//     - warp-specialised and persistent: one block an SM walks its share of
//       the tiles; a producer warpgroup stages chunks into a ring of 2-4
//       stages (the input by cp.async, the weights loaded one chunk ahead,
//       split and transposed in registers) and hands each over and back by
//       named barriers, so copies, splits and a tile's epilogue overlap the
//       two consumer warpgroups' products;
//     - tiles: a consumer warpgroup holds 8, 4, 2 or 1 m64 accumulator
//       tiles at 16, 32, 64, 128 channels; K3 holds a row's four phases in
//       one block up to 32 channels (the input halo staged once; its output
//       rows leave as 8-byte pairs of both column phases), two at 48-64;
//     - the epilogue (bias, LeakyReLU, PixelNorm: the thread's channels,
//       the quad's lanes, the cluster's blocks in rank order) runs in
//       float32 from the registers, stores 32-byte runs (8 pixels of a
//       channel) straight from them, so the ring runs on into the next tile;
//     - nvcc -Xptxas -v (CUDA 12.9, sm_90a): 168 registers a thread (384
//       threads, one block an SM); spills of 0-56 bytes a thread at every
//       width but K3's 64 channels (240 bytes, synthesis block 4) and K1's
//       128 (88, on no path); no serialised wgmma; dynamic shared memory
//       164-218 KB (K1), 118-169 KB (K3).
//
//   small images (conv_flat_kernel; taken when the large shape's tiles
//     would fill less than half the SMs): what bounds these convs is not
//     arithmetic (a few MFLOP, microseconds at the FP32 peak) but latency: a
//     chain of serial steps over the input channels in too few blocks,
//     each step staging weights.  So:
//     - the tile is NP = 32 * PR * rg pixels of the batch flattened to
//       (b, row, col): images of 1-32 pixels share a tile and every weight
//       staged serves all of them.  A lane owns PR pixels 32 apart.  The
//       input is staged as the contiguous flattened range the tile's 3x3
//       neighbourhoods reach (the tile and W + 1 pixels each side) plus one
//       zero word, and a thread reads, for each of its pixels and taps, an
//       offset fixed for the whole launch: the neighbour's, or the zero
//       word's where the neighbour lies in another row or image or past the
//       batch;
//     - K = K*K*cin is split over S <= 8 blocks of one cluster (with
//       PixelNorm past 128 channels the cluster also holds the nsplit
//       channel splits, S * nsplit <= 8), each block taking a contiguous
//       range of input-channel steps; the partial
//       tiles are reduced through distributed shared memory in rank order,
//       rank k finishing the k-th 1/S of the tile's pixels over all its
//       channels, so the epilogue (and PixelNorm, whose per-pixel sums meet
//       across the channel splits of the same pixels) stays with the rank
//       that holds the sum.  One launch, no workspace, no atomics;
//     - each step's weights are one 16-byte-copy run per (channel, tap),
//       double-buffered with the input: step k+1's copies fly while step k's
//       FMAs run;
//     - taps that leave every image (all but the centre at 1x1) are neither
//       staged nor computed.
//
// Element types.  The tensor-core pieces take activations and weights in
// float32 or in bf16 (the element type E; the bias, the accumulation and
// the epilogue are float32 in both, and the output is rounded to E once, to
// nearest even): K1, K2 and K3 use them at float32, K4 (block3x3.cuh) at
// both.  In bf16 a step is one wgmma m64nNk16 in place of 3xTF32's three
// m64nNk8: 16 input channels a chunk, the A fragment's pairs of channels
// packed into 32-bit registers, B one K-major plane with the same 128-byte
// core matrices (8 output channels x 16 bytes), so a chunk's words, the
// descriptors and the tap offsets are those of float32's.  The input planes
// hold `plane` bf16 elements (half the bytes), staged by 8-byte copies so
// that the columns staged are float32's.  The fresh accumulator a fragment
// row stays: the tensor cores' additions inside a wgmma truncate in bf16 as
// in TF32.  K1 bf16 and K3 bf16 are a kernel of their own (conv_bf16.cuh)
// that sums in this order, so K4 bf16 gives their bits.  The small shape
// is float32 only.  The output's type O is E's, or the other for the JAX
// functions' mixed calls (they compute in x's dtype and cast only at the
// store): the same plan and sums, only store_tiles' type differs (K1 and
// K3 with float32 x and a bf16 output, K4 both ways).  Each library holds
// the instances of one (E, O) pair (block3x3_bf16.cu the bf16 ones,
// *_f32_bf16.cu and *_bf16_f32.cu the mixed ones): g++ makes the
// function-local statics of template instances (launch's opt-in flags)
// unique across the process, and two libraries holding the same instance
// would share them.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace mg {

namespace coop = cooperative_groups;

using bf16 = __nv_bfloat16;

// Per element type: input channels a chunk (one k8 step of TF32, one k16
// step of bf16) and the weight planes a stage holds (3xTF32's big and small
// parts, or bf16's one).
template <typename E>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int CK = 8, PLANES = 2;
};
template <>
struct Elem<bf16> {
  static constexpr int CK = 16, PLANES = 1;
};
template <typename E>
constexpr bool is_f32 = std::is_same<E, float>::value;

template <typename E>
__device__ __forceinline__ E from_f32(float v) {
  if constexpr (is_f32<E>)
    return v;
  else
    return __float2bfloat16_rn(v);
}

constexpr int CO = 16;         // output channels per warp
constexpr int MAX_CG = 8;      // channel groups (warps of CO channels) per block
constexpr int MAX_CLUSTER = 8; // blocks of a portable cluster

// ---------------------------------------------------------------------------
// Large images: an implicit GEMM on the tensor cores in 3xTF32.
//
// Warpgroup matrix products of m64 x N x k8 in TF32, A (8 input channels of
// 64 consecutive pixels of one image row) from registers, B (8 input
// channels x N output channels of one tap) from shared memory.  Each operand
// is split into big = tf32(v) and small = tf32(v - big) and a product is
// summed as big*big + big*small + small*big into one float32 accumulator.
// scale_d 0 makes a product overwrite the accumulator instead of adding to
// it (the weight gradient starts each fresh accumulator so).  N = 144: the
// weight gradient's 3 x 48 columns (csrc/wgrad3x3.cu).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void mma(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<112> {
  static __device__ __forceinline__ void mma(float (&d)[56], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
        "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<144> {
  static __device__ __forceinline__ void mma(float (&d)[72], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, "
        "{%72, %73, %74, %75}, %76, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// The same in bf16: one product of m64 x N x k16, A (16 input channels of the
// 64 pixels, packed pairs) from registers, B K-major from shared memory,
// float32 accumulation (bf16 x bf16 products are exact in float32).
template <int N>
struct WgmmaBf16;

template <>
struct WgmmaBf16<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<80> {
  static __device__ __forceinline__ void mma(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<112> {
  static __device__ __forceinline__ void mma(float (&d)[56], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
        "{%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Shared-memory matrix descriptor, no swizzle, K-major: core matrices of 8
// rows x 16 bytes; lbo: bytes between the two core matrices along K, sbo:
// bytes between core matrices 8 rows apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

constexpr int TC_W = 64;          // tile columns: the 64 rows of one wgmma
constexpr int TC_SW = TC_W + 8;   // staged columns, image columns c0-4 .. c0+67
constexpr int TC_CK = 8;          // float32 input channels a stage (one k8 step); the
                                  // words a stage's input plane row and weights count in
constexpr int TC_WG = 2;          // consumer warpgroups a block (the products)
constexpr int TC_THREADS = 128 * (TC_WG + 1);  // and one producer warpgroup (the copies)
constexpr int TC_SMEM_BUDGET = 220 * 1024;      // bytes of stages and sums a block

// The large shape's geometry at N output channels a block, for K = 3 (K1,
// K2) and K = 2 (K3).  tiles: m64 accumulator tiles a consumer warpgroup
// holds (at most 64 floats a thread); ppb: K3's phases a block (the tiles of
// one input row are its phases where they fit); rows: image rows a
// warpgroup owns; th: rows a tile; nt: weight taps a stage holds; plane: an
// input channel's staged halo tile (elements); stage: a stage's input and
// weight planes (planes: 2 for float32's split, 1 for bf16), in 4-byte
// words; stages: as many as the budget holds, 2 to 4.  A bf16 stage has
// float32's input words (16 channels of half the bytes) and one plane.
struct TcGeom {
  int tiles, ppb, rows, th, nt, plane, bsplit, stage, stages, floats;
};
__host__ __device__ constexpr TcGeom tc_geom(int K, int N, int planes = 2) {
  const int tiles = N <= 16 ? 8 : N <= 32 ? 4 : N <= 64 ? 2 : 1;
  const int ppb = K == 2 ? (tiles < 4 ? tiles : 4) : 1;
  const int rows = tiles / ppb, th = TC_WG * rows;
  const int nt = K == 3 ? 9 : 4 * ppb;
  const int sh = th + 2;
  // Padded to 8 words mod 32, so that a fragment's 4 channels x 8 pixels
  // fall in 32 distinct banks.
  const int plane = (sh * TC_SW + 23) / 32 * 32 + 8;
  const int bsplit = nt * TC_CK * N;  // one of the two split weight planes
  const int stage = TC_CK * plane + planes * bsplit;
  const int part = 2 * TC_WG * tiles * TC_W;
  const int fit = (TC_SMEM_BUDGET / 4 - part) / stage;
  const int stages = fit > 4 ? 4 : fit;
  return TcGeom{tiles, ppb, rows, th, nt, plane, bsplit, stage, stages, stages * stage + part};
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- The pieces of the tensor-core route, shared by conv_tc_kernel (K1,
// K2, K3) and block3x3.cuh's whole-block kernel (K4), so that both sum every
// output in one order.

// Four consecutive elements of one channel row: 16 bytes of float32 (L2
// only: the input is read once a tile), 8 of bf16.
__device__ __forceinline__ void cp_async_x4(float* dst, const float* src, bool valid) {
  cp_async16_cg(dst, src, valid);
}
__device__ __forceinline__ void cp_async_x4(bf16* dst, const bf16* src, bool valid) {
  cp_async8(dst, src, valid);
}

// The producer warpgroup (thread pt of 128) copies a chunk's input channels'
// halo tile (Elem<E>::CK of them) into planes [CK][plane]: image rows
// r_first .. r_first + rows - 1, columns c_first .. c_first + TC_SW - 1, zero
// outside the image and past cin.  vec: runs of 4 elements (W and c_first
// multiples of 4, x aligned to 4 elements), each wholly inside or outside
// the image.  Otherwise one element at a time: 4-byte copies of float32,
// plain loads and stores of bf16.
template <typename E>
__device__ __forceinline__ void stage_input(E* a_s, const E* xb, const E* any, int cin, int H, int W,
                                            int ci0, int r_first, int rows, int c_first, int plane,
                                            int pt, bool vec) {
  constexpr int CK = Elem<E>::CK;
  if (vec) {
    for (int e = pt; e < CK * rows * (TC_SW / 4); e += 128) {
      const int qq = e % (TC_SW / 4), tt = e / (TC_SW / 4), rl = tt % rows, ci = tt / rows;
      const int gr = r_first + rl, gc = c_first + 4 * qq, c = ci0 + ci;
      const bool ok = c < cin && gr >= 0 && gr < H && gc >= 0 && gc < W;
      cp_async_x4(a_s + ci * plane + rl * TC_SW + 4 * qq, ok ? xb + ((size_t)c * H + gr) * W + gc : any, ok);
    }
    return;
  }
  for (int e = pt; e < CK * rows * TC_SW; e += 128) {
    const int qq = e % TC_SW, tt = e / TC_SW, rl = tt % rows, ci = tt / rows;
    const int gr = r_first + rl, gc = c_first + qq, c = ci0 + ci;
    const bool ok = c < cin && gr >= 0 && gr < H && gc >= 0 && gc < W;
    const E* src = ok ? xb + ((size_t)c * H + gr) * W + gc : any;
    if constexpr (is_f32<E>)
      cp_async4(a_s + ci * plane + rl * TC_SW + qq, src, ok);
    else
      a_s[ci * plane + rl * TC_SW + qq] = ok ? *src : from_f32<E>(0.f);
  }
}

// A chunk's weights into the producer's registers (zero past cin and
// coutp): its r-th (tap, channel group, output channel) is e = 128 * r + pt,
// the output channel fastest, so that a warp's loads are runs of channels; a
// group is 4 float32 channels (one 16-byte word of TF32's k8) or 8 bf16
// channels (one of bf16's k16, as 4 words of pairs, the lower channel in the
// low half).  K = 3: taps tap0 + 0 .. NT - 1 of w (cin, 9, coutp); K = 2: the
// phases ph0 + tap / 4, sub-tap tap % 4 of w (4, cin, 4, coutp).  The
// address is formed before the bounds test: formed inside it, float32 K3
// ran 7% slower over synthesis's blocks on an H100 (scripts/torch_ab.py),
// with the same bits.
template <int K, typename T>
__device__ __forceinline__ const T* weight_at(const T* w, int cin, int coutp, int c, int tap, int ph0, int co) {
  return K == 3 ? w + ((size_t)c * 9 + tap) * coutp + co
                : w + (((size_t)(ph0 + tap / 4) * cin + c) * 4 + tap % 4) * coutp + co;
}
template <int K, int NT, int N, int WREGS>
__device__ __forceinline__ void load_weight_chunk(float (&wv)[WREGS][4], const float* __restrict__ w,
                                                  int cin, int coutp, int co_base, int ci0, int tap0,
                                                  int ph0, int pt) {
#pragma unroll
  for (int r = 0; r < WREGS; ++r) {
    const int e = r * 128 + pt;
    const int n = e % N, tt = e / N, cq = tt & 1, tap = tt >> 1;
    const int co = co_base + n;
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int c = ci0 + 4 * cq + c4;
      const float* src = weight_at<K>(w, cin, coutp, c, tap0 + tap, ph0, co);
      wv[r][c4] = e < NT * 2 * N && c < cin && co < coutp ? __ldg(src) : 0.f;
    }
  }
}
template <int K, int NT, int N, int WREGS>
__device__ __forceinline__ void load_weight_chunk(uint32_t (&wv)[WREGS][4], const bf16* __restrict__ w,
                                                  int cin, int coutp, int co_base, int ci0, int tap0,
                                                  int ph0, int pt) {
  const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
#pragma unroll
  for (int r = 0; r < WREGS; ++r) {
    const int e = r * 128 + pt;
    const int n = e % N, tt = e / N, oct = tt & 1, tap = tt >> 1;
    const int co = co_base + n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t half[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = ci0 + 8 * oct + 2 * i + h;
        const unsigned short* src = weight_at<K>(wu, cin, coutp, c, tap0 + tap, ph0, co);
        half[h] = e < NT * 2 * N && c < cin && co < coutp ? __ldg(src) : 0u;
      }
      wv[r][i] = half[0] | (half[1] << 16);
    }
  }
}

// The chunk's weights split into big and small and written K-major, one
// 16-byte word of 4 input channels each, [tap][quad][n][4] per plane.
template <int NT, int N, int WREGS>
__device__ __forceinline__ void store_split_weights(float* b_big, float* b_small,
                                                    const float (&wv)[WREGS][4], int pt) {
#pragma unroll
  for (int r = 0; r < WREGS; ++r) {
    const int e = r * 128 + pt;
    if (e < NT * 2 * N) {
      float hi[4], lo[4];
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        hi[c4] = __uint_as_float(to_tf32(wv[r][c4]));
        lo[c4] = __uint_as_float(to_tf32(wv[r][c4] - hi[c4]));
      }
      reinterpret_cast<float4*>(b_big)[e] = make_float4(hi[0], hi[1], hi[2], hi[3]);
      reinterpret_cast<float4*>(b_small)[e] = make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// The chunk's weights as a stage holds them, from b on (bsplit words a
// plane): float32 split into its two TF32 planes; bf16 as they are, one
// plane [tap][octet][n][8], the same 16-byte words in the same places.
template <int NT, int N, int WREGS>
__device__ __forceinline__ void store_stage_weights(float* b, int bsplit, const float (&wv)[WREGS][4], int pt) {
  store_split_weights<NT, N>(b, b + bsplit, wv, pt);
}
template <int NT, int N, int WREGS>
__device__ __forceinline__ void store_stage_weights(float* b, int, const uint32_t (&wv)[WREGS][4], int pt) {
#pragma unroll
  for (int r = 0; r < WREGS; ++r) {
    const int e = r * 128 + pt;
    if (e < NT * 2 * N) reinterpret_cast<uint4*>(b)[e] = make_uint4(wv[r][0], wv[r][1], wv[r][2], wv[r][3]);
  }
}
// The producer's registers for a chunk's weights.
template <typename E, int WREGS>
using WeightRegs = std::conditional_t<is_f32<E>, float[WREGS][4], uint32_t[WREGS][4]>;

// A fragment of m64 x k8 from planes [channel][plane] (pixels 16*wq + g and
// + 8, channels t and t + 4 of the thread; ap points at channel t, pixel
// 16*wq + g), split in registers into big and small TF32 parts.
__device__ __forceinline__ void load_split_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* ap,
                                             int plane) {
  const float av[4] = {ap[0], ap[8], ap[4 * plane], ap[4 * plane + 8]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = to_tf32(av[i]);
    lo[i] = to_tf32(av[i] - __uint_as_float(hi[i]));
  }
}

// One float32 product in 3xTF32: big*big + big*small + small*big.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                     uint64_t b_big, uint64_t b_small) {
  Wgmma<N>::mma(d, hi, b_big);
  Wgmma<N>::mma(d, hi, b_small);
  Wgmma<N>::mma(d, lo, b_big);
}

// A thread's A fragment and its products, per element type.  The thread's
// first channel of a chunk is CH * t: float32's m64 x k8 fragment holds
// channels t, t + 4 of pixels 16*wq + g and + 8; bf16's m64 x k16 fragment
// holds channels 2t, 2t + 1, 2t + 8, 2t + 9 of them, pairs (2t, 2t + 1) and
// (2t + 8, 2t + 9) packed into one register each, the lower channel in the
// low half: registers (g; 2t), (g + 8; 2t), (g; 2t + 8), (g + 8; 2t + 8).
template <typename E>
struct AFrag;
template <>
struct AFrag<float> {
  static constexpr int CH = 1;
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void load(const float* ap, int plane) { load_split_a(hi, lo, ap, plane); }
  template <int N>
  __device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t b_big, uint64_t b_small) const {
    mma3<N>(d, hi, lo, b_big, b_small);
  }
};
template <>
struct AFrag<bf16> {
  static constexpr int CH = 2;
  uint32_t a[4];
  __device__ __forceinline__ void load(const bf16* ap, int plane) {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(ap);
    const int o[4] = {0, 8, 8 * plane, 8 * plane + 8};
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = (uint32_t)p[o[i]] | ((uint32_t)p[o[i] + plane] << 16);
  }
  template <int N>
  __device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t b, uint64_t) const {
    WgmmaBf16<N>::mma(d, a, b);
  }
};

template <int T, int ND>
__device__ __forceinline__ void fence_tiles(float (&d)[T][ND]) {
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int k = 0; k < ND; ++k) fence_operand(d[u][k]);
}

// The tensor cores' own additions truncate, so products go to a fresh
// accumulator d, which is added to the tile's in float32 (round to
// nearest) after each fragment row and set to zero again.
template <int T, int ND>
__device__ __forceinline__ void add_fresh(float (&acc)[T][ND], float (&d)[T][ND]) {
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      fence_operand(d[u][k]);
      acc[u][k] += d[u][k];
      d[u][k] = 0.f;
      fence_operand(d[u][k]);
    }
}

// A chunk's products for a warpgroup's T accumulator tiles: each input row
// j and column shift s of the halo is loaded once as an A fragment (row(j)
// points at the thread's first channel, pixel 16*wq + g of input row j; + s
// shifts it), split (float32), and serves every tile (row, phase) whose tap
// it is.  Two fragments in registers at a time: a group's products are in
// flight while the next one's fragment is loaded.  K = 3: RW rows, one
// tile each, taps dy * 3 + dx; K = 2: RW rows of PPB phases, phase offsets
// (oy, ox) compile-time (OY, OX where a block holds fewer than four
// phases), taps pu * 4 + dy * 2 + dx.  After each input row the fresh
// accumulators go into acc.  d_small: float32's small TF32 plane (bf16: 0).
template <typename E, int K, int N, int T, int PPB, int RW, int OY, int OX, typename Row>
__device__ __forceinline__ void tc_products(float (&acc)[T][N / 2], float (&d)[T][N / 2], Row row,
                                            int plane, uint64_t d_big, uint64_t d_small) {
  fence_tiles(d);
  AFrag<E> fr[2];
#pragma unroll
  for (int j = 0; j < RW + 2; ++j) {
    const E* rp = row(j);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int f = (j * 3 + s) & 1;
      fr[f].load(rp + s, plane);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < T; ++u) {
        const int ru = u / PPB, pu = u % PPB;
        const int oy = K == 3 ? 0 : PPB == 4 ? pu >> 1 : OY;
        const int ox = K == 3 ? 0 : PPB == 4 ? pu & 1 : PPB == 2 ? pu : OX;
        const int dy = j - ru - oy, dx = s - ox;
        if (dy >= 0 && dy < K && dx >= 0 && dx < K) {
          const int tap = K == 3 ? dy * 3 + dx : pu * 4 + dy * 2 + dx;
          const uint64_t off = (uint64_t)(tap * N * 32) >> 4;
          fr[f].template mma<N>(d[u], d_big + off, d_small + off);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    add_fresh(acc, d);
  }
}

// Bias and LeakyReLU on a warpgroup's tiles in registers.  A thread holds,
// of tile u, pixels m = 16*wq + g + 8*i and channels 8*j + 2*t + e as
// acc[u][4*j + 2*i + e].
template <int T, int N>
__device__ __forceinline__ void bias_lrelu(float (&acc)[T][N / 2], const float* __restrict__ bias,
                                           int co_base, int cout, int t, float slope, int use_slope) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co_base + 8 * j + 2 * t + e;
      const float bk = (bias != nullptr && co < cout) ? bias[co] : 0.f;
#pragma unroll
      for (int u = 0; u < T; ++u)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = acc[u][4 * j + 2 * i + e] + bk;
          if (use_slope) v = v >= 0.f ? v : slope * v;
          acc[u][4 * j + 2 * i + e] = v;
        }
    }
}

// PixelNorm's sum of u^2 for each of the thread's pixels: its channels in
// order, then the quad's four lanes.
template <int T, int N>
__device__ __forceinline__ void pn_sums(const float (&acc)[T][N / 2], float (&sum)[T][2]) {
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) sq = fmaf(acc[u][4 * j + 2 * i + e], acc[u][4 * j + 2 * i + e], sq);
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      sum[u][i] = sq;
    }
}

// The sums of the blocks of a cluster that share the pixels, in rank order
// 0 .. nranks - 1: each writes its own to pt ([TC_WG][T][64]), the cluster
// meets, each reads all.
template <int T>
__device__ __forceinline__ void pn_cluster_sums(float (&sum)[T][2], float* pt, int wg, int wq, int g,
                                                int t, int nranks) {
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (t == 0) pt[(wg * T + u) * TC_W + 16 * wq + g + 8 * i] = sum[u][i];
  coop::cluster_group cluster = coop::this_cluster();
  cluster.sync();
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sq = 0.f;
      for (int k = 0; k < nranks; ++k)
        sq += cluster.map_shared_rank(pt, k)[(wg * T + u) * TC_W + 16 * wq + g + 8 * i];
      sum[u][i] = sq;
    }
}

// The PixelNorm scale of pixel (u, i), from its mean of u^2 m.
template <int T, int N>
__device__ __forceinline__ void pn_scale(float (&acc)[T][N / 2], int u, int i, float m, float eps) {
  const float scale = rsqrtf(m + eps);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) acc[u][4 * j + 2 * i + e] *= scale;
}

// Two horizontally adjacent output pixels (K3's column phases) in one store.
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Stores of a warpgroup's tiles to y (B, cout, H * st, W * st), of the
// output type O (rounded once where it is bf16): tile u is image row r0 + u / PPB of phase ph0 + u % PPB, pixels c0 + m
// for m < mlim; rows from rlim on are not stored.  A warp's store covers 8
// consecutive pixels of 4 channels, or, where the block holds both column
// phases of K3's output row, the two phases of 8 pixels as pairs.
template <typename O, int K, int T, int N, int PPB>
__device__ __forceinline__ void store_tiles(const float (&acc)[T][N / 2], O* __restrict__ y, int b,
                                            int cout, int co_base, int H, int W, int st, int r0, int c0,
                                            int ph0, int rlim, int mlim, int wq, int g, int t) {
  const size_t plane_o = (size_t)H * st * W * st;
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int ru = u / PPB, pu = u % PPB;
    const int ph = ph0 + pu;
    const int oy = K == 2 ? ph >> 1 : 0, ox = K == 2 ? ph & 1 : 0;
    if (PPB >= 2 && (pu & 1)) continue;  // stored with its ox = 0 partner
    const int r = r0 + ru;
    if (r >= rlim) continue;
    O* yrow = y + (size_t)b * cout * plane_o + (size_t)(r * st + oy) * W * st;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co_base + 8 * j + 2 * t + e;
        if (co >= cout) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = 16 * wq + g + 8 * i, c = c0 + m;
          if (m >= mlim || c >= W) continue;
          O* dst = yrow + co * plane_o;
          if constexpr (PPB >= 2)
            store_pair(dst + 2 * c, acc[u][4 * j + 2 * i + e], acc[u + 1][4 * j + 2 * i + e]);
          else
            dst[c * st + ox] = from_f32<O>(acc[u][4 * j + 2 * i + e]);
        }
      }
  }
}

// x: (B, cin, H, W); w: kernel layout; bias: (cout,) or null for none;
// y: (B, cout, H, W), or (B, cout, 2H, 2W) when nphase == 4; msq: null, or
// (B, 1, H, W) to receive the pre-norm mean over channels of u^2 (K2; needs
// pixel_norm and nphase == 1).  Persistent: block x = cluster * nsplit +
// split walks the tiles cluster, cluster + clusters, ... of the ntx x nty x
// nz tiles (columns fastest; nz = B * phase groups), each 64 columns x th
// rows of one image and phase group, for the split's N output channels.
// With PixelNorm and nsplit > 1 the nsplit blocks of a tile are one cluster.
//
// Warp-specialised: the producer warpgroup stages the block's sequence of
// chunks (a tile's Elem<E>::CK input channels each) into a ring of stages,
// a stage at a time: the input by cp.async, the weights loaded (float32:
// split into big and small) and transposed to K-major; it hands a stage
// over by a named barrier (full) and takes it back by another (empty).  The
// two consumer warpgroups multiply and run the epilogue.  E: float32 or
// bf16 x and w; O: float32 or bf16 y, stored from the float32 epilogue
// (the bias and msq are float32).
template <typename E, typename O, int K, int N>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_tc_kernel(const E* __restrict__ x, const E* __restrict__ w,
               const float* __restrict__ bias, O* __restrict__ y,
               float* __restrict__ msq, int cin, int cout, int coutp, int H, int W,
               int nphase, int nsplit, int ntx, int nty, int nz, float slope, int use_slope,
               int pixel_norm, float eps) {
  constexpr int CK = Elem<E>::CK, PL = Elem<E>::PLANES;
  constexpr TcGeom G = tc_geom(K, N, PL);
  constexpr int T = G.tiles, PPB = G.ppb, RW = G.rows, TH = G.th, NT = G.nt, S = G.stages;
  constexpr int SH = TH + 2, ND = N / 2;
  static_assert(S >= 2, "two stages must fit");
  // Named barriers (0 is __syncthreads'): stage s full 1 + s, empty 1 + S
  // + s (producer and consumers, all TC_THREADS); the producer's own.
  constexpr int FULL = 1, EMPTY = 1 + S, PRODUCER = 1 + 2 * S;
  extern __shared__ __align__(128) float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // Stage s: input [CK][plane] of E, then the weight planes [NT][2][N][16
  // bytes] (K-major, 128-byte core matrices; float32: big, then small); then
  // PixelNorm's sums, 2 x [WG][T][64].
  float* part = smem + S * G.stage;

  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) & 3, wg = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x % nsplit, cid = blockIdx.x / nsplit, ncl = gridDim.x / nsplit;
  const int nphg = nphase / PPB;
  const int co_base = split * N;
  const int ntiles = ntx * nty * nz;
  const int my_tiles = cid < ntiles ? (ntiles - cid + ncl - 1) / ncl : 0;
  const int nchunks = (cin + CK - 1) / CK;
  const int total = my_tiles * nchunks;
  const bool clustered = pixel_norm && nsplit > 1;

  struct Tile {
    int c0, r0, b, ph0;
  };
  auto tile_of = [&](int it) {
    const int tl = cid + it * ncl;
    const int bx = tl % ntx, rest = tl / ntx, by = rest % nty, zi = rest / nty;
    return Tile{bx * TC_W, by * TH, zi / nphg, (zi % nphg) * PPB};
  };

  if (wg == TC_WG) {
    // ---- The producer. ----
    const int pt = tid - 128 * TC_WG;
    const bool vec = (W & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(E) - 1)) == 0;
    // Chunk q's halo tile and (one chunk ahead, into registers) its weights.
    auto issue = [&](int q) {
      const Tile tq = tile_of(q / nchunks);
      stage_input(reinterpret_cast<E*>(smem + (q % S) * G.stage), x + (size_t)tq.b * cin * H * W, x, cin,
                  H, W, (q % nchunks) * CK, tq.r0 - 1, SH, tq.c0 - 4, G.plane, pt, vec);
    };
    constexpr int WREGS = (NT * 2 * N + 127) / 128;
    WeightRegs<E, WREGS> wv;
    auto load_weights = [&](int q) {
      const Tile tq = tile_of(q / nchunks);
      load_weight_chunk<K, NT, N>(wv, w, cin, coutp, co_base, (q % nchunks) * CK, 0, tq.ph0, pt);
    };
    // One commit group a chunk: chunk q is group q.  The first S are
    // issued here, chunk q + S when the consumers give back chunk q's stage.
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (k < total) issue(k);
      cp_async_commit();
    }
    if (total > 0) load_weights(0);
    for (int k = 0; k < total; ++k) {
      if (k == 0)
        cp_async_wait<S - 1>();
      else
        cp_async_wait<S - 2>();
      bar_sync(PRODUCER, 128);  // chunk k's input landed, every producer thread's copies
      store_stage_weights<NT, N>(smem + (k % S) * G.stage + TC_CK * G.plane, G.bsplit, wv, pt);
      if (k + 1 < total) load_weights(k + 1);
      fence_proxy_async();  // the weights are read by wgmma
      bar_arrive(FULL + k % S, TC_THREADS);
      if (k >= 1) {
        const int kn = k - 1 + S;
        if (kn < total) {
          bar_sync(EMPTY + (k - 1) % S, TC_THREADS);
          issue(kn);
        }
        cp_async_commit();
      }
      if (clustered && k % nchunks == nchunks - 1) coop::this_cluster().sync();  // the tile's exchange
    }
    if (clustered) coop::this_cluster().sync();
    return;
  }

  // ---- The consumers. ----
  for (int it = 0; it < my_tiles; ++it) {
    const Tile tc = tile_of(it);
    const int c0 = tc.c0, r0 = tc.r0, b = tc.b, ph0 = tc.ph0;
    float acc[T][ND];
#pragma unroll
    for (int u = 0; u < T; ++u)
#pragma unroll
      for (int k = 0; k < ND; ++k) acc[u][k] = 0.f;

    for (int kc = 0; kc < nchunks; ++kc) {
      const int q = it * nchunks + kc;
      float d[T][ND];
#pragma unroll
      for (int u = 0; u < T; ++u)
#pragma unroll
        for (int k = 0; k < ND; ++k) d[u][k] = 0.f;
      const float* cur = smem + (q % S) * G.stage;
      bar_sync(FULL + q % S, TC_THREADS);
      const uint64_t d_big = smem_desc(cur + TC_CK * G.plane, N * 16, 128);
      const uint64_t d_small = PL == 2 ? smem_desc(cur + TC_CK * G.plane + G.bsplit, N * 16, 128) : 0;
      // Input row j of the warpgroup's halo; which tiles a fragment serves
      // is fixed at compile time (OY, OX: the phase offsets of a block of
      // K3 that holds fewer than four phases).
      const E* a_base = reinterpret_cast<const E*>(cur) + AFrag<E>::CH * t * G.plane + (wg * RW) * TC_SW + 3 +
                        16 * wq + g;
      auto row = [&](int j) { return a_base + j * TC_SW; };
      if constexpr (K == 3 || PPB == 4) {
        tc_products<E, K, N, T, PPB, RW, 0, 0>(acc, d, row, G.plane, d_big, d_small);
      } else if constexpr (PPB == 2) {
        if (ph0 >> 1) tc_products<E, K, N, T, PPB, RW, 1, 0>(acc, d, row, G.plane, d_big, d_small);
        else tc_products<E, K, N, T, PPB, RW, 0, 0>(acc, d, row, G.plane, d_big, d_small);
      } else {
        switch (ph0) {
          case 0: tc_products<E, K, N, T, PPB, RW, 0, 0>(acc, d, row, G.plane, d_big, d_small); break;
          case 1: tc_products<E, K, N, T, PPB, RW, 0, 1>(acc, d, row, G.plane, d_big, d_small); break;
          case 2: tc_products<E, K, N, T, PPB, RW, 1, 0>(acc, d, row, G.plane, d_big, d_small); break;
          default: tc_products<E, K, N, T, PPB, RW, 1, 1>(acc, d, row, G.plane, d_big, d_small); break;
        }
      }
      if (q + S < total) bar_arrive(EMPTY + q % S, TC_THREADS);  // the stage goes back
    }

    // Epilogue in float32, from the registers.
    bias_lrelu<T, N>(acc, bias, co_base, cout, t, slope, use_slope);
    if (pixel_norm) {
      // A pixel's sum of u^2: the thread's channels in order, then the
      // quad's four lanes, then (past 128 channels) the cluster's blocks in
      // rank order, through a buffer of this tile's parity (a block reuses
      // it two tiles later, after every block has passed the next tile's
      // cluster barrier, so after every read of it).
      float sum[T][2];
      pn_sums<T, N>(acc, sum);
      if (clustered) pn_cluster_sums<T>(sum, part + (it & 1) * (TC_WG * T * TC_W), wg, wq, g, t, nsplit);
#pragma unroll
      for (int u = 0; u < T; ++u)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m = sum[u][i] / (float)cout;
          if (msq != nullptr && t == 0 && split == 0) {
            const int r = r0 + wg * RW + u, c = c0 + 16 * wq + g + 8 * i;
            if (r < H && c < W) msq[((size_t)b * H + r) * W + c] = m;
          }
          pn_scale<T, N>(acc, u, i, m, eps);
        }
    }
    store_tiles<O, K, T, N, PPB>(acc, y, b, cout, co_base, H, W, nphase == 4 ? 2 : 1, r0 + wg * RW, c0,
                                 ph0, H, TC_W, wq, g, t);
  }
  // A block's shared memory must outlive the other blocks' reads of it.
  if (clustered) coop::this_cluster().sync();
}

// ---------------------------------------------------------------------------
// Small images.  Block x = (tile * nsplit + split) * S + ks: pixels
// [tile * NP, tile * NP + NP) of the flattened batch, channels
// [split * COP, split * COP + COP), input-channel steps [ks * csteps,
// ks * csteps + csteps).  The S blocks of a (tile, split) are one cluster;
// with PixelNorm and nsplit > 1 the nsplit * S blocks of a tile are.
// blockIdx.y is the phase.  E: float32 (K1 bf16 and K3 bf16 are
// conv_bf16.cuh's); O: float32 or bf16 y.
template <typename E, typename O, int K, int PR, int CK>
__global__ void __launch_bounds__(256, 2)
conv_flat_kernel(const E* __restrict__ x, const E* __restrict__ w,
                 const float* __restrict__ bias, O* __restrict__ y,
                 float* __restrict__ msq, int cin, int cout, int coutp, int H, int W,
                 int N, int rg, int nphase, int nsplit, int S, int csteps, float slope,
                 int use_slope, int pixel_norm, float eps) {
  static_assert(is_f32<E>, "the small shape is float32 only");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int KK = K * K;
  const bool pn_cluster = pixel_norm && nsplit > 1;  // the splits share a cluster
  const int csize = pn_cluster ? S * nsplit : S;
  const int ks = blockIdx.x % S, split = (blockIdx.x / S) % nsplit;
  const int tile = blockIdx.x / (S * nsplit);
  // Cluster rank of the block (split', ks') of this tile.
  auto rank_of = [&](int sp, int k) { return pn_cluster ? sp * S + k : k; };
  const int ph = blockIdx.y, oy = ph >> 1, ox = ph & 1;
  const int cg = blockDim.x / (32 * rg);
  const int COP = cg * CO, NP = 32 * PR * rg;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int cgi = wid % cg, rgi = wid / cg;
  const int co_base = split * COP;
  const int p0 = tile * NP;
  const int HW = H * W;
  // Staged pixels of a channel: the tile and W + 1 each side, then one
  // word that stays 0, which every neighbour outside a pixel's image reads.
  const int L = NP + 2 * W + 3, ZERO = L - 1;
  const int WBUF = CK * KK * COP;
  const int BUF = WBUF + ((CK * L + 3) & ~3);  // keeps each buffer 16-byte aligned

  // Taps whose offset leaves every image; and for each of this thread's
  // pixels and each tap, where in a staged channel its neighbour lies (the
  // zero word where it is in another row or image or past the batch).
  int live = 0;
#pragma unroll
  for (int t = 0; t < KK; ++t) {
    const int ry = oy + t / K - 1, rx = ox + t % K - 1;
    if (ry > -H && ry < H && rx > -W && rx < W) live |= 1 << t;
  }
  int pl[PR], src_of[PR][KK];
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    pl[i] = rgi * 32 * PR + lane + 32 * i;
    const int p = p0 + pl[i];
    const int rem = p % HW, r = rem / W, c = rem - r * W;
#pragma unroll
    for (int t = 0; t < KK; ++t) {
      const int dr = oy + t / K - 1, dc = ox + t % K - 1;
      const bool in = p < N && r + dr >= 0 && r + dr < H && c + dc >= 0 && c + dc < W;
      src_of[i][t] = in ? pl[i] + W + 1 + dr * W + dc : ZERO;
    }
  }

  const int total_steps = (cin + CK - 1) / CK;
  const int s_begin = ks * csteps;
  const int nsteps = max(0, min(csteps, total_steps - s_begin));
  const E* wp = w + (size_t)ph * cin * KK * coutp;

  auto stage = [&](int step, float* buf) {
    const int ci0 = (s_begin + step) * CK;
    const int q4 = COP / 4;
    for (int i = threadIdx.x; i < CK * KK * q4; i += blockDim.x) {
      const int j4 = i % q4, t = i / q4, tap = t % KK, cil = t / KK;
      if (!(live >> tap & 1)) continue;
      const int c = ci0 + cil, co = co_base + 4 * j4;
      const bool ok = c < cin && co < coutp;
      cp_async16(buf + t * COP + 4 * j4, ok ? wp + ((size_t)c * KK + tap) * coutp + co : wp, ok);
    }
    float* a_s = buf + WBUF;
    for (int e = threadIdx.x; e < L; e += blockDim.x) {
      const int q = p0 - W - 1 + e;
      const bool inside = e < ZERO && q >= 0 && q < N;
      const int bq = inside ? q / HW : 0;
      const E* src = x + (inside ? (size_t)bq * cin * HW + (q - bq * HW) : 0);
#pragma unroll
      for (int ci = 0; ci < CK; ++ci) {
        const bool ok = inside && ci0 + ci < cin;
        cp_async4(a_s + ci * L + e, ok ? src + (size_t)(ci0 + ci) * HW : x, ok);
      }
    }
  };

  float acc[PR][CO];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[i][k] = 0.f;

  if (nsteps > 0) {
    stage(0, smem);
    cp_async_commit();
  }
  for (int st = 0; st < nsteps; ++st) {
    const float* cur = smem + (st & 1) * BUF;
    if (st + 1 < nsteps) {
      stage(st + 1, smem + ((st + 1) & 1) * BUF);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* a_s = cur + WBUF;
    const float* w_s = cur + cgi * CO;
    for (int ci = 0; ci < CK; ++ci, a_s += L, w_s += KK * COP) {
#pragma unroll
      for (int t = 0; t < KK; ++t) {
        if (!(live >> t & 1)) continue;
        float a[PR];
#pragma unroll
        for (int i = 0; i < PR; ++i) a[i] = a_s[src_of[i][t]];
        const float4* wv = reinterpret_cast<const float4*>(w_s + t * COP);
        float wr[CO];
#pragma unroll
        for (int q = 0; q < CO / 4; ++q) {
          const float4 t4 = wv[q];
          wr[4 * q] = t4.x;
          wr[4 * q + 1] = t4.y;
          wr[4 * q + 2] = t4.z;
          wr[4 * q + 3] = t4.w;
        }
#pragma unroll
        for (int i = 0; i < PR; ++i)
#pragma unroll
          for (int k = 0; k < CO; ++k) acc[i][k] = fmaf(a[i], wr[k], acc[i][k]);
      }
    }
    __syncthreads();
  }

  // The partial tile, [COP][NP], over the staging buffers.
  float* red = smem;
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int k = 0; k < CO; ++k) red[(cgi * CO + k) * NP + pl[i]] = acc[i][k];
  if (csize > 1)
    coop::this_cluster().sync();
  else
    __syncthreads();

  // Block ks finishes pixels [ks * SL, ks * SL + SL) of the tile: the S
  // partials of its split in rank order, bias, LeakyReLU, in place (no
  // other block reads this slice of this block's tile).
  const int SL = NP / S, sl0 = ks * SL;
  for (int e = threadIdx.x; e < COP * SL; e += blockDim.x) {
    const int co = e / SL, idx = co * NP + sl0 + e % SL;
    float v = 0.f;
    if (S > 1) {
      coop::cluster_group cluster = coop::this_cluster();
      for (int k = 0; k < S; ++k) v += cluster.map_shared_rank(red, rank_of(split, k))[idx];
    } else {
      v = red[idx];
    }
    const int gco = co_base + co;
    if (bias != nullptr && gco < cout) v += bias[gco];
    if (use_slope) v = v >= 0.f ? v : slope * v;
    red[idx] = v;
  }

  float* part = smem + COP * NP;  // [SL]: this block's sum of u^2 a pixel
  float* scl = part + SL;         // [SL]: the PixelNorm scale a pixel
  if (pixel_norm) {
    __syncthreads();
    for (int j = threadIdx.x; j < SL; j += blockDim.x) {
      float s = 0.f;
      for (int co = 0; co < COP; ++co) {
        const float v = red[co * NP + sl0 + j];
        s = fmaf(v, v, s);
      }
      part[j] = s;
    }
    if (pn_cluster)
      coop::this_cluster().sync();
    else
      __syncthreads();
    for (int j = threadIdx.x; j < SL; j += blockDim.x) {
      float s = part[j];
      if (pn_cluster) {
        coop::cluster_group cluster = coop::this_cluster();
        s = 0.f;
        for (int k = 0; k < nsplit; ++k) s += cluster.map_shared_rank(part, rank_of(k, ks))[j];
      }
      const float m = s / (float)cout;
      const int p = p0 + sl0 + j;
      if (msq != nullptr && split == 0 && p < N) msq[p] = m;
      scl[j] = rsqrtf(m + eps);
    }
  }
  __syncthreads();

  const int sts = nphase == 4 ? 2 : 1;
  const int Ho = H * sts, Wo = W * sts;
  for (int e = threadIdx.x; e < COP * SL; e += blockDim.x) {
    const int co = e / SL, j = e % SL;
    const int gco = co_base + co, p = p0 + sl0 + j;
    if (gco >= cout || p >= N) continue;
    float v = red[co * NP + sl0 + j];
    if (pixel_norm) v *= scl[j];
    const int bq = p / HW, rem = p - bq * HW, r = rem / W, c = rem - r * W;
    y[((size_t)bq * cout + gco) * Ho * Wo + (size_t)(r * sts + oy) * Wo + c * sts + ox] = from_f32<O>(v);
  }
  // A block's shared memory must outlive the other blocks' reads of it.
  if (csize > 1) coop::this_cluster().sync();
}

// ---------------------------------------------------------------------------
constexpr int MAX_DEVICES = 64;

// What the launcher asks of the current device, looked up once per device.
struct DeviceInfo {
  int sms = 0;         // streaming multiprocessors
  int smem_optin = 0;  // most dynamic shared memory a block may request
};

inline int current_device(int* dev, const DeviceInfo** info) {
  static DeviceInfo table[MAX_DEVICES];
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  if (*dev < 0 || *dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceInfo& d = table[*dev];
  if (d.sms == 0) {
    e = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, *dev);
    if (e != cudaSuccess) return (int)e;
  }
  *info = &d;
  return 0;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

constexpr int FLAT_CK = 8;  // input channels a step, small shape

// How a conv of these sizes is launched.  shape 1: large images, 2: small.
// tile_rows and ppb: the large shape's image rows and phases a tile; ntx,
// nty, nz: its tiles along columns, rows and images x phase groups.
struct ConvPlan {
  int shape, cg, rg, nsplit, pr, S, csteps, cluster, tile_rows, ppb, ntx, nty, nz;
  dim3 grid, block;
  size_t smem;  // bytes
};

#ifdef MG_CONV_SWEEP
// Only in the plan sweep's own build (scripts/torch_conv_sweep.py compiles
// with -DMG_CONV_SWEEP): mg_conv_force sets a shape (1 or 2; 0 lets the
// sizes choose) and the small shape's pixels a lane and cluster split (0:
// by the sizes) for every later launch.
struct ConvForce {
  int shape = 0, pr = 0, S = 0;
};
inline ConvForce& conv_force() {
  static ConvForce f;
  return f;
}
#endif

inline int plan_conv(int K, int B, int cin, int cout, int H, int W, int nphase,
                     int pixel_norm, const DeviceInfo& info, ConvPlan* p) {
  if (B < 1 || cin < 1 || cout < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int KK = K * K;
  const int cgt = ceil_div(cout, CO);        // channel groups in all
  const int nsplit = ceil_div(cgt, MAX_CG);  // blocks a tile, 1 up to 128 channels
  const int cg = ceil_div(cgt, nsplit);      // channel groups per block
  const int rg = MAX_CG / cg;                // at most 256 threads a block
  if (pixel_norm && nsplit > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  p->nsplit = nsplit;
  p->cg = cg;

  // The small shape.  Pixels a lane: the fewest that make the tile at least
  // one image row wide (the staged input is the tile and W + 1 pixels each
  // side, so a narrower tile stages mostly halo), and no larger a tile than
  // the batch's pixels.  Then the cluster's split over input channels: as
  // large as the portable cluster and the steps allow, while the grid stays
  // within three blocks an SM and, past one block an SM, each block keeps
  // at least 3 steps (fewer leave its fixed costs uncovered).  Fitted on an
  // H100 to the critic's and generator's shapes up to 64x64 and
  // synthesis's first blocks, each timed under every (pixels a lane, split)
  // pair and the large shape (scripts/torch_conv_sweep.py, PERF.md).
  const long N = (long)B * H * W;
  int rgs = rg;
  while (rgs > 1 && 32L * (rgs / 2) >= N) rgs /= 2;
  int pr = 1;
  while (pr < 4 && 32 * pr * rgs < W && 32L * 2 * pr * rgs <= ((N + 31) / 32) * 32) pr *= 2;
  auto blocks = [&](int pr_, int S_) {
    return (long)ceil_div((int)std::min<long>(N, 1L << 30), 32 * pr_ * rgs) * nsplit * nphase * S_;
  };
  const int total_steps = ceil_div(cin, FLAT_CK);
  int S = 1;
  const int per_cluster = pixel_norm ? nsplit : 1;  // channel splits a cluster holds
  while (2 * S * per_cluster <= MAX_CLUSTER && 2 * S <= total_steps &&
         blocks(pr, 2 * S) <= 3L * info.sms &&
         (ceil_div(total_steps, 2 * S) >= 3 || blocks(pr, 2 * S) <= info.sms))
    S *= 2;
#ifdef MG_CONV_SWEEP
  if (conv_force().pr > 0) pr = conv_force().pr;
  if (conv_force().S > 0) S = conv_force().S;
  if (S * per_cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
#endif
  const int NP = 32 * pr * rgs, COP = cg * CO;
  const size_t L = (size_t)NP + 2 * W + 3;
  const size_t buf = (size_t)FLAT_CK * KK * COP + ((FLAT_CK * L + 3) & ~(size_t)3);
  const size_t flat_floats = std::max(2 * buf, (size_t)COP * NP + 2 * NP);
  const bool flat_fits = flat_floats * sizeof(float) <= (size_t)info.smem_optin;

  // The large shape once its tiles fill half the SMs (from 32x32 at the
  // train step's widths; scripts/torch_conv_sweep.py, PERF.md).
  const TcGeom tg = tc_geom(K, cg * CO);
  const long ntiles = (long)ceil_div(W, TC_W) * ceil_div(H, tg.th) * B * (nphase / tg.ppb);
  const long large_blocks = ntiles * nsplit;
  // Not below 32 columns, where a 64-column tile would be mostly halo.
  int shape = ((2 * large_blocks > info.sms && W >= 32) || !flat_fits) ? 1 : 2;
#ifdef MG_CONV_SWEEP
  const int fs = conv_force().shape;
  if (fs == 1 || (fs == 2 && flat_fits)) shape = fs;
#endif
  p->shape = shape;
  if (shape == 1) {
    p->rg = TC_WG;
    p->pr = tg.tiles;
    p->S = 1;
    p->csteps = ceil_div(cin, TC_CK);
    p->cluster = pixel_norm && nsplit > 1 ? nsplit : 1;
    p->tile_rows = tg.th;
    p->ppb = tg.ppb;
    p->ntx = ceil_div(W, TC_W);
    p->nty = ceil_div(H, tg.th);
    p->nz = B * (nphase / tg.ppb);
    if (ntiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
    p->smem = sizeof(float) * (size_t)tg.floats;
    // Persistent: one block an SM, each walking its share of the tiles.
    const long clusters = std::min<long>(ntiles, std::max(1, info.sms / nsplit));
    p->block = dim3(TC_THREADS);
    p->grid = dim3((unsigned)(clusters * nsplit));
    return 0;
  }
  p->tile_rows = 0;
  p->ppb = 1;
  p->ntx = p->nty = p->nz = 0;
  p->rg = rgs;
  p->pr = pr;
  p->S = S;
  p->csteps = ceil_div(total_steps, S);
  p->cluster = S * per_cluster;
  p->block = dim3(32 * cg * rgs);
  const long tiles = ceil_div((int)N, NP);
  if (N > (1L << 30) || tiles * nsplit * S > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  p->grid = dim3((unsigned)(tiles * nsplit * S), nphase, 1);
  p->smem = flat_floats * sizeof(float);
  return 0;
}

template <auto kernel, typename... Args>
int launch(const ConvPlan& p, int dev, const DeviceInfo& info, cudaStream_t stream,
           Args... args) {
  // Above 48 KB a kernel gets dynamic shared memory by request only: once
  // for this kernel on this device.
  static bool opted_in[MAX_DEVICES] = {};
  if (p.smem > (size_t)info.smem_optin) return (int)cudaErrorInvalidValue;
  if (p.smem > 48 * 1024 && !opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, info.smem_optin);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = p.grid;
  cfg.blockDim = p.block;
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  // A cluster only where blocks share shared memory: a launch without the
  // attribute is an ordinary one.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// O: y's type, float32 or bf16 (K1 and K3 with a bf16 output: x float32,
// the same plan and sums, the store rounded once).
template <typename E, typename O, int K>
int launch_conv_tile(const E* x, const E* w, const float* bias, O* y,
                     float* msq, int B, int cin, int cout, int H, int W, int nphase,
                     float slope, int use_slope, int pixel_norm, float eps,
                     cudaStream_t stream) {
  if (msq != nullptr && !(pixel_norm && nphase == 1)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const DeviceInfo* info = nullptr;
  int err = current_device(&dev, &info);
  if (err != 0) return err;
  ConvPlan p;
  err = plan_conv(K, B, cin, cout, H, W, nphase, pixel_norm, *info, &p);
  if (err != 0) return err;
  const int coutp = ceil_div(cout, CO) * CO;
  if (p.shape == 1) {
#define MG_TC(CG)                                                                            \
  case CG:                                                                                   \
    return launch<conv_tc_kernel<E, O, K, CG * CO>>(p, dev, *info, stream, x, w, bias, y, msq, \
                                                 cin, cout, coutp, H, W, nphase, p.nsplit, \
                                                 p.ntx, p.nty, p.nz, slope, use_slope,     \
                                                 pixel_norm, eps)
    switch (p.cg) {
      MG_TC(1); MG_TC(2); MG_TC(3); MG_TC(4); MG_TC(5); MG_TC(6); MG_TC(7); MG_TC(8);
      default: return (int)cudaErrorInvalidValue;
    }
#undef MG_TC
  }
  const int N = B * H * W;
#define MG_FLAT(PR)                                                                         \
  launch<conv_flat_kernel<E, O, K, PR, FLAT_CK>>(p, dev, *info, stream, x, w, bias, y, msq, \
         cin, cout, coutp, H, W, N, p.rg, nphase, p.nsplit, p.S, p.csteps, slope,      \
         use_slope, pixel_norm, eps)
  switch (p.pr) {
    case 1: return MG_FLAT(1);
    case 2: return MG_FLAT(2);
    case 4: return MG_FLAT(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MG_FLAT
}

// The plan the launcher takes for these sizes on the current device, for
// measurement and tests: out = {shape, cluster blocks, S, nsplit, pixels a
// lane (large shape: accumulator tiles a warpgroup), threads, blocks,
// shared-memory bytes, tile rows (large shape), phases a block (large
// shape)}.  Returns a CUDA error code.  Each source exports it
// (mg_conv_plan) for its own element type.
template <typename E>
int conv_plan_out(int K, int B, int cin, int cout, int H, int W, int nphase, int pixel_norm, int* out) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  int err = current_device(&dev, &info);
  if (err != 0) return err;
  ConvPlan p;
  err = plan_conv(K, B, cin, cout, H, W, nphase, pixel_norm, *info, &p);
  if (err != 0) return err;
  const int v[10] = {p.shape, p.cluster, p.S, p.nsplit, p.pr, (int)p.block.x,
                     (int)(p.grid.x * p.grid.y * p.grid.z), (int)p.smem, p.tile_rows, p.ppb};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

}  // namespace mg

#ifdef MG_CONV_SWEEP
extern "C" void mg_conv_force(int shape, int pr, int S) {
  mg::conv_force() = mg::ConvForce{shape, pr, S};
}
#endif
