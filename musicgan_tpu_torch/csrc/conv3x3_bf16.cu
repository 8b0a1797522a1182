// K1 in bf16: the fused 3x3 'SAME' conv + bias + LeakyReLU + PixelNorm with
// bf16 activations and weights and a bf16 output (float32 bias, accumulation
// and epilogue).  Replaces musicgan_tpu/ops/conv.py::fused_conv3x3 (Pallas
// kernel _kernel) called with bf16 x and out_dtype=bfloat16, the JAX
// package's "pallas_bf16" / "pallas_up_bf16" / "pallas_block_bf16" path.
// With bf16 x and a float32 output (and K2 with bf16 x) the same kernel
// stores float32: conv3x3_bf16_f32.cu.
// conv_bf16.cuh's kernel at K = 3: bf16 wgmma m64nNk16 on the tensor cores
// at every size, both operands from shared memory.  What bounds it at the
// synthesis shapes is its bytes (conv_bf16.cuh says how the design keeps
// them few and wide).
#include "conv_bf16.cuh"

// x: (B, cin, H, W) bf16; w: (nsplit, chunks, 9, 2, N, 8) bf16 from
// ops/conv_bf16.py::tc_weights; bias: (cout,) float32 or null; y: (B, cout,
// H, W) bf16; route, tc: 0 for the size rule (a forced route and tile width
// for measurements and tests).
extern "C" int mg_conv3x3_bf16(const mg::bf16* x, const mg::bf16* w, const float* bias,
                               mg::bf16* y, int B, int cin, int cout, int H, int W,
                               float slope, int use_slope, int pixel_norm, float eps, int route,
                               int tc, cudaStream_t stream) {
  return mg::cb::launch_conv_bf16<3, mg::bf16>(x, w, bias, y, nullptr, B, cin, cout, H, W, slope, use_slope, pixel_norm,
                                     eps, route, tc, stream);
}

// The launch plan at these sizes (conv_bf16.cuh::conv_bf16_plan_out).
extern "C" int mg_conv_bf16_plan(int K, int B, int cin, int cout, int H, int W, int pixel_norm,
                                 int route, int tc, int* out) {
  return mg::cb::conv_bf16_plan_out(K, B, cin, cout, H, W, pixel_norm, route, tc, out);
}
