// K1 with float32 x and a bf16 output: the fused 3x3 'SAME' conv + bias +
// LeakyReLU + PixelNorm computed as K1 in float32 (conv_tile.cuh's
// template at K = 3, the same plan and sums) and rounded to bf16 once, to
// nearest even, at the store.  Replaces musicgan_tpu/ops/conv.py::
// fused_conv3x3 (Pallas kernel _kernel) called with float32 x and
// out_dtype=bfloat16: the JAX kernel computes in x's dtype and casts only
// at its store.  What bounds it is K1's (conv3x3.cu), with half the output
// bytes.  Its own source: its instances (output type bf16) build beside
// conv3x3.cu's.
#include "conv_tile.cuh"

// x: (B, cin, H, W) float32; w: (cin, 9, coutp) float32 from
// kernel_weights; bias: (cout,) float32 or null; y: (B, cout, H, W) bf16.
extern "C" int mg_conv3x3_f32_bf16(const float* x, const float* w, const float* bias, mg::bf16* y, int B,
                                   int cin, int cout, int H, int W, float slope, int use_slope,
                                   int pixel_norm, float eps, cudaStream_t stream) {
  return mg::launch_conv_tile<float, mg::bf16, 3>(x, w, bias, y, nullptr, B, cin, cout, H, W, 1, slope,
                                                  use_slope, pixel_norm, eps, stream);
}
