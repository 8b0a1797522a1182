// K3 in bf16: conv3x3(upsample_nearest_2x(x)) as four sub-pixel phase
// convolutions with 2x2 kernels, + bias + LeakyReLU + PixelNorm, with bf16
// activations, bf16 phase kernels (summed in float32, then rounded, as the
// JAX package packs them) and a bf16 output.  Replaces
// musicgan_tpu/ops/conv.py::fused_upconv3x3 (Pallas kernel _upconv_kernel,
// whose packed-pair interleave exists for its bf16 output) called with bf16
// x and out_dtype=bfloat16.  conv_tile.cuh's template at E = bf16, K = 2;
// phase results go straight to (2i+a, 2j+b), a block holding both column
// phases storing them as bf16 pairs.  At the largest output, (5, 16, 512,
// 5120), what bounds it is its bytes.
#include "conv_tile.cuh"

// x: (B, cin, H, W) bf16; w: (4, cin, 4, coutp) bf16 from
// kernel_upconv_weights; y: (B, cout, 2H, 2W) bf16.
extern "C" int mg_upconv3x3_bf16(const mg::bf16* x, const mg::bf16* w, const float* bias,
                                 mg::bf16* y, int B, int cin, int cout, int H, int W,
                                 float slope, int use_slope, int pixel_norm, float eps,
                                 cudaStream_t stream) {
  return mg::launch_conv_tile<mg::bf16, 2>(x, w, bias, y, nullptr, B, cin, cout, H, W, 4,
                                           slope, use_slope, pixel_norm, eps, stream);
}

// The launch plan at these sizes (conv_tile.cuh::conv_plan_out).
extern "C" int mg_conv_plan(int K, int B, int cin, int cout, int H, int W, int nphase,
                            int pixel_norm, int* out) {
  return mg::conv_plan_out<mg::bf16>(K, B, cin, cout, H, W, nphase, pixel_norm, out);
}
