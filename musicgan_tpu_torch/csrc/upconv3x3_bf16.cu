// K3 in bf16: conv3x3(upsample_nearest_2x(x)) as four sub-pixel phase
// convolutions with 2x2 kernels, + bias + LeakyReLU + PixelNorm, with bf16
// activations, bf16 phase kernels (summed in float32, then rounded, as the
// JAX package packs them) and a bf16 output.  Replaces
// musicgan_tpu/ops/conv.py::fused_upconv3x3 (Pallas kernel _upconv_kernel,
// whose packed-pair interleave exists for its bf16 output) called with bf16
// x and out_dtype=bfloat16 (with out_dtype=float32: upconv3x3_bf16_f32.cu,
// the same kernel storing float32).  conv_bf16.cuh's kernel at K = 2: a tile's
// phases share its staged window, and both column phases of an output row
// leave interleaved in 16-byte stores.  At the largest output, (5, 16, 512,
// 5120), what bounds it is its bytes.
#include "conv_bf16.cuh"

// x: (B, cin, H, W) bf16; w: (nsplit, chunks, 16, 2, N, 8) bf16 from
// ops/conv_bf16.py::tc_weights (taps phase-major); y: (B, cout, 2H, 2W)
// bf16; route, tc as mg_conv3x3_bf16's.
extern "C" int mg_upconv3x3_bf16(const mg::bf16* x, const mg::bf16* w, const float* bias,
                                 mg::bf16* y, int B, int cin, int cout, int H, int W,
                                 float slope, int use_slope, int pixel_norm, float eps, int route,
                                 int tc, cudaStream_t stream) {
  return mg::cb::launch_conv_bf16<2, mg::bf16>(x, w, bias, y, nullptr, B, cin, cout, H, W, slope, use_slope, pixel_norm,
                                     eps, route, tc, stream);
}

// The launch plan at these sizes (conv_bf16.cuh::conv_bf16_plan_out).
extern "C" int mg_conv_bf16_plan(int K, int B, int cin, int cout, int H, int W, int pixel_norm,
                                 int route, int tc, int* out) {
  return mg::cb::conv_bf16_plan_out(K, B, cin, cout, H, W, pixel_norm, route, tc, out);
}
