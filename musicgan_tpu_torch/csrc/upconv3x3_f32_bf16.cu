// K3 with float32 x and a bf16 output: conv3x3(upsample_nearest_2x(x)) as
// four sub-pixel phase convolutions + bias + LeakyReLU + PixelNorm,
// computed as K3 in float32 (conv_tile.cuh's template at K = 2, the same
// plan and sums) and rounded to bf16 once, to nearest even, at the store.
// Replaces musicgan_tpu/ops/conv.py::fused_upconv3x3 (Pallas kernel
// _upconv_kernel) called with float32 x and out_dtype=bfloat16.  What
// bounds it is K3's (upconv3x3.cu), with half the output bytes.  Its own
// source: its instances build beside upconv3x3.cu's.
#include "conv_tile.cuh"

// x: (B, cin, H, W) float32; w: (4, cin, 4, coutp) float32 from
// kernel_upconv_weights; y: (B, cout, 2H, 2W) bf16.
extern "C" int mg_upconv3x3_f32_bf16(const float* x, const float* w, const float* bias, mg::bf16* y, int B,
                                     int cin, int cout, int H, int W, float slope, int use_slope,
                                     int pixel_norm, float eps, cudaStream_t stream) {
  return mg::launch_conv_tile<float, mg::bf16, 2>(x, w, bias, y, nullptr, B, cin, cout, H, W, 4, slope,
                                                  use_slope, pixel_norm, eps, stream);
}
