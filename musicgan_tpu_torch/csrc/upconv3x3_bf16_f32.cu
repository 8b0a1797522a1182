// K3 with bf16 x and a float32 output: conv3x3(upsample_nearest_2x(x)) as
// four sub-pixel phase convolutions + bias + LeakyReLU + PixelNorm as K3
// bf16 computes it (conv_bf16.cuh at K = 2: the bf16 phase kernels, exact
// products summed in float32, the float32 epilogue), stored unrounded in
// float32, both column phases of a row interleaved.  Replaces
// musicgan_tpu/ops/conv.py::fused_upconv3x3 (Pallas kernel
// _upconv_kernel) called with bf16 x and out_dtype=float32.  The same plan
// as K3 bf16, so its output rounded to bf16 is K3 bf16's bit for bit.
// What bounds it is K3 bf16's, with twice the output bytes.
#include "conv_bf16.cuh"

// x: (B, cin, H, W) bf16; w: ops/conv_bf16.py::tc_weights (K3 bf16's
// pack); y: (B, cout, 2H, 2W) float32; route, tc as mg_upconv3x3_bf16's.
extern "C" int mg_upconv3x3_bf16_f32(const mg::bf16* x, const mg::bf16* w, const float* bias, float* y, int B,
                                     int cin, int cout, int H, int W, float slope, int use_slope, int pixel_norm,
                                     float eps, int route, int tc, cudaStream_t stream) {
  return mg::cb::launch_conv_bf16<2, float>(x, w, bias, y, nullptr, B, cin, cout, H, W, slope, use_slope,
                                            pixel_norm, eps, route, tc, stream);
}
