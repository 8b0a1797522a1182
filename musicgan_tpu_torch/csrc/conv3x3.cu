// K1: fused 3x3 'SAME' conv + bias + LeakyReLU + PixelNorm, float32.
// Replaces musicgan_tpu/ops/conv.py::fused_conv3x3 (Pallas kernel _kernel).
// The kernel body is conv_tile_kernel<3> in conv_tile.cuh.
#include "conv_tile.cuh"

// x: (B, cin, H, W); w: (cout, 9*cin) from pack_weights; y: (B, cout, H, W).
extern "C" int mg_conv3x3(const float* x, const float* w, const float* bias,
                          float* y, int B, int cin, int cout, int H, int W,
                          float slope, int use_slope, int pixel_norm, float eps,
                          cudaStream_t stream) {
  return mg::launch_conv_tile<3>(x, w, bias, y, B, cin, cout, H, W, 1, slope,
                                 use_slope, pixel_norm, eps, stream);
}
