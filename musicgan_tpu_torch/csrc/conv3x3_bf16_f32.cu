// K1 with bf16 x and a float32 output, and K2 with bf16 x: the fused 3x3
// 'SAME' conv + bias + LeakyReLU + PixelNorm as K1 bf16 computes it
// (conv_bf16.cuh at K = 3: bf16 wgmma m64nNk16, exact products summed in
// float32, the float32 epilogue), stored unrounded in float32; K2 also
// writes the pre-norm mean_c(u^2) map from the PixelNorm sums (past 128
// channels those after the cluster's exchange).  Replace
// musicgan_tpu/ops/conv.py::fused_conv3x3 (Pallas kernel _kernel) called
// with bf16 x and out_dtype=float32, and ::fused_conv3x3_msq (_kernel with
// emit_msq) called with bf16 x, whose outputs are float32.  The same plan
// as K1 bf16, so its output rounded to bf16 is K1 bf16's bit for bit.  What
// bounds it is K1 bf16's, with twice the output bytes.
#include "conv_bf16.cuh"

// x: (B, cin, H, W) bf16; w: ops/conv_bf16.py::tc_weights (K1 bf16's
// pack); bias: (cout,) float32 or null; y: (B, cout, H, W) float32; route,
// tc as mg_conv3x3_bf16's.
extern "C" int mg_conv3x3_bf16_f32(const mg::bf16* x, const mg::bf16* w, const float* bias, float* y, int B,
                                   int cin, int cout, int H, int W, float slope, int use_slope, int pixel_norm,
                                   float eps, int route, int tc, cudaStream_t stream) {
  return mg::cb::launch_conv_bf16<3, float>(x, w, bias, y, nullptr, B, cin, cout, H, W, slope, use_slope,
                                            pixel_norm, eps, route, tc, stream);
}

// K2 with bf16 x: as mg_conv3x3_bf16_f32 with PixelNorm; msq: (B, 1, H, W)
// float32, the mean over channels of the squared post-LeakyReLU
// activation, before "+ eps" and the scale.
extern "C" int mg_conv3x3_msq_bf16(const mg::bf16* x, const mg::bf16* w, const float* bias, float* y,
                                   float* msq, int B, int cin, int cout, int H, int W, float slope,
                                   int use_slope, float eps, cudaStream_t stream) {
  if (msq == nullptr) return (int)cudaErrorInvalidValue;
  return mg::cb::launch_conv_bf16<3, float>(x, w, bias, y, msq, B, cin, cout, H, W, slope, use_slope, 1, eps,
                                            0, 0, stream);
}
