// K1: fused 3x3 'SAME' conv + bias + LeakyReLU + PixelNorm, float32.
// Replaces musicgan_tpu/ops/conv.py::fused_conv3x3 (Pallas kernel _kernel).
// K2: the same with PixelNorm on, also writing the pre-norm mean_c(u^2) map
// that the backward pass needs.  Replaces
// musicgan_tpu/ops/conv.py::fused_conv3x3_msq (_kernel with emit_msq).
// The kernel of both is conv_tile.cuh's template at K = 3: conv_tc_kernel
// (large images, 3xTF32 on the tensor cores) or conv_flat_kernel (small).
// With float32 x and a bf16 output: conv3x3_f32_bf16.cu.
#include "conv_tile.cuh"

// x: (B, cin, H, W); w: (cin, 9, coutp) from kernel_weights; bias: (cout,)
// or null; y: (B, cout, H, W).
extern "C" int mg_conv3x3(const float* x, const float* w, const float* bias,
                          float* y, int B, int cin, int cout, int H, int W,
                          float slope, int use_slope, int pixel_norm, float eps,
                          cudaStream_t stream) {
  return mg::launch_conv_tile<float, float, 3>(x, w, bias, y, nullptr, B, cin, cout, H, W, 1,
                                        slope, use_slope, pixel_norm, eps, stream);
}

// As mg_conv3x3 with PixelNorm; msq: (B, 1, H, W), the mean over channels of
// the squared post-LeakyReLU activation, before "+ eps" and the scale.
extern "C" int mg_conv3x3_msq(const float* x, const float* w, const float* bias,
                              float* y, float* msq, int B, int cin, int cout,
                              int H, int W, float slope, int use_slope, float eps,
                              cudaStream_t stream) {
  if (msq == nullptr) return (int)cudaErrorInvalidValue;
  return mg::launch_conv_tile<float, float, 3>(x, w, bias, y, msq, B, cin, cout, H, W, 1,
                                        slope, use_slope, 1, eps, stream);
}

// The launch plan at these sizes (conv_tile.cuh::conv_plan_out).
extern "C" int mg_conv_plan(int K, int B, int cin, int cout, int H, int W, int nphase,
                            int pixel_norm, int* out) {
  return mg::conv_plan_out<float>(K, B, cin, cout, H, W, nphase, pixel_norm, out);
}
