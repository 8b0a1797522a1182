// K3: conv3x3(upsample_nearest_2x(x)) as four sub-pixel phase convolutions
// with 2x2 kernels (K = 4*cin), + bias + LeakyReLU + PixelNorm, float32.
// Replaces musicgan_tpu/ops/conv.py::fused_upconv3x3 (Pallas kernel
// _upconv_kernel).  The kernel is conv_tile.cuh's template at K = 2:
// conv_tc_kernel (large images, 3xTF32 on the tensor cores, up to four
// phases a block) or conv_flat_kernel (small, the phase on blockIdx.y);
// phase results go straight to (2i+a, 2j+b), the interleave that Mosaic
// refused in float32.  With float32 x and a bf16 output:
// upconv3x3_f32_bf16.cu.
#include "conv_tile.cuh"

// x: (B, cin, H, W); w: (4, cin, 4, coutp) from kernel_upconv_weights;
// y: (B, cout, 2H, 2W).
extern "C" int mg_upconv3x3(const float* x, const float* w, const float* bias,
                            float* y, int B, int cin, int cout, int H, int W,
                            float slope, int use_slope, int pixel_norm, float eps,
                            cudaStream_t stream) {
  return mg::launch_conv_tile<float, float, 2>(x, w, bias, y, nullptr, B, cin, cout, H, W, 4,
                                        slope, use_slope, pixel_norm, eps, stream);
}

// The launch plan at these sizes (conv_tile.cuh::conv_plan_out).
extern "C" int mg_conv_plan(int K, int B, int cin, int cout, int H, int W, int nphase,
                            int pixel_norm, int* out) {
  return mg::conv_plan_out<float>(K, B, cin, cout, H, W, nphase, pixel_norm, out);
}
