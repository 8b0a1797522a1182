// K1 in bf16: the fused 3x3 'SAME' conv + bias + LeakyReLU + PixelNorm with
// bf16 activations and weights and a bf16 output (float32 bias, accumulation
// and epilogue).  Replaces musicgan_tpu/ops/conv.py::fused_conv3x3 (Pallas
// kernel _kernel) called with bf16 x and out_dtype=bfloat16, the JAX
// package's "pallas_bf16" / "pallas_up_bf16" / "pallas_block_bf16" path.
// conv_tile.cuh's template at E = bf16, K = 3: conv_tc_kernel (large images,
// one bf16 wgmma m64nNk16 a step on the tensor cores) or conv_flat_kernel
// (small, float32 FMAs on the CUDA cores).  Half of float32 K1's bytes, so
// at the synthesis shapes what bounds it is its bytes.
#include "conv_tile.cuh"

// x: (B, cin, H, W) bf16; w: (cin, 9, coutp) bf16 from kernel_weights;
// bias: (cout,) float32 or null; y: (B, cout, H, W) bf16.
extern "C" int mg_conv3x3_bf16(const mg::bf16* x, const mg::bf16* w, const float* bias,
                               mg::bf16* y, int B, int cin, int cout, int H, int W,
                               float slope, int use_slope, int pixel_norm, float eps,
                               cudaStream_t stream) {
  return mg::launch_conv_tile<mg::bf16, 3>(x, w, bias, y, nullptr, B, cin, cout, H, W, 1,
                                           slope, use_slope, pixel_norm, eps, stream);
}

// The launch plan at these sizes (conv_tile.cuh::conv_plan_out).
extern "C" int mg_conv_plan(int K, int B, int cin, int cout, int H, int W, int nphase,
                            int pixel_norm, int* out) {
  return mg::conv_plan_out<mg::bf16>(K, B, cin, cout, H, W, nphase, pixel_norm, out);
}
