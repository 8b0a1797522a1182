// K4 with bf16 x and a float32 output past 128 channels (either conv) where
// the cluster route does not fit (block3x3_bf16_template.cu's widths):
// block3x3.cuh at E = bf16 (block3x3_bf16_template.cu's kernel: one bf16 wgmma
// m64nNk16 a step, c1 held in bf16, a cluster whose PixelNorm sums meet in
// rank order), its float32 epilogue stored unrounded.  Replaces
// musicgan_tpu/ops/conv.py::fused_block (Pallas kernel _block_kernel)
// called with bf16 x and out_dtype=float32 at those widths: the bf16
// products are exact, summed in float32, c1 rounded to bf16 as the JAX
// kernel's x.dtype scratch holds it.  ops/conv_bf16.py::block_route sends
// those widths here (block3x3_bf16_f32.cu up to 128 channels,
// block3x3_bf16_wide_f32.cu past them where it fits).  Its own
// source, so that its 36 instances build beside the others.
#include "block3x3.cuh"

// x: (B, cin, H, W) bf16; w1: (cin, 9, cmidp) bf16; b1: (cmid,) float32;
// w2: (4, cmid, 4, coutp) bf16; b2: (cout,) float32; ws:
// block3x3_bf16_template.cu's mg_block3x3_workspace words; y: (B, cout, 2H,
// 2W) float32.
extern "C" int mg_block3x3_bf16_template_f32(const mg::bf16* x, const mg::bf16* w1, const float* b1,
                                             const mg::bf16* w2, const float* b2, float* ws, float* y, int B,
                                             int cin, int cmid, int cout, int H, int W, float slope,
                                             float eps, cudaStream_t stream) {
  return mg::block_launch<mg::bf16, float>(x, w1, b1, w2, b2, ws, y, B, cin, cmid, cout, H, W, slope, eps,
                                           stream);
}
