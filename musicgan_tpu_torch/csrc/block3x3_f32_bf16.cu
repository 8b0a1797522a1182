// K4 with float32 x and a bf16 output: one whole generator block in one
// launch, block3x3.cuh at E = float (3xTF32 on the tensor cores, c1 held in
// float32, clusters past 128 channels), the output rounded to bf16 once, to
// nearest even, at the store.  Replaces musicgan_tpu/ops/conv.py::
// fused_block (Pallas kernel _block_kernel) called with float32 x and
// out_dtype=bfloat16: the JAX kernel's c1 scratch is x's dtype and it casts
// only at its store.  It gives K4's (block3x3.cu) float32 result rounded,
// bit for bit, as it takes the same plan and sums.  What bounds it is K4's,
// with half the output bytes.  Its own source, so that its 36 instances
// build beside block3x3.cu's.
#include "block3x3.cuh"

// x: (B, cin, H, W) float32; w1: (cin, 9, cmidp); b1: (cmid,); w2: (4,
// cmid, 4, coutp) float32; b2: (cout,); ws: block3x3.cu's
// mg_block3x3_workspace words; y: (B, cout, 2H, 2W) bf16.
extern "C" int mg_block3x3_f32_bf16(const float* x, const float* w1, const float* b1, const float* w2,
                                    const float* b2, float* ws, mg::bf16* y, int B, int cin, int cmid,
                                    int cout, int H, int W, float slope, float eps, cudaStream_t stream) {
  return mg::block_launch<float, mg::bf16>(x, w1, b1, w2, b2, ws, y, B, cin, cmid, cout, H, W, slope, eps,
                                           stream);
}
