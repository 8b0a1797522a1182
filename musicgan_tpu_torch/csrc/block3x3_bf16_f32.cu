// K4 with bf16 x and a float32 output, cmid and cout up to 128:
// block_bf16.cuh's kernel (block3x3_bf16.cu's: bf16 wgmma from shared
// memory, TMA input, c1 held in bf16 in conv2's operand layout) with its
// last epilogue stored unrounded in float32.  Replaces musicgan_tpu/ops/
// conv.py::fused_block (Pallas kernel _block_kernel) called with bf16 x and
// out_dtype=float32: its c1 scratch is x's dtype (bf16) and it casts only at
// its store.  It gives K1 bf16 (bf16 out) then K3 bf16 with a float32 output
// bit for bit, and its output rounded to bf16 is K4 bf16's.  What bounds it
// is K4 bf16's, with twice the output bytes.  Wider blocks take
// block3x3_bf16_wide_f32.cu or block3x3_bf16_template_f32.cu
// (ops/conv_bf16.py::block_route).  Its own
// source, so that its 64 instances build beside block3x3_bf16.cu's.
#include "block_bf16.cuh"

// x: (B, cin, H, W) bf16; w1, w2: the packs of K1 bf16 and K3 bf16
// (ops/conv_bf16.py::tc_weights); b1: (cmid,), b2: (cout,) float32; ws:
// unused; y: (B, cout, 2H, 2W) float32; tc, run as mg_block3x3_bf16's.
extern "C" int mg_block3x3_bf16_f32(const mg::bf16* x, const mg::bf16* w1, const float* b1, const mg::bf16* w2,
                                    const float* b2, float* /* ws */, float* y, int B, int cin, int cmid,
                                    int cout, int H, int W, float slope, float eps, int tc, int run,
                                    cudaStream_t stream) {
  if (cmid > mg::kb::MAX_N || cout > mg::kb::MAX_N) return (int)cudaErrorInvalidValue;
  return mg::kb::launch_block_bf16<float, false>(x, w1, b1, w2, b2, y, B, cin, cmid, cout, H, W, slope, eps, tc,
                                                 run, stream);
}
