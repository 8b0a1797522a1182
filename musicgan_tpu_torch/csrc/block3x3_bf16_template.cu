// K4 in bf16 past 128 channels where the cluster route's layout does not
// fit (block_bf16.cuh::kb_cluster_fits: every rank holds three transposed
// rows of every input chunk; every input up to 608 channels fits, wider
// ones at some widths of c1 and the output): block3x3.cuh at E = bf16, the float32 template's
// tensor-core pieces with c1 held in bf16, one bf16 wgmma m64nNk16 a step,
// each conv split over a cluster of blocks whose PixelNorm sums meet in
// rank order.  Replaces musicgan_tpu/ops/conv.py::fused_block (Pallas
// kernel _block_kernel) called with bf16 x and out_dtype=bfloat16 at those
// widths; ops/conv_bf16.py::block_route sends them here by the widths
// alone (block3x3_bf16.cu up to 128 channels, block3x3_bf16_wide.cu past
// them where it fits).  It gives K1 bf16 then K3 bf16's bits where K1 and
// K3 take the float32 tensor-core route's shape.  Its own source, so that
// it builds beside the others.  With out_dtype=float32:
// block3x3_bf16_template_f32.cu.
#include "block3x3.cuh"

// The geometry at these widths (block3x3.cuh::block_tile_out).
extern "C" int mg_block3x3_tile(int cmid, int cout, int* out) {
  return mg::block_tile_out<mg::bf16>(cmid, cout, out);
}

// The plan at these sizes on the current device (block3x3.cuh::block_plan_out).
extern "C" int mg_block3x3_plan(int B, int cin, int cmid, int cout, int H, int W, long long* out) {
  return mg::block_plan_out<mg::bf16>(B, cin, cmid, cout, H, W, out);
}

// Words of the workspace mg_block3x3_bf16_template needs (0: widths it does not take).
extern "C" long long mg_block3x3_workspace(int cin, int cmid, int cout) {
  return mg::block_workspace<mg::bf16>(cin, cmid, cout);
}

// x: (B, cin, H, W) bf16; w1: (cin, 9, cmidp) bf16; b1: (cmid,) float32;
// w2: (4, cmid, 4, coutp) bf16; b2: (cout,) float32; ws:
// mg_block3x3_workspace words; y: (B, cout, 2H, 2W) bf16.  (Named apart from
// block3x3_bf16.cu's entry, whose arguments differ.)
extern "C" int mg_block3x3_bf16_template(const mg::bf16* x, const mg::bf16* w1, const float* b1,
                                         const mg::bf16* w2, const float* b2, float* ws, mg::bf16* y, int B,
                                         int cin, int cmid, int cout, int H, int W, float slope, float eps,
                                         cudaStream_t stream) {
  return mg::block_launch<mg::bf16, mg::bf16>(x, w1, b1, w2, b2, ws, y, B, cin, cmid, cout, H, W, slope, eps, stream);
}
