// K4 with bf16 x and a float32 output past 128 channels (either conv):
// block3x3_bf16_wide.cu's kernel (block_bf16.cuh over a cluster, c1 held in
// bf16) with its last epilogue stored unrounded in float32, leaving through
// the bf16 staging region in two halves of the channels.  Replaces
// musicgan_tpu/ops/conv.py::fused_block (Pallas kernel _block_kernel)
// called with bf16 x and out_dtype=float32 at those widths: its c1 scratch
// is x's dtype (bf16) and it casts only at its store.  It gives K1 bf16
// (bf16 out) then K3 bf16 with a float32 output bit for bit, and its output
// rounded to bf16 is block3x3_bf16_wide.cu's.  Inputs too wide for the
// cluster's layout take block3x3_bf16_template_f32.cu.  Its own source, so
// that its 48 instances build beside the others.
#include "block_bf16.cuh"

// x: (B, cin, H, W) bf16; w1, w2: the packs of K1 bf16 and K3 bf16
// (ops/conv_bf16.py::tc_weights, every split); b1: (cmid,), b2: (cout,)
// float32; ws: unused; y: (B, cout, 2H, 2W) float32; tc, run as
// mg_block3x3_bf16_wide's.
extern "C" int mg_block3x3_bf16_wide_f32(const mg::bf16* x, const mg::bf16* w1, const float* b1,
                                         const mg::bf16* w2, const float* b2, float* /* ws */, float* y, int B,
                                         int cin, int cmid, int cout, int H, int W, float slope, float eps,
                                         int tc, int run, cudaStream_t stream) {
  if (!mg::kb::kb_cluster_fits(cin, cmid, cout)) return (int)cudaErrorInvalidValue;
  return mg::kb::launch_block_bf16<float, true>(x, w1, b1, w2, b2, y, B, cin, cmid, cout, H, W, slope, eps, tc,
                                                run, stream);
}
