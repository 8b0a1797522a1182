// K4 in bf16 past 128 channels (either conv): block_bf16.cuh's kernel over
// a thread-block cluster (block_bf16_kernel<N1, N2, O, true>), split as K1
// bf16 and K3 bf16 split their channels: each rank computes its slice of c1
// into its own ring and its slice of the outputs, conv2 reads the peers'
// c1 chunks through distributed shared memory, PixelNorm's sums meet in
// rank order.  Replaces musicgan_tpu/ops/conv.py::fused_block (Pallas
// kernel _block_kernel) called with bf16 x and out_dtype=bfloat16 at those
// widths; ops/conv_bf16.py::block_route sends them here by the widths alone
// where the layout fits (block_bf16.cuh::kb_cluster_fits; wider inputs take
// block3x3_bf16_template.cu).  It gives K1 bf16 then K3 bf16's bits.  With
// out_dtype=float32: block3x3_bf16_wide_f32.cu.  Its own source, so that
// its 48 instances build beside block3x3_bf16.cu's.
#include "block_bf16.cuh"

// The plan at these sizes on the current device (block_bf16.cuh::plan_out).
extern "C" int mg_block3x3_plan(int B, int cin, int cmid, int cout, int H, int W, int tc, int run,
                                long long* out) {
  if (!mg::kb::kb_cluster_fits(cin, cmid, cout)) return (int)cudaErrorInvalidValue;
  return mg::kb::plan_out(B, cin, cmid, cout, H, W, tc, run, out);
}

// Words of the workspace mg_block3x3_bf16_wide needs: none (the packs it
// reads are made ahead), or -1 for widths it does not take.
extern "C" long long mg_block3x3_workspace(int cin, int cmid, int cout) {
  return mg::kb::kb_cluster_fits(cin, cmid, cout) ? 0 : -1;
}

// x: (B, cin, H, W) bf16; w1, w2: the packs of K1 bf16 and K3 bf16
// (ops/conv_bf16.py::tc_weights, every split); b1: (cmid,), b2: (cout,)
// float32; ws: unused (mg_block3x3_workspace); y: (B, cout, 2H, 2W) bf16;
// tc and run 0 for the size rule's (forced for measurements and tests).
extern "C" int mg_block3x3_bf16_wide(const mg::bf16* x, const mg::bf16* w1, const float* b1,
                                     const mg::bf16* w2, const float* b2, float* /* ws */, mg::bf16* y, int B,
                                     int cin, int cmid, int cout, int H, int W, float slope, float eps, int tc,
                                     int run, cudaStream_t stream) {
  if (!mg::kb::kb_cluster_fits(cin, cmid, cout)) return (int)cudaErrorInvalidValue;
  return mg::kb::launch_block_bf16<mg::bf16, true>(x, w1, b1, w2, b2, y, B, cin, cmid, cout, H, W, slope, eps,
                                                   tc, run, stream);
}
