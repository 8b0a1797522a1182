// K4 in bf16: one whole generator block in one launch with bf16 activations
// and weights, c1 held in bf16 and a bf16 output (float32 bias,
// accumulation and epilogues).  Replaces musicgan_tpu/ops/conv.py::
// fused_block (Pallas kernel _block_kernel, its c1 scratch of x.dtype and its
// packed-pair interleave) called with bf16 x and out_dtype=bfloat16.  It
// gives K1 bf16 then K3 bf16's bits.  With out_dtype=float32 the same
// kernels store float32: block3x3_bf16_f32.cu, block3x3_bf16_wide_f32.cu.
//
// cmid and cout up to 128 (ops/conv_bf16.py::block_route): block_bf16.cuh,
// the kernel designed for Hopper in bf16 (bf16 wgmma from shared memory,
// TMA input, c1 held in conv2's operand layout).  Wider blocks take the
// same kernel over a cluster (block3x3_bf16_wide.cu), or where that does
// not fit block3x3.cuh at bf16 (block3x3_bf16_template.cu).
#include "block_bf16.cuh"

namespace {
bool kb_route(int cmid, int cout) { return cmid <= mg::kb::MAX_N && cout <= mg::kb::MAX_N; }
}  // namespace

// The widths' geometry: out = {N1, N2, m64 blocks a row tile, conv1's
// kernel rows and conv2's fresh sums in flight, conv2's phases a pass,
// warpgroups a block at most, widest strip}.  Returns 0, or 1 for widths it
// does not take.
extern "C" int mg_block3x3_tile(int cmid, int cout, int* out) {
  if (cmid < 1 || cout < 1) return 1;
  if (kb_route(cmid, cout)) {
    const int n1 = 16 * mg::ceil_div(cmid, 16), n2 = 16 * mg::ceil_div(cout, 16);
    const int mb = mg::kb::kb_mb(n1, n2);
    const int v[8] = {n1,
                      n2,
                      mb,
                      mg::kb::kb_dy1(n1, n2),
                      mg::kb::kb_f2(n1, n2),
                      mg::kb::kb_pp2(n1, n2),
                      mg::kb::kb_wgmax(n1, n2),
                      std::min(mg::kb::MAX_TC, 64 * mb - 16)};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 0;
  }
  return 1;
}

// The plan at these sizes on the current device (block_bf16.cuh::plan_out).
extern "C" int mg_block3x3_plan(int B, int cin, int cmid, int cout, int H, int W, int tc, int run,
                                long long* out) {
  if (!kb_route(cmid, cout)) return (int)cudaErrorInvalidValue;
  return mg::kb::plan_out(B, cin, cmid, cout, H, W, tc, run, out);
}

// Words of the workspace mg_block3x3_bf16 needs: none (the packs it reads
// are made ahead), or -1 for widths it does not take.
extern "C" long long mg_block3x3_workspace(int cin, int cmid, int cout) {
  return cin >= 1 && cmid >= 1 && cout >= 1 && kb_route(cmid, cout) ? 0 : -1;
}

// x: (B, cin, H, W) bf16; w1, w2: the packs of K1 bf16 and K3 bf16
// (ops/conv_bf16.py::tc_weights); b1: (cmid,), b2: (cout,) float32; ws:
// unused (mg_block3x3_workspace); y: (B, cout, 2H, 2W) bf16; tc and run 0
// for the size rule's (a forced strip width and run length for
// measurements and tests).
extern "C" int mg_block3x3_bf16(const mg::bf16* x, const mg::bf16* w1, const float* b1,
                                const mg::bf16* w2, const float* b2, float* /* ws */, mg::bf16* y, int B,
                                int cin, int cmid, int cout, int H, int W, float slope, float eps, int tc,
                                int run, cudaStream_t stream) {
  if (!kb_route(cmid, cout)) return (int)cudaErrorInvalidValue;
  return mg::kb::launch_block_bf16<mg::bf16, false>(x, w1, b1, w2, b2, y, B, cin, cmid, cout, H, W, slope, eps,
                                                    tc, run, stream);
}
