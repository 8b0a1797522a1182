// K4 in float32: one whole generator block in one launch (block3x3.cuh at
// E = float; 3xTF32 on the tensor cores).  Replaces
// musicgan_tpu/ops/conv.py::fused_block (Pallas kernel _block_kernel).
// With a bf16 output: block3x3_f32_bf16.cu.
#include "block3x3.cuh"

// The geometry at these widths (block3x3.cuh::block_tile_out).
extern "C" int mg_block3x3_tile(int cmid, int cout, int* out) {
  return mg::block_tile_out<float>(cmid, cout, out);
}

// The plan at these sizes on the current device (block3x3.cuh::block_plan_out).
extern "C" int mg_block3x3_plan(int B, int cin, int cmid, int cout, int H, int W, long long* out) {
  return mg::block_plan_out<float>(B, cin, cmid, cout, H, W, out);
}

// Words of the workspace mg_block3x3 needs (0: widths it does not take).
extern "C" long long mg_block3x3_workspace(int cin, int cmid, int cout) {
  return mg::block_workspace<float>(cin, cmid, cout);
}

// x: (B, cin, H, W); w1: (cin, 9, cmidp); b1: (cmid,); w2: (4, cmid, 4,
// coutp); b2: (cout,); ws: mg_block3x3_workspace words; y: (B, cout, 2H, 2W).
extern "C" int mg_block3x3(const float* x, const float* w1, const float* b1, const float* w2,
                           const float* b2, float* ws, float* y, int B, int cin, int cmid,
                           int cout, int H, int W, float slope, float eps, cudaStream_t stream) {
  return mg::block_launch<float, float>(x, w1, b1, w2, b2, ws, y, B, cin, cmid, cout, H, W, slope, eps, stream);
}
