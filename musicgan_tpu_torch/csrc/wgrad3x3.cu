// The weight gradient of a 3x3 'SAME' convolution, float32 on the CUDA
// cores, summed in a fixed order:
//   dw[o, i, ky, kx] = sum_{b, y, x} d[b, o, y, x] * x[b, i, y + ky - 1, x + kx - 1]
// (zero outside the image).  It replaces the library call the trainable conv
// made (torch.nn.grad.conv2d_weight; on the TPU, XLA's transposed conv in
// musicgan_tpu/ops/conv_vjp.py): cuDNN's default algorithms sum a pixel
// chunk's products with atomics in an order that changes from run to run,
// and its deterministic ones, on an H100, sum the 1.5 million pixels of a
// 512x512 batch of 6 into 16 channels 75 times further from float64 than
// the default (1.2e-4 against 1.7e-6, relative to the largest value).
//
// Two launches.  First, a block takes a chunk of up to 32 steps, each 32
// pixels of one image row, and a tile of 32 output x 32 input channels: it stages
// a step (d as [o][pixel]; x as the three input rows it reads, [i][row][34
// columns], zero outside the image), and a thread sums 2 output x 2 input
// channels x 9 taps over the chunk's pixels in order, four pixels at a
// time from 16-byte reads.  It writes the chunk's partial sums.  Second,
// one thread an output weight adds the chunks' partials in chunk order.  So
// the result is the same bits run after run, whatever the scheduling.
//
// What bounds it on an H100: float32 operations, 2 * pixels * cin * cout
// * 9 FLOP (a third of a stage-7 iteration's weight gradients at 67
// TFLOP/s is about 1 ms); the partials are a few tens of MB.
#include "common.cuh"

namespace {

constexpr int WG_T = 32;          // output and input channels of a tile
constexpr int WG_P = 32;          // pixels of one image row a step
constexpr int WG_XW = WG_P + 4;   // a staged input row: columns x0 - 1 .. x0 + 32, padded
constexpr int WG_STEPS = 32;      // most steps a chunk (a block's share of the sum)
constexpr int WG_THREADS = 256;

// Block (chunk, tile): part[chunk][o][i][tap] for the tile's channels.  A
// step is 32 pixels of one image row (b, y, x0 ..), the steps of the batch
// ordered by (b, y, x0); chunk k takes steps spc*k .. spc*k + spc - 1.
__global__ void __launch_bounds__(WG_THREADS)
wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ d,
                     float* __restrict__ part, int cin, int cout, int H, int W, int nsteps,
                     int spc, int tiles_in) {
  __shared__ __align__(16) float d_s[WG_T][WG_XW];
  __shared__ __align__(16) float x_s[WG_T][3][WG_XW];
  const int chunk = blockIdx.x;
  const int o0 = (blockIdx.y / tiles_in) * WG_T, i0 = (blockIdx.y % tiles_in) * WG_T;
  const int HW = H * W, segs = (W + WG_P - 1) / WG_P;
  const int s0 = chunk * spc, s1 = min(nsteps, s0 + spc);
  const int tid = threadIdx.x, op = tid % 16, ip = tid / 16;  // channels 2*op .. and 2*ip ..
  float acc[2][2][9];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[c][i][t] = 0.f;

  for (int st = s0; st < s1; ++st) {
    const int x0 = (st % segs) * WG_P, row = st / segs, b = row / H, y = row - b * H;
    for (int e = tid; e < WG_T * WG_P; e += WG_THREADS) {
      const int p = e % WG_P, c = e / WG_P;
      const bool ok = o0 + c < cout && x0 + p < W;
      d_s[c][p] = ok ? d[((size_t)b * cout + o0 + c) * HW + (size_t)y * W + x0 + p] : 0.f;
    }
    for (int e = tid; e < WG_T * 3 * (WG_P + 2); e += WG_THREADS) {
      const int col = e % (WG_P + 2), rest = e / (WG_P + 2), ky = rest % 3, c = rest / 3;
      const int yy = y + ky - 1, xx = x0 - 1 + col;
      const bool ok = i0 + c < cin && yy >= 0 && yy < H && xx >= 0 && xx < W;
      x_s[c][ky][col] = ok ? x[((size_t)b * cin + i0 + c) * HW + (size_t)yy * W + xx] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int q = 0; q < WG_P; q += 4) {
      float4 dv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) dv[c] = *reinterpret_cast<const float4*>(&d_s[2 * op + c][q]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          // Pixels q .. q + 3 read columns q + kx .. q + kx + 3 of the row.
          const float4 a = *reinterpret_cast<const float4*>(&x_s[2 * ip + i][ky][q]);
          const float2 a2 = *reinterpret_cast<const float2*>(&x_s[2 * ip + i][ky][q + 4]);
          const float xr[6] = {a.x, a.y, a.z, a.w, a2.x, a2.y};
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float v = acc[c][i][ky * 3 + kx];
              v = fmaf(dv[c].x, xr[kx], v);
              v = fmaf(dv[c].y, xr[kx + 1], v);
              v = fmaf(dv[c].z, xr[kx + 2], v);
              v = fmaf(dv[c].w, xr[kx + 3], v);
              acc[c][i][ky * 3 + kx] = v;
            }
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = o0 + 2 * op + c, ii = i0 + 2 * ip + i;
      if (o >= cout || ii >= cin) continue;
      float* dst = part + (((size_t)chunk * cout + o) * cin + ii) * 9;
#pragma unroll
      for (int t = 0; t < 9; ++t) dst[t] = acc[c][i][t];
    }
}

// dw[e] = the chunks' partials of weight e, added in chunk order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                    int nchunks, int total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.f;
  for (int k = 0; k < nchunks; ++k) s += part[(size_t)k * total + e];
  dw[e] = s;
}

// Steps of 32 pixels of one image row in the batch.
long wgrad_steps(int B, int H, int W) {
  return (long)B * H * ((W + WG_P - 1) / WG_P);
}

// Steps a chunk: up to 32, fewer where the blocks (chunks x channel tiles)
// would not fill the card twice over (small images, whose few steps would
// run one after another in few blocks).  From the sizes and the SM count
// only, so the sum's grouping, and its bits, are the same run after run.
int wgrad_spc(long steps, int tiles, int* err) {
  static int sms[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev < 0 || dev >= 64)) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && sms[dev] == 0) e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  *err = (int)e;
  if (e != cudaSuccess) return 0;
  const long spc = steps * tiles / (2L * sms[dev]);
  return (int)(spc < 1 ? 1 : spc > WG_STEPS ? WG_STEPS : spc);
}

}  // namespace

// Chunks of the pixel sum at these sizes on the current device (0 for
// sizes the kernel does not take): the workspace holds chunks x cout x cin
// x 9 floats.
extern "C" int mg_wgrad3x3_chunks(int B, int cin, int cout, int H, int W) {
  const long steps = B < 1 || H < 1 || W < 1 ? 0 : wgrad_steps(B, H, W);
  if (steps < 1 || steps > 0x7fffffffL || cin < 1 || cout < 1) return 0;
  int err = 0;
  const int spc = wgrad_spc(steps, ((cin + WG_T - 1) / WG_T) * ((cout + WG_T - 1) / WG_T), &err);
  return err != 0 ? 0 : (int)((steps + spc - 1) / spc);
}

// x: (B, cin, H, W); d: (B, cout, H, W), the gradient at the conv's output
// (before its bias); part: the workspace (mg_wgrad3x3_chunks x cout x cin x
// 9 floats); dw: (cout, cin, 3, 3).
extern "C" int mg_wgrad3x3(const float* x, const float* d, float* part, float* dw, int B,
                           int cin, int cout, int H, int W, cudaStream_t stream) {
  const int nchunks = mg_wgrad3x3_chunks(B, cin, cout, H, W);
  if (nchunks < 1) return (int)cudaErrorInvalidValue;
  const int tiles_in = (cin + WG_T - 1) / WG_T, tiles_out = (cout + WG_T - 1) / WG_T;
  if ((long)tiles_in * tiles_out > 65535) return (int)cudaErrorInvalidValue;
  const long steps = wgrad_steps(B, H, W);
  int err = 0;
  const int spc = wgrad_spc(steps, tiles_in * tiles_out, &err);
  if (err != 0) return err;
  wgrad_partial_kernel<<<dim3(nchunks, tiles_in * tiles_out), WG_THREADS, 0, stream>>>(
      x, d, part, cin, cout, H, W, (int)steps, spc, tiles_in);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int total = cout * cin * 9;
  wgrad_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(part, dw, nchunks, total);
  return (int)cudaGetLastError();
}
