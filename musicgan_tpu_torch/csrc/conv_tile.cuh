// Direct 3x3 convolution with a fused bias / LeakyReLU / PixelNorm epilogue,
// float32 on the CUDA cores (FMA; no TF32, no tensor cores yet).
//
// One template serves three kernels:
//   K = 3: the 3x3 'SAME' conv, and the same also storing the pre-PixelNorm
//          mean-square map                         (conv3x3.cu,   K1, K2)
//   K = 2: one sub-pixel phase of conv3x3(up2x(x)) (upconv3x3.cu, K3)
// The up-conv's four phases ride blockIdx.z (nphase = 4): PixelNorm reduces
// over the channels of one output pixel, and each output pixel belongs to
// exactly one phase, so a block owns one phase of its tile and writes it
// straight to (2i+a, 2j+b); the 4x-sized upsampled tensor never exists.
//
// Work split: a block owns a tile of tw columns x TH rows of output pixels
// and ALL cout channels of them, so PixelNorm finishes inside the block.
// Past 8 * CO = 128 channels the channel groups are split over blockIdx.z
// as well (nsplit blocks a tile); nothing ties the channels of a pixel
// together then, because PixelNorm is refused at those widths.
// Each warp owns CO channels and 32 / tw groups of ROWS rows; each lane one
// column and ROWS rows of it.  Input channels stream through shared memory
// CK at a time, staged with cp.async: the (TH + 2) x (tw + 2) halo tile,
// zero-filled outside the image (this implements 'SAME' padding and the
// ragged edge), and the matching slice of the packed weights, transposed so
// that a warp reads its CO channels of one tap as four broadcast float4
// loads.
//
// Two shapes of the template, chosen by the launcher from the sizes:
//   large images: ROWS = 4, CK = 8, tw = 32.  64 accumulators a thread, one
//     weight load per 16 FMAs: the FMA units are the limit.
//   small images (the large shape's grid would fill less than half of the
//     SMs): ROWS = 1, CK = 16, tw = the image's width rounded up to a power
//     of two (at most 32).  A launch's time there is one block's chain of
//     cin / CK steps, so a thread does a quarter of the FMAs a step, a launch
//     half the steps, and more blocks share the image.  Measured on an H100:
//     1.4-2x faster up to 32x32 at 80-160 channels, 1.5-2x slower from 64x64
//     or 100 blocks on, hence the threshold.
#pragma once

#include "common.cuh"

namespace mg {

constexpr int CO = 16;      // output channels per warp
constexpr int MAX_CG = 8;   // channel groups (warps of CO channels) per block
constexpr int MAX_COUT_PIXEL_NORM = MAX_CG * CO;

// x: (B, cin, H, W); w: (nphase, cout, K*K*cin), K ordered (dy, dx, c);
// bias: (cout,) or null for none; y: (B, cout, H, W), or (B, cout, 2H, 2W)
// when nphase == 4; msq: null, or (B, 1, H, W) to receive the pre-norm
// mean over channels of u^2 (K2; needs pixel_norm and nphase == 1).
// TW output columns per block, one per lane; TW = 0: 1 << tw_shift of them,
// given at run time (at most 32).
template <int K, int ROWS, int CK, int TW>
__global__ void __launch_bounds__(256, 2)
conv_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y,
                 float* __restrict__ msq,
                 int cin, int cout, int H, int W, int rg, int tw_shift, int nphase,
                 int nsplit, float slope, int use_slope, int pixel_norm, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int KK = K * K;
  const int tw = TW ? TW : 1 << tw_shift;
  if (TW) tw_shift = 5;
  const int SW = tw + 2;
  const int cg = blockDim.x / (32 * rg);
  const int RW = (32 >> tw_shift) * ROWS;  // rows a warp covers
  const int TH = RW * rg;
  const int SH = TH + 2;
  const int COP = cg * CO;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int col = lane & (tw - 1);
  const int cgi = wid % cg, rbase = (wid / cg) * RW + (lane >> tw_shift) * ROWS;
  const int c0 = blockIdx.x * tw, r0 = blockIdx.y * TH;
  const int zi = blockIdx.z / nsplit;
  const int co_base = (blockIdx.z % nsplit) * COP;  // first channel of this block
  const int b = zi / nphase, ph = zi % nphase;
  const int oy = ph >> 1, ox = ph & 1;  // both 0 for the plain 3x3 conv
  const float* xb = x + (size_t)b * cin * H * W;
  const float* wp = w + (size_t)ph * cout * KK * cin;
  float* in_s = smem;                  // [CK][SH][SW], row 0 = image row r0-1
  float* w_s = smem + CK * SH * SW;    // [KK][CK][COP]

  float acc[ROWS][CO];
#pragma unroll
  for (int p = 0; p < ROWS; ++p)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[p][k] = 0.f;

  for (int ci0 = 0; ci0 < cin; ci0 += CK) {
    // Stage the chunk with every copy in flight at once: a thread takes
    // positions of the halo tile and copies each for the CK channels.
    for (int e = threadIdx.x; e < SH * SW; e += blockDim.x) {
      const int rl = e / SW, gr = r0 - 1 + rl, gc = c0 - 1 + (e - rl * SW);
      const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
      const float* src = xb + (inside ? (size_t)gr * W + gc : 0);
#pragma unroll
      for (int ci = 0; ci < CK; ++ci) {
        const bool ok = inside && ci0 + ci < cin;
        cp_async4(in_s + ci * SH * SW + e, ok ? src + (size_t)(ci0 + ci) * H * W : xb, ok);
      }
    }
    for (int i = threadIdx.x; i < COP * KK * CK; i += blockDim.x) {
      const int cil = i % CK, t = i / CK, tap = t % KK, co = t / KK;
      const int c = ci0 + cil, gco = co_base + co;
      const bool ok = gco < cout && c < cin;
      cp_async4(w_s + (tap * CK + cil) * COP + co,
                ok ? wp + (size_t)gco * KK * cin + tap * cin + c : wp, ok);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
      const float* src = in_s + (ci * SH + rbase + oy) * SW + col + ox;
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        float v[ROWS + K - 1];
#pragma unroll
        for (int j = 0; j < ROWS + K - 1; ++j) v[j] = src[j * SW + dx];
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
          const float4* wv = reinterpret_cast<const float4*>(
              w_s + ((dy * K + dx) * CK + ci) * COP + cgi * CO);
          float wr[CO];
#pragma unroll
          for (int q = 0; q < CO / 4; ++q) {
            const float4 t4 = wv[q];
            wr[4 * q] = t4.x;
            wr[4 * q + 1] = t4.y;
            wr[4 * q + 2] = t4.z;
            wr[4 * q + 3] = t4.w;
          }
#pragma unroll
          for (int p = 0; p < ROWS; ++p)
#pragma unroll
            for (int k = 0; k < CO; ++k)
              acc[p][k] = fmaf(v[p + dy], wr[k], acc[p][k]);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue in float32: bias, LeakyReLU, PixelNorm over all cout channels.
#pragma unroll
  for (int k = 0; k < CO; ++k) {
    const int co = co_base + cgi * CO + k;
    const float bk = (bias != nullptr && co < cout) ? bias[co] : 0.f;
#pragma unroll
    for (int p = 0; p < ROWS; ++p) {
      float u = acc[p][k] + bk;
      if (use_slope) u = u >= 0.f ? u : slope * u;
      acc[p][k] = u;
    }
  }
  if (pixel_norm) {
    // Channel groups meet in shared memory ([cg][TH][tw], over the staging
    // buffers, which the last __syncthreads above released).  Padded
    // channels are 0.
    float* red = smem;
#pragma unroll
    for (int p = 0; p < ROWS; ++p) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < CO; ++k) s = fmaf(acc[p][k], acc[p][k], s);
      red[(cgi * TH + rbase + p) * tw + col] = s;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < ROWS; ++p) {
      float s = 0.f;
      for (int g = 0; g < cg; ++g) s += red[(g * TH + rbase + p) * tw + col];
      const float m = s / (float)cout;
      if (msq != nullptr && cgi == 0) {
        const int r = r0 + rbase + p, c = c0 + col;
        if (r < H && c < W) msq[((size_t)b * H + r) * W + c] = m;
      }
      const float scale = rsqrtf(m + eps);
#pragma unroll
      for (int k = 0; k < CO; ++k) acc[p][k] *= scale;
    }
  }

  const int st = nphase == 4 ? 2 : 1;
  const int Ho = H * st, Wo = W * st;
  const int c = c0 + col;
#pragma unroll
  for (int p = 0; p < ROWS; ++p) {
    const int r = r0 + rbase + p;
    if (r >= H || c >= W) continue;
    const size_t pix = (size_t)(r * st + oy) * Wo + c * st + ox;
#pragma unroll
    for (int k = 0; k < CO; ++k) {
      const int co = co_base + cgi * CO + k;
      if (co < cout) y[((size_t)b * cout + co) * Ho * Wo + pix] = acc[p][k];
    }
  }
}

constexpr int MAX_DEVICES = 64;

// What the launcher asks of the current device, looked up once per device.
struct DeviceInfo {
  int sms = 0;         // streaming multiprocessors
  int smem_optin = 0;  // most dynamic shared memory a block may request
};

inline int current_device(int* dev, const DeviceInfo** info) {
  static DeviceInfo table[MAX_DEVICES];
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  if (*dev < 0 || *dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceInfo& d = table[*dev];
  if (d.sms == 0) {
    e = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, *dev);
    if (e != cudaSuccess) return (int)e;
  }
  *info = &d;
  return 0;
}

// One shape of the template: grid, block and shared memory for the sizes.
template <int K, int ROWS, int CK, int TW>
int launch_shape(const float* x, const float* w, const float* bias, float* y,
                 float* msq, int B, int cin, int cout, int H, int W, int nphase,
                 int cg, int nsplit, int rg, int tw_shift, float slope, int use_slope,
                 int pixel_norm, float eps, int dev, const DeviceInfo& info,
                 cudaStream_t stream) {
  const int tw = 1 << tw_shift;
  const int th = (32 >> tw_shift) * ROWS * rg;
  const dim3 block(32 * cg * rg);
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B * nphase * nsplit);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (CK * (th + 2) * (tw + 2) + K * K * CK * cg * CO);
  // Above 48 KB a kernel gets dynamic shared memory by request only: once
  // for this shape on this device.
  static bool opted_in[MAX_DEVICES] = {};
  if (smem > 48 * 1024 && !opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_tile_kernel<K, ROWS, CK, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        info.smem_optin);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  conv_tile_kernel<K, ROWS, CK, TW><<<grid, block, smem, stream>>>(
      x, w, bias, y, msq, cin, cout, H, W, rg, tw_shift, nphase, nsplit, slope,
      use_slope, pixel_norm, eps);
  return (int)cudaGetLastError();
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int K>
int launch_conv_tile(const float* x, const float* w, const float* bias, float* y,
                     float* msq, int B, int cin, int cout, int H, int W, int nphase,
                     float slope, int use_slope, int pixel_norm, float eps,
                     cudaStream_t stream) {
  if (B < 1 || cin < 1 || cout < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  if (pixel_norm && cout > MAX_COUT_PIXEL_NORM) return (int)cudaErrorInvalidValue;
  if (msq != nullptr && !(pixel_norm && nphase == 1)) return (int)cudaErrorInvalidValue;
  const int cgt = ceil_div(cout, CO);         // channel groups in all
  const int nsplit = ceil_div(cgt, MAX_CG);   // blocks a tile, 1 up to 128 channels
  const int cg = ceil_div(cgt, nsplit);       // channel groups per block
  const int rg = MAX_CG / cg;                 // at most 256 threads a block

  int dev = 0;
  const DeviceInfo* info = nullptr;
  const int err = current_device(&dev, &info);
  if (err != 0) return err;
  const long large_blocks =
      (long)ceil_div(W, 32) * ceil_div(H, 4 * rg) * B * nphase * nsplit;
  if (2 * large_blocks > info->sms)
    return launch_shape<K, 4, 8, 32>(x, w, bias, y, msq, B, cin, cout, H, W, nphase, cg,
                                     nsplit, rg, 5, slope, use_slope, pixel_norm, eps,
                                     dev, *info, stream);
  // Small images: the tile's width fitted to the image, and no more row
  // groups than the image has rows for.
  int tw_shift = 0;
  while (tw_shift < 5 && (1 << tw_shift) < W) ++tw_shift;
  const int rw = 32 >> tw_shift;
  const int rg_small = rg < ceil_div(H, rw) ? rg : ceil_div(H, rw);
  return launch_shape<K, 1, 16, 0>(x, w, bias, y, msq, B, cin, cout, H, W, nphase, cg,
                                   nsplit, rg_small, tw_shift, slope, use_slope,
                                   pixel_norm, eps, dev, *info, stream);
}

}  // namespace mg
