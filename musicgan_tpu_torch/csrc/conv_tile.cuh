// Direct 3x3 convolution with a fused bias / LeakyReLU / PixelNorm epilogue,
// float32 on the CUDA cores (FMA; no TF32, no tensor cores yet).
//
// One template serves two kernels:
//   K = 3: the 3x3 'SAME' conv                     (conv3x3.cu,   K1)
//   K = 2: one sub-pixel phase of conv3x3(up2x(x)) (upconv3x3.cu, K3)
// The up-conv's four phases ride blockIdx.z (nphase = 4): PixelNorm reduces
// over the channels of one output pixel, and each output pixel belongs to
// exactly one phase, so a block owns one phase of its tile and writes it
// straight to (2i+a, 2j+b); the 4x-sized upsampled tensor never exists.
//
// Work split: a block owns a tile of TILE_W columns x (ROWS * rg) rows of
// output pixels and ALL cout channels of them, so PixelNorm finishes inside
// the block.  Each warp owns CO channels; each lane one column and ROWS
// rows of it.  Input channels stream through shared memory CK at a time,
// staged with cp.async: the (rows + 2) x (TILE_W + 2) halo tile, zero-filled
// outside the image (this implements 'SAME' padding and the ragged edge),
// and the matching slice of the packed weights, transposed so that a warp
// reads its CO channels of one tap as four broadcast float4 loads.
#pragma once

#include "common.cuh"

namespace mg {

constexpr int TILE_W = 32;  // output columns per block, one per lane
constexpr int ROWS = 4;     // output rows per thread
constexpr int CO = 16;      // output channels per warp
constexpr int CK = 8;       // input channels staged per step
constexpr int MAX_COUT = 8 * CO;

// x: (B, cin, H, W); w: (nphase, cout, K*K*cin), K ordered (dy, dx, c);
// y: (B, cout, H, W), or (B, cout, 2H, 2W) when nphase == 4.
template <int K>
__global__ void __launch_bounds__(256, 2)
conv_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y,
                 int cin, int cout, int H, int W, int rg, int nphase,
                 float slope, int use_slope, int pixel_norm, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int KK = K * K;
  constexpr int SW = TILE_W + 2;
  const int cg = blockDim.x / (32 * rg);
  const int TH = ROWS * rg;
  const int SH = TH + 2;
  const int COP = cg * CO;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int cgi = wid % cg, rbase = (wid / cg) * ROWS;
  const int c0 = blockIdx.x * TILE_W, r0 = blockIdx.y * TH;
  const int b = blockIdx.z / nphase, ph = blockIdx.z % nphase;
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
      const int c = ci0 + cil;
      const bool ok = co < cout && c < cin;
      cp_async4(w_s + (tap * CK + cil) * COP + co,
                ok ? wp + (size_t)co * KK * cin + tap * cin + c : wp, ok);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
      const float* src = in_s + (ci * SH + rbase + oy) * SW + lane + ox;
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
    const int co = cgi * CO + k;
    const float bk = co < cout ? bias[co] : 0.f;
#pragma unroll
    for (int p = 0; p < ROWS; ++p) {
      float u = acc[p][k] + bk;
      if (use_slope) u = u >= 0.f ? u : slope * u;
      acc[p][k] = u;
    }
  }
  if (pixel_norm) {
    // Channel groups meet in shared memory ([cg][TH][TILE_W], over in_s,
    // which the last __syncthreads above released).  Padded channels are 0.
    float* red = smem;
#pragma unroll
    for (int p = 0; p < ROWS; ++p) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < CO; ++k) s = fmaf(acc[p][k], acc[p][k], s);
      red[(cgi * TH + rbase + p) * TILE_W + lane] = s;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < ROWS; ++p) {
      float s = 0.f;
      for (int g = 0; g < cg; ++g) s += red[(g * TH + rbase + p) * TILE_W + lane];
      const float scale = rsqrtf(s / (float)cout + eps);
#pragma unroll
      for (int k = 0; k < CO; ++k) acc[p][k] *= scale;
    }
  }

  const int st = nphase == 4 ? 2 : 1;
  const int Ho = H * st, Wo = W * st;
  const int c = c0 + lane;
#pragma unroll
  for (int p = 0; p < ROWS; ++p) {
    const int r = r0 + rbase + p;
    if (r >= H || c >= W) continue;
    const size_t pix = (size_t)(r * st + oy) * Wo + c * st + ox;
#pragma unroll
    for (int k = 0; k < CO; ++k) {
      const int co = cgi * CO + k;
      if (co < cout) y[((size_t)b * cout + co) * Ho * Wo + pix] = acc[p][k];
    }
  }
}

template <int K>
int launch_conv_tile(const float* x, const float* w, const float* bias, float* y,
                     int B, int cin, int cout, int H, int W, int nphase,
                     float slope, int use_slope, int pixel_norm, float eps,
                     cudaStream_t stream) {
  if (B < 1 || cin < 1 || cout < 1 || cout > MAX_COUT || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int cg = (cout + CO - 1) / CO;
  const int rg = cg >= 8 ? 1 : 8 / cg;  // at most 256 threads a block
  const int th = ROWS * rg;
  const dim3 block(32 * cg * rg);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + th - 1) / th, B * nphase);
  const size_t smem =
      sizeof(float) * (CK * (th + 2) * (TILE_W + 2) + K * K * CK * cg * CO);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_tile_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  conv_tile_kernel<K><<<grid, block, smem, stream>>>(
      x, w, bias, y, cin, cout, H, W, rg, nphase, slope, use_slope, pixel_norm, eps);
  return (int)cudaGetLastError();
}

}  // namespace mg
