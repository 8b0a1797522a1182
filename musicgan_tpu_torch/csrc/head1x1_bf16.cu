// The ToMagnPhase head on a bf16 activation in one pass: a 1x1 conv from C
// channels to 2, its bias and tanh, bf16 in, float32 out.  Replaces no
// Pallas kernel: in the JAX package the head is XLA's
// (musicgan_tpu/models/generator.py:250, _head_nchw: the activation upcast
// to float32, an einsum over the channels, the bias, tanh), which the port
// ran as four launches: the upcast (which writes twice the bytes it reads),
// a batched GEMV over the upcast copy, the bias add and tanh.
//
// What bounds it on an H100: bytes.  The function does 4 FLOP an input
// element and reads 2 bytes for them.  At the synthesis shape, (20, 16,
// 512, 5120) bf16 in and (20, 2, 512, 5120) float32 out, the input read once
// and the image written once are 2.10 GB, 0.63 ms at 3.35 TB/s; the four
// launches moved about five times that.  So each byte is moved once:
//   * a thread owns 8 consecutive pixels of one image's plane and reads
//     them from each of the C channel planes as one 16-byte load with the
//     streaming hint (ld.global.cs: the input is read once);
//   * it issues the loads of 16 channels before their first product, so
//     256 bytes a thread are in flight, enough to cover the memory's
//     latency at a few hundred threads an SM;
//   * it keeps 2 x 8 float32 sums in registers; the weights and the bias
//     sit in shared memory as (w[0][c], w[1][c]) pairs, read as broadcasts;
//   * it writes each output channel's 8 pixels as two 16-byte stores.
//
// Numerics: each sum in float32 from 0 in channel order, then the bias, then
// the full-precision tanhf (never tanh.approx):
//   y[b, k, p] = tanhf((sum_c w[k, c] * x[b, c, p]) + bias[k]).
// The 16-byte route needs the plane's length (H * W) a multiple of 8 and
// both pointers on 16 bytes; otherwise the same kernel loads and stores
// element by element, the plane's last run masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 8;     // consecutive pixels a thread
constexpr int kGroup = 16;  // channels whose loads a thread issues before their products
constexpr int kMaxChannels = 4096;  // the weights' shared memory: 32 KB

__device__ __forceinline__ void accumulate8(const uint4 v, const float2 wc, float (&a0)[kPix],
                                            float (&a1)[kPix]) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __uint_as_float(u[i] << 16);           // pixel 2i (the lower address)
    const float hi = __uint_as_float(u[i] & 0xffff0000u);   // pixel 2i + 1
    a0[2 * i] = fmaf(wc.x, lo, a0[2 * i]);
    a1[2 * i] = fmaf(wc.y, lo, a1[2 * i]);
    a0[2 * i + 1] = fmaf(wc.x, hi, a0[2 * i + 1]);
    a1[2 * i + 1] = fmaf(wc.y, hi, a1[2 * i + 1]);
  }
}

// One thread a unit: 8 pixels of one image's plane.  Unit u covers image
// u / units_per_plane, pixels 8 (u % units_per_plane) onwards.
template <bool VEC>
__global__ void __launch_bounds__(kThreads) head1x1_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ y, int C, long long plane, long long units_per_plane, long long units) {
  extern __shared__ float2 sw[];  // sw[c] = (w[0][c], w[1][c])
  for (int c = threadIdx.x; c < C; c += kThreads) sw[c] = make_float2(w[c], w[C + c]);
  __syncthreads();
  const long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (u >= units) return;
  const long long img = u / units_per_plane;
  const long long p0 = (u - img * units_per_plane) * kPix;
  const __nv_bfloat16* xp = x + img * C * plane + p0;
  float* yp = y + img * 2 * plane + p0;
  float a0[kPix], a1[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) a0[j] = a1[j] = 0.0f;
  const float b0 = bias[0], b1 = bias[1];

  if constexpr (VEC) {
    int c = 0;
    for (; c + kGroup <= C; c += kGroup) {
      uint4 v[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        v[i] = __ldcs(reinterpret_cast<const uint4*>(xp + (long long)(c + i) * plane));
#pragma unroll
      for (int i = 0; i < kGroup; ++i) accumulate8(v[i], sw[c + i], a0, a1);
    }
    for (; c < C; ++c)
      accumulate8(__ldcs(reinterpret_cast<const uint4*>(xp + (long long)c * plane)), sw[c], a0, a1);
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      a0[j] = tanhf(a0[j] + b0);
      a1[j] = tanhf(a1[j] + b1);
    }
    float4* y0 = reinterpret_cast<float4*>(yp);
    float4* y1 = reinterpret_cast<float4*>(yp + plane);
    y0[0] = make_float4(a0[0], a0[1], a0[2], a0[3]);
    y0[1] = make_float4(a0[4], a0[5], a0[6], a0[7]);
    y1[0] = make_float4(a1[0], a1[1], a1[2], a1[3]);
    y1[1] = make_float4(a1[4], a1[5], a1[6], a1[7]);
  } else {
    const int n = (int)min((long long)kPix, plane - p0);
    for (int c = 0; c < C; ++c) {
      const float2 wc = sw[c];
      const __nv_bfloat16* xc = xp + (long long)c * plane;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (j < n) {
          const float v = __bfloat162float(xc[j]);
          a0[j] = fmaf(wc.x, v, a0[j]);
          a1[j] = fmaf(wc.y, v, a1[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (j < n) {
        yp[j] = tanhf(a0[j] + b0);
        yp[plane + j] = tanhf(a1[j] + b1);
      }
    }
  }
}

}  // namespace

// x: (B, C, H, W) bf16, contiguous; w: (2, C) float32, contiguous; bias: (2,)
// float32; y: (B, 2, H, W) float32, contiguous.  1 <= C <= 4096.
extern "C" int mg_head1x1_bf16(const void* x, const float* w, const float* bias, float* y, int B, int C,
                               int H, int W, cudaStream_t stream) {
  if (B < 1 || C < 1 || C > kMaxChannels || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)H * W;
  const long long units_per_plane = (plane + kPix - 1) / kPix;
  const long long units = units_per_plane * B;
  const long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = plane % kPix == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(y) % 16 == 0;
  const size_t smem = sizeof(float2) * (size_t)C;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  if (vec)
    head1x1_bf16_kernel<true><<<(unsigned)blocks, kThreads, smem, stream>>>(xb, w, bias, y, C, plane,
                                                                             units_per_plane, units);
  else
    head1x1_bf16_kernel<false><<<(unsigned)blocks, kThreads, smem, stream>>>(xb, w, bias, y, C, plane,
                                                                              units_per_plane, units);
  return (int)cudaGetLastError();
}
