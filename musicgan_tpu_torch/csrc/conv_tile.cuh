// Direct 3x3 convolution with a fused bias / LeakyReLU / PixelNorm epilogue,
// float32 on the CUDA cores (FMA; no TF32, no tensor cores yet).
//
// One template serves three kernels:
//   K = 3: the 3x3 'SAME' conv, and the same also storing the pre-PixelNorm
//          mean-square map                         (conv3x3.cu,   K1, K2)
//   K = 2: one sub-pixel phase of conv3x3(up2x(x)) (upconv3x3.cu, K3)
// The up-conv's four phases are four slices of the grid (nphase = 4):
// PixelNorm reduces over the channels of one output pixel, and each output
// pixel belongs to exactly one phase, so a block owns one phase of its tile
// and writes it straight to (2i+a, 2j+b); the 4x-sized upsampled tensor
// never exists.
//
// Weights come in the kernel layout of ops/conv.py::kernel_weights:
// (nphase, cin, K*K, coutp), coutp = cout rounded up to 16 with zeros, so
// the weights of one input channel and one tap for a block's channels are
// one contiguous run, staged with 16-byte cp.async.
//
// Output channels go to warps 16 at a time (a channel group, CO); up to 8
// groups share a block.  Past 8 * 16 = 128 channels the groups are split
// over nsplit blocks of the same pixels.  PixelNorm needs every channel of a
// pixel: those blocks form one thread-block cluster, and each adds the
// others' per-pixel sums of u^2 through distributed shared memory, in rank
// order, so the result does not depend on scheduling.  PixelNorm therefore
// takes any cout up to 8 * 128 (a portable cluster of 8).
//
// Two shapes, chosen by plan_conv from the sizes:
//
//   large images (conv_tile_kernel): a block owns a tile of 32 columns x TH
//     rows of one image, a lane one column and 4 rows of it, a warp 16
//     channels; input channels stream through shared memory 8 at a time,
//     the (TH + 2) x 34 halo tile zero-filled outside the image.  64
//     accumulators a thread, one weight load per 16 FMAs: what bounds it is
//     float32 operations, at 23-51% of the card's FP32 peak.
//
//   small images (conv_flat_kernel; taken when the large shape's grid would
//     fill less than half the SMs): what bounds these convs is not
//     arithmetic (a few MFLOP, microseconds at the FP32 peak) but latency: a
//     chain of serial steps over the input channels in too few blocks,
//     each step staging weights.  So:
//     - the tile is NP = 32 * PR * rg pixels of the batch flattened to
//       (b, row, col): images of 1-32 pixels share a tile and every weight
//       staged serves all of them.  A lane owns PR pixels 32 apart.  The
//       input is staged as the contiguous flattened range the tile's 3x3
//       neighbourhoods reach (the tile and W + 1 pixels each side) plus one
//       zero word, and a thread reads, for each of its pixels and taps, an
//       offset fixed for the whole launch: the neighbour's, or the zero
//       word's where the neighbour lies in another row or image or past the
//       batch;
//     - K = K*K*cin is split over S <= 8 blocks of one cluster (with
//       PixelNorm past 128 channels the cluster also holds the nsplit
//       channel splits, S * nsplit <= 8), each block taking a contiguous
//       range of input-channel steps; the partial
//       tiles are reduced through distributed shared memory in rank order,
//       rank k finishing the k-th 1/S of the tile's pixels over all its
//       channels, so the epilogue (and PixelNorm, whose per-pixel sums meet
//       across the channel splits of the same pixels) stays with the rank
//       that holds the sum.  One launch, no workspace, no atomics;
//     - each step's weights are one 16-byte-copy run per (channel, tap),
//       double-buffered with the input: step k+1's copies fly while step k's
//       FMAs run;
//     - taps that leave every image (all but the centre at 1x1) are neither
//       staged nor computed.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace mg {

namespace coop = cooperative_groups;

constexpr int CO = 16;         // output channels per warp
constexpr int MAX_CG = 8;      // channel groups (warps of CO channels) per block
constexpr int MAX_CLUSTER = 8; // blocks of a portable cluster

// ---------------------------------------------------------------------------
// Large images.
// x: (B, cin, H, W); w: kernel layout; bias: (cout,) or null for none;
// y: (B, cout, H, W), or (B, cout, 2H, 2W) when nphase == 4; msq: null, or
// (B, 1, H, W) to receive the pre-norm mean over channels of u^2 (K2; needs
// pixel_norm and nphase == 1).  With PixelNorm and nsplit > 1 the nsplit
// blocks of a tile are one cluster along z.
template <int K, int ROWS, int CK>
__global__ void __launch_bounds__(256, 2)
conv_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y,
                 float* __restrict__ msq, int cin, int cout, int coutp, int H, int W,
                 int rg, int nphase, int nsplit, float slope, int use_slope,
                 int pixel_norm, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int KK = K * K;
  constexpr int TW = 32, SW = TW + 2;
  const int cg = blockDim.x / (32 * rg);
  const int TH = ROWS * rg;
  const int SH = TH + 2;
  const int COP = cg * CO;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int col = lane;
  const int cgi = wid % cg, rbase = (wid / cg) * ROWS;
  const int c0 = blockIdx.x * TW, r0 = blockIdx.y * TH;
  const int zi = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int co_base = split * COP;  // first channel of this block
  const int b = zi / nphase, ph = zi % nphase;
  const int oy = ph >> 1, ox = ph & 1;  // both 0 for the plain 3x3 conv
  const float* xb = x + (size_t)b * cin * H * W;
  const float* wp = w + (size_t)ph * cin * KK * coutp;
  float* in_s = smem;                   // [CK][SH][SW], row 0 = image row r0-1
  float* w_s = smem + ((CK * SH * SW + 3) & ~3);  // [KK][CK][COP], 16-byte aligned

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
    const int q4 = COP / 4;
    for (int i = threadIdx.x; i < KK * CK * q4; i += blockDim.x) {
      const int j4 = i % q4, t = i / q4, cil = t % CK, tap = t / CK;
      const int c = ci0 + cil, co = co_base + 4 * j4;
      const bool ok = c < cin && co < coutp;
      cp_async16(w_s + t * COP + 4 * j4, ok ? wp + ((size_t)c * KK + tap) * coutp + co : wp, ok);
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
  const bool clustered = pixel_norm && nsplit > 1;
  if (pixel_norm) {
    // Channel groups meet in shared memory ([cg][TH][TW], over the staging
    // buffers, which the last __syncthreads above released), then the
    // block's sum over its channels ([TH][TW]) meets the other splits'.
    // Padded channels are 0.
    float* red = smem;
    float* part = smem + cg * TH * TW;
#pragma unroll
    for (int p = 0; p < ROWS; ++p) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < CO; ++k) s = fmaf(acc[p][k], acc[p][k], s);
      red[(cgi * TH + rbase + p) * TW + col] = s;
    }
    __syncthreads();
    float sum[ROWS];
#pragma unroll
    for (int p = 0; p < ROWS; ++p) {
      float s = 0.f;
      for (int g = 0; g < cg; ++g) s += red[(g * TH + rbase + p) * TW + col];
      sum[p] = s;
      if (clustered && cgi == 0) part[(rbase + p) * TW + col] = s;
    }
    if (clustered) {
      coop::cluster_group cluster = coop::this_cluster();
      cluster.sync();
#pragma unroll
      for (int p = 0; p < ROWS; ++p) {
        float s = 0.f;
        for (int k = 0; k < nsplit; ++k)
          s += cluster.map_shared_rank(part, k)[(rbase + p) * TW + col];
        sum[p] = s;
      }
    }
#pragma unroll
    for (int p = 0; p < ROWS; ++p) {
      const float m = sum[p] / (float)cout;
      if (msq != nullptr && cgi == 0 && split == 0) {
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
  // A block's shared memory must outlive the other blocks' reads of it.
  if (clustered) coop::this_cluster().sync();
}

// ---------------------------------------------------------------------------
// Small images.  Block x = (tile * nsplit + split) * S + ks: pixels
// [tile * NP, tile * NP + NP) of the flattened batch, channels
// [split * COP, split * COP + COP), input-channel steps [ks * csteps,
// ks * csteps + csteps).  The S blocks of a (tile, split) are one cluster;
// with PixelNorm and nsplit > 1 the nsplit * S blocks of a tile are.
// blockIdx.y is the phase.
template <int K, int PR, int CK>
__global__ void __launch_bounds__(256, 2)
conv_flat_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y,
                 float* __restrict__ msq, int cin, int cout, int coutp, int H, int W,
                 int N, int rg, int nphase, int nsplit, int S, int csteps, float slope,
                 int use_slope, int pixel_norm, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int KK = K * K;
  const bool pn_cluster = pixel_norm && nsplit > 1;  // the splits share a cluster
  const int csize = pn_cluster ? S * nsplit : S;
  const int ks = blockIdx.x % S, split = (blockIdx.x / S) % nsplit;
  const int tile = blockIdx.x / (S * nsplit);
  // Cluster rank of the block (split', ks') of this tile.
  auto rank_of = [&](int sp, int k) { return pn_cluster ? sp * S + k : k; };
  const int ph = blockIdx.y, oy = ph >> 1, ox = ph & 1;
  const int cg = blockDim.x / (32 * rg);
  const int COP = cg * CO, NP = 32 * PR * rg;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int cgi = wid % cg, rgi = wid / cg;
  const int co_base = split * COP;
  const int p0 = tile * NP;
  const int HW = H * W;
  // Staged pixels of a channel: the tile and W + 1 each side, then one
  // word that stays 0, which every neighbour outside a pixel's image reads.
  const int L = NP + 2 * W + 3, ZERO = L - 1;
  const int WBUF = CK * KK * COP;
  const int BUF = WBUF + ((CK * L + 3) & ~3);  // keeps each buffer 16-byte aligned

  // Taps whose offset leaves every image; and for each of this thread's
  // pixels and each tap, where in a staged channel its neighbour lies (the
  // zero word where it is in another row or image or past the batch).
  int live = 0;
#pragma unroll
  for (int t = 0; t < KK; ++t) {
    const int ry = oy + t / K - 1, rx = ox + t % K - 1;
    if (ry > -H && ry < H && rx > -W && rx < W) live |= 1 << t;
  }
  int pl[PR], src_of[PR][KK];
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    pl[i] = rgi * 32 * PR + lane + 32 * i;
    const int p = p0 + pl[i];
    const int rem = p % HW, r = rem / W, c = rem - r * W;
#pragma unroll
    for (int t = 0; t < KK; ++t) {
      const int dr = oy + t / K - 1, dc = ox + t % K - 1;
      const bool in = p < N && r + dr >= 0 && r + dr < H && c + dc >= 0 && c + dc < W;
      src_of[i][t] = in ? pl[i] + W + 1 + dr * W + dc : ZERO;
    }
  }

  const int total_steps = (cin + CK - 1) / CK;
  const int s_begin = ks * csteps;
  const int nsteps = max(0, min(csteps, total_steps - s_begin));
  const float* wp = w + (size_t)ph * cin * KK * coutp;

  auto stage = [&](int step, float* buf) {
    const int ci0 = (s_begin + step) * CK;
    const int q4 = COP / 4;
    for (int i = threadIdx.x; i < CK * KK * q4; i += blockDim.x) {
      const int j4 = i % q4, t = i / q4, tap = t % KK, cil = t / KK;
      if (!(live >> tap & 1)) continue;
      const int c = ci0 + cil, co = co_base + 4 * j4;
      const bool ok = c < cin && co < coutp;
      cp_async16(buf + t * COP + 4 * j4, ok ? wp + ((size_t)c * KK + tap) * coutp + co : wp, ok);
    }
    float* a_s = buf + WBUF;
    for (int e = threadIdx.x; e < L; e += blockDim.x) {
      const int q = p0 - W - 1 + e;
      const bool inside = e < ZERO && q >= 0 && q < N;
      const int bq = inside ? q / HW : 0;
      const float* src = x + (inside ? (size_t)bq * cin * HW + (q - bq * HW) : 0);
#pragma unroll
      for (int ci = 0; ci < CK; ++ci) {
        const bool ok = inside && ci0 + ci < cin;
        cp_async4(a_s + ci * L + e, ok ? src + (size_t)(ci0 + ci) * HW : x, ok);
      }
    }
  };

  float acc[PR][CO];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[i][k] = 0.f;

  if (nsteps > 0) {
    stage(0, smem);
    cp_async_commit();
  }
  for (int st = 0; st < nsteps; ++st) {
    const float* cur = smem + (st & 1) * BUF;
    if (st + 1 < nsteps) {
      stage(st + 1, smem + ((st + 1) & 1) * BUF);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* a_s = cur + WBUF;
    const float* w_s = cur + cgi * CO;
    for (int ci = 0; ci < CK; ++ci, a_s += L, w_s += KK * COP) {
#pragma unroll
      for (int t = 0; t < KK; ++t) {
        if (!(live >> t & 1)) continue;
        float a[PR];
#pragma unroll
        for (int i = 0; i < PR; ++i) a[i] = a_s[src_of[i][t]];
        const float4* wv = reinterpret_cast<const float4*>(w_s + t * COP);
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
        for (int i = 0; i < PR; ++i)
#pragma unroll
          for (int k = 0; k < CO; ++k) acc[i][k] = fmaf(a[i], wr[k], acc[i][k]);
      }
    }
    __syncthreads();
  }

  // The partial tile, [COP][NP], over the staging buffers.
  float* red = smem;
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int k = 0; k < CO; ++k) red[(cgi * CO + k) * NP + pl[i]] = acc[i][k];
  if (csize > 1)
    coop::this_cluster().sync();
  else
    __syncthreads();

  // Block ks finishes pixels [ks * SL, ks * SL + SL) of the tile: the S
  // partials of its split in rank order, bias, LeakyReLU, in place (no
  // other block reads this slice of this block's tile).
  const int SL = NP / S, sl0 = ks * SL;
  for (int e = threadIdx.x; e < COP * SL; e += blockDim.x) {
    const int co = e / SL, idx = co * NP + sl0 + e % SL;
    float v = 0.f;
    if (S > 1) {
      coop::cluster_group cluster = coop::this_cluster();
      for (int k = 0; k < S; ++k) v += cluster.map_shared_rank(red, rank_of(split, k))[idx];
    } else {
      v = red[idx];
    }
    const int gco = co_base + co;
    if (bias != nullptr && gco < cout) v += bias[gco];
    if (use_slope) v = v >= 0.f ? v : slope * v;
    red[idx] = v;
  }

  float* part = smem + COP * NP;  // [SL]: this block's sum of u^2 a pixel
  float* scl = part + SL;         // [SL]: the PixelNorm scale a pixel
  if (pixel_norm) {
    __syncthreads();
    for (int j = threadIdx.x; j < SL; j += blockDim.x) {
      float s = 0.f;
      for (int co = 0; co < COP; ++co) {
        const float v = red[co * NP + sl0 + j];
        s = fmaf(v, v, s);
      }
      part[j] = s;
    }
    if (pn_cluster)
      coop::this_cluster().sync();
    else
      __syncthreads();
    for (int j = threadIdx.x; j < SL; j += blockDim.x) {
      float s = part[j];
      if (pn_cluster) {
        coop::cluster_group cluster = coop::this_cluster();
        s = 0.f;
        for (int k = 0; k < nsplit; ++k) s += cluster.map_shared_rank(part, rank_of(k, ks))[j];
      }
      const float m = s / (float)cout;
      const int p = p0 + sl0 + j;
      if (msq != nullptr && split == 0 && p < N) msq[p] = m;
      scl[j] = rsqrtf(m + eps);
    }
  }
  __syncthreads();

  const int sts = nphase == 4 ? 2 : 1;
  const int Ho = H * sts, Wo = W * sts;
  for (int e = threadIdx.x; e < COP * SL; e += blockDim.x) {
    const int co = e / SL, j = e % SL;
    const int gco = co_base + co, p = p0 + sl0 + j;
    if (gco >= cout || p >= N) continue;
    float v = red[co * NP + sl0 + j];
    if (pixel_norm) v *= scl[j];
    const int bq = p / HW, rem = p - bq * HW, r = rem / W, c = rem - r * W;
    y[((size_t)bq * cout + gco) * Ho * Wo + (size_t)(r * sts + oy) * Wo + c * sts + ox] = v;
  }
  // A block's shared memory must outlive the other blocks' reads of it.
  if (csize > 1) coop::this_cluster().sync();
}

// ---------------------------------------------------------------------------
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

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

constexpr int LARGE_ROWS = 4, LARGE_CK = 8;  // the large shape
constexpr int FLAT_CK = 8;                    // input channels a step, small shape

// How a conv of these sizes is launched.  shape 1: large images, 2: small.
struct ConvPlan {
  int shape, cg, rg, nsplit, pr, S, csteps, cluster;
  dim3 grid, block;
  size_t smem;  // bytes
};

#ifdef MG_CONV_SWEEP
// Only in the plan sweep's own build (scripts/torch_conv_sweep.py compiles
// with -DMG_CONV_SWEEP): mg_conv_force sets a shape (1 or 2; 0 lets the
// sizes choose) and the small shape's pixels a lane and cluster split (0:
// by the sizes) for every later launch.
struct ConvForce {
  int shape = 0, pr = 0, S = 0;
};
inline ConvForce& conv_force() {
  static ConvForce f;
  return f;
}
#endif

inline int plan_conv(int K, int B, int cin, int cout, int H, int W, int nphase,
                     int pixel_norm, const DeviceInfo& info, ConvPlan* p) {
  if (B < 1 || cin < 1 || cout < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int KK = K * K;
  const int cgt = ceil_div(cout, CO);        // channel groups in all
  const int nsplit = ceil_div(cgt, MAX_CG);  // blocks a tile, 1 up to 128 channels
  const int cg = ceil_div(cgt, nsplit);      // channel groups per block
  const int rg = MAX_CG / cg;                // at most 256 threads a block
  if (pixel_norm && nsplit > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  p->nsplit = nsplit;
  p->cg = cg;

  // The small shape.  Pixels a lane: the fewest that make the tile at least
  // one image row wide (the staged input is the tile and W + 1 pixels each
  // side, so a narrower tile stages mostly halo), and no larger a tile than
  // the batch's pixels.  Then the cluster's split over input channels: as
  // large as the portable cluster and the steps allow, while the grid stays
  // within three blocks an SM and, past one block an SM, each block keeps
  // at least 3 steps (fewer leave its fixed costs uncovered).  Fitted on an
  // H100 to the critic's and generator's shapes up to 64x64 and
  // synthesis's first blocks, each timed under every (pixels a lane, split)
  // pair and the large shape (scripts/torch_conv_sweep.py, PERF.md).
  const long N = (long)B * H * W;
  int rgs = rg;
  while (rgs > 1 && 32L * (rgs / 2) >= N) rgs /= 2;
  int pr = 1;
  while (pr < 4 && 32 * pr * rgs < W && 32L * 2 * pr * rgs <= ((N + 31) / 32) * 32) pr *= 2;
  auto blocks = [&](int pr_, int S_) {
    return (long)ceil_div((int)std::min<long>(N, 1L << 30), 32 * pr_ * rgs) * nsplit * nphase * S_;
  };
  const int total_steps = ceil_div(cin, FLAT_CK);
  int S = 1;
  const int per_cluster = pixel_norm ? nsplit : 1;  // channel splits a cluster holds
  while (2 * S * per_cluster <= MAX_CLUSTER && 2 * S <= total_steps &&
         blocks(pr, 2 * S) <= 3L * info.sms &&
         (ceil_div(total_steps, 2 * S) >= 3 || blocks(pr, 2 * S) <= info.sms))
    S *= 2;
#ifdef MG_CONV_SWEEP
  if (conv_force().pr > 0) pr = conv_force().pr;
  if (conv_force().S > 0) S = conv_force().S;
  if (S * per_cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
#endif
  const int NP = 32 * pr * rgs, COP = cg * CO;
  const size_t L = (size_t)NP + 2 * W + 3;
  const size_t buf = (size_t)FLAT_CK * KK * COP + ((FLAT_CK * L + 3) & ~(size_t)3);
  const size_t flat_floats = std::max(2 * buf, (size_t)COP * NP + 2 * NP);
  const bool flat_fits = flat_floats * sizeof(float) <= (size_t)info.smem_optin;

  // The large shape once its grid fills half the SMs (from 64x64 at the
  // train step's widths): there the sweep found it faster at every shape
  // but the 80-channel ones, whose large tile has a single row group.
  const long large_blocks = (long)ceil_div(W, 32) * ceil_div(H, LARGE_ROWS * rg) * B * nphase * nsplit;
  int shape = (2 * large_blocks > info.sms || !flat_fits) ? 1 : 2;
#ifdef MG_CONV_SWEEP
  const int fs = conv_force().shape;
  if (fs == 1 || (fs == 2 && flat_fits)) shape = fs;
#endif
  p->shape = shape;
  if (shape == 1) {
    const int th = LARGE_ROWS * rg;
    p->rg = rg;
    p->pr = LARGE_ROWS;
    p->S = 1;
    p->csteps = ceil_div(cin, LARGE_CK);
    p->cluster = pixel_norm && nsplit > 1 ? nsplit : 1;
    p->block = dim3(32 * cg * rg);
    p->grid = dim3(ceil_div(W, 32), ceil_div(H, th), B * nphase * nsplit);
    if (p->grid.y > 65535 || p->grid.z > 65535) return (int)cudaErrorInvalidValue;
    p->smem = sizeof(float) * ((size_t)KK * LARGE_CK * cg * CO +
                               (((size_t)LARGE_CK * (th + 2) * (32 + 2) + 3) & ~(size_t)3));
    return 0;
  }
  p->rg = rgs;
  p->pr = pr;
  p->S = S;
  p->csteps = ceil_div(total_steps, S);
  p->cluster = S * per_cluster;
  p->block = dim3(32 * cg * rgs);
  const long tiles = ceil_div((int)N, NP);
  if (N > (1L << 30) || tiles * nsplit * S > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  p->grid = dim3((unsigned)(tiles * nsplit * S), nphase, 1);
  p->smem = flat_floats * sizeof(float);
  return 0;
}

template <auto kernel, typename... Args>
int launch(const ConvPlan& p, int dev, const DeviceInfo& info, cudaStream_t stream,
           Args... args) {
  // Above 48 KB a kernel gets dynamic shared memory by request only: once
  // for this kernel on this device.
  static bool opted_in[MAX_DEVICES] = {};
  if (p.smem > (size_t)info.smem_optin) return (int)cudaErrorInvalidValue;
  if (p.smem > 48 * 1024 && !opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, info.smem_optin);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = p.grid;
  cfg.blockDim = p.block;
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  // A cluster only where blocks share shared memory: a launch without the
  // attribute is an ordinary one.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.shape == 2 ? p.cluster : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.shape == 1 ? p.cluster : 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int K>
int launch_conv_tile(const float* x, const float* w, const float* bias, float* y,
                     float* msq, int B, int cin, int cout, int H, int W, int nphase,
                     float slope, int use_slope, int pixel_norm, float eps,
                     cudaStream_t stream) {
  if (msq != nullptr && !(pixel_norm && nphase == 1)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const DeviceInfo* info = nullptr;
  int err = current_device(&dev, &info);
  if (err != 0) return err;
  ConvPlan p;
  err = plan_conv(K, B, cin, cout, H, W, nphase, pixel_norm, *info, &p);
  if (err != 0) return err;
  const int coutp = ceil_div(cout, CO) * CO;
  if (p.shape == 1)
    return launch<conv_tile_kernel<K, LARGE_ROWS, LARGE_CK>>(p, dev, *info, stream, x, w,
                  bias, y, msq, cin, cout, coutp, H, W, p.rg, nphase, p.nsplit, slope,
                  use_slope, pixel_norm, eps);
  const int N = B * H * W;
#define MG_FLAT(PR)                                                                      \
  launch<conv_flat_kernel<K, PR, FLAT_CK>>(p, dev, *info, stream, x, w, bias, y, msq, \
         cin, cout, coutp, H, W, N, p.rg, nphase, p.nsplit, p.S, p.csteps, slope,      \
         use_slope, pixel_norm, eps)
  switch (p.pr) {
    case 1: return MG_FLAT(1);
    case 2: return MG_FLAT(2);
    case 4: return MG_FLAT(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MG_FLAT
}

}  // namespace mg

// The plan the launcher takes for these sizes on the current device, for
// measurement and tests: out = {shape, cluster blocks, S, nsplit, pixels a
// lane, threads, blocks, shared-memory bytes}.  Returns a CUDA error code.
extern "C" int mg_conv_plan(int K, int B, int cin, int cout, int H, int W, int nphase,
                            int pixel_norm, int* out) {
  int dev = 0;
  const mg::DeviceInfo* info = nullptr;
  int err = mg::current_device(&dev, &info);
  if (err != 0) return err;
  mg::ConvPlan p;
  err = mg::plan_conv(K, B, cin, cout, H, W, nphase, pixel_norm, *info, &p);
  if (err != 0) return err;
  const int v[8] = {p.shape, p.cluster, p.S, p.nsplit, p.pr, (int)p.block.x,
                    (int)(p.grid.x * p.grid.y * p.grid.z), (int)p.smem};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

#ifdef MG_CONV_SWEEP
extern "C" void mg_conv_force(int shape, int pr, int S) {
  mg::conv_force() = mg::ConvForce{shape, pr, S};
}
#endif
