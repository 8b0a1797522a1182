// K4: one whole generator block in one launch, float32 on the CUDA cores:
//   c1 = PixelNorm(LeakyReLU(conv3x3(x) + b1))            (cin  -> cmid)
//   y  = PixelNorm(LeakyReLU(conv3x3(up2x(c1)) + b2))     (cmid -> cout, 2H x 2W)
// Replaces musicgan_tpu/ops/conv.py::fused_block (Pallas kernel
// _block_kernel).  c1 never leaves the chip: a thread block computes it for
// its tile plus a one-pixel halo into shared memory, sets every position of
// it that lies outside the image to 0 (the second conv's 'SAME' padding sees
// zeros there, not conv1 evaluated on padding), and runs the second conv as
// its four sub-pixel phase products from that tile, each phase written
// straight to (2i+a, 2j+b).
//
// What bounds it on an H100: float32 operations, as the two kernels it fuses
// (ops/conv.py).  It saves the write and the read of c1 and pays for it with
// conv1 recomputed on the halo.
//
// Shape of a block: 8 warps; a lane is one column of the c1 tile, which is
// 32 columns wide, so the tile makes 30 columns of the input's resolution
// (60 of the output's).  Phase A (conv1) is the tile of conv_tile.cuh: a
// warp owns 16 of the cmid channels and 4 rows, the input channels stream
// through shared memory 8 at a time with cp.async, zero-filled outside the
// image.  With cgA = ceil(cmid / 16) channel groups there are 8 / cgA row
// groups, so the c1 tile has R1 = 4 * (8 / cgA) rows and the block makes
// TH = R1 - 2 rows: 14 at 32 channels, 6 at 48 and 64.  Phase B (conv2) reads
// c1 from shared memory; a warp owns 16 of the cout channels and 2 rows of
// one phase, and walks over the phases and, where 8 warps do not cover the
// tile at once, over batches of rows; the phase's weights stream through
// shared memory 16 mid channels at a time.  PixelNorm's sum over channels
// crosses the warps of a pixel through shared memory, once in each phase.
#include "conv_tile.cuh"

namespace mg {

constexpr int BLK_WARPS = 8;
constexpr int BLK_TW = 30;          // columns of the input's resolution a block makes
constexpr int BLK_C1W = BLK_TW + 2; // the c1 tile's width: one lane a column
constexpr int BLK_INW = BLK_TW + 4; // the input tile's width
constexpr int BLK_RA = 4;           // c1 rows a thread makes
constexpr int BLK_RB = 2;           // output rows (of one phase) a thread makes in a pass
constexpr int BLK_CK1 = 8;          // input channels staged at a time (conv1)
constexpr int BLK_CK2 = 16;         // mid channels of weights staged at a time (conv2)
// Widest conv1 and conv2: PixelNorm reduces inside one block, eight warps
// of 16 channels.
constexpr int BLK_MAX_C = BLK_WARPS * CO;

// The tile for the widths: rows of c1, and the shared memory in floats.
struct BlockTile {
  int cgA, rgA, r1, th, cgB, rgB;
  size_t smem_floats;
};

inline bool block_tile(int cmid, int cout, BlockTile* t) {
  if (cmid < 1 || cout < 1 || cmid > BLK_MAX_C || cout > BLK_MAX_C)
    return false;
  t->cgA = ceil_div(cmid, CO);
  t->rgA = BLK_WARPS / t->cgA;
  t->r1 = BLK_RA * t->rgA;
  t->th = t->r1 - 2;
  t->cgB = ceil_div(cout, CO);
  t->rgB = BLK_WARPS / t->cgB;
  const size_t c1 = (size_t)t->cgA * CO * t->r1 * BLK_C1W;
  const size_t stage_a =
      (size_t)BLK_CK1 * (t->r1 + 2) * BLK_INW + 9 * BLK_CK1 * t->cgA * CO;
  const size_t stage_b =
      (size_t)4 * BLK_CK2 * t->cgB * CO + (size_t)t->cgB * t->rgB * BLK_RB * 32;
  t->smem_floats = c1 + (stage_a > stage_b ? stage_a : stage_b);
  return true;
}

// x: (B, cin, H, W); w1: (cin, 9, cmidp), ops/conv.py::kernel_weights, taps
// (dy, dx), the mid channel fastest and zero past cmid; b1: (cmid,); w2: (4,
// cmid, 4, coutp), kernel_upconv_weights: the four sub-pixel phase kernels
// laid out alike; b2: (cout,); y: (B, cout, 2H, 2W).  cmidp and coutp are
// cmid and cout rounded up to 16, so a (channel, tap) run of weights is
// staged with 16-byte copies.
__global__ void __launch_bounds__(32 * BLK_WARPS, 2)
block3x3_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ y,
                int cin, int cmid, int cout, int H, int W, float slope, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int cgA = (cmid + CO - 1) / CO, rgA = BLK_WARPS / cgA;
  const int cmidp = cgA * CO;
  const int R1 = BLK_RA * rgA, TH = R1 - 2;
  const int c0 = blockIdx.x * BLK_TW, r0 = blockIdx.y * TH, b = blockIdx.z;
  float* c1_s = smem;                         // [cmidp][R1][32], row 0 = image row r0-1
  float* stage = smem + cmidp * R1 * BLK_C1W; // staging, then the reductions

  // ---- phase A: conv1 + bias + LeakyReLU + PixelNorm into c1_s ----------
  {
    const bool active = wid < cgA * rgA;
    const int cgi = wid % cgA;
    const int rbase = active ? (wid / cgA) * BLK_RA : 0;
    const int SH = R1 + 2, SW = BLK_INW;
    const float* xb = x + (size_t)b * cin * H * W;
    float* in_s = stage;                     // [CK1][SH][SW], row 0 = image row r0-2
    float* w_s = stage + BLK_CK1 * SH * SW;  // [9][CK1][cmidp]

    float acc[BLK_RA][CO];
#pragma unroll
    for (int p = 0; p < BLK_RA; ++p)
#pragma unroll
      for (int k = 0; k < CO; ++k) acc[p][k] = 0.f;

    for (int ci0 = 0; ci0 < cin; ci0 += BLK_CK1) {
      for (int e = threadIdx.x; e < SH * SW; e += blockDim.x) {
        const int rl = e / SW, gr = r0 - 2 + rl, gc = c0 - 2 + (e - rl * SW);
        const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
        const float* src = xb + (inside ? (size_t)gr * W + gc : 0);
#pragma unroll
        for (int ci = 0; ci < BLK_CK1; ++ci) {
          const bool ok = inside && ci0 + ci < cin;
          cp_async4(in_s + ci * SH * SW + e, ok ? src + (size_t)(ci0 + ci) * H * W : xb, ok);
        }
      }
      for (int i = threadIdx.x; i < (cmidp / 4) * 9 * BLK_CK1; i += blockDim.x) {
        const int j4 = i % (cmidp / 4), t = i / (cmidp / 4), cil = t % BLK_CK1, tap = t / BLK_CK1;
        const int c = ci0 + cil;
        const bool ok = c < cin;
        cp_async16(w_s + (tap * BLK_CK1 + cil) * cmidp + 4 * j4,
                   ok ? w1 + ((size_t)c * 9 + tap) * cmidp + 4 * j4 : w1, ok);
      }
      cp_async_wait_all();
      __syncthreads();
      if (active) {
#pragma unroll 2
        for (int ci = 0; ci < BLK_CK1; ++ci) {
          const float* src = in_s + (ci * SH + rbase) * SW + lane;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            float v[BLK_RA + 2];
#pragma unroll
            for (int j = 0; j < BLK_RA + 2; ++j) v[j] = src[j * SW + dx];
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              const float4* wv = reinterpret_cast<const float4*>(
                  w_s + ((dy * 3 + dx) * BLK_CK1 + ci) * cmidp + cgi * CO);
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
              for (int p = 0; p < BLK_RA; ++p)
#pragma unroll
                for (int k = 0; k < CO; ++k)
                  acc[p][k] = fmaf(v[p + dy], wr[k], acc[p][k]);
            }
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int k = 0; k < CO; ++k) {
      const int co = cgi * CO + k;
      const float bk = co < cmid ? b1[co] : 0.f;
#pragma unroll
      for (int p = 0; p < BLK_RA; ++p) {
        const float u = acc[p][k] + bk;
        acc[p][k] = u >= 0.f ? u : slope * u;
      }
    }
    float* red = stage;  // [cgA][R1][32]; the loop's last barrier released the staging
    if (active) {
#pragma unroll
      for (int p = 0; p < BLK_RA; ++p) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < CO; ++k) s = fmaf(acc[p][k], acc[p][k], s);
        red[(cgi * R1 + rbase + p) * 32 + lane] = s;
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int p = 0; p < BLK_RA; ++p) {
        float s = 0.f;
        for (int g = 0; g < cgA; ++g) s += red[(g * R1 + rbase + p) * 32 + lane];
        const float scale = rsqrtf(s / (float)cmid + eps);
        // Outside the image c1 is the second conv's zero padding.
        const int gr = r0 - 1 + rbase + p, gc = c0 - 1 + lane;
        const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
#pragma unroll
        for (int k = 0; k < CO; ++k) {
          const int co = cgi * CO + k;
          c1_s[(co * R1 + rbase + p) * BLK_C1W + lane] =
              (inside && co < cmid) ? acc[p][k] * scale : 0.f;
        }
      }
    }
    __syncthreads();
  }

  // ---- phase B: the four phase products of conv2 from c1_s -------------
  const int cgB = (cout + CO - 1) / CO, rgB = BLK_WARPS / cgB;
  const int coutp = cgB * CO;
  const bool active = wid < cgB * rgB;
  const int cgi = wid % cgB, rgi = active ? wid / cgB : 0;
  const int colr = lane < BLK_TW ? lane : BLK_TW - 1;  // lanes 30, 31 repeat column 29
  const int rows_pass = rgB * BLK_RB;
  const int nbatch = (TH + rows_pass - 1) / rows_pass;
  float* w_s = stage;                        // [4][CK2][coutp]
  float* red = stage + 4 * BLK_CK2 * coutp;  // [cgB][rows_pass][32]
  const int Ho = 2 * H, Wo = 2 * W;

  for (int ph = 0; ph < 4; ++ph) {
    const int pa = ph >> 1, pb = ph & 1;
    const float* wp = w2 + (size_t)ph * cmid * 4 * coutp;
    for (int rb = 0; rb < nbatch; ++rb) {
      const int row = rb * rows_pass + rgi * BLK_RB;       // first row of this thread
      const int rowr = row < TH - BLK_RB ? row : TH - BLK_RB;  // rows past the tile repeat its last
      float acc[BLK_RB][CO];
#pragma unroll
      for (int p = 0; p < BLK_RB; ++p)
#pragma unroll
        for (int k = 0; k < CO; ++k) acc[p][k] = 0.f;

      for (int ci0 = 0; ci0 < cmidp; ci0 += BLK_CK2) {
        for (int i = threadIdx.x; i < (coutp / 4) * 4 * BLK_CK2; i += blockDim.x) {
          const int j4 = i % (coutp / 4), t = i / (coutp / 4), cil = t % BLK_CK2, tap = t / BLK_CK2;
          const int c = ci0 + cil;
          const bool ok = c < cmid;
          cp_async16(w_s + (tap * BLK_CK2 + cil) * coutp + 4 * j4,
                     ok ? wp + ((size_t)c * 4 + tap) * coutp + 4 * j4 : wp, ok);
        }
        cp_async_wait_all();
        __syncthreads();
        if (active) {
#pragma unroll 2
          for (int ci = 0; ci < BLK_CK2; ++ci) {
            const float* src = c1_s + ((ci0 + ci) * R1 + rowr + pa) * BLK_C1W + colr + pb;
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
              float v[BLK_RB + 1];
#pragma unroll
              for (int j = 0; j < BLK_RB + 1; ++j) v[j] = src[j * BLK_C1W + dx];
#pragma unroll
              for (int dy = 0; dy < 2; ++dy) {
                const float4* wv = reinterpret_cast<const float4*>(
                    w_s + ((dy * 2 + dx) * BLK_CK2 + ci) * coutp + cgi * CO);
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
                for (int p = 0; p < BLK_RB; ++p)
#pragma unroll
                  for (int k = 0; k < CO; ++k)
                    acc[p][k] = fmaf(v[p + dy], wr[k], acc[p][k]);
              }
            }
          }
        }
        __syncthreads();
      }

#pragma unroll
      for (int k = 0; k < CO; ++k) {
        const int co = cgi * CO + k;
        const float bk = co < cout ? b2[co] : 0.f;
#pragma unroll
        for (int p = 0; p < BLK_RB; ++p) {
          const float u = acc[p][k] + bk;
          acc[p][k] = u >= 0.f ? u : slope * u;
        }
      }
      if (active) {
#pragma unroll
        for (int p = 0; p < BLK_RB; ++p) {
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < CO; ++k) s = fmaf(acc[p][k], acc[p][k], s);
          red[(cgi * rows_pass + rgi * BLK_RB + p) * 32 + lane] = s;
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int p = 0; p < BLK_RB; ++p) {
          float s = 0.f;
          for (int g = 0; g < cgB; ++g) s += red[(g * rows_pass + rgi * BLK_RB + p) * 32 + lane];
          const float scale = rsqrtf(s / (float)cout + eps);
          const int r = r0 + row + p, c = c0 + lane;
          if (row + p >= TH || r >= H || lane >= BLK_TW || c >= W) continue;
          const size_t pix = (size_t)(2 * r + pa) * Wo + 2 * c + pb;
#pragma unroll
          for (int k = 0; k < CO; ++k) {
            const int co = cgi * CO + k;
            if (co < cout) y[((size_t)b * cout + co) * Ho * Wo + pix] = acc[p][k] * scale;
          }
        }
      }
      // The next pass writes `red` only after the barriers of its staging
      // loop, which every read above has passed by then.
    }
  }
}

}  // namespace mg

// Shared memory in bytes that a block needs at these widths (0: widths the
// kernel does not take), and the rows of the input's resolution it makes.
extern "C" int mg_block3x3_tile(int cmid, int cout, int* rows) {
  mg::BlockTile t;
  if (!mg::block_tile(cmid, cout, &t)) return 0;
  if (rows != nullptr) *rows = t.th;
  return (int)(t.smem_floats * sizeof(float));
}

extern "C" int mg_block3x3(const float* x, const float* w1, const float* b1,
                           const float* w2, const float* b2, float* y, int B, int cin,
                           int cmid, int cout, int H, int W, float slope, float eps,
                           cudaStream_t stream) {
  using namespace mg;
  if (B < 1 || cin < 1 || H < 1 || W < 1 || b1 == nullptr || b2 == nullptr)
    return (int)cudaErrorInvalidValue;
  BlockTile t;
  if (!block_tile(cmid, cout, &t)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const DeviceInfo* info = nullptr;
  const int err = current_device(&dev, &info);
  if (err != 0) return err;
  const size_t smem = t.smem_floats * sizeof(float);
  if (smem > (size_t)info->smem_optin) return (int)cudaErrorInvalidValue;
  const dim3 block(32 * BLK_WARPS);
  const dim3 grid(ceil_div(W, BLK_TW), ceil_div(H, t.th), B);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  // Above 48 KB a kernel gets dynamic shared memory by request only: once
  // on each device.
  static bool opted_in[MAX_DEVICES] = {};
  if (!opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        block3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, info->smem_optin);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  block3x3_kernel<<<grid, block, smem, stream>>>(x, w1, b1, w2, b2, y, cin, cmid, cout, H,
                                                 W, slope, eps);
  return (int)cudaGetLastError();
}
