// K5: inverse STFT frames + overlap-add in one kernel, float32.
// Replaces musicgan_tpu/ops/istft_pallas.py::istft_fused (Pallas kernel from
// _kernel_factory).
//
// With r = n_fft / hop and the Hann window and normalisation folded into the
// iDFT bases WC, WS (n_bins, n_fft), the overlap-added signal is
//
//   out[b, q, h] = sum_{j<r} sum_f ( re[b, f, q-j] * WC[f, j*hop + h]
//                                  + im[b, f, q-j] * WS[f, j*hop + h] )
//
// for q < T + r - 1, h < hop, with re/im zero outside [0, T).  That is one
// product with K = r * 2 * n_bins over shifted rows, tiled like a GEMM: a
// block owns a dense (BM rows q) x (BN columns h) piece of the signal and
// loops over (j, re/im, f), so the (T, n_fft) frame matrix never reaches
// device memory.  The spectra are read in their (B, n_bins, T) layout, no
// transpose: a tile row is BM consecutive frames of one bin.
#include "common.cuh"

namespace {

constexpr int BM = 64;   // signal rows q per block
constexpr int BN = 128;  // signal columns h per block
constexpr int BK = 16;   // frequency bins per shared-memory step
constexpr int TM = 8;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads

__global__ void __launch_bounds__(NT)
istft_ola_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 const float* __restrict__ wc, const float* __restrict__ ws,
                 float* __restrict__ out, int nb, int T, int hop, int r) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int n0 = blockIdx.x * BN, q0 = blockIdx.y * BM, b = blockIdx.z;
  const int n_fft = r * hop, rows = T + r - 1;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;

  for (int j = 0; j < r; ++j) {
    for (int part = 0; part < 2; ++part) {
      const float* A = (part ? im : re) + (size_t)b * nb * T;
      const float* Bm = (part ? ws : wc) + j * hop;
      for (int f0 = 0; f0 < nb; f0 += BK) {
        for (int i = tid; i < BK * BM; i += NT) {
          const int m = i % BM, f = f0 + i / BM, t = q0 + m - j;
          const bool ok = f < nb && t >= 0 && t < T;
          cp_async4(&As[i / BM][m], ok ? A + (size_t)f * T + t : A, ok);
        }
        for (int i = tid; i < BK * BN; i += NT) {
          const int n = i % BN, f = f0 + i / BN;
          const bool ok = f < nb && n0 + n < hop;
          cp_async4(&Bs[i / BN][n], ok ? Bm + (size_t)f * n_fft + n0 + n : Bm, ok);
        }
        cp_async_wait_all();
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
          const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
          const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int jj = 0; jj < TN; ++jj) acc[i][jj] = fmaf(a[i], bv[jj], acc[i][jj]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q = q0 + ty * TM + i;
    if (q >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int h = n0 + tx * TN + jj;
      if (h < hop) out[((size_t)b * rows + q) * hop + h] = acc[i][jj];
    }
  }
}

}  // namespace

// re, im: (B, nb, T); wc, ws: (nb, r*hop); out: (B, T + r - 1, hop).
extern "C" int mg_istft_ola(const float* re, const float* im, const float* wc,
                            const float* ws, float* out, int B, int nb, int T,
                            int hop, int r, cudaStream_t stream) {
  if (B < 1 || nb < 1 || T < 1 || hop < 1 || r < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((hop + BN - 1) / BN, (T + r - 1 + BM - 1) / BM, B);
  istft_ola_kernel<<<grid, NT, 0, stream>>>(re, im, wc, ws, out, nb, T, hop, r);
  return (int)cudaGetLastError();
}
