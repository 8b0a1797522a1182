// K5: inverse STFT in one launch, from the spectra to the trimmed signal,
// float32.  Replaces musicgan_tpu/ops/istft_pallas.py::istft_fused (Pallas
// kernel from _kernel_factory), which on the TPU is an iDFT written as a
// matrix product (the MXU was its only fast unit: 2 * 2 * r * n_bins = 8,208
// FLOP an output sample at n_fft 1024) with the COLA division and the trim
// left to XLA.
//
// What bounds it on an H100: bytes.  The function reads the spectra once
// (2 * n_bins * T floats a clip) and writes the signal once ((T - 1) * hop
// floats); at the synthesis shape, (5, 513, 5120) -> (5, 1,310,464), that is
// 131 MB, 0.04 ms at 3.35 TB/s.  A 1,024-point real inverse FFT costs about
// 25k FLOP a frame, 0.66 GFLOP in all, 0.01 ms at 67 TFLOP/s; the matrix iDFT
// would cost 40 times that.  So each frame is transformed by an FFT held in
// shared memory, and nothing but the spectra and the signal touches device
// memory.
//
// The kernel is templated on the transform: n_fft = 2M, M = 2^LOGM, n_fft
// from 16 to 4096 (and on hop = n_fft, whose centring pad is half a hop).  A block owns FR consecutive frames of one clip (32 up to
// n_fft 1024, then as many as 131 KB of shared memory hold) and makes the
// FR - (r - 1) output hops that those frames complete (r = n_fft / hop < FR;
// one hop fewer at r = 1, whose centring pad is half a hop): the
// frames of halo are transformed again by the neighbouring block, never
// shared, so no two blocks write one sample and there are no atomics.
//   1. Load.  Thread (s, f) (frame f = tid % FR) reads bins k and M - k of
//      frame f for k = s, s + P, ... (P = 512 / FR threads a frame): the
//      lanes of a warp read consecutive frames of one bin, coalesced in the
//      (B, n_bins, T) layout.  In registers the pair is packed for a
//      half-length complex transform (the even/odd split of a real inverse
//      FFT: Z_k = S + i E, Z_{M-k} = conj(S) + i conj(E), S = X_k +
//      conj(X_{M-k}), E = w^k (X_k - conj(X_{M-k}))), and stored to shared
//      memory as [bin][frame] complex values.  The DC and Nyquist bins'
//      imaginary parts are dropped, as an inverse real FFT (and the plain
//      version's iDFT bases) drop them.
//   2. Transform.  An M-point complex inverse FFT, decimation in frequency,
//      in place: a radix-2 or radix-4 pass where log2(M) is no multiple of
//      3, then radix-8 passes, each a DFT in registers times the twiddles of
//      a float64 table; each pass stores its outputs in bit-reversed slots,
//      so the transform ends in bit-reversed order.  A warp's shared-memory
//      accesses are runs of consecutive frames: no pass has a bank conflict.
//   3. The last radix-8 pass writes the frame in the time domain, times the
//      Hann window, the normalized scale and 1/n_fft (one float64 table), as
//      [frame][sample] rows padded to n_fft + 2 floats.
//   4. Epilogue.  Each output sample is the sum of its r frame slices in the
//      plain version's order (slice 0 first), times the inverse COLA
//      envelope (a float64 table keyed by the first and last slice present,
//      so the first and last hops get the partial sums), with the n_fft / 2
//      centring pad dropped: only the (T - 1) * hop samples of the output are
//      written, consecutive threads on consecutive samples.
// Shared memory: FR * (n_fft + 2) * 4 bytes a block (131,328 at n_fft 1024),
// one block of 512 threads an SM.
//
// Every other length the TPU kernel takes (n_fft % hop == 0, any n_fft) goes
// to a second kernel, istft_dft_kernel: the windowed iDFT as a product with
// the bases WC, WS (n_bins, n_fft), the window and the normalized scale
// folded in, summed over the r = n_fft / hop frame slices of each hop:
//
//   ola[b, q, h] = sum_{j<r} sum_f ( re[b, f, q-j] * WC[f, j*hop + h]
//                                  + im[b, f, q-j] * WS[f, j*hop + h] )
//
// (re, im zero outside [0, T)), tiled like a GEMM: a block owns 64 hops x
// 128 samples of a hop and loops over (j, re/im, f), so the (T, n_fft) frame
// matrix never reaches device memory.  Its epilogue divides by the window-
// square envelope (summed over the slices present, in slice order, clamped
// at 1e-11) and writes only the samples left after the n_fft / 2 centring
// trim.  2 * 2 * r * n_bins FLOP an output sample: bound by float32
// operations, a simple kernel for lengths no path of the repo runs.
#include "common.cuh"

namespace {

constexpr int NT = 512;  // threads a block

// The sizes of the transform of M = 2^LOGM complex points (n_fft = 2M).
template <int LOGM>
struct Shape {
  static constexpr int M = 1 << LOGM;
  static constexpr int NFFT = 2 * M;
  static constexpr int NB = M + 1;                     // bins
  static constexpr int FR = M <= 512 ? 32 : 16384 / M; // frames a block transforms
  static constexpr int P = NT / FR;                    // threads a frame
  static constexpr int TROW = NFFT + 2;                // floats a time-domain row holds
  // [M][FR] complex values, then over them [FR][TROW] floats.
  static constexpr int SMEM_BYTES = FR * TROW * 4 > M * FR * 8 ? FR * TROW * 4 : M * FR * 8;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 times_i(float2 a) { return make_float2(-a.y, a.x); }

// R-point DFTs with a positive exponent, in registers, natural order out:
// a[p] <- sum_m a[m] exp(2 pi i m p / R).
__device__ __forceinline__ void dft(float2 (&a)[2]) {
  const float2 t = a[0];
  a[0] = cadd(t, a[1]);
  a[1] = csub(t, a[1]);
}

__device__ __forceinline__ void dft(float2 (&a)[4]) {
  const float2 c0 = cadd(a[0], a[2]), c1 = csub(a[0], a[2]);
  const float2 d0 = cadd(a[1], a[3]), d1 = times_i(csub(a[1], a[3]));
  a[0] = cadd(c0, d0);
  a[1] = cadd(c1, d1);
  a[2] = csub(c0, d0);
  a[3] = csub(c1, d1);
}

__device__ __forceinline__ void dft(float2 (&a)[8]) {
  const float h = 0.70710678118654752f;
  float2 c[8];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    c[m] = cadd(a[m], a[m + 4]);
    c[m + 4] = csub(a[m], a[m + 4]);
  }
  c[5] = make_float2(h * (c[5].x - c[5].y), h * (c[5].x + c[5].y));   // * w8
  c[6] = times_i(c[6]);                                               // * i
  c[7] = make_float2(-h * (c[7].x + c[7].y), h * (c[7].x - c[7].y));  // * w8^3
  float2 d[8];
#pragma unroll
  for (int q = 0; q < 8; q += 4) {
    d[q] = cadd(c[q], c[q + 2]);
    d[q + 2] = csub(c[q], c[q + 2]);
    d[q + 1] = cadd(c[q + 1], c[q + 3]);
    d[q + 3] = times_i(csub(c[q + 1], c[q + 3]));
  }
  a[0] = cadd(d[0], d[1]);
  a[4] = csub(d[0], d[1]);
  a[2] = cadd(d[2], d[3]);
  a[6] = csub(d[2], d[3]);
  a[1] = cadd(d[4], d[5]);
  a[5] = csub(d[4], d[5]);
  a[3] = cadd(d[6], d[7]);
  a[7] = csub(d[6], d[7]);
}

// p with its log2(R) bits reversed.
template <int R>
__device__ __forceinline__ int bit_reverse(int p) {
  if constexpr (R == 2) return p;
  if constexpr (R == 4) return ((p & 1) << 1) | (p >> 1);
  return ((p & 1) << 2) | (p & 2) | (p >> 2);
}

// One in-place radix-R pass over the groups {base + g + SPAN * m}: the
// R-point DFT, the twiddles w_(R SPAN)^(g p), output p stored in slot
// bit_reverse(p).  With every pass so, the transform ends in bit-reversed
// order whatever the mix of radices.
template <int LOGM, int R, int SPAN>
__device__ __forceinline__ void fft_pass(float2* zs, const float2* __restrict__ tw, int s,
                                         int f) {
  using S = Shape<LOGM>;
  constexpr int NG = S::M / R, STEP = S::NFFT / (R * SPAN);
#pragma unroll
  for (int j = 0; j < (NG + S::P - 1) / S::P; ++j) {
    const int grp = s + S::P * j;
    if (NG % S::P != 0 && grp >= NG) break;
    const int base = (grp / SPAN) * (R * SPAN), g = grp % SPAN;
    float2 a[R];
#pragma unroll
    for (int m = 0; m < R; ++m) a[m] = zs[(base + g + SPAN * m) * S::FR + f];
    dft(a);
#pragma unroll
    for (int p = 0; p < R; ++p) {
      const float2 v = p == 0 ? a[0] : cmul(a[p], __ldg(tw + g * p * STEP));
      zs[(base + g + SPAN * bit_reverse<R>(p)) * S::FR + f] = v;
    }
  }
}

// The radix-8 passes on spans SPAN, SPAN / 8, ..., 8.
template <int LOGM, int SPAN>
__device__ __forceinline__ void radix8_passes(float2* zs, const float2* __restrict__ tw, int s,
                                              int f) {
  if constexpr (SPAN >= 8) {
    fft_pass<LOGM, 8, SPAN>(zs, tw, s, f);
    __syncthreads();
    radix8_passes<LOGM, SPAN / 8>(zs, tw, s, f);
  }
}

template <int LOGM, bool HALF>
__global__ void __launch_bounds__(NT, 1)
istft_kernel(const float* __restrict__ re, const float* __restrict__ im,
             const float2* __restrict__ tw, const float* __restrict__ gwin,
             const float* __restrict__ inv_env, float* __restrict__ out, int T, int hop,
             int r, int tb) {
  using S = Shape<LOGM>;
  constexpr int M = S::M, FR = S::FR, P = S::P;
  extern __shared__ float4 smem4[];
  float2* zs = reinterpret_cast<float2*>(smem4);  // [M][FR] complex, steps 1-2
  float* ts = reinterpret_cast<float*>(smem4);    // [FR][TROW] real, steps 3-4
  const int f = threadIdx.x % FR, s = threadIdx.x / FR;  // this thread's frame, sub-index
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * tb;  // first output hop of the tile
  // The centring pad, M samples, is mh hops and off samples: r / 2 hops,
  // or half a hop where HALF (r = 1).  Left to run time (M / hop), the
  // kernel gave the same bits and took a fifth longer on an H100: its
  // compiled schedule changed.  The tile reads frames t0 .. t0 + FR - 1.
  const int mh = HALF ? 0 : r / 2, off = HALF ? hop / 2 : 0;
  const int t0 = q0 + mh - (r - 1);
  const int t = t0 + f;
  const bool tv = t >= 0 && t < T;
  const size_t clip = (size_t)b * S::NB * T;
  const float* rb = re + clip + (tv ? t : 0);
  const float* ib = im + clip + (tv ? t : 0);

  // 1. Load and pack: pairs (k, M - k), k = s, s + P, ..., M / 2.
  {
    constexpr int NL = (M / 2) / P + 1;
    float v[NL][4];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int k = s + P * i;
      const bool ok = tv && k <= M / 2;
      v[i][0] = ok ? __ldg(rb + (size_t)k * T) : 0.f;
      v[i][1] = ok && k != 0 ? __ldg(ib + (size_t)k * T) : 0.f;
      v[i][2] = ok ? __ldg(rb + (size_t)(M - k) * T) : 0.f;
      v[i][3] = ok && k != 0 ? __ldg(ib + (size_t)(M - k) * T) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int k = s + P * i;
      if (k > M / 2) continue;
      const float2 Sk = make_float2(v[i][0] + v[i][2], v[i][1] - v[i][3]);
      const float2 D = make_float2(v[i][0] - v[i][2], v[i][1] + v[i][3]);
      const float2 E = cmul(__ldg(tw + k), D);
      zs[k * FR + f] = make_float2(Sk.x - E.y, Sk.y + E.x);
      if (k != 0 && k != M / 2) zs[(M - k) * FR + f] = make_float2(Sk.x + E.y, E.x - Sk.y);
    }
  }
  __syncthreads();

  // 2. The M-point inverse FFT but its last pass, in place: a radix-2 or
  // radix-4 pass where log2(M) is no multiple of 3, then radix-8 passes.
  constexpr int R0 = 1 << (LOGM % 3);
  if constexpr (R0 > 1) {
    fft_pass<LOGM, R0, M / R0>(zs, tw, s, f);
    __syncthreads();
  }
  radix8_passes<LOGM, M / R0 / 8>(zs, tw, s, f);

  // 3. The last pass (radix 8 on span 1, no twiddles) into registers; then,
  // once every thread has read, out to the time-domain rows, windowed.
  // Position n of the transform holds z[bit_reverse(n)], and z[n] =
  // x[2n] + i x[2n + 1], so output p of group c is z[p M / 8 + rev(c)].
  {
    constexpr int NG = M / 8, NJ = (NG + P - 1) / P;
    float2 a[NJ][8];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = s + P * j;
      if (c >= NG) continue;
#pragma unroll
      for (int m = 0; m < 8; ++m) a[j][m] = zs[(8 * c + m) * FR + f];
      dft(a[j]);
    }
    __syncthreads();
    float* row = ts + f * S::TROW;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = s + P * j;
      if (c >= NG) continue;
      int rc = 0;
      if constexpr (LOGM > 3) rc = (int)(__brev((unsigned)c) >> (35 - LOGM));
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int n = p * NG + rc;
        const float2 g = __ldg(reinterpret_cast<const float2*>(gwin) + n);
        *reinterpret_cast<float2*>(row + 2 * n) = make_float2(a[j][p].x * g.x, a[j][p].y * g.y);
      }
    }
  }
  __syncthreads();

  // 4. Overlap-add, COLA, trim.  Output sample q0 * hop + i is sample
  // q0 * hop + i + M of the padded signal: offset h of padded hop qp =
  // q0 + mh + ql, whose slice j comes from frame qp - j, local row
  // ql + r - 1 - j.
  const int nq = min(tb, T - 1 - q0);
  float* ob = out + (size_t)b * (T - 1) * hop + (size_t)q0 * hop;
  for (int i = threadIdx.x; i < nq * hop; i += NT) {
    const int ql = (i + off) / hop, h = i + off - ql * hop;
    const int qp = q0 + mh + ql;
    const int jlo = max(0, qp - T + 1), jhi = min(r - 1, qp);
    float acc = 0.f;
    for (int j = jlo; j <= jhi; ++j) acc += ts[(ql + r - 1 - j) * S::TROW + j * hop + h];
    ob[i] = acc * __ldg(inv_env + (jlo * r + jhi) * hop + h);
  }
}

template <int LOGM>
int launch_istft(const float* re, const float* im, const float* tw, const float* gwin,
                 const float* inv_env, float* out, int B, int n_bins, int T, int hop,
                 cudaStream_t stream) {
  using S = Shape<LOGM>;
  const int r = S::NFFT / hop;
  if (n_bins != S::NB || r < 1 || r >= S::FR) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  using Kernel = decltype(&istft_kernel<LOGM, false>);
  const Kernel kernels[2] = {istft_kernel<LOGM, false>, istft_kernel<LOGM, true>};
  static bool opted_in[64] = {};
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (S::SMEM_BYTES > 48 * 1024 && !opted_in[dev]) {
    for (const Kernel k : kernels) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
      if (e != cudaSuccess) return (int)e;
    }
    opted_in[dev] = true;
  }
  // The frames a tile of tb hops reads: tb + r - 1, and one more where the
  // centring pad is no whole number of hops (r = 1).
  const int tb = S::FR - (r - 1) - (S::M % hop != 0);
  const dim3 grid((T - 1 + tb - 1) / tb, B);
  kernels[r == 1]<<<grid, NT, S::SMEM_BYTES, stream>>>(
      re, im, reinterpret_cast<const float2*>(tw), gwin, inv_env, out, T, hop, r, tb);
  return (int)cudaGetLastError();
}

constexpr int DFT_BM = 64;   // hops q a block
constexpr int DFT_BN = 128;  // samples h of a hop a block
constexpr int DFT_BK = 16;   // bins a shared-memory step
constexpr int DFT_TM = 8;    // hops a thread
constexpr int DFT_TN = 4;    // samples a thread
constexpr int DFT_NT = (DFT_BM / DFT_TM) * (DFT_BN / DFT_TN);  // 256 threads

__global__ void __launch_bounds__(DFT_NT)
istft_dft_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 const float* __restrict__ wc, const float* __restrict__ ws,
                 const float* __restrict__ win2, float* __restrict__ out, int nb, int T, int n_fft,
                 int hop, int q_lo) {
  __shared__ __align__(16) float As[DFT_BK][DFT_BM];
  __shared__ __align__(16) float Bs[DFT_BK][DFT_BN];
  const int tid = threadIdx.x, tx = tid % (DFT_BN / DFT_TN), ty = tid / (DFT_BN / DFT_TN);
  const int n0 = blockIdx.x * DFT_BN, q0 = q_lo + blockIdx.y * DFT_BM, b = blockIdx.z;
  const int r = n_fft / hop;

  float acc[DFT_TM][DFT_TN];
#pragma unroll
  for (int i = 0; i < DFT_TM; ++i)
#pragma unroll
    for (int jj = 0; jj < DFT_TN; ++jj) acc[i][jj] = 0.f;

  for (int j = 0; j < r; ++j) {
    for (int part = 0; part < 2; ++part) {
      const float* A = (part ? im : re) + (size_t)b * nb * T;
      const float* Bm = (part ? ws : wc) + (size_t)j * hop;
      for (int f0 = 0; f0 < nb; f0 += DFT_BK) {
        for (int i = tid; i < DFT_BK * DFT_BM; i += DFT_NT) {
          const int m = i % DFT_BM, f = f0 + i / DFT_BM, t = q0 + m - j;
          const bool ok = f < nb && t >= 0 && t < T;
          cp_async4(&As[i / DFT_BM][m], ok ? A + (size_t)f * T + t : A, ok);
        }
        for (int i = tid; i < DFT_BK * DFT_BN; i += DFT_NT) {
          const int n = i % DFT_BN, f = f0 + i / DFT_BN;
          const bool ok = f < nb && n0 + n < hop;
          cp_async4(&Bs[i / DFT_BN][n], ok ? Bm + (size_t)f * n_fft + n0 + n : Bm, ok);
        }
        cp_async_wait_all();
        __syncthreads();
#pragma unroll
        for (int k = 0; k < DFT_BK; ++k) {
          const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * DFT_TM]);
          const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * DFT_TM + 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * DFT_TN]);
          const float a[DFT_TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[DFT_TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
          for (int i = 0; i < DFT_TM; ++i)
#pragma unroll
            for (int jj = 0; jj < DFT_TN; ++jj) acc[i][jj] = fmaf(a[i], bv[jj], acc[i][jj]);
        }
        __syncthreads();
      }
    }
  }

  // COLA and the trim: sample n = q * hop + h - n_fft / 2 of the signal.
  const long len = (long)(T - 1) * hop;
#pragma unroll
  for (int i = 0; i < DFT_TM; ++i) {
    const int q = q0 + ty * DFT_TM + i;
#pragma unroll
    for (int jj = 0; jj < DFT_TN; ++jj) {
      const int h = n0 + tx * DFT_TN + jj;
      const long n = (long)q * hop + h - n_fft / 2;
      if (h >= hop || n < 0 || n >= len) continue;
      float env = 0.f;
      for (int j = max(0, q - T + 1); j <= min(r - 1, q); ++j) env += win2[j * hop + h];
      out[(size_t)b * len + n] = acc[i][jj] / fmaxf(env, 1e-11f);
    }
  }
}

}  // namespace

// The second route, for every (n_fft, hop) with n_fft % hop == 0: re, im:
// (B, n_bins, T); wc, ws: (n_bins, n_fft), the iDFT bases times the window
// and the normalized scale; win2: (n_fft,) the window squared; out: (B, (T -
// 1) * hop).  T >= 2.
extern "C" int mg_istft_dft(const float* re, const float* im, const float* wc, const float* ws,
                            const float* win2, float* out, int B, int n_bins, int T, int n_fft,
                            int hop, cudaStream_t stream) {
  if (B < 1 || B > 65535 || T < 2 || hop < 1 || n_fft < 1 || n_fft % hop != 0 ||
      n_bins != n_fft / 2 + 1)
    return (int)cudaErrorInvalidValue;
  // The hops q whose samples survive the trim.
  const long pad = n_fft / 2, len = (long)(T - 1) * hop;
  const long q_lo = pad / hop, q_hi = (len + pad - 1) / hop;
  const long rows = q_hi - q_lo + 1;
  if ((rows + DFT_BM - 1) / DFT_BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((hop + DFT_BN - 1) / DFT_BN, (unsigned)((rows + DFT_BM - 1) / DFT_BM), B);
  istft_dft_kernel<<<grid, DFT_NT, 0, stream>>>(re, im, wc, ws, win2, out, n_bins, T, n_fft, hop,
                                                (int)q_lo);
  return (int)cudaGetLastError();
}

// re, im: (B, n_fft / 2 + 1, T); tw: (n_fft,) complex exp(2 pi i k / n_fft);
// gwin: (n_fft,) window * scale / n_fft; inv_env: (r, r, hop), 1 / the
// envelope summed over slices jlo..jhi; out: (B, (T - 1) * hop).  n_fft a
// power of two from 16 to 4096, hop = n_fft / r with r below the frames a
// block holds (mg_istft_frames), T >= 2.
extern "C" int mg_istft(const float* re, const float* im, const float* tw,
                        const float* gwin, const float* inv_env, float* out, int B,
                        int n_bins, int T, int n_fft, int hop, cudaStream_t stream) {
  if (B < 1 || B > 65535 || T < 2 || hop < 1 || n_fft % hop != 0 || n_fft < 2 ||
      (n_fft & (n_fft - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  switch (__builtin_ctz((unsigned)n_fft) - 1) {
#define MG_ISTFT(L) \
  case L: return launch_istft<L>(re, im, tw, gwin, inv_env, out, B, n_bins, T, hop, stream);
    MG_ISTFT(3) MG_ISTFT(4) MG_ISTFT(5) MG_ISTFT(6) MG_ISTFT(7) MG_ISTFT(8) MG_ISTFT(9)
    MG_ISTFT(10) MG_ISTFT(11)
#undef MG_ISTFT
    default: return (int)cudaErrorInvalidValue;
  }
}

// Frames a block of the kernel transforms at this n_fft (0 outside its
// domain): hop = n_fft / r needs r below it.
extern "C" int mg_istft_frames(int n_fft) {
  if (n_fft < 2 || (n_fft & (n_fft - 1)) != 0) return 0;
  switch (__builtin_ctz((unsigned)n_fft) - 1) {
#define MG_FRAMES(L) \
  case L: return Shape<L>::FR;
    MG_FRAMES(3) MG_FRAMES(4) MG_FRAMES(5) MG_FRAMES(6) MG_FRAMES(7) MG_FRAMES(8) MG_FRAMES(9)
    MG_FRAMES(10) MG_FRAMES(11)
#undef MG_FRAMES
    default: return 0;
  }
}
