// K4 bf16: one whole generator block in one launch with bf16 activations,
// bf16 weights, c1 held in bf16 and a bf16 output (float32 bias,
// accumulation and epilogues):
//   c1 = PixelNorm(LeakyReLU(conv3x3(x) + b1))            (cin  -> cmid)
//   y  = PixelNorm(LeakyReLU(conv3x3(up2x(c1)) + b2))     (cmid -> cout, 2H x 2W)
// Replaces musicgan_tpu/ops/conv.py::fused_block (Pallas kernel
// _block_kernel, its c1 scratch of x.dtype and its packed-pair interleave)
// called with bf16 x and out_dtype=bfloat16.  Up to 128 channels (cmid and
// cout) one block holds a unit, instantiated in block3x3_bf16.cu; past them
// a cluster splits each conv's channels as K1 bf16 and K3 bf16 split them
// (CL below), in block3x3_bf16_wide.cu, except inputs too wide for its
// layout (kb_cluster_fits), which take block3x3.cuh at bf16
// (block3x3_bf16_template.cu).  With a float32 output (the JAX function's
// bf16 x and out_dtype=float32: c1 still bf16, the last epilogue stored
// unrounded): block3x3_bf16_f32.cu, block3x3_bf16_wide_f32.cu.
//
// What bounds it on an H100.  On paper its bytes: they are K3 bf16's alone
// (x in, y out, the weights; c1 never leaves the SM), and the products are
// below them (block 7 of synthesis: 114 GFLOP, 0.115 ms at 989 TFLOP/s,
// against 0.188 ms of bytes at 3.35 TB/s).  Measured, the latency of a
// warpgroup's chain of waits: a row is copies, a transposition, products,
// meetings and two epilogues in turn, and with the epilogues, stores and c1
// writes taken out block 7 still took most of its time (PERF.md).  So the
// design is conv_bf16.cuh's (K1 bf16 and K3 bf16), built from its pieces,
// with c1 kept on chip and each row's work done once, and as many
// warpgroups a block as the registers allow:
//
// - a warpgroup walks a strip of tc output columns (input resolution) down a
//   run of rows of one image; for each input row it lands and transposes
//   that row, then computes c1 row r (columns c0 - 1 .. c0 + tc: the strip
//   and its two halo columns), then, once c1 rows r - 2 .. r are there,
//   conv2's output row r - 1 (both row parities).  So each input row is
//   transposed and each c1 row computed once a run; only the two halo
//   columns ((tc + 2) / tc) and the run's two halo rows are done twice;
// - conv1 is K1 bf16's data path at one row a tile: an input row's chunk of
//   16 channels lands by TMA as [16 channels][rw = tc + 24] (image columns
//   c0 - 8 on: a box starts on 16 bytes), is transposed by ldmatrix.trans +
//   stmatrix into the chunk's ring of three input rows, [octet][3 slots x
//   sw][8 channels] (window column wc is image column c0 - 2 + wc), and
//   multiplied with both operands by descriptor, MB m64 blocks of positions
//   (output position p is c1 column c0 - 1 + p), kernel row dy reading the
//   slot of input row r - 1 + dy;
// - its epilogue (bias and LeakyReLU as conv_tile.cuh's, pn_sums, pn_scale)
//   rounds to bf16 once, as K1 bf16 stores c1, and writes c1 by stmatrix
//   (not .trans) straight into conv2's operand layout: a ring of three c1
//   rows a chunk of 16 mid channels, [chunk][octet][3 slots x 64 MB
//   positions + 8][8 channels], ring column p being c1 column c0 - 1 + p,
//   zero outside the image (conv2's 'SAME' padding sees zeros there, not
//   conv1 of the padding).  conv2 then needs no copy and no
//   transposition: its A operand of phase (oy, ox), tap (dy, dx) is the
//   slot of c1 row R - 1 + oy + dy from column ox + dx on, by descriptor;
// - conv2 is K3 bf16's products and epilogue at one row a tile, all four
//   phases a pass or two passes of two (kb_pp2), its outputs staged by
//   cb::stage_out (stmatrix.trans) and stored as 32-byte runs of both
//   column phases of an output row interleaved (the layout the JAX kernel's
//   packed-pair interleave exists for);
// - the weights (the packs of K1 bf16 and K3 bf16, ops/conv_bf16.py::
//   tc_weights) stay resident for the launch where they fit beside the
//   stages and the rings, each conv's copied once by one bulk copy;
//   otherwise a chunk's taps come by a bulk copy of their own;
// - two or three warpgroups a block (kb_wgmax), each walking its own units,
//   with no producer warpgroup: a warpgroup's first thread issues the
//   copies of its item q + stages into the slot item q frees, on that
//   slot's mbarrier (items: each input row's chunks, and each chunk's
//   weights where they stream);
// - the size rule (plan_kb, mirrored by ops/conv_bf16.py::block_plan) from
//   the sizes and the SM count only: the m64 blocks from the channel
//   counts, the strip width, run length, residency and warpgroups of least
//   modelled time, and whether K4 takes the block at all (its modelled time
//   below that of K1 bf16 then K3 bf16's plans; never over a cluster, see
//   plan_kb).
//
// Sum order: conv_bf16.cuh's (chunks of 16 channels in order; in a chunk the
// kernel rows in order, each row's taps into a fresh accumulator, added in
// float32), with the pair's channels a block (N1, N2 = cmid, cout rounded up
// to 16; past 128 the pair's splits, PixelNorm's sums in rank order), so K4
// bf16 gives K1 bf16 then K3 bf16's bits.
#pragma once

#include "conv_bf16.cuh"

namespace mg {
namespace kb {

using cb::bulk_load;
using cb::ldmatrix_x4_trans;
using cb::mbar_expect_tx;
using cb::mbar_init;
using cb::mbar_wait;
using cb::pack_bf16;
using cb::smem_u32;
using cb::stmatrix_x4;
using cb::tma_load_4d;

constexpr int MAX_N = 128;  // channels of either conv one block takes (no cluster)
constexpr int MAX_TC = 224; // widest strip: a TMA box of tc + 24 columns, at most 256
constexpr int MAX_CH = MAX_CLUSTER * MAX_N;  // channels of either conv a cluster takes

// m64 blocks of positions a row tile, from the registers a thread holds:
// conv1's sums and fresh sums, MB x N1 floats, at most 160; conv2's two
// phases' sums and one phase's fresh sums, 3 x MB x N2 / 2 floats, at most
// 160 (but at one block: N2 = 128 holds K3 bf16's 192); and at most two, so
// that two warpgroups' rings fit a block (at four, block 7 of synthesis held
// one warpgroup a block, spilled registers and took about twice the pair's
// time on an H100).
__host__ __device__ constexpr int mb1_max(int n1) { return 160 / n1 < 2 ? 160 / n1 : 2; }
__host__ __device__ constexpr int mb2_max(int n2) {
  return 320 / (3 * n2) < 1 ? 1 : 320 / (3 * n2) > 2 ? 2 : 320 / (3 * n2);
}
__host__ __device__ constexpr int kb_mb(int n1, int n2) {
  return mb1_max(n1) < mb2_max(n2) ? mb1_max(n1) : mb2_max(n2);
}
// Warpgroups a block: three (168 registers a thread) where a thread's sums
// fit in 64 floats with one of conv1's kernel rows and two of conv2's
// fresh sums in flight, else two.  At block 7 of synthesis (N1 32, N2 16)
// three took K4 below the pair on an H100 where two were above it: a
// warpgroup's row is a chain of waits (copies, products, meetings,
// epilogues) that two warpgroups do not hide.
__host__ __device__ constexpr int kb_wgmax(int n1, int n2) {
  return 2 * kb_mb(n1, n2) * n1 / 2 <= 64 && 4 * kb_mb(n1, n2) * n2 / 2 <= 64 ? 3 : 2;
}
// conv2's phases a pass: all four (one pass an output row, as K3 bf16 takes
// them up to 32 channels) where their sums and four fresh ones, 8 x MB x N2
// / 2 floats, fit in 160, else the two of one output row parity (two
// passes; always with three warpgroups).
__host__ __device__ constexpr int kb_pp2(int n1, int n2) {
  return kb_wgmax(n1, n2) == 2 && 8 * kb_mb(n1, n2) * n2 / 2 <= 160 ? 4 : 2;
}
// Products in flight between two waits: conv1's kernel rows, all three
// where their fresh sums and the tile's, (1 + 3) x MB x N1 / 2 floats, fit
// in 160, else one; conv2's (kernel row, phase) fresh sums: with four
// phases a pass the four phases of a kernel row, else the most of 4 (both
// rows and both phases), 2 (both rows) and 1 with (2 + F) x MB x N2 / 2
// floats in 160 (with three warpgroups one row and two).  Each fresh sum is
// added in kernel-row order after the wait, so the sums are the pair's
// whatever is in flight.
__host__ __device__ constexpr int kb_dy1(int n1, int n2) {
  return kb_wgmax(n1, n2) == 2 && 4 * kb_mb(n1, n2) * n1 / 2 <= 160 ? 3 : 1;
}
__host__ __device__ constexpr int kb_f2(int n1, int n2) {
  return kb_wgmax(n1, n2) == 3       ? 2
         : kb_pp2(n1, n2) == 4        ? 4
         : 6 * kb_mb(n1, n2) * n2 / 2 <= 160 ? 4
         : 4 * kb_mb(n1, n2) * n2 / 2 <= 160 ? 2
                                            : 1;
}

struct KbArgs {
  const bf16* x;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  void* y;  // of the kernel's output type O
  int B, cin, cmid, cout, H, W;
  int nch1, nch2, tc, sw, rw, ntx, run, nruns, nunits, nwg;
  int res1, res2, stages, tma, vec, pt1, pr1, ptr2, np;
  int cluster, nsplit1, nsplit2, nown;  // past 128 channels (CL): the ranks, each conv's splits, c1 chunks a rank
  int ss, gs;  // positions a c1 ring slot, output groups a channel staged (CL: from the strip, else 64 / 8 MB)
  uint32_t raw_bytes, stage_bytes, w1chunk_bytes, w2chunk_bytes, w1res_bytes, w2res_bytes;
  uint32_t wg_off, wg_bytes, region_off, ring_off, in_off, bias_off, part_off, bar_off;
  float slope, eps;
};

// A warpgroup's walk: unit u (image, strip, run of rows), and in it the
// items whose copies the warpgroup's first thread issues: for each input
// row k = 0 .. rows + 3 (image row ra - 2 + k) its chunks' TMA rows (ph 0);
// from k = 2 on, c1 row k - 2's conv1 chunks' weights where w1 streams (ph
// 1); from k = 4 on, conv2's chunks of both passes where w2 streams (ph 2).
struct KbWalk {
  int u, b, c0, ra, rows;  // the unit (u: the warpgroup's k-th)
  int k, ph, oy, kc;       // the item
  __device__ bool valid(const KbArgs& a, int first, int slots) const { return first + u * slots < a.nunits; }
  __device__ void unit(const KbArgs& a, int first, int slots, int uu) {
    u = uu;
    k = ph = oy = kc = 0;
    const int g = first + u * slots;
    if (g >= a.nunits) return;
    const int tx = g % a.ntx, rest = g / a.ntx, rr = rest % a.nruns;
    b = rest / a.nruns;
    c0 = tx * a.tc;
    ra = rr * a.run;
    rows = min(a.run, a.H - ra);
  }
  __device__ void next(const KbArgs& a, int first, int slots) {
    if (ph == 0) {
      if (++kc < a.nch1) return;
      kc = 0;
      if (k >= 2 && !a.res1) {
        ph = 1;
        return;
      }
    } else if (ph == 1) {
      if (++kc < a.nch1) return;
      kc = 0;
    } else {
      if (++kc < a.nch2) return;
      kc = 0;
      if (++oy < a.np) return;
      oy = 0;
    }
    if (ph != 2 && k >= 4 && !a.res2) {
      ph = 2;
      return;
    }
    ph = 0;
    if (++k < rows + 4) return;
    unit(a, first, slots, u + 1);
  }
};

// An input row's chunk of 16 channels into raw ([16 channels][rw], image
// row ri, columns c0 - 8 on) by the unit's nt threads, one element at a
// time: where TMA cannot describe x.
__device__ __forceinline__ void fill_raw(unsigned short* raw, const KbArgs& a, int b, int ri, int c0, int ci0,
                                         int lt, int nt) {
  const unsigned short* x = reinterpret_cast<const unsigned short*>(a.x);
  for (int e = lt; e < 16 * a.rw; e += nt) {
    const int col = e % a.rw, ch = e / a.rw, c = ci0 + ch, gc = c0 - 8 + col;
    const bool ok = c < a.cin && ri >= 0 && ri < a.H && gc >= 0 && gc < a.W;
    raw[e] = ok ? x[(((size_t)b * a.cin + c) * a.H + ri) * a.W + gc] : (unsigned short)0;
  }
}

// raw [16][rw] -> the chunk's input ring, [octet][3 slots x sw][8] from
// position dst (its octet 0, the row's slot): cb::transpose's moves
// (ldmatrix.trans, then stmatrix), raw column j the window's column j - 6
// (window column wc is image column c0 - 2 + wc); columns outside the
// window to the spare position, spare (past every position a stored c1
// value reads).  Work items (octet, four matrices) go to the unit's nw
// warps in turn.
__device__ __forceinline__ void transpose_row(uint32_t raw, uint32_t ring, int dst, int spare, const KbArgs& a,
                                              int wq, int nw, int lane) {
  const int kq = a.rw / 8, ng = (kq + 3) / 4, r = lane & 7, j = lane >> 3;
  for (int it = wq; it < 2 * ng; it += nw) {
    const int o = it >= ng, k = min(4 * (it - o * ng) + j, kq - 1);
    uint32_t v[4];
    ldmatrix_x4_trans(raw + 2u * (uint32_t)((o * 8 + r) * a.rw) + 16u * k, v);
    const int wc = 8 * k + r - 6;
    stmatrix_x4(ring + 16u * (uint32_t)(wc >= 0 && wc < a.sw ? dst + o * a.pt1 + wc : spare), v);
  }
}

// Keeps the compiler from hoisting the descriptors computed from d out of
// the loops around it (all of a launch's A descriptors would stay live in
// registers).
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// conv1's products of a chunk in cb::products_k1's order: for each kernel
// row dy, each m64 block's three column taps into a fresh accumulator (one
// chain), the fresh sums added in dy order; DY rows in flight between
// waits, the descriptors made at their use.  ad: the A descriptor at
// position 0 of the chunk's input ring; base: the ring positions of input
// rows r - 1, r, r + 1 (kernel rows dy = 0, 1, 2); bd: the B descriptor at
// the chunk's tap 0.
template <int N, int MB, int DY>
__device__ __forceinline__ void products_c1(float (&acc)[MB][N / 2], float (&d)[DY * MB][N / 2], uint64_t ad,
                                            uint64_t bd, const int (&base)[3]) {
  fence_tiles(d);
#pragma unroll
  for (int dg = 0; dg < 3 / DY; ++dg) {
    wgmma_fence();
#pragma unroll
    for (int dl = 0; dl < DY; ++dl) {
      const int dy = dg * DY + dl;
      const uint64_t a = opaque(ad + (uint64_t)base[dy]), b = opaque(bd + (uint64_t)(dy * 3 * 2 * N));
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          cb::WgmmaSS<N>::mma(d[dl * MB + m], a + (uint64_t)(64 * m + dx), b + (uint64_t)(dx * 2 * N));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int dl = 0; dl < DY; ++dl)
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int k = 0; k < N / 2; ++k) {
          float& f = d[dl * MB + m][k];
          fence_operand(f);
          acc[m][k] += f;
          f = 0.f;
          fence_operand(f);
        }
  }
}

// conv2's products of one pass and chunk into its PP phases' sums, in
// cb::products_k3's order: for each kernel row dy and phase, each m64
// block's two column taps into a fresh accumulator (one chain), the fresh
// sums added in dy order; DY rows x DP phases in flight between waits.
// Phase p of the pass is (oy, ox) = (p >> 1, p & 1) with four phases a
// pass, (the pass's row parity, p) with two.  ad: the A descriptor at the
// chunk's ring, position 0; rb: the ring positions of c1 rows R - 1, R, R
// + 1 (four phases), or of R - 1 + oy, R + oy (two); bd: the B descriptor
// at the pass's first tap (phase p's taps p * 4 + dy * 2 + dx from there).
template <int N, int MB, int PP, int DY, int DP>
__device__ __forceinline__ void products_c2(float (&acc)[PP * MB][N / 2], float (&d)[DY * DP * MB][N / 2],
                                            uint64_t ad, uint64_t bd, const int (&rb)[3]) {
  fence_tiles(d);
#pragma unroll
  for (int dg = 0; dg < 2 / DY; ++dg)
#pragma unroll
    for (int pg = 0; pg < PP / DP; ++pg) {
      const uint64_t b = opaque(bd);
      wgmma_fence();
#pragma unroll
      for (int dl = 0; dl < DY; ++dl) {
        const int dy = dg * DY + dl;
#pragma unroll
        for (int pl = 0; pl < DP; ++pl) {
          const int p = pg * DP + pl, ox = p & 1, row = (PP == 4 ? p >> 1 : 0) + dy;
          const uint64_t a = opaque(ad + (uint64_t)rb[row]);
#pragma unroll
          for (int m = 0; m < MB; ++m)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
              cb::WgmmaSS<N>::mma(d[(dl * DP + pl) * MB + m], a + (uint64_t)(64 * m + ox + dx),
                                  b + (uint64_t)((p * 4 + dy * 2 + dx) * 2 * N));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int dl = 0; dl < DY; ++dl)
#pragma unroll
        for (int pl = 0; pl < DP; ++pl)
#pragma unroll
          for (int m = 0; m < MB; ++m)
#pragma unroll
            for (int k = 0; k < N / 2; ++k) {
              float& f = d[(dl * DP + pl) * MB + m][k];
              fence_operand(f);
              acc[m * PP + pg * DP + pl][k] += f;
              f = 0.f;
              fence_operand(f);
            }
    }
}

// conv_tile.cuh's bias_lrelu with the bias from shared memory (zero past
// the conv's channels): the same float32 additions.
template <int T, int N>
__device__ __forceinline__ void bias_lrelu_s(float (&acc)[T][N / 2], const float* bias, int t, float slope) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float bk = bias[8 * j + 2 * t + e];
#pragma unroll
      for (int u = 0; u < T; ++u)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = acc[u][4 * j + 2 * i + e] + bk;
          v = v >= 0.f ? v : slope * v;
          acc[u][4 * j + 2 * i + e] = v;
        }
    }
}

// conv2's float32 outputs of one pass, the half of its channels from co0 on
// (cb::stage_out_f32's layout in region, G groups a channel staged in
// rows of G + 1), to y by the unit's nt threads: group grp of channel co0 +
// co, both column phases interleaved into 16 columns
// (cb::store_phases_f32).
template <int N2, int PP>
__device__ __forceinline__ void store_pass_f32(const unsigned char* region, const KbArgs& a, int b, int c0, int R,
                                               int oy, int co0, int lt, int nt, int G) {
  constexpr int NH = N2 / 2;
  const int G1 = G + 1;
  const float* rf = reinterpret_cast<const float*>(region);
  for (int e = lt; e < PP / 2 * NH * G; e += nt) {
    const int grp = e % G, rest = e / G, co = rest % NH, oyl = rest / NH, cc = c0 + 8 * grp, gco = co0 + co;
    if (8 * grp >= a.tc || cc >= a.W || gco >= a.cout) continue;
    const int pa = 2 * oyl, orow = 2 * R + (PP == 4 ? oyl : oy);
    const float* s0 = rf + ((pa * NH + co) * G1 + grp) * 8;
    const float* s1 = rf + (((pa + 1) * NH + co) * G1 + grp) * 8;
    cb::store_phases_f32(static_cast<float*>(a.y) + (((size_t)b * a.cout + gco) * 2 * a.H + orow) * 2 * a.W + 2 * cc,
                         s0, s1, min(8, a.W - cc), a.vec);
  }
}

// cb::stage_out and cb::stage_out_f32 for a warpgroup holding m64 blocks
// m0 .. m0 + MB - 1 of a unit (two warpgroups a unit past 128 channels),
// gs groups a channel staged (the strip's, even) in rows of gs + 1: the
// same stores, group 8 (m0 + m) + 2 wq + i, a warp's pair of groups left
// out from gs on.
template <int N, int MB, int PPB>
__device__ __forceinline__ void stage_out_at(const float (&acc)[MB * PPB][N / 2], uint32_t region, int wq, int lane,
                                             int m0, int gs) {
  const int mm = lane >> 3, c = lane & 7, g1 = gs + 1;
#pragma unroll
  for (int u = 0; u < MB * PPB; ++u) {
    const int m = u / PPB, p = u % PPB;
    if (8 * (m0 + m) + 2 * wq >= gs) continue;
#pragma unroll
    for (int j0 = 0; j0 < N / 8; j0 += 2) {
      const int co = 8 * (j0 + (mm >> 1)) + c, grp = 8 * (m0 + m) + 2 * wq + (mm & 1);
      const uint32_t r[4] = {pack_bf16(acc[u][4 * j0], acc[u][4 * j0 + 1]),
                             pack_bf16(acc[u][4 * j0 + 2], acc[u][4 * j0 + 3]),
                             pack_bf16(acc[u][4 * j0 + 4], acc[u][4 * j0 + 5]),
                             pack_bf16(acc[u][4 * j0 + 6], acc[u][4 * j0 + 7])};
      cb::stmatrix_x4_trans(region + 16u * (uint32_t)((p * N + co) * g1 + grp), r);
    }
  }
}
template <int N, int MB, int PPB, int HF>
__device__ __forceinline__ void stage_out_f32_at(const float (&acc)[MB * PPB][N / 2], float* region, int wq,
                                                 int lane, int m0, int gs) {
  constexpr int NH = N / 2, JH = N / 16;
  const int g = lane >> 2, t = lane & 3, g1 = gs + 1;
#pragma unroll
  for (int u = 0; u < MB * PPB; ++u) {
    const int m = u / PPB, p = u % PPB;
    if (8 * (m0 + m) + 2 * wq >= gs) continue;
#pragma unroll
    for (int jl = 0; jl < JH; ++jl)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          region[((p * NH + 8 * jl + 2 * t + e) * g1 + 8 * (m0 + m) + 2 * wq + i) * 8 + g] =
              acc[u][4 * (HF * JH + jl) + 2 * i + e];
  }
}

// Past 128 channels: a peer's c1 chunk (its ring's three slots, both
// octets, 32 ptr2 bytes at src in the peer's shared memory) into dst in
// this block's by its nt threads, 16-byte loads through distributed shared
// memory, four in flight a thread.
__device__ __forceinline__ void copy_peer_chunk(unsigned char* dst, unsigned char* src, int peer, int n16, int lt,
                                                int nt) {
  const uint4* s = coop::this_cluster().map_shared_rank(reinterpret_cast<uint4*>(src), peer);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int e0 = lt; e0 < n16; e0 += 4 * nt) {
    uint4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e0 + nt * i < n16) v[i] = s[e0 + nt * i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e0 + nt * i < n16) d[e0 + nt * i] = v[i];
  }
}

// Block x walks, in warpgroup wg, the units x + (k * nwg + wg) * blocks, k =
// 0, 1, .. (strips fastest, then runs, then images).  O: the output's type,
// bf16 or float32 (the JAX kernel's out_dtype, cast only at its store: the
// same plan and sums, c1 in bf16 either way; float32 leaves through the
// staging region in two halves of the channels, cb::stage_out_f32).
//
// CL: past 128 channels, a cluster of a.cluster blocks (ranks) of two
// warpgroups each walks the units cid, cid + clusters, .. together (the two
// warpgroups of a block share each unit: warpgroup w computes m64 blocks w
// MB .. w MB + MB - 1 of every row tile, both wait for the same copies and
// meet at named barrier 1, 256 threads), split as
// K1 bf16 and K3 bf16 split their channels: rank r computes c1 channels [s1
// N1, s1 N1 + N1) (s1 = min(r, nsplit1 - 1)) into its own ring, which holds
// chunks [s1 nown, s1 nown + nown) of conv2's input, and output channels
// [s2 N2, s2 N2 + N2); a rank past a conv's splits repeats the last split's
// work and neither stores it nor adds its sums (nor writes its c1).
// PixelNorm's sums meet in rank order (pn_cluster_sums, as K1 bf16 and K3
// bf16 meet).  conv2 walks every chunk in order: its own from its ring, a
// peer's (three rows) copied from the peer's ring through distributed
// shared memory into a staging slot (two, in the output staging region)
// when it reaches it.  Per c1 row three cluster barriers:
// PixelNorm's of conv1 (the rings' slots that conv2 of the row before read
// are free after it), the c1 row written (peers may copy it), PixelNorm's
// of conv2 (every read of the rings done).
template <int N1, int N2, typename O, bool CL>
__global__ void __launch_bounds__(CL ? 256 : 128 * kb_wgmax(N1, N2), 1)
    block_bf16_kernel(const __grid_constant__ CUtensorMap tm, const KbArgs a) {
  constexpr int MB = kb_mb(N1, N2), DY1 = kb_dy1(N1, N2), PP = kb_pp2(N1, N2), F2 = kb_f2(N1, N2);
  constexpr int DY2 = PP == 4 ? 1 : F2 >= 2 ? 2 : 1, DP2 = F2 / DY2, NP = 4 / PP;
  constexpr int MBT = CL ? 2 * MB : MB;  // m64 blocks of a unit's row tile (CL: two warpgroups')
  constexpr int ND1 = N1 / 2, ND2 = N2 / 2;
  // Positions a c1 ring slot and output groups a channel staged: 64 MB and
  // 8 MB, or with a cluster the strip's (tc + 2 rounded up to 16, tc / 8 to
  // an even number).
  const int SS = CL ? a.ss : 64 * MB, G = CL ? a.gs : 8 * MB, G1 = G + 1;
  extern __shared__ __align__(1024) unsigned char kb_smem[];
  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127, lane = tid & 31, wq = lt >> 5;
  const int g = lane >> 2, t = lane & 3;
  // The unit's warpgroups: CL both of the block (uw = 0), else warpgroup wg
  // alone; their threads (ut of unt), warps (uq of unq) and named barrier;
  // this warpgroup's first position of a row tile (pos0).
  const int uw = CL ? 0 : wg, ut = CL ? tid : lt, unt = CL ? 256 : 128, uq = ut >> 5, unq = unt >> 5;
  const int ubar = 1 + uw, pos0 = CL ? 64 * MB * wg : 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(kb_smem + a.bar_off);
  uint64_t* full = bars + 4 * uw;
  uint64_t* wbar = bars + 4 * a.nwg;
  const int rank = CL ? (int)(blockIdx.x % a.cluster) : 0;
  const int s1 = CL ? min(rank, a.nsplit1 - 1) : 0, s2 = CL ? min(rank, a.nsplit2 - 1) : 0;
  const int cm0 = s1 * N1, co0 = s2 * N2;  // the rank's first c1 and output channels
  const bf16* w1 = a.w1 + (size_t)s1 * a.nch1 * 9 * 16 * N1;   // its splits of the packs
  const bf16* w2 = a.w2 + (size_t)s2 * a.nch2 * 16 * 16 * N2;
  // The biases, zero past each conv's channels: conv1's N1, then conv2's N2.
  float* bias_s = reinterpret_cast<float*>(kb_smem + a.bias_off);
  for (int e = tid; e < N1 + N2; e += blockDim.x)
    bias_s[e] = e < N1 ? (cm0 + e < a.cmid ? a.b1[cm0 + e] : 0.f)
                       : (co0 + e - N1 < a.cout ? a.b2[co0 + e - N1] : 0.f);
  if (tid == 0) {
    for (int k = 0; k < 4 * a.nwg + 1; ++k) mbar_init(&bars[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int first = CL ? (int)blockIdx.x / a.cluster : blockIdx.x + wg * gridDim.x;
  const int slots = CL ? (int)gridDim.x / a.cluster : gridDim.x * a.nwg;
  const bool any = first < a.nunits;
  unsigned char* wgbase = kb_smem + a.wg_off + uw * a.wg_bytes;
  const unsigned char* w1s = kb_smem;                  // resident conv1 weights
  const unsigned char* w2s = kb_smem + a.w1res_bytes;  // resident conv2 weights

  // Item q into stage slot q % stages: an input row's chunk (by TMA), or a
  // chunk's weights where they stream: conv1's 9 taps, conv2's 4 PP of a
  // pass.
  auto issue = [&](const KbWalk& w, int q) {
    const int s = q % a.stages;
    unsigned char* st = wgbase + s * a.stage_bytes;
    if (w.ph == 0) {
      mbar_expect_tx(&full[s], a.tma ? a.raw_bytes : 0u);
      if (a.tma) tma_load_4d(st, &tm, &full[s], w.c0 - 8, w.kc * 16, w.ra - 2 + w.k, w.b);
    } else if (w.ph == 1) {
      mbar_expect_tx(&full[s], a.w1chunk_bytes);
      bulk_load(st, w1 + (size_t)w.kc * 9 * 16 * N1, a.w1chunk_bytes, &full[s]);
    } else {
      mbar_expect_tx(&full[s], a.w2chunk_bytes);
      bulk_load(st, w2 + ((size_t)w.kc * 16 + 4 * PP * w.oy) * 16 * N2, a.w2chunk_bytes, &full[s]);
    }
  };

  if (tid == 0 && (a.res1 || a.res2)) {
    mbar_expect_tx(wbar, a.w1res_bytes + a.w2res_bytes);
    if (a.res1) bulk_load(kb_smem, w1, a.w1res_bytes, wbar);
    if (a.res2) bulk_load(kb_smem + a.w1res_bytes, w2, a.w2res_bytes, wbar);
  }
  KbWalk fill;
  fill.unit(a, first, slots, 0);
  if (ut == 0)
    for (int k = 0; k < a.stages && fill.valid(a, first, slots); ++k) {
      issue(fill, k);
      fill.next(a, first, slots);
    }
  if ((a.res1 || a.res2) && any) mbar_wait(wbar, 0);

  unsigned char* region = wgbase + a.region_off;
  const uint32_t region_a = smem_u32(region);
  unsigned char* ring = wgbase + a.ring_off;  // c1
  const uint32_t ring_a = smem_u32(ring);
  unsigned char* inr = wgbase + a.in_off;     // the transposed input rows
  const uint32_t inr_a = smem_u32(inr);
  const int spare = a.pr1 - 1;
  float* part1 = reinterpret_cast<float*>(kb_smem + a.part_off);  // CL: PixelNorm's cluster sums
  float* part2 = part1 + 64 * MBT;
  // Item q: wait for its copies; once every warp is past its reads of the
  // slot (a warp's wgmma.wait_group covers its own quarter of the
  // products), the first thread refills the slot with item q + stages.
  int q = 0;
  auto wait_item = [&]() -> unsigned char* {
    const int s = q % a.stages;
    mbar_wait(&full[s], (q / a.stages) & 1);
    return wgbase + s * a.stage_bytes;
  };
  auto release = [&]() {
    bar_sync(ubar, unt);
    if (ut == 0 && fill.valid(a, first, slots)) {
      issue(fill, q + a.stages);
      fill.next(a, first, slots);
    }
    ++q;
  };

  KbWalk walk;
  for (walk.unit(a, first, slots, 0); walk.valid(a, first, slots); walk.unit(a, first, slots, walk.u + 1)) {
    const int b = walk.b, c0 = walk.c0, ra = walk.ra, rows = walk.rows;
    for (int k = 0; k < walk.rows + 4; ++k) {
      // ---- Input row ri = ra - 2 + k into its slot of every chunk's ring.
      // The slot's previous row was last read by the c1 row before, whose
      // products every warp waited for before the barrier after its epilogue.
      const int ri = ra - 2 + k;
      for (int kc = 0; kc < a.nch1; ++kc) {
        unsigned char* st = wait_item();
        if (!a.tma) {
          fill_raw(reinterpret_cast<unsigned short*>(st), a, b, ri, c0, kc * 16, ut, unt);
          bar_sync(ubar, unt);
        }
        transpose_row(smem_u32(st), inr_a, kc * 2 * a.pt1 + ((ri + 6) % 3) * a.sw, spare, a, uq, unq, lane);
        fence_proxy_async();  // the ring is read by wgmma
        release();
      }
      if (k < 2) continue;

      // ---- conv1: c1 row r1 = ra - 1 + j (j = k - 2), columns c0 - 1 ..
      // c0 + tc (positions 0 .. tc + 1), from input rows r1 - 1 .. r1 + 1.
      const int r1 = ri - 1;
      const int base1[3] = {((ri + 4) % 3) * a.sw + pos0, ((ri + 5) % 3) * a.sw + pos0,
                            ((ri + 6) % 3) * a.sw + pos0};
      float acc[MB][ND1], d[DY1 * MB][ND1];
#pragma unroll
      for (int u = 0; u < MB; ++u)
#pragma unroll
        for (int e = 0; e < ND1; ++e) acc[u][e] = 0.f;
#pragma unroll
      for (int u = 0; u < DY1 * MB; ++u)
#pragma unroll
        for (int e = 0; e < ND1; ++e) d[u][e] = 0.f;
      for (int kc = 0; kc < a.nch1; ++kc) {
        const unsigned char* wb = a.res1 ? w1s + (size_t)kc * 9 * 32 * N1 : wait_item();
        products_c1<N1, MB, DY1>(acc, d, smem_desc(inr + (size_t)kc * 32 * a.pt1, a.pt1 * 16, 128),
                                 smem_desc(wb, 16 * N1, 128), base1);
        if (!a.res1) release();
      }
      bias_lrelu_s<MB, N1>(acc, bias_s, t, a.slope);
      {
        float sum[MB][2];
        pn_sums<MB, N1>(acc, sum);
        if constexpr (CL) pn_cluster_sums<MB>(sum, part1, wg, wq, g, t, a.nsplit1);
#pragma unroll
        for (int u = 0; u < MB; ++u)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            pn_scale<MB, N1>(acc, u, i, sum[u][i] / (float)a.cmid, a.eps);
            // Position p of the thread's pixel: c1 column c0 - 1 + p; zero
            // outside the image.
            const int p = pos0 + 64 * u + 16 * wq + g + 8 * i, c = c0 - 1 + p;
            const bool inside = r1 >= 0 && r1 < a.H && c >= 0 && c < a.W;
            if (!inside)
#pragma unroll
              for (int jj = 0; jj < N1 / 8; ++jj)
#pragma unroll
                for (int e = 0; e < 2; ++e) acc[u][4 * jj + 2 * i + e] = 0.f;
          }
      }
      // c1 into ring slot r1 mod 3 by stmatrix: matrix mm of a warp's x4 is
      // positions 64u + 16wq + 8(mm & 1) .., channel group j0 + (mm >> 1)
      // (chunk / 2, octet % 2); lane 8mm + rr gives its row rr's address.
      // The slot's previous row was last read by conv2 two c1 rows ago,
      // whose products every warp has waited for before the barriers since.
      if (!CL || rank < a.nsplit1) {
        const int slot = (r1 + 3) % 3, mm = lane >> 3, rr = lane & 7;
        // A slot holds SS positions: a warp's 16 from SS on are left out.
#pragma unroll
        for (int u = 0; u < MB; ++u) {
          if (pos0 + 64 * u + 16 * wq >= SS) continue;
          const int pos = slot * SS + pos0 + 64 * u + 16 * wq + 8 * (mm & 1) + rr;
#pragma unroll
          for (int j0 = 0; j0 < N1 / 8; j0 += 2) {
            const int jj = j0 + (mm >> 1);
            const uint32_t r[4] = {pack_bf16(acc[u][4 * j0], acc[u][4 * j0 + 1]),
                                   pack_bf16(acc[u][4 * j0 + 2], acc[u][4 * j0 + 3]),
                                   pack_bf16(acc[u][4 * j0 + 4], acc[u][4 * j0 + 5]),
                                   pack_bf16(acc[u][4 * j0 + 6], acc[u][4 * j0 + 7])};
            stmatrix_x4(ring_a + 16u * (uint32_t)(((jj >> 1) * 2 + (jj & 1)) * a.ptr2 + pos), r);
          }
        }
      }
      fence_proxy_async();  // the ring is read by wgmma
      if constexpr (CL)
        coop::this_cluster().sync();  // and copied by the peers
      else
        bar_sync(ubar, unt);
      if (k < 4) continue;

      // ---- conv2: output row R = r1 - 1 (input resolution), from c1 rows
      // R - 1 .. R + 1 in the ring; pass oy makes output rows 2R + oy (both,
      // with four phases a pass).
      const int R = r1 - 1;
      for (int oy = 0; oy < NP; ++oy) {
        const int rb[3] = {((R - 1 + oy + 3) % 3) * SS + pos0, ((R + oy + 3) % 3) * SS + pos0,
                           ((R + 1 + 3) % 3) * SS + pos0};
        float acc2[PP * MB][ND2], d2[F2 * MB][ND2];
#pragma unroll
        for (int u = 0; u < PP * MB; ++u)
#pragma unroll
          for (int e = 0; e < ND2; ++e) acc2[u][e] = 0.f;
#pragma unroll
        for (int u = 0; u < F2 * MB; ++u)
#pragma unroll
          for (int e = 0; e < ND2; ++e) d2[u][e] = 0.f;
        int npeer = 0;  // CL: peer chunks copied in this pass (their staging slot's parity)
        for (int kc = 0; kc < a.nch2; ++kc) {
          const unsigned char* wb = a.res2 ? w2s + ((size_t)kc * 16 + 4 * PP * oy) * 32 * N2 : wait_item();
          const unsigned char* ab = ring + (size_t)kc * 32 * a.ptr2;
          if constexpr (CL) {
            const int owner = kc / a.nown, kl = kc - owner * a.nown;
            ab = ring + (size_t)kl * 32 * a.ptr2;
            if (owner != rank) {
              // Slot npeer & 1 was last read by the products of peer chunk
              // npeer - 2, which every warp waited for before the barrier
              // after copy npeer - 1.
              unsigned char* stg = region + (size_t)(npeer++ & 1) * 32 * a.ptr2;
              copy_peer_chunk(stg, ring + (size_t)kl * 32 * a.ptr2, owner, 2 * a.ptr2, ut, unt);
              fence_proxy_async();  // read by wgmma
              bar_sync(ubar, unt);
              ab = stg;
            }
          }
          products_c2<N2, MB, PP, DY2, DP2>(acc2, d2, smem_desc(ab, a.ptr2 * 16, 128),
                                            smem_desc(wb, 16 * N2, 128), rb);
          if (!a.res2) release();
        }
        bias_lrelu_s<PP * MB, N2>(acc2, bias_s + N1, t, a.slope);
        {
          float sum[PP * MB][2];
          pn_sums<PP * MB, N2>(acc2, sum);
          if constexpr (CL) pn_cluster_sums<PP * MB>(sum, part2, wg, wq, g, t, a.nsplit2);
#pragma unroll
          for (int u = 0; u < PP * MB; ++u)
#pragma unroll
            for (int i = 0; i < 2; ++i) pn_scale<PP * MB, N2>(acc2, u, i, sum[u][i] / (float)a.cout, a.eps);
        }
        // Every warp's reads of the region (the previous pass's stores, and
        // with CL the staged peer chunks) are behind the barrier after them.
        if (CL && rank >= a.nsplit2) {
          // A rank past conv2's splits: nothing to store.
        } else if constexpr (!std::is_same<O, bf16>::value) {
          if constexpr (CL)
            stage_out_f32_at<N2, MB, PP, 0>(acc2, reinterpret_cast<float*>(region), wq, lane, MB * wg, G);
          else
            cb::stage_out_f32<N2, MB, PP, 0>(acc2, reinterpret_cast<float*>(region), wq, lane);
          bar_sync(ubar, unt);
          store_pass_f32<N2, PP>(region, a, b, c0, R, oy, co0, ut, unt, G);
          bar_sync(ubar, unt);  // every warp's reads of the first half
          if constexpr (CL)
            stage_out_f32_at<N2, MB, PP, 1>(acc2, reinterpret_cast<float*>(region), wq, lane, MB * wg, G);
          else
            cb::stage_out_f32<N2, MB, PP, 1>(acc2, reinterpret_cast<float*>(region), wq, lane);
          bar_sync(ubar, unt);
          store_pass_f32<N2, PP>(region, a, b, c0, R, oy, co0 + N2 / 2, ut, unt, G);
        } else {
          if constexpr (CL)
            stage_out_at<N2, MB, PP>(acc2, region_a, wq, lane, MB * wg, G);
          else
            cb::stage_out<N2, MB, PP>(acc2, region_a, wq, lane);
          bar_sync(ubar, unt);
          // Group grp (positions 8 grp .. + 7: output columns 2 (c0 + 8 grp) ..
          // of row 2R + oy, both column phases interleaved) of channel co, for
          // each of the pass's output rows.
          for (int e = ut; e < PP / 2 * N2 * G; e += unt) {
            const int grp = e % G, rest = e / G, co = rest % N2, oyl = rest / N2, cc = c0 + 8 * grp;
            if (8 * grp >= a.tc || cc >= a.W || co0 + co >= a.cout) continue;
            const int pa = 2 * oyl, orow = 2 * R + (PP == 4 ? oyl : oy);
            const uint4 v0 = *reinterpret_cast<const uint4*>(region + 16 * ((pa * N2 + co) * G1 + grp));
            const uint4 v1 = *reinterpret_cast<const uint4*>(region + 16 * (((pa + 1) * N2 + co) * G1 + grp));
            bf16* dst =
                static_cast<bf16*>(a.y) + (((size_t)b * a.cout + co0 + co) * 2 * a.H + orow) * 2 * a.W + 2 * cc;
            const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&v0);
            const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&v1);
            uint32_t o[8];
#pragma unroll
            for (int e2 = 0; e2 < 4; ++e2) {
              o[2 * e2] = __byte_perm(w0[e2], w1[e2], 0x5410);
              o[2 * e2 + 1] = __byte_perm(w0[e2], w1[e2], 0x7632);
            }
            const int nv = min(8, a.W - cc);
            if (a.vec && nv == 8) {
              reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
              reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
            } else {
              const bf16* sv = reinterpret_cast<const bf16*>(o);
              for (int e2 = 0; e2 < 2 * nv; ++e2) dst[e2] = sv[e2];
            }
          }
        }
        bar_sync(ubar, unt);  // the region is the next pass's staging
      }
    }
  }
  // A block's shared memory must outlive its peers' reads of it.
  if constexpr (CL) coop::this_cluster().sync();
}

// ---- The plan (ops/conv_bf16.py::block_plan, integer for integer).

struct KbPlan {
  int n1, n2, mb, nch1, nch2, tc, sw, rw, ntx, run, nruns, nunits, nwg, res1, res2, stages, blocks;
  int pt1, pr1, ptr2, takes;
  int cluster, nsplit1, nsplit2, nown;  // ranks (1: no cluster), each conv's splits, c1 chunks a rank
  int ss, gs;                           // positions a c1 ring slot, output groups staged
  long long smem, cost, pair_cost;
};

// Bytes of a block's shared memory (ops/conv_bf16.py::_kb_layout): raw, an
// input row's chunk as it lands ([16 channels][rw]); stage, raw or a
// streamed chunk's weights (conv1's 9 taps, conv2's 8 of a pass); region,
// conv2's staged outputs of a pass (with a cluster also the two staging
// slots of peer chunks); ring, the c1 ring of the block's n1 / 16 mid
// chunks ([octet][3 slots of ss positions, and the last slot's reach] a
// chunk); inr, the transposed
// input rows of every input chunk ([octet][3 slots x sw positions], pt1 a
// octet), and past them the positions the junk rows of conv1's m64 blocks
// read and the spare position (pr1 in all); w1res, w2res, the resident
// weights (the block's split); bias, both convs' biases; part, with a
// cluster PixelNorm's sums of conv1 and of conv2.
struct KbLayout {
  long long raw, w1chunk, w2chunk, stage, region, pt1, pr1, inr, ss, gs, ptr2, ring, w1res, w2res, wg, bias, part,
      total;
};
inline KbLayout kb_layout(int n1, int n2, int mb, int nch1, int nch2, int tc, int nwg, bool res1, bool res2,
                          int stages, bool cl) {
  KbLayout l;
  const long long sw = tc + 8, rw = tc + 24, pp = kb_pp2(n1, n2);
  l.raw = 32 * rw;
  l.w1chunk = 9LL * 32 * n1;
  l.w2chunk = 4 * pp * 32 * n2;
  l.stage = cb::round_up(std::max({l.raw, res1 ? 0LL : l.w1chunk, res2 ? 0LL : l.w2chunk}), 128);
  l.pt1 = 3 * sw;
  l.pr1 = 2LL * nch1 * l.pt1 + 64LL * mb + 8;
  l.inr = cb::round_up(16 * l.pr1, 128);
  // A c1 ring slot: 64 mb positions, with a cluster the strip's tc + 2 (in
  // steps of 16); the last slot's m64 blocks read 64 mb + 2 positions on.
  // The staged outputs: 8 mb groups a channel, with a cluster the strip's.
  l.ss = cl ? cb::round_up(tc + 2, 16) : 64LL * mb;
  l.gs = cl ? cb::round_up(ceil_div(tc, 8), 2) : 8LL * mb;
  l.ptr2 = 2 * l.ss + 64LL * mb + 8;
  l.region = cb::round_up(std::max(pp * n2 * (l.gs + 1) * 16, cl ? 64 * l.ptr2 : 0LL), 128);
  l.ring = 32LL * (n1 / 16) * l.ptr2;
  l.w1res = res1 ? (long long)nch1 * 9 * 32 * n1 : 0;
  l.w2res = res2 ? (long long)nch2 * 16 * 32 * n2 : 0;
  l.wg = stages * l.stage + l.region + l.ring + l.inr;
  l.bias = 4LL * (n1 + n2);
  l.part = cl ? 4LL * 64 * mb * (1 + pp) : 0;
  l.total = l.w1res + l.w2res + nwg * l.wg + l.bias + l.part + 8LL * (nwg * 4 + 1);
  return l;
}

// Past 128 channels (ops/conv_bf16.py::channel_split, cb::plan_cb's rule):
// channels a rank of each conv and the splits.
inline void kb_split(int c, int* n, int* nsplit) {
  const int groups = ceil_div(c, 16);
  *nsplit = ceil_div(groups, 8);
  *n = 16 * ceil_div(groups, *nsplit);
}

// Whether the cluster route takes these widths (past 128 channels), by the
// widths alone: its smallest layout (16-column strips, weights streamed,
// two stages) fits a block.  Wider inputs keep block3x3.cuh at bf16: every
// rank holds three transposed rows of every input chunk.
inline bool kb_cluster_fits(int cin, int cmid, int cout) {
  if (cin < 1 || cmid < 1 || cout < 1 || cmid > MAX_CH || cout > MAX_CH) return false;
  int n1, n2, ns1, ns2;
  kb_split(cmid, &n1, &ns1);
  kb_split(cout, &n2, &ns2);
  if (ns1 == 1 && ns2 == 1) return false;
  const KbLayout l = kb_layout(n1, n2, 2 * kb_mb(n1, n2), ceil_div(cin, 16), ceil_div(cmid, 16), 16, 1, false,
                               false, 2, true);
  return l.total <= cb::SMEM_BUDGET;
}

// Modelled clocks (times 4) in conv_bf16.cuh's terms (cb::plan_cb): of an
// input row's chunk, its transposition or its copy, the longer; of a c1
// row, each chunk's products or its streamed weights' copy, and its
// epilogue; of an output row, its two passes' products or copies, stores
// and epilogues.
constexpr int ROW1_FIXED_CLK = 1000, ROW2_FIXED_CLK = 2500;
// A unit's modelled time on an SM that nwg warpgroups share, in eighths of
// its clocks (index nwg): fitted to K4 bf16 against K1 bf16 then K3 bf16 at
// blocks 4-7 of synthesis on an H100 (PERF.md): alone, a warpgroup's chain
// of waits goes unhidden (20); two hide part of it (12); three more (7).
constexpr int NWG_EIGHTHS[4] = {0, 20, 12, 7};
// With a cluster: modelled clocks of one cluster barrier, and (times 4) of
// a peer chunk's copy, 16 bytes a clock; a wave of units (one a cluster,
// both warpgroups on it) takes its modelled clocks times 23 / 20, fitted to
// the cluster route against K1 bf16 then K3 bf16 at 13 shapes past 128
// channels on an H100 (PERF.md: the model's ratio to the pair's was 1.9-2.9
// times the measured one at x 3).
constexpr int CLUSTER_SYNC_CLK = 1500, CLUSTER_WAVE_TWENTIETHS = 23;
inline long long kb_peer_cost4(long long ptr2) { return 4 * 2 * ptr2; }
inline long long kb_in_cost4(int nch1, int rw) { return nch1 * std::max(12LL * rw, 4LL * rw); }
inline long long kb_row1_cost4(int n1, int mb, int nch1, bool res1) {
  const long long work = (long long)mb * 9 * std::max(2 * n1, 64 + n1);
  const long long copies = res1 ? 0 : 4LL * 9 * n1;
  return nch1 * std::max(work, copies) + 4LL * mb * n1 + 4LL * ROW1_FIXED_CLK;
}
inline long long kb_row2_cost4(int n1, int n2, int mb, int nch2, int tc, bool res2) {
  const int pp = kb_pp2(n1, n2);
  const long long work = (long long)mb * 4 * pp * std::max(2 * n2, 64 + n2);
  const long long copies = res2 ? 0 : 4LL * 4 * pp * n2;
  return 4 / pp * (nch2 * std::max(work, copies) + (long long)tc * pp * n2 / 8 + 4LL * ROW2_FIXED_CLK);
}

// tc_force, run_force: 0, or a forced strip width (a multiple of 16) and
// run length (measurements and tests).  takes: K4 bf16's modelled time
// below K1 bf16 then K3 bf16's plans' (both with PixelNorm), and no
// cluster: over a cluster it was measured at or above the pair at every
// shape timed on an H100, the closest block 6 of a generator past 128
// channels at 1.000x (PERF.md), so the generator leaves those blocks to
// the pair until a redesign beats it (the cost still picks the layout).
//
// Past 128 channels (cluster > 1: max(nsplit1, nsplit2) ranks of two
// warpgroups each, both on every unit, widths kb_cluster_fits takes): mb
// the two warpgroups' m64 blocks (each one's from the registers, kb_mb, as
// the row costs are), and the same search with
// clusters for blocks (as many as the SMs hold, at most the units), a c1
// row's two cluster barriers and an output pass's one added, and the
// copies of the peers' chunks (nch2 - nown of them a pass).
inline int plan_kb(int B, int cin, int cmid, int cout, int H, int W, int sms, int tc_force, int run_force,
                   KbPlan* out) {
  if (B < 1 || cin < 1 || cmid < 1 || cout < 1 || H < 1 || W < 1 || cmid > MAX_CH || cout > MAX_CH ||
      tc_force < 0 || run_force < 0)
    return (int)cudaErrorInvalidValue;
  KbPlan p{};
  kb_split(cmid, &p.n1, &p.nsplit1);
  kb_split(cout, &p.n2, &p.nsplit2);
  p.cluster = std::max(p.nsplit1, p.nsplit2);
  const bool cl = p.cluster > 1;
  if (cl && !kb_cluster_fits(cin, cmid, cout)) return (int)cudaErrorInvalidValue;
  p.nown = p.n1 / 16;
  const int mbw = kb_mb(p.n1, p.n2);  // a warpgroup's m64 blocks
  p.mb = cl ? 2 * mbw : mbw;          // a unit's (two warpgroups' with a cluster)
  p.nch1 = ceil_div(cin, 16);
  p.nch2 = ceil_div(cmid, 16);
  const int tc_max = std::min(MAX_TC, 64 * p.mb - 16);
  if (tc_force % 16 != 0 || tc_force > tc_max) return (int)cudaErrorInvalidValue;
  bool found = false;
  for (int tc = std::min(tc_max, 16 * ceil_div(W, 16)); tc > 0; tc -= 16) {
    if (tc_force && tc != tc_force) continue;
    const int ntx = ceil_div(W, tc);
    const long long strips = (long long)B * ntx;
    if (strips * H > 0x3fffffffLL) continue;
    for (int res = 3; res >= 0; --res) {
      const bool r1 = res & 2, r2 = res & 1;
      const long long in = kb_in_cost4(p.nch1, tc + 24);
      long long row1 = kb_row1_cost4(p.n1, mbw, p.nch1, r1);
      long long row2 = kb_row2_cost4(p.n1, p.n2, mbw, p.nch2, tc, r2);
      if (cl) {
        const long long ptr2 = 2 * cb::round_up(tc + 2, 16) + 64LL * p.mb + 8, np = 4 / kb_pp2(p.n1, p.n2);
        const long long peers = std::max(0, p.nch2 - p.nown);
        row1 += 4LL * 2 * CLUSTER_SYNC_CLK;
        row2 += np * (peers * kb_peer_cost4(ptr2) + 4LL * CLUSTER_SYNC_CLK);
      }
      // Run lengths from the longest, each nruns once at its shortest run.
      for (int nruns = 1; nruns <= H; ++nruns) {
        const int run = run_force ? run_force : ceil_div(H, nruns);
        if (ceil_div(H, run) != nruns) continue;
        const long long units = strips * nruns;
        const int blocks = cl ? (int)std::min<long long>(units, std::max(1, sms / p.cluster)) * p.cluster
                              : (int)std::min<long long>(units, sms);
        const int wgmax = kb_wgmax(p.n1, p.n2);
        for (int nwg = cl ? 2 : std::min<long long>(wgmax, (units + blocks - 1) / blocks); nwg >= 1; --nwg) {
          int stages = 0;
          KbLayout l{};
          for (int s = 4; s >= 2 && !stages; --s) {
            l = kb_layout(p.n1, p.n2, p.mb, p.nch1, p.nch2, tc, cl ? 1 : nwg, r1, r2, s, cl);
            if (l.total <= cb::SMEM_BUDGET) stages = s;
          }
          if (!stages) continue;
          // Units go to the blocks' warpgroups in waves, nwg warpgroups an
          // SM (with a cluster both on each unit, a wave a unit a
          // cluster); the factor (eighths) is what sharing an SM does to
          // a row's chain of waits (NWG_EIGHTHS).
          const long long slots = cl ? (long long)blocks / p.cluster : (long long)blocks * nwg;
          const long long rows = (run + 4) * in + (run + 2) * row1 + run * row2;
          const long long cost = cl ? (units + slots - 1) / slots * rows * CLUSTER_WAVE_TWENTIETHS / 20
                                    : (units + slots - 1) / slots * nwg * rows * NWG_EIGHTHS[nwg] / 8;
          if (!found || cost < p.cost) {
            found = true;
            p.tc = tc;
            p.ntx = ntx;
            p.run = run;
            p.nruns = nruns;
            p.nunits = (int)units;
            p.nwg = nwg;
            p.res1 = r1;
            p.res2 = r2;
            p.stages = stages;
            p.blocks = blocks;
            p.pt1 = (int)l.pt1;
            p.pr1 = (int)l.pr1;
            p.ptr2 = (int)l.ptr2;
            p.ss = (int)l.ss;
            p.gs = (int)l.gs;
            p.smem = l.total;
            p.cost = cost;
          }
          break;
        }
      }
    }
  }
  if (!found) return (int)cudaErrorInvalidValue;
  p.sw = p.tc + 8;
  p.rw = p.tc + 24;
  cb::CbPlan p1, p3;
  int err = cb::plan_cb(3, B, cin, cmid, H, W, 1, sms, 0, 0, &p1);
  if (err == 0) err = cb::plan_cb(2, B, cmid, cout, H, W, 1, sms, 0, 0, &p3);
  if (err != 0) return err;
  p.pair_cost = p1.cost + p3.cost;
  p.takes = !cl && p.cost < p.pair_cost;
  *out = p;
  return 0;
}

// The plan at these sizes on the current device, for the wrappers and
// tests: out = {takes, tc, run, runs, strips, units, blocks, warpgroups a
// block, w1 resident, w2 resident, stages, shared-memory bytes, modelled
// cost, the pair's modelled cost, mb, SMs, cluster, nsplit1, nsplit2}; tc,
// run as the launchers'.
inline int plan_out(int B, int cin, int cmid, int cout, int H, int W, int tc, int run, long long* out) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  int err = current_device(&dev, &info);
  if (err != 0) return err;
  KbPlan p;
  err = plan_kb(B, cin, cmid, cout, H, W, info->sms, tc, run, &p);
  if (err != 0) return err;
  const long long v[19] = {p.takes, p.tc,      p.run,     p.nruns,   p.ntx,    p.nunits, p.blocks,
                           p.nwg,   p.res1,    p.res2,    p.stages,  p.smem,   p.cost,   p.pair_cost,
                           p.mb,    info->sms, p.cluster, p.nsplit1, p.nsplit2};
  for (int i = 0; i < 19; ++i) out[i] = v[i];
  return 0;
}

// x (B, cin, H, W) as a 4-d view (column, channel, row, image), so that a
// box of (rw, 16, 1, 1) lands as [channel][rw]: one input row of a chunk.
inline int encode_row_map(const bf16* x, int B, int cin, int H, int W, int rw, CUtensorMap* m) {
  const cb::EncodeTiled enc = cb::tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t hw = (cuuint64_t)H * W;
  const cuuint64_t dim[4] = {(cuuint64_t)W, (cuuint64_t)cin, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t str[3] = {2ull * hw, 2ull * W, 2ull * hw * cin};
  const cuuint32_t box[4] = {(cuuint32_t)rw, 16, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x), dim, str, box, ones,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cb::CB_ENCODE_ERROR + (int)r;
}

template <int N1, int N2, typename O, bool CL>
int launch_kb(const KbPlan& p, const KbArgs& a, const CUtensorMap& tm, int dev, const DeviceInfo& info,
              cudaStream_t stream) {
  static bool opted_in[MAX_DEVICES] = {};
  if (p.smem > info.smem_optin) return (int)cudaErrorInvalidValue;
  if (!opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(block_bf16_kernel<N1, N2, O, CL>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, info.smem_optin);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.blocks);
  cfg.blockDim = dim3(128 * p.nwg);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, block_bf16_kernel<N1, N2, O, CL>, tm, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// x: (B, cin, H, W) bf16; w1: ops/conv_bf16.py::tc_weights of conv1 (K1
// bf16's pack), w2: of conv2 (K3 bf16's); b1 (cmid,), b2 (cout,) float32;
// y: (B, cout, 2H, 2W) of O, bf16 or float32; tc, run: 0 for the size
// rule's.  CL: the cluster route (widths past 128 that kb_cluster_fits
// takes), else up to 128 channels.
template <typename O, bool CL>
int launch_block_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2, O* y, int B,
                      int cin, int cmid, int cout, int H, int W, float slope, float eps, int tc, int run,
                      cudaStream_t stream) {
  if (b1 == nullptr || b2 == nullptr) return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  const DeviceInfo* info = nullptr;
  int err = current_device(&dev, &info);
  if (err != 0) return err;
  KbPlan p;
  err = plan_kb(B, cin, cmid, cout, H, W, info->sms, tc, run, &p);
  if (err != 0) return err;
  if ((p.cluster > 1) != CL) return (int)cudaErrorInvalidValue;
  const int regions = CL ? 1 : p.nwg;  // a cluster's two warpgroups share one unit's rings
  const KbLayout l =
      kb_layout(p.n1, p.n2, p.mb, p.nch1, p.nch2, p.tc, regions, p.res1, p.res2, p.stages, CL);
  KbArgs a;
  a.x = x;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.y = y;
  a.B = B;
  a.cin = cin;
  a.cmid = cmid;
  a.cout = cout;
  a.H = H;
  a.W = W;
  a.nch1 = p.nch1;
  a.nch2 = p.nch2;
  a.tc = p.tc;
  a.sw = p.sw;
  a.rw = p.rw;
  a.ntx = p.ntx;
  a.run = p.run;
  a.nruns = p.nruns;
  a.nunits = p.nunits;
  a.nwg = regions;
  a.res1 = p.res1;
  a.res2 = p.res2;
  a.stages = p.stages;
  a.tma = (W % 8) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  a.vec = (W % 4) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  a.pt1 = p.pt1;
  a.pr1 = p.pr1;
  a.ptr2 = p.ptr2;
  a.np = 4 / kb_pp2(p.n1, p.n2);
  a.cluster = p.cluster;
  a.nsplit1 = p.nsplit1;
  a.nsplit2 = p.nsplit2;
  a.nown = p.nown;
  a.ss = p.ss;
  a.gs = p.gs;
  a.raw_bytes = (uint32_t)l.raw;
  a.stage_bytes = (uint32_t)l.stage;
  a.w1chunk_bytes = (uint32_t)l.w1chunk;
  a.w2chunk_bytes = (uint32_t)l.w2chunk;
  a.w1res_bytes = (uint32_t)l.w1res;
  a.w2res_bytes = (uint32_t)l.w2res;
  a.wg_off = (uint32_t)(l.w1res + l.w2res);
  a.wg_bytes = (uint32_t)l.wg;
  a.region_off = (uint32_t)(p.stages * l.stage);
  a.ring_off = (uint32_t)(p.stages * l.stage + l.region);
  a.in_off = (uint32_t)(p.stages * l.stage + l.region + l.ring);
  a.bias_off = a.wg_off + regions * a.wg_bytes;
  a.part_off = a.bias_off + (uint32_t)l.bias;
  a.bar_off = a.part_off + (uint32_t)l.part;
  a.slope = slope;
  a.eps = eps;
  CUtensorMap tm = {};
  if (a.tma) {
    err = encode_row_map(x, B, cin, H, W, p.rw, &tm);
    if (err != 0) return err;
  }
#define MG_KB(A, Bw) \
  if (p.n1 == A && p.n2 == Bw) return launch_kb<A, Bw, O, CL>(p, a, tm, dev, *info, stream);
#define MG_KB_ROW(A) MG_KB(A, 16) MG_KB(A, 32) MG_KB(A, 48) MG_KB(A, 64) MG_KB(A, 80) MG_KB(A, 96) MG_KB(A, 112) MG_KB(A, 128)
#define MG_KB_WIDE(A) MG_KB(A, 80) MG_KB(A, 96) MG_KB(A, 112) MG_KB(A, 128)
  if constexpr (CL) {
    // A split conv has 80 channels a rank or more (kb_split past 128).
    MG_KB_WIDE(16) MG_KB_WIDE(32) MG_KB_WIDE(48) MG_KB_WIDE(64)
    MG_KB_ROW(80) MG_KB_ROW(96) MG_KB_ROW(112) MG_KB_ROW(128)
  } else {
    MG_KB_ROW(16) MG_KB_ROW(32) MG_KB_ROW(48) MG_KB_ROW(64) MG_KB_ROW(80) MG_KB_ROW(96) MG_KB_ROW(112) MG_KB_ROW(128)
  }
#undef MG_KB_WIDE
#undef MG_KB_ROW
#undef MG_KB
  return (int)cudaErrorInvalidValue;
}

}  // namespace kb
}  // namespace mg
