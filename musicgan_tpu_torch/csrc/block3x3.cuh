// K4: one whole generator block in one launch, on the tensor cores (3xTF32
// in float32, one bf16 wgmma a step in bf16):
//   c1 = PixelNorm(LeakyReLU(conv3x3(x) + b1))            (cin  -> cmid)
//   y  = PixelNorm(LeakyReLU(conv3x3(up2x(c1)) + b2))     (cmid -> cout, 2H x 2W)
// Replaces musicgan_tpu/ops/conv.py::fused_block (Pallas kernel
// _block_kernel).  c1 never leaves shared memory.
//
// The arithmetic is the conv template's tensor-core route (conv_tile.cuh):
// the same pieces (the producer's halo copies and split weights, tc_products
// with its fresh accumulator a fragment row, bias / LeakyReLU / PixelNorm over
// the quad and the cluster in rank order), so conv1 sums every c1 pixel in
// K1's order and conv2 every output pixel in K3's: K4 gives K1 then K3's bits
// wherever it holds a conv's channels as they do (up to 128 channels).
//
// Element types (conv_tile.cuh): the template's, E = float or bf16, the
// instantiations in block3x3.cu and block3x3_bf16.cu.  In bf16 the ring
// holds c1 rounded to bf16, as K1 bf16 stores it and the JAX package's c1
// scratch (x.dtype) holds it, so K4 bf16 gives K1 bf16 then K3 bf16's bits;
// the ring's shared memory halves.  The shape (conv1's tile rows, a stage
// of one kernel row or of all three) is float32's at both types, so that
// one size rule (ops/conv.py::block_tile) serves both; bf16's smaller
// stages only fit more of them.  The output's type O is E's or the other
// (the JAX kernel's out_dtype, cast only at its store): the same plan and
// sums, y rounded once where O is bf16, c1 in E whatever O is
// (block3x3_f32_bf16.cu, block3x3_bf16_wide_f32.cu).
//
// Shape: a strip of 62 columns of the input's resolution walks down a run of
// image rows.  conv1 makes m64 tiles of c1, 64 columns (c0 - 1 .. c0 + 62),
// TH1 rows at a time, into a ring of NR c1 rows in shared memory (E,
// planes [channel][NR][72] as the template stages its input, zero outside
// the image: conv2's 'SAME' padding sees zeros there, not conv1 of the
// padding).  As soon as the ring holds the rows an output tile of TH2 rows
// needs, conv2 makes it, its A fragments loaded and split from the ring as
// the template's are from its staged input, and stores the pixels c0 ..
// c0 + 61.  So each c1 row is computed once a run; only the strip's 2 extra
// columns (64 / 62) and the run's two halo rows (and its last tile's
// rounding up to TH1 rows) are computed again.
//
// Warp-specialised and persistent as the template: one producer warpgroup
// walks the block's sequence of chunks (a conv1 chunk: Elem<E>::CK input
// channels' halo rows and their weights for 9 taps, or for 3 taps of one
// kernel row where shared memory is short; a conv2 chunk: CK mid channels'
// weights for the block's phases), copies each into a stage by cp.async
// and hands it over by the named barriers of the template (full 1 + s,
// empty 1 + S + s, counts 384); two consumer warpgroups multiply and run
// the epilogues.  The weights come (float32: split into big and small) and
// laid out as a stage holds them, made once a launch by a first small
// kernel (block_split_weights)
// from the template's own pieces, so the producer only copies.  Between
// conv1's epilogue and conv2 the consumers meet at named barrier 2 + 2S
// (256 threads): before c1 rows are overwritten (the other warpgroup may
// still read the old ones) and after they are written.
//
// Widths past 128 channels: a cluster of C = max(ceil(cmid / 128),
// ceil(cout / 128)) blocks works on one strip; rank k holds conv1's channels
// k*N1 .. and makes conv2's k*N2 ..; PixelNorm's per-pixel sums cross the
// cluster through distributed shared memory in rank order, and conv2 reads
// each chunk of 8 mid channels from the ring of the rank that holds it.
// There the consumers' meeting points are cluster barriers, which the
// producer joins too (after handing over a segment's last chunk).
#pragma once

#include "conv_tile.cuh"

namespace mg {

constexpr int BLK_STRIP = TC_W - 2;  // output columns (input resolution) a strip makes: 62
constexpr int BLK_MIN_RUN = 8;       // fewest rows a run has (but the image's last)

// The widths N (channels a block) the kernel is built for; a conv of n
// channels a block takes the least N >= n (zero weights past n).
__host__ __device__ constexpr int blk_width(int n) { return n <= 64 ? n : n <= 96 ? 96 : 128; }

// Rows the c1 ring must hold: conv1 tile k (rows -1 + k*TH1 .. of a run)
// is written once conv2 has made the tiles the rows before it allowed; the
// live rows then reach from the first pending conv2 tile's upper halo to
// the new tile's last row.
__host__ __device__ constexpr int blk_ring(int th1, int th2) {
  int nr = 0, done = 0;
  for (int k = 0; k < 32; ++k) {
    const int span = (k + 1) * th1 - done * th2;
    nr = span > nr ? span : nr;
    done = ((k + 1) * th1 - 2) / th2;
  }
  return nr;
}

// The geometry at N1 (conv1's channels a block) and N2 (conv2's): conv1
// tiles t1 a warpgroup (TH1 = 2 * t1 rows), dys = 1 where a conv1 stage
// holds one kernel row (3 taps, TH1 input rows) instead of all 9 taps
// (TH1 + 2 rows); conv2 as K3's tc_geom(2, N2); the ring; stages as many as
// the budget holds (2 to 4).  The first of t1 = min(tc_geom(3, N1).tiles,
// 4), halved down to 1, then the same with dys = 1, that fits two stages in
// float32.  Sizes in 4-byte words; planes: the weight planes a stage holds
// (Elem<E>::PLANES), esize: the bytes of an element of the ring.
struct BlkGeom {
  int t1, dys, th1, sh1, nt1, plane1, bsplit1, t2, ppb2, rw2, th2, nt2, bsplit2, nr, planer, stage,
      stages, c1, part1, part2, floats, planes;
};
__host__ __device__ constexpr BlkGeom blk_geom_at(int N1, int N2, int t1, int dys, int planes = 2,
                                                  int esize = 4) {
  const TcGeom g2 = tc_geom(2, N2, planes);
  BlkGeom g{};
  g.t1 = t1;
  g.dys = dys;
  g.planes = planes;
  g.th1 = TC_WG * t1;
  g.sh1 = dys ? g.th1 : g.th1 + 2;
  g.nt1 = dys ? 3 : 9;
  g.plane1 = (g.sh1 * TC_SW + 23) / 32 * 32 + 8;
  g.bsplit1 = g.nt1 * TC_CK * N1;
  g.t2 = g2.tiles;
  g.ppb2 = g2.ppb;
  g.rw2 = g2.rows;
  g.th2 = g2.th;
  g.nt2 = g2.nt;
  g.bsplit2 = g.nt2 * TC_CK * N2;
  const int stage1 = TC_CK * g.plane1 + planes * g.bsplit1, stage2 = planes * g.bsplit2;
  g.stage = stage1 > stage2 ? stage1 : stage2;
  g.nr = blk_ring(g.th1, g.th2);
  g.planer = (g.nr * TC_SW + 23) / 32 * 32 + 8;
  g.c1 = N1 * g.planer * esize / 4;
  g.part1 = TC_WG * t1 * TC_W;
  g.part2 = 2 * TC_WG * g.t2 * TC_W;
  const int fit = (TC_SMEM_BUDGET / 4 - g.c1 - g.part1 - g.part2) / g.stage;
  g.stages = fit > 4 ? 4 : fit;
  g.floats = g.stages * g.stage + g.c1 + g.part1 + g.part2;
  return g;
}
__host__ __device__ constexpr BlkGeom blk_geom(int N1, int N2, int planes = 2, int esize = 4) {
  const int t0 = tc_geom(3, N1).tiles < 4 ? tc_geom(3, N1).tiles : 4;
  for (int dys = 0; dys < 2; ++dys)
    for (int t1 = t0; t1 >= 1; t1 /= 2)
      if (blk_geom_at(N1, N2, t1, dys).stages >= 2) return blk_geom_at(N1, N2, t1, dys, planes, esize);
  return blk_geom_at(N1, N2, 1, 1, planes, esize);  // float32 fits no two stages: refused
}
template <typename E>
__host__ __device__ constexpr BlkGeom blk_geom_of(int N1, int N2) {
  return blk_geom(N1, N2, Elem<E>::PLANES, (int)sizeof(E));
}

// What a block's walk over its units needs, fixed for the launch.
struct BlkSched {
  int ntx, nruns, run, H, cid, ncl, my_units, c1n, c2n;
};

// A run of rows of one strip of one image, and where the walk over its
// chunks stands.  The order: conv1 tile k (c1n chunks), then each conv2 tile
// that tile k completed (NPHG phase groups of c2n chunks each), then tile
// k + 1.  Producer and consumers walk it alike.
template <int TH1, int TH2, int NPHG>
struct BlkWalk {
  int it, b, c0, ra, rows, nk1, n2t;  // the unit
  int k, i, g, kc, mode, ready;       // the chunk: mode 0 conv1 tile k, 1 conv2 tile i, group g
  __device__ bool valid(const BlkSched& s) const { return it < s.my_units; }
  __device__ void unit(const BlkSched& s, int u_it) {
    it = u_it;
    k = i = g = kc = mode = 0;
    if (it >= s.my_units) return;
    const int u = s.cid + it * s.ncl;
    const int bx = u % s.ntx, rest = u / s.ntx, rr = rest % s.nruns;
    b = rest / s.nruns;
    c0 = bx * BLK_STRIP;
    ra = rr * s.run;
    rows = min(s.run, s.H - ra);
    nk1 = (rows + 2 + TH1 - 1) / TH1;
    n2t = (rows + TH2 - 1) / TH2;
  }
  // Conv2 tiles that c1 tile kk completes (all that are left after the last).
  __device__ int ready_after(int kk) const {
    const int r = ((kk + 1) * TH1 - 2) / TH2;
    return kk == nk1 - 1 || r > n2t ? n2t : r;
  }
  __device__ bool last_of_segment(const BlkSched& s) const {
    return mode == 0 ? kc == s.c1n - 1 : kc == s.c2n - 1;
  }
  __device__ void next(const BlkSched& s) {
    if (mode == 0) {
      if (++kc < s.c1n) return;
      kc = 0;
      ready = ready_after(k);
      if (i < ready) {
        mode = 1;
        g = 0;
        return;
      }
    } else {
      if (++kc < s.c2n) return;
      kc = 0;
      if (++g < NPHG) return;
      g = 0;
      if (++i < ready) return;
    }
    mode = 0;
    if (++k < nk1) return;
    unit(s, it + 1);
  }
};

// Registers: 384 threads start at 168 each.  Where N1 <= 48 the producer
// warpgroup, which only issues copies, gives 72 of its registers to each
// consumer thread's 36 (setmaxnreg moves registers only within what the
// block was given, so the new counts must sum to no more, or a consumer's
// increase would wait for ever).  Measured on an H100 at blocks 5-7 of
// synthesis, with the weights split in the producer: at N1 = 32 moving
// registers took K4 from 3.72 to 2.76 ms, at 48 from 2.20 to 2.07; at 64 it
// lost (1.27 -> 1.34-1.55 ms), so N1 >= 64 keeps 168 each.
__host__ __device__ constexpr int blk_producer_regs(int n1) { return n1 >= 64 ? 168 : 96; }
__host__ __device__ constexpr int blk_consumer_regs(int n1) {
  return n1 >= 64 ? 168 : (TC_THREADS * 168 - 128 * blk_producer_regs(n1)) / 256 / 8 * 8;
}

// Words of one rank's stage weights: conv1's c1n chunks, then conv2's
// nphg x c2n, each as a stage holds it (float32: big, then small).
__host__ __device__ constexpr long blk_ws_rank(const BlkGeom& g, int c1n, int c2n, int nphg) {
  return (long)c1n * g.planes * g.bsplit1 + (long)nphg * c2n * g.planes * g.bsplit2;
}

// Every chunk's weights of the launch laid out as the stages hold them
// (float32: split into big and small), once, before the block kernel:
// block (q, rank) makes chunk q of that rank's channels, by the producer's
// own pieces (load_weight_chunk, store_stage_weights), so the values are
// those the template's producer makes.
template <typename E, int N1, int N2>
__global__ void __launch_bounds__(128)
block_split_weights(const E* __restrict__ w1, const E* __restrict__ w2, float* __restrict__ ws,
                    int cin, int cmid, int cmidp, int coutp) {
  constexpr BlkGeom G = blk_geom_of<E>(N1, N2);
  constexpr int NT1 = G.nt1, NT2 = G.nt2, PPB2 = G.ppb2, CK = Elem<E>::CK, PL = Elem<E>::PLANES;
  constexpr int WR1 = (NT1 * 2 * N1 + 127) / 128, WR2 = (NT2 * 2 * N2 + 127) / 128;
  const int c1n = (cin + CK - 1) / CK * (G.dys ? 3 : 1), c2n = (cmid + CK - 1) / CK;
  const int q = blockIdx.x, rank = blockIdx.y, pt = threadIdx.x;
  float* base = ws + (size_t)rank * blk_ws_rank(G, c1n, c2n, 4 / PPB2);
  if (q < c1n) {
    WeightRegs<E, WR1> wv;
    const int dy = G.dys ? q % 3 : 0, ci0 = (G.dys ? q / 3 : q) * CK;
    load_weight_chunk<3, NT1, N1>(wv, w1, cin, cmidp, rank * N1, ci0, 3 * dy, 0, pt);
    store_stage_weights<NT1, N1>(base + (size_t)q * PL * G.bsplit1, G.bsplit1, wv, pt);
  } else {
    WeightRegs<E, WR2> wv;
    const int q2 = q - c1n, g = q2 / c2n, kc = q2 % c2n;
    load_weight_chunk<2, NT2, N2>(wv, w2, cmid, coutp, rank * N2, kc * CK, 0, g * PPB2, pt);
    store_stage_weights<NT2, N2>(base + (size_t)c1n * PL * G.bsplit1 + (size_t)q2 * PL * G.bsplit2,
                                 G.bsplit2, wv, pt);
  }
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  if constexpr (R < 168) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  if constexpr (R > 168) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// x: (B, cin, H, W); w1: (cin, 9, cmidp), ops/conv.py::kernel_weights; b1:
// (cmid,); w2: (4, cmid, 4, coutp), kernel_upconv_weights; b2: (cout,); y:
// (B, cout, 2H, 2W) of O (float32 or bf16; c1 stays E).  Block x =
// cluster * C + rank walks the units cluster, cluster + clusters, ... of the
// nunits = B x nruns x ntx units (strips fastest): image b, rows ra .. ra +
// run - 1, columns c0 .. c0 + 61.
template <typename E, typename O, int N1, int N2>
__global__ void __launch_bounds__(TC_THREADS, 1)
block_tc_kernel(const E* __restrict__ x, const float* __restrict__ ws,
                const float* __restrict__ b1, const float* __restrict__ b2, O* __restrict__ y,
                int cin, int cmid, int cout, int H, int W, int ntx, int run, int nruns, int nunits,
                int C, float slope, float eps) {
  constexpr BlkGeom G = blk_geom_of<E>(N1, N2);
  constexpr int T1 = G.t1, T2 = G.t2, PPB2 = G.ppb2, RW2 = G.rw2, S = G.stages, NR = G.nr;
  constexpr int ND1 = N1 / 2, ND2 = N2 / 2, CK = Elem<E>::CK, PL = Elem<E>::PLANES, CH = AFrag<E>::CH;
  static_assert(S >= 2, "two stages must fit");
  // Named barriers (0 is __syncthreads'): stage s full 1 + s, empty 1 + S
  // + s; the producer's own; the consumers' own.
  constexpr int FULL = 1, EMPTY = 1 + S, PRODUCER = 1 + 2 * S, CONSUMERS = 2 + 2 * S;
  extern __shared__ __align__(128) float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // Stages [S][stage], the c1 ring [N1][planer] of E, PixelNorm's sums:
  // conv1's [WG][T1][64], conv2's 2 x [WG][T2][64].
  E* c1 = reinterpret_cast<E*>(smem + S * G.stage);
  float* part1 = smem + S * G.stage + G.c1;
  float* part2 = part1 + G.part1;

  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) & 3, wg = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % C, cid = blockIdx.x / C, ncl = gridDim.x / C;
  const int co1 = rank * N1, co2 = rank * N2;
  const bool clustered = C > 1;
  // This rank's split weights (block_split_weights).

  // The ring's columns 64 .. 71 are read (by output pixels past the strip,
  // which are not stored) and never written: zero, as is the rest at first.
  for (int e = tid; e < G.c1; e += TC_THREADS) smem[S * G.stage + e] = 0.f;
  __syncthreads();

  BlkSched sched{};
  sched.ntx = ntx;
  sched.nruns = nruns;
  sched.run = run;
  sched.H = H;
  sched.cid = cid;
  sched.ncl = ncl;
  sched.my_units = cid < nunits ? (nunits - cid + ncl - 1) / ncl : 0;
  sched.c1n = (cin + CK - 1) / CK * (G.dys ? 3 : 1);
  sched.c2n = (cmid + CK - 1) / CK;
  using Walk = BlkWalk<G.th1, G.th2, 4 / PPB2>;
  // The block's chunks in all.
  int total = 0;
  {
    Walk w;
    for (w.unit(sched, 0); w.valid(sched); w.unit(sched, w.it + 1))
      total += w.nk1 * sched.c1n + w.n2t * (4 / PPB2) * sched.c2n;
  }

  if (wg == TC_WG) {
    // ---- The producer. ----
    regs_dec<blk_producer_regs(N1)>();
    const int pt = tid - 128 * TC_WG;
    const bool vec = (W & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(E) - 1)) == 0;
    const float* ws_rank = ws + (size_t)rank * blk_ws_rank(G, sched.c1n, sched.c2n, 4 / PPB2);
    // Chunk q: conv1's the input's halo rows, then for either conv the
    // chunk's weights as the stage holds them, all by cp.async.
    auto issue = [&](const Walk& c, int q) {
      float* st = smem + (q % S) * G.stage;
      const float* src;
      float* dst;
      int n4;
      if (c.mode == 0) {
        const int r1 = c.ra - 1 + c.k * G.th1, dy = G.dys ? c.kc % 3 : 0;
        const int ci0 = (G.dys ? c.kc / 3 : c.kc) * CK;
        stage_input(reinterpret_cast<E*>(st), x + (size_t)c.b * cin * H * W, x, cin, H, W, ci0,
                    G.dys ? r1 + dy - 1 : r1 - 1, G.sh1, (c.c0 - 2) & ~3, G.plane1, pt, vec);
        src = ws_rank + (size_t)c.kc * PL * G.bsplit1;
        dst = st + TC_CK * G.plane1;
        n4 = PL * G.bsplit1 / 4;
      } else {
        src = ws_rank + (size_t)sched.c1n * PL * G.bsplit1 + (size_t)(c.g * sched.c2n + c.kc) * PL * G.bsplit2;
        dst = st;
        n4 = PL * G.bsplit2 / 4;
      }
      for (int e = pt; e < n4; e += 128) cp_async16_cg(dst + 4 * e, src + 4 * e, true);
    };
    Walk cur, fill;  // chunks k and k - 1 + S
    cur.unit(sched, 0);
    fill.unit(sched, 0);
    for (int k = 0; k < S; ++k) {
      if (k < total) {
        issue(fill, k);
        fill.next(sched);
      }
      cp_async_commit();
    }
    for (int k = 0; k < total; ++k) {
      if (k == 0)
        cp_async_wait<S - 1>();
      else
        cp_async_wait<S - 2>();
      bar_sync(PRODUCER, 128);  // chunk k landed, every producer thread's copies
      fence_proxy_async();      // the weights are read by wgmma
      bar_arrive(FULL + k % S, TC_THREADS);
      if (k >= 1) {
        const int kn = k - 1 + S;
        if (kn < total) {
          bar_sync(EMPTY + (k - 1) % S, TC_THREADS);
          issue(fill, kn);
          fill.next(sched);
        }
        cp_async_commit();
      }
      // The consumers' cluster barriers at the end of a segment: two after
      // conv1 (its PixelNorm sums; the ring written), one after conv2.
      if (clustered && cur.last_of_segment(sched)) {
        coop::this_cluster().sync();
        if (cur.mode == 0) coop::this_cluster().sync();
      }
      cur.next(sched);
    }
    if (clustered) coop::this_cluster().sync();
    return;
  }

  // ---- The consumers. ----
  regs_inc<blk_consumer_regs(N1)>();
  int q = 0, nseg2 = 0;
  Walk walk;
  for (walk.unit(sched, 0); walk.valid(sched);) {
    const int b = walk.b, c0 = walk.c0, ra = walk.ra, rows = walk.rows;
    if (walk.mode == 0) {
      // conv1 tile k: c1 rows r1 .. r1 + TH1 - 1, columns c0 - 1 .. c0 + 62.
      const int k = walk.k, r1 = ra - 1 + k * G.th1;
      float acc[T1][ND1];
#pragma unroll
      for (int u = 0; u < T1; ++u)
#pragma unroll
        for (int e = 0; e < ND1; ++e) acc[u][e] = 0.f;
      for (int kc = 0; kc < sched.c1n; ++kc, ++q) {
        float d[T1][ND1];
#pragma unroll
        for (int u = 0; u < T1; ++u)
#pragma unroll
          for (int e = 0; e < ND1; ++e) d[u][e] = 0.f;
        const float* st = smem + (q % S) * G.stage;
        bar_sync(FULL + q % S, TC_THREADS);
        const uint64_t d_big = smem_desc(st + TC_CK * G.plane1, N1 * 16, 128);
        const uint64_t d_small = PL == 2 ? smem_desc(st + TC_CK * G.plane1 + G.bsplit1, N1 * 16, 128) : 0;
        // Pixel m of the tile is c1 column c0 - 1 + m, which reads image
        // columns c0 - 2 + m + dx; staged column 0 is image column
        // (c0 - 2) & ~3 (copies of 4 elements), so that is staged column off + m + dx.
        const int off = (c0 - 2) - ((c0 - 2) & ~3);
        const E* a_base = reinterpret_cast<const E*>(st) + CH * t * G.plane1 + (wg * T1) * TC_SW + off +
                          16 * wq + g;
        auto row = [&](int j) { return a_base + j * TC_SW; };
        if constexpr (G.dys) {
          // One kernel row dy: tile u's fragment row is staged row u.
          fence_tiles(d);
          AFrag<E> fr[2];
#pragma unroll
          for (int u = 0; u < T1; ++u) {
#pragma unroll
            for (int s = 0; s < 3; ++s) {
              const int f = (u * 3 + s) & 1;
              fr[f].load(row(u) + s, G.plane1);
              wgmma_fence();
              const uint64_t off = (uint64_t)(s * N1 * 32) >> 4;
              fr[f].template mma<N1>(d[u], d_big + off, d_small + off);
              wgmma_commit();
              wgmma_wait<1>();
            }
            wgmma_wait<0>();
            add_fresh(acc, d);
          }
        } else {
          tc_products<E, 3, N1, T1, 1, T1, 0, 0>(acc, d, row, G.plane1, d_big, d_small);
        }
        if (q + S < total) bar_arrive(EMPTY + q % S, TC_THREADS);  // the stage goes back
        walk.next(sched);
      }
      bias_lrelu<T1, N1>(acc, b1, co1, cmid, t, slope, 1);
      float sum[T1][2];
      pn_sums<T1, N1>(acc, sum);
      // Every consumer is past its reads of the ring rows this tile
      // replaces (and, in a cluster, every block's: its conv2 reads them).
      if (clustered)
        pn_cluster_sums<T1>(sum, part1, wg, wq, g, t, C);
      else
        bar_sync(CONSUMERS, 128 * TC_WG);
#pragma unroll
      for (int u = 0; u < T1; ++u) {
        const int r = r1 + wg * T1 + u;
        E* dst = c1 + ((k * G.th1 + wg * T1 + u) % NR) * TC_SW;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pn_scale<T1, N1>(acc, u, i, sum[u][i] / (float)cmid, eps);
          const int m = 16 * wq + g + 8 * i, c = c0 - 1 + m;
          const bool inside = r >= 0 && r < H && c >= 0 && c < W;
#pragma unroll
          for (int j = 0; j < N1 / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              dst[(8 * j + 2 * t + e) * G.planer + m] = from_f32<E>(inside ? acc[u][4 * j + 2 * i + e] : 0.f);
        }
      }
      if (clustered)
        coop::this_cluster().sync();
      else
        bar_sync(CONSUMERS, 128 * TC_WG);
    } else {
      // conv2 tile i, phases ph0 .. ph0 + PPB2 - 1: output rows r2 .. r2 + TH2
      // - 1 (input resolution), reading c1 rows r2 - 1 .. r2 + TH2.
      const int r2 = ra + walk.i * G.th2, ph0 = walk.g * PPB2, i2 = walk.i;
      float acc[T2][ND2];
#pragma unroll
      for (int u = 0; u < T2; ++u)
#pragma unroll
        for (int e = 0; e < ND2; ++e) acc[u][e] = 0.f;
      for (int kc = 0; kc < sched.c2n; ++kc, ++q) {
        float d[T2][ND2];
#pragma unroll
        for (int u = 0; u < T2; ++u)
#pragma unroll
          for (int e = 0; e < ND2; ++e) d[u][e] = 0.f;
        const float* st = smem + (q % S) * G.stage;
        bar_sync(FULL + q % S, TC_THREADS);
        const uint64_t d_big = smem_desc(st, N2 * 16, 128);
        const uint64_t d_small = PL == 2 ? smem_desc(st + G.bsplit2, N2 * 16, 128) : 0;
        // Mid channels kc*CK .. kc*CK + CK - 1 lie in the ring of rank kc*CK / N1.
        const int owner = kc * CK / N1, lch = kc * CK % N1;
        const E* src = clustered ? coop::this_cluster().map_shared_rank(c1, owner) : c1;
        const E* a_ch = src + (lch + CH * t) * G.planer + 16 * wq + g;
        // Fragment row j is c1 row r2 + wg*RW2 + j - 1; ring column cc is c1
        // column c0 - 1 + cc, so pixel m's shift s reads column m + s.
        auto row = [&](int j) { return a_ch + ((i2 * G.th2 + wg * RW2 + j) % NR) * TC_SW; };
        if constexpr (PPB2 == 4) {
          tc_products<E, 2, N2, T2, PPB2, RW2, 0, 0>(acc, d, row, G.planer, d_big, d_small);
        } else if constexpr (PPB2 == 2) {
          if (ph0 >> 1) tc_products<E, 2, N2, T2, PPB2, RW2, 1, 0>(acc, d, row, G.planer, d_big, d_small);
          else tc_products<E, 2, N2, T2, PPB2, RW2, 0, 0>(acc, d, row, G.planer, d_big, d_small);
        } else {
          switch (ph0) {
            case 0: tc_products<E, 2, N2, T2, PPB2, RW2, 0, 0>(acc, d, row, G.planer, d_big, d_small); break;
            case 1: tc_products<E, 2, N2, T2, PPB2, RW2, 0, 1>(acc, d, row, G.planer, d_big, d_small); break;
            case 2: tc_products<E, 2, N2, T2, PPB2, RW2, 1, 0>(acc, d, row, G.planer, d_big, d_small); break;
            default: tc_products<E, 2, N2, T2, PPB2, RW2, 1, 1>(acc, d, row, G.planer, d_big, d_small); break;
          }
        }
        if (q + S < total) bar_arrive(EMPTY + q % S, TC_THREADS);
        walk.next(sched);
      }
      bias_lrelu<T2, N2>(acc, b2, co2, cout, t, slope, 1);
      float sum[T2][2];
      pn_sums<T2, N2>(acc, sum);
      if (clustered) pn_cluster_sums<T2>(sum, part2 + (nseg2 & 1) * (TC_WG * T2 * TC_W), wg, wq, g, t, C);
      ++nseg2;
#pragma unroll
      for (int u = 0; u < T2; ++u)
#pragma unroll
        for (int i = 0; i < 2; ++i) pn_scale<T2, N2>(acc, u, i, sum[u][i] / (float)cout, eps);
      store_tiles<O, 2, T2, N2, PPB2>(acc, y, b, cout, co2, H, W, 2, r2 + wg * RW2, c0, ph0, ra + rows,
                                      BLK_STRIP, wq, g, t);
    }
  }
  // A block's shared memory must outlive the other blocks' reads of it.
  if (clustered) coop::this_cluster().sync();
}

// How a block of these sizes is launched.
struct BlockPlan {
  int n1, n2, nsplit1, nsplit2, cluster, run, nruns, ntx, units, blocks, takes;
  BlkGeom geom;
  long c1_rows;  // conv1 rows (of 64 columns) computed in all
  ConvPlan launch;
};

inline int split_width(int c, int* nsplit) {
  const int cgt = ceil_div(c, CO);
  *nsplit = ceil_div(cgt, MAX_CG);
  return blk_width(ceil_div(cgt, *nsplit) * CO);
}

// The widths' part of the plan (no device needed): N1, N2, the splits and
// the geometry for the element type E.  Returns false for widths the
// kernel does not take (at either type: those where float32 fits no two
// stages).
template <typename E>
inline bool plan_block_widths(int cmid, int cout, BlockPlan* p) {
  if (cmid < 1 || cout < 1 || cmid > MAX_CLUSTER * MAX_CG * CO || cout > MAX_CLUSTER * MAX_CG * CO)
    return false;
  p->n1 = split_width(cmid, &p->nsplit1);
  p->n2 = split_width(cout, &p->nsplit2);
  p->cluster = std::max(p->nsplit1, p->nsplit2);
  // Past 64 mid channels a ring of the 6 rows that conv2's 16-channel tiles
  // (4 rows) need does not fit: conv2 then takes 32 channels a block.
  if (p->n2 == 16 && blk_geom(p->n1, 16).stages < 2) p->n2 = 32;
  p->geom = blk_geom_of<E>(p->n1, p->n2);
  return blk_geom(p->n1, p->n2).stages >= 2;
}

// The whole plan, from the sizes and the SM count only (no timing; the
// plan does not change what a pixel sums, only who sums it).  The run
// length: from 8 rows up in steps of 2, the one that makes the least work
// a cluster in the waves of units over the card's clusters (conv1's rows of a run are its rows + 2
// rounded up to TH1, conv2's its rows rounded up to TH2).  takes: the
// generator's rule (ops/conv.py::block_takes mirrors it), K4 where K1 and
// K3 both take the template's tensor-core route at the block's sizes and
// units of runs of 8 rows fill half the card's clusters (as plan_conv
// takes the tensor-core route once its tiles fill half the SMs).
template <typename E>
inline int plan_block(int B, int cin, int cmid, int cout, int H, int W, const DeviceInfo& info,
                      BlockPlan* p) {
  if (B < 1 || cin < 1 || H < 1 || W < 1 || !plan_block_widths<E>(cmid, cout, p))
    return (int)cudaErrorInvalidValue;
  const BlkGeom& g = p->geom;
  const int C = p->cluster, clusters = std::max(1, info.sms / C);
  p->ntx = ceil_div(W, BLK_STRIP);
  const long strips = (long)B * p->ntx;
  const long f1 = (long)ceil_div(cin, TC_CK) * 9 * p->n1, f2 = (long)ceil_div(cmid, TC_CK) * 16 * p->n2;
  auto rows_c1 = [&](int rows) { return (long)ceil_div(rows + 2, g.th1) * g.th1; };
  auto rows_c2 = [&](int rows) { return (long)ceil_div(rows, g.th2) * g.th2; };
  long best = -1;
  for (int run = std::min(BLK_MIN_RUN, H); run <= H; run += 2) {
    const int r = run, nruns = ceil_div(H, run);
    const long waves = (strips * nruns + clusters - 1) / clusters;
    const long cost = waves * (rows_c1(r) * f1 + rows_c2(r) * f2);
    if (best < 0 || cost <= best) {
      best = cost;
      p->run = run;
      p->nruns = nruns;
    }
  }
  if (strips * p->nruns > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  p->units = (int)(strips * p->nruns);
  p->blocks = (int)std::min<long>(p->units, clusters) * C;
  p->c1_rows = 0;
  for (int rr = 0; rr < p->nruns; ++rr) p->c1_rows += rows_c1(std::min(p->run, H - rr * p->run));
  p->c1_rows *= strips;
  // K1's and K3's tensor-core blocks at these sizes (plan_conv's rule: the
  // route once its tiles fill half the SMs, from 32 columns).
  auto tc_blocks = [&](int K, int c, int nphase) {
    const int cgt = ceil_div(c, CO), nsplit = ceil_div(cgt, MAX_CG);
    const TcGeom tg = tc_geom(K, ceil_div(cgt, nsplit) * CO);
    return (long)ceil_div(W, TC_W) * ceil_div(H, tg.th) * B * (nphase / tg.ppb) * nsplit;
  };
  p->takes = W >= 32 && 2 * tc_blocks(3, cmid, 1) > info.sms && 2 * tc_blocks(2, cout, 4) > info.sms &&
             2 * strips * ceil_div(H, BLK_MIN_RUN) > clusters;
  ConvPlan& l = p->launch;
  l.grid = dim3((unsigned)p->blocks);
  l.block = dim3(TC_THREADS);
  l.smem = sizeof(float) * (size_t)g.floats;
  l.cluster = C;
  return 0;
}

// Words of the stage-weights workspace at these widths (0: widths the
// kernel does not take).
template <typename E>
inline long block_workspace(int cin, int cmid, int cout) {
  BlockPlan p;
  if (cin < 1 || !plan_block_widths<E>(cmid, cout, &p)) return 0;
  constexpr int CK = Elem<E>::CK;
  const int c1n = ceil_div(cin, CK) * (p.geom.dys ? 3 : 1), c2n = ceil_div(cmid, CK);
  return p.cluster * blk_ws_rank(p.geom, c1n, c2n, 4 / p.geom.ppb2);
}

// The launches at widths (N1, N2): the weights laid out, then the block
// kernel.  Widths whose geometry does not fit two stages are never
// planned, and not built.
template <typename E, typename O, int N1, int N2>
int launch_block(const BlockPlan& p, int dev, const DeviceInfo& info, cudaStream_t stream,
                 const E* x, const E* w1, const float* b1, const E* w2,
                 const float* b2, float* ws, O* y, int cin, int cmid, int cout, int H, int W,
                 float slope, float eps) {
  if constexpr (blk_geom(N1, N2).stages >= 2) {
    constexpr BlkGeom G = blk_geom_of<E>(N1, N2);
    constexpr int CK = Elem<E>::CK;
    const int cmidp = ceil_div(cmid, CO) * CO, coutp = ceil_div(cout, CO) * CO;
    const int nq = ceil_div(cin, CK) * (G.dys ? 3 : 1) + (4 / G.ppb2) * ceil_div(cmid, CK);
    block_split_weights<E, N1, N2><<<dim3(nq, p.cluster), 128, 0, stream>>>(w1, w2, ws, cin, cmid, cmidp, coutp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return launch<block_tc_kernel<E, O, N1, N2>>(p.launch, dev, info, stream, x, (const float*)ws, b1, b2, y,
                                              cin, cmid, cout, H, W, p.ntx, p.run, p.nruns, p.units,
                                              p.cluster, slope, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// The exports of a K4 library of element type E (block3x3.cu,
// block3x3_bf16.cu).

// The geometry at these widths for tests: out = {N1, N2, nsplit1, nsplit2,
// cluster, t1, dys, TH1, TH2, ring rows, stages, shared-memory bytes}.
// Returns 0, or 1 for widths the kernel does not take.
template <typename E>
int block_tile_out(int cmid, int cout, int* out) {
  BlockPlan p;
  if (!plan_block_widths<E>(cmid, cout, &p)) return 1;
  const BlkGeom& g = p.geom;
  const int v[12] = {p.n1, p.n2, p.nsplit1, p.nsplit2, p.cluster, g.t1, g.dys, g.th1, g.th2, g.nr,
                     g.stages, (int)(sizeof(float) * g.floats)};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

// The plan at these sizes on the current device: out = {takes, run rows,
// runs, strips a row of the image, units, blocks, cluster, conv1 rows
// computed in all (of 64 columns)}.  Returns a CUDA error code.
template <typename E>
int block_plan_out(int B, int cin, int cmid, int cout, int H, int W, long long* out) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  int err = current_device(&dev, &info);
  if (err != 0) return err;
  BlockPlan p;
  err = plan_block<E>(B, cin, cmid, cout, H, W, *info, &p);
  if (err != 0) return err;
  const long long v[8] = {p.takes, p.run, p.nruns, p.ntx, p.units, p.blocks, p.cluster, p.c1_rows};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// x: (B, cin, H, W); w1: (cin, 9, cmidp); b1: (cmid,); w2: (4, cmid, 4,
// coutp); b2: (cout,); ws: block_workspace<E> words; y: (B, cout, 2H, 2W)
// of O (the mixed pairs: the same plan and sums, only the store's type).
template <typename E, typename O>
int block_launch(const E* x, const E* w1, const float* b1, const E* w2, const float* b2, float* ws, O* y,
                 int B, int cin, int cmid, int cout, int H, int W, float slope, float eps,
                 cudaStream_t stream) {
  if (b1 == nullptr || b2 == nullptr || ws == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const DeviceInfo* info = nullptr;
  int err = current_device(&dev, &info);
  if (err != 0) return err;
  BlockPlan p;
  err = plan_block<E>(B, cin, cmid, cout, H, W, *info, &p);
  if (err != 0) return err;
#define MG_BLK(A, Bw) \
  if (p.n1 == A && p.n2 == Bw) return launch_block<E, O, A, Bw>(p, dev, *info, stream, x, w1, b1, w2, b2, ws, y, cin, cmid, cout, H, W, slope, eps);
#define MG_BLK_ROW(A) MG_BLK(A, 16) MG_BLK(A, 32) MG_BLK(A, 48) MG_BLK(A, 64) MG_BLK(A, 96) MG_BLK(A, 128)
  MG_BLK_ROW(16) MG_BLK_ROW(32) MG_BLK_ROW(48) MG_BLK_ROW(64) MG_BLK_ROW(96) MG_BLK_ROW(128)
#undef MG_BLK_ROW
#undef MG_BLK
  return (int)cudaErrorInvalidValue;
}

}  // namespace mg
