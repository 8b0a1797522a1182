// The weight gradient of a 3x3 'SAME' convolution on the tensor cores in
// 3xTF32 (images of at most 16 x 16: float32 FMAs, the second route
// below), summed in a fixed order:
//   dw[o, i, ky, kx] = sum_{b, y, x} d[b, o, y, x] * x[b, i, y + ky - 1, x + kx - 1]
// (zero outside the image).  It replaces the library call the trainable conv
// made (torch.nn.grad.conv2d_weight; on the TPU, XLA's transposed conv in
// musicgan_tpu/ops/conv_vjp.py): cuDNN's default algorithms sum a pixel
// chunk's products with atomics in an order that changes from run to run,
// and its deterministic ones, on an H100, sum the 1.5 million pixels of a
// 512x512 batch of 6 into 16 channels 75 times further from float64 than
// the default (1.2e-4 against 1.7e-6, relative to the largest value).
//
// An implicit GEMM with the pixels as its K, in warpgroup products (wgmma
// m64nNk8, TF32) from conv_tile.cuh.  The row shift ky is moved from x to
// d: with p = (b, y', x) the pixel of x the product reads,
//   dw[o, i, ky, kx] = sum_p d[b, o, y' - ky + 1, x] * x[b, i, y', x + kx - 1],
// so that
//   M = 3 * cin: rows (i, kx) in slabs of 16 channels of one kx, slab s =
//       (channel slab s / 3, kx = s % 3): one warp's 16 rows of an m64 tile;
//       A = x shifted by kx columns, from registers (a shift is an address
//       offset there; wgmma's shared-memory operands must be aligned);
//   N = 3 * nb: columns (ky, o), nb = 16, 32 or 48 output channels a block
//       (past that, split evenly over blocks), so that one wgmma is
//       m64n48k8, m64n96k8 or m64n144k8; B = d shifted by ky rows, whole
//       rows, from shared memory;
//   K = B * H * W pixels.
// Why: with the taps all in M (M = 9 cin, N = cout) the 512x512 convs (cout
// 16 and 32) would issue 15 m64n16k8 or 9 m64n32k8 a k8 step, and on an
// H100 such narrow products run at about a quarter of the tensor cores'
// rate (PERF.md §6 has the measurements); here they issue 6 m64n48k8 or 3
// m64n96k8, and load 3x fewer A fragments.  What bounds it: operations, 3
// TF32 products for each float32 one at 495 TFLOP/s, and for the 512x512
// convs as much the bytes of x and d read once (a stage-7 iteration's 34
// convs: 0.594 ms of 3xTF32, 1.450 of FP32); in practice the copies of x
// and of d's halo rows, and at tiny images a launch's fixed costs.
//
// The design:
// - K in chunks: a chunk is tr image rows x tc columns of one image (tc =
//   64, or the width rounded up to 8 below 64); its k8 steps are 8 pixels
//   of one row of it, padded to a multiple of 4 (the padding's d is zero).
// - Copies: x's channels of the block, the chunk's rows, columns c0 - 4 ..
//   c0 + tc + 7 ([channel][tr][sw]; tr and sw / 4 odd, so that a
//   fragment's 8 channels x 4 pixels fall in 32 distinct banks); d's
//   output channels of the block, rows r0 - 1 .. r0 + tr, as its K-major
//   quads ([row][pixel quad][n][4 pixels]).  By the tensor memory
//   accelerator (TMA, one thread, boxes zero outside the tensors, d's a 5-d
//   view whose innermost dimension is 4 pixels) where W is a multiple of 4,
//   else by 4-byte cp.async.  A producer warpgroup issues them into a ring
//   of stages.
// - B: each of the two consumer warpgroups takes half of every chunk's k8
//   steps and builds, a flush group's steps at a time, B = [quad][(ky,
//   o)][4] from d's rows (row r + 2 - ky for pixel row r), split into big
//   and small TF32 planes in a buffer of its own, then fences (wgmma reads
//   it) and meets its threads.  3xTF32 (big*big + big*small + small*big,
//   A split in registers): one TF32 product keeps about 3 digits, which
//   misses the 1e-5 bar over 1.5 million pixels
//   (tests/test_torch_wgrad_tc.py models both).
// - The tensor cores' own additions truncate, so products go to a fresh
//   accumulator that is added to the float32 sum (round to nearest) every
//   WG_FLUSH k8 steps; the next group's first products overwrite it
//   (scale-d 0).  A group's products are straight-line code: a runtime
//   condition between them would make ptxas serialise them.
// - Registers move from the producer to the consumers (setmaxnreg); at the
//   end the second consumer's sums are added to the first's (in that order)
//   through shared memory.
// - Large images (up to 1.57 M pixels into as few as 4,608 outputs): the
//   chunks are dealt to about one block an SM in turn (kblocks runs of at
//   most cpb chunks: run kb takes chunks kb, kb + kblocks, ..), each
//   writing its partial sums to a workspace; a second launch adds them in
//   run order, in rgroups groups of consecutive runs (each group in order,
//   then the groups in order), so that its loads are spread over enough
//   threads.  One run writes dw directly and skips the second launch.
// - The plan (plan_wgrad) comes from the sizes and the SM count only, never
//   from timing: the same inputs give the same bits run after run.  No
//   atomics, no library kernel.  ops/conv_vjp.py::wgrad_plan mirrors it.
//
// A second route for small images (wgrad_small_takes: both sides at most
// WS_MAX_SIDE), where the route above spends its time on fixed costs (a
// chunk pipeline for a few k8 steps, mostly padding below 8 columns, and a
// second launch): float32 FMAs on the CUDA cores, one launch.  A block
// takes 32 input channels (one a lane) x 32 output channels (8 a warp, in
// two halves of 4 warps) and a run of the flattened image rows (b, y); the
// rows of a chunk are staged with each image's halo rows and columns as
// zeros, so that a tap is an offset into the staged rows whatever the
// image's width, and each thread sums its 8 x 9 weights over its half's
// pixels in order.  The runs of one tile are the blocks of a cluster (at
// most 8), whose sums are added in rank order through distributed shared
// memory.
#include <cuda.h>  // CUtensorMap and its enums (the encoder is reached through the runtime)

#include "conv_tile.cuh"

namespace {

using namespace mg;

constexpr int WG_FLUSH = 4;         // k8 steps between flushes of the fresh accumulator
// Registers: 384 threads start at 168 each (launch bounds); the producer,
// which only issues copies, gives its spare ones to the consumers, which
// hold two sets of fragments, the fresh accumulators and the sums.  The
// counts sum to 384 x 168: setmaxnreg moves registers only within what the
// block was given, and a larger sum would make the consumers' increase wait
// for ever.
constexpr int WG_PRODUCER_REGS = 56, WG_CONSUMER_REGS = 224;
static_assert(128 * WG_PRODUCER_REGS + 256 * WG_CONSUMER_REGS <= TC_THREADS * 168, "setmaxnreg");
constexpr int WG_PIXELS = 256;      // pixels a chunk aims at
constexpr int WG_RED = 8;           // groups of runs the second launch adds in parallel
constexpr int WG_SMEM_BUDGET = 220 * 1024;  // bytes of stages and B buffers a block

// How the weight gradient of these sizes is launched.  nsplit blocks of nb
// output channels (N = 3 nb); slabs of 16 channels x one kx, m64 tiles of
// 4 slabs, groups of `tiles` tiles a block (both consumer warpgroups hold
// them); chunks of tr rows x tc columns, nch input channels staged a chunk,
// a channel plane of `plane` floats, a stage of `stage` floats, `stages`
// of them, each consumer's B buffer of `bbuf` floats; ntx x nty chunks an
// image; kblocks runs of at most cpb chunks; blocks = nsplit x groups x
// kblocks.
struct WgradPlan {
  int route;  // WG_ROUTE_TC or WG_ROUTE_SMALL
  int nsplit, nb, tiles, groups, slabs, nch, tc, tr, plane, stage, stages, bbuf, ntx, nty, chunks, cpb,
      kblocks, rgroups;
  // The small route: nti x nto tiles of WS_TI input x WS_TO output
  // channels, cluster blocks a tile taking rpb of the B H image rows each,
  // in chunks of rch rows (x staged in xcap floats, d in dcap pixels).
  int nti, nto, cluster, rpb, rch, xcap, dcap;
  int blocks;
  size_t smem;
};
constexpr int WG_ROUTE_TC = 0, WG_ROUTE_SMALL = 1;

// Output channels a block (16, 32 or 48: one wgmma of N = 48, 96 or 144),
// past the most the channels split evenly over blocks: 48 from 64x64
// images up, where fewer blocks a chunk stage less, 32 below, where more
// blocks fill the card (a size rule fitted on an H100 to the train step's
// shapes, PERF.md §6); m64 tiles a block: what the consumers' registers
// hold (two sets of 8 fragment registers, a fresh accumulator and a sum of
// 3 nb / 2 each, a tile).
inline int wgrad_max_nb(int H, int W) { return (long)H * W >= 64 * 64 ? 48 : 32; }
inline int wgrad_max_tiles(int nb) { return nb == 16 ? 2 : 1; }

// Floats of a staged input row: image columns c0 - 4 .. c0 + tc + 7, 16
// bytes a side for the one-pixel halo and an odd number of 16-byte words.
__host__ __device__ constexpr int wgrad_row_floats(int tc) { return tc + 12; }
// A chunk's k8 steps padded to a multiple of 4: an even share for each
// consumer warpgroup, which it takes in flush groups of WG_FLUSH steps and,
// where that leaves 2, one group of 2.
__host__ __device__ constexpr int wgrad_padded_steps(int ns) { return (ns + 3) / 4 * 4; }
// A consumer's B buffer: the big and small planes of one flush group's
// steps, 2 quads a step, 3 nb words of 4 floats a quad.
__host__ __device__ constexpr int wgrad_bbuf_floats(int nb) { return 2 * 2 * WG_FLUSH * 3 * nb * 4; }
// Where the stages' mbarriers lie (floats from the start of shared memory):
// after the stages and the B buffers, and after the second consumer's sums
// at the end.
__host__ __device__ constexpr int wgrad_barriers_at(int stages, int stage, int bbuf, int tiles, int nb) {
  return stages * stage + 2 * bbuf > 64 * tiles * 3 * nb ? stages * stage + 2 * bbuf : 64 * tiles * 3 * nb;
}

// The small route's geometry (see wgrad_small_kernel).
constexpr int WS_TI = 32;                 // input channels a block: one a lane
constexpr int WS_RO = 8;                  // output channels a warp
constexpr int WS_TO = 32;                 // output channels a block: 4 warps of WS_RO
constexpr int WS_THREADS = 256;           // two halves of 4 warps, each taking every other
                                          // 4 pixels of a chunk
constexpr int WS_XROW = WS_TI + 1;        // floats a staged x position: odd, so both copies
                                          // (lanes along positions) and reads (along channels)
                                          // meet 32 banks
constexpr int WS_PIXELS = 32;             // pixels a block of a cluster takes at least
constexpr int WS_MAX_SIDE = 16;           // the size rule: images of at most 16 x 16
constexpr int WS_SMEM = 100 * 1024;       // a block's staging (opt-in past 48 KB)

// The size rule between the routes (a fit on an H100 to the train step's
// shapes, PERF.md §6): the small route for images of at most 16 x 16.
inline bool wgrad_small_takes(int H, int W) { return H <= WS_MAX_SIDE && W <= WS_MAX_SIDE; }

// Staged rows of a chunk of r consecutive image rows (images of H rows):
// the rows and the two halo rows of each image they touch.
__host__ __device__ constexpr int ws_xrows(int r, int H) { return r + 2 + 2 * ((r + H - 2) / H); }

inline int plan_small(int B, int cin, int cout, int H, int W, int sms, WgradPlan* p) {
  p->nti = ceil_div(cin, WS_TI);
  p->nto = ceil_div(cout, WS_TO);
  const long tiles = (long)p->nti * p->nto, rows = (long)B * H;
  // Blocks a tile: as many as one wave holds, the pixels (at least
  // WS_PIXELS a block), the rows and a portable cluster allow; then as few
  // as take the rows in runs of rpb.  One wave: a block takes an SM (its
  // registers), and a cluster's blocks must share a GPC, so not every SM
  // takes one: 3/4 of them (on an H100, 96 blocks in clusters of 8 ran in
  // one wave, 112 in clusters of 7 and 128 in clusters of 8 in two;
  // PERF.md §6).
  const long cl = std::max(1L, std::min({(long)MAX_CLUSTER, rows, std::max(1L, 3L * sms / 4 / tiles),
                                         (rows * W + WS_PIXELS - 1) / WS_PIXELS}));
  const long rpb = (rows + cl - 1) / cl;
  auto dcap = [&](long r) { return (r * W + 3) / 4 * 4; };
  auto xcap = [&](long r) { return ((long)ws_xrows((int)r, H) * (W + 2) * WS_XROW + 3) / 4 * 4; };
  auto bytes = [&](long r) { return 4 * (xcap(r) + (WS_TO + 1) * dcap(r)); };
  long rch = rpb;
  while (rch > 1 && bytes(rch) > WS_SMEM) --rch;
  if (bytes(rch) > WS_SMEM || tiles * MAX_CLUSTER > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  p->cluster = (int)((rows + rpb - 1) / rpb);
  p->rpb = (int)rpb;
  p->rch = (int)rch;
  p->xcap = (int)xcap(rch);
  p->dcap = (int)dcap(rch);
  p->blocks = (int)(tiles * p->cluster);
  // The staging, and over it the block's sums for the cluster and the writes.
  p->smem = (size_t)std::max(bytes(rch), 4L * WS_TO * WS_TI * 9);
  return 0;
}

// route: WG_ROUTE_TC, WG_ROUTE_SMALL, or -1 for the size rule's.
inline int plan_wgrad(int B, int cin, int cout, int H, int W, int sms, int route, WgradPlan* p) {
  if (B < 1 || cin < 1 || cout < 1 || H < 1 || W < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  *p = WgradPlan{};
  p->cluster = 1;
  p->route = route < 0 ? (wgrad_small_takes(H, W) ? WG_ROUTE_SMALL : WG_ROUTE_TC) : route;
  if (p->route == WG_ROUTE_SMALL) return plan_small(B, cin, cout, H, W, sms, p);
  if (p->route != WG_ROUTE_TC) return (int)cudaErrorInvalidValue;
  p->nsplit = ceil_div(cout, wgrad_max_nb(H, W));
  p->nb = ceil_div(ceil_div(cout, p->nsplit), 16) * 16;
  p->slabs = 3 * ceil_div(cin, 16);
  const int mtiles = ceil_div(p->slabs, 4);
  p->groups = ceil_div(mtiles, wgrad_max_tiles(p->nb));
  p->tiles = ceil_div(mtiles, p->groups);
  // The input channels a stage holds: the most channel slabs the slabs of
  // one group's tiles reach.
  int span = 0;
  for (int gi = 0; gi < p->groups; ++gi) {
    const int s0 = 4 * gi * p->tiles, s1 = std::min(p->slabs, 4 * (gi + 1) * p->tiles);
    span = std::max(span, (s1 - 1) / 3 - s0 / 3 + 1);
  }
  p->nch = 16 * span;
  p->tc = W >= 64 ? 64 : ceil_div(W, 8) * 8;
  const int sw = wgrad_row_floats(p->tc);
  auto stage_floats = [&](int tr) { return (long)p->nch * tr * sw + (long)(tr + 2) * p->tc * p->nb; };
  const long bbuf = wgrad_bbuf_floats(p->nb);
  // Rows a chunk: odd (with sw, a channel plane is 4 words mod 8), up to
  // WG_PIXELS pixels and the image's height, fewer until three stages and
  // the B buffers fit.
  int tr = 1;
  while (tr + 2 <= std::min(H, std::max(1, WG_PIXELS / p->tc))) tr += 2;
  while (tr > 1 && 4 * (3 * stage_floats(tr) + 2 * bbuf) > WG_SMEM_BUDGET) tr -= 2;
  const long stage = stage_floats(tr);
  const long stages = std::min(4L, (WG_SMEM_BUDGET / 4 - 2 * bbuf) / stage);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  p->tr = tr;
  p->plane = tr * sw;
  p->stage = (int)stage;
  p->stages = (int)stages;
  p->bbuf = (int)bbuf;
  p->ntx = ceil_div(W, p->tc);
  p->nty = ceil_div(H, tr);
  const long chunks = (long)B * p->nty * p->ntx;
  const long units = (long)p->groups * p->nsplit;
  if (chunks > 0x7fffffffL || units > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  // As many runs as fill the card with at most one block an SM (a second
  // wave would double the time), at most one a chunk.
  const long kblocks = std::max(1L, std::min<long>(chunks, sms / units));
  const long cpb = (chunks + kblocks - 1) / kblocks;
  if (units * kblocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  p->chunks = (int)chunks;
  p->cpb = (int)cpb;
  p->kblocks = (int)kblocks;
  p->rgroups = (int)std::min<long>(WG_RED, kblocks);
  p->blocks = (int)(units * kblocks);
  p->smem = 4 * (size_t)wgrad_barriers_at((int)stages, (int)stage, (int)bbuf, p->tiles, p->nb) + 8 * 4;
  return 0;
}

// A thread's A fragment of one k8 step (rows: channels g and g + 8 of its
// warp's slab; columns: pixels t and t + 4 of the step; ap points at
// channel g, pixel t, shifted by the slab's kx), split in registers into big
// and small TF32 parts.
__device__ __forceinline__ void load_split_x(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* ap, int plane) {
  const float av[4] = {ap[0], ap[8 * plane], ap[4], ap[8 * plane + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = to_tf32(av[i]);
    lo[i] = to_tf32(av[i] - __uint_as_float(hi[i]));
  }
}

// A k8 step's A fragments of a warpgroup's T tiles: tile u's from xs +
// off[u] (the step's pixel offset already in xs), split.
template <int T>
__device__ __forceinline__ void load_step(uint32_t (&hi)[T][4], uint32_t (&lo)[T][4], const float* xs,
                                          const int (&off)[T], int plane) {
#pragma unroll
  for (int u = 0; u < T; ++u) load_split_x(hi[u], lo[u], xs + off[u], plane);
}

// A k8 step's products for the T tiles as one commit group, term by term
// (big*big for every tile, then big*small, then small*big), so that each
// fresh accumulator's three products are T products apart.  FIRST: the
// flush group's first step, whose first product overwrites the fresh
// accumulator (scale-d 0) instead of adding to it.
template <int N, int T, bool FIRST>
__device__ __forceinline__ void issue_step(float (&dd)[T][N / 2], const uint32_t (&hi)[T][4],
                                           const uint32_t (&lo)[T][4], uint64_t b_big, uint64_t b_small) {
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < T; ++u) Wgmma<N>::mma(dd[u], hi[u], b_big, FIRST ? 0 : 1);
#pragma unroll
  for (int u = 0; u < T; ++u) Wgmma<N>::mma(dd[u], hi[u], b_small);
#pragma unroll
  for (int u = 0; u < T; ++u) Wgmma<N>::mma(dd[u], lo[u], b_big);
  wgmma_commit();
}

// Fresh accumulators added to the float32 sums (round to nearest).  The
// accumulators themselves are written only by wgmma: the next flush
// group's first products overwrite them (issue_step's FIRST), so nothing
// zeroes them here as add_fresh does for the conv route.
template <int T, int ND>
__device__ __forceinline__ void flush_fresh(float (&acc)[T][ND], float (&dd)[T][ND]) {
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      fence_operand(dd[u][k]);
      acc[u][k] += dd[u][k];
    }
}

// The tensor memory accelerator (TMA): a box of a tensor map copied to
// shared memory by one thread, zero outside the tensor, its bytes counted on
// an mbarrier of the stage.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// Waits for the phase of this parity to complete; traps (a launch error,
// not a hung card) if it has not after about two seconds.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}
__device__ __forceinline__ void tma_load_4d(float* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(float* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(smem_u32(bar))
      : "memory");
}

struct Chunk {
  int b, r0, c0;
};
__device__ __forceinline__ Chunk chunk_at(int q, int ntx, int nty, int tr, int tc) {
  const int tx = q % ntx, rest = q / ntx;
  return Chunk{rest / nty, (rest % nty) * tr, tx * tc};
}

// Block x = kb * units + unit, unit = group * nsplit + split: output
// channels [split * NB, split * NB + NB), the tiles [group * T, group * T +
// T) of M, chunks kb, kb + kblocks, kb + 2 kblocks, .. (so that the blocks
// at work at one time read neighbouring rows, and each other's halo rows
// from L2).  out: dw where kblocks == 1, else the workspace, run kb's
// partial sums at kb * cout * cin * 9, both laid out as dw (cout, cin, 3,
// 3).
template <int NB, int T>
__global__ void __launch_bounds__(TC_THREADS, 1)
wgrad_tc_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_d, int tma,
                const float* __restrict__ x, const float* __restrict__ d, float* __restrict__ out, int cin,
                int cout, int H, int W, int slabs, int nch, int tc, int tr, int plane, int stage, int S,
                int bbuf, int ntx, int nty, int chunks, int nsplit, int units) {
  constexpr int N = 3 * NB, ND = N / 2;
  // Named barriers (0 is __syncthreads'): stage s full 1 + s (4-byte
  // route: the producer warpgroup and the consumers) and empty 1 + S + s
  // (the consumers and the producer's warps that copy: all four on the
  // 4-byte route, the first on the TMA route); the two consumer
  // warpgroups' at the end; each consumer warpgroup's own.
  const int FULL = 1, EMPTY = 1 + S, COMBINE = 1 + 2 * S, OWN = 2 + 2 * S;
  const int empty_count = tma ? 256 + 32 : TC_THREADS;
  extern __shared__ __align__(128) float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) & 3, wg = tid >> 7;
  const int g = lane >> 2, t = lane & 3;
  const int unit = blockIdx.x % units, kb = blockIdx.x / units;
  const int split = unit % nsplit, group = unit / nsplit;
  const int o0 = split * NB, s_lo = 4 * group * T, c_lo = 16 * (s_lo / 3);
  const int kblocks = gridDim.x / units, total = (chunks - kb + kblocks - 1) / kblocks;
  const int sw = wgrad_row_floats(tc), ns = tr * tc / 8, nsp = wgrad_padded_steps(ns);
  const int P = tr * tc, rq = tc / 4;  // pixels a chunk; quads a row
  // Stage s's copies land on full[s] (the TMA route).
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + wgrad_barriers_at(S, stage, bbuf, T, NB));
  if (tma) {
    if (tid == 0) {
      for (int k = 0; k < S; ++k) mbar_init(&full[k]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  if (wg == TC_WG) {
    // ---- The producer. ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    const int pt = tid - 128 * TC_WG, pw = pt >> 5;
    // Chunk k of the block into stage k % S: the input's channels c_lo ..
    // c_lo + nch - 1, image rows r0 .. r0 + tr - 1, columns c0 - 4 .. c0 +
    // tc + 7, as [channel][row][sw]; d's output channels o0 .. o0 + NB - 1,
    // rows r0 - 1 .. r0 + tr, columns c0 .. c0 + tc - 1 as [row][quad][n][4];
    // zero outside the image, past cin and past cout.  By TMA (one thread;
    // the tensor maps of the launcher) where W is a multiple of 4, else
    // 4-byte copies, a warp's lanes along a row.
    auto issue = [&](int k) {
      const Chunk ch = chunk_at(kb + k * kblocks, ntx, nty, tr, tc);
      float* st = smem + (k % S) * stage;
      if (tma) {
        if (pt == 0) {
          mbar_expect_tx(&full[k % S], 4u * (uint32_t)(nch * plane + (tr + 2) * tc * NB));
          tma_load_4d(st, &tm_x, &full[k % S], ch.c0 - 4, ch.r0, c_lo, ch.b);
          tma_load_5d(st + nch * plane, &tm_d, &full[k % S], 0, o0, ch.c0 / 4, ch.r0 - 1, ch.b);
        }
        return;
      }
      for (int ci = pw; ci < nch; ci += 4) {
        const int c = c_lo + ci;
        for (int rl = 0; rl < tr; ++rl) {
          const int gr = ch.r0 + rl;
          const bool in = c < cin && gr < H;
          const float* src = x + (((size_t)ch.b * cin + (in ? c : 0)) * H + (in ? gr : 0)) * W;
          for (int j = lane; j < sw; j += 32) {
            const int gc = ch.c0 - 4 + j;
            const bool ok = in && gc >= 0 && gc < W;
            cp_async4(st + ci * plane + rl * sw + j, ok ? src + gc : x, ok);
          }
        }
      }
      float* dq = st + nch * plane;
      const int nl = lane & 7, ql = lane >> 3, dquads = (tr + 2) * rq;
      for (int blk = pw; blk < NB / 8 * ((dquads + 3) / 4); blk += 4) {
        const int n = 8 * (blk % (NB / 8)) + nl, qd = 4 * (blk / (NB / 8)) + ql;
        if (qd >= dquads) continue;
        const int j = qd / rq, c = 4 * (qd - j * rq);
        const int o = o0 + n, gr = ch.r0 - 1 + j, gc = ch.c0 + c;
        const bool in = o < cout && gr >= 0 && gr < H;
        const float* src = d + (((size_t)ch.b * cout + (in ? o : 0)) * H + (in ? gr : 0)) * W + gc;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = in && gc + e < W;
          cp_async4(dq + (qd * NB + n) * 4 + e, ok ? src + e : d, ok);
        }
      }
    };
    // Chunk k is stage k % S's phase (k / S) & 1 (TMA route: the
    // producer's first thread issues, its first warp takes the stages back)
    // or the k-th commit group (4-byte route: every producer thread).  The
    // first S are issued here, chunk k + S when the consumers give back
    // chunk k's stage.
    if (tma) {
      if (pw != 0) return;
      for (int k = 0; k < total; ++k) {
        if (k >= S) bar_sync(EMPTY + k % S, empty_count);
        issue(k);
      }
      return;
    }
    for (int k = 0; k < S; ++k) {
      if (k < total) issue(k);
      cp_async_commit();
    }
    for (int k = 0; k < total; ++k) {
      // Chunk k's copies have landed once at most S - 1 (then S - 2) later
      // groups are pending; then every producer thread's.
      if (k == 0) {
        if (S == 2) cp_async_wait<1>(); else if (S == 3) cp_async_wait<2>(); else cp_async_wait<3>();
      } else {
        if (S == 2) cp_async_wait<0>(); else if (S == 3) cp_async_wait<1>(); else cp_async_wait<2>();
      }
      bar_arrive(FULL + k % S, TC_THREADS);
      if (k >= 1) {
        const int kn = k - 1 + S;
        if (kn < total) {
          bar_sync(EMPTY + (k - 1) % S, empty_count);
          issue(kn);
        }
        cp_async_commit();
      }
    }
    return;
  }

  // ---- The consumers. ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  // Tile u's fragment base for this thread: its warp's slab (channel slab,
  // kx), channel g, pixel t, the slab's shift (kx - 1 columns; the stage's
  // column 4 is the chunk's first).  Past the last slab a warp reads the
  // group's first slab, and its rows are not stored.
  int off[T];
#pragma unroll
  for (int u = 0; u < T; ++u) {
    int s = s_lo + 4 * u + wq;
    if (s >= slabs) s = s_lo;
    off[u] = (16 * (s / 3) - c_lo + g) * plane + s % 3 + 3 + t;
  }
  float acc[T][ND], dd[T][ND];
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int k = 0; k < ND; ++k) acc[u][k] = dd[u][k] = 0.f;

  // This warpgroup's k8 steps of every chunk, WG_FLUSH to a flush group.
  // Two sets of fragments: step s + 1's are loaded and split while step
  // s's products run (the wait before it makes sure step s - 1's, which
  // used that set, are done).
  const int lo = wg * nsp / 2, hi = lo + nsp / 2;  // an even share
  float* bb = smem + S * stage + wg * bbuf;  // this warpgroup's B: big, then small
  const uint64_t b_big = smem_desc(bb, N * 16, 128), b_small = smem_desc(bb + bbuf / 2, N * 16, 128);
  uint32_t fhi[2][T][4], flo[2][T][4];
  // Step sp: pixels 8 sp .. 8 sp + 7 of the chunk, one row of it (a padding
  // step reads the last real step's input, against zero d).
  auto step_xoff = [&](int sp) {
    const int px = 8 * min(sp, ns - 1);
    return px / tc * sw + px % tc;
  };
  for (int k = 0; k < total; ++k) {
    const float* cur = smem + (k % S) * stage;
    if (tma)
      mbar_wait(&full[k % S], (k / S) & 1);
    else
      bar_sync(FULL + k % S, TC_THREADS);
    const float4* dq = reinterpret_cast<const float4*>(cur + nch * plane);
    load_step<T>(fhi[0], flo[0], cur + step_xoff(lo), off, plane);
    // A flush group of G steps from step s.  First its B: the chunk's quad
    // Q = 2 s + q (pixel row r = 4 Q / tc) and column (ky, o) is d's quad
    // of row r + 2 - ky, split into big and small (zero for a padding step;
    // the group before has waited for its products, the last readers); then
    // a fence (wgmma reads it) and the warpgroup's threads meet.  Then the
    // products: straight-line code, no condition between them.
    auto group = [&](auto gsize, int s) {
      constexpr int G = decltype(gsize)::value;
      static_assert(G % 2 == 0, "a flush group starts on the first set of fragments");
      float4* big = reinterpret_cast<float4*>(bb);
      float4* small = reinterpret_cast<float4*>(bb + bbuf / 2);
      for (int e = tid % 128; e < 2 * G * N; e += 128) {
        const int q = e / N, n = e - q * N, ky = n / NB, Q = 2 * s + q;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (4 * Q < P) {
          const int r = Q / rq;
          v = dq[((r + 2 - ky) * rq + Q - r * rq) * NB + n - ky * NB];
        }
        const float vv[4] = {v.x, v.y, v.z, v.w};
        float h[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          h[i] = __uint_as_float(to_tf32(vv[i]));
          l[i] = __uint_as_float(to_tf32(vv[i] - h[i]));
        }
        big[e] = make_float4(h[0], h[1], h[2], h[3]);
        small[e] = make_float4(l[0], l[1], l[2], l[3]);
      }
      fence_proxy_async();
      bar_sync(OWN + wg, 128);
      fence_tiles(dd);
#pragma unroll
      for (int p = 0; p < G; ++p) {
        // Step s + p's B quads start at word 2 p N.
        const uint64_t boff = (uint64_t)(p * N * 32) >> 4;
        if (p == 0)  // known at compile time: the loop is unrolled
          issue_step<N, T, true>(dd, fhi[0], flo[0], b_big + boff, b_small + boff);
        else
          issue_step<N, T, false>(dd, fhi[p & 1], flo[p & 1], b_big + boff, b_small + boff);
        wgmma_wait<1>();
        load_step<T>(fhi[(p + 1) & 1], flo[(p + 1) & 1], cur + step_xoff(s + p + 1), off, plane);
      }
      wgmma_wait<0>();
      flush_fresh(acc, dd);
    };
    int s = lo;
    for (; s + WG_FLUSH <= hi; s += WG_FLUSH) group(std::integral_constant<int, WG_FLUSH>{}, s);
    if (s < hi) group(std::integral_constant<int, 2>{}, s);
    if (k + S < total) bar_arrive(EMPTY + k % S, empty_count);  // the stage goes back
  }

  // The second warpgroup's sums added to the first's, through the stages
  // (every chunk is consumed and no copy is in flight).
  bar_sync(COMBINE, 256);
  float* ex = smem + tid % 128;
  if (wg == 1) {
#pragma unroll
    for (int u = 0; u < T; ++u)
#pragma unroll
      for (int k = 0; k < ND; ++k) ex[(u * ND + k) * 128] = acc[u][k];
  }
  bar_sync(COMBINE, 256);
  if (wg == 1) return;
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int k = 0; k < ND; ++k) acc[u][k] += ex[(u * ND + k) * 128];

  // A thread holds, of tile u, rows 16 wq + g + 8 i (channels g + 8 i of
  // its warp's slab, kx = slab % 3) and columns n = 8 j + 2 t + e (ky = n /
  // NB, output channel o0 + n % NB) as acc[u][4 j + 2 i + e].
  float* dst = out + (size_t)kb * cout * cin * 9;
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int s = s_lo + 4 * u + wq;
    if (s >= slabs) continue;
    const int kx = s % 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = 16 * (s / 3) + g + 8 * i;
      if (ci >= cin) continue;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * t + e, o = o0 + n % NB;
          if (o < cout) dst[((size_t)o * cin + ci) * 9 + (n / NB) * 3 + kx] = acc[u][4 * j + 2 * i + e];
        }
    }
  }
}

// dw[e] = the runs' partial sums of weight e in run order: thread (e, y)
// adds runs [y * gsz, y * gsz + gsz) in order, then thread (e, 0) adds the
// groups' sums in order.
__global__ void __launch_bounds__(32 * WG_RED)
wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, int kblocks, int rgroups,
                    int total) {
  __shared__ float sums[WG_RED][32];
  const int e = blockIdx.x * 32 + threadIdx.x, y = threadIdx.y;
  const int gsz = (kblocks + rgroups - 1) / rgroups, k0 = y * gsz, k1 = min(kblocks, k0 + gsz);
  float v = 0.f;
  if (e < total)
    for (int k = k0; k < k1; ++k) v += part[(size_t)k * total + e];
  sums[y][threadIdx.x] = v;
  __syncthreads();
  if (y == 0 && e < total) {
    float r = sums[0][threadIdx.x];
    for (int j = 1; j < rgroups; ++j) r += sums[j][threadIdx.x];
    dw[e] = r;
  }
}

// The small route.  Block x = tile * cluster + rank: input channels i0 ..
// i0 + 31 (lane), output channels o0 + 8 (warp % 4) .. + 7, the flattened
// image rows j = b H + y in [rank rpb, rank rpb + rpb), in chunks of rch
// rows; half warp / 4 of the block takes the chunk's pixels 8 k + 4 half ..
// + 3 (k = 0, 1, ..).
// A chunk stages x's rows j - 1 .. j + 1 of each of its images, zero on the
// halo rows between images and on the halo columns, as [position][channel]
// over positions q = (staged row) (W + 2) + column + 1, and d's pixels as
// [output channel][pixel] with each pixel's position (qs, already times
// WS_XROW).  Tap (ky, kx) of a pixel at q reads x at q + (ky - 1)(W + 2) +
// kx - 1.  Each thread adds its 8 x 9 products a pixel, pixel after pixel
// (a chunk's pixels padded to a multiple of 4 with zero d); a block's sum is
// its first half's plus its second's, the cluster's sums are added in rank
// order, and each block writes a slice of the tile in dw's order, a warp to
// consecutive weights.  No atomics.
__global__ void __launch_bounds__(WS_THREADS)
wgrad_small_kernel(const float* __restrict__ x, const float* __restrict__ d, float* __restrict__ dw, int cin,
                   int cout, int H, int W, int rows, int rpb, int rch, int csize, int xcap, int dcap) {
  extern __shared__ __align__(16) float4 smem_small[];
  float* xs = reinterpret_cast<float*>(smem_small);
  float* ds = xs + xcap;
  int* qs = reinterpret_cast<int*>(ds + WS_TO * dcap);
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, half = tid >> 7;
  const int rank = blockIdx.x % csize, tile = blockIdx.x / csize, nti = (cin + WS_TI - 1) / WS_TI;
  const int i0 = WS_TI * (tile % nti), o0 = WS_TO * (tile / nti);
  const int Wp = W + 2, HW = H * W;
  int toff[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) toff[tap] = ((tap / 3 - 1) * Wp + tap % 3 - 1) * WS_XROW;
  float acc[WS_RO][9];
#pragma unroll
  for (int r = 0; r < WS_RO; ++r)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) acc[r][tap] = 0.f;

  const int j_lo = rank * rpb, j_hi = min(rows, j_lo + rpb);
  for (int j0 = j_lo; j0 < j_hi; j0 += rch) {
    const int j1 = min(j_hi, j0 + rch);
    // Staged rows: from the halo row above row j0 to the one below row j1
    // - 1; image row j is staged row j + 2 b + 1 - pr_lo.
    const int pr_lo = j0 + 2 * (j0 / H), pr_hi = j1 + 1 + 2 * ((j1 - 1) / H);
    const int nq = (pr_hi - pr_lo + 1) * Wp, np = (j1 - j0) * W, npad = (np + 3) & ~3;
    __syncthreads();  // the chunk before is read
    for (int q = tid; q < nq; q += WS_THREADS) {
      const int pr = pr_lo + q / Wp, xp = q % Wp, b = pr / (H + 2), yp = pr % (H + 2);
      const bool in = yp >= 1 && yp <= H && xp >= 1 && xp <= W;
      const size_t at = in ? ((size_t)b * cin + i0) * HW + (size_t)(yp - 1) * W + xp - 1 : 0;
#pragma unroll 8
      for (int i = 0; i < WS_TI; ++i) {
        const bool ok = in && i0 + i < cin;
        cp_async4(xs + q * WS_XROW + i, ok ? x + at + (size_t)i * HW : x, ok);
      }
    }
    for (int p = tid; p < npad; p += WS_THREADS) {
      const bool in = p < np;
      int q = Wp + 1;  // a padding pixel's: any staged position (its d is zero)
      size_t at = 0;
      if (in) {
        const int j = j0 + p / W, xx = p % W, b = j / H;
        q = (j + 2 * b + 1 - pr_lo) * Wp + xx + 1;
        at = ((size_t)b * cout + o0) * HW + (size_t)(j - b * H) * W + xx;
      }
      qs[p] = q * WS_XROW;
#pragma unroll 8
      for (int o = 0; o < WS_TO; ++o) {
        const bool ok = in && o0 + o < cout;
        cp_async4(ds + o * dcap + p, ok ? d + at + (size_t)o * HW : d, ok);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    const float* xl = xs + lane;
    const float* dl = ds + WS_RO * warp * dcap;
    for (int p = 4 * half; p < npad; p += 8) {
      const int4 q4 = *reinterpret_cast<const int4*>(qs + p);
      float4 dv[WS_RO];
#pragma unroll
      for (int r = 0; r < WS_RO; ++r) dv[r] = *reinterpret_cast<const float4*>(dl + r * dcap + p);
      const int qq[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float xv[9];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) xv[tap] = xl[qq[k] + toff[tap]];
#pragma unroll
        for (int r = 0; r < WS_RO; ++r) {
          const float dk = k == 0 ? dv[r].x : k == 1 ? dv[r].y : k == 2 ? dv[r].z : dv[r].w;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) acc[r][tap] = fmaf(dk, xv[tap], acc[r][tap]);
        }
      }
    }
  }

  // The block's sums as the tile lies in dw, [o][i][tap] (32 x 32 x 9),
  // over the staging: the second half's, then the first's added to them;
  // then block `rank` adds its slice of the cluster's tiles in rank order
  // and writes it.
  __syncthreads();  // the staging is read
  float* red = xs;
  if (half == 1)
#pragma unroll
    for (int r = 0; r < WS_RO; ++r)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) red[((WS_RO * warp + r) * WS_TI + lane) * 9 + tap] = acc[r][tap];
  __syncthreads();
  if (half == 0)
#pragma unroll
    for (int r = 0; r < WS_RO; ++r)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        float& v = red[((WS_RO * warp + r) * WS_TI + lane) * 9 + tap];
        v = acc[r][tap] + v;
      }
  coop::cluster_group cluster = coop::this_cluster();
  if (csize > 1)
    cluster.sync();
  else
    __syncthreads();
  constexpr int total = WS_TO * WS_TI * 9, U = 4;  // U: loads in flight a thread
  const int sl = (total + csize - 1) / csize, e0 = rank * sl, e1 = min(total, e0 + sl);
  const float* first = csize > 1 ? cluster.map_shared_rank(red, 0) : red;
  for (int e = e0 + tid; e < e1; e += U * WS_THREADS) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int eu = e + u * WS_THREADS;
      v[u] = eu < e1 ? first[eu] : 0.f;
    }
    for (int k = 1; k < csize; ++k) {
      const float* peer = cluster.map_shared_rank(red, k);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int eu = e + u * WS_THREADS;
        if (eu < e1) v[u] += peer[eu];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int eu = e + u * WS_THREADS, ol = eu / (WS_TI * 9), rest = eu - ol * (WS_TI * 9);
      const int o = o0 + ol, i = i0 + rest / 9;
      if (eu < e1 && o < cout && i < cin) dw[((size_t)o * cin + i0) * 9 + rest] = v[u];
    }
  }
  if (csize > 1) cluster.sync();  // no block leaves while another reads its sums
}

int launch_small(const WgradPlan& p, int dev, const DeviceInfo& info, cudaStream_t stream, const float* x,
                 const float* d, float* dw, int B, int cin, int cout, int H, int W) {
  // Above 48 KB a kernel gets dynamic shared memory by request only: once
  // on this device.
  static bool opted_in[MAX_DEVICES] = {};
  if (p.smem > (size_t)info.smem_optin) return (int)cudaErrorInvalidValue;
  if (p.smem > 48 * 1024 && !opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(wgrad_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               info.smem_optin);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.blocks);
  cfg.blockDim = dim3(WS_THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, wgrad_small_kernel, x, d, dw, cin, cout, H, W, B * H, p.rpb,
                                           p.rch, p.cluster, p.xcap, p.dcap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime (no link against the
// driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// Error codes past the runtime's: a driver error of the tensor-map encoder.
constexpr int WG_ENCODE_ERROR = 10000;

// The kernel's boxes: x (B, cin, H, W) as [channel][row][sw columns]; d
// (B, cout, H, W) as a 5-d view (4 pixels, channel, quad of pixels, row,
// image), so that a box lands as d's K-major quads [row][quad][n][4].
int encode_maps(const WgradPlan& p, const float* x, const float* d, int B, int cin, int cout, int H, int W,
                CUtensorMap* mx, CUtensorMap* md) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t hw = (cuuint64_t)H * W;
  const cuuint64_t xdim[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)cin, (cuuint64_t)B};
  const cuuint64_t xstr[3] = {4ull * W, 4ull * hw, 4ull * hw * cin};
  const cuuint32_t xbox[4] = {(cuuint32_t)wgrad_row_floats(p.tc), (cuuint32_t)p.tr, (cuuint32_t)p.nch, 1};
  const cuuint64_t ddim[5] = {4, (cuuint64_t)cout, (cuuint64_t)W / 4, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t dstr[4] = {4ull * hw, 16, 4ull * W, 4ull * hw * cout};
  const cuuint32_t dbox[5] = {4, (cuuint32_t)p.nb, (cuuint32_t)p.tc / 4, (cuuint32_t)p.tr + 2, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUresult r = enc(mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), xdim, xstr, xbox, ones,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS)
    r = enc(md, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(d), ddim, dstr, dbox, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : WG_ENCODE_ERROR + (int)r;
}

template <int NB, int T>
int launch_wgrad(const WgradPlan& p, int dev, const DeviceInfo& info, cudaStream_t stream,
                 const float* x, const float* d, float* out, int B, int cin, int cout, int H, int W) {
  // Above 48 KB a kernel gets dynamic shared memory by request only: once
  // for this kernel on this device.
  static bool opted_in[MAX_DEVICES] = {};
  if (p.smem > (size_t)info.smem_optin) return (int)cudaErrorInvalidValue;
  if (p.smem > 48 * 1024 && !opted_in[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(wgrad_tc_kernel<NB, T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, info.smem_optin);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  // The TMA route where its tensor maps can describe x and d (rows of a
  // multiple of 16 bytes, 16-byte aligned), else 4-byte copies.
  const bool tma = (W & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(d) & 15) == 0;
  CUtensorMap mx = {}, md = {};
  if (tma) {
    const int err = encode_maps(p, x, d, B, cin, cout, H, W, &mx, &md);
    if (err != 0) return err;
  }
  wgrad_tc_kernel<NB, T><<<p.blocks, TC_THREADS, p.smem, stream>>>(
      mx, md, tma ? 1 : 0, x, d, out, cin, cout, H, W, p.slabs, p.nch, p.tc, p.tr, p.plane, p.stage, p.stages,
      p.bbuf, p.ntx, p.nty, p.chunks, p.nsplit, p.groups * p.nsplit);
  return (int)cudaGetLastError();
}

int plan_here(int B, int cin, int cout, int H, int W, int route, int* dev, const DeviceInfo** info,
              WgradPlan* p) {
  const int err = current_device(dev, info);
  if (err != 0) return err;
  return plan_wgrad(B, cin, cout, H, W, (*info)->sms, route, p);
}

}  // namespace

// The plan at these sizes on the current device (route: WG_ROUTE_TC,
// WG_ROUTE_SMALL or -1 for the size rule's), for the wrapper (its
// workspace: kblocks > 1 runs of cout x cin x 9 floats) and for tests:
// out = {route, blocks, shared-memory bytes, SMs, cluster, then the tensor-
// core route's nsplit, nb, tiles, groups, nch, tc, tr, stages, chunks, cpb,
// kblocks, rgroups, then the small route's nti, nto, rpb, rch} (the other
// route's zero).  Returns a CUDA error code.
extern "C" int mg_wgrad3x3_plan(int B, int cin, int cout, int H, int W, int route, int* out) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  WgradPlan p;
  const int err = plan_here(B, cin, cout, H, W, route, &dev, &info, &p);
  if (err != 0) return err;
  const int v[21] = {p.route, p.blocks, (int)p.smem, info->sms, p.cluster, p.nsplit, p.nb, p.tiles, p.groups,
                     p.nch, p.tc, p.tr, p.stages, p.chunks, p.cpb, p.kblocks, p.rgroups, p.nti, p.nto, p.rpb,
                     p.rch};
  for (int i = 0; i < 21; ++i) out[i] = v[i];
  return 0;
}

// x: (B, cin, H, W); d: (B, cout, H, W), the gradient at the conv's output
// (before its bias); part: the workspace (kblocks x cout x cin x 9 floats
// where the plan has more than one run, else unused); dw: (cout, cin, 3, 3);
// route as for mg_wgrad3x3_plan (the wrapper passes -1; a named route is
// for measurements and tests).
extern "C" int mg_wgrad3x3(const float* x, const float* d, float* part, float* dw, int B, int cin,
                           int cout, int H, int W, int route, cudaStream_t stream) {
  int dev = 0;
  const DeviceInfo* info = nullptr;
  WgradPlan p;
  int err = plan_here(B, cin, cout, H, W, route, &dev, &info, &p);
  if (err != 0) return err;
  if ((long)cout * cin * 9 > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  if (p.route == WG_ROUTE_SMALL) return launch_small(p, dev, *info, stream, x, d, dw, B, cin, cout, H, W);
  float* out = p.kblocks > 1 ? part : dw;
#define MG_WG(NB, T)                                                                           \
  if (p.nb == NB && p.tiles == T)                                                              \
  err = launch_wgrad<NB, T>(p, dev, *info, stream, x, d, out, B, cin, cout, H, W)
  err = (int)cudaErrorInvalidValue;
  MG_WG(16, 1); MG_WG(16, 2); MG_WG(32, 1); MG_WG(48, 1);
#undef MG_WG
  if (err != 0 || p.kblocks == 1) return err;
  const int total = cout * cin * 9;
  wgrad_reduce_kernel<<<ceil_div(total, 32), dim3(32, WG_RED), 0, stream>>>(part, dw, p.kblocks, p.rgroups,
                                                                           total);
  return (int)cudaGetLastError();
}
