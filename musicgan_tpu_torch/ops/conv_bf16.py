"""The bf16 conv kernels K1 bf16 and K3 bf16 (``csrc/conv_bf16.cuh``): their
launch plan, mirrored here from the sizes and the SM count alone, and the
weight pack they read.

Both kernels are one implicit GEMM on the tensor cores, bf16 ``wgmma``
m64nNk16 with A and B read from shared memory by descriptor.  A tile is a
window of the input: ``nb`` images (``nb`` > 1 only for whole images), of
each ``th`` rows and ``tc`` columns, staged with a halo of one row above
and below each image and of one column left (and ``sw - tc - 1`` right),
landing by TMA as ``[row][16 channels][sw + 16]`` (image columns from ``c0
- 8``: a box starts on 16 bytes; an odd number of 16-byte units a channel
row keeps the transposition's reads in distinct banks; zero outside the
image), then transposed in
shared memory to channels innermost, ``[octet][position][8 channels]``,
position ``row * sw + column``.  There a tap ``(dy, dx)`` is the same
window shifted by ``dy * sw + dx`` positions, a 16-byte-aligned start
address, so one descriptor per tap and m64 block serves as A; the output
positions of a tile are the ``64 * mb`` positions from ``sw + 1`` on (some
are halo or right-hand columns, computed and not stored).  B is the weight
pack of :func:`tc_weights`, resident in shared memory for the whole launch
where it fits, else copied a chunk of 16 input channels at a time.

Routes: ``small_bf16_tc`` when a tile holds whole images (``th == H``,
``tc >= W``; several images fold into one tile), ``large_bf16_tc`` for row
bands of one image.  The size rule, :func:`plan`, takes the tile of least
modelled time over both (``_tile_cost4``); no timing, so a conv sums in the
same order run after run, and every route sums a pixel in one order:
chunks of 16 input channels in order, in each the kernel rows ``dy`` in
order, each row's column taps ``dx`` in order into a fresh accumulator that
is then added to the tile's in float32 (the order of ``conv_tile.cuh``'s
tensor-core route, which K4 bf16 also keeps, so K4 bf16 equals K1 bf16 then
K3 bf16 bit for bit).

K4 bf16 (``csrc/block_bf16.cuh``) reads the same packs and keeps the same
order; :func:`block_plan` mirrors its plan (strip width, run length,
weights resident or streamed, warpgroups a block; past 128 channels the
cluster and each conv's splits) and says whether the generator takes it
(``takes``).

A float32 output (the JAX functions' bf16 ``x`` with ``out_dtype=float32``,
and K2 with bf16 ``x``) leaves through the bf16 output's staging region in
two halves of the block's channels, ``[phase][N / 2][8 mb + 1][8]`` floats,
the same bytes: so neither plan (nor its mirror here) depends on the output
type, and the float32 output rounded to bf16 is the bf16 output's bits.
"""

from __future__ import annotations

import functools

import torch

__all__ = [
    "ROUTES",
    "SMEM_BUDGET",
    "BLOCK_MAX_CHANNELS",
    "CLUSTER_MAX_CHANNELS",
    "block_geometry",
    "cluster_fits",
    "block_plan",
    "block_route",
    "channel_split",
    "geometry",
    "plan",
    "routes_for",
    "tc_weights",
    "tc_weights_shape",
]

# Route codes of the C launcher (0: the size rule's).
ROUTES = {1: "small_bf16_tc", 2: "large_bf16_tc"}
ROUTE_CODES = {name: code for code, name in ROUTES.items()}
# Most dynamic shared memory a Hopper block may ask for (232,448 bytes),
# less room for the mbarriers' alignment.
SMEM_BUDGET = 232448 - 1024
MAX_TC = 224          # widest tile: a TMA box of tc + 24 columns, at most 256
CHUNK = 16            # input channels a chunk (one k16 step)
MAX_PIXEL_NORM_SPLITS = 8  # a portable cluster


def channel_split(cout: int) -> tuple[int, int]:
    """``(N, nsplit)``: output channels a block (a multiple of 16, at most
    128) and the blocks a pixel's channels are split over."""
    groups = -(-cout // 16)
    nsplit = -(-groups // 8)
    return 16 * -(-groups // nsplit), nsplit


def _acc_tiles(n: int) -> int:
    """m64 x n accumulators a warpgroup holds (two register sets of them:
    the tile's sums and the fresh one, 128 floats a thread)."""
    return 8 if n <= 16 else 4 if n <= 32 else 2 if n <= 64 else 1


def geometry(k: int, n: int) -> dict:
    """Per tile at ``n`` channels a block: ``mb`` m64 blocks of positions,
    ``ppb`` sub-pixel phases (K3: all four up to 32 channels, else the two
    of one output row parity), ``taps`` a phase, ``wtaps`` the taps of the
    weights a tile reads (all of them, or K3's two phases)."""
    if k == 3:
        return {"mb": _acc_tiles(n), "ppb": 1, "taps": 9, "wtaps": 9}
    ppb = 4 if n <= 32 else 2
    return {"mb": max(1, _acc_tiles(n) // ppb), "ppb": ppb, "taps": 4, "wtaps": 4 * ppb}


def _wgmma_clk4(n: int) -> int:
    """Modelled clocks (times 4) of one m64nNk16 on an SM: its products at
    2048 bf16 MACs a clock, or its operands (2 KB of A, 32n bytes of B) at
    128 bytes of shared memory a clock, the larger."""
    return max(2 * n, 64 + n)


def _smem(k, n, g, nwg, sw, rows_w, resident, stages, nchunks, nsplit, pixel_norm) -> int:
    """Bytes of shared memory a block takes (``conv_bf16.cuh::cb_layout``),
    either output type: ``out`` holds a tile's bf16 outputs or half its
    float32 ones."""
    raw = 32 * rows_w * (sw + 16)
    wchunk = 32 * n * g["wtaps"]
    ptrans = _round(max(rows_w * sw + 1, 64 * g["mb"] + 2 * sw + 2), 8)
    trans = 32 * ptrans
    out = g["ppb"] * n * (8 * g["mb"] + 1) * 16
    region = _round(max(trans, out), 128)
    stage = _round(raw + (0 if resident else wchunk), 128)
    wres = nchunks * 32 * n * (9 if k == 3 else 16) if resident else 0
    part = 2 * g["mb"] * g["ppb"] * 64 * 4 if pixel_norm and nsplit > 1 else 0
    return wres + nwg * (stages * stage + region) + part + 8 * (nwg * 4 + 1)


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


def _stages_and_residency(k, n, g, nwg, sw, rows_w, nchunks, nsplit, pixel_norm):
    """``(resident, stages, smem)``: the weights resident where two stages
    fit beside them, the stages as many as fit up to 4; None where not even
    two streamed stages fit."""
    for resident in (True, False):
        best = None
        for stages in (4, 3, 2):
            s = _smem(k, n, g, nwg, sw, rows_w, resident, stages, nchunks, nsplit, pixel_norm)
            if s <= SMEM_BUDGET:
                best = (resident, stages, s)
                break
        if best is not None:
            return best
    return None


# Modelled fixed clocks of a tile: its epilogue (bias, LeakyReLU, PixelNorm,
# the staging of its outputs) and its stores, 2.5-4K clocks a tile at
# synthesis's large shapes (a clock64 profile of the kernel on an NVIDIA
# H100 80GB HBM3 at 700 W; PERF.md §6).
TILE_FIXED_CLK = 2500


def _tile_cost4(k, n, g, nchunks, streamed, sw, rows_w, outputs) -> int:
    """Modelled clocks (times 4, integers, so that the C launcher's rule is
    the same to the last bit) of one tile on an SM: each chunk's work, its
    products and its transposition (3 clocks a staged position, as
    profiled), or its copies (the window at 32 bytes a clock from L2, and
    the weights where they stream), whichever is longer; then the tile's
    stores (64 bytes a clock) and its fixed cost."""
    rw = sw + 16
    work = g["mb"] * g["ppb"] * g["taps"] * _wgmma_clk4(n) + 12 * rows_w * rw
    copies = 4 * (rows_w * rw + (g["wtaps"] * n if streamed else 0))
    return nchunks * max(work, copies) + outputs * g["ppb"] * n // 8 + 4 * TILE_FIXED_CLK


def plan(k: int, bsz: int, cin: int, cout: int, h: int, w: int, pixel_norm: bool, sms: int,
         route: int = 0, tc: int = 0) -> dict:
    """The launch plan of K1 bf16 (``k=3``) or K3 bf16 (``k=2``) at these
    sizes on a card of ``sms`` SMs: ``conv_bf16.cuh::plan_cb`` in Python.
    ``route``: 0 for the size rule, 1 (``small_bf16_tc``) or 2
    (``large_bf16_tc``) to force one; ``tc`` (a multiple of 16) forces
    the tile's columns (both for measurements and tests only).  Raises
    ValueError where no tile fits (or the forced ones have none).

    The rule: every tile of ``tc`` columns (multiples of 16 up to 240 and
    the width rounded up), ``th`` rows and, for whole images, ``nb``
    images, whose output positions fit the warpgroup's ``64 * mb`` and
    whose stages fit in shared memory, is costed as ``ceil(tiles * nsplit
    / sms)`` rounds of :func:`_tile_cost4`; the least cost wins (ties: the
    widest, then tallest, then most images, the order tried).  A block
    holds two warpgroups, each walking its own tiles, unless every block
    gets one tile or PixelNorm meets across a cluster (then one)."""
    if min(bsz, cin, cout, h, w) < 1 or k not in (2, 3) or route not in (0, 1, 2):
        raise ValueError(f"plan: sizes {(k, bsz, cin, cout, h, w)}, route {route}")
    n, nsplit = channel_split(cout)
    if pixel_norm and nsplit > MAX_PIXEL_NORM_SPLITS:
        raise ValueError(f"plan: PixelNorm over {cout} channels")
    clustered = bool(pixel_norm and nsplit > 1)
    g = geometry(k, n)
    nchunks = -(-cin // CHUNK)
    budget = 64 * g["mb"]
    nph = 2 if g["ppb"] == 2 else 1
    best = None
    for tcc in range(min(MAX_TC, _round(w, 16)), 0, -16):
        if tc and tcc != tc:
            continue
        sw = tcc + 8
        ntx = -(-w // tcc)
        whole = tcc >= w
        for th in range(min(h, budget // sw + 1), 0, -1):
            for nb in (range(bsz, 0, -1) if whole and th == h else (1,)):
                span = ((nb - 1) * (th + 2) + th - 1) * sw + tcc
                rt = 1 if whole and th == h else 2
                if span > budget or (route and rt != route):
                    continue
                rows_w = nb * (th + 2)
                ntiles = ntx * -(-h // th) * -(-bsz // nb) * nph
                ncl = min(ntiles, max(1, sms // nsplit))
                nwg = 1 if clustered or ntiles <= ncl else 2
                fit = _stages_and_residency(k, n, g, nwg, sw, rows_w, nchunks, nsplit, pixel_norm)
                if fit is None:
                    continue
                resident, stages, smem = fit
                cost = -(-ntiles * nsplit // sms) * _tile_cost4(
                    k, n, g, nchunks, not resident, sw, rows_w, nb * th * min(tcc, w))
                if best is None or cost < best[0]:
                    best = (cost, dict(route=ROUTES[rt], route_code=rt, tc=tcc, sw=sw, th=th, nb=nb,
                                       ntx=ntx, nty=-(-h // th), nbz=-(-bsz // nb), nph=nph, ntiles=ntiles,
                                       resident=resident, stages=stages, smem_bytes=smem, nwg=nwg,
                                       blocks=ncl * nsplit))
    if best is None:
        raise ValueError(f"plan: no tile (route {route}, tc {tc}) fits sizes {(k, bsz, cin, cout, h, w)}")
    p = best[1]
    p.update(n=n, nsplit=nsplit, cluster=nsplit if clustered else 1, threads=128 * p["nwg"],
             nchunks=nchunks, cost=best[0], **g)
    return p


def routes_for(k: int, bsz: int, cin: int, cout: int, h: int, w: int, pixel_norm: bool, sms: int) -> list[str]:
    """The routes that have a tile at these sizes."""
    out = []
    for code, name in ROUTES.items():
        try:
            plan(k, bsz, cin, cout, h, w, pixel_norm, sms, code)
        except ValueError:
            continue
        out.append(name)
    return out


def tc_weights_shape(k: int, cin: int, cout: int) -> tuple[int, ...]:
    n, nsplit = channel_split(cout)
    return (nsplit, -(-cin // CHUNK), 9 if k == 3 else 16, 2, n, 8)


def tc_weights(wk: torch.Tensor, upconv: bool, cout: int) -> torch.Tensor:
    """The pack K1 bf16 / K3 bf16 read, from the kernel layout
    ``wk`` (``kernel_weights``: ``(cin, 9, coutp)``, or
    ``kernel_upconv_weights``: ``(4, cin, 4, coutp)``, in the kernel's
    dtype): ``(nsplit, chunks, taps, 2, N, 8)``, a chunk's taps each
    ``[octet][output channel][8 input channels]`` (``wgmma``'s K-major B in
    128-byte core matrices), K3's taps phase-major (``phase * 4 + tap``),
    zero past ``cin`` and ``cout``.  The same values as ``wk``, moved."""
    if upconv:
        _, cin, _, coutp = wk.shape
        t = wk.permute(1, 0, 2, 3).reshape(cin, 16, coutp)      # (cin, phase * 4 + tap, coutp)
    else:
        cin, _, coutp = wk.shape
        t = wk
    taps = t.shape[1]
    n, nsplit = channel_split(cout)
    nchunks = -(-cin // CHUNK)
    full = t.new_zeros(nchunks * CHUNK, taps, nsplit * n)
    width = min(coutp, nsplit * n)
    full[:cin, :, :width] = t[:, :, :width]
    full[:, :, cout:] = 0
    # (chunk, octet, i, tap, split, n) -> (split, chunk, tap, octet, n, i)
    return full.reshape(nchunks, 2, 8, taps, nsplit, n).permute(4, 0, 3, 1, 5, 2).contiguous()


# ---- K4 bf16 (csrc/block_bf16.cuh): a whole generator block in one launch,
# c1 kept in shared memory in conv2's operand layout.  Its plan, mirrored
# here from ``plan_kb`` integer for integer so that the generator's choice
# (``ops/conv.py::fused_block_fits``) is known without the card.

# Widest conv1 and conv2 one block takes (no cluster); past them the same
# kernel runs over a cluster of MAX_PIXEL_NORM_SPLITS blocks at most, where
# its layout fits (cluster_fits), else csrc/block3x3.cuh at bf16.
BLOCK_MAX_CHANNELS = 128
CLUSTER_MAX_CHANNELS = MAX_PIXEL_NORM_SPLITS * BLOCK_MAX_CHANNELS
BLOCK_MAX_TC = 224
# Modelled fixed clocks of a c1 row (its epilogue, the ring's stores) and of
# an output row's pass (epilogue, staging, stores).
ROW1_FIXED_CLK, ROW2_FIXED_CLK = 1000, 2500
# A unit's modelled time on an SM that nwg warpgroups share, in eighths of
# its clocks (index nwg), fitted to K4 bf16 against K1 bf16 then K3 bf16 at
# blocks 4-7 of synthesis on an H100 (PERF.md): alone, a warpgroup's chain
# of waits goes unhidden; two hide part of it, three more.
NWG_EIGHTHS = (0, 20, 12, 7)
# With a cluster: modelled clocks of one cluster barrier (a c1 row meets
# twice, an output pass once), and a wave of units (one a cluster, both
# warpgroups on it) at its modelled clocks times 23 / 20, fitted to the
# cluster route against K1 bf16 then K3 bf16 at 13 shapes past 128 channels
# on an H100 (PERF.md; ``scripts/torch_conv_sweep.py --part k4wide``).
CLUSTER_SYNC_CLK, CLUSTER_WAVE_TWENTIETHS = 1500, 23


def _kb_peer_cost4(ptr2: int) -> int:
    """Modelled clocks (times 4) of copying a peer's c1 chunk (``32 * ptr2``
    bytes) through distributed shared memory, 16 bytes a clock."""
    return 4 * 2 * ptr2


def cluster_fits(cin: int, cmid: int, cout: int) -> bool:
    """Whether K4 bf16's cluster route takes these widths
    (``block_bf16.cuh::kb_cluster_fits``), by the widths alone: past 128
    channels (either conv) and up to ``CLUSTER_MAX_CHANNELS``, where its
    smallest layout (16-column strips, both convs' weights streamed, two
    stages) fits a block.  Every rank holds three transposed rows of every
    input chunk, so wide inputs do not fit."""
    if min(cin, cmid, cout) < 1 or max(cmid, cout) > CLUSTER_MAX_CHANNELS:
        return False
    (n1, ns1), (n2, ns2) = channel_split(cmid), channel_split(cout)
    if ns1 == ns2 == 1:
        return False
    geo = block_geometry(cmid, cout)
    lay = _kb_layout(n1, n2, geo["mb"], -(-cin // CHUNK), -(-cmid // CHUNK), 16, 1, False, False, 2,
                     geo["pp2"], True)
    return lay["total"] <= SMEM_BUDGET


def block_route(cmid: int, cout: int, cin: int) -> str:
    """K4 bf16's route by the widths alone: ``"bf16_tc"`` (``block_bf16.cuh``,
    one block) where both convs have at most 128 channels; past them
    ``"bf16_cluster"`` (the same kernel over a cluster,
    ``block3x3_bf16_wide.cu``) where :func:`cluster_fits`, else
    ``"template"`` (``block3x3.cuh`` at bf16, ``block3x3_bf16_template.cu``)."""
    if cmid <= BLOCK_MAX_CHANNELS and cout <= BLOCK_MAX_CHANNELS:
        return "bf16_tc"
    return "bf16_cluster" if cluster_fits(cin, cmid, cout) else "template"


def _mb1_max(n1: int) -> int:
    return min(160 // n1, 2)


def _mb2_max(n2: int) -> int:
    v = 320 // (3 * n2)
    return 1 if v < 1 else min(v, 2)


def block_geometry(cmid: int, cout: int) -> dict:
    """The widths' part of K4 bf16's plan (``mg_block3x3_tile``): channels a
    block ``n1``, ``n2`` and each conv's splits ``nsplit1``, ``nsplit2``
    (the pair's, :func:`channel_split`: K4 bf16 sums in their order), the
    ``cluster`` (``max(nsplit1, nsplit2)``, 1 up to 128 channels), ``mb``
    m64 blocks of positions a row tile (``mb_wg`` a warpgroup's, ``mb`` below;
    with a cluster two warpgroups share each row tile, ``mb = 2 * mb_wg``;
    a warpgroup's from its registers:
    conv1's sums and fresh sums ``mb * n1`` floats, conv2's ``3 * mb * n2 /
    2``, at most 160 each but at ``n2 = 128``; at most two, so that
    two warpgroups' rings and windows fit a block), conv2's phases a pass
    ``pp2`` (all four where ``8 * mb * n2 / 2`` floats fit in 160, else the
    two of one row parity), the products in flight between waits (``dy1``
    conv1's kernel rows, 3 or 1; ``f2`` conv2's (kernel row, phase) fresh
    sums, 4, 2 or 1; registers as above), the warpgroups a block at most
    (``wgmax``: three, at 168 registers a thread, where the sums fit in 64
    floats with ``dy1`` 1, ``pp2`` 2 and ``f2`` 2; else two; with a cluster
    the two on each unit), and the widest strip ``max_tc`` (``64 * mb -
    16``: its ``tc + 2`` c1 columns fit conv1's ``mb`` blocks)."""
    (n1, nsplit1), (n2, nsplit2) = channel_split(cmid), channel_split(cout)
    mb = min(_mb1_max(n1), _mb2_max(n2))
    wgmax = 3 if 2 * mb * n1 // 2 <= 64 and 4 * mb * n2 // 2 <= 64 else 2
    pp2 = 4 if wgmax == 2 and 8 * mb * n2 // 2 <= 160 else 2
    dy1 = 3 if wgmax == 2 and 4 * mb * n1 // 2 <= 160 else 1
    if wgmax == 3:
        f2 = 2
    else:
        f2 = 4 if pp2 == 4 or 6 * mb * n2 // 2 <= 160 else 2 if 4 * mb * n2 // 2 <= 160 else 1
    cluster = max(nsplit1, nsplit2)
    mbt = 2 * mb if cluster > 1 else mb
    return {"n1": n1, "n2": n2, "nsplit1": nsplit1, "nsplit2": nsplit2, "cluster": cluster, "mb": mbt,
            "mb_wg": mb, "dy1": dy1, "f2": f2, "pp2": pp2, "wgmax": 2 if cluster > 1 else wgmax,
            "max_tc": min(BLOCK_MAX_TC, 64 * mbt - 16)}


def _kb_layout(n1, n2, mb, nch1, nch2, tc, nwg, res1, res2, stages, pp, cl=False) -> dict:
    """Bytes of a K4 bf16 block's shared memory (``block_bf16.cuh::kb_layout``):
    per warpgroup the stages (an input row's chunk as it lands, or a
    streamed chunk's weights), the staged outputs (with a cluster also the
    two staging slots of peer c1 chunks), the c1 ring of the block's ``n1 /
    16`` mid chunks (``ptr2`` positions an octet), and the transposed input rows
    (``pt1`` positions an octet, ``pr1`` in all with the junk rows' reach
    and the spare one); with a cluster PixelNorm's sums (``part``).  A
    ring slot holds ``ss`` positions (``64 * mb``, with a cluster the
    strip's ``tc + 2`` in steps of 16; the last slot's m64 blocks read ``64
    * mb + 2`` on), the staged outputs ``gs`` groups a channel (``8 * mb``,
    with a cluster the strip's ``tc / 8`` rounded up to an even number) in
    rows of ``gs + 1``."""
    sw, rw = tc + 8, tc + 24
    raw = 32 * rw
    w1chunk, w2chunk = 9 * 32 * n1, 4 * pp * 32 * n2
    stage = _round(max(raw, 0 if res1 else w1chunk, 0 if res2 else w2chunk), 128)
    pt1 = 3 * sw
    pr1 = 2 * nch1 * pt1 + 64 * mb + 8
    inr = _round(16 * pr1, 128)
    ss = _round(tc + 2, 16) if cl else 64 * mb
    gs = _round(-(-tc // 8), 2) if cl else 8 * mb
    ptr2 = 2 * ss + 64 * mb + 8
    region = _round(max(pp * n2 * (gs + 1) * 16, 64 * ptr2 if cl else 0), 128)
    ring = 32 * (n1 // 16) * ptr2
    w1res = nch1 * 9 * 32 * n1 if res1 else 0
    w2res = nch2 * 16 * 32 * n2 if res2 else 0
    wg = stages * stage + region + ring + inr
    bias = 4 * (n1 + n2)
    part = 4 * 64 * mb * (1 + pp) if cl else 0
    return {"raw": raw, "w1chunk": w1chunk, "w2chunk": w2chunk, "stage": stage, "region": region, "pt1": pt1,
            "pr1": pr1, "inr": inr, "ss": ss, "gs": gs, "ptr2": ptr2, "ring": ring, "w1res": w1res, "w2res": w2res, "wg": wg,
            "bias": bias, "part": part, "total": w1res + w2res + nwg * wg + bias + part + 8 * (nwg * 4 + 1)}


def _kb_in_cost4(nch1, rw) -> int:
    """Modelled clocks (times 4) of an input row: each chunk's transposition
    (3 clocks a staged position) or its copy, the longer."""
    return nch1 * max(12 * rw, 4 * rw)


def _kb_row1_cost4(n1, mb, nch1, res1) -> int:
    """Modelled clocks (times 4) of one c1 row: each chunk's products or its
    streamed weights' copy, the longer; the epilogue."""
    work = mb * 9 * _wgmma_clk4(n1)
    copies = 0 if res1 else 4 * 9 * n1
    return nch1 * max(work, copies) + 4 * mb * n1 + 4 * ROW1_FIXED_CLK


def _kb_row2_cost4(n2, mb, nch2, tc, res2, pp) -> int:
    """Modelled clocks (times 4) of one output row, its passes of ``pp``
    phases: each chunk's products (no copy of c1, no transposition) or its
    weights' copy; the stores and the epilogue."""
    work = mb * 4 * pp * _wgmma_clk4(n2)
    copies = 0 if res2 else 4 * 4 * pp * n2
    return 4 // pp * (nch2 * max(work, copies) + tc * pp * n2 // 8 + 4 * ROW2_FIXED_CLK)


@functools.lru_cache(maxsize=1024)
def _block_plan(bsz, cin, cmid, cout, h, w, sms, tc, run) -> dict:
    return _block_plan_uncached(bsz, cin, cmid, cout, h, w, sms, tc, run)


def block_plan(bsz: int, cin: int, cmid: int, cout: int, h: int, w: int, sms: int,
               tc: int = 0, run: int = 0) -> dict:
    """K4 bf16's launch plan at these sizes on a card of ``sms`` SMs
    (``block_bf16.cuh::plan_kb`` in Python, cached; widths up to 128, or
    past them where :func:`cluster_fits`): see
    :func:`_block_plan_uncached`."""
    return dict(_block_plan(bsz, cin, cmid, cout, h, w, sms, tc, run))


def _block_plan_uncached(bsz: int, cin: int, cmid: int, cout: int, h: int, w: int, sms: int,
                         tc: int = 0, run: int = 0) -> dict:
    """K4 bf16's launch plan at these sizes on a card of ``sms`` SMs
    (``block_bf16.cuh::plan_kb`` in Python).  ``tc``, ``run``:
    0, or a forced strip width (a multiple of 16 up to ``max_tc``) and run
    length (measurements and tests).  Raises ValueError where nothing fits.

    The rule: over every strip width (multiples of 16 from ``max_tc``, or
    the image's width rounded up, down; the m64 blocks stay ``mb``), the
    residency of each conv's weights (both, conv1's, conv2's, none) and
    every number of runs (each at its shortest run), the layout that fits
    (as many warpgroups a block as the units fill, up to ``wgmax``; stages
    as many as fit up to 4) of least modelled time, ``ceil(units / (blocks
    * nwg)) * nwg * ((run + 4) * in + (run + 2) * row1 + run * row2) *
    NWG_EIGHTHS[nwg] / 8`` (waves of a unit's input rows, c1 rows and output
    rows over the warpgroups, and what sharing an SM does to them); ties to
    the first found (wider, more
    resident, longer runs).  ``takes``: that time below K1 bf16
    then K3 bf16's (their plans' costs, with PixelNorm).  No timing.

    Past 128 channels (``cluster`` > 1, widths :func:`cluster_fits` takes):
    the same search with clusters of ``cluster`` blocks of two warpgroups
    (``nwg`` 2, both on every unit, one region of rings: a wave is a unit a
    cluster) for blocks (``blocks`` = as many clusters as the SMs hold, at most the
    units, times ``cluster``), a c1 row's two cluster barriers and an
    output pass's one added (``CLUSTER_SYNC_CLK``), and the copies of the
    peers' ``nch2 - n1 / 16`` c1 chunks, each whole a pass into a staging
    slot.  ``takes`` is False there: the cluster was measured at or above
    the pair at every shape timed on an H100 (``scripts/torch_conv_sweep.py
    --part k4wide``; the closest 1.000x), so the generator leaves those
    blocks to the pair; the cost still picks the layout."""
    if (min(bsz, cin, cmid, cout, h, w) < 1 or cmid > CLUSTER_MAX_CHANNELS or cout > CLUSTER_MAX_CHANNELS
            or tc < 0 or run < 0):
        raise ValueError(f"block_plan: sizes {(bsz, cin, cmid, cout, h, w)}, tc {tc}, run {run}")
    geo = block_geometry(cmid, cout)
    n1, n2, mb, mbw, cluster = geo["n1"], geo["n2"], geo["mb"], geo["mb_wg"], geo["cluster"]
    cl = cluster > 1
    if cl and not cluster_fits(cin, cmid, cout):
        raise ValueError(f"block_plan: widths {(cin, cmid, cout)} do not fit the cluster route")
    nch1, nch2 = -(-cin // CHUNK), -(-cmid // CHUNK)
    if tc % 16 or tc > geo["max_tc"]:
        raise ValueError(f"block_plan: strip width {tc} (a multiple of 16 up to {geo['max_tc']})")
    best = None
    for tcc in range(min(geo["max_tc"], _round(w, 16)), 0, -16):
        if tc and tcc != tc:
            continue
        ntx = -(-w // tcc)
        strips = bsz * ntx
        if strips * h > 0x3FFFFFFF:
            continue
        for res in (3, 2, 1, 0):
            r1, r2 = bool(res & 2), bool(res & 1)
            inp = _kb_in_cost4(nch1, tcc + 24)
            row1 = _kb_row1_cost4(n1, mbw, nch1, r1)
            row2 = _kb_row2_cost4(n2, mbw, nch2, tcc, r2, geo["pp2"])
            if cl:
                peer = max(0, nch2 - n1 // 16) * _kb_peer_cost4(2 * _round(tcc + 2, 16) + 64 * mb + 8)
                row1 += 4 * 2 * CLUSTER_SYNC_CLK
                row2 += 4 // geo["pp2"] * (peer + 4 * CLUSTER_SYNC_CLK)
            for nruns in range(1, h + 1):  # each number of runs once, at its shortest run
                rr = run if run else -(-h // nruns)
                if -(-h // rr) != nruns:
                    continue
                units = strips * nruns
                blocks = min(units, max(1, sms // cluster)) * cluster if cl else min(units, sms)
                for nwg in range(2 if cl else min(geo["wgmax"], -(-units // blocks)), 0, -1):
                    stages, lay = 0, None
                    for s in (4, 3, 2):
                        lay = _kb_layout(n1, n2, mb, nch1, nch2, tcc, 1 if cl else nwg, r1, r2, s, geo["pp2"],
                                         cl)
                        if lay["total"] <= SMEM_BUDGET:
                            stages = s
                            break
                    if not stages:
                        continue
                    slots = blocks // cluster if cl else blocks * nwg
                    rows = (rr + 4) * inp + (rr + 2) * row1 + rr * row2
                    cost = (-(-units // slots) * rows * CLUSTER_WAVE_TWENTIETHS // 20 if cl
                            else -(-units // slots) * nwg * rows * NWG_EIGHTHS[nwg] // 8)
                    if best is None or cost < best["cost"]:
                        best = dict(tc=tcc, ntx=ntx, run=rr, nruns=nruns, units=units, nwg=nwg, res1=r1,
                                    res2=r2, stages=stages, blocks=blocks, pt1=lay["pt1"], pr1=lay["pr1"],
                                    ptr2=lay["ptr2"], ss=lay["ss"], gs=lay["gs"], smem_bytes=lay["total"],
                                    cost=cost)
                    break
    if best is None:
        raise ValueError(f"block_plan: no layout fits sizes {(bsz, cin, cmid, cout, h, w)}")
    pair_cost = (plan(3, bsz, cin, cmid, h, w, True, sms)["cost"]
                 + plan(2, bsz, cmid, cout, h, w, True, sms)["cost"])
    best.update(geo, sw=best["tc"] + 8, rw=best["tc"] + 24, strips=best["ntx"], nch1=nch1, nch2=nch2,
                pair_cost=pair_cost, takes=not cl and best["cost"] < pair_cost, threads=128 * best["nwg"])
    return best
