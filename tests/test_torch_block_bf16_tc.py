"""K4 bf16 (``csrc/block_bf16.cuh``) without the card: the plan mirror
``ops/conv_bf16.py::block_plan`` and a numpy model of the kernel's data
path.

The model follows the kernel where layout matters: each input row's chunk
of 16 channels lands as the TMA box does (``[16 channels][tc + 24]``, image
columns from ``c0 - 8``), is transposed as ``ldmatrix.trans`` then
``stmatrix`` move it (window column ``wc`` is raw column ``wc + 6``) into
the chunk's ring of three input rows (slot ``row mod 3``), and is read
through the A descriptor (K-major core matrices, LBO between the two
octets, SBO 128) against the B descriptor of K1 bf16's pack, kernel row
``dy`` from the slot of input row ``r - 1 + dy``; c1, after its epilogue and
its one rounding to bf16, is written by the epilogue's ``stmatrix``
addresses into the ring of three c1 rows that conv2's descriptors read
(slot ``r mod 3``, ring column ``p`` = c1 column ``c0 - 1 + p``, zero
outside the image); each warpgroup's walk goes down its strip row by row
(input row ``k``, c1 row ``k - 2``, conv2's output row ``k - 3`` from c1
slots ``k - 4 .. k - 2``, in one pass of four phases or two of two), and
conv2's outputs go through ``stage_out``'s groups to the store map's
interleaved 32-byte runs.  Memory the kernel never writes starts as bf16
NaNs, so a valid output that read it would show.  Whole blocks at small,
ragged sizes are held against a float64 block of the same bf16 values (c1
rounded to bf16 as the JAX kernel's c1 scratch of ``x.dtype`` holds it),
and every output is stored exactly once.

Past 128 channels the model walks a cluster's ranks in step: each computes
its split of c1 into its own ring and its split of the outputs, PixelNorm's
sums meet in rank order, and conv2 copies a peer's c1 chunks into its
staging slots.  Run in float32 with each wgmma chain one exact sum, it
gives bit for bit what K1 bf16 then K3 bf16 give with the same chains
straight from the images (``_model_pair``), which is held to the plain
versions.
"""

import numpy as np
import pytest
import torch

from musicgan_tpu_torch.config import ModelConfig
from musicgan_tpu_torch.models.layers import subpixel_phase_kernels
from musicgan_tpu_torch.ops import conv as conv_ops
from musicgan_tpu_torch.ops import conv_bf16 as cb

SMS = 132  # an H100 SXM's
NAN16 = 0x7FC0  # a bf16 NaN: memory the kernel does not write


def _synthesis_blocks():
    """(B, cin, cmid, cout, H, W) of the 8 blocks of a 5-clip, nb_vec-10 call."""
    return [(5, ci, ci, co, 2 * 2**i, 20 * 2**i) for i, (ci, co) in enumerate(ModelConfig().gen_channels)]


SYNTHESIS = _synthesis_blocks()
RAGGED = [
    (1, 5, 7, 3, 3, 37), (2, 20, 24, 40, 5, 19), (1, 16, 48, 64, 4, 18), (3, 12, 32, 16, 2, 9),
    (2, 8, 16, 16, 6, 40), (1, 130, 128, 128, 9, 70), (6, 3, 100, 120, 33, 250), (1, 1, 1, 1, 1, 1),
]

# The launcher's plan (block_bf16.cuh::plan_kb, compiled for the host) at
# these sizes on 132 SMs: (takes, tc, run, runs, strips, units, blocks,
# warpgroups, w1 resident, w2 resident, stages, mb, shared bytes, cost,
# the pair's cost, pt1, pr1, ptr2).
HEADER_PLANS = {
    (5, 32, 32, 128, 2, 20): (0, 16, 1, 2, 2, 20, 20, 1, 1, 1, 4, 1, 210728, 128960, 37344, 72, 360, 200),
    (5, 128, 128, 112, 4, 40): (0, 16, 1, 4, 3, 60, 60, 1, 0, 0, 3, 1, 214632, 553920, 93920, 72, 1224, 200),
    (5, 112, 112, 96, 8, 80): (0, 32, 1, 8, 3, 120, 120, 1, 0, 0, 4, 1, 230376, 465200, 116656, 120, 1752, 200),
    (5, 96, 96, 80, 16, 160): (0, 48, 3, 6, 4, 120, 120, 1, 0, 0, 4, 1, 206184, 799520, 232160, 168, 2088, 200),
    (5, 80, 80, 64, 32, 320): (0, 48, 3, 11, 7, 385, 132, 1, 1, 0, 2, 1, 227048, 1604160, 651552, 168, 1752, 200),
    (5, 64, 64, 48, 64, 640): (0, 112, 16, 4, 6, 120, 120, 1, 1, 0, 2, 2, 223336, 2425120, 1871840, 360, 3016, 392),
    (5, 48, 48, 32, 128, 1280): (0, 96, 12, 11, 14, 770, 132, 2, 0, 0, 2, 2, 230024, 5257728, 4066560, 312, 2008, 392),
    (5, 32, 32, 16, 256, 2560): (1, 112, 26, 10, 23, 1150, 132, 3, 1, 0, 2, 2, 221864, 7798392, 8442032, 360, 1576, 392),
    (1, 5, 7, 3, 3, 37): (0, 16, 1, 3, 3, 9, 9, 1, 1, 1, 4, 2, 43816, 104480, 31360, 72, 280, 392),
    (2, 20, 24, 40, 5, 19): (0, 16, 1, 5, 2, 20, 20, 1, 1, 1, 4, 2, 131048, 138720, 34720, 72, 424, 392),
    (1, 16, 48, 64, 4, 18): (0, 16, 1, 4, 2, 8, 8, 1, 1, 1, 4, 1, 158824, 111640, 31200, 72, 216, 200),
    (3, 12, 32, 16, 2, 9): (0, 16, 1, 2, 1, 6, 6, 1, 1, 1, 4, 2, 69224, 114000, 33004, 72, 280, 392),
    (2, 8, 16, 16, 6, 40): (0, 16, 1, 6, 3, 36, 36, 1, 1, 1, 4, 2, 43816, 104480, 31360, 72, 280, 392),
    (1, 130, 128, 128, 9, 70): (0, 16, 1, 9, 5, 45, 45, 1, 0, 0, 3, 1, 221608, 615280, 103168, 72, 1368, 200),
    (6, 3, 100, 120, 33, 250): (0, 48, 3, 11, 6, 396, 132, 1, 1, 0, 3, 1, 219752, 2097120, 829408, 168, 408, 200),
    (1, 1, 1, 1, 1, 1): (0, 16, 1, 1, 1, 1, 1, 1, 1, 1, 4, 2, 43816, 104480, 31210, 72, 280, 392),
}


def _plan_tuple(p):
    return tuple(int(p[k]) for k in ("takes", "tc", "run", "nruns", "ntx", "units", "blocks", "nwg", "res1",
                                     "res2", "stages", "mb", "smem_bytes", "cost", "pair_cost", "pt1", "pr1",
                                     "ptr2"))


@pytest.mark.parametrize("size", sorted(HEADER_PLANS))
def test_block_plan_mirror_equals_the_headers_rule(size):
    assert _plan_tuple(cb.block_plan(*size, SMS)) == HEADER_PLANS[size]


@pytest.mark.parametrize("bsz,cin,cmid,cout,h,w", SYNTHESIS + RAGGED)
def test_block_plan_covers_every_output_once_and_fits(bsz, cin, cmid, cout, h, w):
    """Strips of ``tc`` columns and runs of ``run`` rows tile the image once;
    the layout fits a block; the strip's c1 columns fit conv1's m64 blocks
    and its outputs conv2's; the units are spread over the blocks'
    warpgroups."""
    p = cb.block_plan(bsz, cin, cmid, cout, h, w, SMS)
    assert p["tc"] % 16 == 0 and 16 <= p["tc"] <= p["max_tc"] <= cb.BLOCK_MAX_TC
    assert p["tc"] + 2 <= 64 * p["mb"] and p["rw"] <= 256  # the TMA box
    assert p["ntx"] == -(-w // p["tc"]) and p["nruns"] == -(-h // p["run"])
    assert p["units"] == bsz * p["ntx"] * p["nruns"] and p["blocks"] == min(p["units"], SMS)
    assert 1 <= p["nwg"] <= p["wgmax"] and p["units"] > p["blocks"] * (p["nwg"] - 1)
    assert 2 <= p["stages"] <= 4 and p["smem_bytes"] <= cb.SMEM_BUDGET
    cov = np.zeros((bsz, h, w), np.int64)
    for u in range(p["units"]):
        tx, rest = u % p["ntx"], u // p["ntx"]
        rr, b = rest % p["nruns"], rest // p["nruns"]
        ra = rr * p["run"]
        cov[b, ra : ra + p["run"], tx * p["tc"] : (tx + 1) * p["tc"]] += 1
    assert (cov == 1).all()
    assert (p["n1"], p["n2"]) == (cb.channel_split(cmid)[0], cb.channel_split(cout)[0])


@pytest.mark.parametrize("bsz,cin,cmid,cout,h,w", SYNTHESIS + RAGGED)
def test_fused_block_fits_in_bf16_takes_what_the_plan_takes(bsz, cin, cmid, cout, h, w):
    p = cb.block_plan(bsz, cin, cmid, cout, h, w, SMS)
    assert conv_ops.fused_block_fits(cin, cmid, cout, size=(bsz, h, w), dtype=torch.bfloat16) == p["takes"]
    assert p["takes"] == (p["cost"] < p["pair_cost"])
    assert p["pair_cost"] == (cb.plan(3, bsz, cin, cmid, h, w, True, SMS)["cost"]
                              + cb.plan(2, bsz, cmid, cout, h, w, True, SMS)["cost"])
    assert cb.block_plan(bsz, cin, cmid, cout, h, w, SMS) == p  # no timing: the same plan again


def test_block_routes_by_width_alone():
    """Up to 128 channels each one block of block_bf16.cuh, past 128 the
    same kernel over a cluster where its layout fits (inputs up to 608
    channels fit at every width), else block3x3.cuh at bf16, which
    float32's rule sizes; float32's rule and route are unchanged."""
    assert cb.block_route(128, 128, 128) == "bf16_tc" and cb.block_route(1, 1, 1) == "bf16_tc"
    assert cb.block_route(129, 16, 16) == "bf16_cluster" and cb.block_route(16, 144, 16) == "bf16_cluster"
    assert cb.block_route(1024, 1024, 608) == "bf16_cluster" and cb.block_route(1024, 1024, 609) == "template"
    assert all(cb.cluster_fits(608, cm, co) for cm in range(129, 1025, 37) for co in (1, 200, 1024))
    assert conv_ops.fused_block_fits(144, 144, 160, dtype=torch.bfloat16)
    size = (5, 32, 320)
    assert (conv_ops.fused_block_fits(144, 144, 160, size=size, dtype=torch.bfloat16)
            == cb.block_plan(5, 144, 144, 160, 32, 320, SMS)["takes"])
    assert cb.block_route(640, 640, 640) == "template"
    assert (conv_ops.fused_block_fits(640, 640, 640, size=size, dtype=torch.bfloat16)
            == conv_ops.block_takes(5, 640, 640, 640, 32, 320, SMS))
    for bsz, cin, cmid, cout, h, w in SYNTHESIS:
        assert (conv_ops.fused_block_fits(cin, cmid, cout, size=(bsz, h, w))
                == conv_ops.block_takes(bsz, cin, cmid, cout, h, w, SMS))
    with pytest.raises(ValueError):
        cb.block_plan(1, 609, 1024, 1024, 4, 4, SMS)
    with pytest.raises(ValueError):
        cb.block_plan(1, 8, 16, 16, 4, 64, SMS, tc=24)


def test_block_geometry_registers():
    """m64 blocks a row tile, products in flight and warpgroups a block from
    the registers a thread holds: conv1's sums and fresh sums (``(1 + dy1) *
    mb * n1 / 2`` floats) and conv2's (``(pp2 + f2) * mb * n2 / 2``) within
    160, but where one block and one set already pass it, and within 64
    where three warpgroups share a block's 65,536 registers; at most two
    m64 blocks."""
    for n1 in range(16, 129, 16):
        for n2 in range(16, 129, 16):
            g = cb.block_geometry(n1, n2)
            assert 1 <= g["mb"] <= 2 and g["max_tc"] == min(224, 64 * g["mb"] - 16)
            assert g["dy1"] in (1, 3) and g["f2"] in (1, 2, 4) and g["pp2"] in (2, 4) and g["wgmax"] in (2, 3)
            cap = 64 if g["wgmax"] == 3 else 160
            assert (1 + g["dy1"]) * g["mb"] * n1 // 2 <= cap or (g["mb"] == 1 and g["dy1"] == 1)
            assert (g["pp2"] + g["f2"]) * g["mb"] * n2 // 2 <= cap or (g["mb"] == 1 and g["f2"] == 1)
    geo = [cb.block_geometry(ci, co) for _, ci, _, co, _, _ in SYNTHESIS[4:]]
    assert [(g["mb"], g["dy1"], g["f2"], g["pp2"], g["wgmax"]) for g in geo] == [
        (1, 3, 2, 2, 2), (2, 1, 1, 2, 2), (2, 1, 2, 2, 2), (2, 1, 2, 2, 3)]


# ---- The numpy model of the data path.

def _u16(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _f(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _to_u16(v: np.ndarray) -> np.ndarray:
    return _u16(torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(torch.bfloat16))


def _desc_read(flat: np.ndarray, start: int, lbo16: int) -> np.ndarray:
    """The 64 x 16 operand a K-major, no-swizzle descriptor reads from
    ``flat`` (uint16): element (m, k) at byte start * 16 + (k // 8) * LBO
    + (m // 8) * 128 + (m % 8) * 16 + (k % 8) * 2; ``lbo16`` is LBO / 16."""
    m = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    byte = start * 16 + (k // 8) * lbo16 * 16 + (m // 8) * 128 + (m % 8) * 16 + (k % 8) * 2
    return _f(flat[byte // 2])


def _b_read(pack: np.ndarray, tap: int, n: int) -> np.ndarray:
    """The 16 x n B operand of a chunk's tap: byte tap * 32n + (k // 8) *
    16n + (n // 8) * 128 + (n % 8) * 16 + (k % 8) * 2."""
    k = np.arange(16)[:, None]
    nn = np.arange(n)[None, :]
    byte = tap * 32 * n + (k // 8) * 16 * n + (nn // 8) * 128 + (nn % 8) * 16 + (k % 8) * 2
    return _f(pack[byte // 2])


def _bias_lrelu(acc, bias, c0, c, slope):
    """Bias (zero past channel ``c``) and LeakyReLU of a rank's channels
    ``c0 ..``, in the accumulator's dtype."""
    v = acc.copy()
    n = acc.shape[-1]
    bb = np.zeros(n, acc.dtype)
    k = max(0, min(n, c - c0))
    bb[:k] = bias[c0 : c0 + k]
    v += bb
    return np.where(v >= 0, v, acc.dtype.type(slope) * v)


def _pn_scale(vs, nsplit, c, eps):
    """PixelNorm over ranks' (or splits') slices ``vs``: each one's sum of
    squares over its channels in order, added in rank order over the first
    ``nsplit`` (pn_cluster_sums), in the slices' dtype."""
    dt = vs[0].dtype.type
    tot = dt(0)
    for v in vs[:nsplit]:
        part = np.zeros(v.shape[:-1] + (1,), v.dtype)
        for j in range(v.shape[-1]):
            part += v[..., j : j + 1] * v[..., j : j + 1]
        tot = tot + part
    scale = dt(1) / np.sqrt(tot / dt(c) + dt(eps))
    return [v * scale for v in vs]


def _model_block(x, w1, b1, w2, b2, p, slope=0.2, eps=1e-8, dt=np.float64):
    """The whole block through the modelled kernel (the last rounding to
    bf16 left out), and how many times each output was stored.  Each wgmma
    chain (a kernel row's taps of a chunk) is one float64 sum of exact
    products, added in ``dt`` to the row tile's sums; the epilogues run in
    ``dt``.

    With a cluster (``p["cluster"]`` > 1) every rank walks the unit:
    rank ``r`` transposes every input chunk into its own rows (modelled
    once: they are the same bytes), computes c1 channels of split ``s1 =
    min(r, nsplit1 - 1)`` into its own ring (chunks ``s1 * nown ..``),
    PixelNorm's sums meet in rank order, and conv2 walks every mid chunk:
    its own from its ring, a peer's copied whole from the peer's ring into
    staging slot ``npeer & 1`` (bf16 NaNs until written).  Outputs of split
    ``s2 = min(r, nsplit2 - 1)``, stored by the ranks below ``nsplit2``."""
    bsz, cin, h, w = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    n1, n2, mb, tc, sw, rw = p["n1"], p["n2"], p["mb"], p["tc"], p["sw"], p["rw"]
    pt1, pr1, ptr2, ss, g = p["pt1"], p["pr1"], p["ptr2"], p["ss"], 8 * p["mb"]
    nc, ns1, ns2, nown = p["cluster"], p["nsplit1"], p["nsplit2"], n1 // 16
    x16 = _u16(torch.from_numpy(x).to(torch.bfloat16))
    pack1 = _u16(conv_ops.kernel_weights_tc(torch.from_numpy(w1)))        # [split][chunk][9][2][n1][8]
    pack2 = _u16(conv_ops.kernel_weights_tc(torch.from_numpy(w2), True))  # [split][chunk][16][2][n2][8]
    y = np.zeros((bsz, cout, 2 * h, 2 * w), dt)
    seen = np.zeros(y.shape, np.int64)
    rings = [np.full(nown * 2 * ptr2 * 8 + 64 * mb * 8, NAN16, np.uint16) for _ in range(nc)]
    stages = [np.full(2 * 2 * ptr2 * 8 + 64 * mb * 8, NAN16, np.uint16) for _ in range(nc)]
    inr = np.full(pr1 * 8, NAN16, np.uint16)  # the transposed input rows of every chunk
    for unit in range(p["units"]):  # every unit, in any warpgroup: each its own rings
        tx, rest = unit % p["ntx"], unit // p["ntx"]
        rr, b = rest % p["nruns"], rest // p["nruns"]
        c0, ra = tx * tc, rr * p["run"]
        rows = min(p["run"], h - ra)
        for k in range(rows + 4):
            ri = ra - 2 + k  # input row k of the unit
            for kc in range(p["nch1"]):
                # The TMA box: [16][rw], row ri, columns c0 - 8 ..
                raw = np.zeros((16, rw), np.uint16)
                if 0 <= ri < h:
                    lo, hi = max(0, c0 - 8), min(w, c0 - 8 + rw)
                    chans = slice(kc * 16, min(cin, kc * 16 + 16))
                    raw[: chans.stop - chans.start, lo - (c0 - 8) : hi - (c0 - 8)] = x16[b, chans, ri, lo:hi]
                # ldmatrix.trans then stmatrix: matrix (octet o, columns 8kq ..),
                # its row gg to window column 8kq + gg - 6 of the row's slot.
                for o in range(2):
                    for kq in range(rw // 8):
                        for gg in range(8):
                            wc = 8 * kq + gg - 6
                            pos = (kc * 2 + o) * pt1 + ((ri + 6) % 3) * sw + wc if 0 <= wc < sw else pr1 - 1
                            inr[pos * 8 : pos * 8 + 8] = raw[8 * o : 8 * o + 8, 8 * kq + gg]
            if k < 2:
                continue
            r1 = ri - 1  # the c1 row, from input rows r1 - 1 .. r1 + 1
            base = [((ri + 4) % 3) * sw, ((ri + 5) % 3) * sw, ((ri + 6) % 3) * sw]
            c1s = []
            for r in range(nc):
                s1 = min(r, ns1 - 1)
                acc = np.zeros((mb, 64, n1), dt)
                for kc in range(p["nch1"]):
                    flat = inr[kc * 2 * pt1 * 8 :]
                    chunk = pack1[s1, kc].reshape(-1)
                    for u in range(mb):
                        for dy in range(3):  # products_c1: a fresh chain a kernel row
                            fresh = sum(_desc_read(flat, base[dy] + 64 * u + dx, pt1)
                                        @ _b_read(chunk, dy * 3 + dx, n1) for dx in range(3))
                            acc[u] += fresh.astype(dt)
                c1s.append(_bias_lrelu(acc, b1, s1 * n1, cmid, slope))  # (mb, 64, n1)
            c1s = _pn_scale(c1s, ns1, cmid, eps)
            pcol = c0 - 1 + np.arange(64 * mb).reshape(mb, 64)
            inside = (0 <= r1 < h) & (pcol >= 0) & (pcol < w)
            slot = (r1 + 3) % 3
            for r in range(min(nc, ns1)):  # a rank past conv1's splits writes no c1
                c1u = _to_u16(np.where(inside[..., None], c1s[r], 0.0))  # rounded once to bf16
                # stmatrix: matrix mm of warp wq's x4 at channel groups j0, j0 + 1
                # is positions 64u + 16wq + 8(mm & 1) + rr, group jj = j0 + (mm >> 1);
                # lane 8mm + rr's address: chunk jj >> 1, octet jj & 1.
                for u in range(mb):
                    for wq in range(4):
                        if 64 * u + 16 * wq >= ss:
                            continue  # a slot holds ss positions: a warp's 16 past them are left out
                        for j0 in range(0, n1 // 8, 2):
                            for mm in range(4):
                                for rl in range(8):
                                    m = 16 * wq + 8 * (mm & 1) + rl
                                    jj = j0 + (mm >> 1)
                                    pos = slot * ss + 64 * u + m
                                    at = (((jj >> 1) * 2 + (jj & 1)) * ptr2 + pos) * 8
                                    rings[r][at : at + 8] = c1u[u, m, 8 * jj : 8 * jj + 8]
            if k < 4:
                continue
            rout = r1 - 1  # conv2's output row R, from c1 rows R - 1 .. R + 1
            pp = p["pp2"]  # phases a pass: (oy, ox) = (q >> 1, q & 1), or (the pass's oy, q)
            csize = 2 * ptr2 * 8  # a c1 chunk: both octets
            for ps in range(4 // pp):
                phases = [(q >> 1, q & 1) for q in range(4)] if pp == 4 else [(ps, 0), (ps, 1)]
                outs = []
                for r in range(nc):
                    s2 = min(r, ns2 - 1)
                    acc2 = np.zeros((pp * mb, 64, n2), dt)
                    npeer = 0
                    for kc in range(p["nch2"]):
                        owner, kl = divmod(kc, nown)
                        if owner == r:
                            rflat = rings[r][kl * csize :]
                        else:  # the peer's chunk through distributed shared memory
                            at = (npeer & 1) * csize
                            npeer += 1
                            stages[r][at : at + csize] = rings[owner][kl * csize : (kl + 1) * csize]
                            rflat = stages[r][at:]
                        chunk = pack2[s2, kc].reshape(-1)
                        for q, (oy, ox) in enumerate(phases):
                            for dy in range(2):
                                start = ((rout - 1 + oy + dy + 3) % 3) * ss
                                for m in range(mb):
                                    fresh = sum(_desc_read(rflat, start + 64 * m + ox + dx, ptr2)
                                                @ _b_read(chunk, (2 * oy + ox) * 4 + dy * 2 + dx, n2)
                                                for dx in range(2))
                                    acc2[m * pp + q] += fresh.astype(dt)
                    outs.append(_bias_lrelu(acc2, b2, s2 * n2, cout, slope))
                outs = _pn_scale(outs, ns2, cout, eps)
                for r in range(min(nc, ns2)):
                    out, co0 = outs[r], r * n2
                    # stage_out: [phase][channel][G + 1][8], group 8m + 2wq + i
                    # = positions 64m + 16wq + 8i ..
                    stage = np.full((pp, n2, g + 1, 8), np.nan, dt)
                    for u in range(pp * mb):
                        m, q = u // pp, u % pp
                        for grp in range(8):
                            stage[q, :, 8 * m + grp, :] = out[u, 8 * grp : 8 * grp + 8].T
                    # The store map: group grp, channel co, row parity oyl -> both
                    # column phases of output row 2R + oy from column 2 (c0 + 8 grp) on.
                    for e in range(pp // 2 * n2 * g):
                        grp, rest = e % g, e // g
                        co, oyl = rest % n2, rest // n2
                        cc = c0 + 8 * grp
                        if 8 * grp >= tc or cc >= w or co0 + co >= cout:
                            continue
                        nv = min(8, w - cc)
                        orow = 2 * rout + (oyl if pp == 4 else ps)
                        run2 = np.stack([stage[2 * oyl, co, grp], stage[2 * oyl + 1, co, grp]], axis=1).reshape(-1)
                        y[b, co0 + co, orow, 2 * cc : 2 * cc + 2 * nv] += run2[: 2 * nv]
                        seen[b, co0 + co, orow, 2 * cc : 2 * cc + 2 * nv] += 1
    return y, seen


def _model_pair(x, w1, b1, w2, b2, slope=0.2, eps=1e-8, dt=np.float32):
    """K1 bf16 then K3 bf16 as their plans split the channels
    (``channel_split``), straight from the images: the same wgmma chains
    (one float64 sum of exact products a chunk and kernel row, or a chunk,
    kernel row and phase), added in ``dt`` in the same order, the same
    epilogues and PixelNorm's sums in split order; c1 rounded to bf16."""
    bsz, cin, h, w = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    (n1, ns1), (n2, ns2) = cb.channel_split(cmid), cb.channel_split(cout)
    nch1, nch2 = -(-cin // 16), -(-cmid // 16)
    xb = np.zeros((bsz, h + 2, w + 2, nch1 * 16))
    xb[:, 1:-1, 1:-1, :cin] = _f(_u16(torch.from_numpy(x).to(torch.bfloat16))).transpose(0, 2, 3, 1)
    pack1 = _u16(conv_ops.kernel_weights_tc(torch.from_numpy(w1)))
    pack2 = _u16(conv_ops.kernel_weights_tc(torch.from_numpy(w2), True))
    c1s = []
    for s in range(ns1):
        acc = np.zeros((bsz, h, w, n1), dt)
        for kc in range(nch1):
            chunk = pack1[s, kc].reshape(-1)
            for dy in range(3):
                fresh = sum(xb[:, dy : dy + h, dx : dx + w, 16 * kc : 16 * kc + 16] @ _b_read(chunk, dy * 3 + dx, n1)
                            for dx in range(3))
                acc += fresh.astype(dt)
        c1s.append(_bias_lrelu(acc, b1, s * n1, cmid, slope))
    c1 = np.concatenate(_pn_scale(c1s, ns1, cmid, eps), -1)[..., :cmid]
    cpad = np.zeros((bsz, h + 2, w + 2, nch2 * 16))
    cpad[:, 1:-1, 1:-1, :cmid] = _f(_to_u16(c1))
    outs = []
    for s in range(ns2):
        acc = np.zeros((4, bsz, h, w, n2), dt)
        for kc in range(nch2):
            chunk = pack2[s, kc].reshape(-1)
            for ph in range(4):
                oy, ox = ph >> 1, ph & 1
                for dy in range(2):
                    fresh = sum(cpad[:, oy + dy : oy + dy + h, ox + dx : ox + dx + w, 16 * kc : 16 * kc + 16]
                                @ _b_read(chunk, ph * 4 + dy * 2 + dx, n2) for dx in range(2))
                    acc[ph] += fresh.astype(dt)
        outs.append(_bias_lrelu(acc, b2, s * n2, cout, slope))
    out = np.concatenate(_pn_scale(outs, ns2, cout, eps), -1)[..., :cout]
    y = np.zeros((bsz, cout, 2 * h, 2 * w), dt)
    for ph in range(4):
        y[:, :, ph >> 1 :: 2, ph & 1 :: 2] = out[ph].transpose(0, 3, 1, 2)
    return y


def _reference(x, w1, b1, w2, b2, slope=0.2, eps=1e-8):
    """The block of the same bf16 values in float64, c1 rounded to bf16."""
    xd = torch.from_numpy(x).to(torch.bfloat16).double()
    w1d = torch.from_numpy(w1).to(torch.bfloat16).double()

    def epi(v, bias):
        v = v + torch.from_numpy(bias).double()[None, :, None, None]
        v = torch.where(v >= 0, v, slope * v)
        return v * torch.rsqrt((v * v).mean(1, keepdim=True) + eps)

    c1 = epi(torch.nn.functional.conv2d(xd, w1d, padding=1), b1).to(torch.bfloat16).double()
    bsz, _, h, w = c1.shape
    y = torch.zeros(bsz, w2.shape[0], 2 * h, 2 * w, dtype=torch.float64)
    cp = torch.nn.functional.pad(c1, (1, 1, 1, 1))
    for ph, kern in enumerate(subpixel_phase_kernels(torch.from_numpy(w2))):
        oy, ox = ph >> 1, ph & 1
        y[:, :, oy::2, ox::2] = torch.nn.functional.conv2d(cp[:, :, oy : oy + h + 1, ox : ox + w + 1],
                                                           kern.to(torch.bfloat16).double())
    return epi(y, b2).numpy()


@pytest.mark.parametrize("bsz,cin,cmid,cout,h,w,tc,run", [
    (1, 5, 7, 3, 3, 37, 0, 0),          # one image, W no multiple of 8, channels no multiple of 16
    (2, 20, 24, 40, 5, 19, 0, 0),       # two input chunks and two mid chunks, two images
    (1, 16, 48, 64, 4, 18, 0, 0),       # one m64 block a row tile, w1 resident or not
    (3, 12, 32, 16, 2, 9, 0, 0),        # four m64 blocks, conv2's two phases in flight
    (2, 8, 16, 16, 6, 40, 16, 2),       # three strips and three runs a strip (halo rows recomputed)
    (1, 3, 20, 12, 7, 33, 32, 3),       # a ragged last strip and last run
])
def test_model_of_the_data_path_computes_the_block(bsz, cin, cmid, cout, h, w, tc, run):
    rng = np.random.default_rng(bsz * 1000 + cin + cmid + cout + h + w)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    x = f32(rng.standard_normal((bsz, cin, h, w)))
    w1 = f32(rng.standard_normal((cmid, cin, 3, 3)) * 0.3)
    b1 = f32(rng.standard_normal(cmid) * 0.1)
    w2 = f32(rng.standard_normal((cout, cmid, 3, 3)) * 0.3)
    b2 = f32(rng.standard_normal(cout) * 0.1)
    p = cb.block_plan(bsz, cin, cmid, cout, h, w, SMS, tc=tc, run=run)
    got, seen = _model_block(x, w1, b1, w2, b2, p)
    assert (seen == 1).all()
    np.testing.assert_allclose(got, _reference(x, w1, b1, w2, b2), rtol=0, atol=1e-9)


# Past 128 channels: WIDE_BLOCK (5, 144 -> 144 -> 160, 32 x 320) cut down, a
# ragged one (channels no multiple of 16, W no multiple of 8), three ranks.
CLUSTER_MODEL = [(1, 16, 144, 160, 4, 20), (2, 5, 136, 150, 3, 37), (1, 8, 272, 288, 2, 24)]
# The launcher's plan (plan_kb compiled for the host, 132 SMs) past 128
# channels: (takes, tc, run, runs, strips, units, blocks, warpgroups, w1
# resident, w2 resident, stages, mb, shared bytes, cost, the pair's cost,
# pt1, pr1, ptr2, cluster, nsplit1, nsplit2).
CLUSTER_HEADER_PLANS = {
    (1, 16, 144, 160, 4, 20): (0, 16, 1, 4, 2, 8, 16, 2, 1, 0, 4, 2, 156456, 169280, 50720, 72, 280, 200, 2, 2, 2),
    (5, 144, 144, 160, 32, 320): (0, 80, 11, 3, 4, 60, 120, 2, 0, 0, 3, 2, 230184, 2118980, 1960256, 264, 4888, 328,
                                  2, 2, 2),
    (2, 5, 136, 150, 3, 37): (0, 16, 1, 3, 3, 18, 36, 2, 1, 0, 4, 2, 156456, 169280, 50720, 72, 280, 200, 2, 2, 2),
    (1, 8, 272, 288, 2, 24): (0, 16, 1, 2, 2, 4, 12, 2, 1, 0, 4, 2, 183976, 263524, 84128, 72, 280, 200, 3, 3, 3),
    (5, 272, 272, 288, 16, 160): (0, 48, 8, 2, 4, 40, 120, 2, 0, 0, 2, 2, 223400, 2770745, 1570544, 168, 5848, 264, 3,
                                  3, 3),
    (1, 448, 1024, 1024, 8, 64): (0, 16, 2, 4, 4, 16, 128, 2, 0, 0, 2, 2, 207016, 2456179, 503328, 72, 4168, 200, 8,
                                  8, 8),
    # Block 6 of chip_smoke.py's generator past 128 channels: modelled below
    # the pair, not taken (no cluster is).
    (5, 160, 160, 144, 128, 1280): (0, 80, 32, 4, 16, 320, 132, 2, 0, 0, 2, 2, 215592, 32130080, 32638560, 264, 5416,
                                    328, 2, 2, 2),
}


def _cluster_tuple(p):
    return _plan_tuple(p) + tuple(int(p[k]) for k in ("cluster", "nsplit1", "nsplit2"))


@pytest.mark.parametrize("size", sorted(CLUSTER_HEADER_PLANS))
def test_cluster_plan_mirror_equals_the_headers_rule(size):
    assert _cluster_tuple(cb.block_plan(*size, SMS)) == CLUSTER_HEADER_PLANS[size]


# Each width tier past 128 (2 to 8 ranks; cin at the widest that fits).
CLUSTER_TIERS = [(5, 144, 144, 160, 32, 320), (1, 608, 256, 256, 8, 64), (2, 608, 384, 384, 9, 50),
                 (1, 608, 512, 512, 4, 40), (1, 608, 640, 640, 5, 33), (1, 608, 768, 768, 3, 64),
                 (1, 608, 896, 896, 4, 17), (1, 608, 1024, 1024, 8, 64), (3, 100, 129, 40, 7, 50),
                 (1, 16, 16, 1024, 6, 30)]


@pytest.mark.parametrize("bsz,cin,cmid,cout,h,w", CLUSTER_MODEL + CLUSTER_TIERS)
def test_cluster_plan_covers_every_output_once_and_fits(bsz, cin, cmid, cout, h, w):
    """Past 128 channels: clusters of ``max(nsplit1, nsplit2)`` blocks of two
    warpgroups (both on each unit), the splits K1 bf16's and K3 bf16's, the units over the
    clusters, every rank's split of each conv covered once, the layout
    within 227 KB (``SMEM_BUDGET``)."""
    p = cb.block_plan(bsz, cin, cmid, cout, h, w, SMS)
    (n1, ns1), (n2, ns2) = cb.channel_split(cmid), cb.channel_split(cout)
    assert (p["n1"], p["nsplit1"], p["n2"], p["nsplit2"]) == (n1, ns1, n2, ns2)
    assert p["cluster"] == max(ns1, ns2) > 1 and p["cluster"] <= cb.MAX_PIXEL_NORM_SPLITS
    assert (p["n1"], p["n2"]) == (cb.plan(3, bsz, cin, cmid, h, w, True, SMS)["n"],
                                  cb.plan(2, bsz, cmid, cout, h, w, True, SMS)["n"])
    assert p["nwg"] == 2 and p["mb"] == 2 * p["mb_wg"] and p["blocks"] % p["cluster"] == 0
    assert p["blocks"] // p["cluster"] == min(p["units"], SMS // p["cluster"])
    assert 2 <= p["stages"] <= 4 and p["smem_bytes"] <= cb.SMEM_BUDGET <= 227 * 1024
    assert p["tc"] % 16 == 0 and p["tc"] + 2 <= 64 * p["mb"] and p["units"] == bsz * p["ntx"] * p["nruns"]
    cov = np.zeros((bsz, h, w), np.int64)
    for u in range(p["units"]):
        tx, rest = u % p["ntx"], u // p["ntx"]
        rr, b = rest % p["nruns"], rest // p["nruns"]
        cov[b, rr * p["run"] : (rr + 1) * p["run"], tx * p["tc"] : (tx + 1) * p["tc"]] += 1
    assert (cov == 1).all()
    # Each conv's channels once over its splits, and every mid chunk owned by one rank below nsplit1.
    for c, n, ns in ((cmid, n1, ns1), (cout, n2, ns2)):
        own = np.zeros(ns * n, np.int64)
        for r in range(p["cluster"]):
            if r < ns:
                own[min(r, ns - 1) * n : (min(r, ns - 1) + 1) * n] += 1
        assert (own[:c] == 1).all()
    assert all(kc // (n1 // 16) < ns1 for kc in range(-(-cmid // 16)))
    # The generator never takes a cluster (measured no faster than the pair).
    assert not p["takes"]
    assert conv_ops.fused_block_fits(cin, cmid, cout, size=(bsz, h, w), dtype=torch.bfloat16) == p["takes"]


def _block_inputs(seed, bsz, cin, cmid, cout, h, w):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(rng.standard_normal((bsz, cin, h, w))), f32(rng.standard_normal((cmid, cin, 3, 3)) * 0.3),
            f32(rng.standard_normal(cmid) * 0.1), f32(rng.standard_normal((cout, cmid, 3, 3)) * 0.1),
            f32(rng.standard_normal(cout) * 0.1))


@pytest.mark.parametrize("bsz,cin,cmid,cout,h,w", CLUSTER_MODEL)
def test_cluster_model_computes_the_block(bsz, cin, cmid, cout, h, w):
    """The cluster's data path in float64: every output stored once, by the
    rank of its split, and equal to the float64 block."""
    x, w1, b1, w2, b2 = _block_inputs(bsz + cin + cmid + cout, bsz, cin, cmid, cout, h, w)
    p = cb.block_plan(bsz, cin, cmid, cout, h, w, SMS)
    assert p["cluster"] > 1
    got, seen = _model_block(x, w1, b1, w2, b2, p)
    assert (seen == 1).all()
    np.testing.assert_allclose(got, _reference(x, w1, b1, w2, b2), rtol=0, atol=1e-9)


@pytest.mark.parametrize("bsz,cin,cmid,cout,h,w,tc,run", [
    (1, 16, 144, 160, 4, 20, 0, 0), (2, 5, 136, 150, 3, 37, 16, 2), (2, 5, 136, 150, 3, 37, 0, 0),
    (1, 8, 272, 288, 2, 24, 0, 0), (3, 12, 129, 40, 3, 30, 0, 0),  # a rank past conv2's split
    (1, 16, 16, 160, 4, 20, 0, 0),  # a rank past conv1's split
    (2, 20, 24, 40, 5, 19, 0, 0),  # one block: the narrow route the same way
])
def test_model_gives_the_pairs_bits_and_the_pair_is_the_plain_block(bsz, cin, cmid, cout, h, w, tc, run):
    """In float32, each wgmma chain one exact sum: the modelled kernel
    (ranks, their rings, the peers' chunks through the staging slots,
    PixelNorm's sums in rank order) gives K1
    bf16 then K3 bf16's bits, both output dtypes (the float32 output
    rounded to bf16 is the bf16 output), and that pair is the plain
    versions' block within the bf16 block's bar
    (``tests/test_torch_cuda.py::assert_k4_bf16_close``)."""
    x, w1, b1, w2, b2 = _block_inputs(7 * bsz + cin + cmid + cout, bsz, cin, cmid, cout, h, w)
    p = cb.block_plan(bsz, cin, cmid, cout, h, w, SMS, tc=tc, run=run)
    got, seen = _model_block(x, w1, b1, w2, b2, p, dt=np.float32)
    assert (seen == 1).all() and got.dtype == np.float32
    pair = _model_pair(x, w1, b1, w2, b2)
    assert np.array_equal(got, pair)  # the float32 output
    assert np.array_equal(_to_u16(got), _to_u16(pair))  # the bf16 output
    bf = torch.bfloat16
    xb = torch.from_numpy(x).to(bf)
    c1 = conv_ops.conv3x3_plain(xb, torch.from_numpy(w1), torch.from_numpy(b1), 0.2, True, 1e-8, out_dtype=bf)
    plain = conv_ops.upconv3x3_plain(c1, torch.from_numpy(w2), torch.from_numpy(b2), 0.2, True, 1e-8,
                                     out_dtype=bf).float()
    mine = torch.from_numpy(pair).to(bf).float()
    assert ((mine - plain).norm() / plain.norm()).item() <= 1e-2


def test_generator_asks_the_bf16_rule_and_hands_k4_its_packs(monkeypatch):
    """Under ``pallas_block_bf16`` each block asks ``fused_block_fits`` with
    its bf16 dtype (the bf16 rule), and a block it takes goes through
    ``fused_block`` with the packs K4 bf16 shares with K1 bf16 and K3 bf16
    on the card (on the CPU the kernel layout, for the plain versions)."""
    import dataclasses

    from musicgan_tpu_torch.models import Generator
    from tests.tiny_cfg import TINY_MODEL

    cfg = ModelConfig(rand_channels=TINY_MODEL.rand_channels, gen_channels=TINY_MODEL.gen_channels,
                      disc_channels=TINY_MODEL.disc_channels, conv_impl="pallas_block_bf16")
    asked, blocks = [], []
    real_block = conv_ops.fused_block

    def fits(cin, cmid, cout, size=None, device=None, dtype=torch.float32):
        asked.append(dtype)
        return cmid == cfg.gen_channels[-1][0]  # the last block takes K4

    def block(x, *a, w1_packed=None, w2_packed=None, **kw):
        blocks.append((x.shape[1], x.dtype, tuple(w1_packed.shape), tuple(w2_packed.shape)))
        return real_block(x, *a, w1_packed=w1_packed, w2_packed=w2_packed, **kw)

    monkeypatch.setattr(conv_ops, "fused_block_fits", fits)
    monkeypatch.setattr(conv_ops, "fused_block", block)
    gen = Generator(cfg, seed=2)
    z = torch.randn(1, cfg.rand_channels, 2, 4, generator=torch.Generator().manual_seed(0))
    stage = len(cfg.gen_channels) - 1
    # The two passes differ in the block path alone: the same generator (one
    # set of parameter tensors) under both impls, on one intra-op thread, so
    # that nothing of the host's threading or memory placement can tell them
    # apart (one run of the whole suite found two generators' passes on 8
    # threads unequal; no rerun did).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            y = gen.forward_nchw(z, stage)
            gen.cfg = dataclasses.replace(cfg, conv_impl="pallas_up_bf16")
            ref = gen.forward_nchw(z, stage)
    finally:
        torch.set_num_threads(threads)
    assert asked == [torch.bfloat16] * len(cfg.gen_channels)
    cin, cout = cfg.gen_channels[-1]
    assert blocks == [(cin, torch.bfloat16, (cin, 9, -(-cin // 16) * 16), (4, cin, 4, -(-cout // 16) * 16))]
    assert torch.equal(y, ref)  # on the CPU both are the same plain versions
