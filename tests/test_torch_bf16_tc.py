"""K1 bf16 and K3 bf16 (``csrc/conv_bf16.cuh``) without the card: the plan
mirror ``ops/conv_bf16.py::plan`` and a numpy model of the kernel's operand
layouts.

The model follows the kernel byte for byte where layout matters: a chunk's
window lands as the TMA box does (``[row][16 channels][sw + 16]``, image
columns from ``c0 - 8``), is transposed as ``ldmatrix.trans`` then
``stmatrix`` move it (``[octet][position][8]``), A and B are read through
their shared-memory descriptors (K-major, 8 x 16-byte core matrices, LBO
between the two octets of k16, SBO 128 between 8-row groups) from the
transposed window and from ``tc_weights``'s pack, and the products of every
m64 block, phase and tap go to the positions the kernel stages with
``stmatrix.trans`` and stores (K3: both column phases interleaved).  It
computes whole convs at small sizes, held against a float64 conv of the same
bf16 values: the pack, the window, the descriptors and the store map
together compute the conv, and every output is stored exactly once.
"""

import numpy as np
import pytest
import torch

from musicgan_tpu_torch.config import ModelConfig
from musicgan_tpu_torch.models.layers import subpixel_phase_kernels
from musicgan_tpu_torch.ops import conv as conv_ops
from musicgan_tpu_torch.ops import conv_bf16 as cb

SMS = 132  # an H100 SXM's


def _synthesis_shapes():
    """(k, B, cin, cout, H, W) of K1 and K3 at the 8 blocks of a 5-clip,
    nb_vec-10 synthesis call."""
    out = []
    for i, (cin, cout) in enumerate(ModelConfig().gen_channels):
        h, w = 2 * 2**i, 20 * 2**i
        out += [(3, 5, cin, cin, h, w), (2, 5, cin, cout, h, w)]
    return out


SYNTHESIS = _synthesis_shapes()
# Ragged: W no multiple of 4 or of 64, channels no multiple of 16, one image,
# PixelNorm past 128 channels (a cluster of 2 and of 3), whole images folded.
RAGGED = [
    (3, 1, 5, 7, 3, 37), (2, 1, 5, 7, 3, 37), (3, 2, 12, 20, 9, 33), (2, 2, 20, 20, 9, 33),
    (3, 6, 131, 144, 4, 4), (2, 6, 144, 144, 4, 4), (3, 1, 24, 272, 64, 70), (2, 3, 21, 20, 96, 130),
    (3, 2, 5, 7, 130, 300), (2, 4, 32, 32, 70, 130), (3, 7, 16, 16, 1, 6), (2, 3, 9, 40, 2, 3),
]


def _tiles(p, h):
    """(b0, r0, c0, oy) of every tile, in the kernel's order (tile_of)."""
    tl = np.arange(p["ntiles"])
    oy, rest = tl % p["nph"], tl // p["nph"]
    tx, rest2 = rest % p["ntx"], rest // p["ntx"]
    return (rest2 // p["nty"]) * p["nb"], (rest2 % p["nty"]) * p["th"], tx * p["tc"], oy


def _groups(p):
    """For each of a tile's 8 * mb groups of 8 output positions (as
    stmatrix.trans stages them): the image in the tile, the row in the
    image's band, the first column in the tile, or -1 where the kernel
    stores nothing (conv_bf16.cuh::store_out)."""
    sw, th = p["sw"], p["th"]
    grp = np.arange(8 * p["mb"])
    p0 = sw + 1 + 8 * grp
    sr, sc = p0 // sw, p0 % sw
    img = sr // (th + 2)
    lr = sr - img * (th + 2) - 1
    ok = (sc - 1 < p["tc"]) & (img < p["nb"]) & (lr >= 0) & (lr < th)
    return np.where(ok, img, -1), lr, sc - 1


def _coverage(k, bsz, cout, h, w, p):
    """How many times the kernel stores each output pixel (of each row
    parity for K3): one group stores up to 8 columns of all the tile's
    channels; every channel of a split lies in one tile's N."""
    b0, r0, c0, oy = _tiles(p, h)
    img, lr, col = _groups(p)
    keep = img >= 0
    img, lr, col = img[keep], lr[keep], col[keep]
    b = b0[:, None] + img[None]
    r = r0[:, None] + lr[None]
    c = c0[:, None] + col[None]
    oyy = np.broadcast_to(oy[:, None], b.shape)
    valid = (b < bsz) & (r < h) & (c < w)
    cov = np.zeros((p["nph"] if k == 2 else 1, bsz, h, w), np.int64)
    for j in range(8):
        vj = valid & (c + j < w)
        np.add.at(cov, (oyy[vj], b[vj], r[vj], c[vj] + j), 1)
    return cov


@pytest.mark.parametrize("k,bsz,cin,cout,h,w", SYNTHESIS + RAGGED)
def test_plan_covers_every_output_once(k, bsz, cin, cout, h, w):
    p = cb.plan(k, bsz, cin, cout, h, w, True, SMS)
    cov = _coverage(k, bsz, cout, h, w, p)
    assert (cov == 1).all(), f"pixels stored {cov.min()}..{cov.max()} times"
    n, nsplit = cb.channel_split(cout)
    assert p["n"] * p["nsplit"] >= cout and (p["n"], p["nsplit"]) == (n, nsplit) and n % 16 == 0
    assert 2 <= p["stages"] <= 4 and p["smem_bytes"] <= cb.SMEM_BUDGET
    assert p["blocks"] == min(p["ntiles"], max(1, SMS // nsplit)) * nsplit
    assert p["cluster"] == (nsplit if nsplit > 1 else 1)
    assert p["tc"] % 16 == 0 and p["sw"] == p["tc"] + 8 and p["sw"] + 16 <= 256  # the TMA box
    # The m64 blocks cover the tile's output positions.
    assert ((p["nb"] - 1) * (p["th"] + 2) + p["th"] - 1) * p["sw"] + p["tc"] <= 64 * p["mb"]


@pytest.mark.parametrize("k,bsz,cin,cout,h,w", SYNTHESIS + RAGGED)
def test_plan_takes_the_cheaper_route_from_the_sizes_and_sm_count(k, bsz, cin, cout, h, w):
    """The size rule's plan is the cheaper of the two routes' (each the least
    modelled cost over its tiles), the same when asked again, and a route
    is named by its tile: whole images for small_bf16_tc."""
    p = cb.plan(k, bsz, cin, cout, h, w, True, SMS)
    costs = {}
    for name in cb.routes_for(k, bsz, cin, cout, h, w, True, SMS):
        q = cb.plan(k, bsz, cin, cout, h, w, True, SMS, cb.ROUTE_CODES[name])
        assert q["route"] == name
        assert (q["th"] == h and q["tc"] >= w) == (name == "small_bf16_tc")
        costs[name] = q["cost"]
    assert p["route"] in costs and p["cost"] == min(costs.values())
    assert cb.plan(k, bsz, cin, cout, h, w, True, SMS) == p
    other = cb.plan(k, bsz, cin, cout, h, w, True, 66)
    assert other["blocks"] <= 66 * p["nsplit"]


def test_synthesis_plans_are_on_the_tensor_cores_with_resident_weights_at_the_large_blocks():
    """At all 16 synthesis shapes a plan exists (so the tensor-core kernel
    takes them: there is no other route), and the weights of blocks 5-7
    (the most time) stay resident."""
    for k, bsz, cin, cout, h, w in SYNTHESIS:
        p = cb.plan(k, bsz, cin, cout, h, w, True, SMS)
        assert p["route"] in cb.ROUTES.values()
        if h >= 64:
            assert p["resident"], (k, cin, cout, h, w)


def test_plan_refuses_what_no_tile_takes():
    with pytest.raises(ValueError):
        cb.plan(3, 1, 8, 8, 300, 300, True, SMS, route=1)  # whole 300 x 300 images in one tile
    with pytest.raises(ValueError):
        cb.plan(3, 1, 8, 16 * 8 * 9, 4, 4, True, SMS)    # PixelNorm past a cluster of 8
    with pytest.raises(ValueError):
        cb.plan(3, 1, 8, 8, 4, 4, True, SMS, route=3)


# ---- The numpy model of the data path.

def _bf16_values(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _f(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _raw_window(x16, p, b0, r0, c0, kc):
    """A chunk's window as the TMA box lands: [rows_w][16][sw + 16], image
    columns c0 - 8 .., zero outside the image and past cin."""
    bsz, cin, h, w = x16.shape
    th, rw = p["th"], p["sw"] + 16
    raw = np.zeros((p["nb"] * (th + 2), 16, rw), np.uint16)
    for sr in range(raw.shape[0]):
        img, lr = sr // (th + 2), sr % (th + 2) - 1
        b, r = b0 + img, r0 + lr
        if b >= bsz or not 0 <= r < h:
            continue
        for ch in range(16):
            c = kc * 16 + ch
            if c >= cin:
                continue
            for col in range(rw):
                gc = c0 - 8 + col
                if 0 <= gc < w:
                    raw[sr, ch, col] = x16[b, c, r, gc]
    return raw


def _transpose(raw, p, ptrans):
    """ldmatrix.trans then stmatrix, matrix by matrix and lane by lane:
    returns the transposed window as bytes, [octet][ptrans][8] bf16."""
    sw, rw = p["sw"], p["sw"] + 16
    trans = np.zeros((2, ptrans, 8), np.uint16)
    for sr in range(raw.shape[0]):
        for o in range(2):
            for kq in range(rw // 8):
                m = raw[sr, 8 * o : 8 * o + 8, 8 * kq : 8 * kq + 8]  # rows: channels, as ldmatrix reads them
                # ldmatrix.trans: lane (g, t) holds (channel 2t, 2t + 1) of column g;
                # stmatrix: row g (lanes 4g .. 4g + 3) to the address lane g gives.
                for g in range(8):
                    wc = 8 * kq + g - 7
                    pos = sr * sw + wc if 0 <= wc < sw else ptrans - 1
                    trans[o, pos] = [m[2 * t + e, g] for t in range(4) for e in range(2)]
    return trans.reshape(-1)


def _a_matrix(trans_flat, start_pos, ptrans):
    """The 64 x 16 A operand a descriptor at position start_pos reads:
    element (m, k) at byte start * 16 + (k // 8) * LBO + (m // 8) * 128 +
    (m % 8) * 16 + (k % 8) * 2, LBO = ptrans * 16."""
    flat = trans_flat.view(np.uint8)
    a = np.zeros((64, 16), np.uint16)
    for m in range(64):
        for kk in range(16):
            byte = start_pos * 16 + (kk // 8) * ptrans * 16 + (m // 8) * 128 + (m % 8) * 16 + (kk % 8) * 2
            a[m, kk] = int(flat[byte]) | (int(flat[byte + 1]) << 8)
    return a


def _b_matrix(pack_flat, base_tap, n):
    """The 16 x n B operand at tap base_tap of a chunk: byte tap * 32n +
    (k // 8) * LBO + (n // 8) * 128 + (n % 8) * 16 + (k % 8) * 2, LBO =
    16n."""
    flat = pack_flat.view(np.uint8)
    b = np.zeros((16, n), np.uint16)
    for kk in range(16):
        for nn in range(n):
            byte = base_tap * 32 * n + (kk // 8) * 16 * n + (nn // 8) * 128 + (nn % 8) * 16 + (kk % 8) * 2
            b[kk, nn] = int(flat[byte]) | (int(flat[byte + 1]) << 8)
    return b


def _model_conv(k, x, w, p):
    """The whole conv through the modelled kernel (no epilogue): (B, cout,
    H, W) for K1, (B, cout, 2H, 2W) for K3, float64, and how many times each
    output was stored."""
    bsz, cin, h, wd = x.shape
    cout = w.shape[0]
    n, nsplit, mb, ppb, sw = p["n"], p["nsplit"], p["mb"], p["ppb"], p["sw"]
    rows_w = p["nb"] * (p["th"] + 2)
    ptrans = -(-max(rows_w * sw + 1, 64 * mb + 2 * sw + 2) // 8) * 8
    x16 = _u16(torch.from_numpy(x).to(torch.bfloat16))
    wt = torch.from_numpy(w)
    wk = conv_ops.kernel_upconv_weights(wt, torch.bfloat16) if k == 2 else conv_ops.kernel_weights(wt, torch.bfloat16)
    pack = _u16(cb.tc_weights(wk, k == 2, cout))
    taps_all = 9 if k == 3 else 16
    hs = 2 if k == 2 else 1
    y = np.zeros((bsz, cout, h * hs, wd * hs))
    seen = np.zeros(y.shape, np.int64)
    g1 = 8 * mb + 1
    b0s, r0s, c0s, oys = _tiles(p, h)
    for ti in range(p["ntiles"]):
        b0, r0, c0, oy_t = int(b0s[ti]), int(r0s[ti]), int(c0s[ti]), int(oys[ti])
        for split in range(nsplit):
            acc = np.zeros((mb * ppb, 64, n))
            for kc in range(p["nchunks"]):
                trans = _transpose(_raw_window(x16, p, b0, r0, c0, kc), p, ptrans)
                chunk = pack[split, kc].reshape(-1)
                for u in range(mb * ppb):
                    m, ph = u // ppb, u % ppb
                    if k == 3:
                        taps = [(dy, dx, dy * sw + dx, dy * 3 + dx) for dy in range(3) for dx in range(3)]
                    else:
                        oy, ox = (ph >> 1, ph & 1) if ppb == 4 else (oy_t, ph)
                        taps = [(dy, dx, (oy + dy) * sw + ox + dx, (2 * oy + ox) * 4 + dy * 2 + dx)
                                for dy in range(2) for dx in range(2)]
                    for _, _, off, tap in taps:
                        a = _f(_a_matrix(trans, 64 * m + off, ptrans)).astype(np.float64)
                        bm = _f(_b_matrix(chunk, tap, n)).astype(np.float64)
                        acc[u] += a @ bm
            # stmatrix.trans: tile u's group g (positions 8g .. 8g + 7 of its
            # m64 block) and channel co to [phase][co][g1][8], then store_out.
            stage = np.zeros((ppb, n, g1, 8))
            for u in range(mb * ppb):
                m, ph = u // ppb, u % ppb
                for grp in range(8):
                    stage[ph, :, 8 * m + grp, :] = acc[u][8 * grp : 8 * grp + 8].T
            img, lr, col = _groups(p)
            for grp in np.flatnonzero(img >= 0):
                b, r, c = b0 + img[grp], r0 + lr[grp], c0 + col[grp]
                if b >= bsz or r >= h or c >= wd:
                    continue
                nv = min(8, wd - c)
                for co in range(n):
                    gco = split * n + co
                    if gco >= cout:
                        continue
                    if k == 3:
                        y[b, gco, r, c : c + nv] += stage[0, co, grp, :nv]
                        seen[b, gco, r, c : c + nv] += 1
                        continue
                    for oyl in range(ppb // 2):
                        oy = oyl if ppb == 4 else oy_t
                        pa = 2 * oyl if ppb == 4 else 0
                        pair = np.stack([stage[pa, co, grp], stage[pa + 1, co, grp]], axis=1).reshape(-1)
                        y[b, gco, 2 * r + oy, 2 * c : 2 * c + 2 * nv] += pair[: 2 * nv]
                        seen[b, gco, 2 * r + oy, 2 * c : 2 * c + 2 * nv] += 1
    return y, seen


def _reference(k, x, w):
    """The conv (K1) or up-conv as four phase convs (K3) of the bf16
    values, in float64."""
    xd = torch.from_numpy(x).to(torch.bfloat16).double()
    wt = torch.from_numpy(w)
    if k == 3:
        wd = wt.to(torch.bfloat16).double()
        return torch.nn.functional.conv2d(xd, wd, padding=1).numpy()
    bsz, _, h, wdt = x.shape
    y = np.zeros((bsz, w.shape[0], 2 * h, 2 * wdt))
    xp = torch.nn.functional.pad(xd, (1, 1, 1, 1))
    for ph, kern in enumerate(subpixel_phase_kernels(wt)):
        oy, ox = ph >> 1, ph & 1
        kd = kern.to(torch.bfloat16).double()
        sl = xp[:, :, oy : oy + h + 1, ox : ox + wdt + 1]
        y[:, :, oy::2, ox::2] = torch.nn.functional.conv2d(sl, kd).numpy()
    return y


@pytest.mark.parametrize("k,bsz,cin,cout,h,w,route,tc", [
    (3, 2, 20, 24, 5, 19, 0, 0),        # row bands, ragged width and channels, two chunks
    (3, 3, 8, 16, 2, 10, 1, 0),         # whole images folded into a tile (mb 8)
    (2, 2, 20, 24, 3, 11, 0, 0),        # K3, four phases a tile
    (2, 1, 16, 48, 4, 18, 0, 0),        # K3, one row parity a tile (both column phases)
    (2, 3, 5, 16, 2, 6, 1, 0),          # K3 on whole images, two m64 blocks
    (3, 1, 16, 136, 2, 9, 2, 16),       # two channel splits
])
def test_model_of_the_data_path_computes_the_conv(k, bsz, cin, cout, h, w, route, tc):
    rng = np.random.default_rng(k * 1000 + cin + cout + h + w)
    x = _bf16_values(rng.standard_normal((bsz, cin, h, w)))
    wt = (rng.standard_normal((cout, cin, 3, 3)) * 0.2).astype(np.float32)
    p = cb.plan(k, bsz, cin, cout, h, w, False, SMS, route, tc)
    got, seen = _model_conv(k, x, wt, p)
    assert (seen == 1).all()
    np.testing.assert_allclose(got, _reference(k, x, wt), rtol=0, atol=1e-9)


def test_tc_weights_is_the_kernel_layout_moved():
    """The pack holds the kernel layout's bf16 values (K4 reads that layout;
    K1 bf16 and K3 bf16 this one), zero past cin and cout."""
    rng = np.random.default_rng(5)
    for upconv, cin, cout in ((False, 21, 40), (True, 21, 40), (False, 16, 144), (True, 33, 16)):
        w = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3))).astype(np.float32))
        wk = conv_ops.kernel_upconv_weights(w, torch.bfloat16) if upconv else conv_ops.kernel_weights(w, torch.bfloat16)
        pack = conv_ops.kernel_weights_tc(w, upconv)
        k = 2 if upconv else 3
        assert tuple(pack.shape) == cb.tc_weights_shape(k, cin, cout) and pack.dtype == torch.bfloat16
        n = pack.shape[4]
        taps = 16 if upconv else 9
        lay = wk.permute(1, 0, 2, 3).reshape(cin, 16, -1) if upconv else wk
        for c in range(pack.shape[1] * 16):
            for tap in range(taps):
                for co in range(pack.shape[0] * n):
                    v = pack[co // n, c // 16, tap, (c % 16) // 8, co % n, c % 8]
                    want = lay[c, tap, co] if c < cin and co < cout else 0
                    assert v == want


# ---- The float32 output (the mixed call bf16 in, float32 out, and K2 with
# bf16 x): the tile leaves through the bf16 output's staging region in two
# halves of its channels (conv_bf16.cuh::stage_out_f32, store_out_f32), so
# the plan and the layout are the bf16 output's.

def _f32_halves(k, n):
    """stage_out_f32 then store_out_f32 for one tile, thread by thread, at
    N = ``n`` channels: each half's region as the staging threads fill it
    (each float tagged with its (phase, position, channel)), and what each
    store item reads back.  Raises AssertionError on a float written twice
    or outside the bf16 region, an item twice, or a read of another tag."""
    g_ = cb.geometry(k, n)
    mb, ppb = g_["mb"], g_["ppb"]
    G, G1, NH, JH = 8 * mb, 8 * mb + 1, n // 2, n // 16
    floats = ppb * n * G1 * 16 // 4  # the bf16 output's region, conv_bf16.py::_smem's out
    noy = 1 if k == 3 else ppb // 2
    items = -(-noy * NH * G // 128)
    stored = set()
    for hf in (0, 1):
        region = {}
        for wq in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for u in range(mb * ppb):
                    m, p = u // ppb, u % ppb
                    for jl in range(JH):
                        for e in range(2):
                            for i in range(2):
                                idx = ((p * NH + 8 * jl + 2 * t + e) * G1 + 8 * m + 2 * wq + i) * 8 + g
                                assert 0 <= idx < floats and idx not in region
                                region[idx] = (p, 64 * m + 16 * wq + g + 8 * i, 8 * (hf * JH + jl) + 2 * t + e)
        for lt in range(128):
            grp = lt % G
            for it in range(items):
                rest = lt // G + it * (128 // G)
                co, oyl = rest % NH, rest // NH
                if oyl >= noy:
                    continue
                assert (hf, oyl, co, grp) not in stored
                stored.add((hf, oyl, co, grp))
                phases = [0] if k == 3 else [2 * oyl, 2 * oyl + 1] if ppb == 4 else [0, 1]
                for ph in phases:
                    for slot in range(8):
                        assert region[((ph * NH + co) * G1 + grp) * 8 + slot] == (ph, 8 * grp + slot, hf * NH + co)
    return stored, noy, G, NH


@pytest.mark.parametrize("k", [3, 2])
@pytest.mark.parametrize("n", [16, 32, 48, 64, 80, 96, 112, 128])
def test_float32_output_leaves_through_the_bf16_region_in_two_halves(k, n):
    """Every (position, channel) of a tile is staged once per half inside the
    bf16 output's region, and every (row parity, channel, group) of both
    halves is stored once, each reading back the floats staged for it."""
    stored, noy, G, NH = _f32_halves(k, n)
    assert len(stored) == 2 * noy * NH * G


def _msq_coverage(bsz, h, w, p):
    """How many times K2 with bf16 x writes each pixel of its mean-square map
    (conv_bf16.cuh::store_msq: position sw + 1 + 64 u + 16 wq + g + 8 i of
    every tile, the stored outputs' positions only)."""
    sw, th, tc = p["sw"], p["th"], p["tc"]
    pos = sw + 1 + np.arange(64 * p["mb"])
    sr, sc = pos // sw, pos % sw
    img = sr // (th + 2)
    lr = sr - img * (th + 2) - 1
    ok = (sc >= 1) & (sc - 1 < tc) & (img < p["nb"]) & (lr >= 0) & (lr < th)
    cov = np.zeros((bsz, h, w), np.int64)
    b0, r0, c0, _ = _tiles(p, h)
    for ti in range(p["ntiles"]):
        b, r, c = b0[ti] + img, r0[ti] + lr, c0[ti] + sc - 1
        v = ok & (b < bsz) & (r < h) & (c < w)
        np.add.at(cov, (b[v], r[v], c[v]), 1)
    return cov


def _train_gen_shapes():
    """K2's shapes in a stage-7 train step at batch 6 (the generator's 16
    convs), (B, cin, cout, H, W)."""
    out, h = [], 2
    for cin, cout in ModelConfig().gen_channels:
        out += [(6, cin, cin, h, h), (6, cin, cout, 2 * h, 2 * h)]
        h *= 2
    return out


@pytest.mark.parametrize("bsz,cin,cout,h,w", _train_gen_shapes() + [s[1:] for s in RAGGED if s[0] == 3])
def test_msq_map_covers_every_pixel_once(bsz, cin, cout, h, w):
    p = cb.plan(3, bsz, cin, cout, h, w, True, SMS)
    assert (_msq_coverage(bsz, h, w, p) == 1).all()
