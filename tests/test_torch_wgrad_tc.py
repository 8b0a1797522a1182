"""The weight-gradient kernel's arithmetic and launch plans, on the CPU.

``csrc/wgrad3x3.cu`` has two routes, chosen by a size rule
(``ops/conv_vjp.py::wgrad_route``): float32 FMAs in one launch for images
of at most 16x16, and for larger ones the tensor-core route, which computes ``dw[o, i, ky, kx] = sum over the pixels p of
x of d[p shifted by 1 - ky rows] * x[p shifted by kx - 1 columns]`` as an
implicit GEMM on the tensor cores in 3xTF32 (both operands split by
``cvt.rna`` into big and small TF32 parts, three products a float32
product), the products of every ``WG_FLUSH`` k8 steps in a fresh
accumulator whose additions truncate, flushed into a float32 sum (round
to nearest); each run of chunks adds its two consumer warpgroups' sums,
and a second launch adds the runs in the plan's groups.  The kernel cannot
run here, so these tests hold a model of that arithmetic, in the order
``ops/conv_vjp.py::wgrad_k_order`` gives, against float64 at the path's
longest K (6 x 512 x 512 pixels), and the Python plan
(``wgrad_plan``, which ``tests/test_torch_cuda.py`` holds equal to the
launcher's on the card) to covering every pixel once, in order; and the
small route's staging geometry to reading every tap of every pixel from
its place in the image (zero outside), within the shared memory its plan
sizes.
"""

import math

import pytest
import torch
import torch.nn.functional as F
from test_torch_tf32_split import split

from musicgan_tpu_torch.config import ModelConfig
from musicgan_tpu_torch.ops import conv_vjp

TOL = 1e-5  # the kernel's bar against float64 on the card, relative to the largest value


def train_conv_shapes(batch=6, stage=7):
    """The 34 trainable convs of a stage-7 iteration at ``ModelConfig()``
    widths (as ``chip_smoke.py::train_conv_shapes``): (B, cin, cout, H, W)."""
    cfg = ModelConfig()
    shapes, h = [], cfg.latent_height
    for cin, cout in cfg.gen_channels[: stage + 1]:
        shapes += [(batch, cin, cin, h, h), (batch, cin, cout, 2 * h, 2 * h)]
        h *= 2
    for cin, cout in cfg.disc_channels[len(cfg.disc_channels) - 2 - stage:]:
        shapes += [(batch, cin, cout, h, h), (batch, cout, cout, h // 2, h // 2)]
        h //= 2
    return shapes


PATH_SHAPES = train_conv_shapes()
# One pixel, widths below 8, no multiple of 4, of 8, of 64, a batch that
# ends inside a run, heights below a chunk's rows, several channel splits.
RAGGED_SHAPES = [
    (1, 1, 1, 1, 1), (6, 3, 5, 1, 1), (2, 5, 7, 2, 3), (3, 9, 17, 5, 7), (2, 5, 7, 13, 37), (7, 16, 16, 9, 8),
    (5, 33, 65, 3, 70), (3, 40, 129, 9, 12), (1, 96, 300, 4, 130), (13, 20, 48, 31, 65),
]


def test_path_has_34_trainable_convs():
    assert len(PATH_SHAPES) == 34
    assert max(b * h * w for b, _, _, h, w in PATH_SHAPES) == 6 * 512 * 512


def _rz32(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero: a tensor-core addition."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def model_dw(x: torch.Tensor, d: torch.Tensor, plan: dict, three: bool = True) -> torch.Tensor:
    """The kernel's arithmetic for one input and one output channel: the
    9 taps of dw, float32.  The sum runs over x's pixels p (the order's
    entries): tap (ky, kx) multiplies x at p shifted by kx - 1 columns with
    d at p shifted by 1 - ky rows (zero outside the image).  Each k8 step's
    products (a wgmma: 8 exact
    products of TF32 values, added to the fresh accumulator with one
    truncation) go big*big, big*small, small*big (``three``; else big*big
    alone); every flush group's fresh sum is added to the warpgroup's
    float32 sum in order; a run is warpgroup 0's sum plus warpgroup 1's;
    the runs are added in ``rgroups`` groups of consecutive runs, each in
    order, then the groups in order."""
    bsz, _, h, w = x.shape
    order = conv_vjp.wgrad_k_order(plan, bsz, h, w)
    valid = order >= 0
    idx = order.clamp(min=0)

    def take(flat):
        return torch.where(valid, flat[idx], 0.0)

    xp, dp = F.pad(x, (1, 1, 1, 1)), F.pad(d, (1, 1, 1, 1))
    kblocks, rgroups = plan["kblocks"], plan["rgroups"]
    gsz = math.ceil(kblocks / rgroups)
    out = torch.empty(9)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        xb, xs = split(take(xp[:, 0, 1:1 + h, kx:kx + w].reshape(-1)))
        db, ds = split(take(dp[:, 0, 2 - ky:2 - ky + h, 1:1 + w].reshape(-1)))
        terms = [(xb, db), (xb, ds), (xs, db)] if three else [(xb, db)]
        step_sums = [(a.double() * b.double()).sum(-1) for a, b in terms]  # (kblocks, 2, groups, flush)
        fresh = torch.zeros(step_sums[0].shape[:-1])
        for f in range(step_sums[0].shape[-1]):
            for s in step_sums:
                fresh = _rz32(fresh.double() + s[..., f])
        acc = torch.zeros(kblocks, 2)
        for gi in range(fresh.shape[2]):
            acc = acc + fresh[:, :, gi]
        runs = acc[:, 0] + acc[:, 1]
        total = None
        for j in range(rgroups):
            v = torch.zeros(())
            for k in range(j * gsz, min(kblocks, (j + 1) * gsz)):
                v = v + runs[k]
            total = v if total is None else total + v
        out[tap] = total
    return out


def _reference(x, d):
    bsz, _, h, w = x.shape
    xp = F.pad(x.double(), (1, 1, 1, 1))
    return torch.stack([(xp[:, 0, ky:ky + h, kx:kx + w] * d[:, 0].double()).sum()
                        for ky in range(3) for kx in range(3)])


@pytest.mark.parametrize("shape", [(6, 32, 16, 512, 512), (6, 16, 32, 512, 512)])
def test_3xtf32_with_fresh_accumulators_is_float32_accurate_at_the_longest_k(shape):
    """At 1.57 million pixels, in the order and grouping of the path's plan
    for each 512x512 conv: within 1e-5 of float64 relative to the largest
    value, where one TF32 product (big*big alone) misses the bar."""
    bsz, _, _, h, w = shape
    plan = conv_vjp.wgrad_plan(*shape)
    assert plan["kblocks"] > 1 and plan["rgroups"] > 1
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(bsz, 1, h, w, generator=gen)
    d = torch.randn(bsz, 1, h, w, generator=gen) / math.sqrt(bsz * h * w)
    ref = _reference(x, d)
    scale = ref.abs().max()
    three = model_dw(x, d, plan)
    assert ((three.double() - ref).abs().max() / scale).item() <= TOL
    one = model_dw(x, d, plan, three=False)
    assert ((one.double() - ref).abs().max() / scale).item() > TOL


def test_the_size_rule_splits_the_path_at_16x16():
    """The small route takes the path's images up to 16x16 (16 of the 34
    convs), the tensor-core route every larger one; a side past 16 is
    enough for the tensor cores."""
    routes = [conv_vjp.wgrad_plan(*s)["route"] for s in PATH_SHAPES]
    assert routes == [conv_vjp.WGRAD_SMALL if s[3] <= 16 else conv_vjp.WGRAD_TC for s in PATH_SHAPES]
    assert routes.count(conv_vjp.WGRAD_SMALL) == 16
    assert conv_vjp.wgrad_route(16, 16) == conv_vjp.WGRAD_SMALL
    assert conv_vjp.wgrad_route(16, 17) == conv_vjp.wgrad_route(17, 1) == conv_vjp.WGRAD_TC


# The size rule's route at every shape, and each route forced at the ragged
# ones (the small route stages whole rows: it refuses rows too wide for a
# block's shared memory, past about 190 columns).
ROUTE_CASES = [(s, r) for s in PATH_SHAPES + RAGGED_SHAPES for r in (None, *conv_vjp.WGRAD_ROUTES)
               if r is None or (s in RAGGED_SHAPES and (r == conv_vjp.WGRAD_TC or s[4] <= 64))]


@pytest.mark.parametrize("shape,route", ROUTE_CASES, ids=str)
def test_wgrad_plan_covers_every_pixel_once_in_order(shape, route):
    """Every pixel of the batch lies in exactly one place of the order.
    Small route: block k of a tile's cluster takes image rows k * rpb ..,
    each half of it every other 4 pixels of a chunk, in order.  Tensor-core route: one k8 step of one warpgroup of one run;
    run kb takes chunks kb, kb + kblocks, .. (chunks ordered by image, then
    row tile, then column tile) in that order, and each warpgroup meets a
    chunk's pixels in row-major order.  On the size rule's route (None), or
    on each route where it is forced."""
    bsz, cin, cout, h, w = shape
    plan = conv_vjp.wgrad_plan(*shape, route=route)
    order = conv_vjp.wgrad_k_order(plan, bsz, h, w)
    n = bsz * h * w
    seen = order[order >= 0]
    assert torch.equal(torch.bincount(seen, minlength=n), torch.ones(n, dtype=torch.int64))
    if plan["route"] == conv_vjp.WGRAD_SMALL:
        for k in range(plan["cluster"]):
            for hf in range(2):
                pix = order[k, hf]
                pix = pix[pix >= 0]
                assert bool((pix // w // plan["rpb"] == k).all()) and bool((pix[1:] > pix[:-1]).all())
                j0 = k * plan["rpb"] + (pix // w - k * plan["rpb"]) // plan["rch"] * plan["rch"]
                assert bool(((pix - j0 * w) // 4 % 2 == hf).all())
        return
    tr, tc, ntx, nty, kblocks = plan["tr"], plan["tc"], plan["ntx"], plan["nty"], plan["kblocks"]
    for kb in range(kblocks):
        for wg in range(2):
            p = order[kb, wg].reshape(-1)
            p = p[p >= 0]
            b, rem = p // (h * w), p % (h * w)
            chunk = (b * nty + rem // w // tr) * ntx + rem % w // tc
            assert bool((chunk % kblocks == kb).all())
            key = chunk * n + p
            assert bool((key[1:] > key[:-1]).all())


@pytest.mark.parametrize("shape,route", ROUTE_CASES, ids=str)
def test_wgrad_plan_depends_only_on_the_sizes_and_the_sm_count(shape, route):
    """The same sizes give the same plan; another SM count changes only how
    the pixels are cut into runs (the tensor-core route's runs of chunks,
    the small route's blocks a cluster).  The plan fits the card.  Small
    route: 32 x 32 channels a block, a portable cluster, every row once,
    the staging and the cluster's sums within 100 KB.  Tensor-core route:
    two stages or more within a block's shared memory, a channel plane 4
    words mod 8 (conflict-free fragment loads), N and M covered by the
    blocks, one wave of blocks."""
    bsz, cin, cout, h, w = shape
    plan = conv_vjp.wgrad_plan(*shape, route=route)
    assert plan == conv_vjp.wgrad_plan(*shape, route=route)
    other = conv_vjp.wgrad_plan(*shape, sms=114, route=route)
    if plan["route"] == conv_vjp.WGRAD_SMALL:
        runs = ("cluster", "rpb", "rch", "xcap", "dcap", "blocks", "smem", "sms")
        assert {k: v for k, v in plan.items() if k not in runs} == {k: v for k, v in other.items() if k not in runs}
        rows = bsz * h
        assert plan["nti"] * 32 >= cin and plan["nto"] * 32 >= cout and plan["launches"] == 1
        assert 1 <= plan["cluster"] <= 8 and plan["cluster"] * plan["rpb"] >= rows > (plan["cluster"] - 1) * plan["rpb"]
        assert 1 <= plan["rch"] <= plan["rpb"] and plan["blocks"] == plan["nti"] * plan["nto"] * plan["cluster"]
        assert plan["smem"] <= 100 * 1024 and plan["xcap"] % 4 == 0 and plan["dcap"] % 4 == 0
        return
    runs = ("cpb", "kblocks", "rgroups", "blocks", "sms", "launches")
    assert {k: v for k, v in plan.items() if k not in runs} == {k: v for k, v in other.items() if k not in runs}
    assert 2 <= plan["stages"] <= 4 and plan["smem"] <= 220 * 1024
    assert plan["plane"] % 8 == 4 and plan["tc"] % 8 == 0 and plan["tr"] % 2 == 1
    assert plan["nsplit"] * plan["nb"] >= cout and plan["nb"] in (16, 32, 48)
    assert 4 * plan["groups"] * plan["tiles"] >= plan["slabs"] == 3 * math.ceil(cin / 16)
    # Runs of cpb or cpb - 1 chunks, at most one block an SM where the card has as many.
    assert plan["kblocks"] * plan["cpb"] >= plan["chunks"] > plan["kblocks"] * (plan["cpb"] - 1)
    assert plan["blocks"] <= max(plan["sms"], plan["groups"] * plan["nsplit"])
    assert plan["launches"] == (1 if plan["kblocks"] == 1 else 2)


def test_wgrad_plan_refuses_empty_sizes():
    with pytest.raises(ValueError, match="wgrad_plan"):
        conv_vjp.wgrad_plan(0, 16, 16, 4, 4)
    with pytest.raises(ValueError, match="no route"):
        conv_vjp.wgrad_plan(6, 16, 16, 4, 4, route="cudnn")
    with pytest.raises(ValueError, match="one row does not fit"):
        conv_vjp.wgrad_plan(1, 96, 300, 1, 200, route=conv_vjp.WGRAD_SMALL)


def small_route_reads(x: torch.Tensor, plan: dict) -> torch.Tensor:
    """What the small route's threads read, as ``(9, B * H * W, cin)``:
    for each tap and pixel (in the order of the image rows), the staged x
    at the pixel's position plus the tap's offset, built as
    ``wgrad_small_kernel`` stages a chunk: the staged rows run from the
    halo row above the chunk's first image row to the one below its last,
    across the images it touches, each (W + 2) positions wide with zero
    halo rows and columns; the chunk's staging must fit in the plan's
    ``xcap`` (unwritten entries are NaN here, so a read of one shows)."""
    bsz, cin, h, w = x.shape
    wp, rows = w + 2, bsz * h
    xrow = cin + 1
    out = torch.empty(9, rows * w, cin)
    for k in range(plan["cluster"]):
        j_lo, j_hi = k * plan["rpb"], min(rows, (k + 1) * plan["rpb"])
        for j0 in range(j_lo, j_hi, plan["rch"]):
            j1 = min(j_hi, j0 + plan["rch"])
            pr_lo, pr_hi = j0 + 2 * (j0 // h), j1 + 1 + 2 * ((j1 - 1) // h)
            nq = (pr_hi - pr_lo + 1) * wp
            assert nq * 33 <= plan["xcap"]  # the kernel's row of 32 channels + 1
            staged = torch.full((plan["xcap"] // 33 + 1, xrow), float("nan"))
            q = torch.arange(nq)
            pr, xp = pr_lo + q // wp, q % wp
            b, yp = pr // (h + 2), pr % (h + 2)
            inside = (yp >= 1) & (yp <= h) & (xp >= 1) & (xp <= w)
            vals = x[b.clamp(max=bsz - 1), :, (yp - 1).clamp(0, h - 1), (xp - 1).clamp(0, w - 1)]
            staged[:nq, :cin] = torch.where(inside[:, None], vals, 0.0)
            p = torch.arange((j1 - j0) * w)
            j, xx = j0 + p // w, p % w
            pos = (j + 2 * (j // h) + 1 - pr_lo) * wp + xx + 1
            for tap in range(9):
                out[tap, j0 * w + p] = staged[pos + (tap // 3 - 1) * wp + tap % 3 - 1, :cin]
    return out


@pytest.mark.parametrize("shape", [s for s in PATH_SHAPES if s[3] <= 16] + [s for s in RAGGED_SHAPES if s[4] <= 64],
                         ids=str)
def test_small_route_reads_every_tap_from_its_pixel(shape):
    """The small route's staging, as its plan sizes it, gives every tap of
    every pixel x at the pixel shifted by (ky - 1, kx - 1), zero outside
    the image, never a neighbouring image's pixel or an unstaged entry;
    so the taps' sums over the pixels are the weight gradient."""
    bsz, cin, cout, h, w = shape
    cin = min(cin, 4)  # the geometry does not depend on the channels
    plan = conv_vjp.wgrad_plan(bsz, cin, cout, h, w, route=conv_vjp.WGRAD_SMALL)
    x = torch.randn(bsz, cin, h, w, generator=torch.Generator().manual_seed(sum(shape)))
    got = small_route_reads(x, plan)
    xp = F.pad(x, (1, 1, 1, 1))
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        want = xp[:, :, ky:ky + h, kx:kx + w].permute(0, 2, 3, 1).reshape(-1, cin)
        assert torch.equal(got[tap], want), tap
