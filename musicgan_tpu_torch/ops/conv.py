"""Fused 3x3 conv, sub-pixel up-conv and whole generator block:
hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``fused_conv3x3`` (K1) replaces ``musicgan_tpu/ops/conv.py::fused_conv3x3``
(Pallas ``_kernel``); ``fused_conv3x3_msq`` (K2) replaces
``fused_conv3x3_msq`` (the same Pallas kernel with ``emit_msq``): K1 with
PixelNorm, also writing the pre-norm ``mean_c(u^2)`` map that the backward
pass of ``ops/conv_vjp.py`` needs; ``fused_upconv3x3`` (K3) replaces
``fused_upconv3x3`` (Pallas ``_upconv_kernel``).  All three kernels are one
template, ``csrc/conv_tile.cuh``, built by ``csrc/conv3x3.cu`` (K1, K2) and
``csrc/upconv3x3.cu``.  ``fused_block`` (K4) replaces ``fused_block``
(Pallas ``_block_kernel``): K1 with PixelNorm then K3 with PixelNorm in one
launch, ``csrc/block3x3.cu``, built from the template's tensor-core pieces
so that it sums every pixel in their order; the first conv's output stays
in a ring of rows in shared memory, zero outside the image.

Widths: any ``cout``.  Past 128 channels the kernel splits the channel
groups of a pixel over several thread blocks; with PixelNorm those blocks
form one thread-block cluster and add each other's per-pixel sums through
distributed shared memory, so PixelNorm takes up to
``MAX_PIXEL_NORM_CHANNELS`` (a portable cluster of 8 blocks of 128); K4
the same for both its convs.

What bounds them on an H100 depends on the image (``csrc/conv_tile.cuh``
says how each shape works).  From 32x32 up at the train step's widths: an
implicit GEMM on the tensor cores in 3xTF32 (each operand split into two
TF32 parts, three products summed in float32, which keeps float32's
accuracy; plain TF32 would not hold the conv bar), bound by those
operations or, for the up-conv's largest output, by its bytes.  Below that
a conv is a few MFLOP and what bounds it is latency: serial steps over the
input channels in too few blocks.  There the tile is a set of pixels of the
flattened batch (so every weight staged serves all images), the input
channels are split over a cluster of up to 8 blocks whose partial sums meet
in distributed shared memory, and each step's weights arrive as 16-byte
copies while the previous step computes, in float32 on the CUDA cores.  The
up-conv never writes the 4x-sized upsampled input: it runs the four 2x2
phase kernels on the small input.

Weights: the plain versions take OIHW; the kernels K1-K4 take the kernel
layout of :func:`kernel_weights` / :func:`kernel_upconv_weights` (input
channel, tap, output channel fastest, padded to 16 channels).  The
generator makes them once per weight version (``models/generator.py``) and
passes them as ``w_packed``.  :func:`pack_weights` /
:func:`pack_upconv_weights` keep the JAX package's layout, which the tests
hold the kernel layout against.

Dispatch: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel, anything else raises.  Nothing falls back.  Each wrapper counts its
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ..models.layers import (
    conv2d,
    conv3x3_on_nearest_up2x,
    leaky_relu,
    pixel_norm,
    subpixel_phase_kernels,
)

__all__ = [
    "fused_conv3x3",
    "fused_conv3x3_msq",
    "fused_upconv3x3",
    "fused_block",
    "fused_block_fits",
    "pack_weights",
    "pack_upconv_weights",
    "kernel_weights",
    "kernel_upconv_weights",
    "conv_plan",
    "conv3x3_plain",
    "conv3x3_msq_plain",
    "upconv3x3_plain",
    "fused_block_plain",
]

# Widest conv that may carry PixelNorm (csrc/conv_tile.cuh: the blocks that
# share a pixel's channels, 128 each, form one portable cluster of at most 8).
# Without PixelNorm there is no limit.
MAX_PIXEL_NORM_CHANNELS = 8 * 128
# Output channels rounded up to this in the kernel layout.
_CO = 16


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``(cout, cin, 3, 3)`` -> ``(cout, 9*cin)``, K ordered
    ``(dy, dx, c)`` (``musicgan_tpu/ops/conv.py::pack_weights``)."""
    cout, cin, kh, kw = w.shape
    assert (kh, kw) == (3, 3)
    return w.permute(0, 2, 3, 1).reshape(cout, 9 * cin).contiguous()


def pack_upconv_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``(cout, cin, 3, 3)`` -> ``(4, cout, 4*cin)``: the four
    sub-pixel phase kernels of ``conv3x3(upsample_nearest_2x(x))``, each
    packed like :func:`pack_weights` with K ordered ``(dy, dx, c)``; phase
    ``a * 2 + b`` makes output pixel ``(2i+a, 2j+b)``."""
    cout, cin, kh, kw = w.shape
    assert (kh, kw) == (3, 3)
    phases = [
        k.permute(0, 2, 3, 1).reshape(cout, 4 * cin)
        for k in subpixel_phase_kernels(w)
    ]
    return torch.stack(phases, dim=0).contiguous()


def _pad_cout(w: torch.Tensor) -> torch.Tensor:
    """OIHW weights with zero output channels appended up to a multiple of 16."""
    extra = -w.shape[0] % _CO
    return w if extra == 0 else torch.cat([w, w.new_zeros(extra, *w.shape[1:])])


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``(cout, cin, 3, 3)`` -> the layout K1 and K2 read,
    ``(cin, 9, coutp)``: taps ordered ``(dy, dx)``, the output channel
    fastest and zero from ``cout`` to ``coutp`` (``cout`` rounded up to 16).
    The weights of one input channel and one tap for a block's channels are
    then one run of 16-byte copies.  It is :func:`pack_weights` permuted."""
    cout, cin, kh, kw = w.shape
    assert (kh, kw) == (3, 3)
    return _pad_cout(w).permute(1, 2, 3, 0).reshape(cin, 9, -1).contiguous()


def kernel_upconv_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``(cout, cin, 3, 3)`` -> the layout K3 reads,
    ``(4, cin, 4, coutp)``: :func:`pack_upconv_weights`'s four sub-pixel
    phase kernels, each laid out as :func:`kernel_weights` lays out a 3x3
    kernel."""
    cout, cin, kh, kw = w.shape
    assert (kh, kw) == (3, 3)
    phases = [k.permute(1, 2, 3, 0).reshape(cin, 4, -1) for k in subpixel_phase_kernels(_pad_cout(w))]
    return torch.stack(phases, dim=0).contiguous()


def _epilogue(y, slope, pixel_norm_, eps):
    if slope is not None:
        y = leaky_relu(y, slope)
    if pixel_norm_:
        y = pixel_norm(y, eps)
    return y


def conv3x3_plain(x, w, b, slope=None, pixel_norm=False, eps=1e-8):
    """Plain version of K1: ``(B, cin, H, W)`` and OIHW weights ->
    ``(B, cout, H, W)``.  ``b`` may be None (no bias)."""
    return _epilogue(conv2d(x, w, b), slope, pixel_norm, eps)


def conv3x3_msq_plain(x, w, b, slope=None, eps=1e-8):
    """Plain version of K2: ``(y, m)`` with ``y`` as :func:`conv3x3_plain`
    with PixelNorm and ``m`` the ``(B, 1, H, W)`` mean over channels of the
    squared post-LeakyReLU activation (before ``+ eps`` and the scale)."""
    u = _epilogue(conv2d(x, w, b), slope, False, eps)
    m = torch.mean(torch.square(u), dim=1, keepdim=True)
    return u * torch.rsqrt(m + eps), m


def upconv3x3_plain(x, w, b, slope=None, pixel_norm=False, eps=1e-8):
    """Plain version of K3: ``(B, cin, H, W)`` and OIHW weights ->
    ``(B, cout, 2H, 2W)``."""
    return _epilogue(conv3x3_on_nearest_up2x(x, w, b), slope, pixel_norm, eps)


_CONV_TAIL = [_build.INT] * 5 + [_build.FLOAT, _build.INT]
_CONV_ARGS = [_build.PTR] * 4 + _CONV_TAIL + [_build.INT, _build.FLOAT]
_MSQ_ARGS = [_build.PTR] * 5 + _CONV_TAIL + [_build.FLOAT]


def _operands(name, x, w_packed, b, pixel_norm, cout):
    """Check the operands of a conv kernel; returns them contiguous with the
    bias's address (0 for none)."""
    for t in (x, w_packed) if b is None else (x, w_packed, b):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: every operand must be float32 on {x.device}")
    if b is not None and b.shape != (cout,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} for {cout} output channels")
    if pixel_norm and cout > MAX_PIXEL_NORM_CHANNELS:
        raise ValueError(
            f"{name}: PixelNorm over cout {cout} > {MAX_PIXEL_NORM_CHANNELS} is not supported"
        )
    b = None if b is None else b.contiguous()
    return x.contiguous(), w_packed.contiguous(), b, 0 if b is None else b.data_ptr()


def _kernel_layout(name, w, w_packed, upconv):
    """The kernel-layout weights: ``w_packed`` if given (checked), else made
    from the OIHW ``w``."""
    cout, cin = w.shape[:2]
    coutp = -(-cout // _CO) * _CO
    want = (4, cin, 4, coutp) if upconv else (cin, 9, coutp)
    if w_packed is None:
        return kernel_upconv_weights(w) if upconv else kernel_weights(w)
    if tuple(w_packed.shape) != want:
        raise ValueError(f"{name}: packed weights {tuple(w_packed.shape)}, not {want}")
    return w_packed


def _launch(name, x, w_packed, b, cout, out_hw, slope, pixel_norm, eps):
    """Check the operands, allocate the output and launch ``mg_<name>``."""
    bsz, cin, h, w = x.shape
    x, w_packed, b, b_ptr = _operands(name, x, w_packed, b, pixel_norm, cout)
    y = torch.empty(bsz, cout, *out_hw, device=x.device, dtype=torch.float32)
    _build.kernel(name, f"mg_{name}", _CONV_ARGS)(
        x.data_ptr(), w_packed.data_ptr(), b_ptr, y.data_ptr(),
        bsz, cin, cout, h, w, 0.0 if slope is None else slope,
        int(slope is not None), int(pixel_norm), eps, device=x.device,
    )
    return y


def fused_conv3x3(x, w, b, slope=None, pixel_norm=False, eps=1e-8, w_packed=None):
    """3x3 'SAME' conv on NCHW ``(B, cin, H, W)`` with OIHW weights ->
    ``(B, cout, H, W)``, with the bias / LeakyReLU / PixelNorm epilogue.
    ``b`` may be None (no bias: the input-gradient convs).
    ``w_packed``: ``kernel_weights(w)`` made ahead, for the kernel."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, slope, pixel_norm, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3x3: no kernel for device {x.device}")
    wp = _kernel_layout("fused_conv3x3", w, w_packed, False)
    y = _launch("conv3x3", x, wp, b, w.shape[0], x.shape[2:], slope, pixel_norm, eps)
    fused_conv3x3.launches += 1
    return y


def fused_conv3x3_msq(x, w, b, slope=None, eps=1e-8, w_packed=None):
    """Training forward of :func:`fused_conv3x3` with PixelNorm: returns
    ``(y, m)``, ``m`` the pre-norm ``mean_c(u^2)`` map ``(B, 1, H, W)``.
    It is the one intermediate the backward pass cannot rebuild from ``y``
    in float32: ``mean_c(y^2) = m / (m + eps)`` rounds to 1 for ``m >> eps``."""
    if x.device.type == "cpu":
        return conv3x3_msq_plain(x, w, b, slope, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3x3_msq: no kernel for device {x.device}")
    wp = _kernel_layout("fused_conv3x3_msq", w, w_packed, False)
    bsz, cin, h, wd = x.shape
    cout = w.shape[0]
    x, wp, b, b_ptr = _operands("conv3x3_msq", x, wp, b, True, cout)
    y = torch.empty(bsz, cout, h, wd, device=x.device, dtype=torch.float32)
    m = torch.empty(bsz, 1, h, wd, device=x.device, dtype=torch.float32)
    _build.kernel("conv3x3", "mg_conv3x3_msq", _MSQ_ARGS)(
        x.data_ptr(), wp.data_ptr(), b_ptr, y.data_ptr(), m.data_ptr(),
        bsz, cin, cout, h, wd, 0.0 if slope is None else slope,
        int(slope is not None), eps, device=x.device,
    )
    fused_conv3x3_msq.launches += 1
    return y, m


def fused_upconv3x3(x, w, b, slope=None, pixel_norm=False, eps=1e-8, w_packed=None):
    """``conv3x3(upsample_nearest_2x(x))`` on NCHW ``(B, cin, H, W)`` with
    OIHW weights -> ``(B, cout, 2H, 2W)``, with the fused epilogue.
    ``w_packed``: ``kernel_upconv_weights(w)`` made ahead, for the kernel."""
    if x.device.type == "cpu":
        return upconv3x3_plain(x, w, b, slope, pixel_norm, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_upconv3x3: no kernel for device {x.device}")
    wp = _kernel_layout("fused_upconv3x3", w, w_packed, True)
    h, w_ = x.shape[2:]
    y = _launch("upconv3x3", x, wp, b, w.shape[0], (2 * h, 2 * w_), slope, pixel_norm, eps)
    fused_upconv3x3.launches += 1
    return y


def fused_block_plain(x, w1, b1, w2, b2, slope=0.2, eps=1e-8):
    """Plain version of K4: :func:`conv3x3_plain` then :func:`upconv3x3_plain`,
    both with LeakyReLU and PixelNorm."""
    mid = conv3x3_plain(x, w1, b1, slope, True, eps)
    return upconv3x3_plain(mid, w2, b2, slope, True, eps)


# K4's geometry (csrc/block3x3.cu), mirrored here so that the widths it
# takes are known without the card: a cluster of up to 8 blocks of at most
# 128 channels each for either conv, the conv template's tensor-core tiles
# (m64 rows of 64 pixels, two consumer warpgroups), a ring of c1 rows in
# shared memory.
_TC_W, _TC_SW, _TC_CK, _TC_WG = 64, 72, 8, 2
_TC_SMEM_BUDGET_FLOATS = 220 * 1024 // 4
# Most dynamic shared memory a Hopper thread block may ask for.
SMEM_OPTIN_BYTES = 232448
# Most channels either conv of K4 takes: 8 blocks of 128 (a portable cluster).
MAX_BLOCK_CHANNELS = MAX_PIXEL_NORM_CHANNELS
# Output columns (of the input's resolution) a K4 strip makes: a c1 tile is
# 64 columns, one m64 row of the tensor cores, two of them halo.
BLOCK_STRIP = _TC_W - 2


def _tc_geom(k: int, n: int) -> tuple[int, int, int, int]:
    """``(tiles, phases a block, rows a warpgroup, taps a stage)`` of the
    conv template's tensor-core route at ``n`` channels a block
    (``conv_tile.cuh::tc_geom``)."""
    tiles = 8 if n <= 16 else 4 if n <= 32 else 2 if n <= 64 else 1
    ppb = min(tiles, 4) if k == 2 else 1
    return tiles, ppb, tiles // ppb, 9 if k == 3 else 4 * ppb


def _block_ring(th1: int, th2: int) -> int:
    nr = done = 0
    for k in range(32):
        nr = max(nr, (k + 1) * th1 - done * th2)
        done = ((k + 1) * th1 - 2) // th2
    return nr


def _block_geom(n1: int, n2: int) -> dict:
    def at(t1, dys):
        _, ppb2, rw2, nt2 = _tc_geom(2, n2)
        th1, th2 = _TC_WG * t1, _TC_WG * rw2
        plane1 = ((th1 if dys else th1 + 2) * _TC_SW + 23) // 32 * 32 + 8
        stage = max(_TC_CK * plane1 + 2 * (3 if dys else 9) * _TC_CK * n1, 2 * nt2 * _TC_CK * n2)
        nr = _block_ring(th1, th2)
        fixed = (n1 * ((nr * _TC_SW + 23) // 32 * 32 + 8) + _TC_WG * t1 * _TC_W
                 + 2 * _TC_WG * _tc_geom(2, n2)[0] * _TC_W)
        stages = min(4, (_TC_SMEM_BUDGET_FLOATS - fixed) // stage)
        return {"t1": t1, "dys": dys, "th1": th1, "th2": th2, "ring_rows": nr, "stages": stages,
                "smem_bytes": 4 * (stages * stage + fixed)}

    t0 = min(_tc_geom(3, n1)[0], 4)
    for dys in (0, 1):
        t1 = t0
        while t1 >= 1:
            g = at(t1, dys)
            if g["stages"] >= 2:
                return g
            t1 //= 2
    return at(1, 1)


def _block_width(c: int) -> tuple[int, int]:
    """``(channels a block, blocks)`` of a conv of ``c`` channels in K4: as
    the conv template splits them, the width rounded up to one K4 is built
    for (16, 32, 48, 64, 96, 128)."""
    groups = -(-c // 16)
    nsplit = -(-groups // 8)
    n = -(-groups // nsplit) * 16
    return (n if n <= 64 else 96 if n <= 96 else 128), nsplit


def block_tile(cmid: int, cout: int) -> dict | None:
    """K4's geometry at these widths, as ``csrc/block3x3.cu`` lays it out
    (``mg_block3x3_tile``), or None for widths it does not take (past
    ``MAX_BLOCK_CHANNELS``): channels a block ``n1``, ``n2`` and blocks
    ``nsplit1``, ``nsplit2`` of each conv, the ``cluster``, conv1's tiles a
    warpgroup ``t1`` and whether a stage holds one kernel row (``dys``),
    the rows of a conv1 tile ``th1`` and of a conv2 tile ``th2``, the c1
    ring's rows, the stages and the shared memory."""
    if not (1 <= cmid <= MAX_BLOCK_CHANNELS and 1 <= cout <= MAX_BLOCK_CHANNELS):
        return None
    n1, nsplit1 = _block_width(cmid)
    n2, nsplit2 = _block_width(cout)
    if n2 == 16 and _block_geom(n1, 16)["stages"] < 2:
        n2 = 32  # the ring conv2's 4-row tiles need does not fit
    g = _block_geom(n1, n2)
    if g["stages"] < 2:
        return None
    return {"n1": n1, "n2": n2, "nsplit1": nsplit1, "nsplit2": nsplit2,
            "cluster": max(nsplit1, nsplit2), **g}


_PLAN_BLOCK_KEYS = ("takes", "run_rows", "runs", "strips", "units", "blocks", "cluster", "c1_rows")


@functools.lru_cache(maxsize=256)
def _block_plan(bsz: int, cin: int, cmid: int, cout: int, h: int, w: int, device: int) -> dict:
    lib = _build.load("block3x3")
    fn = lib.mg_block3x3_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(_PLAN_BLOCK_KEYS))()
    with torch.cuda.device(device):
        err = fn(bsz, cin, cmid, cout, h, w, out)
    if err != 0:
        raise ValueError(f"block_plan: CUDA error {err} for sizes {(bsz, cin, cmid, cout, h, w)}")
    plan = dict(zip(_PLAN_BLOCK_KEYS, out))
    plan["takes"] = bool(plan["takes"])
    # conv1's pixels computed over those the block needs (c1 at H x W).
    plan["recompute"] = plan["c1_rows"] * _TC_W / (bsz * h * w)
    return plan


def block_plan(bsz: int, cin: int, cmid: int, cout: int, h: int, w: int, device=None) -> dict:
    """How K4 launches at these sizes on a CUDA device (the current one by
    default), as its launcher plans it from the sizes and the SM count:
    whether the generator ``takes`` it, the run of image rows a unit walks,
    the runs and strips, units, blocks, cluster, and ``recompute``, conv1's
    pixels computed over the c1 pixels needed.  Needs the card."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return dict(_block_plan(bsz, cin, cmid, cout, h, w, index))


# SMs of an H100 SXM: the card the generator's rule is stated for where
# the tensor is not on one (the CPU path, whose plain versions are the same
# function either way).
H100_SMS = 132


def block_takes(bsz: int, cin: int, cmid: int, cout: int, h: int, w: int, sms: int) -> bool:
    """K4's size rule (``csrc/block3x3.cu::plan_block``'s ``takes``): K1
    and K3 both take the conv template's tensor-core route at the block's
    sizes (their tiles fill half the ``sms``, from 32 columns) and units of
    runs of 8 rows of K4's 62-column strips fill half the card's clusters,
    so that little of conv1 is computed twice.  No timing."""
    tile = block_tile(cmid, cout)
    if tile is None or w < 32:
        return False

    def tc_blocks(k, c, nphase):
        groups = -(-c // 16)
        nsplit = -(-groups // 8)
        tiles, ppb, rows, _ = _tc_geom(k, -(-groups // nsplit) * 16)
        return -(-w // _TC_W) * -(-h // (_TC_WG * rows)) * bsz * (nphase // ppb) * nsplit

    strips = bsz * -(-w // BLOCK_STRIP)
    return (2 * tc_blocks(3, cmid, 1) > sms and 2 * tc_blocks(2, cout, 4) > sms
            and 2 * strips * -(-h // 8) > max(1, sms // tile["cluster"]))


def fused_block_fits(cin: int, cmid: int, cout: int, size=None, device=None) -> bool:
    """Whether a generator block takes K4 (else the K1 + K3 pair).  By the
    widths alone (``size`` None): K4 takes ``cmid`` and ``cout`` up to
    ``MAX_BLOCK_CHANNELS``, every width of ``ModelConfig()`` (``cin``
    streams through in steps of 8 channels).  With ``size = (B, H, W)``,
    also the kernel's own size rule, :func:`block_takes`, for the SMs of
    ``device`` (a CUDA one; otherwise an H100's): blocks 4 to 7 of a
    5-clip, nb_vec-10 call on an H100."""
    if block_tile(cmid, cout) is None:
        return False
    if size is None:
        return True
    dev = torch.device("cpu") if device is None else torch.device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else H100_SMS
    return block_takes(size[0], cin, cmid, cout, size[1], size[2], sms)


_BLOCK_ARGS = [_build.PTR] * 7 + [_build.INT] * 6 + [_build.FLOAT] * 2


@functools.lru_cache(maxsize=256)
def _block_workspace(cin: int, cmid: int, cout: int) -> int:
    """Floats of K4's workspace: every chunk's weights, split into the two
    TF32 parts a launch makes once and its stages copy."""
    fn = _build.load("block3x3").mg_block3x3_workspace
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    return fn(cin, cmid, cout)


def fused_block(x, w1, b1, w2, b2, slope=0.2, eps=1e-8, w1_packed=None, w2_packed=None):
    """A whole generator block on NCHW ``(B, cin, H, W)`` with OIHW weights
    ``w1`` ``(cmid, cin, 3, 3)`` and ``w2`` ``(cout, cmid, 3, 3)`` ->
    ``(B, cout, 2H, 2W)``: ``pn(lrelu(conv3x3(x)))``, kept on the chip, then
    ``pn(lrelu(conv3x3(up2x(.))))``, in one launch.  ``w1_packed``,
    ``w2_packed``: ``kernel_weights(w1)`` and ``kernel_upconv_weights(w2)``
    made ahead, the layouts K1 and K3 read too."""
    if x.device.type == "cpu":
        return fused_block_plain(x, w1, b1, w2, b2, slope, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block: no kernel for device {x.device}")
    bsz, cin, h, wd = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    if w1.shape[1] != cin or w2.shape[1] != cmid:
        raise ValueError(f"fused_block: weights {tuple(w1.shape)}, {tuple(w2.shape)} for {cin} input channels")
    w1p = _kernel_layout("fused_block", w1, w1_packed, False)
    w2p = _kernel_layout("fused_block", w2, w2_packed, True)
    if block_tile(cmid, cout) is None:
        raise ValueError(
            f"fused_block: PixelNorm over {cmid} or {cout} > {MAX_BLOCK_CHANNELS} "
            "channels is not supported"
        )
    if b1 is None or b2 is None:
        raise ValueError("fused_block: both convs carry a bias")
    x, w1p, b1, b1_ptr = _operands("block3x3", x, w1p, b1, True, cmid)
    _, w2p, b2, b2_ptr = _operands("block3x3", x, w2p, b2, True, cout)
    y = torch.empty(bsz, cout, 2 * h, 2 * wd, device=x.device, dtype=torch.float32)
    ws = torch.empty(_block_workspace(cin, cmid, cout), device=x.device, dtype=torch.float32)
    _build.kernel("block3x3", "mg_block3x3", _BLOCK_ARGS)(
        x.data_ptr(), w1p.data_ptr(), b1_ptr, w2p.data_ptr(), b2_ptr, ws.data_ptr(), y.data_ptr(),
        bsz, cin, cmid, cout, h, wd, slope, eps, device=x.device,
    )
    fused_block.launches += 1
    return y


_PLAN_KEYS = ("shape", "cluster", "split_k", "nsplit", "pixels_a_lane", "threads", "blocks",
              "smem_bytes", "tile_rows", "phases_a_block")
# The conv template's two routes (csrc/conv_tile.cuh): the large-image shape,
# an implicit GEMM on the tensor cores in 3xTF32, and the small-image shape,
# float32 on the CUDA cores.
_ROUTES = {1: ("large", "large_tc"), 2: ("small", "small_fp32")}


def conv_plan(kind: str, bsz: int, cin: int, cout: int, h: int, w: int, pixel_norm: bool) -> dict:
    """How K1/K2 (``kind="conv3x3"``) or K3 (``"upconv3x3"``) launches at
    these sizes on the current CUDA device, as the launcher plans it:
    ``shape`` ("large" or "small") and its ``route`` ("large_tc" or
    "small_fp32"), the cluster's blocks, its split over input channels, the
    channel splits, pixels a lane (large shape: accumulator tiles of 64
    pixels a warpgroup), threads a block, blocks, shared memory, and for the
    large shape the ``tile`` (image rows x columns a block) and K3's phases
    a block.  Needs the card (the plan reads its SM count)."""
    lib = _build.load(kind)
    fn = lib.mg_conv_plan
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    k, nphase = (2, 4) if kind == "upconv3x3" else (3, 1)
    err = fn(k, bsz, cin, cout, h, w, nphase, int(pixel_norm), out)
    if err != 0:
        raise ValueError(f"conv_plan({kind}): CUDA error {err} for sizes {(bsz, cin, cout, h, w)}")
    plan = dict(zip(_PLAN_KEYS, out))
    plan["shape"], plan["route"] = _ROUTES[plan["shape"]]
    plan["tile"] = (plan["tile_rows"], 64) if plan["shape"] == "large" else None
    return plan


fused_conv3x3.launches = 0
fused_conv3x3_msq.launches = 0
fused_upconv3x3.launches = 0
fused_block.launches = 0
