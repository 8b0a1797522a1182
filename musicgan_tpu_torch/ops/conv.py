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
launch, ``csrc/block3x3.cu``, the first conv's output kept in shared memory
with a one-pixel halo that is set to zero outside the image.

Widths: any ``cout``.  Past 128 channels the kernel splits the channel
groups of a pixel over several thread blocks; with PixelNorm those blocks
form one thread-block cluster and add each other's per-pixel sums through
distributed shared memory, so PixelNorm takes up to
``MAX_PIXEL_NORM_CHANNELS`` (a portable cluster of 8 blocks of 128).

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


# The shape of a K4 thread block (csrc/block3x3.cu): 8 warps, each thread 4
# rows x 16 channels of the first conv's tile, which is 32 columns wide.
_BLK_WARPS, _BLK_RA, _BLK_RB, _BLK_CK1, _BLK_CK2, _BLK_C1W = 8, 4, 2, 8, 16, 32
# Widest conv of K4: eight warps of 16 channels, PixelNorm inside the block.
MAX_BLOCK_CHANNELS = _BLK_WARPS * 16
# Most dynamic shared memory a Hopper thread block may ask for.
SMEM_OPTIN_BYTES = 232448
# Fewest rows of a K4 tile that the generator takes the kernel for: at 6
# rows x 30 columns the first conv is computed on (8 * 32) / (6 * 30) = 1.42
# times the pixels; the next smaller tile has 2 rows and costs 2.13 times.
MIN_BLOCK_ROWS = 6
# Most passes over the tile's rows that the second conv may need for a
# phase: each pass stages the phase's weights again and ends in barriers.
# Block 0 of the generator (128 output channels: one row group, 7 passes)
# measured 14 times the K1 + K3 pair's time on an H100.
MAX_BLOCK_PASSES = 2


def block_tile(cmid: int, cout: int) -> tuple[int, int, int] | None:
    """``(rows, shared-memory bytes, passes)`` of a K4 thread block at these
    widths, as ``csrc/block3x3.cu`` lays it out, or None for widths it does
    not take (more than ``MAX_BLOCK_CHANNELS``: K4's PixelNorm reduces
    inside one thread block).
    Eight warps of 16 channels x 4 rows make the first conv's tile, so it
    has ``4 * (8 // ceil(cmid / 16))`` rows, two of them halo; the second
    conv's ``8 // ceil(cout / 16)`` row groups make 2 rows each at a time,
    so a phase takes ``passes`` turns over the tile."""
    if not (1 <= cmid <= MAX_BLOCK_CHANNELS and 1 <= cout <= MAX_BLOCK_CHANNELS):
        return None
    cg_a, cg_b = -(-cmid // 16), -(-cout // 16)
    rg_a, rg_b = _BLK_WARPS // cg_a, _BLK_WARPS // cg_b
    r1 = _BLK_RA * rg_a
    c1 = cg_a * 16 * r1 * _BLK_C1W
    stage_a = _BLK_CK1 * (r1 + 2) * (_BLK_C1W + 2) + 9 * _BLK_CK1 * cg_a * 16
    stage_b = 4 * _BLK_CK2 * cg_b * 16 + cg_b * rg_b * _BLK_RB * 32
    return r1 - 2, 4 * (c1 + max(stage_a, stage_b)), -(-(r1 - 2) // (rg_b * _BLK_RB))


def fused_block_fits(cin: int, cmid: int, cout: int) -> bool:
    """Whether a generator block of these widths takes K4 (else the K1 + K3
    pair).  The card's rule, from the kernel's own layout: its shared memory
    (the first conv's whole tile for all ``cmid`` channels, plus staging)
    must fit a thread block's ``SMEM_OPTIN_BYTES``, which it does at every
    width PixelNorm allows; the tile, which shrinks as ``cmid`` grows
    because a block's eight warps hold 16 channels x 4 rows each, must keep
    ``MIN_BLOCK_ROWS`` rows, which holds up to 64 mid channels; and the
    second conv must cover it in ``MAX_BLOCK_PASSES`` passes a phase, which
    at those tiles holds up to 64 output channels.  Blocks 5, 6 and 7 of
    the full-width generator fit.  ``cin`` does not enter: the input streams
    through in steps of 8 channels."""
    tile = block_tile(cmid, cout)
    return (
        tile is not None and tile[0] >= MIN_BLOCK_ROWS
        and tile[1] <= SMEM_OPTIN_BYTES and tile[2] <= MAX_BLOCK_PASSES
    )


_BLOCK_ARGS = [_build.PTR] * 6 + [_build.INT] * 6 + [_build.FLOAT] * 2


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
    _build.kernel("block3x3", "mg_block3x3", _BLOCK_ARGS)(
        x.data_ptr(), w1p.data_ptr(), b1_ptr, w2p.data_ptr(), b2_ptr, y.data_ptr(),
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
