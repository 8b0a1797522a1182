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

Widths: without PixelNorm any ``cout`` (past 128 channels the kernel splits
the channel groups over the grid; the critic's convs reach 160).  With
PixelNorm ``cout <= 128`` (``MAX_COUT_PIXEL_NORM``): the norm reduces over
all channels of a pixel inside one thread block, which holds eight warps of
16 channels.  The generator's widest conv has 128.

What bounds them on an H100: float32 operations.  At the generator's
widths (16..128 channels) a 3x3 conv does 2 * 9 * cin FLOP per output
value against 4 bytes stored, above the card's float32 ridge of about
20 FLOP/byte (67 TFLOP/s over 3.35 TB/s), so the CUDA cores, not the
memory, are the limit.  The design keeps the FMA units fed from
registers: each thread holds 4 rows x 16 channels of accumulators, reads
its input column once per tap row and its 16 weights as broadcast float4
loads from shared memory, and the epilogue (bias, LeakyReLU, PixelNorm)
runs on the accumulators before the only store.  Each 8-channel chunk is
staged with ``cp.async``, every copy in flight at once: a load-at-a-time
staging loop left the kernel waiting on memory latency (2.3x slower at
block 7 of the up-conv on an H100; PERF.md).  The up-conv never writes
the 4x-sized upsampled input: it reads the small input and runs the four
2x2 phase kernels (2.25x fewer MACs than a 3x3 conv on the upsampled
tensor).  Float32 on the CUDA cores is the first, simple form; tensor
cores (TF32 or bf16 ``wgmma``) are later work.

Small images (the critic's last blocks, the generator's first: 1x1 to
32x32 at 80-160 channels) are not bound by operations but by one block's
chain of serial steps over the input channels, with most of the 32x4 tile
masked.  For them the launcher takes a second shape of the same template
(one row a thread, the tile's width fitted to the image, 16 input channels
a step) whenever the large shape's grid would fill less than half of the
card's SMs; it is 1.4-2x faster there on an H100 and slower from 64x64 on
(PERF.md).

Dispatch: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel, anything else raises.  Nothing falls back.  Each wrapper counts its
launches in ``.launches``.  The plain versions take the OIHW weights; the
kernels take them packed, which the generator does once per weight
(``models/generator.py``) and passes as ``w_packed``.
"""

from __future__ import annotations

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
    "conv3x3_plain",
    "conv3x3_msq_plain",
    "upconv3x3_plain",
    "fused_block_plain",
]

# Widest conv that may carry PixelNorm (csrc/conv_tile.cuh: the norm needs
# every channel of a pixel in one block, eight warps of 16 channels).
# Without PixelNorm there is no limit.
MAX_COUT_PIXEL_NORM = 128


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


def _operands(name, x, w_packed, b, pixel_norm):
    """Check the operands of a conv kernel; returns them contiguous with the
    bias's address (0 for none) and ``cout``."""
    cout = w_packed.shape[-2]
    for t in (x, w_packed) if b is None else (x, w_packed, b):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: every operand must be float32 on {x.device}")
    if b is not None and b.shape != (cout,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} for {cout} output channels")
    if pixel_norm and cout > MAX_COUT_PIXEL_NORM:
        raise ValueError(
            f"{name}: PixelNorm over cout {cout} > {MAX_COUT_PIXEL_NORM} is not supported"
        )
    b = None if b is None else b.contiguous()
    return x.contiguous(), w_packed.contiguous(), b, 0 if b is None else b.data_ptr(), cout


def _launch(name, x, w_packed, b, out_hw, slope, pixel_norm, eps):
    """Check the operands, allocate the output and launch ``mg_<name>``."""
    bsz, cin, h, w = x.shape
    x, w_packed, b, b_ptr, cout = _operands(name, x, w_packed, b, pixel_norm)
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
    ``w_packed``: ``pack_weights(w)`` made ahead, for the kernel."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, slope, pixel_norm, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3x3: no kernel for device {x.device}")
    wp = pack_weights(w) if w_packed is None else w_packed
    y = _launch("conv3x3", x, wp, b, x.shape[2:], slope, pixel_norm, eps)
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
    wp = pack_weights(w) if w_packed is None else w_packed
    bsz, cin, h, wd = x.shape
    x, wp, b, b_ptr, cout = _operands("conv3x3_msq", x, wp, b, True)
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
    ``w_packed``: ``pack_upconv_weights(w)`` made ahead, for the kernel."""
    if x.device.type == "cpu":
        return upconv3x3_plain(x, w, b, slope, pixel_norm, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_upconv3x3: no kernel for device {x.device}")
    wp = pack_upconv_weights(w) if w_packed is None else w_packed
    h, w_ = x.shape[2:]
    y = _launch("upconv3x3", x, wp, b, (2 * h, 2 * w_), slope, pixel_norm, eps)
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
    not take (PixelNorm over more than ``MAX_COUT_PIXEL_NORM`` channels).
    Eight warps of 16 channels x 4 rows make the first conv's tile, so it
    has ``4 * (8 // ceil(cmid / 16))`` rows, two of them halo; the second
    conv's ``8 // ceil(cout / 16)`` row groups make 2 rows each at a time,
    so a phase takes ``passes`` turns over the tile."""
    if not (1 <= cmid <= MAX_COUT_PIXEL_NORM and 1 <= cout <= MAX_COUT_PIXEL_NORM):
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
    ``w2_packed``: ``pack_weights(w1)`` and ``pack_upconv_weights(w2)`` made
    ahead, for the kernel."""
    if x.device.type == "cpu":
        return fused_block_plain(x, w1, b1, w2, b2, slope, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block: no kernel for device {x.device}")
    w1p = pack_weights(w1) if w1_packed is None else w1_packed
    w2p = pack_upconv_weights(w2) if w2_packed is None else w2_packed
    bsz, cin, h, wd = x.shape
    cmid, cout = w1p.shape[0], w2p.shape[1]
    if w1p.shape != (cmid, 9 * cin) or w2p.shape != (4, cout, 4 * cmid):
        raise ValueError(
            f"fused_block: packed weights {tuple(w1p.shape)}, {tuple(w2p.shape)} "
            f"for widths {cin} -> {cmid} -> {cout}"
        )
    if block_tile(cmid, cout) is None:
        raise ValueError(
            f"fused_block: PixelNorm over {cmid} or {cout} > {MAX_COUT_PIXEL_NORM} "
            "channels is not supported"
        )
    if b1 is None or b2 is None:
        raise ValueError("fused_block: both convs carry a bias")
    x, w1p, b1, b1_ptr, _ = _operands("block3x3", x, w1p, b1, True)
    _, w2p, b2, b2_ptr, _ = _operands("block3x3", x, w2p, b2, True)
    y = torch.empty(bsz, cout, 2 * h, 2 * wd, device=x.device, dtype=torch.float32)
    _build.kernel("block3x3", "mg_block3x3", _BLOCK_ARGS)(
        x.data_ptr(), w1p.data_ptr(), b1_ptr, w2p.data_ptr(), b2_ptr, y.data_ptr(),
        bsz, cin, cmid, cout, h, wd, slope, eps, device=x.device,
    )
    fused_block.launches += 1
    return y


fused_conv3x3.launches = 0
fused_conv3x3_msq.launches = 0
fused_upconv3x3.launches = 0
fused_block.launches = 0
