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
launch, ``csrc/block3x3.cuh``, built from the template's tensor-core pieces
so that it sums every pixel in their order; the first conv's output stays
in a ring of rows in shared memory, zero outside the image.

Dtypes: each of K1, K3 and K4 takes float32 in and out, bf16 in and out
(the JAX functions' ``out_dtype=jnp.bfloat16`` with bf16 activations), or
one of the JAX functions' two mixed pairs: bf16 in and float32 out, float32
in and bf16 out.  As the JAX functions do, the wrappers default to a
float32 output whatever ``x`` is (``out_dtype=torch.float32``); the plain
versions default to ``x``'s dtype.  The bf16 kernels are their own sources
(``csrc/conv3x3_bf16.cu``, ``upconv3x3_bf16.cu``, ``block3x3_bf16.cu``),
and so is each mixed pair (``<kernel>_bf16_f32.cu``, ``<kernel>_f32_bf16.cu``,
``block3x3_bf16_wide_f32.cu``).  K1 bf16 and K3 bf16 are a
kernel of their own, ``csrc/conv_bf16.cuh``, on the tensor cores at every
size, with its plan mirrored and its weight pack made by
``ops/conv_bf16.py``; K4 bf16 is ``csrc/block_bf16.cuh``, built from its
pieces (a strip walks down a run of rows, c1 held in a ring of rows in
conv2's operand layout; plan ``ops/conv_bf16.py::block_plan``, the same
packs): one block up to 128 channels, past them a cluster split as K1
bf16 and K3 bf16 split (``csrc/block3x3_bf16_wide.cu``), and where that
layout does not fit (``conv_bf16.cluster_fits``: inputs past 608
channels, at some widths of c1 and the output) its float32 template at
bf16 (``csrc/block3x3_bf16_template.cu``).  The
weights are rounded
to bf16 after packing (for K3 and K4's conv2, the summed sub-pixel phase
kernels), the bias stays float32, products are exact and summed in
float32, the epilogue runs in float32, and the output is rounded to bf16
once; K4 holds conv1's output in bf16, so it is K1 bf16 then K3 bf16.  The
JAX kernels compute in ``x``'s dtype and cast to ``out_dtype`` only at the
store, and so do the mixed kernels: bf16 in, float32 out is the bf16
kernel's exact products summed in float32 and its float32 epilogue, stored
unrounded (K4's c1 still bf16); float32 in, bf16 out is the float32
kernel's result rounded to bf16 once.  Each takes its same-dtype kernel's
plan, so its output rounded to bf16 is that kernel's bits.  K2 takes
float32, or bf16 with float32 ``y`` and ``m`` (the JAX function's outputs
are float32).  Each wrapper counts its bf16-in-and-out launches apart in
``.bf16_launches`` and its mixed ones in ``.mixed_launches`` (both are also
in ``.launches``); K1 and K3 count those whose plan splits PixelNorm over a
cluster in ``.cluster_launches`` (:func:`splits_pixel_norm`).

Widths: any ``cout``.  Past 128 channels the kernel splits the channel
groups of a pixel over several thread blocks; with PixelNorm those blocks
form one thread-block cluster and add each other's per-pixel sums through
distributed shared memory, so PixelNorm takes up to
``MAX_PIXEL_NORM_CHANNELS`` (a portable cluster of 8 blocks of 128); K4
the same for both its convs.

What bounds the float32 kernels on an H100 depends on the image
(``csrc/conv_tile.cuh`` says how each shape works; K1 bf16 and K3 bf16 are
bound by their bytes at every large shape, ``csrc/conv_bf16.cuh``).  From 32x32 up at the train step's widths: an
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

Weights: the plain versions take OIHW (float32, rounded to bf16 inside
where the input is bf16); the kernels K1-K4 take the kernel layout of
:func:`kernel_weights` / :func:`kernel_upconv_weights` (input channel, tap,
output channel fastest, padded to 16 channels) in the input's dtype.  The
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
from . import conv_bf16
from .nan_check import checked
from ..models.layers import (
    conv2d_same,
    leaky_relu,
    pixel_norm,
    subpixel_conv,
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
    "kernel_weights_tc",
    "conv_plan",
    "splits_pixel_norm",
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
# The element types a kernel takes, in and out (any pair of them).
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}


def out_dtype_of(name: str, x: torch.Tensor, out_dtype=None) -> torch.dtype:
    """The output dtype of a conv call: ``out_dtype``, or ``x``'s where it
    is None.  ``x``'s dtype, or the other of float32 and bf16 (the JAX
    functions' mixed pairs); any other pair raises."""
    out = x.dtype if out_dtype is None else out_dtype
    if out != x.dtype and not (x.dtype in KERNEL_DTYPES and out in KERNEL_DTYPES):
        raise NotImplementedError(
            f"{name}: {x.dtype} in and {out} out; a mixed pair is float32 and bfloat16, either way"
        )
    return out


def _kernel_out_dtype(name: str, x: torch.Tensor, out_dtype) -> torch.dtype:
    """A wrapper's checks before a kernel: the device, then ``x``'s dtype
    (one no kernel takes raises ValueError whatever the output's), then the
    pair (:func:`out_dtype_of`)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: x is {x.dtype}; the kernels take float32 or bfloat16")
    return out_dtype_of(name, x, out_dtype)


def _lib(name: str, dtype: torch.dtype, out: torch.dtype | None = None) -> str:
    """The source (library) of kernel ``name`` for ``x``'s ``dtype`` and
    the output's ``out`` (``dtype``'s by default): ``name``,
    ``name_bf16``, ``name_f32_bf16`` or ``name_bf16_f32``."""
    if out is None or out == dtype:
        return f"{name}_bf16" if dtype == torch.bfloat16 else name
    return f"{name}_{_TAG[dtype]}_{_TAG[out]}"


# K4 bf16's source a route (ops/conv_bf16.py::block_route).
_BF16_BLOCK_LIBS = {"bf16_cluster": "block3x3_bf16_wide", "template": "block3x3_bf16_template"}


def _block_lib(dtype: torch.dtype, cin: int, cmid: int, cout: int, out: torch.dtype | None = None) -> str:
    """K4's source for ``x``'s ``dtype``, the output's ``out`` and these
    widths: in bf16 up to 128 channels ``block3x3_bf16`` (``csrc/block_bf16.cuh``),
    past them ``block3x3_bf16_wide`` (the same kernel over a cluster) or,
    where that does not fit, ``block3x3_bf16_template`` (``block3x3.cuh``
    at bf16), each with ``_f32`` for a float32 output; float32
    ``block3x3`` or ``block3x3_f32_bf16``."""
    if dtype == torch.bfloat16:
        route = conv_bf16.block_route(cmid, cout, cin)
        if route != "bf16_tc":
            return _BF16_BLOCK_LIBS[route] + ("_f32" if out == torch.float32 else "")
    return _lib("block3x3", dtype, out)


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


def kernel_weights(w: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """OIHW ``(cout, cin, 3, 3)`` -> the layout K1 and K2 read,
    ``(cin, 9, coutp)``: taps ordered ``(dy, dx)``, the output channel
    fastest and zero from ``cout`` to ``coutp`` (``cout`` rounded up to 16).
    The weights of one input channel and one tap for a block's channels are
    then one run of 16-byte copies.  It is :func:`pack_weights` permuted,
    rounded to ``dtype`` after packing (the bf16 kernels' weights)."""
    cout, cin, kh, kw = w.shape
    assert (kh, kw) == (3, 3)
    return _pad_cout(w).permute(1, 2, 3, 0).reshape(cin, 9, -1).to(dtype).contiguous()


def kernel_upconv_weights(w: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """OIHW ``(cout, cin, 3, 3)`` -> the layout K3 reads,
    ``(4, cin, 4, coutp)``: :func:`pack_upconv_weights`'s four sub-pixel
    phase kernels, each laid out as :func:`kernel_weights` lays out a 3x3
    kernel; rounded to ``dtype`` after the phase sums, as the JAX package
    rounds ``pack_upconv_weights(w)``."""
    cout, cin, kh, kw = w.shape
    assert (kh, kw) == (3, 3)
    phases = [k.permute(1, 2, 3, 0).reshape(cin, 4, -1) for k in subpixel_phase_kernels(_pad_cout(w))]
    return torch.stack(phases, dim=0).to(dtype).contiguous()


def kernel_weights_tc(w: torch.Tensor, upconv: bool = False) -> torch.Tensor:
    """OIHW ``(cout, cin, 3, 3)`` -> the pack K1 bf16 (``upconv`` False)
    or K3 bf16 reads: :func:`kernel_weights` / :func:`kernel_upconv_weights`
    in bf16, moved into ``wgmma``'s K-major tiles by
    ``ops/conv_bf16.py::tc_weights`` (the same bf16 values)."""
    wk = kernel_upconv_weights(w, torch.bfloat16) if upconv else kernel_weights(w, torch.bfloat16)
    return conv_bf16.tc_weights(wk, upconv, w.shape[0])


def _epilogue(y, slope, pixel_norm_, eps):
    if slope is not None:
        y = leaky_relu(y, slope)
    if pixel_norm_:
        y = pixel_norm(y, eps)
    return y


def conv3x3_plain(x, w, b, slope=None, pixel_norm=False, eps=1e-8, out_dtype=None):
    """Plain version of K1: ``(B, cin, H, W)`` and OIHW weights ->
    ``(B, cout, H, W)``.  ``b`` may be None (no bias).  A bf16 ``x`` is
    computed in float32 (never a bf16 convolution: the products of bf16
    operands are exact there) on the weights rounded to bf16, and the
    output rounded to ``out_dtype`` (``x``'s by default) once."""
    out = out_dtype_of("conv3x3_plain", x, out_dtype)
    if x.dtype == torch.bfloat16:
        x, w = x.float(), w.to(torch.bfloat16).float()
    return _epilogue(conv2d_same(x, w, b), slope, pixel_norm, eps).to(out)


def conv3x3_msq_plain(x, w, b, slope=None, eps=1e-8):
    """Plain version of K2: ``(y, m)`` with ``y`` as :func:`conv3x3_plain`
    with PixelNorm and ``m`` the ``(B, 1, H, W)`` mean over channels of the
    squared post-LeakyReLU activation (before ``+ eps`` and the scale).  A
    bf16 ``x``: computed in float32 on the weights rounded to bf16, as
    :func:`conv3x3_plain`; ``y`` and ``m`` float32 (the JAX function's)."""
    if x.dtype == torch.bfloat16:
        x, w = x.float(), w.to(torch.bfloat16).float()
    u = _epilogue(conv2d_same(x, w, b), slope, False, eps)
    m = torch.mean(torch.square(u), dim=1, keepdim=True)
    return u * torch.rsqrt(m + eps), m


def upconv3x3_plain(x, w, b, slope=None, pixel_norm=False, eps=1e-8, out_dtype=None):
    """Plain version of K3: ``(B, cin, H, W)`` and OIHW weights ->
    ``(B, cout, 2H, 2W)``.  A bf16 ``x``: the four summed phase kernels
    rounded to bf16, the rest as :func:`conv3x3_plain`."""
    out = out_dtype_of("upconv3x3_plain", x, out_dtype)
    phases = subpixel_phase_kernels(w)  # conv3x3_on_nearest_up2x's decomposition
    if x.dtype == torch.bfloat16:
        x, phases = x.float(), [k.to(torch.bfloat16).float() for k in phases]
    return _epilogue(subpixel_conv(x, phases, b), slope, pixel_norm, eps).to(out)


_CONV_TAIL = [_build.INT] * 5 + [_build.FLOAT, _build.INT]
_CONV_ARGS = [_build.PTR] * 4 + _CONV_TAIL + [_build.INT, _build.FLOAT]
# The bf16 kernels also take a forced route and tile width (0: the size rule's).
_CONV_BF16_ARGS = _CONV_ARGS + [_build.INT, _build.INT]
_MSQ_ARGS = [_build.PTR] * 5 + _CONV_TAIL + [_build.FLOAT]


def _operands(name, x, w_packed, b, pixel_norm, cout):
    """Check the operands of a conv kernel: ``x`` and ``w_packed`` of one
    dtype the kernels take (float32 or bf16), the bias float32, all on
    ``x``'s device; returns them contiguous with the bias's address (0 for
    none)."""
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: x is {x.dtype}; the kernels take float32 or bfloat16")
    for t, dt in ((x, x.dtype), (w_packed, x.dtype)) + (() if b is None else ((b, torch.float32),)):
        if t.device != x.device or t.dtype != dt:
            raise ValueError(
                f"{name}: operand of {t.dtype} on {t.device}; x and its packed weights must be "
                f"{x.dtype} and the bias float32, all on {x.device}"
            )
    if b is not None and b.shape != (cout,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} for {cout} output channels")
    if pixel_norm and cout > MAX_PIXEL_NORM_CHANNELS:
        raise ValueError(
            f"{name}: PixelNorm over cout {cout} > {MAX_PIXEL_NORM_CHANNELS} is not supported"
        )
    b = None if b is None else b.contiguous()
    return x.contiguous(), w_packed.contiguous(), b, 0 if b is None else b.data_ptr()


def _kernel_layout(name, w, w_packed, upconv, dtype=torch.float32):
    """The kernel-layout weights in ``dtype``: ``w_packed`` if given
    (checked), else made from the OIHW ``w``."""
    cout, cin = w.shape[:2]
    coutp = -(-cout // _CO) * _CO
    want = (4, cin, 4, coutp) if upconv else (cin, 9, coutp)
    if w_packed is None:
        return kernel_upconv_weights(w, dtype) if upconv else kernel_weights(w, dtype)
    if tuple(w_packed.shape) != want:
        raise ValueError(f"{name}: packed weights {tuple(w_packed.shape)}, not {want}")
    return w_packed


def _bf16_weights(name, w, w_packed, upconv):
    """K1 bf16 / K3 bf16's weight pack (``kernel_weights_tc``): ``w_packed``
    as given where it is that pack, moved from the kernel layout where it
    is :func:`kernel_weights` / :func:`kernel_upconv_weights` in bf16 (the
    layout K4 reads), else made from the OIHW ``w``."""
    cout, cin = w.shape[:2]
    want = conv_bf16.tc_weights_shape(2 if upconv else 3, cin, cout)
    if w_packed is None:
        wp = kernel_weights_tc(w, upconv)
    elif w_packed.dim() == len(want):
        if tuple(w_packed.shape) != want:
            raise ValueError(f"{name}: packed weights {tuple(w_packed.shape)}, not {want}")
        wp = w_packed
    else:
        wp = conv_bf16.tc_weights(_kernel_layout(name, w, w_packed, upconv, torch.bfloat16), upconv, cout)
    # The kernel copies the pack by 16-byte bulk copies.
    return wp if wp.data_ptr() % 16 == 0 else wp.clone()


def _launch(name, x, w_packed, b, cout, out_hw, slope, pixel_norm, eps, route, tc, out):
    """Check the operands, allocate the output of dtype ``out`` and launch
    the entry of :func:`_lib`'s source for the pair (for bf16 ``x`` with
    its forced ``route`` name and tile width ``tc`` where given)."""
    bsz, cin, h, w = x.shape
    x, w_packed, b, b_ptr = _operands(name, x, w_packed, b, pixel_norm, cout)
    y = torch.empty(bsz, cout, *out_hw, device=x.device, dtype=out)
    lib = _lib(name, x.dtype, out)
    args = [x.data_ptr(), w_packed.data_ptr(), b_ptr, y.data_ptr(),
            bsz, cin, cout, h, w, 0.0 if slope is None else slope,
            int(slope is not None), int(pixel_norm), eps]
    if x.dtype == torch.bfloat16:
        _build.kernel(lib, f"mg_{lib}", _CONV_BF16_ARGS)(
            *args, 0 if route is None else conv_bf16.ROUTE_CODES[route], tc, device=x.device)
    elif route is not None or tc:
        raise ValueError(f"{name}: a forced route or tile width is for the bf16 kernels only")
    else:
        _build.kernel(lib, f"mg_{lib}", _CONV_ARGS)(*args, device=x.device)
    return y


def splits_pixel_norm(cout: int, pixel_norm: bool) -> bool:
    """Whether a K1 / K3 launch's plan splits PixelNorm over a thread-block
    cluster: PixelNorm over the channels of more than one block (past 128,
    ``conv_bf16.channel_split``), in either dtype."""
    return pixel_norm and conv_bf16.channel_split(cout)[1] > 1


def _count(wrapper, dtype, out, clustered: bool = False) -> None:
    wrapper.launches += 1
    if clustered:
        wrapper.cluster_launches += 1
    if dtype != out:
        wrapper.mixed_launches += 1
    elif dtype == torch.bfloat16:
        wrapper.bf16_launches += 1


def fused_conv3x3(x, w, b, slope=None, pixel_norm=False, eps=1e-8, w_packed=None, out_dtype=torch.float32,
                  route=None, tc=0):
    """3x3 'SAME' conv on NCHW ``(B, cin, H, W)`` with OIHW weights ->
    ``(B, cout, H, W)``, with the bias / LeakyReLU / PixelNorm epilogue.
    ``b`` may be None (no bias: the input-gradient convs).  ``x`` float32 or
    bf16; ``out_dtype`` float32 or bf16, float32 by default as the JAX
    function's (a caller that wants ``x``'s dtype passes it).
    ``w_packed``: ``kernel_weights(w, x.dtype)`` made ahead, for the kernel
    (bf16: or ``kernel_weights_tc(w)``, the pack K1 bf16 reads).  ``route``
    and ``tc`` force K1 bf16's route (``"small_bf16_tc"``,
    ``"large_bf16_tc"``) and tile width, for measurements and tests."""
    if x.device.type == "cpu":
        out = out_dtype_of("fused_conv3x3", x, out_dtype)
        return checked("fused_conv3x3", conv3x3_plain(x, w, b, slope, pixel_norm, eps, out))
    out = _kernel_out_dtype("fused_conv3x3", x, out_dtype)
    if x.dtype == torch.bfloat16:
        wp = _bf16_weights("fused_conv3x3", w, w_packed, False)
    else:
        wp = _kernel_layout("fused_conv3x3", w, w_packed, False, x.dtype)
    y = _launch("conv3x3", x, wp, b, w.shape[0], x.shape[2:], slope, pixel_norm, eps, route, tc, out)
    _count(fused_conv3x3, x.dtype, out, splits_pixel_norm(w.shape[0], pixel_norm))
    return checked("fused_conv3x3", y)


def fused_conv3x3_msq(x, w, b, slope=None, eps=1e-8, w_packed=None):
    """Training forward of :func:`fused_conv3x3` with PixelNorm: returns
    ``(y, m)``, ``m`` the pre-norm ``mean_c(u^2)`` map ``(B, 1, H, W)``.
    It is the one intermediate the backward pass cannot rebuild from ``y``
    in float32: ``mean_c(y^2) = m / (m + eps)`` rounds to 1 for ``m >> eps``.
    ``x`` float32, or bf16 (``w_packed`` then K1 bf16's pack or the bf16
    kernel layout): ``y`` and ``m`` are float32 either way, as the JAX
    function's; the bf16 call is K1 bf16's kernel with a float32 store
    (counted in ``.mixed_launches``)."""
    if x.device.type == "cpu":
        return checked("fused_conv3x3_msq", conv3x3_msq_plain(x, w, b, slope, eps))
    _kernel_out_dtype("fused_conv3x3_msq", x, torch.float32)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        wp = _bf16_weights("fused_conv3x3_msq", w, w_packed, False)
    else:
        wp = _kernel_layout("fused_conv3x3_msq", w, w_packed, False)
    bsz, cin, h, wd = x.shape
    cout = w.shape[0]
    x, wp, b, b_ptr = _operands("conv3x3_msq", x, wp, b, True, cout)
    y = torch.empty(bsz, cout, h, wd, device=x.device, dtype=torch.float32)
    m = torch.empty(bsz, 1, h, wd, device=x.device, dtype=torch.float32)
    lib, sym = ("conv3x3_bf16_f32", "mg_conv3x3_msq_bf16") if bf16 else ("conv3x3", "mg_conv3x3_msq")
    _build.kernel(lib, sym, _MSQ_ARGS)(
        x.data_ptr(), wp.data_ptr(), b_ptr, y.data_ptr(), m.data_ptr(),
        bsz, cin, cout, h, wd, 0.0 if slope is None else slope,
        int(slope is not None), eps, device=x.device,
    )
    fused_conv3x3_msq.launches += 1
    if bf16:
        fused_conv3x3_msq.mixed_launches += 1
    return checked("fused_conv3x3_msq", (y, m))


def fused_upconv3x3(x, w, b, slope=None, pixel_norm=False, eps=1e-8, w_packed=None, out_dtype=torch.float32,
                    route=None, tc=0):
    """``conv3x3(upsample_nearest_2x(x))`` on NCHW ``(B, cin, H, W)`` with
    OIHW weights -> ``(B, cout, 2H, 2W)``, with the fused epilogue.  Dtypes
    as :func:`fused_conv3x3`.  ``w_packed``: ``kernel_upconv_weights(w,
    x.dtype)`` made ahead, for the kernel (bf16: or
    ``kernel_weights_tc(w, upconv=True)``).  ``route``, ``tc``: as
    :func:`fused_conv3x3`'s, for K3 bf16."""
    if x.device.type == "cpu":
        out = out_dtype_of("fused_upconv3x3", x, out_dtype)
        return checked("fused_upconv3x3", upconv3x3_plain(x, w, b, slope, pixel_norm, eps, out))
    out = _kernel_out_dtype("fused_upconv3x3", x, out_dtype)
    if x.dtype == torch.bfloat16:
        wp = _bf16_weights("fused_upconv3x3", w, w_packed, True)
    else:
        wp = _kernel_layout("fused_upconv3x3", w, w_packed, True, x.dtype)
    h, w_ = x.shape[2:]
    y = _launch("upconv3x3", x, wp, b, w.shape[0], (2 * h, 2 * w_), slope, pixel_norm, eps, route, tc, out)
    _count(fused_upconv3x3, x.dtype, out, splits_pixel_norm(w.shape[0], pixel_norm))
    return checked("fused_upconv3x3", y)


def fused_block_plain(x, w1, b1, w2, b2, slope=0.2, eps=1e-8, out_dtype=None):
    """Plain version of K4: :func:`conv3x3_plain` then :func:`upconv3x3_plain`,
    both with LeakyReLU and PixelNorm; conv1's output in ``x``'s dtype (the
    JAX kernel's c1 scratch), so in bf16 it is the bf16 pair's, and with a
    float32 ``out_dtype`` K1 bf16 then K3 bf16 with a float32 output."""
    out = out_dtype_of("fused_block_plain", x, out_dtype)
    mid = conv3x3_plain(x, w1, b1, slope, True, eps)
    return upconv3x3_plain(mid, w2, b2, slope, True, eps, out)


# K4's geometry (csrc/block3x3.cuh), mirrored here so that the widths it
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
    """K4's geometry at these widths, as ``csrc/block3x3.cuh`` lays it out
    (``mg_block3x3_tile``), or None for widths it does not take (past
    ``MAX_BLOCK_CHANNELS``): channels a block ``n1``, ``n2`` and blocks
    ``nsplit1``, ``nsplit2`` of each conv, the ``cluster``, conv1's tiles a
    warpgroup ``t1`` and whether a stage holds one kernel row (``dys``),
    the rows of a conv1 tile ``th1`` and of a conv2 tile ``th2``, the c1
    ring's rows, the stages and the shared memory."""
    tile = _block_tile(cmid, cout)
    return None if tile is None else dict(tile)


@functools.lru_cache(maxsize=1024)
def _block_tile(cmid: int, cout: int) -> dict | None:
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


_PLAN_BLOCK_BF16_KEYS = ("takes", "tc", "run_rows", "runs", "strips", "units", "blocks", "nwg", "res1", "res2",
                         "stages", "smem_bytes", "cost", "pair_cost", "mb", "sms", "cluster", "nsplit1", "nsplit2")


@functools.lru_cache(maxsize=256)
def _block_plan(bsz: int, cin: int, cmid: int, cout: int, h: int, w: int, device: int, lib: str,
                tc: int = 0, run: int = 0) -> dict:
    fn = _build.load(lib).mg_block3x3_plan
    bf16_route = lib in ("block3x3_bf16", "block3x3_bf16_wide")
    keys = _PLAN_BLOCK_BF16_KEYS if bf16_route else _PLAN_BLOCK_KEYS
    if bf16_route:
        fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
        args = (bsz, cin, cmid, cout, h, w, tc, run)
    else:
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
        args = (bsz, cin, cmid, cout, h, w)
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(keys))()
    with torch.cuda.device(device):
        err = fn(*args, out)
    if err != 0:
        raise ValueError(f"block_plan: CUDA error {err} for sizes {(bsz, cin, cmid, cout, h, w)}")
    plan = dict(zip(keys, out))
    plan["takes"] = bool(plan["takes"])
    if bf16_route:
        plan["route"] = "bf16_tc" if plan["cluster"] == 1 else "bf16_cluster"
        plan["res1"], plan["res2"] = bool(plan["res1"]), bool(plan["res2"])
        # conv1's pixels computed over those the block needs: the strip's
        # two halo columns and the runs' two halo rows.
        plan["recompute"] = plan["strips"] * (plan["tc"] + 2) * (h + 2 * plan["runs"]) / (h * w)
    else:
        plan["route"] = "template"
        # conv1's pixels computed over those the block needs (c1 at H x W).
        plan["recompute"] = plan["c1_rows"] * _TC_W / (bsz * h * w)
    return plan


def block_plan(bsz: int, cin: int, cmid: int, cout: int, h: int, w: int, device=None,
               dtype: torch.dtype = torch.float32, tc: int = 0, run: int = 0) -> dict:
    """How K4 launches at these sizes on a CUDA device (the current one by
    default), as its launcher plans it from the sizes and the SM count.
    float32 (and bf16 ``route`` "template", inputs too wide for the
    cluster): whether the generator ``takes`` it, the run of image rows a
    unit walks, the runs and strips, units, blocks, cluster, and
    ``recompute``, conv1's pixels computed over the c1 pixels needed.  bf16
    (``route`` "bf16_tc" up to 128 channels, "bf16_cluster" past them,
    ``csrc/block_bf16.cuh``): the keys of ``ops/conv_bf16.py::block_plan``
    the launcher reports (``takes``, ``tc``, ``run_rows``, ``runs``,
    ``units``, ``nwg``, residency, ``stages``, ``cost`` and ``pair_cost``,
    ``cluster``, ``nsplit1``, ``nsplit2``, ...), ``tc`` and ``run`` forced
    as :func:`fused_block`'s.  Needs the card."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if dtype != torch.bfloat16 and (tc or run):
        raise ValueError("block_plan: a forced strip width or run is for K4 bf16 only")
    return dict(_block_plan(bsz, cin, cmid, cout, h, w, index, _block_lib(dtype, cin, cmid, cout), tc, run))


# SMs of an H100 SXM: the card the generator's rule is stated for where
# the tensor is not on one (the CPU path, whose plain versions are the same
# function either way).
H100_SMS = 132


def block_takes(bsz: int, cin: int, cmid: int, cout: int, h: int, w: int, sms: int) -> bool:
    """K4's size rule (``csrc/block3x3.cuh::plan_block``'s ``takes``): K1
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


def fused_block_fits(cin: int, cmid: int, cout: int, size=None, device=None,
                     dtype: torch.dtype = torch.float32) -> bool:
    """Whether a generator block takes K4 (else the K1 + K3 pair).  By the
    widths alone (``size`` None): K4 takes ``cmid`` and ``cout`` up to
    ``MAX_BLOCK_CHANNELS``, every width of ``ModelConfig()`` (``cin``
    streams through in steps of 8 channels), in both dtypes.  With ``size =
    (B, H, W)``, also the kernel's own size rule for the SMs of ``device``
    (a CUDA one; otherwise an H100's): in float32 :func:`block_takes`
    (blocks 4 to 7 of a 5-clip, nb_vec-10 call on an H100); in bf16 K4
    bf16's (``ops/conv_bf16.py::block_plan``'s ``takes``: its modelled time
    below K1 bf16 then K3 bf16's, and never past 128 channels, where the
    cluster route was measured no faster than the pair), and for inputs
    too wide for the cluster float32's, whose template that route runs."""
    if _block_tile(cmid, cout) is None:
        return False
    if size is None:
        return True
    dev = torch.device("cpu") if device is None else torch.device(device)
    sms = _sms(dev.index if dev.index is not None else torch.cuda.current_device()) if dev.type == "cuda" \
        else H100_SMS
    return _block_fits(cin, cmid, cout, tuple(size), sms, dtype == torch.bfloat16)


@functools.lru_cache(maxsize=64)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# The generator asks at every block of every forward: the rules are pure
# functions of the sizes, kept (their Python is a sizeable share of a
# synthesis call's host time).
@functools.lru_cache(maxsize=4096)
def _block_fits(cin: int, cmid: int, cout: int, size: tuple, sms: int, bf16: bool) -> bool:
    if bf16 and conv_bf16.block_route(cmid, cout, cin) != "template":
        return conv_bf16.block_plan(size[0], cin, cmid, cout, size[1], size[2], sms)["takes"]
    return block_takes(size[0], cin, cmid, cout, size[1], size[2], sms)


_BLOCK_ARGS = [_build.PTR] * 7 + [_build.INT] * 6 + [_build.FLOAT] * 2
# K4 bf16 also takes a forced strip width and run length (0: the size rule's).
_BLOCK_BF16_ARGS = _BLOCK_ARGS + [_build.INT, _build.INT]


@functools.lru_cache(maxsize=256)
def _block_workspace(cin: int, cmid: int, cout: int, lib: str) -> int:
    """4-byte words of K4's workspace in library ``lib``: every chunk's
    weights as its stages hold them (float32: split into the two TF32
    parts), laid out once a launch and copied by its stages; none for K4
    bf16 up to 128 channels, which reads the packs made ahead."""
    fn = _build.load(lib).mg_block3x3_workspace
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    return fn(cin, cmid, cout)


def fused_block(x, w1, b1, w2, b2, slope=0.2, eps=1e-8, w1_packed=None, w2_packed=None, out_dtype=torch.float32,
                tc=0, run=0):
    """A whole generator block on NCHW ``(B, cin, H, W)`` with OIHW weights
    ``w1`` ``(cmid, cin, 3, 3)`` and ``w2`` ``(cout, cmid, 3, 3)`` ->
    ``(B, cout, 2H, 2W)``: ``pn(lrelu(conv3x3(x)))``, kept on the chip, then
    ``pn(lrelu(conv3x3(up2x(.))))``, in one launch.  Dtypes as
    :func:`fused_conv3x3`.  ``w1_packed``, ``w2_packed``:
    ``kernel_weights(w1, x.dtype)`` and ``kernel_upconv_weights(w2,
    x.dtype)`` made ahead, the layouts K1 and K3 read too; in bf16 where
    ``csrc/block_bf16.cuh`` takes the widths (one block or a cluster) also
    ``kernel_weights_tc(w1)`` and ``kernel_weights_tc(w2, True)``, the packs
    K1 bf16 and K3 bf16 read and K4 bf16 reads (the kernel layout is moved
    into them on the card).  ``tc``, ``run``: K4 bf16's strip width and run
    length forced, for measurements and tests."""
    if x.device.type == "cpu":
        out = out_dtype_of("fused_block", x, out_dtype)
        return checked("fused_block", fused_block_plain(x, w1, b1, w2, b2, slope, eps, out))
    out = _kernel_out_dtype("fused_block", x, out_dtype)
    bsz, cin, h, wd = x.shape
    cmid, cout = w1.shape[0], w2.shape[0]
    if w1.shape[1] != cin or w2.shape[1] != cmid:
        raise ValueError(f"fused_block: weights {tuple(w1.shape)}, {tuple(w2.shape)} for {cin} input channels")
    if block_tile(cmid, cout) is None:
        raise ValueError(
            f"fused_block: PixelNorm over {cmid} or {cout} > {MAX_BLOCK_CHANNELS} "
            "channels is not supported"
        )
    if b1 is None or b2 is None:
        raise ValueError("fused_block: both convs carry a bias")
    bf16_tc = x.dtype == torch.bfloat16 and conv_bf16.block_route(cmid, cout, cin) != "template"
    if (tc or run) and not bf16_tc:
        raise ValueError("fused_block: a forced strip width or run is for K4 bf16's block_bf16.cuh only")
    if bf16_tc:
        w1p = _bf16_weights("fused_block", w1, w1_packed, False)
        w2p = _bf16_weights("fused_block", w2, w2_packed, True)
    else:
        # K4 bf16's template route (inputs too wide for the cluster) is
        # block3x3.cuh at bf16, which reads the kernel layout (a pack of K1
        # bf16 / K3 bf16 given is made anew).
        if x.dtype == torch.bfloat16:
            w1_packed = None if w1_packed is not None and w1_packed.dim() == 6 else w1_packed
            w2_packed = None if w2_packed is not None and w2_packed.dim() == 6 else w2_packed
        w1p = _kernel_layout("fused_block", w1, w1_packed, False, x.dtype)
        w2p = _kernel_layout("fused_block", w2, w2_packed, True, x.dtype)
    x, w1p, b1, b1_ptr = _operands("block3x3", x, w1p, b1, True, cmid)
    _, w2p, b2, b2_ptr = _operands("block3x3", x, w2p, b2, True, cout)
    y = torch.empty(bsz, cout, 2 * h, 2 * wd, device=x.device, dtype=out)
    lib = _block_lib(x.dtype, cin, cmid, cout, out)
    # The workspace (and the plan) are those of x's dtype, whatever the output's.
    ws = torch.empty(_block_workspace(cin, cmid, cout, _block_lib(x.dtype, cin, cmid, cout)), device=x.device,
                     dtype=torch.float32)
    args = [x.data_ptr(), w1p.data_ptr(), b1_ptr, w2p.data_ptr(), b2_ptr, ws.data_ptr(), y.data_ptr(),
            bsz, cin, cmid, cout, h, wd, slope, eps]
    if bf16_tc:
        _build.kernel(lib, f"mg_{lib}", _BLOCK_BF16_ARGS)(*args, tc, run, device=x.device)
    else:
        _build.kernel(lib, f"mg_{lib}", _BLOCK_ARGS)(*args, device=x.device)
    _count(fused_block, x.dtype, out)
    return checked("fused_block", y)


_PLAN_KEYS = ("shape", "cluster", "split_k", "nsplit", "pixels_a_lane", "threads", "blocks",
              "smem_bytes", "tile_rows", "phases_a_block")
# The conv template's two routes (csrc/conv_tile.cuh): the large-image shape,
# an implicit GEMM on the tensor cores in 3xTF32, and the small-image shape,
# float32 on the CUDA cores.
_ROUTES = {1: ("large", "large_tc"), 2: ("small", "small_fp32")}
_PLAN_BF16_KEYS = ("route_code", "tc", "th", "nb", "ntiles", "resident", "stages", "nwg", "blocks",
                   "smem_bytes", "n", "nsplit", "cluster", "mb", "ppb", "sms")


def conv_plan(kind: str, bsz: int, cin: int, cout: int, h: int, w: int, pixel_norm: bool,
              dtype: torch.dtype = torch.float32, route: str | None = None, tc: int = 0) -> dict:
    """How K1/K2 (``kind="conv3x3"``) or K3 (``"upconv3x3"``) launches at
    these sizes on the current CUDA device, as the launcher plans it.
    float32: ``shape`` ("large" or "small") and its ``route`` ("large_tc"
    or "small_fp32"), the cluster's blocks, its split over input channels,
    the channel splits, pixels a lane (large shape: accumulator tiles of 64
    pixels a warpgroup), threads a block, blocks, shared memory, and for the
    large shape the ``tile`` (image rows x columns a block) and K3's phases
    a block.  bf16 (K1 bf16, K3 bf16, ``csrc/conv_bf16.cuh``): the keys of
    ``ops/conv_bf16.py::plan`` that the launcher reports (``route``
    "small_bf16_tc" or "large_bf16_tc", ``tc``, ``th``, ``nb``, ...), with
    ``tile`` ``(th, tc)`` and ``phases_a_block``; ``route`` and ``tc``
    force them as the wrapper's do.  A mixed pair takes the plan of ``x``'s
    dtype (the kernels store another type, nothing else).  Needs the card
    (the plan reads its SM count)."""
    k, nphase = (2, 4) if kind == "upconv3x3" else (3, 1)
    lib = _build.load(_lib(kind, dtype))
    if dtype == torch.bfloat16:
        fn = lib.mg_conv_bf16_plan
        fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * len(_PLAN_BF16_KEYS))()
        code = 0 if route is None else conv_bf16.ROUTE_CODES[route]
        err = fn(k, bsz, cin, cout, h, w, int(pixel_norm), code, tc, out)
        if err != 0:
            raise ValueError(f"conv_plan({kind}, bf16): CUDA error {err} for sizes {(bsz, cin, cout, h, w)}")
        plan = dict(zip(_PLAN_BF16_KEYS, out))
        plan["route"] = conv_bf16.ROUTES[plan["route_code"]]
        plan["resident"] = bool(plan["resident"])
        plan["tile"] = (plan["th"], plan["tc"])
        plan["phases_a_block"] = plan["ppb"]
        plan["threads"] = 128 * plan["nwg"]
        return plan
    if route is not None or tc:
        raise ValueError("conv_plan: a forced route or tile width is for the bf16 kernels only")
    fn = lib.mg_conv_plan
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    err = fn(k, bsz, cin, cout, h, w, nphase, int(pixel_norm), out)
    if err != 0:
        raise ValueError(f"conv_plan({kind}): CUDA error {err} for sizes {(bsz, cin, cout, h, w)}")
    plan = dict(zip(_PLAN_KEYS, out))
    plan["shape"], plan["route"] = _ROUTES[plan["shape"]]
    plan["tile"] = (plan["tile_rows"], 64) if plan["shape"] == "large" else None
    return plan


fused_conv3x3.launches = fused_conv3x3.bf16_launches = fused_conv3x3.mixed_launches = 0
fused_conv3x3.cluster_launches = 0
fused_conv3x3_msq.launches = fused_conv3x3_msq.mixed_launches = 0
fused_upconv3x3.launches = fused_upconv3x3.bf16_launches = fused_upconv3x3.mixed_launches = 0
fused_upconv3x3.cluster_launches = 0
fused_block.launches = fused_block.bf16_launches = fused_block.mixed_launches = 0
