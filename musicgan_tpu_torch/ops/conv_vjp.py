"""The trainable fused conv: the CUDA forward kernels under a gradient whose
input-gradient conv is the hand-written kernel again.

Counterpart of ``musicgan_tpu/ops/conv_vjp.py::conv3x3_act`` (a
``jax.custom_vjp``), as a ``torch.autograd.Function`` with the same split:

* **forward**: ``fused_conv3x3_msq`` (K2) when PixelNorm is on, which also
  gives the pre-norm ``m = mean_c(u^2)`` map, else ``fused_conv3x3`` (K1).
  Saved for the backward: ``x`` (only if the weight needs a gradient), ``w``,
  the output ``y`` and ``m``.  No pre-activation is kept: ``u = y / r`` and
  ``sign(preact) = sign(y)``, because LeakyReLU and the positive norm scale
  both keep the sign.
* **backward, epilogue** (plain PyTorch, as it is XLA elementwise math in
  JAX): per pixel, with ``r = (m + eps)^-1/2`` and ``y_c = u_c * r``,

      dL/du_c = r * (g_c - y_c * mean_k(g_k * y_k)),
      dpre    = du * where(y >= 0, 1, slope)

  (the subgradient at 0 is 1, as in ``layers.leaky_relu``, whose
  ``torch.where`` gives the same under autograd).
* **backward, input gradient**: K1 on ``dpre`` with the 180-degree-rotated,
  in/out-swapped weights and no bias: the transpose of a 'SAME' 3x3 conv is
  a 'SAME' 3x3 conv.  It is launched on the card, never a library call.
* **backward, weight and bias**: the weight gradient is
  :func:`weight_grad3x3`, a hand-written kernel (``csrc/wgrad3x3.cu``, an
  implicit GEMM with the pixels as K on the tensor cores in 3xTF32, and for
  images of at most 16x16 float32 FMAs in one launch) that sums in a fixed
  order, so a train run on the card gives the same bits
  run after run and a resumed run equals the uninterrupted one (JAX leaves
  it to XLA; its plain version is the library's conv-backward-weights);
  ``db = sum(dpre)``.  :func:`wgrad_plan` mirrors the kernel's launch plan
  and :func:`wgrad_k_order` the order in which it sums the pixels.

The Function is differentiable once (``once_differentiable``).  The WGAN-GP
needs an input gradient inside the loss; ``models/discriminator.py::
critic_input_grad_nchw_train`` unrolls that inner backward by hand from
first-order calls of this Function, so nothing here is differentiated twice.

Dispatch: on a CPU tensor ``conv3x3_act`` is :func:`conv3x3_act_plain`
(ordinary autograd through the plain conv), on a CUDA tensor it is the
Function, anything else raises.  The Function packs the weights for the
kernels at every call: they change at every train step.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .nan_check import checked
from .conv import H100_SMS, conv3x3_plain, fused_conv3x3, fused_conv3x3_msq

__all__ = ["conv3x3_act", "conv3x3_act_plain", "conv3x3_act_backward", "weight_grad3x3",
           "weight_grad3x3_plain", "wgrad_kernel_plan", "wgrad_k_order", "wgrad_plan", "wgrad_route"]


def conv3x3_act_plain(x, w, b, slope=0.2, pixel_norm=False, eps=1e-8):
    """Plain version: the plain conv and epilogue under ordinary autograd."""
    return conv3x3_plain(x, w, b, slope, pixel_norm, eps)


def weight_grad3x3_plain(x, dpre, w_shape):
    """Plain version of :func:`weight_grad3x3`: the library's weight
    gradient of a 3x3 'SAME' conv (TF32 off on the card, where cuDNN would
    take it by default)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.nn.grad.conv2d_weight(x, w_shape, dpre, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# ---- The weight-gradient kernel's plan, as csrc/wgrad3x3.cu::plan_wgrad
# makes it from the sizes and the SM count (no timing).
_WG_FLUSH = 4          # k8 steps between flushes of the fresh accumulator
_WG_PIXELS = 256       # pixels a chunk aims at
_WG_RED = 8            # groups of runs the second launch adds in parallel
_WG_SMEM_BUDGET = 220 * 1024
_WS_TI, _WS_TO = 32, 32  # the small route's input and output channels a block
_WS_XROW = _WS_TI + 1  # floats a staged x position
_WS_PIXELS = 32        # pixels a block of a cluster takes at least
_WS_MAX_SIDE = 16      # the size rule: images of at most 16 x 16 take the small route
_WS_SMEM = 100 * 1024   # a block's staging
_MAX_CLUSTER = 8
WGRAD_TC, WGRAD_SMALL = "tc_3xtf32", "small_fp32"
WGRAD_ROUTES = (WGRAD_TC, WGRAD_SMALL)  # the kernel's codes 0 and 1


def wgrad_route(h: int, w: int) -> str:
    """The size rule between the weight gradient's two routes (the
    kernel's ``wgrad_small_takes``): float32 FMAs in one launch for images
    of at most 16x16, where the tensor-core route's fixed costs dominate,
    else 3xTF32 on the tensor cores."""
    return WGRAD_SMALL if h <= _WS_MAX_SIDE and w <= _WS_MAX_SIDE else WGRAD_TC


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _padded_steps(ns: int) -> int:
    """A chunk's k8 steps padded to a multiple of 4, an even share for each
    consumer warpgroup (the kernel's ``wgrad_padded_steps``)."""
    return _cdiv(ns, 4) * 4


def _small_plan(bsz: int, cin: int, cout: int, h: int, w: int, sms: int) -> dict:
    nti, nto = _cdiv(cin, _WS_TI), _cdiv(cout, _WS_TO)
    tiles, rows = nti * nto, bsz * h
    # Blocks a tile: one wave (a block an SM on 3/4 of the SMs: a cluster's
    # blocks share a GPC), at least _WS_PIXELS pixels a block, a portable cluster.
    cl = max(1, min(_MAX_CLUSTER, rows, max(1, 3 * sms // 4 // tiles), _cdiv(rows * w, _WS_PIXELS)))
    rpb = _cdiv(rows, cl)

    def caps(r):  # x's staged positions (rows and each touched image's halo rows), d's pixels
        xrows = r + 2 + 2 * ((r + h - 2) // h)
        return _cdiv(xrows * (w + 2) * _WS_XROW, 4) * 4, _cdiv(r * w, 4) * 4

    def nbytes(r):
        xcap, dcap = caps(r)
        return 4 * (xcap + (_WS_TO + 1) * dcap)

    rch = rpb
    while rch > 1 and nbytes(rch) > _WS_SMEM:
        rch -= 1
    if nbytes(rch) > _WS_SMEM:
        raise ValueError(f"wgrad_plan: one row does not fit at {(bsz, cin, cout, h, w)}")
    cluster = _cdiv(rows, rpb)
    xcap, dcap = caps(rch)
    return {
        "route": WGRAD_SMALL, "nti": nti, "nto": nto, "cluster": cluster, "rpb": rpb, "rch": rch,
        "xcap": xcap, "dcap": dcap, "blocks": tiles * cluster,
        "smem": max(nbytes(rch), 4 * _WS_TO * _WS_TI * 9), "sms": sms,
        "launches": 1, "tma": False,
    }


def wgrad_plan(bsz: int, cin: int, cout: int, h: int, w: int, sms: int = H100_SMS,
               route: str | None = None) -> dict:
    """The weight-gradient kernel's launch plan at these sizes on a card of
    ``sms`` SMs, as ``csrc/wgrad3x3.cu::plan_wgrad`` makes it (and
    :func:`wgrad_kernel_plan` reads it from the card), on the route of the
    size rule (:func:`wgrad_route`) or the one named.

    The small route (``"small_fp32"``): ``nti`` x ``nto`` tiles of 32 input
    x 32 output channels, ``cluster`` blocks a tile (a thread-block cluster
    that adds its blocks' sums in rank order), block ``k`` taking the
    flattened image rows ``(b, y)`` ``[k * rpb, k * rpb + rpb)`` in chunks
    of ``rch`` rows (x staged in ``xcap`` floats, d in ``dcap`` pixels);
    one launch.

    The tensor-core route (``"tc_3xtf32"``):

    * M = 3 * cin, rows (input channel, kx), in ``slabs`` of 16 channels x
      one kx, m64 tiles of 4 slabs, ``groups`` of ``tiles`` tiles a block;
      N = 3 * ``nb``, columns (ky, output channel), ``nb`` 16, 32 or 48
      output channels a block (one wgmma m64n48k8, m64n96k8 or m64n144k8;
      at most 32 below 64x64 images), ``nsplit`` blocks;
    * K = the pixels of x in ``chunks`` of ``tr`` rows x ``tc`` columns of
      one image (``ntx`` x ``nty`` an image), ``nch`` input channels staged
      with their column halo and d's rows with their row halo, ``stages``
      stages in a ring, and each consumer's B (of one flush group's steps)
      of ``bbuf`` floats;
    * ``kblocks`` runs of at most ``cpb`` chunks (run ``kb`` takes chunks
      ``kb``, ``kb + kblocks``, ..), one block each per (group, split):
      ``blocks`` in all; where ``kblocks`` > 1 a second
      launch adds the runs' partial sums in order, in ``rgroups`` groups of
      consecutive runs (``launches`` 2), else the block writes dw (1).

    ``route`` is the one route (3xTF32 on the tensor cores); ``tma``: the
    chunks are copied by the tensor memory accelerator (W a multiple of 4,
    and x and d 16-byte aligned, which a fresh tensor is), else by 4-byte
    copies, the same bits either way; ``cluster`` is 1: no block reads
    another's shared memory.  Raises ValueError for sizes the kernel does
    not take."""
    if min(bsz, cin, cout, h, w, sms) < 1:
        raise ValueError(f"wgrad_plan: sizes {(bsz, cin, cout, h, w)} on {sms} SMs")
    route = wgrad_route(h, w) if route is None else route
    if route == WGRAD_SMALL:
        return _small_plan(bsz, cin, cout, h, w, sms)
    if route != WGRAD_TC:
        raise ValueError(f"wgrad_plan: no route {route!r}")
    # 16, 32 or 48 output channels a block: at most 48 from 64x64 images up, 32 below.
    nsplit = _cdiv(cout, 48 if h * w >= 64 * 64 else 32)
    nb = _cdiv(_cdiv(cout, nsplit), 16) * 16
    slabs = 3 * _cdiv(cin, 16)
    mtiles = _cdiv(slabs, 4)
    max_tiles = 2 if nb == 16 else 1  # what the consumers' registers hold
    groups = _cdiv(mtiles, max_tiles)
    tiles = _cdiv(mtiles, groups)
    span = max((min(slabs, 4 * (gi + 1) * tiles) - 1) // 3 - 4 * gi * tiles // 3 + 1 for gi in range(groups))
    nch = 16 * span
    tc = 64 if w >= 64 else _cdiv(w, 8) * 8
    sw = tc + 12  # columns c0 - 4 .. c0 + tc + 7: an odd number of 16-byte words

    def stage_floats(tr):  # x's rows, d's rows with their halo
        return nch * tr * sw + (tr + 2) * tc * nb

    bbuf = 2 * 2 * _WG_FLUSH * 3 * nb * 4  # a consumer's B of one flush group, big and small

    tr = 1  # odd, so that a channel plane, tr * sw, is 4 words mod 8
    while tr + 2 <= min(h, max(1, _WG_PIXELS // tc)):
        tr += 2
    while tr > 1 and 4 * (3 * stage_floats(tr) + 2 * bbuf) > _WG_SMEM_BUDGET:
        tr -= 2
    stage = stage_floats(tr)
    stages = min(4, (_WG_SMEM_BUDGET // 4 - 2 * bbuf) // stage)
    if stages < 2:
        raise ValueError(f"wgrad_plan: two stages do not fit at {(bsz, cin, cout, h, w)}")
    ntx, nty = _cdiv(w, tc), _cdiv(h, tr)
    chunks = bsz * nty * ntx
    units = groups * nsplit
    kblocks = max(1, min(chunks, sms // units))  # runs: at most one block an SM, one a chunk
    cpb = _cdiv(chunks, kblocks)
    return {
        "route": WGRAD_TC, "nsplit": nsplit, "nb": nb, "slabs": slabs, "tiles": tiles, "groups": groups,
        "nch": nch, "tc": tc, "tr": tr, "plane": tr * sw, "stage": stage, "stages": stages, "bbuf": bbuf,
        "ntx": ntx, "nty": nty, "chunks": chunks, "cpb": cpb, "kblocks": kblocks,
        "rgroups": min(_WG_RED, kblocks), "blocks": units * kblocks,
        "smem": 4 * max(stages * stage + 2 * bbuf, 64 * tiles * 3 * nb) + 8 * 4, "sms": sms, "cluster": 1,
        "launches": 1 if kblocks == 1 else 2, "tma": w % 4 == 0,
    }


def wgrad_k_order(plan: dict, bsz: int, h: int, w: int) -> torch.Tensor:
    """The order in which the kernel of ``plan`` sums the pixels, as an
    int64 tensor of flattened pixel indices ``(b * h + y) * w + x``, -1
    where there is none.

    The small route: ``(cluster, 2, rpb * w)``, block ``k``'s pixels (image
    rows ``k * rpb`` .., in chunks of ``rch`` rows) in the order each of
    its two halves adds them into one float32 FMA sum: half ``h`` takes a
    chunk's pixels ``8 j + 4 h`` .. ``+ 3`` (``j`` = 0, 1, ..); a block's
    sum is half 0's plus half 1's, and dw is the blocks' sums added in rank
    order.

    The tensor-core route: ``(kblocks, 2, groups, WG_FLUSH, 8)``: run
    ``kb``'s consumer warpgroup ``wg`` adds flush group after flush group
    (each of ``WG_FLUSH`` k8 steps of 8 pixels, or 2 at the end of a
    chunk's share, its products in a fresh accumulator) into its float32
    sum; -1 where a step's position lies outside the image, is a padding
    step's, or the group, the step or the run's chunk does not exist.  Run
    ``kb`` takes chunks ``kb``, ``kb + kblocks``, ..; a chunk's k8 steps,
    padded to a multiple of 4, go half to warpgroup 0 (the first) and half
    to 1; a run's sum is warpgroup 0's plus warpgroup 1's; dw is the runs'
    sums added as the plan's ``rgroups`` groups of consecutive runs say."""
    if plan["route"] == WGRAD_SMALL:
        rpb, rch, rows = plan["rpb"], plan["rch"], bsz * h
        out = torch.full((plan["cluster"], 2, rpb * w), -1, dtype=torch.int64)
        for k in range(plan["cluster"]):
            halves = [[], []]
            for j0 in range(k * rpb, min(rows, k * rpb + rpb), rch):
                pix = torch.arange(j0 * w, min(rows, j0 + rch, k * rpb + rpb) * w)
                local = torch.arange(len(pix))
                for hf in range(2):
                    halves[hf].append(pix[local // 4 % 2 == hf])
            for hf in range(2):
                got = torch.cat(halves[hf])
                out[k, hf, : len(got)] = got
        return out
    tr, tc, cpb, kblocks = plan["tr"], plan["tc"], plan["cpb"], plan["kblocks"]
    ntx, nty, chunks = plan["ntx"], plan["nty"], plan["chunks"]
    half = _padded_steps(tr * tc // 8) // 2  # k8 steps of a warpgroup a chunk
    gpc = _cdiv(half, _WG_FLUSH)  # flush groups of a warpgroup a chunk
    out = torch.full((kblocks, 2, cpb * gpc, _WG_FLUSH, 8), -1, dtype=torch.int64)
    q = torch.arange(chunks)
    tx, rest = q % ntx, q // ntx
    b, r0, c0 = rest // nty, (rest % nty) * tr, tx * tc
    kb, qi = q % kblocks, q // kblocks
    k = torch.arange(tr * tc)
    r, c = k // tc, k % tc
    y, x = r0[:, None] + r, c0[:, None] + c  # (chunks, tr * tc)
    pix = torch.where((y < h) & (x < w), (b[:, None] * h + y) * w + x, -1)
    step, lane = k // 8, k % 8
    wg, s = step // half, step % half
    grp = qi[:, None] * gpc + s // _WG_FLUSH
    out[kb[:, None], wg, grp, s % _WG_FLUSH, lane] = pix
    return out


# What mg_wgrad3x3_plan reports: these keys, then each route's (the other
# route's are zero).
_PLAN_KEYS = ("route", "blocks", "smem", "sms", "cluster")
_ROUTE_KEYS = {
    WGRAD_TC: ("nsplit", "nb", "tiles", "groups", "nch", "tc", "tr", "stages", "chunks", "cpb", "kblocks",
               "rgroups"),
    WGRAD_SMALL: ("nti", "nto", "rpb", "rch"),
}


def _route_code(route: str | None) -> int:
    return -1 if route is None else WGRAD_ROUTES.index(route)


@functools.lru_cache(maxsize=256)
def _wgrad_kernel_plan(bsz: int, cin: int, cout: int, h: int, w: int, route: str | None, device: int) -> dict:
    fn = _build.load("wgrad3x3").mg_wgrad3x3_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * (len(_PLAN_KEYS) + sum(len(k) for k in _ROUTE_KEYS.values())))()
    with torch.cuda.device(device):
        err = fn(bsz, cin, cout, h, w, _route_code(route), out)
    if err != 0:
        raise ValueError(f"wgrad_kernel_plan: CUDA error {err} for sizes {(bsz, cin, cout, h, w)}")
    vals = list(out)
    plan = dict(zip(_PLAN_KEYS, vals))
    plan["route"] = WGRAD_ROUTES[plan["route"]]
    at = len(_PLAN_KEYS)
    for name, keys in _ROUTE_KEYS.items():
        if name == plan["route"]:
            plan.update(zip(keys, vals[at:]))
        at += len(keys)
    return plan


def wgrad_kernel_plan(bsz: int, cin: int, cout: int, h: int, w: int, device=None,
                      route: str | None = None) -> dict:
    """The weight-gradient kernel's plan as its launcher makes it on a CUDA
    device (the current one by default), on the size rule's route or the
    one named: the keys of :func:`wgrad_plan` that the launcher reports,
    and the device's SM count.  Needs the card."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return dict(_wgrad_kernel_plan(bsz, cin, cout, h, w, route, index))


_WGRAD_ARGS = [_build.PTR] * 4 + [_build.INT] * 6


def weight_grad3x3(x, dpre, w_shape, route: str | None = None):
    """Weight gradient ``(cout, cin, 3, 3)`` of a 3x3 'SAME' conv from its
    input ``x`` ``(B, cin, H, W)`` and the gradient at its output ``dpre``
    ``(B, cout, H, W)``.  On a CUDA tensor the kernel of
    ``csrc/wgrad3x3.cu``, 3xTF32 on the tensor cores summed in a fixed
    order, so the same inputs give the same bits run after run (cuDNN's
    default algorithms do not, and its deterministic ones lose accuracy at
    512x512); on a CPU tensor its plain version; anything else raises.
    ``route`` None takes the size rule's route (:func:`wgrad_route`); a
    route of ``WGRAD_ROUTES`` is forced, for measurements and tests.
    Counts its calls in ``.launches`` (one a call, also where the plan adds
    the runs' partial sums in a second launch)."""
    if x.device.type == "cpu":
        return checked("weight_grad3x3", weight_grad3x3_plain(x, dpre, w_shape))
    if x.device.type != "cuda":
        raise ValueError(f"weight_grad3x3: no kernel for device {x.device}")
    bsz, cin, h, w = x.shape
    cout = w_shape[0]
    if tuple(w_shape) != (cout, cin, 3, 3) or dpre.shape != (bsz, cout, h, w):
        raise ValueError(f"weight_grad3x3: {tuple(x.shape)}, {tuple(dpre.shape)} for weights {tuple(w_shape)}")
    for t in (x, dpre):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"weight_grad3x3: every operand must be float32 on {x.device}")
    x, dpre = x.contiguous(), dpre.contiguous()
    runs = wgrad_kernel_plan(bsz, cin, cout, h, w, x.device, route).get("kblocks", 1)
    part = torch.empty(runs if runs > 1 else 0, cout, cin, 9, device=x.device, dtype=torch.float32)
    dw = torch.empty(cout, cin, 3, 3, device=x.device, dtype=torch.float32)
    _build.kernel("wgrad3x3", "mg_wgrad3x3", _WGRAD_ARGS)(
        x.data_ptr(), dpre.data_ptr(), part.data_ptr(), dw.data_ptr(), bsz, cin, cout, h, w,
        _route_code(route), device=x.device,
    )
    weight_grad3x3.launches += 1
    return checked("weight_grad3x3", dw)


weight_grad3x3.launches = 0


def conv3x3_act_backward(x, w, y, m, g, slope, pixel_norm, eps, needs=(True, True, True)):
    """The hand-written backward of ``conv3x3_act``: ``(dx, dw, db)`` from
    the saved ``x, w, y, m`` and the cotangent ``g``; ``needs`` says which
    of the three to compute (the others are None).  The input gradient goes
    through ``fused_conv3x3``: K1 on a CUDA tensor, its plain version on a
    CPU tensor, which is how the CPU tests check this algebra."""
    if pixel_norm:
        r = torch.rsqrt(m + eps)  # (B, 1, H, W)
        du = r * (g - y * torch.mean(g * y, dim=1, keepdim=True))
    else:
        du = g
    dpre = du if slope is None else du * torch.where(y >= 0, 1.0, slope)
    dx = dw = db = None
    if needs[0]:
        w_t = w.flip(2, 3).transpose(0, 1)  # rot180, in/out swap (OIHW)
        dx = fused_conv3x3(dpre, w_t, None)
    if needs[1]:
        dw = weight_grad3x3(x, dpre, w.shape)
    if needs[2]:
        db = dpre.sum(dim=(0, 2, 3))
    return dx, dw, db


class _Conv3x3Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, slope, pixel_norm, eps):
        if pixel_norm:
            y, m = fused_conv3x3_msq(x, w, b, slope, eps)
        else:
            y, m = fused_conv3x3(x, w, b, slope, False, eps), None
        ctx.slope, ctx.pixel_norm, ctx.eps = slope, pixel_norm, eps
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w, y, m)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, y, m = ctx.saved_tensors
        dx, dw, db = conv3x3_act_backward(
            x, w, y, m, g, ctx.slope, ctx.pixel_norm, ctx.eps, ctx.needs_input_grad[:3]
        )
        return dx, dw, db, None, None, None


def conv3x3_act(x, w, b, slope=0.2, pixel_norm=False, eps=1e-8):
    """3x3 'SAME' conv + bias (+ LeakyReLU) (+ PixelNorm) on NCHW float32
    with OIHW weights, differentiable once in ``(x, w, b)``.  ``b`` may be
    None; ``slope`` None means no LeakyReLU."""
    if x.device.type == "cpu":
        # checked under the name of the kernel the card runs here
        name = "fused_conv3x3_msq" if pixel_norm else "fused_conv3x3"
        return checked(name, conv3x3_act_plain(x, w, b, slope, pixel_norm, eps))
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_act: no kernel for device {x.device}")
    return _Conv3x3Act.apply(x, w, b, slope, pixel_norm, eps)
