"""Progressive-growing generator as an ``nn.Module`` (counterpart of
``musicgan_tpu/models/generator.py``, every ``conv_impl`` of its
``generator_forward``).

All 8 blocks and all 8 ToMagnPhase heads exist from construction, as in
JAX, so the parameter set never changes shape.  Internally NCHW; the
public :meth:`Generator.forward` keeps the JAX layout (NHWC latent in,
NHWC image out).  :meth:`Generator.forward_nchw` dispatches on
``conv_impl`` as JAX's ``generator_forward`` does:

* ``"pallas_up"``, ``"pallas_block"``, ``"pallas"`` and their ``_bf16``
  names: the inference kernels.  Each block is ``fused_conv3x3`` (conv1 +
  LeakyReLU + PixelNorm) then ``fused_upconv3x3`` (up2x + conv2 + LeakyReLU
  + PixelNorm): on the card the kernels K1 and K3, on the CPU their plain
  versions.  Under ``"pallas_block"`` a block that ``fused_block_fits`` at
  its sizes and dtype is one launch of ``fused_block`` (K4) instead, as in
  JAX's ``block_nchw`` (on the CPU by an H100's rule: K4's plain version is
  the pair's own); ``"pallas"`` runs K1, a plain nearest up2x, then K1
  again.  The ``_bf16`` impls round the latent to bf16 and run the same
  blocks in bf16 (JAX's ``_generator_forward_nchw`` with
  ``compute_dtype=bfloat16``): the bf16 kernels, float32 inside, a bf16
  activation between them.  Each block packs its conv weights for the
  kernels once per dtype and layout, not per call.  The image is float32
  either way: the fade-in is plain PyTorch in float32, as it is XLA in JAX,
  and so are the heads on a float32 activation; a bf16 one on the card
  takes the head kernel (``ops/head.py``), which reads it once.
* ``"pallas_train"`` and ``"pallas_gp"``: :meth:`Generator.forward_nchw_train`
  (counterpart of ``_generator_forward_nchw_train``): each block is
  ``conv3x3_act`` with PixelNorm (forward kernel K2), a plain 2x upsample
  and ``conv3x3_act`` again, all under the once-differentiable gradient of
  ``ops/conv_vjp.py``, and the fade head is computed at every ``alpha``.
* ``"xla"`` (and ``"auto"``, which the entry points resolve before they get
  here) and ``"subpixel"``: the library lowering, ``F.conv2d`` in the
  ``compute_dtype`` (``models/layers.py``), the heads 1x1 convs, under
  ``layers.library_numerics``; ``"subpixel"`` runs each conv2 on the
  nearest-2x grid as four 2x2 phase convs.  Differentiable twice.

Fade-in (reference ``generator.py:106-126``): at stage s > 0 the output is
``alpha * head_s(block_s(x)) + (1 - alpha) * up2x(head_{s-1}(x))``.

GANSynth's generator (``ModelConfig`` with ``dense_start``, ``n_classes``,
``tail_conv``: Engel et al. 2019, the progressive GAN's ``generator``) runs
on the same blocks.  Its input is dense (:meth:`Generator._dense_input`:
the 1x1 latent joined by the label's one-hot, pixel-normed, a product with
the source's ``(h, w)`` VALID conv kernel, LeakyReLU, PixelNorm; span
``mg.synth.latent``), in float32 whatever the blocks' dtype.  Its blocks
are "up, conv c -> c', conv c' -> c' at each size": regrouped, each
``GenBlock`` is one size's second conv with the next size's up and first
conv, and the last size's second conv is the tail (:class:`TailConv`, K1),
before one head.  Such a generator is grown only: it runs its last stage,
at ``alpha`` 1, and never trains; its weights start at the equalized
learning rate's scale, ``N(0, 2 / fan_in)`` (the head ``1 / fan_in``), zero
biases.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import conv as conv_ops
from ..ops import conv_bf16
from ..ops import conv_vjp
from ..ops import head as head_ops
from ..utils import profiling
from . import layers
from .layers import upsample_nearest_2x

_DEFAULT = ModelConfig()
# The names that run the inference kernels and the trainable ones.
INFERENCE_KERNEL_IMPLS = (
    "pallas", "pallas_up", "pallas_block", "pallas_bf16", "pallas_up_bf16", "pallas_block_bf16",
)
TRAIN_KERNEL_IMPLS = ("pallas_train", "pallas_gp")

__all__ = ["Generator", "GenBlock", "TailConv", "condition", "generator_param_count"]


def _pack(w: torch.Tensor, dtype: torch.dtype, upconv: bool, tc: bool) -> torch.Tensor:
    """The kernels' layout of OIHW ``w``: ``kernel_weights_tc`` (``tc``: the
    bf16 pack of K1 bf16 and K3 bf16), else ``kernel_upconv_weights`` /
    ``kernel_weights`` in ``dtype``."""
    if tc:
        return conv_ops.kernel_weights_tc(w.detach(), upconv)
    if upconv:
        return conv_ops.kernel_upconv_weights(w.detach(), dtype)
    return conv_ops.kernel_weights(w.detach(), dtype)


def _kept(packs: dict, key: tuple, w: torch.Tensor, make) -> torch.Tensor:
    """``make()`` kept in ``packs[key]`` until ``w`` changes (in place,
    which bumps its version, or by a move to other storage)."""
    version = (w.device, w.data_ptr(), w._version)
    hit = packs.get(key)
    if hit is None or hit[0] != version:
        hit = packs[key] = (version, make())
    return hit[1]


def condition(x: torch.Tensor, labels: torch.Tensor | None, n_classes: int) -> torch.Tensor:
    """``(B, C)`` latent -> ``(B, C + n_classes)``: joined by the one-hot of
    ``labels`` (``(B,)`` class indices), float32."""
    if not n_classes:
        return x
    if labels is None or labels.shape != (x.shape[0],):
        raise ValueError(f"a generator of {n_classes} classes takes a label a row, not {labels!r}")
    out = x.new_zeros(x.shape[0], x.shape[1] + n_classes)
    out[:, : x.shape[1]] = x
    return out.scatter_(1, labels.to(x.device, torch.long)[:, None] + x.shape[1], 1.0)


class GenBlock(nn.Module):
    """Conv3x3 -> LeakyReLU -> PixelNorm -> Up2x -> Conv3x3 -> LeakyReLU ->
    PixelNorm (reference ``generator.py:16-39``)."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cin, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(cin, cout, 3, padding=1, device=device)
        self._packs: dict[tuple, tuple] = {}

    def _packed(self, name: str, dtype: torch.dtype = torch.float32, upconv: bool | None = None,
                tc: bool = False) -> torch.Tensor:
        """The kernels' layout of conv ``name``'s weight in ``dtype``
        (``kernel_upconv_weights`` where ``upconv``, by default for
        ``conv2``, else ``kernel_weights``: K1, K3 and K4 read the same;
        ``tc``: ``kernel_weights_tc``, the bf16 pack of K1 bf16 and K3
        bf16), made once and kept until the weight changes (in place, which
        bumps its version, or by a move to other storage).  Each dtype and
        layout has its own entry."""
        upconv = name == "conv2" if upconv is None else upconv
        w = getattr(self, name).weight
        return _kept(self._packs, (name, dtype, upconv, tc), w, lambda: _pack(w, dtype, upconv, tc))

    def forward(
        self, x: torch.Tensor, slope: float, eps: float, use_block: bool = False,
        use_upconv: bool = True,
    ) -> torch.Tensor:
        """Dtype: ``x``'s (float32 or bf16), in and out.  ``use_block``: take
        the whole-block kernel where its size rule
        (``ops.conv.fused_block_fits``) says so; ``use_upconv`` False: conv2
        as K1 on the input upsampled (impl ``"pallas"``)."""
        w1, w2, dt = self.conv1.weight, self.conv2.weight, x.dtype
        tc = dt == torch.bfloat16 and x.device.type == "cuda"  # K1 bf16 and K3 bf16 read their own pack
        if use_block and conv_ops.fused_block_fits(
            w1.shape[1], w1.shape[0], w2.shape[0], size=(x.shape[0], *x.shape[2:]), device=x.device, dtype=dt
        ):
            # K4 bf16 (but its template route) reads K1 bf16's and K3 bf16's packs.
            tcb = tc and conv_bf16.block_route(w1.shape[0], w2.shape[0], w1.shape[1]) != "template"
            return conv_ops.fused_block(
                x, w1, self.conv1.bias, w2, self.conv2.bias, slope, eps,
                w1_packed=self._packed("conv1", dt, False, tcb), w2_packed=self._packed("conv2", dt, True, tcb),
                out_dtype=dt,
            )
        x = conv_ops.fused_conv3x3(
            x, self.conv1.weight, self.conv1.bias, slope, True, eps,
            w_packed=self._packed("conv1", dt, False, tc), out_dtype=dt,
        )
        if not (use_upconv or use_block):
            return conv_ops.fused_conv3x3(
                upsample_nearest_2x(x), self.conv2.weight, self.conv2.bias, slope, True, eps,
                w_packed=self._packed("conv2", dt, False, tc), out_dtype=dt,
            )
        return conv_ops.fused_upconv3x3(
            x, self.conv2.weight, self.conv2.bias, slope, True, eps,
            w_packed=self._packed("conv2", dt, True, tc), out_dtype=dt,
        )

    def forward_train(self, x: torch.Tensor, slope: float, eps: float) -> torch.Tensor:
        x = conv_vjp.conv3x3_act(x, self.conv1.weight, self.conv1.bias, slope, True, eps)
        x = upsample_nearest_2x(x)  # its transpose is a 2x2 sum-pool, left to autograd
        return conv_vjp.conv3x3_act(x, self.conv2.weight, self.conv2.bias, slope, True, eps)

    def forward_library(
        self, x: torch.Tensor, slope: float, eps: float, dtype: torch.dtype, subpixel: bool
    ) -> torch.Tensor:
        """The block in the library lowering (JAX's ``_block_apply``): convs
        in ``dtype``, activations and PixelNorm in float32."""
        x = layers.pixel_norm(layers.leaky_relu(
            layers.conv2d(x, self.conv1.weight, self.conv1.bias, dtype), slope), eps)
        if subpixel:
            x = layers.conv3x3_on_nearest_up2x(x, self.conv2.weight, self.conv2.bias, dtype)
        else:
            x = layers.conv2d(upsample_nearest_2x(x), self.conv2.weight, self.conv2.bias, dtype)
        return layers.pixel_norm(layers.leaky_relu(x, slope), eps)


class TailConv(nn.Module):
    """Conv3x3 -> LeakyReLU -> PixelNorm at one size (GANSynth's last
    conv, after the blocks): K1 in the kernel impls."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1, device=device)
        self._packs: dict[tuple, tuple] = {}

    def forward(self, x: torch.Tensor, slope: float, eps: float) -> torch.Tensor:
        w, dt = self.conv.weight, x.dtype
        tc = dt == torch.bfloat16 and x.device.type == "cuda"
        pack = _kept(self._packs, (dt, tc), w, lambda: _pack(w, dt, False, tc))
        return conv_ops.fused_conv3x3(x, w, self.conv.bias, slope, True, eps, w_packed=pack, out_dtype=dt)

    def forward_library(self, x: torch.Tensor, slope: float, eps: float, dtype: torch.dtype) -> torch.Tensor:
        return layers.pixel_norm(layers.leaky_relu(layers.conv2d(x, self.conv.weight, self.conv.bias, dtype), slope),
                                 eps)


class Generator(nn.Module):
    """8 up-blocks + 8 heads (all stages).  Parameters start from
    PyTorch's conv init, ``U(+-1/sqrt(fan_in))`` as in JAX, drawn from a
    ``torch.Generator`` seeded with ``seed``.  A grown-only config
    (``cfg.grown_only``: GANSynth's) has its dense input, blocks, tail and
    one head instead, drawn at the equalized learning rate's scale."""

    def __init__(self, cfg: ModelConfig = _DEFAULT, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        if cfg.dense_start:
            self.dense = nn.Conv2d(cfg.rand_channels + cfg.n_classes, cfg.gen_channels[0][0], tuple(cfg.dense_start),
                                   device=device)
            self._packs: dict[tuple, tuple] = {}
        self.blocks = nn.ModuleList(
            GenBlock(cin, cout, device) for cin, cout in cfg.gen_channels
        )
        last = cfg.gen_channels[-1][1]
        if cfg.tail_conv:
            self.tail = TailConv(last, device)
        outs = [last] if cfg.grown_only else [cout for _, cout in cfg.gen_channels]
        self.heads = nn.ModuleList(nn.Conv2d(cout, 2, 1, device=device) for cout in outs)
        g = torch.Generator(device=self.heads[0].weight.device).manual_seed(seed)
        heads = set(self.heads)
        with torch.no_grad():
            for m in self.modules():
                if not isinstance(m, nn.Conv2d):
                    continue
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                if cfg.grown_only:  # He: N(0, 2 / fan_in); the head's gain 1
                    m.weight.normal_(0.0, ((1.0 if m in heads else 2.0) / fan_in) ** 0.5, generator=g)
                    m.bias.zero_()
                else:
                    bound = 1.0 / fan_in**0.5
                    m.weight.uniform_(-bound, bound, generator=g)
                    m.bias.uniform_(-bound, bound, generator=g)

    def _check_grown(self, stage: int, alpha, impl: str) -> None:
        cfg = self.cfg
        if cfg.grown_only and (stage != cfg.n_stages - 1 or isinstance(alpha, torch.Tensor) or alpha != 1.0
                               or impl in TRAIN_KERNEL_IMPLS):
            raise ValueError(f"a {cfg.topology} generator runs grown only (stage {cfg.n_stages - 1}, alpha 1, no "
                             f"training impl), not stage {stage}, alpha {alpha}, {impl!r}")

    def _head_index(self, stage: int) -> int:
        return 0 if self.cfg.grown_only else stage

    def _dense_input(self, z: torch.Tensor, labels, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """GANSynth's input layer (span ``mg.synth.latent``): the ``(B, C,
        1, 1)`` latent joined by the one-hot of ``labels`` (:func:`condition`),
        pixel-normed over its ``C + n_classes`` values, the dense layer
        (``dense.weight`` as the source's VALID conv on the input zero-padded
        to ``(2h - 1, 2w - 1)``: ``h[c, i, j] = sum_k W[c, k, h-1-i, w-1-j]
        x[k] + b[c]``, one product in ``compute_dtype``, TF32 off),
        LeakyReLU and PixelNorm -> ``(B, c0, h, w)`` float32."""
        cfg, d = self.cfg, self.dense
        bsz, (h, w), c0 = z.shape[0], cfg.dense_start, d.out_channels
        with profiling.span("mg.synth.latent"):
            x = condition(z.reshape(bsz, -1).to(torch.float32), labels, cfg.n_classes)
            x = x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + cfg.pixel_norm_eps)
            wt = d.weight
            mat = _kept(self._packs, ("dense", compute_dtype), wt,
                        lambda: wt.detach().flip(2, 3).permute(1, 0, 2, 3).reshape(x.shape[1], -1).to(compute_dtype))
            with layers.library_numerics():
                y = (x.to(compute_dtype) @ mat).to(torch.float32)
            y = y.view(bsz, c0, h, w) + d.bias[None, :, None, None]
            return layers.pixel_norm(layers.leaky_relu(y, cfg.leaky_slope), cfg.pixel_norm_eps)

    def _head(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """ToMagnPhase head: 1x1 conv + tanh in float32 (JAX's
        ``_head_nchw``).  A bf16 activation on the card with no gradient
        wanted takes the head kernel (``ops/head.py::head1x1``), one pass;
        every other input its plain version, which upcasts the input."""
        h = self.heads[i]
        w = h.weight[:, :, 0, 0]
        needs_grad = torch.is_grad_enabled() and (x.requires_grad or h.weight.requires_grad or h.bias.requires_grad)
        if head_ops.takes_kernel(x.dtype, x.device.type, needs_grad):
            return head_ops.head1x1(x, w, h.bias)
        return head_ops.head1x1_plain(x, w, h.bias)

    def forward_nchw(
        self, z: torch.Tensor, stage: int, alpha=1.0, impl: str | None = None,
        compute_dtype: torch.dtype = torch.float32, labels: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``(B, C, h, w)`` latent -> ``(B, 2, h * 2^(stage+1), w *
        2^(stage+1))`` magn/phase image in [-1, 1], float32 (a dense input's
        ``(B, C, 1, 1)`` latent and ``labels`` -> ``(B, 2, H, W)`` at
        ``cfg.image_size``).  ``impl``
        (default ``self.cfg.conv_impl``) selects the lowering, as in JAX's
        ``generator_forward`` (module docstring); ``"auto"`` here is
        ``"xla"``.  ``compute_dtype`` is the library lowering's (JAX's
        ``compute_dtype`` argument); the kernel impls carry their own."""
        impl = self.cfg.conv_impl if impl is None else impl
        self._check_grown(stage, alpha, impl)
        if impl in TRAIN_KERNEL_IMPLS:
            return self.forward_nchw_train(z, stage, alpha)
        if impl in INFERENCE_KERNEL_IMPLS:
            return self._forward_kernels(z, stage, alpha, impl, labels)
        if impl not in ("auto", "xla", "subpixel"):
            raise ValueError(f"unknown conv_impl {impl!r}")
        slope, eps, subpixel = self.cfg.leaky_slope, self.cfg.pixel_norm_eps, impl == "subpixel"

        def head(i, x):  # JAX's ``_head_apply``: a 1x1 conv in the compute dtype
            h = self.heads[i]
            return torch.tanh(layers.conv2d(x, h.weight, h.bias, compute_dtype))

        with layers.library_numerics():
            out = self._dense_input(z, labels, compute_dtype) if self.cfg.dense_start else z
            for i in range(stage):
                out = self.blocks[i].forward_library(out, slope, eps, compute_dtype, subpixel)
            x = self.blocks[stage].forward_library(out, slope, eps, compute_dtype, subpixel)
            if self.cfg.tail_conv:
                x = self.tail.forward_library(x, slope, eps, compute_dtype)
            out_mp = head(self._head_index(stage), x)
            return self._fade(out_mp, out, stage, alpha, head)

    @staticmethod
    def _fade(out_mp, out, stage: int, alpha, head) -> torch.Tensor:
        """``alpha * out_mp + (1 - alpha) * up2x(head_{s-1}(out))`` at a
        stage past 0.  At a float ``alpha == 1`` the fade term is exactly
        zero (tanh is finite), so it is not computed: synthesis always runs
        there.  A tensor ``alpha`` is never read back."""
        if stage == 0 or (not isinstance(alpha, torch.Tensor) and alpha == 1.0):
            return out_mp
        old = upsample_nearest_2x(head(stage - 1, out))
        return alpha * out_mp + (1.0 - alpha) * old

    def _forward_kernels(self, z: torch.Tensor, stage: int, alpha, impl: str, labels=None) -> torch.Tensor:
        """The inference kernels.  ``impl`` gives three things, as in JAX's
        ``_generator_forward_nchw``: the blocks' dtype (bf16 for the
        ``_bf16`` names: ``z``, or the dense input's float32 output, is
        rounded to it), the up-conv (``pallas_up*``)
        or K1 on the upsampled input (``pallas``, ``pallas_bf16``), and the
        whole-block kernel (``pallas_block*``)."""
        slope, eps = self.cfg.leaky_slope, self.cfg.pixel_norm_eps
        use_block = impl.startswith("pallas_block")
        use_upconv = impl.startswith("pallas_up")
        out = self._dense_input(z, labels) if self.cfg.dense_start else z
        out = out.to(torch.bfloat16) if impl.endswith("_bf16") else out
        for i in range(stage):
            out = self.blocks[i](out, slope, eps, use_block, use_upconv)
        x = self.blocks[stage](out, slope, eps, use_block, use_upconv)
        if self.cfg.tail_conv:
            x = self.tail(x, slope, eps)
        out_mp = self._head(self._head_index(stage), x)
        return self._fade(out_mp, out, stage, alpha, self._head)

    def forward_nchw_train(self, z: torch.Tensor, stage: int, alpha) -> torch.Tensor:
        """The differentiable forward of the train step, same shapes as
        :meth:`forward_nchw`.  ``alpha`` may be a tensor on the device: the
        fade term is computed whatever its value, so nothing reads it back."""
        self._check_grown(stage, alpha, "pallas_train")
        slope, eps = self.cfg.leaky_slope, self.cfg.pixel_norm_eps
        out = z
        for i in range(stage):
            out = self.blocks[i].forward_train(out, slope, eps)
        out_mp = self._head(stage, self.blocks[stage].forward_train(out, slope, eps))
        if stage > 0:
            old = upsample_nearest_2x(self._head(stage - 1, out))
            out_mp = alpha * out_mp + (1.0 - alpha) * old
        return out_mp

    def forward(
        self, z: torch.Tensor, stage: int, alpha=1.0, train: bool = False, impl: str | None = None,
        compute_dtype: torch.dtype = torch.float32, labels: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``z``: ``(B, h, w, rand_channels)`` NHWC, as in JAX's
        ``generator_forward`` -> ``(B, H, W, 2)``.  ``train`` selects the
        differentiable kernel forward; else ``impl``, ``compute_dtype`` and
        ``labels`` as in :meth:`forward_nchw`."""
        zn = z.permute(0, 3, 1, 2)
        out = (self.forward_nchw_train(zn, stage, alpha) if train
               else self.forward_nchw(zn, stage, alpha, impl, compute_dtype, labels))
        return out.permute(0, 2, 3, 1)


def generator_param_count(cfg: ModelConfig = _DEFAULT, stage: int | None = None) -> int:
    """Number of parameters *active* at ``stage`` (None = all allocated).

    At stage 7 with the fade head included this equals the reference's
    fully-grown count of 902,132.  A grown-only config has one stage and
    one head: GANSynth's published widths give 7,308,802."""

    def conv_n(kh, kw, cin, cout):
        return kh * kw * cin * cout + cout

    total = sum(
        conv_n(3, 3, cin, cin) + conv_n(3, 3, cin, cout)
        for cin, cout in cfg.gen_channels
    )
    if cfg.grown_only:
        if stage not in (None, cfg.n_stages - 1):
            raise ValueError(f"a {cfg.topology} generator has stage {cfg.n_stages - 1} alone, not {stage}")
        last = cfg.gen_channels[-1][1]
        if cfg.dense_start:
            total += conv_n(*cfg.dense_start, cfg.rand_channels + cfg.n_classes, cfg.gen_channels[0][0])
        if cfg.tail_conv:
            total += conv_n(3, 3, last, last)
        return total + conv_n(1, 1, last, 2)
    if stage is None:
        total += sum(conv_n(1, 1, cout, 2) for _, cout in cfg.gen_channels)
    else:
        total += conv_n(1, 1, cfg.gen_channels[stage][1], 2)
        if stage > 0:
            total += conv_n(1, 1, cfg.gen_channels[stage - 1][1], 2)
    return total
