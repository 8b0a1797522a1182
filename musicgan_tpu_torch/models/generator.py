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
  kernels once per dtype and layout, not per call.  Heads and the fade-in
  are plain PyTorch in float32 (the heads upcast their input), as they are
  XLA in JAX, so the image is float32 either way.
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
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import conv as conv_ops
from ..ops import conv_bf16
from ..ops import conv_vjp
from . import layers
from .layers import upsample_nearest_2x

_DEFAULT = ModelConfig()
# The names that run the inference kernels and the trainable ones.
INFERENCE_KERNEL_IMPLS = (
    "pallas", "pallas_up", "pallas_block", "pallas_bf16", "pallas_up_bf16", "pallas_block_bf16",
)
TRAIN_KERNEL_IMPLS = ("pallas_train", "pallas_gp")

__all__ = ["Generator", "generator_param_count"]


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
        key = (w.device, w.data_ptr(), w._version)
        hit = self._packs.get((name, dtype, upconv, tc))
        if hit is None or hit[0] != key:
            if tc:
                pack = conv_ops.kernel_weights_tc(w.detach(), upconv)
            elif upconv:
                pack = conv_ops.kernel_upconv_weights(w.detach(), dtype)
            else:
                pack = conv_ops.kernel_weights(w.detach(), dtype)
            hit = self._packs[(name, dtype, upconv, tc)] = (key, pack)
        return hit[1]

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
            # K4 bf16 up to 128 channels reads K1 bf16's and K3 bf16's packs.
            tcb = tc and conv_bf16.block_route(w1.shape[0], w2.shape[0]) == "bf16_tc"
            return conv_ops.fused_block(
                x, w1, self.conv1.bias, w2, self.conv2.bias, slope, eps,
                w1_packed=self._packed("conv1", dt, False, tcb), w2_packed=self._packed("conv2", dt, True, tcb),
            )
        x = conv_ops.fused_conv3x3(
            x, self.conv1.weight, self.conv1.bias, slope, True, eps,
            w_packed=self._packed("conv1", dt, False, tc),
        )
        if not (use_upconv or use_block):
            return conv_ops.fused_conv3x3(
                upsample_nearest_2x(x), self.conv2.weight, self.conv2.bias, slope, True, eps,
                w_packed=self._packed("conv2", dt, False, tc),
            )
        return conv_ops.fused_upconv3x3(
            x, self.conv2.weight, self.conv2.bias, slope, True, eps,
            w_packed=self._packed("conv2", dt, True, tc),
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


class Generator(nn.Module):
    """8 up-blocks + 8 heads (all stages).  Parameters start from
    PyTorch's conv init, ``U(+-1/sqrt(fan_in))`` as in JAX, drawn from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig = _DEFAULT, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            GenBlock(cin, cout, device) for cin, cout in cfg.gen_channels
        )
        self.heads = nn.ModuleList(
            nn.Conv2d(cout, 2, 1, device=device) for _, cout in cfg.gen_channels
        )
        g = torch.Generator(device=self.heads[0].weight.device).manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    bound = 1.0 / (m.in_channels * m.kernel_size[0] * m.kernel_size[1]) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=g)
                    m.bias.uniform_(-bound, bound, generator=g)

    def _head(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """ToMagnPhase head: 1x1 conv + tanh, as a batched ``(2, C) @
        (C, H*W)`` product on the NCHW activation itself (an einsum over
        ``bchw``, or a broadcast matmul, first copies it).  A bf16 input is
        upcast first (JAX's ``_head_nchw``)."""
        h = self.heads[i]
        x = x.to(h.weight.dtype)
        b, c, hh, ww = x.shape
        w = h.weight[:, :, 0, 0].expand(b, -1, -1)
        y = torch.bmm(w, x.reshape(b, c, hh * ww))
        return torch.tanh(y.reshape(b, -1, hh, ww) + h.bias[None, :, None, None])

    def forward_nchw(
        self, z: torch.Tensor, stage: int, alpha=1.0, impl: str | None = None,
        compute_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """``(B, C, h, w)`` latent -> ``(B, 2, h * 2^(stage+1), w *
        2^(stage+1))`` magn/phase image in [-1, 1], float32.  ``impl``
        (default ``self.cfg.conv_impl``) selects the lowering, as in JAX's
        ``generator_forward`` (module docstring); ``"auto"`` here is
        ``"xla"``.  ``compute_dtype`` is the library lowering's (JAX's
        ``compute_dtype`` argument); the kernel impls carry their own."""
        impl = self.cfg.conv_impl if impl is None else impl
        if impl in TRAIN_KERNEL_IMPLS:
            return self.forward_nchw_train(z, stage, alpha)
        if impl in INFERENCE_KERNEL_IMPLS:
            return self._forward_kernels(z, stage, alpha, impl)
        if impl not in ("auto", "xla", "subpixel"):
            raise ValueError(f"unknown conv_impl {impl!r}")
        slope, eps, subpixel = self.cfg.leaky_slope, self.cfg.pixel_norm_eps, impl == "subpixel"

        def head(i, x):  # JAX's ``_head_apply``: a 1x1 conv in the compute dtype
            h = self.heads[i]
            return torch.tanh(layers.conv2d(x, h.weight, h.bias, compute_dtype))

        with layers.library_numerics():
            out = z
            for i in range(stage):
                out = self.blocks[i].forward_library(out, slope, eps, compute_dtype, subpixel)
            out_mp = head(stage, self.blocks[stage].forward_library(out, slope, eps, compute_dtype, subpixel))
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

    def _forward_kernels(self, z: torch.Tensor, stage: int, alpha, impl: str) -> torch.Tensor:
        """The inference kernels.  ``impl`` gives three things, as in JAX's
        ``_generator_forward_nchw``: the blocks' dtype (bf16 for the
        ``_bf16`` names: ``z`` is rounded to it), the up-conv (``pallas_up*``)
        or K1 on the upsampled input (``pallas``, ``pallas_bf16``), and the
        whole-block kernel (``pallas_block*``)."""
        slope, eps = self.cfg.leaky_slope, self.cfg.pixel_norm_eps
        use_block = impl.startswith("pallas_block")
        use_upconv = impl.startswith("pallas_up")
        out = z.to(torch.bfloat16) if impl.endswith("_bf16") else z
        for i in range(stage):
            out = self.blocks[i](out, slope, eps, use_block, use_upconv)
        out_mp = self._head(stage, self.blocks[stage](out, slope, eps, use_block, use_upconv))
        return self._fade(out_mp, out, stage, alpha, self._head)

    def forward_nchw_train(self, z: torch.Tensor, stage: int, alpha) -> torch.Tensor:
        """The differentiable forward of the train step, same shapes as
        :meth:`forward_nchw`.  ``alpha`` may be a tensor on the device: the
        fade term is computed whatever its value, so nothing reads it back."""
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
        compute_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """``z``: ``(B, h, w, rand_channels)`` NHWC, as in JAX's
        ``generator_forward`` -> ``(B, H, W, 2)``.  ``train`` selects the
        differentiable kernel forward; else ``impl`` and ``compute_dtype``
        as in :meth:`forward_nchw`."""
        zn = z.permute(0, 3, 1, 2)
        out = (self.forward_nchw_train(zn, stage, alpha) if train
               else self.forward_nchw(zn, stage, alpha, impl, compute_dtype))
        return out.permute(0, 2, 3, 1)


def generator_param_count(cfg: ModelConfig = _DEFAULT, stage: int | None = None) -> int:
    """Number of parameters *active* at ``stage`` (None = all allocated).

    At stage 7 with the fade head included this equals the reference's
    fully-grown count of 902,132."""

    def conv_n(kh, kw, cin, cout):
        return kh * kw * cin * cout + cout

    total = sum(
        conv_n(3, 3, cin, cin) + conv_n(3, 3, cin, cout)
        for cin, cout in cfg.gen_channels
    )
    if stage is None:
        total += sum(conv_n(1, 1, cout, 2) for _, cout in cfg.gen_channels)
    else:
        total += conv_n(1, 1, cfg.gen_channels[stage][1], 2)
        if stage > 0:
            total += conv_n(1, 1, cfg.gen_channels[stage - 1][1], 2)
    return total
