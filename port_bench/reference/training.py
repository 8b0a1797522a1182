"""Plain reference of the WGAN-GP train iteration at a grown stage.

After the reference repository's ``train.py`` and ``networks/``: the
critic (an input head, 1x1 conv and LeakyReLU; blocks of conv3x3,
LeakyReLU, 2x average pool, conv3x3, LeakyReLU; a linear) mirrored by the
generator; during a fade-in the critic adds ``(1 - alpha)`` times the next
head on the pooled input and the generator ``(1 - alpha)`` times the
previous head's image, upsampled.  The real batch is min-max scaled per
sample and channel to [-1, 1].  The critic's loss is the Wasserstein loss
plus 10 times the mean squared distance of the input gradient's norm from 1
at ``eps * real + (1 - eps) * fake``, by double backward; the generator
trains against the updated critic every ``n_critic``-th iteration.  Adam
keeps one step count a leaf that advances only on a nonzero gradient (the
port's and its JAX original's optimizer; a leaf that stays zero never
moves).

Parameters are a dict of float32 tensors with the port's names
(``blocks.i.conv1.weight``, ``heads.i.bias``, ``clf.weight``, ...), so
that leaves compare by name.  Rows are processed ``rows`` at a time and
the gradients summed, so that a full-width batch fits on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["param_shapes", "critic_score", "generator_image", "Adam", "iteration"]


def param_shapes(gen_channels, disc_channels, rand_channels: int) -> tuple[dict, dict]:
    """``(gen, disc)``: name -> shape of every leaf, as the port names them."""
    gen, disc = {}, {}
    for i, (cin, cout) in enumerate(gen_channels):
        gen[f"blocks.{i}.conv1.weight"], gen[f"blocks.{i}.conv1.bias"] = (cin, cin, 3, 3), (cin,)
        gen[f"blocks.{i}.conv2.weight"], gen[f"blocks.{i}.conv2.bias"] = (cout, cin, 3, 3), (cout,)
    for i, (_, cout) in enumerate(gen_channels):
        gen[f"heads.{i}.weight"], gen[f"heads.{i}.bias"] = (2, cout, 1, 1), (2,)
    for i, (cin, cout) in enumerate(disc_channels):
        disc[f"blocks.{i}.conv1.weight"], disc[f"blocks.{i}.conv1.bias"] = (cout, cin, 3, 3), (cout,)
        disc[f"blocks.{i}.conv2.weight"], disc[f"blocks.{i}.conv2.bias"] = (cout, cout, 3, 3), (cout,)
    for i, (cin, _) in enumerate(disc_channels):
        disc[f"heads.{i}.weight"], disc[f"heads.{i}.bias"] = (cin, 2, 1, 1), (cin,)
    disc["clf.weight"], disc["clf.bias"] = (1, disc_channels[-1][1]), (1,)
    assert rand_channels == gen_channels[0][0]
    return gen, disc


def _conv(x, p, name, rounding):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if rounding is not None:
        x, w = rounding(x), rounding(w)
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def _pool(x):
    return F.avg_pool2d(x, 2)


def critic_score(p: dict, x: torch.Tensor, stage: int, alpha: float, slope: float, rounding=None) -> torch.Tensor:
    """``(B, 2, H, W)`` -> ``(B, 1)``; ``stage`` counts down from the
    smallest input (``n - 2`` takes 4x4) to 0 (512x512)."""
    n = sum(1 for k in p if k.endswith(".conv1.weight"))

    def block(i, t):
        t = F.leaky_relu(_conv(t, p, f"blocks.{i}.conv1", rounding), slope)
        return F.leaky_relu(_conv(_pool(t), p, f"blocks.{i}.conv2", rounding), slope)

    out = block(stage, F.leaky_relu(_conv(x, p, f"heads.{stage}", rounding), slope))
    if stage < n - 2:
        old = F.leaky_relu(_conv(_pool(x), p, f"heads.{stage + 1}", rounding), slope)
        out = alpha * out + (1.0 - alpha) * old
    for i in range(stage + 1, n):
        out = block(i, out)
    out = out.reshape(out.shape[0], -1)
    w, b = p["clf.weight"], p["clf.bias"]
    if rounding is not None:
        out, w = rounding(out), rounding(w)
    return F.linear(out, w, b)


def generator_image(p: dict, z: torch.Tensor, stage: int, alpha: float, slope: float, eps: float,
                    rounding=None) -> torch.Tensor:
    """``(B, C, h, w)`` latent -> ``(B, 2, h * 2**(stage + 1), ...)``."""

    def norm(t):
        return t * torch.rsqrt(torch.mean(t * t, dim=1, keepdim=True) + eps)

    def up(t):
        return F.interpolate(t, scale_factor=2, mode="nearest")

    x, prev = z, None
    for i in range(stage + 1):
        prev = x
        x = norm(F.leaky_relu(_conv(x, p, f"blocks.{i}.conv1", rounding), slope))
        x = norm(F.leaky_relu(_conv(up(x), p, f"blocks.{i}.conv2", rounding), slope))
    out = torch.tanh(_conv(x, p, f"heads.{stage}", rounding))
    if stage > 0:
        old = up(torch.tanh(_conv(prev, p, f"heads.{stage - 1}", rounding)))
        out = alpha * out + (1.0 - alpha) * old
    return out


class Adam:
    """Adam with a step count a leaf that advances only when the leaf's
    gradient is nonzero somewhere; a leaf without a gradient only decays
    its moments, and a leaf whose count is 0 does not move."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = {k: 0 for k in params}
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        for k, p in params.items():
            g = grads.get(k)
            self.mu[k].mul_(self.b1)
            self.nu[k].mul_(self.b2)
            if g is not None:
                self.count[k] += int(bool((g != 0).any()))
                self.mu[k].add_(g, alpha=1 - self.b1)
                self.nu[k].addcmul_(g, g, value=1 - self.b2)
            c = self.count[k]
            if c == 0:
                continue
            m_hat = self.mu[k] / (1.0 - self.b1**c)
            v_hat = self.nu[k] / (1.0 - self.b2**c)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def _scaled(x_raw: torch.Tensor) -> torch.Tensor:
    lo, hi = x_raw.amin(dim=(2, 3), keepdim=True), x_raw.amax(dim=(2, 3), keepdim=True)
    return (x_raw - lo) / (hi - lo + 1e-8) * 2.0 - 1.0


def _grads(loss_fn, params: dict, batch: int, rows: int) -> tuple[dict, float]:
    """Gradients (by name; None where the loss does not reach a leaf) and
    value of ``sum over chunks of loss_fn(rows a, b)``, chunk by chunk."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    acc, total = {k: None for k in params}, 0.0
    for a in range(0, batch, rows):
        loss = loss_fn(leaves, a, min(a + rows, batch))
        got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        for k, g in zip(leaves, got):
            if g is not None:
                acc[k] = g if acc[k] is None else acc[k] + g
        total += float(loss.detach())
    return acc, total


def iteration(gen: dict, disc: dict, opt_g: Adam, opt_d: Adam, x_raw: torch.Tensor, noise, stage: int,
              alpha: float, do_g: bool, slope: float, pn_eps: float, gp_weight: float,
              rows: int = 6, rounding=None) -> dict:
    """One iteration, in place on ``gen``, ``disc`` and the optimizers.
    ``noise``: ``(z, eps, zg)``, NHWC latents and ``(B, 1, 1, 1)`` mixing
    weights.  Returns the losses and the gradients as the optimizers got
    them."""
    z, eps, zg = noise
    z, zg = z.permute(0, 3, 1, 2), zg.permute(0, 3, 1, 2)
    batch = x_raw.shape[0]
    disc_stage = sum(1 for k in disc if k.endswith(".conv1.weight")) - 2 - stage
    x_real = _scaled(x_raw)
    with torch.no_grad():
        x_fake = generator_image(gen, z, stage, alpha, slope, pn_eps, rounding)

    def critic_loss(p, a, b):
        out_real = critic_score(p, x_real[a:b], disc_stage, alpha, slope, rounding)
        out_fake = critic_score(p, x_fake[a:b], disc_stage, alpha, slope, rounding)
        x_hat = (eps[a:b] * x_real[a:b] + (1.0 - eps[a:b]) * x_fake[a:b]).requires_grad_(True)
        score = critic_score(p, x_hat, disc_stage, alpha, slope, rounding)
        g = torch.autograd.grad(score.sum(), x_hat, create_graph=True)[0]
        g_norm = torch.sqrt(torch.sum(g.reshape(b - a, -1) ** 2, dim=1) + 1e-12)
        w = (-out_real.sum() + out_fake.sum()) / batch
        return w + gp_weight * torch.sum((g_norm - 1.0) ** 2) / batch

    d_grads, d_loss = _grads(critic_loss, disc, batch, rows)
    opt_d.update(disc, d_grads)
    out = {"critic_loss": d_loss, "disc_grads": d_grads}
    if do_g:
        frozen = {k: v.detach() for k, v in disc.items()}

        def gen_loss(p, a, b):
            x_gen = generator_image(p, zg[a:b], stage, alpha, slope, pn_eps, rounding)
            return -critic_score(frozen, x_gen, disc_stage, alpha, slope, rounding).sum() / batch

        g_grads, g_loss = _grads(gen_loss, gen, batch, rows)
        opt_g.update(gen, g_grads)
        out.update(gen_loss=g_loss, gen_grads=g_grads)
    return out
