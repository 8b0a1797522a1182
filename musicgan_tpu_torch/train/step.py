"""WGAN-GP train steps (counterpart of ``musicgan_tpu/train/step.py``).

* ``build_step``       -- one iteration per call, two variants per stage
  (critic-only, and critic + generator for every ``n_critic``-th iteration,
  a schedule decided on the host);
* ``build_chunk_step`` -- K iterations per call, the generator update of
  each chosen by a host-computed mask.  It is a plain loop, so a chunk of K
  gives bit-identical state to K single steps; a CUDA graph of the chunk is
  later work.

An iteration: per-stage input pipeline (min-max -> [-1, 1] -> resize) ->
G forward without gradient -> D on real and fake -> Wasserstein loss
(+ optional drift) + gradient penalty, whose inner input gradient is
``critic_input_grad_nchw_train`` (unrolled by hand from first-order convs)
-> critic gradients with respect to critic parameters only -> Adam -> on G
iterations the generator trains against the *updated* critic, then the EMA.
On the card every 3x3 conv of it is a hand-written kernel: K2 forward in the
generator, K1 forward in the critic and K1 again for every input gradient
(``ops/conv_vjp.py``).

Unlike JAX's pure step, this one updates the state's modules and optimizer
moments in place and returns the same ``TrainState`` (JAX donates its
buffers to the same end).  Metrics come back as device scalars: nothing in
a step reads the device, so the host can run ahead of it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
from typing import Any, Optional

import torch

from ..audio.transforms import grower_transform
from ..config import ModelConfig, TrainConfig
from ..device import resolve_device
from ..models.discriminator import Discriminator, critic_input_grad_nchw
from ..models.generator import Generator
from ..models.losses import wasserstein_discriminator_loss, wasserstein_generator_loss
from .optim import AdamState, adam_per_leaf

__all__ = [
    "TrainState",
    "init_train_state",
    "make_optimizers",
    "build_step",
    "build_chunk_step",
]


@dataclasses.dataclass
class TrainState:
    """Whole-run training state.  Every per-stage head exists from the
    start, so it never changes structure at growth boundaries."""

    gen: Generator
    disc: Discriminator
    opt_gen: AdamState
    opt_disc: AdamState
    rng: torch.Generator       # on the state's device; draws z, eps, zg
    iter_idx: torch.Tensor     # int32 scalar on the device
    gen_ema: Optional[dict] = None  # name -> tensor (ema_decay > 0), else None

    def clone(self) -> "TrainState":
        """A deep copy, the random generator's state included."""
        rng = torch.Generator(device=self.rng.device)
        rng.set_state(self.rng.get_state())
        return TrainState(
            gen=copy.deepcopy(self.gen), disc=copy.deepcopy(self.disc),
            opt_gen=_tree_clone(self.opt_gen), opt_disc=_tree_clone(self.opt_disc),
            rng=rng, iter_idx=self.iter_idx.clone(),
            gen_ema=None if self.gen_ema is None else _tree_clone(self.gen_ema),
        )


def _tree_clone(tree: Any):
    if isinstance(tree, AdamState):
        return AdamState(*(_tree_clone(t) for t in tree))
    return {k: v.clone() for k, v in tree.items()}


def _params(module: torch.nn.Module) -> dict:
    return dict(module.named_parameters())


def make_optimizers(cfg: TrainConfig):
    """``(opt_gen, opt_disc)``: Adam with per-leaf step counts
    (``train/optim.py``), so a head that becomes active at a growth boundary
    starts from fresh bias correction."""
    b1, b2 = cfg.betas
    return adam_per_leaf(cfg.gen_lr, b1=b1, b2=b2), adam_per_leaf(cfg.disc_lr, b1=b1, b2=b2)


def init_train_state(
    seed: int = 0,
    model_cfg: ModelConfig = ModelConfig(),
    train_cfg: TrainConfig = TrainConfig(),
    device: str | torch.device | None = None,
) -> TrainState:
    """The full run state from ``seed``, on ``device`` (``cuda`` by default;
    raises without a GPU unless ``device="cpu"``)."""
    device = resolve_device(device)
    gen = Generator(model_cfg, device=device, seed=seed)
    disc = Discriminator(model_cfg, device=device, seed=seed + 1)
    opt_g, opt_d = make_optimizers(train_cfg)
    return TrainState(
        gen=gen, disc=disc,
        opt_gen=opt_g.init(_params(gen)), opt_disc=opt_d.init(_params(disc)),
        rng=torch.Generator(device=device).manual_seed(seed + 2),
        iter_idx=torch.zeros((), dtype=torch.int32, device=device),
        gen_ema=(
            {k: p.detach().clone() for k, p in _params(gen).items()}
            if train_cfg.ema_decay > 0 else None
        ),
    )


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """``module``'s parameters take no gradient inside: a backward through
    it then computes input gradients only (no weight gradient is made just
    to be dropped)."""
    params = list(module.parameters())
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _grads(loss: torch.Tensor, params: dict) -> dict:
    """Gradients of ``loss`` by name; None for a parameter it does not reach
    (heads and blocks of other stages)."""
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return dict(zip(params, got))


def _make_iteration(stage: int, model_cfg: ModelConfig, train_cfg: TrainConfig, pre_scaled: bool):
    """The per-iteration core ``iteration(state, x_raw, alpha, do_g, noise)``."""
    size = 4 * 2**stage
    disc_stage = len(model_cfg.disc_channels) - 2 - stage  # 7 -> 0
    gp_w, drift, ema_d = train_cfg.grad_penalty_weight, train_cfg.drift_eps, train_cfg.ema_decay
    opt_g, opt_d = make_optimizers(train_cfg)

    def iteration(state: TrainState, x_raw, alpha, do_g: bool, noise=None):
        gen, disc = state.gen, state.disc
        if not isinstance(alpha, torch.Tensor):
            alpha = float(alpha)
        batch = x_raw.shape[0]
        device = x_raw.device
        z_shape = (batch, model_cfg.rand_channels, model_cfg.latent_height, model_cfg.latent_width)
        if noise is None:
            # All three draws are made whether or not the generator trains,
            # so that the stream does not depend on the n_critic pattern.
            z = torch.randn(z_shape, generator=state.rng, device=device)
            eps = torch.rand((batch, 1, 1, 1), generator=state.rng, device=device)
            zg = torch.randn(z_shape, generator=state.rng, device=device)
        else:  # NHWC latents as the JAX step draws them, for parity tests
            z, eps, zg = noise
            z, zg = z.permute(0, 3, 1, 2), zg.permute(0, 3, 1, 2)

        x_real = x_raw.to(torch.float32) if pre_scaled else grower_transform(x_raw, size)
        with torch.no_grad():
            x_fake = gen.forward_nchw_train(z, stage, alpha)

        # ---- critic ------------------------------------------------------
        out_real = disc.forward_nchw(x_real, disc_stage, alpha)
        out_fake = disc.forward_nchw(x_fake, disc_stage, alpha)
        w_loss = wasserstein_discriminator_loss(out_real, out_fake)
        if drift:  # ProGAN eps-drift: anchors the critic's output scale
            w_loss = w_loss + drift * torch.mean(torch.square(out_real))
        # WGAN-GP: the critic's gradient at a random interpolate has unit norm.
        x_hat = eps * x_real + (1.0 - eps) * x_fake
        g = critic_input_grad_nchw(disc, x_hat, disc_stage, alpha)
        g_norm = torch.sqrt(torch.sum(torch.square(g.reshape(batch, -1)), dim=1) + 1e-12)
        gp = gp_w * torch.mean(torch.square(g_norm - 1.0))
        disc_params = _params(disc)
        d_grads = _grads(w_loss + gp, disc_params)
        opt_d.update(d_grads, state.opt_disc, disc_params)
        metrics = {
            "disc_loss": w_loss.detach(), "grad_pen": gp.detach(),
            "e_tp": out_real.detach().mean(), "e_tn": out_fake.detach().mean(),
        }

        # ---- generator, against the *updated* critic ---------------------
        if do_g:
            with _frozen(disc):
                out_gen = disc.forward_nchw(gen.forward_nchw_train(zg, stage, alpha), disc_stage, alpha)
                loss = wasserstein_generator_loss(out_gen)
                gen_params = _params(gen)
                g_grads = _grads(loss, gen_params)
            opt_g.update(g_grads, state.opt_gen, gen_params)
            if ema_d > 0:  # EMA over generator UPDATES
                with torch.no_grad():
                    for k, p in gen_params.items():
                        state.gen_ema[k].mul_(ema_d).add_(p, alpha=1.0 - ema_d)
            metrics.update(gen_loss=loss.detach(), e_gen=out_gen.detach().mean())
        else:
            zero = torch.zeros((), device=device)
            metrics.update(gen_loss=zero, e_gen=zero)
        state.iter_idx += 1
        return state, metrics

    return iteration


def _no_mesh(mesh, data_axis) -> None:
    if mesh is not None or data_axis is not None:
        raise NotImplementedError(
            "mesh / data_axis: data-parallel training is not ported yet "
            "(ROADMAP.md section A item 16)"
        )


def _no_pre_scaled(pre_scaled: bool) -> None:
    if pre_scaled:
        raise ValueError("device_data implies the on-device input pipeline: pre_scaled must be False")


def _gather(data: torch.Tensor, idx) -> torch.Tensor:
    """Rows ``idx`` of a device-resident corpus, upcast to float32 (the
    corpus may be stored in bfloat16; compute always runs in float32)."""
    idx = torch.as_tensor(idx, device=data.device)
    return data.index_select(0, idx).to(torch.float32)


@functools.lru_cache(maxsize=None)
def build_step(
    stage: int,
    with_gen: bool,
    model_cfg: ModelConfig = ModelConfig(),
    train_cfg: TrainConfig = TrainConfig(),
    mesh=None,
    data_axis: str | None = None,
    pre_scaled: bool = False,
    device_data: bool = False,
):
    """One iteration at ``stage``.  Returns ``step(state, x_raw, alpha,
    noise=None) -> (state, metrics)``; ``x_raw`` is ``(B, 2, H, W)`` float32
    on the state's device (full-res, or stage-res when ``pre_scaled``),
    ``alpha`` the fade-in scalar (a float or a device tensor).  With
    ``device_data`` the step is ``step(state, data, idx, alpha, noise=None)``
    and gathers the batch by row index from a device-resident corpus.

    ``noise``: optional ``(z, eps, zg)`` (NHWC latents, ``eps`` of shape
    ``(B, 1, 1, 1)``) in place of the draws from ``state.rng``, so that
    tests can give both packages the same numbers."""
    _no_mesh(mesh, data_axis)
    iteration = _make_iteration(stage, model_cfg, train_cfg, pre_scaled)

    if device_data:
        _no_pre_scaled(pre_scaled)

        def step_dev(state, data, idx, alpha, noise=None):
            return iteration(state, _gather(data, idx), alpha, bool(with_gen), noise)

        return step_dev

    def step(state, x_raw, alpha, noise=None):
        return iteration(state, x_raw, alpha, bool(with_gen), noise)

    return step


@functools.lru_cache(maxsize=None)
def build_chunk_step(
    stage: int,
    chunk: int,
    model_cfg: ModelConfig = ModelConfig(),
    train_cfg: TrainConfig = TrainConfig(),
    mesh=None,
    data_axis: str | None = None,
    pre_scaled: bool = False,
    device_data: bool = False,
):
    """K iterations per call: ``chunk_step(state, x_stack, alphas, gen_mask,
    noise=None) -> (state, metrics_stack)``.

    ``x_stack``: ``(K, B, 2, H, W)``; ``alphas``: ``(K,)`` fade-in per
    iteration; ``gen_mask``: ``(K,)`` bools on the host, True where the
    generator updates (the n_critic pattern).  With ``device_data`` it is
    ``chunk_step(state, data, idx_stack, alphas, gen_mask, noise=None)``
    with ``idx_stack`` of shape ``(K, B)``.  Metrics come back stacked
    ``(K,)`` per key.  ``noise``: optional sequence of K ``(z, eps, zg)``.
    Bit-identical to ``chunk`` single steps."""
    _no_mesh(mesh, data_axis)
    iteration = _make_iteration(stage, model_cfg, train_cfg, pre_scaled)
    if device_data:
        _no_pre_scaled(pre_scaled)

    def run(state, batch_of, n, alphas, gen_mask, noise):
        if n != chunk:
            raise ValueError(f"the stack carries {n} iterations, the chunk step was built for {chunk}")
        rows = []
        for k in range(chunk):
            state, m = iteration(
                state, batch_of(k), alphas[k], bool(gen_mask[k]),
                None if noise is None else noise[k],
            )
            rows.append(m)
        return state, {key: torch.stack([m[key] for m in rows]) for key in rows[0]}

    if device_data:

        def chunk_step_dev(state, data, idx_stack, alphas, gen_mask, noise=None):
            return run(state, lambda k: _gather(data, idx_stack[k]), len(idx_stack), alphas, gen_mask, noise)

        return chunk_step_dev

    def chunk_step(state, x_stack, alphas, gen_mask, noise=None):
        return run(state, lambda k: x_stack[k], x_stack.shape[0], alphas, gen_mask, noise)

    return chunk_step
