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
(+ optional drift) + gradient penalty -> critic gradients with respect to
critic parameters only -> Adam -> on G iterations the generator trains
against the *updated* critic, then the EMA.

Spans (``utils/profiling.py``): each iteration is one
``mg.train.iteration``; inside it ``mg.train.critic`` (noise to the
critic's gradients), ``mg.train.critic_adam``, and on G iterations
``mg.train.generator`` and ``mg.train.gen_adam`` (Adam and the EMA); each
gradient call is an ``mg.train.backward`` inside its phase.

``ModelConfig.conv_impl`` is resolved when the step is built
(``ops/autotune.py``: "auto" is measured on a real chunk of this step, once
per stage and shape) and selects the lowering, as in JAX:

* ``"pallas_gp"``: every 3x3 conv is a hand-written kernel: K2 forward in
  the generator, K1 forward in the critic and K1 again for every input
  gradient (``ops/conv_vjp.py``), and the penalty's inner input gradient is
  ``critic_input_grad_nchw`` (unrolled by hand from first-order convs);
* ``"pallas_train"``: the same kernels in the first-order contexts, and the
  penalty through ``torch.autograd.grad(create_graph=True)`` of the library
  critic (the kernels' gradient is differentiable once);
* ``"xla"`` / ``"subpixel"``: the library lowerings everywhere, the penalty
  by double backward through them.

``TrainConfig.compute_dtype`` ``"bfloat16"`` runs the library lowerings'
convs and the critic's linear in bf16 (``models/layers.py``);
``"bfloat16_f32gp"`` keeps the penalty's critic in float32.  Parameters,
Adam's moments, the losses and the metrics stay float32 in every dtype.
Every step that runs a library conv does so with TF32 off and under
cuDNN's deterministic algorithms (``layers.library_numerics``), set for the
iteration and restored afterwards, so that a resumed run equals the
uninterrupted one bit for bit whichever impl won.

Unlike JAX's pure step, this one updates the state's modules and optimizer
moments in place and returns the same ``TrainState`` (JAX donates its
buffers to the same end).  Metrics come back as device scalars: nothing in
a step reads the device, so the host can run ahead of it.

Data parallelism (``mesh``: a ``parallel.Group``, one process per card):
every rank holds the whole state and takes its rows ``[r*b, (r+1)*b)`` of
the global batch of ``B = b * world``.  It draws the global batch's noise
from ``state.rng`` and keeps its rows, so the random streams stay in step
and the run is the one-process run's.  The gradients of its local mean are
summed over the ranks in ONE ``all_reduce`` of a flat buffer, then divided
by the world size, before Adam: once for the critic's loss and penalty,
once for the generator's.  (Explicit calls, not ``DistributedDataParallel``,
whose hooks do not compose with the penalty's double backward.)  The
metrics are averaged by one more ``all_reduce``.  Every rank gets the same
bits from each, so the replicated states stay equal bit for bit.  With a
device-resident corpus each rank holds its row range of it
(``parallel.data_sharding``) and a step gathers the rows it owns of the
global index batch into a zero buffer that one batch-sized ``all_reduce``
completes (JAX's lowering of the gather from a sharded corpus).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch

from ..audio.transforms import grower_transform
from ..config import ModelConfig, TrainConfig
from ..device import resolve_device
from ..models.discriminator import Discriminator, critic_input_grad_nchw
from ..models.generator import Generator
from ..models.layers import library_numerics
from ..models.losses import wasserstein_discriminator_loss, wasserstein_generator_loss
from ..parallel.mesh import Group, Mesh, all_reduce_sum
from ..utils import profiling
from .optim import AdamState, adam_per_leaf

__all__ = [
    "TrainState",
    "data_group",
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


def _mean_over_ranks(grads: dict, group: Group) -> dict:
    """The gradients of the global mean from each rank's gradients of its
    local mean: one ``all_reduce`` of them all in a flat buffer, then a
    division by the world size.  A leaf the loss does not reach (None) is
    None on every rank."""
    names = [k for k, g in grads.items() if g is not None]
    flat = all_reduce_sum(torch.cat([grads[k].reshape(-1) for k in names]))
    flat.div_(group.world)
    out, offset = dict(grads), 0
    for k in names:
        n = grads[k].numel()
        out[k] = flat[offset : offset + n].view_as(grads[k])
        offset += n
    return out


def _make_iteration(stage: int, model_cfg: ModelConfig, train_cfg: TrainConfig, pre_scaled: bool, device,
                    group: Optional[Group] = None):
    """The per-iteration core ``iteration(state, x_raw, alpha, do_g, noise)``;
    with ``group``, ``x_raw`` is this rank's rows of the global batch."""
    from ..ops.autotune import SECOND_ORDER_IMPLS, resolve_conv_impl

    # Training differentiates through the generator: resolve conv_impl to a
    # differentiable lowering (the inference-only kernel impls raise).  With
    # train_cfg given, "auto" is measured on a real chunk of this step.
    z_shape = (train_cfg.batch_size, model_cfg.latent_height, model_cfg.latent_width, model_cfg.rand_channels)
    impl = resolve_conv_impl(
        model_cfg, z_shape, stage, for_training=True, train_cfg=train_cfg, device=device
    ).conv_impl
    # The penalty differentiates the critic TWICE; the kernels' gradient is
    # differentiable once, so under "pallas_train" the penalty's critic is
    # the library lowering.
    gp_impl = impl if impl in SECOND_ORDER_IMPLS else "xla"
    # "bfloat16_f32gp": bf16 operands in every forward EXCEPT the penalty's:
    # plain bf16 destabilizes exactly the penalty, which regularizes an
    # INPUT gradient, the quantity operand rounding perturbs most
    # (VALIDATION.md r2).
    dtype = torch.bfloat16 if train_cfg.compute_dtype in ("bfloat16", "bfloat16_f32gp") else torch.float32
    gp_dtype = torch.float32 if train_cfg.compute_dtype == "bfloat16_f32gp" else dtype
    numerics = contextlib.nullcontext if impl == "pallas_gp" else functools.partial(library_numerics, True)
    size = 4 * 2**stage
    disc_stage = len(model_cfg.disc_channels) - 2 - stage  # 7 -> 0
    gp_w, drift, ema_d = train_cfg.grad_penalty_weight, train_cfg.drift_eps, train_cfg.ema_decay
    opt_g, opt_d = make_optimizers(train_cfg)

    def input_grad(disc, x_hat, alpha):
        """The critic's input gradient at the interpolate, itself
        differentiable once more with respect to the critic's parameters."""
        if impl == "pallas_gp":
            return critic_input_grad_nchw(disc, x_hat, disc_stage, alpha)
        x_hat = x_hat.detach().requires_grad_(True)
        score = disc.forward_nchw(x_hat, disc_stage, alpha, gp_impl, gp_dtype)
        return torch.autograd.grad(score.sum(), x_hat, create_graph=True)[0]

    def iteration(state: TrainState, x_raw, alpha, do_g: bool, noise=None):
        with profiling.span("mg.train.iteration"), numerics():
            return _iteration(state, x_raw, alpha, do_g, noise)

    def _iteration(state: TrainState, x_raw, alpha, do_g: bool, noise):
        gen, disc = state.gen, state.disc
        if not isinstance(alpha, torch.Tensor):
            alpha = float(alpha)
        batch = x_raw.shape[0]
        device = x_raw.device
        # ---- critic ------------------------------------------------------
        with profiling.span("mg.train.critic"):
            # The noise is drawn for the global batch: a rank keeps its rows.
            world, rank = (1, 0) if group is None else (group.world, group.rank)
            z_shape = (batch * world, model_cfg.rand_channels, model_cfg.latent_height, model_cfg.latent_width)
            if noise is None:
                # All three draws are made whether or not the generator
                # trains, so that the stream does not depend on the n_critic
                # pattern.
                z = torch.randn(z_shape, generator=state.rng, device=device)
                eps = torch.rand((batch * world, 1, 1, 1), generator=state.rng, device=device)
                zg = torch.randn(z_shape, generator=state.rng, device=device)
            else:  # NHWC latents as the JAX step draws them, for parity tests
                z, eps, zg = noise
                z, zg = z.permute(0, 3, 1, 2), zg.permute(0, 3, 1, 2)
            if group is not None:
                rows = slice(rank * batch, (rank + 1) * batch)
                z, eps, zg = (t[rows].to(device) for t in (z, eps, zg))

            x_real = x_raw.to(torch.float32) if pre_scaled else grower_transform(x_raw, size)
            with torch.no_grad():
                x_fake = gen.forward_nchw(z, stage, alpha, impl, dtype)

            out_real = disc.forward_nchw(x_real, disc_stage, alpha, impl, dtype)
            out_fake = disc.forward_nchw(x_fake, disc_stage, alpha, impl, dtype)
            w_loss = wasserstein_discriminator_loss(out_real, out_fake)
            if drift:  # ProGAN eps-drift: anchors the critic's output scale
                w_loss = w_loss + drift * torch.mean(torch.square(out_real))
            # WGAN-GP: the critic's gradient at a random interpolate has unit norm.
            x_hat = eps * x_real + (1.0 - eps) * x_fake
            g = input_grad(disc, x_hat, alpha)
            g_norm = torch.sqrt(torch.sum(torch.square(g.reshape(batch, -1)), dim=1) + 1e-12)
            gp = gp_w * torch.mean(torch.square(g_norm - 1.0))
            disc_params = _params(disc)
            with profiling.span("mg.train.backward"):
                d_grads = _grads(w_loss + gp, disc_params)
            if group is not None:
                d_grads = _mean_over_ranks(d_grads, group)
        with profiling.span("mg.train.critic_adam"):
            opt_d.update(d_grads, state.opt_disc, disc_params)
        metrics = {
            "disc_loss": w_loss.detach(), "grad_pen": gp.detach(),
            "e_tp": out_real.detach().mean(), "e_tn": out_fake.detach().mean(),
        }

        # ---- generator, against the *updated* critic ---------------------
        if do_g:
            with profiling.span("mg.train.generator"):
                with _frozen(disc):
                    x_gen = gen.forward_nchw(zg, stage, alpha, impl, dtype)
                    out_gen = disc.forward_nchw(x_gen, disc_stage, alpha, impl, dtype)
                    loss = wasserstein_generator_loss(out_gen)
                    gen_params = _params(gen)
                    with profiling.span("mg.train.backward"):
                        g_grads = _grads(loss, gen_params)
                if group is not None:
                    g_grads = _mean_over_ranks(g_grads, group)
            with profiling.span("mg.train.gen_adam"):
                opt_g.update(g_grads, state.opt_gen, gen_params)
                if ema_d > 0:  # EMA over generator UPDATES
                    with torch.no_grad():
                        for k, p in gen_params.items():
                            state.gen_ema[k].mul_(ema_d).add_(p, alpha=1.0 - ema_d)
            metrics.update(gen_loss=loss.detach(), e_gen=out_gen.detach().mean())
        else:
            zero = torch.zeros((), device=device)
            metrics.update(gen_loss=zero, e_gen=zero)
        if group is not None:  # the global batch's means
            keys = list(metrics)
            mean = all_reduce_sum(torch.stack([metrics[k] for k in keys])).div_(group.world)
            metrics = dict(zip(keys, mean.unbind()))
        state.iter_idx += 1
        return state, metrics

    return iteration


def data_group(mesh) -> Optional[Group]:
    """The process group a train step's collectives run over: ``mesh`` is
    None (one process) or a ``parallel.Group``.  Training is data parallel
    over processes, one a card, so a ``parallel.Mesh`` of devices in this
    process is refused."""
    if mesh is None or isinstance(mesh, Group):
        return mesh
    if isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"a Mesh of {mesh.size} devices in one process: training runs one process per card; "
            "launch one process a card with train --coordinator HOST:PORT --num-processes N "
            "--process-id I (parallel.initialize_distributed), and train(mesh='auto') takes their group"
        )
    raise TypeError(f"mesh must be None or a parallel.Group, got {mesh!r}")


def _no_pre_scaled(pre_scaled: bool) -> None:
    if pre_scaled:
        raise ValueError("device_data implies the on-device input pipeline: pre_scaled must be False")


def _gather(data: torch.Tensor, idx) -> torch.Tensor:
    """Rows ``idx`` of a device-resident corpus, upcast to float32 (the
    corpus may be stored in bfloat16; compute always runs in float32)."""
    idx = torch.as_tensor(idx, device=data.device)
    return data.index_select(0, idx).to(torch.float32)


def _gather_sharded(data: torch.Tensor, idx, group: Group) -> torch.Tensor:
    """This rank's rows of the global batch ``idx`` (``(B,)`` row indices
    into the whole corpus) when each rank holds one row range of it:
    ``data`` is this rank's range, rows ``[rank * n, (rank + 1) * n)``.
    Each rank writes the rows it owns into a zero ``(B, ...)`` buffer, one
    ``all_reduce`` sums the buffers (every row comes from exactly one rank,
    so the sum is exact), and the rank keeps rows ``[rank * b, (rank + 1) *
    b)``."""
    idx = np.asarray(torch.as_tensor(idx).cpu())
    per, b = data.shape[0], len(idx) // group.world
    lo = group.rank * per
    buf = torch.zeros((len(idx), *data.shape[1:]), dtype=torch.float32, device=data.device)
    mine = np.nonzero((idx >= lo) & (idx < lo + per))[0]
    if len(mine):
        rows = torch.as_tensor(idx[mine] - lo, device=data.device)
        buf[torch.as_tensor(mine, device=data.device)] = data.index_select(0, rows).to(torch.float32)
    return all_reduce_sum(buf)[group.rank * b : (group.rank + 1) * b]


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
    device=None,
):
    """One iteration at ``stage``.  Returns ``step(state, x_raw, alpha,
    noise=None) -> (state, metrics)``; ``x_raw`` is ``(B, 2, H, W)`` float32
    on the state's device (full-res, or stage-res when ``pre_scaled``),
    ``alpha`` the fade-in scalar (a float or a device tensor).  With
    ``device_data`` the step is ``step(state, data, idx, alpha, noise=None)``
    and gathers the batch by row index from a device-resident corpus.

    ``noise``: optional ``(z, eps, zg)`` (NHWC latents, ``eps`` of shape
    ``(B, 1, 1, 1)``) in place of the draws from ``state.rng``, so that
    tests can give both packages the same numbers.

    ``device``: where the state lives, for ``conv_impl="auto"``'s
    resolution (the card by default, as JAX's default backend; on a CPU
    device "auto" is "xla").

    ``mesh``: a ``parallel.Group`` makes the step data parallel over the
    process group (module docstring; ``data_axis`` names its axis, as in
    JAX): ``x_raw`` is then this rank's ``B / world`` rows of the global
    batch, ``noise`` the global batch's, and with ``device_data`` ``data``
    is this rank's row range of the corpus (``parallel.data_sharding``) and
    ``idx`` the global ``(B,)`` index batch.  The metrics are the global
    batch's on every rank."""
    group = data_group(mesh)
    iteration = _make_iteration(stage, model_cfg, train_cfg, pre_scaled, device, group)
    gather = _gather if group is None else functools.partial(_gather_sharded, group=group)

    if device_data:
        _no_pre_scaled(pre_scaled)

        def step_dev(state, data, idx, alpha, noise=None):
            return iteration(state, gather(data, idx), alpha, bool(with_gen), noise)

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
    device=None,
):
    """K iterations per call: ``chunk_step(state, x_stack, alphas, gen_mask,
    noise=None) -> (state, metrics_stack)``.

    ``x_stack``: ``(K, B, 2, H, W)``; ``alphas``: ``(K,)`` fade-in per
    iteration; ``gen_mask``: ``(K,)`` bools on the host, True where the
    generator updates (the n_critic pattern).  With ``device_data`` it is
    ``chunk_step(state, data, idx_stack, alphas, gen_mask, noise=None)``
    with ``idx_stack`` of shape ``(K, B)``.  Metrics come back stacked
    ``(K,)`` per key.  ``noise``: optional sequence of K ``(z, eps, zg)``.
    Bit-identical to ``chunk`` single steps.  ``device`` and ``mesh`` as in
    :func:`build_step` (``idx_stack`` then holds global index batches)."""
    group = data_group(mesh)
    iteration = _make_iteration(stage, model_cfg, train_cfg, pre_scaled, device, group)
    gather = _gather if group is None else functools.partial(_gather_sharded, group=group)
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
            return run(state, lambda k: gather(data, idx_stack[k]), len(idx_stack), alphas, gen_mask, noise)

        return chunk_step_dev

    def chunk_step(state, x_stack, alphas, gen_mask, noise=None):
        return run(state, lambda k: x_stack[k], x_stack.shape[0], alphas, gen_mask, noise)

    return chunk_step
