"""Generator weights in: the reference's ``state_dict`` and the JAX
package's parameter pytree.

``load_reference_generator`` is the counterpart of
``musicgan_tpu/models/torch_ingest.py::load_reference_generator``: a key
map over the reference's name-mangled ``state_dict`` (Generator ``Block``
is ``Sequential(Conv, LeakyReLU, PixelNorm, Upsample, Conv, LeakyReLU,
PixelNorm)``, so its convs sit at indices 0 and 4; ``__end_block`` is the
head of the saved stage and ``__last_end_block.0`` the previous one).
Both sides are OIHW, so no transpose is needed.

``params_from_jax`` carries a JAX pytree across (HWIO -> OIHW), so that
both packages compute the same thing in the tests; ``disc_params_from_jax``,
``adam_state_from_jax`` and ``train_state_from_jax`` do the same for the
critic, the per-leaf Adam state and a whole train state, and
``params_to_jax_layout`` / ``adam_state_to_jax_layout`` go the other way
(numpy out), which is how the tests compare a state after a step.

The export/import half is the counterpart of the same module's
``export_reference_*``, ``load_reference_adam``, ``export_reference_save``
and ``import_reference_run``: a run of the port written as the reference
Saver's four files (``gen_{i}.pt``, ``disc_{i}.pt``, ``optim_gen_{i}.pt``,
``optim_disc_{i}.pt``, reference ``utils.py:118-145``), and such a save
read back into a run directory that ``train --resume`` continues.  The
port's weights and Adam moments are in the reference's layouts already
(conv OIHW, linear ``(out, in)``), so every leaf is carried as a copy: no
layout differs.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..train.optim import AdamState
from .discriminator import Discriminator
from .generator import Generator

__all__ = [
    "load_reference_generator",
    "load_reference_discriminator",
    "export_reference_generator",
    "export_reference_discriminator",
    "export_reference_adam",
    "load_reference_adam",
    "export_reference_save",
    "import_reference_run",
    "params_from_jax",
    "disc_params_from_jax",
    "adam_state_from_jax",
    "train_state_from_jax",
    "params_to_jax_layout",
    "adam_state_to_jax_layout",
]


def _reference_gen_into(gen: Generator, sd: dict, cfg: ModelConfig, stage: int | None) -> int:
    """Load a reference generator ``state_dict`` into ``gen`` (its other
    heads keep their values); returns the stage."""
    own = gen.state_dict()
    for i in range(cfg.n_stages):
        pre = f"_Generator__gen_blocks.{i}"
        if f"{pre}.0.weight" not in sd:
            break
        for ours, theirs in (("conv1", 0), ("conv2", 4)):
            for leaf in ("weight", "bias"):
                own[f"blocks.{i}.{ours}.{leaf}"] = sd[f"{pre}.{theirs}.{leaf}"]

    head_w = sd["_Generator__end_block.0.weight"]
    if stage is None:
        cin = head_w.shape[1]
        stage = next(s for s, (_, cout) in enumerate(cfg.gen_channels) if cout == cin)
    own[f"heads.{stage}.weight"] = head_w
    own[f"heads.{stage}.bias"] = sd["_Generator__end_block.0.bias"]
    if stage > 0 and "_Generator__last_end_block.0.0.weight" in sd:
        for leaf in ("weight", "bias"):
            own[f"heads.{stage - 1}.{leaf}"] = sd[f"_Generator__last_end_block.0.0.{leaf}"]
    gen.load_state_dict(own)
    return stage


def _reference_disc_into(disc: Discriminator, sd: dict, cfg: ModelConfig, layer: int | None) -> int:
    """Load a reference discriminator ``state_dict`` into ``disc``; returns
    the layer (the reference's ``curr_layer``: the block the current input
    head feeds)."""
    own = disc.state_dict()
    for i in range(len(cfg.disc_channels)):
        pre = f"_Discriminator__conv_blocks.{i}"
        if f"{pre}.0.weight" not in sd:
            break
        for ours, theirs in (("conv1", 0), ("conv2", 3)):
            for leaf in ("weight", "bias"):
                own[f"blocks.{i}.{ours}.{leaf}"] = sd[f"{pre}.{theirs}.{leaf}"]

    head_w = sd["_Discriminator__start_block.0.weight"]
    if layer is None:
        cout = head_w.shape[0]
        layer = next(s for s, (cin, _) in enumerate(cfg.disc_channels) if cin == cout)
    own[f"heads.{layer}.weight"] = head_w
    own[f"heads.{layer}.bias"] = sd["_Discriminator__start_block.0.bias"]
    if "_Discriminator__last_start_block.1.0.weight" in sd:
        for leaf in ("weight", "bias"):
            own[f"heads.{layer + 1}.{leaf}"] = sd[f"_Discriminator__last_start_block.1.0.{leaf}"]
    for leaf in ("weight", "bias"):
        own[f"clf.{leaf}"] = sd[f"_Discriminator__clf.0.{leaf}"]
    disc.load_state_dict(own)
    return layer


def load_reference_generator(
    path: str,
    cfg: ModelConfig = ModelConfig(),
    stage: int | None = None,
    device="cpu",
) -> Generator:
    """A :class:`Generator` holding a reference ``gen_*.pt`` state_dict.

    ``stage``: growth stage the checkpoint was saved at (None = infer from
    the ``__end_block`` head's input channels).  Heads of other stages
    keep their seeded init; at ``alpha = 1`` only the ``stage`` head
    reaches the output."""
    gen = Generator(cfg)
    _reference_gen_into(gen, torch.load(path, map_location="cpu", weights_only=True), cfg, stage)
    return gen.to(device)


def load_reference_discriminator(
    path: str,
    cfg: ModelConfig = ModelConfig(),
    layer: int | None = None,
    device="cpu",
) -> Discriminator:
    """A :class:`Discriminator` holding a reference ``disc_*.pt``
    state_dict.  ``layer``: the reference's ``curr_layer`` (None = infer
    from the ``__start_block`` head's output channels); the heads of other
    layers keep their seeded init."""
    disc = Discriminator(cfg)
    _reference_disc_into(disc, torch.load(path, map_location="cpu", weights_only=True), cfg, layer)
    return disc.to(device)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy (``torch.save`` of a view would write its
    whole storage)."""
    return t.detach().cpu().clone(memory_format=torch.contiguous_format)


def export_reference_generator(
    gen: Generator | dict,
    path: str,
    stage: int = 7,
    cfg: ModelConfig = ModelConfig(),
) -> None:
    """Write a generator (a :class:`Generator` or its ``state_dict``) as a
    reference-format ``state_dict`` so reference tooling
    (``generate.py:29-38``) can load models trained here.  Inverse of
    :func:`load_reference_generator`."""
    own = gen.state_dict() if isinstance(gen, torch.nn.Module) else gen
    sd = {}
    for i in range(cfg.n_stages):
        for ours, idx in (("conv1", 0), ("conv2", 4)):
            for leaf in ("weight", "bias"):
                sd[f"_Generator__gen_blocks.{i}.{idx}.{leaf}"] = _host(own[f"blocks.{i}.{ours}.{leaf}"])
    for leaf in ("weight", "bias"):
        sd[f"_Generator__end_block.0.{leaf}"] = _host(own[f"heads.{stage}.{leaf}"])
    if stage > 0:
        for leaf in ("weight", "bias"):
            sd[f"_Generator__last_end_block.0.0.{leaf}"] = _host(own[f"heads.{stage - 1}.{leaf}"])
    torch.save(sd, path)


def export_reference_discriminator(
    disc: Discriminator | dict,
    path: str,
    layer: int = 0,
    cfg: ModelConfig = ModelConfig(),
) -> None:
    """Write a critic as a reference-format ``state_dict`` (``disc_{i}.pt``).
    ``layer`` is the reference's ``curr_layer``: the conv-block index the
    current input head feeds (7 at gen stage 0, 0 fully grown).  Inverse
    of :func:`load_reference_discriminator`."""
    own = disc.state_dict() if isinstance(disc, torch.nn.Module) else disc
    sd = {}
    for i in range(len(cfg.disc_channels)):
        for ours, idx in (("conv1", 0), ("conv2", 3)):
            for leaf in ("weight", "bias"):
                sd[f"_Discriminator__conv_blocks.{i}.{idx}.{leaf}"] = _host(own[f"blocks.{i}.{ours}.{leaf}"])
    for leaf in ("weight", "bias"):
        sd[f"_Discriminator__start_block.0.{leaf}"] = _host(own[f"heads.{layer}.{leaf}"])
    if layer < len(cfg.disc_channels) - 2:
        # grown at least once: the previous head lives behind the AvgPool
        # (reference discriminator.py::next_layer)
        for leaf in ("weight", "bias"):
            sd[f"_Discriminator__last_start_block.1.0.{leaf}"] = _host(own[f"heads.{layer + 1}.{leaf}"])
    for leaf in ("weight", "bias"):
        sd[f"_Discriminator__clf.0.{leaf}"] = _host(own[f"clf.{leaf}"])
    torch.save(sd, path)


# ---------------------------------------------------------------------------
# Optimizer-state interop (reference ``optim_gen_{i}.pt`` /
# ``optim_disc_{i}.pt``: torch.optim.Adam state_dicts).
#
# The reference constructs Adam over the INITIAL module's parameters() and
# calls ``add_param_group`` with each newly-grown head
# (``train.py:64-69,262-272``), so a saved state_dict has one param group
# per growth and torch's ordinal parameter indexing follows module
# registration order.  The port's per-leaf Adam (``train/optim.py``) keeps
# torch-faithful per-leaf step counts, so the mapping is a bijection:
#   torch state[i]["step"]        <-> count leaf  (0-count leaves have no
#                                                  torch entry: never stepped)
#   torch state[i]["exp_avg"]     <-> mu leaf     (same layout: a copy)
#   torch state[i]["exp_avg_sq"]  <-> nu leaf
# ---------------------------------------------------------------------------


def _gen_param_order(stage: int, cfg: ModelConfig):
    """Reference-optimizer ordinal parameter names (the port's) for the
    generator at growth ``stage``, plus the param-group index lists
    ``train.py`` would have built by then.

    Registration order (reference ``generator.py:54-103``): the full
    ``__gen_blocks`` ModuleList is pre-built at construction (all 8
    blocks), then ``__end_block`` (head 0): 34 params in Adam's group 0;
    each ``next_layer`` adds the fresh head as a 2-param group while
    ``__last_end_block`` reuses the previous head's tensors."""
    order = []
    for i in range(cfg.n_stages):
        for conv in ("conv1", "conv2"):
            order += [f"blocks.{i}.{conv}.weight", f"blocks.{i}.{conv}.bias"]
    order += ["heads.0.weight", "heads.0.bias"]
    groups = [list(range(len(order)))]
    for s in range(1, stage + 1):
        groups.append([len(order), len(order) + 1])
        order += [f"heads.{s}.weight", f"heads.{s}.bias"]
    return order, groups


def _disc_param_order(layer: int, cfg: ModelConfig):
    """Same for the discriminator at ``curr_layer == layer``.

    Registration order (reference ``discriminator.py:52-104``): all 9
    ``__conv_blocks``, then ``__start_block`` (head 7: start_layer=7),
    then ``__clf``: 40 params in group 0; growth walks the head index
    DOWN (6, 5, ... 0), 2 params per group."""
    n = len(cfg.disc_channels)
    order = []
    for i in range(n):
        for conv in ("conv1", "conv2"):
            order += [f"blocks.{i}.{conv}.weight", f"blocks.{i}.{conv}.bias"]
    start = n - 2  # reference start_layer = 7
    order += [f"heads.{start}.weight", f"heads.{start}.bias", "clf.weight", "clf.bias"]
    groups = [list(range(len(order)))]
    for h in range(start - 1, layer - 1, -1):
        groups.append([len(order), len(order) + 1])
        order += [f"heads.{h}.weight", f"heads.{h}.bias"]
    return order, groups


def _param_order(which: str, stage: int, cfg: ModelConfig):
    if which == "gen":
        return _gen_param_order(stage, cfg)
    if which == "disc":
        return _disc_param_order(len(cfg.disc_channels) - 2 - stage, cfg)
    raise ValueError(f"which must be 'gen' or 'disc', got {which!r}")


def export_reference_adam(
    opt_state: AdamState,
    path: str,
    which: str,
    stage: int = 7,
    lr: float = 1e-3,
    betas: tuple = (0.0, 0.9),
    eps: float = 1e-8,
    cfg: ModelConfig = ModelConfig(),
) -> None:
    """Write the port's per-leaf Adam state as a reference-format
    ``torch.optim.Adam`` state_dict (``optim_{gen,disc}_{i}.pt``), loadable
    by ``torch.optim.Adam.load_state_dict`` on an optimizer built exactly as
    the reference's ``train.py:64-69,262-272`` builds it.

    ``which``: ``"gen"`` (``stage`` = growth stage 0..7) or ``"disc"``
    (``stage`` = the gen stage; the disc layer is ``7 - stage``).  Leaves
    with a zero step count get no state entry: exactly torch's lazy-init
    behavior for parameters that never received a gradient."""
    order, groups = _param_order(which, stage, cfg)
    state = {}
    for idx, name in enumerate(order):
        c = int(opt_state.count[name])
        if c == 0:
            continue
        state[idx] = {
            "step": torch.tensor(float(c)),
            "exp_avg": _host(opt_state.mu[name]),
            "exp_avg_sq": _host(opt_state.nu[name]),
        }

    # The installed torch version's full param-group key set, from a
    # throwaway Adam, so the export stays loadable across torch versions
    # that add group options.
    probe = torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))], lr=lr, betas=betas, eps=eps)
    defaults = {k: v for k, v in probe.state_dict()["param_groups"][0].items() if k != "params"}
    torch.save(
        {"state": state, "param_groups": [{**defaults, "params": g} for g in groups]},
        path,
    )


def load_reference_adam(
    path: str,
    which: str,
    template: AdamState,
    stage: int | None = None,
    cfg: ModelConfig = ModelConfig(),
) -> tuple[AdamState, int]:
    """Load a reference ``optim_{gen,disc}_{i}.pt`` into the port's per-leaf
    Adam state, in place of ``template``'s leaves (a fresh state: zeros).
    Mapped leaves are filled; unmapped leaves (e.g. heads the reference run
    never grew) stay at count 0 / zero moments, which the update rule treats
    exactly like torch treats state-less params.  ``stage`` (gen growth
    stage) is inferred from the param-group count when None.  The file is
    read with ``weights_only=True``: an Adam state_dict holds tensors,
    numbers, tuples, bools and ``None`` only.  Returns ``(template,
    stage)``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if stage is None:
        stage = len(sd["param_groups"]) - 1
    order, groups = _param_order(which, stage, cfg)
    if [len(g) for g in groups] != [len(g["params"]) for g in sd["param_groups"]]:
        raise ValueError(
            f"param-group shape mismatch for {which} at stage {stage}: "
            f"ours {[len(g) for g in groups]} vs saved "
            f"{[len(g['params']) for g in sd['param_groups']]}"
        )
    # torch enumerates params group by group in insertion order: the same
    # ordinal order `order` was built in.
    flat = [i for g in sd["param_groups"] for i in g["params"]]
    with torch.no_grad():
        for ordinal, torch_idx in enumerate(flat):
            ent = sd["state"].get(torch_idx)
            if ent is None:
                continue  # never stepped: keep zeros / count 0
            name = order[ordinal]
            step = ent["step"]
            step = float(step.item() if torch.is_tensor(step) else step)
            if step != int(step) or not 0 <= step < 2**31:
                raise ValueError(f"{which} Adam step of {name} is {step}, not an int32 count")
            want = template.mu[name].shape
            # Group arity alone can't catch a save from a different
            # ModelConfig whose group sizes coincide: pin each moment to
            # the template leaf.
            if ent["exp_avg"].shape != want or ent["exp_avg_sq"].shape != want:
                raise ValueError(
                    f"{which} Adam moment shape mismatch at {name}: torch gives "
                    f"{tuple(ent['exp_avg'].shape)}/{tuple(ent['exp_avg_sq'].shape)}, "
                    f"the model expects {tuple(want)}: the save likely comes from a "
                    "different ModelConfig"
                )
            template.count[name].fill_(int(step))
            template.mu[name].copy_(ent["exp_avg"])
            template.nu[name].copy_(ent["exp_avg_sq"])
    return template, stage


def export_reference_save(
    state,
    out_dir: str,
    save_idx: int,
    stage: int = 7,
    cfg: ModelConfig = ModelConfig(),
    gen_lr: float = 1e-3,
    disc_lr: float = 1e-3,
    betas: tuple = (0.0, 0.9),
) -> list:
    """Write a COMPLETE reference-format save, the four files the
    reference's Saver emits per save (``utils.py:118-145``):
    ``gen_{i}.pt``, ``disc_{i}.pt``, ``optim_gen_{i}.pt``,
    ``optim_disc_{i}.pt``, from the port's ``TrainState``.  Uses the RAW
    generator weights (not the EMA copy): the optimizer moments pair with
    the weights Adam actually updates, and the reference has no EMA.
    Returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    layer = len(cfg.disc_channels) - 2 - stage
    paths = [
        os.path.join(out_dir, f"{name}_{save_idx}.pt")
        for name in ("gen", "disc", "optim_gen", "optim_disc")
    ]
    export_reference_generator(state.gen, paths[0], stage=stage, cfg=cfg)
    export_reference_discriminator(state.disc, paths[1], layer=layer, cfg=cfg)
    export_reference_adam(state.opt_gen, paths[2], "gen", stage=stage, lr=gen_lr, betas=betas, cfg=cfg)
    export_reference_adam(state.opt_disc, paths[3], "disc", stage=stage, lr=disc_lr, betas=betas, cfg=cfg)
    return paths


def import_reference_run(
    ref_dir: str,
    save_idx: int,
    run_dir: str,
    model_cfg: ModelConfig = ModelConfig(),
    train_cfg: TrainConfig | None = None,
    iter_idx: int | None = None,
    seed: int = 0,
    device=None,
) -> tuple:
    """Turn a reference save directory (the four ``*_{i}.pt`` files) into a
    run directory of the port: ``{run_dir}/checkpoints/save_0`` holding a
    full ``TrainState`` (weights, Adam moments and per-leaf counts) and a
    ``meta.json`` with the train loop's keys (plus ``imported_from`` and
    ``imported_save_idx``), the grower positioned at the start of the
    saved stage's steady phase.  ``train -o run_dir --resume`` then
    CONTINUES the reference's (or the JAX package's exported) run.

    ``iter_idx`` defaults to ``save_idx * 1000`` (the reference saves every
    1000 iterations, ``train.py:111-112``).  ``device``: the state's
    (``cuda`` by default); the random generator saved with it is of that
    device, so resume on the same kind.  Returns ``(state, stage)``.

    Fidelity note: heads older than ``stage - 1`` keep fresh-init WEIGHTS
    (the reference's model state_dict format cannot carry them: its own
    ``next_layer`` orphans them from every module) while their Adam
    MOMENTS do ride along (they stay in the optimizer's param groups, so
    the reference saves them too).  A head below ``stage - 1`` is
    unreachable in any forward.  The EMA, when ``train_cfg`` keeps one,
    starts as a copy of the generator's weights.
    """
    from ..train.checkpoint import CheckpointManager
    from ..train.grower import Grower
    from ..train.step import init_train_state

    train_cfg = train_cfg if train_cfg is not None else TrainConfig()
    # The template carries fresh zero optimizer states and the random
    # generator; the four files overwrite the rest.  The stage comes from
    # the optimizer file's param-group count, and places the heads of both
    # networks (a head's width alone is ambiguous where two stages share
    # it).
    state = init_train_state(seed, model_cfg, train_cfg, device=device)
    path = lambda name: os.path.join(ref_dir, f"{name}_{save_idx}.pt")  # noqa: E731
    _, stage = load_reference_adam(path("optim_gen"), "gen", state.opt_gen, cfg=model_cfg)
    load_reference_adam(path("optim_disc"), "disc", state.opt_disc, stage=stage, cfg=model_cfg)
    load = lambda name: torch.load(path(name), map_location="cpu", weights_only=True)  # noqa: E731
    _reference_gen_into(state.gen, load("gen"), model_cfg, stage)
    _reference_disc_into(state.disc, load("disc"), model_cfg, len(model_cfg.disc_channels) - 2 - stage)
    with torch.no_grad():
        state.iter_idx.fill_(save_idx * 1000 if iter_idx is None else iter_idx)
        if state.gen_ema is not None:
            for k, p in state.gen.named_parameters():
                state.gen_ema[k].copy_(p)

    # Grower counters: start of the stage's steady phase (alpha == 1).  The
    # reference's .pt files carry no counters, so the convention is
    # "resume fully faded-in at the saved stage".
    grower = Grower(
        max_stage=train_cfg.max_stage,
        fadein_lengths=train_cfg.fadein_lengths,
        train_lengths=train_cfg.train_lengths,
    )
    grower.curr_grow = stage
    grower.step_sample_idx = grower.fadein_lengths[stage]
    grower.sample_idx = (grower._cum_train[stage - 1] if stage > 0 else 0) + grower.step_sample_idx

    CheckpointManager(os.path.join(run_dir, "checkpoints")).save(
        0,
        state,
        {
            # the train loop's keys (loop.py ``meta_dict`` and the Saver's),
            # so resume and eval read an imported save as their own
            "grower": grower.state_dict(),
            "epoch": 0,
            "epoch_batch_pos": 0,
            "iter_idx": int(state.iter_idx),
            "run_name": os.path.basename(os.path.abspath(run_dir)),
            "train_cfg": dataclasses.asdict(train_cfg),
            "saver_counter": 0,
            "save_idx": 0,
            "imported_from": os.path.abspath(ref_dir),
            "imported_save_idx": save_idx,
        },
    )
    return state, stage


def _jax_leaves(tree: dict):
    """``(name, leaf, kind)`` for every leaf of a JAX generator or critic
    pytree, ``name`` being the port's ``state_dict`` key."""
    for i, blk in enumerate(tree["blocks"]):
        for conv in ("conv1", "conv2"):
            yield f"blocks.{i}.{conv}.weight", blk[conv]["w"], "conv"
            yield f"blocks.{i}.{conv}.bias", blk[conv]["b"], "bias"
    for i, head in enumerate(tree["heads"]):
        yield f"heads.{i}.weight", head["w"], "conv"
        yield f"heads.{i}.bias", head["b"], "bias"
    if "clf" in tree:
        yield "clf.weight", tree["clf"]["w"], "linear"
        yield "clf.bias", tree["clf"]["b"], "bias"


# JAX layout -> the port's: conv HWIO -> OIHW, linear (cin, cout) -> (cout, cin).
_TO_TORCH = {"conv": (3, 2, 0, 1), "linear": (1, 0)}
_TO_JAX = {"conv": (2, 3, 1, 0), "linear": (1, 0)}


def params_from_jax(params_np: dict, layout: bool = True) -> dict[str, torch.Tensor]:
    """JAX generator or critic pytree (numpy leaves: ``{"blocks": [{"conv1":
    {"w": HWIO, "b"}, "conv2": ...}], "heads": [...]}``, the critic's also
    ``"clf": {"w": (C, 1), "b"}``) -> a :class:`Generator` or
    :class:`Discriminator` ``state_dict``.  ``layout=False`` keeps every
    leaf's shape (the per-leaf Adam counts, which are scalars)."""
    sd = {}
    for name, leaf, kind in _jax_leaves(params_np):
        a = np.asarray(leaf)
        if layout and kind in _TO_TORCH:
            a = np.transpose(a, _TO_TORCH[kind])
        sd[name] = torch.from_numpy(np.array(a))  # a contiguous copy
    return sd


def disc_params_from_jax(params_np: dict) -> dict[str, torch.Tensor]:
    """JAX critic pytree -> a :class:`Discriminator` ``state_dict`` (HWIO ->
    OIHW, ``clf.w (C, 1)`` -> ``(1, C)``)."""
    return params_from_jax(params_np)


def adam_state_from_jax(opt_state, device="cpu") -> AdamState:
    """The JAX package's per-leaf Adam state (``count``, ``mu``, ``nu``
    pytrees shaped like the parameters, numpy leaves) -> the port's."""

    def on(tree, layout):
        return {k: v.to(device) for k, v in params_from_jax(tree, layout).items()}

    return AdamState(
        count=on(opt_state.count, False), mu=on(opt_state.mu, True), nu=on(opt_state.nu, True)
    )


def train_state_from_jax(
    state_np,
    model_cfg: ModelConfig = ModelConfig(),
    train_cfg: TrainConfig = TrainConfig(),
    device="cpu",
):
    """A JAX ``TrainState`` with numpy leaves (``jax.tree_util.tree_map(
    np.asarray, state)``) -> the port's ``TrainState`` on ``device``.  The
    JAX random key has no counterpart: the port's generator is seeded from
    ``train_cfg.seed``."""
    from ..train.step import TrainState

    gen, disc = Generator(model_cfg), Discriminator(model_cfg)
    gen.load_state_dict(params_from_jax(state_np.gen_params))
    disc.load_state_dict(disc_params_from_jax(state_np.disc_params))
    ema = state_np.gen_ema
    return TrainState(
        gen=gen.to(device), disc=disc.to(device),
        opt_gen=adam_state_from_jax(state_np.opt_gen, device),
        opt_disc=adam_state_from_jax(state_np.opt_disc, device),
        rng=torch.Generator(device=device).manual_seed(train_cfg.seed),
        iter_idx=torch.tensor(int(state_np.iter_idx), dtype=torch.int32, device=device),
        gen_ema=None if ema is None else {
            k: v.to(device) for k, v in params_from_jax(ema).items()
        },
    )


def params_to_jax_layout(sd: dict, layout: bool = True) -> dict:
    """The reverse of :func:`params_from_jax`: a ``state_dict`` (or any
    dictionary keyed like one: Adam moments, counts) -> the JAX package's
    nested pytree with numpy leaves."""
    count = lambda prefix: 1 + max(int(k.split(".")[1]) for k in sd if k.startswith(prefix))  # noqa: E731
    tree = {
        "blocks": [{"conv1": {}, "conv2": {}} for _ in range(count("blocks."))],
        "heads": [{} for _ in range(count("heads."))],
    }
    if "clf.weight" in sd:
        tree["clf"] = {}
    for name, t in sd.items():
        *path, leaf = name.split(".")
        a = t.detach().cpu().numpy()
        kind = "bias" if leaf == "bias" else "linear" if path == ["clf"] else "conv"
        if layout and kind in _TO_JAX:
            a = np.transpose(a, _TO_JAX[kind])
        node = tree
        for key in path:
            node = node[int(key)] if key.isdigit() else node[key]
        node["w" if leaf == "weight" else "b"] = np.array(a)  # a contiguous copy
    return tree


def adam_state_to_jax_layout(state: AdamState) -> dict:
    """``{"count", "mu", "nu"}``, each a pytree in the JAX layout."""
    return {
        "count": params_to_jax_layout(state.count, layout=False),
        "mu": params_to_jax_layout(state.mu),
        "nu": params_to_jax_layout(state.nu),
    }
