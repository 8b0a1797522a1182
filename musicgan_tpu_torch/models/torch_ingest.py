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
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..train.optim import AdamState
from .discriminator import Discriminator
from .generator import Generator

__all__ = [
    "load_reference_generator",
    "params_from_jax",
    "disc_params_from_jax",
    "adam_state_from_jax",
    "train_state_from_jax",
    "params_to_jax_layout",
    "adam_state_to_jax_layout",
]


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
    sd = torch.load(path, map_location="cpu", weights_only=True)
    gen = Generator(cfg)
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
    return gen.to(device)


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
