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
both packages compute the same thing in the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from .generator import Generator

__all__ = ["load_reference_generator", "params_from_jax"]


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


def params_from_jax(params_np: dict) -> dict[str, torch.Tensor]:
    """JAX generator pytree (numpy leaves: ``{"blocks": [{"conv1": {"w":
    HWIO, "b"}, "conv2": ...}], "heads": [...]}``) -> a
    :class:`Generator` ``state_dict``."""

    def oihw(w):
        return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1))))

    sd = {}
    for i, blk in enumerate(params_np["blocks"]):
        for name in ("conv1", "conv2"):
            sd[f"blocks.{i}.{name}.weight"] = oihw(blk[name]["w"])
            sd[f"blocks.{i}.{name}.bias"] = torch.from_numpy(np.array(blk[name]["b"]))
    for i, head in enumerate(params_np["heads"]):
        sd[f"heads.{i}.weight"] = oihw(head["w"])
        sd[f"heads.{i}.bias"] = torch.from_numpy(np.array(head["b"]))
    return sd
