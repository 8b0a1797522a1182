"""Full train-state checkpointing WITH resume (counterpart of
``musicgan_tpu/train/checkpoint.py``).

A checkpoint is the complete run state: both networks' parameters, both
optimizers' moments and per-leaf counts, the random generator's state, the
iteration index and the generator EMA when the run carries one, in one
file, plus the host-side counters (grower, epoch cursor, saver) in a JSON
sidecar, so that ``resume`` continues bit-where-it-left-off.

Layout: ``{root}/save_{k}/state.pt`` and ``{root}/save_{k}/meta.json``.
``state.pt`` is one ``torch.save`` of plain tensors, numbers and strings
(it loads with ``weights_only=True``), every tensor on the CPU.
``meta.json`` holds the keys the JAX package's sidecar holds and is written
last: its presence marks the save complete.  The JAX package's own saves
(``save_{k}/state`` as an orbax directory) are a different format and are
not read here.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

from .optim import AdamState
from .step import TrainState

__all__ = ["CheckpointManager", "resolve_checkpoint"]

_STEP_RE = re.compile(r"^save_(\d+)$")
STATE_NAME = "state.pt"


def resolve_checkpoint(ckpt: str) -> tuple[str, int]:
    """``(checkpoints_root, save_idx)`` from any of the checkpoint-path
    spellings the CLI accepts: a specific ``.../save_N`` dir, a
    ``.../checkpoints`` dir, or a run dir containing ``checkpoints/``
    (latest save in the latter two)."""
    ckpt = os.path.normpath(ckpt)  # tolerate trailing slashes
    m = _STEP_RE.match(os.path.basename(ckpt))
    if m:
        return os.path.dirname(ckpt), int(m.group(1))
    root = ckpt
    if os.path.isdir(os.path.join(ckpt, "checkpoints")):
        root = os.path.join(ckpt, "checkpoints")
    if not os.path.isdir(root):
        # constructing CheckpointManager would mkdir a typo'd path
        raise FileNotFoundError(f"checkpoint path does not exist: {root}")
    save_idx = CheckpointManager(root).latest()
    if save_idx is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    return root, save_idx


def _cpu(tree: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tree.items()}


def _adam_payload(opt: AdamState) -> dict:
    return {"count": _cpu(opt.count), "mu": _cpu(opt.mu), "nu": _cpu(opt.nu)}


def _load_tree(dst: dict, src: dict, what: str) -> None:
    """Copy ``src`` into the tensors of ``dst`` in place."""
    if set(dst) != set(src):
        raise ValueError(
            f"checkpoint {what}: leaves differ: "
            f"{sorted(set(dst) ^ set(src))[:6]}"
        )
    with torch.no_grad():
        for k, v in dst.items():
            if v.shape != src[k].shape:
                raise ValueError(
                    f"checkpoint {what}.{k}: shape {tuple(src[k].shape)} "
                    f"!= {tuple(v.shape)}"
                )
            v.copy_(src[k])


class CheckpointManager:
    def __init__(self, root: str):
        os.makedirs(root, exist_ok=True)
        self.root = os.path.abspath(root)

    def _dir(self, save_idx: int) -> str:
        return os.path.join(self.root, f"save_{save_idx}")

    def save(self, save_idx: int, state: TrainState, meta: dict) -> str:
        """Write ``state`` and then ``meta``.  The tensors are copied to
        the host one network at a time; nothing but the state is held (the
        device-resident corpus is no part of it)."""
        d = self._dir(save_idx)
        os.makedirs(d, exist_ok=True)
        payload = {
            "gen": _cpu(state.gen.state_dict()),
            "disc": _cpu(state.disc.state_dict()),
            "opt_gen": _adam_payload(state.opt_gen),
            "opt_disc": _adam_payload(state.opt_disc),
            # A generator's state is a CPU byte tensor whatever its device;
            # the device's type is kept beside it because the two kinds of
            # generator do not take each other's state.
            "rng_state": state.rng.get_state().clone(),
            "rng_device": state.rng.device.type,
            "iter_idx": state.iter_idx.detach().cpu(),
        }
        if state.gen_ema is not None:
            payload["gen_ema"] = _cpu(state.gen_ema)
        path = os.path.join(d, STATE_NAME)
        # Overwriting an index starts by making the old save incomplete.
        meta_path = os.path.join(d, "meta.json")
        if os.path.exists(meta_path):
            os.remove(meta_path)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        # record the saved STRUCTURE so restore can shape its result
        meta = {**meta, "has_ema": state.gen_ema is not None}
        with open(meta_path + ".tmp", "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(meta_path + ".tmp", meta_path)
        return d

    def saved_indices(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.isfile(os.path.join(self.root, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        idx = self.saved_indices()
        return idx[-1] if idx else None

    def restore(
        self, save_idx: int, template: TrainState, load_rng: bool = True
    ) -> tuple[TrainState, dict]:
        """Load save ``save_idx`` INTO ``template``'s modules, moments,
        random generator and ``iter_idx``, in place (an in-place copy bumps
        each weight's version, so a ``GenBlock`` packs it anew), and return
        ``(template, meta)``.

        The EMA follows the saved structure and the template's: an EMA-on
        template restoring an EMA-less save gets an EMA seeded from the
        restored live weights; an EMA-off template restoring an
        EMA-carrying save still gets the saved EMA (``generate`` loading a
        run trained with ``ema_decay > 0``).

        ``load_rng=False`` leaves the template's random generator alone: a
        caller that only wants the weights (``generate``) may then read a
        save made on the card from the CPU, whose generator cannot take the
        card's state."""
        d = self._dir(save_idx)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        path = os.path.join(d, STATE_NAME)
        if not os.path.isfile(path):
            if os.path.isdir(os.path.join(d, "state")):
                raise NotImplementedError(
                    f"{d} is a musicgan_tpu (orbax) checkpoint; musicgan_tpu_torch "
                    "reads its own saves and reference gen_*.pt files: convert "
                    "with `python -m musicgan_tpu export CKPT -o gen.pt`"
                )
            raise FileNotFoundError(path)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        device = template.iter_idx.device

        template.gen.load_state_dict(payload["gen"])
        template.disc.load_state_dict(payload["disc"])
        for name, opt in (("opt_gen", template.opt_gen), ("opt_disc", template.opt_disc)):
            for field in AdamState._fields:
                _load_tree(getattr(opt, field), payload[name][field], f"{name}.{field}")
        if load_rng:
            if payload["rng_device"] != template.rng.device.type:
                raise ValueError(
                    f"{d} was saved with a {payload['rng_device']} random generator "
                    f"and cannot continue bit-exactly on {template.rng.device.type}"
                )
            template.rng.set_state(payload["rng_state"])
        with torch.no_grad():
            template.iter_idx.copy_(payload["iter_idx"])

        has_ema = meta.get("has_ema", "gen_ema" in payload)
        if has_ema:
            saved = payload["gen_ema"]
            if template.gen_ema is not None:
                _load_tree(template.gen_ema, saved, "gen_ema")
            else:
                template.gen_ema = {k: v.to(device) for k, v in saved.items()}
        elif template.gen_ema is not None:
            with torch.no_grad():
                for k, p in template.gen.named_parameters():
                    template.gen_ema[k].copy_(p)
        return template, meta
