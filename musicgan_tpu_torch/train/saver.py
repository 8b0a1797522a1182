"""Periodic checkpoint + preview-image saver (counterpart of
``musicgan_tpu/train/saver.py``; reference ``utils.py:89-242``).

Every ``save_every`` train iterations: write a full-resume checkpoint and
render ``nb_preview`` magnitude/phase PNG pairs ('plasma' colormap, the
reference's preview style at ``utils.py:147-207``) from fresh latents
through the current-stage generator.  A preview has two halves:
:meth:`Saver.preview_images` computes the images on the state's device
(through the inference forward, so through the conv kernels on the card),
:meth:`Saver.draw_previews` draws them with matplotlib on the host.

In a data-parallel run the state is replicated: only the lead (``lead``)
writes the checkpoint and the previews, and every rank then waits in
``sync`` (a barrier), so that no rank reads a save before it exists.  The
cadence counters advance on every rank.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..models.generator import Generator
from .checkpoint import CheckpointManager
from .step import TrainState

__all__ = ["Saver"]


class Saver:
    def __init__(
        self,
        output_dir: str,
        train_cfg: TrainConfig = TrainConfig(),
        model_cfg: ModelConfig = ModelConfig(),
        lead: bool = True,
        sync: Optional[Callable[[], None]] = None,
    ):
        os.makedirs(output_dir, exist_ok=True)
        self.lead = lead
        self.sync = sync
        self.output_dir = output_dir
        self.cfg = train_cfg
        self.model_cfg = model_cfg
        self.ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"))
        self.counter = 0
        self.curr_save = 0
        # Made at the first preview, on the state's device: the stream of
        # preview latents runs on from save to save, as JAX's split key does.
        self._preview_rng: torch.Generator | None = None
        self._ema_gen: Generator | None = None  # holds the EMA weights for previews
        self._warned_no_matplotlib = False

    @torch.no_grad()
    def preview_images(self, state: TrainState, stage: int, alpha: float) -> np.ndarray:
        """``(nb_preview, H, W, 2)`` magn/phase images of fresh latents at
        ``stage`` and ``alpha``.  Previews render what generate would ship:
        the EMA weights when the run carries them (``ema_decay > 0``)."""
        cfg = self.model_cfg
        device = state.iter_idx.device
        if self._preview_rng is None:
            self._preview_rng = torch.Generator(device=device).manual_seed(self.cfg.seed + 777)
        gen = state.gen
        if state.gen_ema is not None:
            if self._ema_gen is None:
                self._ema_gen = Generator(cfg, device=device)
            # In place: the blocks' packed weights are made anew once a save.
            self._ema_gen.load_state_dict(state.gen_ema)
            gen = self._ema_gen
        z = torch.randn(
            (self.cfg.nb_preview, cfg.rand_channels, cfg.latent_height, cfg.latent_width),
            generator=self._preview_rng, device=device,
        )
        # The Saver's conv_impl, as JAX's Saver runs generator_forward with
        # its model_cfg ("auto" there is the library lowering).
        x = gen.forward_nchw(z, stage, float(alpha), cfg.conv_impl)  # (N, 2, H, W)
        return x.permute(0, 2, 3, 1).cpu().numpy()

    def draw_previews(self, images: np.ndarray, stage: int) -> list[str]:
        """Write ``{magn,phase}_{save}_ID{i}.png`` for each image; returns
        the paths."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        paths = []
        for gen_idx, x in enumerate(images):
            for ch, name in ((0, "magn"), (1, "phase")):
                img = x[:, :, ch]
                fig, ax = plt.subplots()
                ax.matshow(img / (img.max() - img.min() + 1e-12), cmap="plasma")
                plt.title(f"gen {name} {self.curr_save} grow={stage}")
                path = os.path.join(
                    self.output_dir, f"{name}_{self.curr_save}_ID{gen_idx}.png"
                )
                fig.savefig(path)
                plt.close(fig)
                paths.append(path)
        return paths

    def _save_previews(self, state: TrainState, stage: int, alpha: float) -> None:
        if self.cfg.nb_preview <= 0:
            return
        images = self.preview_images(state, stage, alpha)
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            # The images were computed; only the drawing needs the package.
            if not self._warned_no_matplotlib:
                print(
                    "[saver] matplotlib is not installed: previews are computed "
                    "but no PNG is drawn", flush=True,
                )
                self._warned_no_matplotlib = True
            return
        self.draw_previews(images, stage)

    def _save(self, state: TrainState, stage: int, alpha: float, meta: dict) -> None:
        if self.lead:
            self.ckpt.save(
                self.curr_save,
                state,
                {**meta, "saver_counter": self.counter, "save_idx": self.curr_save},
            )
            self._save_previews(state, stage, alpha)
        if self.sync is not None:
            self.sync()
        self.curr_save += 1

    def request_save(
        self, state: TrainState, stage: int, alpha: float, meta: dict
    ) -> bool:
        """Call once per train iteration; fires every ``save_every`` calls
        (reference ``utils.py:209-233``)."""
        self.counter += 1
        if self.counter % self.cfg.save_every != 0:
            return False
        self._save(state, stage, alpha, meta)
        return True

    def save_now(
        self, state: TrainState, stage: int, alpha: float, meta: dict
    ) -> None:
        """Off-cadence checkpoint flush (preemption): same artifact as a
        cadence save; the cadence counter is untouched, so the next
        periodic save still fires on schedule."""
        self._save(state, stage, alpha, meta)

    @property
    def save_counter(self) -> int:
        return self.counter % self.cfg.save_every
