"""Host-side progressive-growth schedule (counterpart of
``musicgan_tpu/train/grower.py``; reference ``utils.py:14-86``).

Pure bookkeeping over *samples viewed*; the stage index it produces selects
which train step runs (``train/step.py::build_step``), and ``alpha`` is the
fade-in scalar fed to that step.  The per-stage input transform itself
lives inside the step (``audio/transforms.py::grower_transform``), not here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

__all__ = ["Grower"]


@dataclass
class Grower:
    n_grow: int = 7
    max_stage: int | None = None  # cap growth (phantom grows past the cap
    # would keep resetting the fade-in against a stale previous-stage head)
    fadein_lengths: Sequence[int] = (
        1, 25_000, 37_500, 50_000, 62_500, 75_000, 87_500, 100_000,
    )
    train_lengths: Sequence[int] = (
        50_000, 100_000, 150_000, 200_000, 250_000, 300_000, 350_000,
    )
    curr_grow: int = 0
    sample_idx: int = 0
    step_sample_idx: int = 0
    _cum_train: list = field(init=False, repr=False)

    def __post_init__(self):
        assert len(self.fadein_lengths) == self.n_grow + 1
        assert len(self.train_lengths) == self.n_grow
        acc, cum = 0, []
        for t in self.train_lengths:
            acc += t
            cum.append(acc)
        self._cum_train = cum

    def grow(self, viewed_samples: int) -> bool:
        """Advance counters; True exactly when the stage just switched
        (reference ``utils.py:45-60``)."""
        self.sample_idx += viewed_samples
        self.step_sample_idx += viewed_samples
        cap = self.n_grow if self.max_stage is None else min(
            self.n_grow, self.max_stage
        )
        if self.curr_grow >= cap:
            return False
        if self._cum_train[self.curr_grow] < self.sample_idx:
            self.step_sample_idx = 0
            self.curr_grow += 1
            return True
        return False

    @property
    def alpha(self) -> float:
        """Fade-in weight (reference ``utils.py:62-68``); stage 0's fade-in
        length of 1 makes alpha == 1 immediately."""
        return min(
            1.0, (1.0 + self.step_sample_idx) / self.fadein_lengths[self.curr_grow]
        )

    def alphas_for_next(self, k: int, batch_size: int) -> list[float]:
        """Fade-in weights for the next ``k`` iterations of ``batch_size``
        samples each, assuming no stage switch occurs within them (the
        chunked train loop guarantees this via ``samples_to_next_stage``).
        Element ``i`` equals what ``alpha`` would read after ``i`` calls to
        ``grow(batch_size)`` — property-tested against that sequence."""
        fade = self.fadein_lengths[self.curr_grow]
        return [
            min(1.0, (1.0 + self.step_sample_idx + i * batch_size) / fade)
            for i in range(k)
        ]

    @property
    def downscale(self) -> int:
        """Image downscale exponent: 7 at stage 0 (4x4) .. 0 at stage 7."""
        return self.n_grow - self.curr_grow

    @property
    def image_size(self) -> int:
        return 512 // 2**self.downscale

    def samples_to_next_stage(self) -> int | None:
        """Samples left before the next stage switch (None once fully
        grown) — used by the chunked train loop to size dispatch chunks."""
        cap = self.n_grow if self.max_stage is None else min(
            self.n_grow, self.max_stage
        )
        if self.curr_grow >= cap:
            return None
        return self._cum_train[self.curr_grow] - self.sample_idx

    # --- checkpoint support (the reference cannot resume; we can) ---

    def state_dict(self) -> dict:
        return {
            "curr_grow": self.curr_grow,
            "sample_idx": self.sample_idx,
            "step_sample_idx": self.step_sample_idx,
        }

    def load_state_dict(self, d: dict) -> None:
        self.curr_grow = int(d["curr_grow"])
        self.sample_idx = int(d["sample_idx"])
        self.step_sample_idx = int(d["step_sample_idx"])
