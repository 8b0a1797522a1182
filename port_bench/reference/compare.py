"""The numbers that decide ``correct``, each compared with its limit.

Synthesis, in two stages (``image_gap``, ``wave_gap``): the waveform is an
ill-conditioned function of the generator's image.  Its phase is a running
sum of five thousand instantaneous-frequency columns and the overlap-add
of an image that is no consistent spectrogram interferes, so bf16 rounding
alone, 0.03 of the image's 2-norm, moves the waveform (and its re-analysed
magnitudes) by more than half of its norm, as far as fp8 does.  So the
image is judged against the reference's from the same latents, and the
waveform against the reference's vocoder on the program's own image, each
by the relative 2-norm of the worst clip.

Training: each leaf is judged by its norm, by the worst leaf.  The gap of a
leaf is ``| |a| - |r| |`` over the larger of ``|r|`` and the median leaf's
``|r|`` (some gradients are all but zero).  Leaves whose reference gradient
is below a thousandth of the median leaf's move by round-off alone and are
left out, by that rule and not by name (a head that the fade multiplies by
0, the leaves of other stages).
"""

from __future__ import annotations

import statistics

import torch

__all__ = ["rel_gaps", "moving_leaves", "leaf_gaps", "loss_gap"]


def rel_gaps(got: torch.Tensor, ref: torch.Tensor) -> list[float]:
    """Per row: ``||got - ref|| / ||ref||`` (float32, on ``ref``'s device);
    a row of another shape, missing, or not finite reads infinity."""
    if got is None or got.shape != ref.shape:
        return [float("inf")] * len(ref)
    got = got.to(ref.device, torch.float32)
    out = []
    for a, r in zip(got, ref):
        gap = torch.linalg.vector_norm(a - r) / torch.linalg.vector_norm(r)
        out.append(float(gap) if bool(torch.isfinite(a).all()) else float("inf"))
    return out


def moving_leaves(ref_grad_norms: dict) -> list[str]:
    """The leaves the rule keeps: a reference gradient of at least a
    thousandth of the median leaf's (over the leaves it reaches)."""
    reached = {k: v for k, v in ref_grad_norms.items() if v is not None and v > 0}
    if not reached:
        return []
    med = statistics.median(reached.values())
    return sorted(k for k, v in reached.items() if v >= 1e-3 * med)


def leaf_gaps(prog: dict, ref: dict, leaves: list[str]) -> dict:
    """Each leaf's gap of norms; a leaf the program lacks, or whose norm is
    not finite, reads infinity."""
    if not leaves:
        return {}
    med = statistics.median(ref[k] for k in leaves)
    out = {}
    for k in leaves:
        a = prog.get(k)
        finite = a is not None and a == a and abs(a) != float("inf")
        out[k] = abs(a - ref[k]) / max(ref[k], med) if finite else float("inf")
    return out


def loss_gap(prog: list[float], ref: list[float]) -> float:
    """The worst of ``|a - r| / max(|r|, 1e-3)`` over the losses compared."""
    gaps = [abs(a - r) / max(abs(r), 1e-3) if a == a else float("inf") for a, r in zip(prog, ref)]
    return max(gaps) if gaps else float("inf")
