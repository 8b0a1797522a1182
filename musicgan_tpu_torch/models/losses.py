"""GAN losses (counterpart of ``musicgan_tpu/models/losses.py``; reference
``networks/criterion.py:4-18``).

The Wasserstein pair drives training; the log-loss pair is kept for parity
with the reference, which defines it and does not use it either.
"""

from __future__ import annotations

import torch

__all__ = [
    "wasserstein_discriminator_loss",
    "wasserstein_generator_loss",
    "discriminator_loss",
    "generator_loss",
]


def wasserstein_discriminator_loss(y_real: torch.Tensor, y_fake: torch.Tensor):
    return -(torch.mean(y_real) - torch.mean(y_fake))


def wasserstein_generator_loss(y_fake: torch.Tensor):
    return -torch.mean(y_fake)


def discriminator_loss(y_real: torch.Tensor, y_fake: torch.Tensor):
    return -torch.mean(torch.log2(y_real) + torch.log2(1.0 - y_fake))


def generator_loss(y_fake: torch.Tensor):
    return -torch.mean(torch.log2(y_fake))
