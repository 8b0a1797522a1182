"""What the drivers share: the program's configuration from a cell's
configuration file, the seeded draws, pacing on the device."""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["model_config", "rng", "device_generator", "Completion", "free_device"]


def model_config(config: dict):
    """The program's ``ModelConfig`` from the file's ``model`` group."""
    from musicgan_tpu_torch.config import ModelConfig

    m = dict(config["model"])
    for key in ("gen_channels", "disc_channels"):
        if key in m:
            m[key] = tuple(tuple(c) for c in m[key])
    return ModelConfig(**m)


def rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for one purpose of a run, from its seed (any whole
    number; the driver's are larger than 32 bits)."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % (2**63))


class Completion:
    """A mark after queued device work; ``wait()`` returns when the work
    before it is done (at once on the CPU, where it ran as it was called)."""

    def __init__(self, device):
        """Marks the current stream of ``device``."""
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        return time.perf_counter()


def free_device(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
