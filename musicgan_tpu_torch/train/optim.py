"""Adam with per-leaf step counts (counterpart of
``musicgan_tpu/train/optim.py::adam_per_leaf``).

PyTorch's own Adam keeps a per-parameter step count that starts at the
parameter's first real gradient, and the reference relies on it when newly
grown heads join the optimizer mid-run.  Here every head and block exists
from the start, so a leaf that a stage does not reach yet sees a zero (or
missing) gradient for many steps: its count advances only when its
gradient is nonzero anywhere, its update is exactly zero while the count is
0, and its bias correction uses its own count.  One global count would give
a leaf that was inactive for N steps a ``1/sqrt(1 - b2)`` = 3.16x oversized
first update.

This is not ``torch.optim.Adam``: the count is data-dependent and stays on
the device (``(g != 0).any()`` is kept as a tensor, no ``.item()``), and
the state is a plain pytree ``AdamState(count, mu, nu)`` of dictionaries
keyed by parameter name, the layout the JAX package's state carries across
to (``models/torch_ingest.py``).  Parameters and state are updated in
place; the per-leaf arithmetic is batched with ``torch._foreach_*``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["AdamState", "AdamPerLeaf", "adam_per_leaf"]


class AdamState(NamedTuple):
    count: dict  # name -> int32 scalar tensor
    mu: dict     # name -> first moment, the parameter's shape
    nu: dict     # name -> second moment


class AdamPerLeaf:
    def __init__(self, learning_rate: float, b1: float, b2: float, eps: float = 1e-8):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params: dict) -> AdamState:
        return AdamState(
            count={k: torch.zeros((), dtype=torch.int32, device=p.device) for k, p in params.items()},
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState, params: dict) -> None:
        """One step, in place on ``state`` and ``params``.  ``grads`` maps
        names to gradients; a missing or None entry is an all-zero gradient."""
        b1, b2 = self.b1, self.b2
        names = list(params)
        live = [k for k in names if grads.get(k) is not None]
        idle = [k for k in names if grads.get(k) is None]
        if live:
            g = [grads[k] for k in live]
            mu, nu = [state.mu[k] for k in live], [state.nu[k] for k in live]
            active = [(gi != 0).any().to(torch.int32) for gi in g]
            torch._foreach_add_([state.count[k] for k in live], active)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        if idle:  # a zero gradient only decays the moments
            torch._foreach_mul_([state.mu[k] for k in idle], b1)
            torch._foreach_mul_([state.nu[k] for k in idle], b2)

        count = torch.stack([state.count[k] for k in names])
        c_f = count.clamp(min=1).to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, c_f)
        bc2 = 1.0 - torch.pow(b2, c_f)
        # Leaves that were never active (count 0) get exactly zero update.
        step = torch.where(count > 0, -self.learning_rate / bc1, torch.zeros_like(bc1))
        den = torch._foreach_div([state.nu[k] for k in names], list(bc2.unbind()))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_mul([state.mu[k] for k in names], list(step.unbind()))
        torch._foreach_div_(upd, den)
        torch._foreach_add_([params[k] for k in names], upd)


def adam_per_leaf(learning_rate: float, b1: float, b2: float, eps: float = 1e-8) -> AdamPerLeaf:
    return AdamPerLeaf(learning_rate, b1, b2, eps)
