"""Training: the WGAN-GP train step and its per-leaf Adam."""

from .optim import AdamPerLeaf, AdamState, adam_per_leaf
from .step import (
    TrainState,
    build_chunk_step,
    build_step,
    init_train_state,
    make_optimizers,
)

__all__ = [
    "AdamPerLeaf",
    "AdamState",
    "TrainState",
    "adam_per_leaf",
    "build_chunk_step",
    "build_step",
    "init_train_state",
    "make_optimizers",
]
