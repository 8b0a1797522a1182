"""Training: the WGAN-GP train step, its per-leaf Adam, and the train loop
with its growth schedule, checkpoints and previews."""

from .checkpoint import CheckpointManager, resolve_checkpoint
from .grower import Grower
from .loop import PREEMPTED, train
from .optim import AdamPerLeaf, AdamState, adam_per_leaf
from .saver import Saver
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
    "CheckpointManager",
    "Grower",
    "PREEMPTED",
    "Saver",
    "TrainState",
    "adam_per_leaf",
    "build_chunk_step",
    "build_step",
    "init_train_state",
    "make_optimizers",
    "resolve_checkpoint",
    "train",
]
