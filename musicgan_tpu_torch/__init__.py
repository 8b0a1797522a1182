"""musicgan_tpu_torch — the PyTorch / CUDA port of ``musicgan_tpu`` for
NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports none of it,
nor JAX.  Ported so far: the synthesis path — a reference ``gen_*.pt``
checkpoint through the fully grown generator and the iSTFT vocoder to WAV
files — and the WGAN-GP train step (generator, critic, hand-unrolled
gradient penalty, per-leaf Adam), on four hand-written CUDA kernels
(``ops/``, sources in ``csrc/``).  Its entry points are
``generate.generate``, ``generate.synthesize_fn``,
``python -m musicgan_tpu_torch generate``, ``train.init_train_state``,
``train.build_step`` and ``train.build_chunk_step``; they run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import audio, config, generate, models, ops, train

__all__ = ["audio", "config", "generate", "models", "ops", "train", "__version__"]
