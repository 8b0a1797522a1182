"""musicgan_tpu_torch — the PyTorch / CUDA port of ``musicgan_tpu`` for
NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports none of it,
nor JAX.  Ported so far: the synthesis path — a reference ``gen_*.pt``
checkpoint through the fully grown generator and the iSTFT vocoder to WAV
files — on three hand-written CUDA kernels (``ops/``, sources in
``csrc/``).  Its entry points are ``generate.generate``,
``generate.synthesize_fn`` and ``python -m musicgan_tpu_torch generate``;
they run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import audio, config, generate, models, ops

__all__ = ["audio", "config", "generate", "models", "ops", "__version__"]
