"""musicgan_tpu_torch — the PyTorch / CUDA port of ``musicgan_tpu`` for
NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports none of it,
nor JAX.  Ported so far: the synthesis path (a reference ``gen_*.pt``
checkpoint, or a checkpoint of this package's ``train``, through the
generator and the iSTFT vocoder to WAV files), the WGAN-GP train step
(generator, critic, hand-unrolled gradient penalty, per-leaf Adam) and the
train loop around it (growth schedule, dataset, checkpoints with bit-exact
resume, previews, metrics, stall watchdog), serving (``serve``: a micro-batching
service over the resident generator and its HTTP front end), evaluation
(``evaluate``: checkpoint audition and corpus-referenced scoring), the
forward STFT half with ``view_audio``, dataset ingest
(``audio.ingest.create_dataset`` with the C++ host tail of ``native``),
run interchange with the reference's four-file saves
(``models.torch_ingest``), conv_impl selection (``ops.autotune``:
``"auto"`` measures per shape; the library lowerings ``xla`` /
``subpixel``; bf16 training) and parallelism (``parallel``: data-parallel
training over a ``torch.distributed`` group, one process a card, and
synthesis of a long clip sharded along time over a mesh of devices, which
``serve`` takes for a solo wide request), on hand-written CUDA kernels
(``ops/``, sources in ``csrc/``): the five TPU kernels' counterparts, K1, K3
and K4 also in bf16 (the ``*_bf16`` inference impls), and the conv's weight
gradient.  Its entry points are
``generate.generate``, ``generate.synthesize_fn``, ``train.train``,
``serve.SynthesisService``, ``serve.serve``, ``evaluate.audition_run``,
``evaluate.compare_artifacts``, ``view_audio.view_audio``,
``audio.ingest.create_dataset``, ``models.torch_ingest.export_reference_save``,
``models.torch_ingest.import_reference_run``, ``python -m musicgan_tpu_torch
create_dataset|train|generate|serve|eval|compare|view_audio|export|import|info``,
``train.init_train_state``, ``train.build_step``,
``train.build_chunk_step``, ``parallel.initialize_distributed`` and
``parallel.longclip.sharded_synthesize_fn``; those that build tensors run on ``cuda`` unless
the caller passes ``device="cpu"`` (ingest runs on the host only).
"""

__version__ = "0.1.0"

from . import audio, config, evaluate, generate, models, native, ops, parallel, serve, train, utils, view_audio

__all__ = [
    "audio", "config", "evaluate", "generate", "models", "native", "ops", "parallel", "serve", "train",
    "utils", "view_audio", "__version__",
]
