"""One-time conv-impl autotune: measure, pick, cache (counterpart of
``musicgan_tpu/ops/autotune.py``).

``ModelConfig.conv_impl="auto"`` means "run each candidate once on the real
shapes and keep the winner".  On the card the candidates are the library
lowerings (``"xla"``: ``F.conv2d`` through cuDNN; ``"subpixel"``: the same
with each up2x + conv3x3 as four 2x2 phase convs) and the hand-written
kernels (K1, K3 and K4 in float32 and bf16 for inference; the trainable
kernels for training), and which is fastest depends on the shape, so no
static default is right everywhere.

Methodology, as in JAX's: K forwards (or K train iterations) queued in one
dispatch that ends where the host waits for the device
(``utils/timing.py``), best of ``_REPS``, the scalar round trip
subtracted.  The result is cached per (card, stage, latent shape, dtype)
for the life of the process and persisted to
``$MUSICGAN_AUTOTUNE_DIR/conv_autotune.json`` (default
``~/.cache/musicgan_tpu_torch/``, never the JAX package's file), so later
processes on the same machine skip the measurement too.  The key's backend
part names the card (``cuda:NVIDIA H100 80GB HBM3``) where JAX writes
``jax.default_backend()``.

One deliberate deviation from JAX: JAX scores a candidate that raises as
``inf`` and lets a quieter one win.  Here a candidate that raises makes the
resolution raise, naming the impl: a kernel that fails to build or launch
must never be hidden behind a library winner.

One process only: the broadcast of the lead's winner to the other
processes of a multi-process run comes with data parallelism (ROADMAP A16).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..config import ModelConfig

__all__ = [
    "resolve_conv_impl", "measure_conv_impls", "measure_train_impls",
    "resolve_istft_impl", "measure_istft_impls", "VOCODER_IMPLS",
    "TRAINING_IMPLS", "SECOND_ORDER_IMPLS", "ALL_IMPLS",
]

_CACHE: dict = {}
_K = 4          # forwards per timed dispatch
_REPS = 2       # dispatches per candidate (best-of)
_CACHE_VERSION = 1  # bump when any impl's kernel changes: invalidates
# persisted winners picked against the old code

# Differentiable impls (trainable).  "pallas_train" is the trainable kernel
# path (ops/conv_vjp.py), differentiable ONCE, which covers every first-order
# context of the WGAN-GP step; the grad-of-grad penalty branch is routed to
# "xla" inside the step (train/step.py).  "pallas_gp" = pallas_train + the
# penalty's inner input gradient unrolled by hand on the kernels
# (models/discriminator.py::critic_input_grad_nchw_train): the whole step
# runs the kernels.
TRAINING_IMPLS = ("xla", "subpixel", "pallas_train", "pallas_gp")
# Impls whose graphs autograd can differentiate twice (the penalty's
# create_graph formulation; pallas_gp sidesteps it with the explicit
# backward, so it is NOT needed here).
SECOND_ORDER_IMPLS = ("xla", "subpixel")
# Inference candidates, all six of JAX's ALL_IMPLS.  JAX measures
# TPU_INFERENCE_IMPLS on its chip, which drops "pallas_up" only because
# Mosaic rejects its float32 phase interleave; K3 on Hopper interleaves the
# phases in its own stores, so "pallas_up" stays a candidate here.
ALL_IMPLS = (
    "xla", "subpixel", "pallas", "pallas_bf16", "pallas_up",
    "pallas_up_bf16",
)
# Vocoder (iSTFT) lowerings: the plain matmul-DFT (audio/stft.py) on the
# card vs the fused kernel K5 (ops/istft_fused.py).  Same contract.
VOCODER_IMPLS = ("xla", "pallas")


def _beat_watchdog() -> None:
    """Witness the measurement's progress to the run's stall watchdog (if
    any): a stage's first step times several train graphs, honest device
    work during which the train loop makes no metric fetches."""
    from ..utils.watchdog import beat_active

    beat_active()


def _device(device) -> torch.device:
    """``device``, or the process's default one (JAX's
    ``jax.default_backend()``): the card where there is one."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _backend(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def _capturing(device: torch.device) -> bool:
    """Inside a CUDA-graph capture (JAX's "under a tracer"): the timing
    harness synchronises and must never run there."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _measure_rtt(device: torch.device) -> float:
    from ..utils.timing import scalar_rtt

    return scalar_rtt(reps=3, device=device)


def _best_of(impl: str, fn, k: int, rtt: float, device: torch.device) -> float:
    """Seconds per unit of ``fn`` (a dispatch of ``k`` units): one warm-up
    dispatch (builds, first launches), then the best of ``_REPS``, the round
    trip subtracted and clamped at 0 for display (the ranking is unaffected:
    every candidate lost the same ``rtt``).  A candidate that raises makes
    the measurement raise, naming it."""
    from ..utils.timing import _wait

    try:
        fn()
        _wait(device)
        _beat_watchdog()  # the wait above is real device progress
        best = float("inf")
        for _ in range(_REPS):
            t0 = time.perf_counter()
            fn()
            _wait(device)
            best = min(best, time.perf_counter() - t0)
    except Exception as e:
        raise RuntimeError(f"[autotune] candidate {impl!r} failed: {type(e).__name__}: {e}") from e
    _beat_watchdog()
    return max((best - rtt) / k, 0.0)


def _persist_path() -> str:
    base = os.environ.get("MUSICGAN_AUTOTUNE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "musicgan_tpu_torch"
    )
    return os.path.join(base, "conv_autotune.json")


def _load_persisted() -> dict:
    p = _persist_path()
    if os.path.isfile(p):
        try:
            with open(p) as f:
                return json.load(f)
        except (OSError, ValueError):
            pass
    return {}


def _persist(table: dict) -> None:
    """Write the table; a directory that cannot be written only costs the
    next process a measurement."""
    p = _persist_path()
    try:
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "w") as f:
            json.dump(table, f, indent=1)
    except OSError:
        pass


def _report(label: str, winner: str, times: dict, seconds: float) -> None:
    print(
        f"[autotune] {label} -> {winner}  ("
        + ", ".join(f"{k}={v * 1e3:.2f}ms" for k, v in times.items())
        + f"; measured in {seconds:.2f} s)",
        flush=True,
    )


def measure_conv_impls(
    cfg: ModelConfig,
    z_shape: tuple,
    stage: int,
    candidates=ALL_IMPLS,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> dict[str, float]:
    """Wall seconds per generator forward for each candidate impl on
    ``device`` (the card by default), a seeded generator at ``cfg``'s widths
    on a seeded NHWC latent of ``z_shape``.  Public so that PERF.md studies
    can tabulate it."""
    from ..models.generator import Generator

    device = _device(device)
    gen = Generator(cfg, device=device, seed=0)
    g = torch.Generator(device=device).manual_seed(1)
    z = torch.randn(z_shape, generator=g, device=device, dtype=dtype).permute(0, 3, 1, 2)
    rtt = _measure_rtt(device)

    times: dict[str, float] = {}
    for impl in candidates:

        @torch.no_grad()
        def many(impl=impl):
            acc = torch.zeros((), device=device)
            for _ in range(_K):
                acc = acc + gen.forward_nchw(z, stage, 1.0, impl).sum()
            return acc

        times[impl] = _best_of(impl, many, _K, rtt, device)
    return times


def measure_train_impls(
    model_cfg: ModelConfig,
    train_cfg,
    stage: int,
    candidates=TRAINING_IMPLS,
    device=None,
) -> dict[str, float]:
    """Wall seconds per train ITERATION for each candidate, on a real
    K-iteration chunk of the train step (D forwards + gradient penalty +
    backward + Adam, one generator update per chunk: the n_critic pattern),
    from a fresh seeded state for each."""
    from ..train.step import build_chunk_step, init_train_state

    k = 5  # one full n_critic cycle per dispatch
    size = 4 * 2**stage
    device = _device(device)
    rtt = _measure_rtt(device)
    init_cfg = dataclasses.replace(model_cfg, conv_impl="xla")
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((k, train_cfg.batch_size, 2, size, size), generator=g, device=device)
    alphas = [1.0] * k
    mask = [True] + [False] * (k - 1)

    times: dict[str, float] = {}
    for impl in candidates:
        mcfg = dataclasses.replace(model_cfg, conv_impl=impl)
        step = build_chunk_step(stage, k, mcfg, train_cfg, pre_scaled=True, device=device)
        state = init_train_state(0, init_cfg, train_cfg, device=device)

        def run(step=step, state=state):
            step(state, x, alphas, mask)  # updates ``state`` in place

        times[impl] = _best_of(impl, run, k, rtt, device)
        del state
    return times


def measure_istft_impls(
    n_bins: int, t: int, candidates=VOCODER_IMPLS, k: int = 48, device=None
) -> dict[str, float]:
    """Wall seconds per iSTFT for each vocoder lowering at the ``(n_bins,
    t)`` spectrum shape, ``k`` inversions per timed dispatch (a single
    iSTFT is well under a millisecond, so a shallow dispatch would rank the
    round trip's jitter, not the lowerings)."""
    from ..audio.stft import istft_real_imag
    from ..models.layers import library_numerics
    from .istft_fused import istft_fused

    device = _device(device)
    rng = np.random.default_rng(0)
    real = torch.from_numpy(rng.normal(size=(n_bins, t)).astype(np.float32)).to(device)
    imag = torch.from_numpy(rng.normal(size=(n_bins, t)).astype(np.float32)).to(device)
    rtt = _measure_rtt(device)
    fns = {"xla": istft_real_imag, "pallas": istft_fused}

    times: dict[str, float] = {}
    for impl in candidates:

        def many(fn=fns[impl]):
            with library_numerics():
                for _ in range(k):
                    fn(real, imag)

        times[impl] = _best_of(impl, many, k, rtt, device)
    return times


def _istft_key(backend: str, n_bins: int, t: int) -> str:
    return f"v{_CACHE_VERSION}|{backend}|istft|{n_bins}x{t}|{VOCODER_IMPLS}"


def resolve_istft_impl(
    t: int, n_bins: int = 513, allow_measure: bool = True, device=None
) -> str:
    """Measured vocoder-lowering winner for a ``(n_bins, t)`` spectrum on
    ``device`` (the card by default): the contract of
    :func:`resolve_conv_impl`, persisted per shape; a CPU device always
    gets ``"xla"``."""
    device = _device(device)
    if device.type == "cpu":
        return "xla"
    allow_measure = allow_measure and not _capturing(device)
    key = _istft_key(_backend(device), n_bins, t)
    if not allow_measure and key not in _CACHE:
        return _load_persisted().get(key) or "xla"
    if key not in _CACHE:
        persisted = _load_persisted()
        if key in persisted:
            winner = persisted[key]
        else:
            t0 = time.perf_counter()
            times = measure_istft_impls(n_bins, t, device=device)
            winner = min(times, key=times.get)
            _report("istft_impl", winner, times, time.perf_counter() - t0)
            persisted[key] = winner
            _persist(persisted)
        _CACHE[key] = winner
    return _CACHE[key]


def _candidates_and_key(
    backend: str, z_shape: tuple, stage: int, for_training: bool, train_cfg
) -> tuple[tuple, str]:
    """Candidate impls and the persisted-table key for one resolution.
    Training keys carry a ``train`` marker plus batch and compute dtype, so
    a training winner can never alias an inference winner (they are
    measured on different graphs and rank differently)."""
    if for_training:
        candidates = TRAINING_IMPLS
        if train_cfg is not None and train_cfg.compute_dtype != "float32":
            # pallas_train / pallas_gp are float32 kernel paths; bf16
            # training keeps the library candidates.
            candidates = tuple(i for i in candidates if i in SECOND_ORDER_IMPLS)
        batch = train_cfg.batch_size if train_cfg is not None else z_shape[0]
        cdt = train_cfg.compute_dtype if train_cfg is not None else "float32"
        key = (
            f"v{_CACHE_VERSION}|{backend}|train|s{stage}|"
            f"{'x'.join(map(str, z_shape))}|b{batch}|{cdt}|{candidates}"
        )
    else:
        candidates = ALL_IMPLS
        key = (
            f"v{_CACHE_VERSION}|{backend}|s{stage}|"
            f"{'x'.join(map(str, z_shape))}|float32|{candidates}"
        )
    return candidates, key


def resolve_conv_impl(
    cfg: ModelConfig,
    z_shape: tuple,
    stage: int,
    for_training: bool = False,
    train_cfg=None,
    allow_measure: bool = True,
    device=None,
) -> ModelConfig:
    """Return ``cfg`` with ``conv_impl="auto"`` replaced by the measured
    winner for (card, stage, z_shape); ``z_shape`` is the NHWC latent shape,
    as in JAX.  Non-auto configs pass through, except that training rejects
    the inference-only kernel impls, and the float32 kernel impls under a
    bf16 ``compute_dtype``.

    ``device``: where the impl will run, the card by default; on a CPU
    device "auto" is ``"xla"`` without measuring.  With ``for_training``
    and a ``train_cfg`` the candidates are timed on a real chunk of the
    train step (:func:`measure_train_impls`).

    ``allow_measure=False`` (and any call inside a CUDA-graph capture)
    resolves from the in-memory or persisted table only and falls back to
    ``"xla"`` on a miss WITHOUT caching it, so a later call outside still
    measures."""
    if cfg.conv_impl != "auto":
        if for_training and cfg.conv_impl not in TRAINING_IMPLS:
            raise ValueError(
                f"conv_impl={cfg.conv_impl!r} is inference-only (no VJP); "
                f"use one of {TRAINING_IMPLS} or 'auto' for training"
            )
        if (
            for_training
            and train_cfg is not None
            and train_cfg.compute_dtype != "float32"
            and cfg.conv_impl not in SECOND_ORDER_IMPLS
        ):
            # The trainable kernels are float32 kernels that ignore
            # compute_dtype: honoring this combination would silently train
            # in full float32 under a bf16-labelled run.
            raise ValueError(
                f"conv_impl={cfg.conv_impl!r} trains in float32 only; with "
                f"compute_dtype={train_cfg.compute_dtype!r} use one of "
                f"{SECOND_ORDER_IMPLS} or 'auto'"
            )
        return cfg

    device = _device(device)
    if device.type == "cpu":
        # The kernels' plain versions are no production target there; don't
        # spend start-up time measuring them.
        return dataclasses.replace(cfg, conv_impl="xla")

    candidates, key = _candidates_and_key(_backend(device), z_shape, stage, for_training, train_cfg)
    if not (allow_measure and not _capturing(device)) and key not in _CACHE:
        winner = _load_persisted().get(key)
        return dataclasses.replace(cfg, conv_impl=winner or "xla")
    if key not in _CACHE:
        persisted = _load_persisted()
        if key in persisted:
            winner = persisted[key]
        else:
            t0 = time.perf_counter()
            if for_training and train_cfg is not None:
                times = measure_train_impls(cfg, train_cfg, stage, candidates, device=device)
                label = f"train conv_impl (stage {stage})"
            else:
                times = measure_conv_impls(cfg, z_shape, stage, candidates, device=device)
                label = f"conv_impl (stage {stage}, z {tuple(z_shape)})"
            winner = min(times, key=times.get)
            _report(label, winner, times, time.perf_counter() - t0)
            persisted[key] = winner
            _persist(persisted)
        _CACHE[key] = winner
    return dataclasses.replace(cfg, conv_impl=_CACHE[key])
