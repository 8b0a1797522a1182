"""Offline synthesis: a library of clips rendered by back-to-back calls.

Each call is ``synthesize_fn(cfg, stage)(gen, z)`` on ``clips_per_call``
latents of ``nb_vec`` vectors drawn from the seed, its waveforms copied to
pinned host memory on a copy stream of their own, as a renderer that
streams its clips out overlaps the copy of one call with the next.  That
pipeline is the harness's own: the program's ``generate`` copies each
call's waveforms to the host synchronously, so this cell measures the
synthesis with an overlap that ``generate`` lacks.  The host queues
``queue_ahead`` calls beyond the one it waits for.  The window closes at
the first completion past ``--seconds``; the rate is all the audio
completed on the host by then over the whole window.

``correct``: ``sampled_calls`` calls drawn from the seed among the first
``sample_from_first`` (and the last call completed), all their clips,
against the plain reference (``reference/synthesis.py``), in two stages
(``reference/compare.py``): the generator's image inside the timed call
against the reference's from the same latents, and the waveform against
the reference's vocoder on that image, the program's own (the waveform as
a whole is not held against the reference's from the latents).  The image
is observed by wrapping the generator's ``forward_nchw`` on its instance
(:func:`observe_images`), which keeps a reference to each call's output
and adds no device work.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from ..reference import compare, synthesis as ref
from ..reference.lower import numerics
from ..work import ELEM_BYTES, PEAK_FLOPS, generator_units, least_s, total, vocoder_unit
from .common import Completion, device_generator, free_device, model_config, rng

AUDIO_DEFAULTS = {"n_fft": 1024, "stft_stride": 256, "sample_rate": 44100}


def _geometry(run):
    cfg, tr = run.config, run.traffic
    mcfg = model_config(cfg)
    audio = {**AUDIO_DEFAULTS, **cfg.get("audio", {})}
    clips, nb_vec = int(tr["clips_per_call"]), int(tr["nb_vec"])
    shape = (clips, mcfg.latent_height, mcfg.latent_width * nb_vec, mcfg.rand_channels)
    frames = mcfg.latent_width * nb_vec * 2**mcfg.n_stages
    samples = (frames - 1) * audio["stft_stride"]
    return mcfg, audio, clips, shape, frames, samples


def load_program(run, mcfg):
    """The program's generator from the configuration's checkpoint, its
    kernels built first on the card."""
    from musicgan_tpu_torch.generate import load_generator_params
    from musicgan_tpu_torch.ops import _build

    if run.device.type == "cuda":
        seconds = _build.build_all()
        run.log(f"kernels built or found in {seconds:.2f} s")
    return load_generator_params(str(run.root / run.config["checkpoint"]), mcfg, run.device)


def resolved(run, mcfg, z_shape, frames) -> tuple[str, str]:
    from musicgan_tpu_torch.ops.autotune import resolve_conv_impl, resolve_istft_impl

    stage = run.config["stage"]
    impl = resolve_conv_impl(mcfg, z_shape, stage, device=run.device).conv_impl
    return impl, resolve_istft_impl(frames, device=run.device)


def call_work(run, mcfg, batch: int, frames: int):
    """Least times and operations of one synthesis call of ``batch`` clips."""
    cfg, audio = run.config, {**AUDIO_DEFAULTS, **run.config.get("audio", {})}
    precision = cfg["precision"]
    lat = (mcfg.latent_height, frames // 2**mcfg.n_stages)
    gen = generator_units(mcfg.gen_channels, batch, lat, cfg["stage"], ELEM_BYTES[precision])
    voc = vocoder_unit(batch, audio["n_fft"] // 2, frames, audio["n_fft"], audio["stft_stride"])
    peak = PEAK_FLOPS[precision]
    return {"generator_least_s": least_s(gen, peak), "vocoder_least_s": voc.least_s(peak),
            "flops": total(gen).flops + voc.flops, "peak_flops": peak}


def observe_images(gen) -> dict:
    """Wrap ``gen.forward_nchw`` on this instance so that ``box["last"]``
    holds the image of the latest call (the same tensor, not a copy)."""
    box = {"last": None}
    inner = gen.forward_nchw

    def forward_nchw(*args, **kwargs):
        box["last"] = inner(*args, **kwargs)
        return box["last"]

    gen.forward_nchw = forward_nchw
    return box


def judge(run, items) -> None:
    """``items``: ``(waves, image, z)`` of the clips compared (``image``
    None where it was not observed).  Sets the checks ``image_gap`` and
    ``wave_gap``: the worst clip's relative 2-norm against the reference's
    generator on ``z`` and its vocoder on ``image``."""
    cfg, dev = run.config, run.device
    n_blocks = int(cfg["stage"]) + 1
    weights = ref.load_generator(str(run.root / cfg["checkpoint"]), n_blocks, dev)
    img_gaps, wave_gaps = [], []
    with torch.no_grad(), numerics("float32", dev):
        for waves, image, z in items:
            z = z.to(dev)
            for a in range(0, len(z), 4):
                img_gaps += compare.rel_gaps(None if image is None else image[a : a + 4],
                                             ref.generator_image(weights, z[a : a + 4], n_blocks))
                if image is None or waves is None:
                    wave_gaps += [float("inf")] * len(z[a : a + 4])
                else:
                    wave_gaps += compare.rel_gaps(waves[a : a + 4], ref.vocode(image[a : a + 4].to(dev)))
    run.facts["clips_compared"] = len(img_gaps)
    limits = cfg["limits"]
    run.checks["image_gap"] = (max(img_gaps), limits["image_gap"])
    run.checks["wave_gap"] = (max(wave_gaps), limits["wave_gap"])


def setup(run):
    mcfg, audio, clips, shape, frames, samples = _geometry(run)
    tr, dev = run.traffic, run.device
    from musicgan_tpu_torch.generate import synthesize_fn

    gen = load_program(run, mcfg)
    synth = synthesize_fn(mcfg, run.config["stage"])
    g = device_generator(run.seed, 1, dev)
    for _ in range(int(tr.get("warmup_calls", 2))):
        synth(gen, torch.randn(shape, generator=g, device=dev))
    impl, vocoder = resolved(run, mcfg, shape, frames)
    run.log(f"conv_impl {impl}, vocoder {vocoder}")
    box = observe_images(gen)
    pick = rng(run.seed, 2)
    first = int(tr["sample_from_first"])
    sample = set(int(i) for i in pick.choice(first, size=int(tr["sampled_calls"]), replace=False))
    pin = dev.type == "cuda"
    copier = torch.cuda.Stream(dev) if pin else None
    ahead = int(tr["queue_ahead"])
    ring = [torch.empty((clips, samples), dtype=torch.float32, pin_memory=pin) for _ in range(ahead + 2)]
    kept = {i: torch.empty((clips, samples), dtype=torch.float32, pin_memory=pin) for i in sample}
    return {"gen": gen, "synth": synth, "g": g, "shape": shape, "ring": ring, "kept": kept, "box": box,
            "ahead": ahead, "mcfg": mcfg, "frames": frames, "samples": samples, "clips": clips,
            "rate": audio["sample_rate"], "impl": impl, "copier": copier}


def copy_out(waves: torch.Tensor, dest: torch.Tensor, copier) -> Completion:
    """Queue the copy of ``waves`` into ``dest`` on ``copier`` after the
    work that made them; a mark of its end (on the CPU, a plain copy)."""
    if copier is None:
        dest.copy_(waves)
        return Completion(waves.device)
    copier.wait_stream(torch.cuda.current_stream(waves.device))
    with torch.cuda.stream(copier):
        dest.copy_(waves, non_blocking=True)
        waves.record_stream(copier)
        return Completion(waves.device)


def window(run, st):
    dev, synth, gen, shape = run.device, st["synth"], st["gen"], st["shape"]
    ring, kept, ahead = st["ring"], st["kept"], st["ahead"]
    pending = deque()
    recent = deque(maxlen=len(ring))  # (call, buffer, latents, image) of the calls in flight or just done
    observed = {}
    done, issued, last_done = 0, 0, None
    with run.measure():
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        t_last = t0
        while True:
            z = torch.randn(shape, generator=st["g"], device=dev)
            with run.span("port_bench.synthesize_fn"):
                waves = synth(gen, z)
            dest = kept.get(issued, ring[issued % len(ring)])
            with run.span("port_bench.copy_to_host"):
                pending.append((issued, copy_out(waves, dest, st["copier"])))
            if issued in kept:
                observed[issued] = (z, st["box"]["last"])
            recent.append((issued, dest, z, st["box"]["last"]))
            issued += 1
            del waves
            if len(pending) > ahead:
                i, mark = pending.popleft()
                with run.span("port_bench.wait"):
                    t_last = mark.wait()
                done += 1
                last_done = i
                if t_last >= deadline:
                    break
    for _, mark in pending:
        mark.wait()
    window_s = t_last - t0
    audio_s = done * st["clips"] * st["samples"] / st["rate"]
    run.end_to_end["synth_audio_s_per_s"] = audio_s / window_s
    run.attempted, run.failed = issued, 0
    run.facts.update(calls_completed=done, calls_issued=issued, window_s=window_s, audio_s=audio_s,
                     conv_impl=st["impl"], units_done=done,
                     **call_work(run, st["mcfg"], st["clips"], st["frames"]))
    # The last completed call's buffer is not reused by the calls drained
    # after it (``ahead + 2`` buffers in the ring).
    st["compare"] = {j: (kept[j], *observed[j]) for j in kept if j < done}
    st["compare"].update({j: (dest, z, image) for j, dest, z, image in recent if j == last_done})


def check(run, st):
    """Free the program, then judge every clip of the calls compared."""
    compared = [(waves, image, z) for _, (waves, z, image) in sorted(st.pop("compare").items())]
    for key in ("gen", "synth", "ring", "box", "copier"):
        st.pop(key, None)
    free_device(run.device)
    judge(run, compared)
