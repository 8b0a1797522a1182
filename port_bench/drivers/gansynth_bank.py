"""A sample bank: GANSynth rendering every pitch of a few timbres.

Each call is ``synthesize_fn(cfg, stage)(gen, z, labels)`` on
``instruments`` latents drawn from the seed, each repeated over all
``pitches`` of the configuration's range (label ``k`` is MIDI pitch
``first_midi + k``), as a musician building a sampler's bank renders one
timbre across its range.  The weights are drawn from the seed
(``reference/gansynth.py::draw_weights``) and handed to the program and the
reference alike.  The pipeline is ``synth_offline``'s: waveforms copied to
pinned host memory on a copy stream, ``queue_ahead`` calls queued beyond
the one the host waits for, the window closed at the first completion past
``--seconds``; the rate is the audio completed on the host (each note's
``crop`` samples) over the whole window.

``correct``: ``sampled_calls`` calls drawn from the seed among the first
``sample_from_first``, and the last call completed, every note, in
``synth_offline``'s two stages: the image inside the timed call against the
reference generator on the same latents and pitches (``image_gap``), and the
waveform against the reference vocoder on that image (``wave_gap``), the
worst note's relative 2-norm (``reference/compare.py``).  The pitch moves
a note's image by little beside the latent, so the image is also held to
the pitch's own effect (``pitch_gap``): the worst note's share of the
reference's change from its image with the one-hot left out that the
program's image misses (:func:`pitch_shares`; 0 for the reference itself,
1 for a program that drops the pitch).

The window's launch counts (the mel products', K5's, and K1's and K3's
that split PixelNorm over a cluster) are kept in ``facts["launches"]``
for the per-layer readers.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from ..reference import compare, gansynth as ref
from ..reference.lower import numerics
from ..work_gansynth import call_work
from .common import device_generator, free_device, rng
from .synth_offline import copy_out, observe_images

__all__ = ["model_config", "program_state", "call_inputs", "launch_counts", "pitch_shares", "judge", "setup", "window",
           "check"]


def model_config(config: dict):
    """The program's ``ModelConfig`` from the file's ``model`` group (its
    ``audio`` group an ``AudioConfig``)."""
    from musicgan_tpu_torch.config import AudioConfig, ModelConfig

    m = dict(config["model"])
    m["gen_channels"] = tuple(tuple(c) for c in m["gen_channels"])
    m["dense_start"] = tuple(m["dense_start"])
    m["audio"] = AudioConfig(**m["audio"])
    return ModelConfig(**m)


def widths(mcfg) -> list[int]:
    """GANSynth's width of each of its blocks, from the regrouped
    ``gen_channels``."""
    return [mcfg.gen_channels[0][0]] + [cout for _, cout in mcfg.gen_channels]


def reference_weights(run, mcfg) -> dict:
    g = device_generator(run.seed, 3, run.device)
    return ref.draw_weights(widths(mcfg), mcfg.rand_channels, mcfg.n_classes, mcfg.dense_start, g, run.device)


def program_state(weights: dict, n_blocks: int) -> dict:
    """The reference's weights under the program's names: GANSynth block
    ``k``'s first conv is ``GenBlock`` ``k - 2``'s ``conv2``, its second
    ``GenBlock`` ``k - 1``'s ``conv1`` (the last block's, the tail)."""
    names = {"b1.dense": "dense", "b1.conv": "blocks.0.conv1", "to_rgb": "heads.0"}
    for k in range(2, n_blocks + 2):
        names[f"b{k}.conv0"] = f"blocks.{k - 2}.conv2"
        names[f"b{k}.conv1"] = f"blocks.{k - 1}.conv1" if k <= n_blocks else "tail.conv"
    state = {}
    for src, dst in names.items():
        state[f"{dst}.weight"], state[f"{dst}.bias"] = weights[src]
    return state


def load_program(run, mcfg, weights):
    """The program's generator holding ``weights``, its kernels built first
    on the card."""
    from musicgan_tpu_torch.models import Generator
    from musicgan_tpu_torch.ops import _build

    if run.device.type == "cuda":
        seconds = _build.build_all()
        run.log(f"kernels built or found in {seconds:.2f} s")
    gen = Generator(mcfg, device=run.device)
    gen.load_state_dict(program_state(weights, mcfg.n_stages))
    return gen.eval()


def call_inputs(run, latents: torch.Tensor):
    """``(instruments, 1, 1, C)`` latents -> each repeated over the pitches:
    ``(instruments * pitches, 1, 1, C)`` and the labels, pitch fastest."""
    pitches = int(run.traffic["pitches"])
    labels = torch.arange(pitches, device=latents.device).repeat(latents.shape[0])
    return latents.repeat_interleave(pitches, dim=0), labels


def launch_counts() -> dict:
    """The program's counters: the mel products and K5 (the readers'
    calls) and the K1 / K3 launches that split PixelNorm over a cluster."""
    from musicgan_tpu_torch.audio import functions
    from musicgan_tpu_torch.ops import conv, istft_fused

    return {"mel": functions.mel_to_linear.launches, "istft": istft_fused.istft_fused.launches,
            "conv3x3_cluster": conv.fused_conv3x3.cluster_launches,
            "upconv3x3_cluster": conv.fused_upconv3x3.cluster_launches}


def pitch_shares(got, want: torch.Tensor, unpitched: torch.Tensor) -> list[float]:
    """Per note: ``|<want - got, d>| / <d, d>``, ``d = want - unpitched``,
    the reference's image less its image with the one-hot left out: the
    share of the pitch's own effect that ``got`` misses along it.  A note
    missing, of another shape or not finite reads infinity."""
    if got is None or got.shape != want.shape:
        return [float("inf")] * len(want)
    out = []
    for g, w, u in zip(got.to(want.device, torch.float32), want, unpitched):
        d = (w - u).flatten()
        share = torch.dot((w - g).flatten(), d).abs() / torch.dot(d, d)
        out.append(float(share) if bool(torch.isfinite(g).all()) else float("inf"))
    return out


def judge(run, items, weights) -> None:
    """``items``: ``(waves, image, latents)`` of the calls compared (``image``
    None where it was not observed).  Sets the checks ``image_gap`` and
    ``wave_gap``, the worst note's relative 2-norm against the reference's
    generator on the call's latents and pitches and its vocoder on
    ``image``, and ``pitch_gap`` (:func:`pitch_shares`)."""
    cfg, dev = run.config, run.device
    mcfg = model_config(cfg)
    acfg = mcfg.audio_config
    img_gaps, wave_gaps, pitch_gaps = [], [], []

    def reference(z, labels):
        return ref.generator_image(weights, z, labels, mcfg.n_classes, mcfg.leaky_slope, mcfg.pixel_norm_eps)

    with torch.no_grad(), numerics("float32", dev):
        for waves, image, latents in items:
            z, labels = call_inputs(run, latents.to(dev))
            for a in range(0, len(z), 8):
                got = None if image is None else image[a : a + 8]
                want = reference(z[a : a + 8], labels[a : a + 8])
                img_gaps += compare.rel_gaps(got, want)
                pitch_gaps += pitch_shares(got, want, reference(z[a : a + 8], None))
                if image is None or waves is None:
                    wave_gaps += [float("inf")] * len(z[a : a + 8])
                else:
                    wave_gaps += compare.rel_gaps(waves[a : a + 8], ref.vocode(
                        image[a : a + 8].to(dev), acfg.n_fft, acfg.stft_stride, acfg.sample_rate, acfg.crop))
    run.facts["notes_compared"] = len(img_gaps)
    limits = cfg["limits"]
    run.checks["image_gap"] = (max(img_gaps), limits["image_gap"])
    run.checks["wave_gap"] = (max(wave_gaps), limits["wave_gap"])
    run.checks["pitch_gap"] = (max(pitch_gaps), limits["pitch_gap"])


def setup(run):
    from musicgan_tpu_torch.generate import synthesize_fn
    from musicgan_tpu_torch.ops.autotune import resolve_conv_impl, resolve_istft_impl

    tr, dev = run.traffic, run.device
    mcfg = model_config(run.config)
    acfg = mcfg.audio_config
    weights = reference_weights(run, mcfg)
    gen = load_program(run, mcfg, weights)
    stage = int(run.config["stage"])
    synth = synthesize_fn(mcfg, stage)
    notes = int(tr["instruments"]) * int(tr["pitches"])
    shape = (int(tr["instruments"]), 1, 1, mcfg.rand_channels)
    g = device_generator(run.seed, 1, dev)
    for _ in range(int(tr.get("warmup_calls", 2))):
        synth(gen, *call_inputs(run, torch.randn(shape, generator=g, device=dev)))
    z_shape = (notes, 1, 1, mcfg.rand_channels)
    impl = resolve_conv_impl(mcfg, z_shape, stage, device=dev).conv_impl
    vocoder = resolve_istft_impl(mcfg.frames((1, 1)), n_bins=acfg.n_fft // 2 + 1, device=dev, n_fft=acfg.n_fft,
                                 hop=acfg.stft_stride)
    run.log(f"conv_impl {impl}, vocoder {vocoder}")
    box = observe_images(gen)
    pick = rng(run.seed, 2)
    sample = set(int(i) for i in pick.choice(int(tr["sample_from_first"]), size=int(tr["sampled_calls"]),
                                             replace=False))
    pin = dev.type == "cuda"
    copier = torch.cuda.Stream(dev) if pin else None
    ahead = int(tr["queue_ahead"])
    samples = acfg.crop or (mcfg.frames((1, 1)) - 1) * acfg.stft_stride
    ring = [torch.empty((notes, samples), dtype=torch.float32, pin_memory=pin) for _ in range(ahead + 2)]
    kept = {i: torch.empty((notes, samples), dtype=torch.float32, pin_memory=pin) for i in sample}
    return {"gen": gen, "synth": synth, "g": g, "shape": shape, "ring": ring, "kept": kept, "box": box,
            "ahead": ahead, "mcfg": mcfg, "notes": notes, "samples": samples, "rate": acfg.sample_rate,
            "impl": impl, "copier": copier, "weights": weights}


def window(run, st):
    dev, synth, gen, shape = run.device, st["synth"], st["gen"], st["shape"]
    ring, kept, ahead = st["ring"], st["kept"], st["ahead"]
    pending = deque()
    recent = deque(maxlen=len(ring))  # (call, buffer, latents, image) of the calls in flight or just done
    observed = {}
    done, issued, last_done = 0, 0, None
    before = launch_counts()
    with run.measure():
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        t_last = t0
        while True:
            latents = torch.randn(shape, generator=st["g"], device=dev)
            z, labels = call_inputs(run, latents)
            with run.span("port_bench.synthesize_fn"):
                waves = synth(gen, z, labels)
            dest = kept.get(issued, ring[issued % len(ring)])
            with run.span("port_bench.copy_to_host"):
                pending.append((issued, copy_out(waves, dest, st["copier"])))
            if issued in kept:
                observed[issued] = (latents, st["box"]["last"])
            recent.append((issued, dest, latents, st["box"]["last"]))
            issued += 1
            del waves, z
            if len(pending) > ahead:
                i, mark = pending.popleft()
                with run.span("port_bench.wait"):
                    t_last = mark.wait()
                done += 1
                last_done = i
                if t_last >= deadline:
                    break
    after = launch_counts()
    run.log("launches in the window: " + ", ".join(f"{k} {after[k] - before[k]}" for k in after))
    for _, mark in pending:
        mark.wait()
    window_s = t_last - t0
    audio_s = done * st["notes"] * st["samples"] / st["rate"]
    run.end_to_end["synth_audio_s_per_s"] = audio_s / window_s
    run.attempted, run.failed = issued, 0
    run.facts.update(calls_completed=done, calls_issued=issued, window_s=window_s, audio_s=audio_s,
                     conv_impl=st["impl"], units_done=done,
                     launches={k: after[k] - before[k] for k in after},
                     **call_work(st["mcfg"], st["notes"], run.config["precision"]))
    # The last completed call's buffer is not reused by the calls drained
    # after it (``ahead + 2`` buffers in the ring).
    st["compare"] = {j: (kept[j], *observed[j]) for j in kept if j < done}
    st["compare"].update({j: (dest, lat, image) for j, dest, lat, image in recent if j == last_done})


def check(run, st):
    """Free the program, then judge every note of the calls compared."""
    compared = [(waves, image, latents) for _, (waves, latents, image) in sorted(st.pop("compare").items())]
    for key in ("gen", "synth", "ring", "box", "copier"):
        st.pop(key, None)
    free_device(run.device)
    judge(run, compared, st["weights"])
