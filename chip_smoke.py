#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit (``nvcc``).  Phases, each of which raises on failure:

1. print the card's name and power limit; build every kernel from
   ``musicgan_tpu_torch/csrc`` (one ``nvcc`` per source, all at once);
2. at the main path's shapes (5 clips x nb_vec 10, the full-width
   generator of ``saved_models/quality_r4/gen_final.pt``): hold each kernel
   against its plain PyTorch version on the card (TF32 off), and time the
   kernel, the plain version and one PyTorch library call computing the
   same function (the yardstick, used nowhere in the port);
3. run ``generate`` end to end through the entry point, with every launch
   counter set to 0 just before and read just after; check the five WAVs
   and hold the waveforms against the same latents through the plain
   versions on the card (with the counters showing that the kernel pass
   launched every kernel and the plain pass none); time warm runs.

The last lines are a ``{"kernels": [...]}`` record, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.  Per-shape numbers also go
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from musicgan_tpu_torch import generate as generate_mod
from musicgan_tpu_torch.audio import load_wav
from musicgan_tpu_torch.audio.stft import hann_window, istft_real_imag
from musicgan_tpu_torch.config import AudioConfig, ModelConfig
from musicgan_tpu_torch.models import load_reference_generator
from musicgan_tpu_torch.models.layers import upsample_nearest_2x
from musicgan_tpu_torch.ops import _build
from musicgan_tpu_torch.ops import conv as conv_ops
from musicgan_tpu_torch.ops import istft_fused as istft_ops

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "saved_models" / "quality_r4" / "gen_final.pt"
NB_MUSIC, NB_VEC, SEED = 5, 10, 0
WARM_REPS = 20  # warm synthesis calls timed one by one; the median is quoted

# H100 SXM published peaks: float32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# Kernel vs plain version, both float32 on the card: the sums run in
# another order (K up to 9 * 128 = 1152 products for the convs, 4104 for
# the iSTFT), about 1e-6 relative on outputs of order 1.
TOL = {"fused_conv3x3": 1e-4, "fused_upconv3x3": 1e-4, "istft_fused": 2e-4}
# End to end, kernels vs plain versions on the same latents.  The image:
# each conv disagrees by up to ~1.3e-5 (the per-shape check above), and
# 16 convs compound it; an H100 showed 8.8e-4, so 2e-3.  The waveform: the
# phase channel is a frequency prefix-summed over 5,120 frames, so an image
# error e is a phase error that walks like pi * e * sqrt(n) radians, times
# a magnitude that peaks near 0.05 for this generator; an H100 showed
# 4.3e-5, held at 1e-3 (2% of the peak amplitude).
TOL_IMAGE, TOL_WAVE = 2e-3, 1e-3

SOURCES = {
    "fused_conv3x3": ("musicgan_tpu_torch/csrc/conv3x3.cu", "musicgan_tpu/ops/conv.py:90"),
    "fused_upconv3x3": ("musicgan_tpu_torch/csrc/upconv3x3.cu", "musicgan_tpu/ops/conv.py:139"),
    "istft_fused": ("musicgan_tpu_torch/csrc/istft.cu", "musicgan_tpu/ops/istft_pallas.py:60"),
}
WRAPPERS = {
    "fused_conv3x3": conv_ops.fused_conv3x3,
    "fused_upconv3x3": conv_ops.fused_upconv3x3,
    "istft_fused": istft_ops.istft_fused,
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def main_path_latent(cfg: ModelConfig, dev) -> torch.Tensor:
    """The latents ``generate`` draws at the CLI defaults from ``SEED``."""
    return torch.randn(
        (NB_MUSIC, cfg.latent_height, cfg.latent_width * NB_VEC, cfg.rand_channels),
        generator=torch.Generator(device=dev).manual_seed(SEED), device=dev,
    )


def time_ms(fn) -> float:
    """Mean device time of ``fn`` by CUDA events, after a warm-up call;
    enough repetitions to cover about 50 ms."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = int(min(50, max(3, math.ceil(50.0 / max(start.elapsed_time(end), 1e-3)))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def measure(name, shape, kernel, plain, library, flops, nbytes):
    """One kernel at one main-path shape: error against the plain version
    (raises past the tolerance) and the three times."""
    err = (kernel() - plain()).abs().max().item()
    if not err <= TOL[name]:
        raise AssertionError(f"{name} {shape}: max abs err {err:.3e} > {TOL[name]:.0e}")
    b, by = bound_ms(flops, nbytes)
    row = {
        "name": name, "shape": shape, "max_abs_err": err,
        "ms": time_ms(kernel), "plain_ms": time_ms(plain),
        "library_ms": time_ms(library), "bound_ms": b, "bound_by": by,
        "flops": flops, "bytes": nbytes,
    }
    print(
        f"[kernel] {name:16s} {str(shape):26s} err {err:.2e}  kernel {row['ms']:.4f} ms"
        f"  plain {row['plain_ms']:.4f}  library {row['library_ms']:.4f}"
        f"  bound {b:.4f} ({by})"
    )
    return row


def check_kernels(gen, cfg: ModelConfig, dev) -> list[dict]:
    """Phase 2: every kernel at every shape the main path gives it."""
    rng = torch.Generator(device=dev).manual_seed(1)
    slope, eps = cfg.leaky_slope, cfg.pixel_norm_eps
    rows = []
    h, w = cfg.latent_height, cfg.latent_width * NB_VEC
    for i, (cin, cout) in enumerate(cfg.gen_channels):
        blk = gen.blocks[i]
        x = torch.randn(NB_MUSIC, cin, h, w, generator=rng, device=dev)
        w1, b1 = blk.conv1.weight.detach(), blk.conv1.bias.detach()
        w1p = conv_ops.pack_weights(w1)
        px = NB_MUSIC * h * w
        rows.append(measure(
            "fused_conv3x3", (NB_MUSIC, cin, cin, h, w),
            lambda: conv_ops.fused_conv3x3(x, w1, b1, slope, True, eps, w_packed=w1p),
            lambda: conv_ops.conv3x3_plain(x, w1, b1, slope, True, eps),
            lambda: F.conv2d(x, w1, b1, padding=1),
            2.0 * px * cin * 9 * cin, 4.0 * (2 * px * cin + 9 * cin * cin + cin),
        ))
        w2, b2 = blk.conv2.weight.detach(), blk.conv2.bias.detach()
        w2p = conv_ops.pack_upconv_weights(w2)
        xu = upsample_nearest_2x(x)
        rows.append(measure(
            "fused_upconv3x3", (NB_MUSIC, cin, cout, h, w),
            lambda: conv_ops.fused_upconv3x3(x, w2, b2, slope, True, eps, w_packed=w2p),
            lambda: conv_ops.upconv3x3_plain(x, w2, b2, slope, True, eps),
            lambda: F.conv2d(xu, w2, b2, padding=1),
            2.0 * 4 * px * cout * 4 * cin,
            4.0 * (px * cin + 4 * px * cout + 16 * cin * cout + cout),
        ))
        del xu
        h, w = 2 * h, 2 * w

    acfg = AudioConfig()
    n_fft, hop = acfg.n_fft, acfg.stft_stride
    n_bins, t, r = n_fft // 2 + 1, w, n_fft // hop
    re = torch.randn(NB_MUSIC, n_bins, t, generator=rng, device=dev)
    im = torch.randn(NB_MUSIC, n_bins, t, generator=rng, device=dev)
    spec = torch.complex(re, im)
    window = torch.from_numpy(hann_window(n_fft)).to(dev)
    rows.append(measure(
        "istft_fused", (NB_MUSIC, n_bins, t),
        lambda: istft_ops.istft_fused(re, im, n_fft, hop),
        lambda: istft_real_imag(re, im, n_fft, hop),
        lambda: torch.istft(spec, n_fft, hop, window=window, center=True, normalized=True),
        2.0 * NB_MUSIC * (t + r - 1) * hop * r * 2 * n_bins,
        4.0 * (2 * NB_MUSIC * n_bins * t + 2 * n_bins * n_fft + NB_MUSIC * (t - 1) * hop),
    ))
    return rows


def plain_on_card():
    """Route the synthesis path through the plain versions, on CUDA tensors
    too, for the end-to-end comparison; the caller checks by the launch
    counters that no kernel ran."""
    return [
        mock.patch.object(conv_ops, "fused_conv3x3", lambda *a, w_packed=None: conv_ops.conv3x3_plain(*a)),
        mock.patch.object(conv_ops, "fused_upconv3x3", lambda *a, w_packed=None: conv_ops.upconv3x3_plain(*a)),
        mock.patch.object(generate_mod, "istft_fused", istft_real_imag),
    ]


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def end_to_end(cfg: ModelConfig, dev) -> dict:
    """Phase 3: ``generate`` through the entry point, counted."""
    acfg = AudioConfig()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    reset_launches()
    t0 = time.perf_counter()
    paths = generate_mod.generate(
        out_dir, cfg.rand_channels, str(CKPT), nb_vec=NB_VEC, nb_music=NB_MUSIC,
        seed=SEED, device="cuda",
    )
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"[e2e] generate wrote {len(paths)} WAVs in {cold_s:.2f} s; launches {launches}")
    expect = {"fused_conv3x3": cfg.n_stages, "fused_upconv3x3": cfg.n_stages, "istft_fused": 1}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")

    n_samples = (cfg.latent_width * NB_VEC * 2 ** cfg.n_stages - 1) * acfg.stft_stride
    waves = []
    for p in paths:
        wave, sr = load_wav(p)
        if sr != acfg.sample_rate or wave.shape != (n_samples,):
            raise AssertionError(f"{p}: {sr} Hz, {wave.shape} samples")
        if not np.isfinite(wave).all() or np.abs(wave).max() < 1e-3:
            raise AssertionError(f"{p}: non-finite or silent waveform")
        waves.append(wave)
    clip_s = n_samples / acfg.sample_rate
    print(f"[e2e] {len(paths)} clips of {clip_s:.3f} s, peak |x| "
          f"{max(float(np.abs(w).max()) for w in waves):.4f}")

    # The same latents through the plain versions on the card.
    gen = load_reference_generator(str(CKPT), cfg, device=dev)
    z = main_path_latent(cfg, dev)
    synth = generate_mod.synthesize_fn(cfg, cfg.n_stages - 1)
    reset_launches()
    with torch.no_grad():
        img = gen.forward_nchw(z.permute(0, 3, 1, 2), cfg.n_stages - 1)
    if read_launches() != {**expect, "istft_fused": 0}:
        raise AssertionError(f"kernel forward launched {read_launches()}")
    patches = plain_on_card()
    for p in patches:
        p.start()
    reset_launches()
    try:
        with torch.no_grad():
            img_plain = gen.forward_nchw(z.permute(0, 3, 1, 2), cfg.n_stages - 1)
        waves_plain = synth(gen, z).cpu().numpy()
    finally:
        for p in patches:
            p.stop()
    if any(read_launches().values()):
        raise AssertionError(f"the plain pass launched kernels: {read_launches()}")
    err_img = (img - img_plain).abs().max().item()
    err_wave = float(np.abs(np.stack(waves) - waves_plain).max())
    print(f"[e2e] kernels vs plain on the card: image err {err_img:.3e} "
          f"(tol {TOL_IMAGE:.0e}), waveform err {err_wave:.3e} (tol {TOL_WAVE:.0e})")
    if not (err_img <= TOL_IMAGE and err_wave <= TOL_WAVE):
        raise AssertionError("end-to-end output disagrees with the plain versions")

    # Warm runs, each timed alone to the end of its device work: synthesis
    # (WARM_REPS calls), then the whole entry point (5 calls).
    synth(gen, z)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    synth_s = []
    for _ in range(WARM_REPS):
        t0 = time.perf_counter()
        synth(gen, z)
        torch.cuda.synchronize()
        synth_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    gen_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        generate_mod.generate(
            out_dir, cfg.rand_channels, str(CKPT), nb_vec=NB_VEC, nb_music=NB_MUSIC,
            seed=SEED, device="cuda",
        )
        gen_s.append(time.perf_counter() - t0)
    audio_s = NB_MUSIC * clip_s
    med_synth, med_gen = float(np.median(synth_s)), float(np.median(gen_s))
    print(f"[e2e] warm synthesis, median of {WARM_REPS}: {med_synth * 1e3:.3f} ms "
          f"(min {min(synth_s) * 1e3:.3f}, max {max(synth_s) * 1e3:.3f}) = "
          f"{audio_s / med_synth:.1f} audio-s/s; warm generate (load + synthesis + WAV "
          f"writes), median of 5: {med_gen:.4f} s (min {min(gen_s):.4f}, max {max(gen_s):.4f}) = "
          f"{audio_s / med_gen:.1f} audio-s/s; peak device memory {peak / 2**30:.3f} GiB")
    return {
        "launches": launches, "cold_generate_s": cold_s,
        "warm_synthesis_s": synth_s, "warm_synthesis_median_s": med_synth,
        "warm_generate_s": gen_s, "warm_generate_median_s": med_gen, "audio_s": audio_s, "peak_bytes": peak,
        "err_image": err_img, "err_wave": err_wave,
    }


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    card = card_line()
    print(f"[card] {card}")
    dev = torch.device("cuda")
    # The plain versions and the library yardsticks run in float32, not TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[build] kernels built in {_build.build_all():.2f} s")

    cfg = ModelConfig()
    gen = load_reference_generator(str(CKPT), cfg, device=dev)
    rows = check_kernels(gen, cfg, dev)
    del gen
    e2e = end_to_end(cfg, dev)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        mine = [r for r in rows if r["name"] == name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": e2e["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{k: sum(r[k] for r in mine) for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "operations" if sum(r["flops"] for r in mine) / PEAK_FP32_FLOPS
            >= sum(r["bytes"] for r in mine) / PEAK_BYTES_S else "bytes",
        })
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "shapes": rows, "end_to_end": e2e, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
