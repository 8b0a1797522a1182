#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis path and its WGAN-GP train step on
one NVIDIA GPU.

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

4. at the train step's shapes (stage 7, batch 6, full width): K2 at the 16
   generator convs, K1 at the 18 critic convs (up to 160 channels) and at
   every input-gradient conv (swapped channels, no bias), each against its
   plain version, with the three times as in phase 2;
5. the trainable conv ``conv3x3_act`` on the card: its input, weight and
   bias gradients against autograd through the plain version; the
   hand-unrolled gradient-penalty input gradient at stage 7 against
   ``torch.autograd.grad`` through the plain critic, value and the outer
   parameter gradient of the penalty;
6. the train path through its entry points: ``init_train_state``, 10
   iterations of ``build_step(7, ...)`` in the n_critic pattern and one
   ``build_chunk_step(0, 10)``, launch counters set to 0 before and held
   against the counts the architecture gives after; the first D+G
   iteration again from the same state and noise through the plain
   versions on the card; warm timings.

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
from musicgan_tpu_torch.config import AudioConfig, ModelConfig, TrainConfig
from musicgan_tpu_torch.models import (
    Discriminator,
    critic_input_grad_nchw_train,
    load_reference_generator,
)
from musicgan_tpu_torch.models.layers import upsample_nearest_2x
from musicgan_tpu_torch.ops import _build
from musicgan_tpu_torch.ops import conv as conv_ops
from musicgan_tpu_torch.ops import conv_vjp
from musicgan_tpu_torch.ops import istft_fused as istft_ops
from musicgan_tpu_torch.train import build_chunk_step, build_step, init_train_state

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
TOL = {
    "fused_conv3x3": 1e-4, "fused_conv3x3_msq": 1e-4, "fused_upconv3x3": 1e-4,
    "istft_fused": 2e-4,
}
TOL_MSQ_REL = 1e-4  # K2's mean-square map, relative to its largest value
# End to end, kernels vs plain versions on the same latents.  The image:
# each conv disagrees by up to ~1.3e-5 (the per-shape check above), and
# 16 convs compound it; an H100 showed 8.8e-4, so 2e-3.  The waveform: the
# phase channel is a frequency prefix-summed over 5,120 frames, so an image
# error e is a phase error that walks like pi * e * sqrt(n) radians, times
# a magnitude that peaks near 0.05 for this generator; an H100 showed
# 4.3e-5, held at 1e-3 (2% of the peak amplitude).
TOL_IMAGE, TOL_WAVE = 2e-3, 1e-3

# The train path: stage 7 (512x512), the n_critic pattern over 10 iterations
# (two of them train the generator), then one chunk of 10 at stage 0 (4x4).
TRAIN_STAGE, TRAIN_ITERS, CHUNK = 7, 10, 10
TRAIN_ALPHA = 0.5  # mid fade-in: both heads of each network are live
TIMED_ITERS = 10   # warm iterations of each kind; the median is quoted
# The three gradients of conv3x3_act, kernels vs cuDNN in float32 on the
# card, each relative to the reference's largest value.  LeakyReLU's
# gradient jumps at 0, and of 50 million pre-activations a few lie within
# the two convs' rounding difference of it; there the two passes take
# different sides and the gradients differ by order 1 around that pixel.  So
# the reference takes the kernel's own sign mask, the check reports how many
# signs differed, and what is left is the convs' rounding: ~1e-6.
TOL_GRAD_REL = 1e-4
# Whole backward passes (the hand-unrolled penalty gradient against double
# backward through the plain critic; a train iteration's gradients against
# the plain versions) cannot share masks.  They are held in the 2-norm,
# relative to the reference's, where the few pixels on the other side of a
# LeakyReLU count by their share of all pixels.
TOL_BACKWARD_L2 = 1e-2
# One whole iteration, kernels vs plain versions: the repo's own bar for
# two lowerings of the train step (tests/test_ops_vjp.py).
TOL_METRIC_REL, TOL_METRIC_ABS = 1e-3, 1e-4

SOURCES = {
    "fused_conv3x3": ("musicgan_tpu_torch/csrc/conv3x3.cu", "musicgan_tpu/ops/conv.py:90"),
    "fused_conv3x3_msq": ("musicgan_tpu_torch/csrc/conv3x3.cu", "musicgan_tpu/ops/conv.py:625"),
    "fused_upconv3x3": ("musicgan_tpu_torch/csrc/upconv3x3.cu", "musicgan_tpu/ops/conv.py:139"),
    "istft_fused": ("musicgan_tpu_torch/csrc/istft.cu", "musicgan_tpu/ops/istft_pallas.py:60"),
}
WRAPPERS = {
    "fused_conv3x3": conv_ops.fused_conv3x3,
    "fused_conv3x3_msq": conv_ops.fused_conv3x3_msq,
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


def measure(name, shape, kernel, plain, library, flops, nbytes, role="synthesis"):
    """One kernel at one main-path shape: error against the plain version
    (raises past the tolerance) and the three times."""
    err = (kernel() - plain()).abs().max().item()
    if not err <= TOL[name]:
        raise AssertionError(f"{name} {shape}: max abs err {err:.3e} > {TOL[name]:.0e}")
    b, by = bound_ms(flops, nbytes)
    row = {
        "name": name, "role": role, "shape": shape, "max_abs_err": err,
        "ms": time_ms(kernel), "plain_ms": time_ms(plain),
        "library_ms": time_ms(library), "bound_ms": b, "bound_by": by,
        "flops": flops, "bytes": nbytes,
    }
    print(
        f"[kernel] {name:17s} {role:10s} {str(shape):26s} err {err:.2e}  kernel {row['ms']:.4f} ms"
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
    expect = {
        "fused_conv3x3": cfg.n_stages, "fused_conv3x3_msq": 0,
        "fused_upconv3x3": cfg.n_stages, "istft_fused": 1,
    }
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


def conv_rows(name, role, shapes, rng, dev, slope, bias):
    """K1 or K2 at ``shapes`` = ``[(B, cin, cout, H, W), ...]``, called as
    the train step calls it (OIHW weights, packed inside the wrapper)."""
    rows = []
    for bsz, cin, cout, h, w in shapes:
        x = torch.randn(bsz, cin, h, w, generator=rng, device=dev)
        wt = torch.randn(cout, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
        b = torch.randn(cout, generator=rng, device=dev) * 0.1 if bias else None
        px = bsz * h * w
        flops = 2.0 * px * cout * 9 * cin
        nbytes = 4.0 * (px * cin + px * cout + 9 * cin * cout + (cout if bias else 0))
        if name == "fused_conv3x3_msq":
            m, m_ref = conv_ops.fused_conv3x3_msq(x, wt, b, slope, 1e-8)[1], conv_ops.conv3x3_msq_plain(x, wt, b, slope, 1e-8)[1]
            m_rel = ((m - m_ref).abs().max() / m_ref.abs().max()).item()
            if not m_rel <= TOL_MSQ_REL:
                raise AssertionError(f"{name} {(bsz, cin, cout, h, w)}: mean-square map rel err {m_rel:.3e}")
            row = measure(
                name, (bsz, cin, cout, h, w),
                lambda: conv_ops.fused_conv3x3_msq(x, wt, b, slope, 1e-8)[0],
                lambda: conv_ops.conv3x3_msq_plain(x, wt, b, slope, 1e-8)[0],
                lambda: F.conv2d(x, wt, b, padding=1), flops, nbytes + 4.0 * px, role,
            )
            row["msq_rel_err"] = m_rel
        else:
            row = measure(
                name, (bsz, cin, cout, h, w),
                lambda: conv_ops.fused_conv3x3(x, wt, b, slope),
                lambda: conv_ops.conv3x3_plain(x, wt, b, slope),
                lambda: F.conv2d(x, wt, b, padding=1), flops, nbytes, role,
            )
        rows.append(row)
    return rows


def train_conv_shapes(cfg: ModelConfig, batch: int, stage: int):
    """``(generator convs, critic convs)`` of one iteration at ``stage``,
    each ``(B, cin, cout, H, W)`` in forward order."""
    gen, h = [], cfg.latent_height
    for cin, cout in cfg.gen_channels[: stage + 1]:
        gen += [(batch, cin, cin, h, h), (batch, cin, cout, 2 * h, 2 * h)]
        h *= 2
    disc = []
    for cin, cout in cfg.disc_channels[len(cfg.disc_channels) - 2 - stage:]:
        disc += [(batch, cin, cout, h, h), (batch, cout, cout, h // 2, h // 2)]
        h //= 2
    return gen, disc


def check_train_kernels(cfg: ModelConfig, tcfg: TrainConfig, dev) -> list[dict]:
    """Phase 4: every kernel at every shape the train step gives it."""
    rng = torch.Generator(device=dev).manual_seed(2)
    gen, disc = train_conv_shapes(cfg, tcfg.batch_size, TRAIN_STAGE)
    swap = lambda shapes: [(b, cout, cin, h, w) for b, cin, cout, h, w in shapes]  # noqa: E731
    slope = cfg.leaky_slope
    return (
        conv_rows("fused_conv3x3_msq", "gen_fwd", gen, rng, dev, slope, True)
        + conv_rows("fused_conv3x3", "critic_fwd", disc, rng, dev, slope, True)
        + conv_rows("fused_conv3x3", "critic_dx", swap(disc), rng, dev, None, False)
        + conv_rows("fused_conv3x3", "gen_dx", swap(gen[1:]), rng, dev, None, False)
    )


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def rel_l2(got: torch.Tensor, ref: torch.Tensor, floor: float = 1e-30) -> float:
    return ((got - ref).norm() / ref.norm().clamp_min(floor)).item()


def plain_with_mask_of(y_kernel):
    """``conv3x3_act_plain`` with LeakyReLU's mask taken from the signs of
    ``y_kernel`` (the kernel's output) instead of its own pre-activation."""

    def fn(x, w, b, slope, pn, eps):
        u = conv_ops.conv3x3_plain(x, w, b)
        n_diff = 0
        if slope is not None:
            n_diff = int(((u >= 0) != (y_kernel >= 0)).sum())
            u = u * torch.where(y_kernel >= 0, 1.0, slope)
        fn.signs_differing = n_diff
        if pn:
            u = u * torch.rsqrt(torch.mean(torch.square(u), dim=1, keepdim=True) + eps)
        return u

    return fn


def plain_convs():
    """Route ``conv3x3_act`` to its plain version, on CUDA tensors too."""
    return mock.patch.object(conv_vjp, "conv3x3_act", conv_vjp.conv3x3_act_plain)


def check_function_and_gp(cfg: ModelConfig, tcfg: TrainConfig, dev) -> dict:
    """Phase 5: the gradients of ``conv3x3_act`` and the hand-unrolled
    gradient-penalty input gradient, kernels vs plain autograd on the card."""
    rng = torch.Generator(device=dev).manual_seed(3)
    out = {"function": []}
    bsz = tcfg.batch_size
    cases = [  # (B, cin, cout, H, W), slope, PixelNorm: large and small
        ((bsz, 16, 32, 512, 512), cfg.leaky_slope, False),  # critic block 0 conv1
        ((bsz, 32, 16, 512, 512), cfg.leaky_slope, True),   # generator block 7 conv2
        ((bsz, 144, 160, 2, 2), cfg.leaky_slope, False),    # critic block 8 conv1
        ((bsz, 160, 144, 2, 2), None, False),               # its transpose in the penalty
    ]
    for (b, cin, cout, h, w), slope, pn in cases:
        x = torch.randn(b, cin, h, w, generator=rng, device=dev)
        wt = torch.randn(cout, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
        bias = torch.randn(cout, generator=rng, device=dev) * 0.1
        cot = torch.randn(b, cout, h, w, generator=rng, device=dev)
        grads, y_kernel = {}, None
        for name in ("kernel", "plain"):
            fn = conv_vjp.conv3x3_act if name == "kernel" else plain_with_mask_of(y_kernel)
            leaves = [t.clone().requires_grad_(True) for t in (x, wt, bias)]
            reset_launches()
            y = fn(*leaves, slope, pn, cfg.pixel_norm_eps)
            y_kernel = y.detach()
            grads[name] = torch.autograd.grad((y * cot).sum(), leaves)
            n = sum(read_launches().values())
            if n != (2 if name == "kernel" else 0):  # forward + input gradient
                raise AssertionError(f"conv3x3_act ({name}) launched {n} kernels")
        errs = [rel_err(g, r) for g, r in zip(grads["kernel"], grads["plain"])]
        print(f"[function] conv3x3_act {(b, cin, cout, h, w)} slope {slope} pn {pn}: "
              f"rel err dx {errs[0]:.2e} dw {errs[1]:.2e} db {errs[2]:.2e} (tol {TOL_GRAD_REL:.0e}); "
              f"{fn.signs_differing} of {y.numel()} pre-activation signs differ")
        if not max(errs) <= TOL_GRAD_REL:
            raise AssertionError("conv3x3_act gradients disagree with autograd through the plain version")
        out["function"].append({
            "shape": (b, cin, cout, h, w), "pixel_norm": pn, "rel_err_dx_dw_db": errs,
            "signs_differing": fn.signs_differing,
        })

    # The penalty's input gradient at stage 7 (critic stage 0), full width.
    disc = Discriminator(cfg, device=dev, seed=1)
    x = torch.rand(bsz, 512, 512, 2, generator=rng, device=dev) * 2 - 1

    def penalty(g):
        g_norm = torch.sqrt(torch.sum(torch.square(g.reshape(bsz, -1)), dim=1) + 1e-12)
        return torch.mean(torch.square(g_norm - 1.0))

    params = list(disc.parameters())
    reset_launches()
    g_hand = critic_input_grad_nchw_train(disc, x, 0, TRAIN_ALPHA)
    d_hand = torch.autograd.grad(penalty(g_hand), params, allow_unused=True)
    launches = read_launches()["fused_conv3x3"]
    n_convs = 2 * len(cfg.disc_channels)
    if launches != 3 * n_convs:  # recorded forward, transposed convs, their input gradients
        raise AssertionError(f"the hand-unrolled penalty launched K1 {launches} times, not {3 * n_convs}")
    with plain_convs():
        reset_launches()
        xg = x.clone().requires_grad_(True)
        (g_auto,) = torch.autograd.grad(disc(xg, 0, TRAIN_ALPHA).sum(), xg, create_graph=True)
        d_auto = torch.autograd.grad(penalty(g_auto), params, allow_unused=True)
        if any(read_launches().values()):
            raise AssertionError(f"the plain critic launched kernels: {read_launches()}")
    err_g, err_g_max = rel_l2(g_hand.detach(), g_auto.detach()), rel_err(g_hand.detach(), g_auto.detach())
    v_hand, v_auto = penalty(g_hand).item(), penalty(g_auto).item()
    err_outer, worst = 0.0, None
    for (name, _), a, b in zip(disc.named_parameters(), d_hand, d_auto):
        if (a is None) != (b is None):
            raise AssertionError(f"{name}: one penalty gradient is missing")
        if a is not None and rel_l2(a, b) > err_outer:
            err_outer, worst = rel_l2(a, b), name
    print(f"[penalty] critic_input_grad_nchw_train at stage 7: {launches} K1 launches; input gradient "
          f"rel L2 err {err_g:.2e} (max abs, relative: {err_g_max:.2e}); penalty {v_hand:.6f} vs "
          f"{v_auto:.6f}; outer parameter gradient, worst leaf {worst}: rel L2 err {err_outer:.2e} "
          f"(tol {TOL_BACKWARD_L2:.0e})")
    if not (err_g <= TOL_BACKWARD_L2 and err_outer <= TOL_BACKWARD_L2):
        raise AssertionError("the hand-unrolled input gradient disagrees with autograd through the plain critic")
    if not abs(v_hand - v_auto) <= TOL_METRIC_ABS + TOL_METRIC_REL * abs(v_auto):
        raise AssertionError(f"penalty {v_hand!r} vs {v_auto!r}")
    out["penalty"] = {
        "rel_l2_err": err_g, "rel_max_err": err_g_max, "outer_rel_l2_err": err_outer,
        "penalty": [v_hand, v_auto], "launches": launches,
    }
    return out


def expected_train_launches(cfg: ModelConfig, stage: int, n_d_only: int, n_d_and_g: int) -> dict:
    """Launches the architecture gives.  With g = 2 (stage + 1) generator
    convs and c = 2 (stage + 2) critic convs: a critic iteration runs K2 g
    times (the fake batch) and K1 7 c times (two critic forwards and their
    input gradients, 4 c; the penalty's recorded forward, its transposed
    convs and their input gradients, 3 c); a generator iteration adds K2 g
    times and K1 2 c + g - 1 times (critic forward and input gradients, and
    the generator's input gradients but the first conv's, whose input is the
    latent)."""
    g, c = 2 * (stage + 1), 2 * (stage + 2)
    n = n_d_only + n_d_and_g
    return {
        "fused_conv3x3": n * 7 * c + n_d_and_g * (2 * c + g - 1),
        "fused_conv3x3_msq": n * g + n_d_and_g * g,
        "fused_upconv3x3": 0, "istft_fused": 0,
    }


def metrics_floats(metrics: dict) -> dict:
    vals = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in vals.values()):
        raise AssertionError(f"non-finite metrics: {vals}")
    return vals


def first_moments(state) -> dict:
    """Copies of both optimizers' first moments, keyed ``gen.`` / ``disc.``."""
    out = {f"gen.{k}": v.clone() for k, v in state.opt_gen.mu.items()}
    out.update({f"disc.{k}": v.clone() for k, v in state.opt_disc.mu.items()})
    return out


def timed_iterations(step, state, x, n: int) -> list[float]:
    """``n`` warm calls, each timed to the end of its device work."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, x, TRAIN_ALPHA)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def train_path(cfg: ModelConfig, tcfg: TrainConfig, dev) -> dict:
    """Phase 6: the train step through its entry points, counted."""
    rng = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(tcfg.batch_size, 2, 512, 512, generator=rng, device=dev)
    x_stack = torch.randn(CHUNK, tcfg.batch_size, 2, 512, 512, generator=rng, device=dev)
    gen_mask = [(i + 1) % tcfg.n_critic == 0 for i in range(TRAIN_ITERS)]
    n_g = sum(gen_mask)

    reset_launches()
    t0 = time.perf_counter()
    state = init_train_state(SEED, cfg, tcfg, device="cuda")
    before = {k: v.clone() for m in (state.gen, state.disc) for k, v in m.state_dict(prefix=type(m).__name__ + ".").items()}
    history, snap, snap_metrics, snap_mu = [], None, None, None
    for i, do_g in enumerate(gen_mask):
        if do_g and snap is None:
            snap = state.clone()
        state, m = build_step(TRAIN_STAGE, do_g, cfg, tcfg)(state, x, TRAIN_ALPHA)
        history.append(m)
        if do_g and snap_metrics is None:
            snap_metrics, snap_mu = m, first_moments(state)
    after7 = {k: v.clone() for m in (state.gen, state.disc) for k, v in m.state_dict(prefix=type(m).__name__ + ".").items()}
    state, chunk_metrics = build_chunk_step(0, CHUNK, cfg, tcfg)(
        state, x_stack, [1.0] * CHUNK, gen_mask[:CHUNK]
    )
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_launches()

    want7 = expected_train_launches(cfg, TRAIN_STAGE, TRAIN_ITERS - n_g, n_g)
    want0 = expected_train_launches(cfg, 0, CHUNK - n_g, n_g)
    expect = {k: want7[k] + want0[k] for k in want7}
    print(f"[train] {TRAIN_ITERS} iterations at stage {TRAIN_STAGE} ({n_g} with the generator) and a "
          f"chunk of {CHUNK} at stage 0 in {cold_s:.2f} s; launches {launches}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")

    hist = [metrics_floats(m) for m in history]
    chunk = {k: [float(v) for v in vals] for k, vals in chunk_metrics.items()}
    if not all(math.isfinite(v) for vals in chunk.values() for v in vals):
        raise AssertionError(f"non-finite chunk metrics: {chunk}")
    if not all(m["grad_pen"] > 0 for m in hist) or not all(v > 0 for v in chunk["grad_pen"]):
        raise AssertionError("grad_pen is not positive")
    if [m["gen_loss"] != 0.0 for m in hist] != gen_mask or [v != 0.0 for v in chunk["gen_loss"]] != gen_mask[:CHUNK]:
        raise AssertionError("gen_loss does not follow the n_critic pattern")
    if int(state.iter_idx) != TRAIN_ITERS + CHUNK:
        raise AssertionError(f"iter_idx {int(state.iter_idx)}")
    # After the stage-7 iterations: the weights of every block and of the
    # two live heads of each network moved; no parameter of a head of another
    # stage did, and their Adam counts stayed 0.  (A live bias may get an
    # exactly zero gradient: the Wasserstein terms of the real and the fake
    # batch cancel in it where both light the same LeakyReLU masks, and the
    # penalty reaches biases only through those masks.)
    for k, v in after7.items():
        moved = not torch.equal(v, before[k])
        net, kind, idx = k.split(".")[:3]
        if kind == "heads":
            live = int(idx) in ((TRAIN_STAGE, TRAIN_STAGE - 1) if net == "Generator" else (0, 1))
        else:
            live = True
        if moved != live and (k.endswith("weight") or moved):
            raise AssertionError(f"{k}: moved {moved}, live at stage {TRAIN_STAGE} {live}")
    if int(state.opt_disc.count["heads.4.weight"]) != 0:
        raise AssertionError("the Adam count of a head no stage reached has advanced")
    if int(state.opt_disc.count["blocks.8.conv2.weight"]) != TRAIN_ITERS + CHUNK:
        raise AssertionError("the critic's Adam count did not advance every iteration")
    if int(state.opt_gen.count["blocks.0.conv1.weight"]) != 2 * n_g:
        raise AssertionError("the generator's Adam count did not advance on its iterations")
    print(f"[train] stage-7 metrics, first D+G iteration: {metrics_floats(snap_metrics)}")

    # The first D+G iteration again, from the same state (the random
    # generator's state included, so the same noise) through the plain
    # versions on the card.
    with plain_convs():
        reset_launches()
        snap, m_plain = build_step(TRAIN_STAGE, True, cfg, tcfg)(snap, x, TRAIN_ALPHA)
        m_plain = metrics_floats(m_plain)
        if any(read_launches().values()):
            raise AssertionError(f"the plain iteration launched kernels: {read_launches()}")
    m_kernel = metrics_floats(snap_metrics)
    print(f"[train] the same iteration through the plain versions: {m_plain}")
    for k, v in m_plain.items():
        if not abs(m_kernel[k] - v) <= TOL_METRIC_ABS + TOL_METRIC_REL * abs(v):
            raise AssertionError(f"{k}: kernels {m_kernel[k]!r} vs plain {v!r}")
    # With b1 = 0 the first moments after an iteration ARE its gradients.
    # Each network's whole gradient is held in the 2-norm.  Leaf by leaf is
    # not a fair bar on this state: at random init the critic's score hardly
    # depends on its input (the biases carry it through 18 layers), so the
    # Wasserstein gradient of a leaf is the difference of two nearly equal
    # batch means and comes out of the rounding; the worst leaf is printed.
    mu_plain = first_moments(snap)
    del snap
    err_mu, worst, worst_err = {}, None, 0.0
    for net in ("gen.", "disc."):
        keys = [k for k in mu_plain if k.startswith(net)]
        err_mu[net] = rel_l2(
            torch.cat([snap_mu[k].flatten() for k in keys]),
            torch.cat([mu_plain[k].flatten() for k in keys]),
        )
        for k in keys:
            if mu_plain[k].norm() > 0 and rel_l2(snap_mu[k], mu_plain[k]) > worst_err:
                worst, worst_err = k, rel_l2(snap_mu[k], mu_plain[k])
    print(f"[train] gradients of that iteration, kernels vs plain, rel L2 err: generator "
          f"{err_mu['gen.']:.2e}, critic {err_mu['disc.']:.2e} (tol {TOL_BACKWARD_L2:.0e}); "
          f"worst single leaf {worst}: {worst_err:.2e}")
    if not max(err_mu.values()) <= TOL_BACKWARD_L2:
        raise AssertionError("the iteration's gradients disagree with the plain versions")

    # Warm timings, each call timed to the end of its device work; and the
    # same two kinds of iteration through the plain versions (cuDNN in
    # float32 behind every conv, the same hand-unrolled penalty), 3 each.
    step_d, step_dg = build_step(TRAIN_STAGE, False, cfg, tcfg), build_step(TRAIN_STAGE, True, cfg, tcfg)
    torch.cuda.reset_peak_memory_stats()
    d_s = timed_iterations(step_d, state, x, TIMED_ITERS)
    dg_s = timed_iterations(step_dg, state, x, TIMED_ITERS)
    peak = torch.cuda.max_memory_allocated()
    with plain_convs():
        plain_d_s = timed_iterations(step_d, state, x, 3)
        plain_dg_s = timed_iterations(step_dg, state, x, 3)
    print(f"[train] through the plain versions, median of 3: critic only "
          f"{float(np.median(plain_d_s)) * 1e3:.2f} ms, critic + generator "
          f"{float(np.median(plain_dg_s)) * 1e3:.2f} ms")
    med_d, med_dg = float(np.median(d_s)), float(np.median(dg_s))
    n_c = tcfg.n_critic
    steps_s7 = n_c / ((n_c - 1) * med_d + med_dg)
    chunk_step = build_chunk_step(0, CHUNK, cfg, tcfg)
    chunk_s = []
    for _ in range(TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk_step(state, x_stack, [1.0] * CHUNK, gen_mask[:CHUNK])
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    steps_s0 = CHUNK / float(np.median(chunk_s))
    print(f"[train] warm stage-7 iteration, median of {TIMED_ITERS}: critic only {med_d * 1e3:.2f} ms "
          f"(min {min(d_s) * 1e3:.2f}, max {max(d_s) * 1e3:.2f}), critic + generator {med_dg * 1e3:.2f} ms "
          f"(min {min(dg_s) * 1e3:.2f}, max {max(dg_s) * 1e3:.2f}) = {steps_s7:.3f} steps/s at "
          f"n_critic {n_c}; peak device memory {peak / 2**30:.3f} GiB; stage 0, chunks of {CHUNK}, "
          f"median of {TIMED_ITERS}: {float(np.median(chunk_s)) * 1e3:.2f} ms a chunk = {steps_s0:.1f} steps/s")
    return {
        "launches": launches, "cold_s": cold_s, "metrics_stage7": hist, "metrics_chunk": chunk,
        "plain_d_and_g": m_plain, "grad_rel_l2_err": err_mu, "plain_d_only_s": plain_d_s,
        "plain_d_and_g_s": plain_dg_s, "d_only_s": d_s, "d_and_g_s": dg_s, "chunk_s": chunk_s,
        "steps_per_s_stage7": steps_s7, "steps_per_s_stage0": steps_s0, "peak_bytes": peak,
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
    torch.cuda.empty_cache()

    tcfg = TrainConfig()
    rows += check_train_kernels(cfg, tcfg, dev)
    grads = check_function_and_gp(cfg, tcfg, dev)
    torch.cuda.empty_cache()
    train = train_path(cfg, tcfg, dev)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        mine = [r for r in rows if r["name"] == name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": e2e["launches"][name] + train["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{k: sum(r[k] for r in mine) for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "operations" if sum(r["flops"] for r in mine) / PEAK_FP32_FLOPS
            >= sum(r["bytes"] for r in mine) / PEAK_BYTES_S else "bytes",
        })
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "shapes": rows, "end_to_end": e2e, "gradients": grads, "train": train,
         "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
