#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis path, its WGAN-GP train step and its
``train`` entry point on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit (``nvcc``).  Phases, each of which raises on failure:

1. print the card's name and power limit; build every kernel from
   ``musicgan_tpu_torch/csrc`` (one ``nvcc`` per source, all at once);
2. at the main path's shapes (5 clips x nb_vec 10, the full-width
   generator of ``saved_models/quality_r4/gen_final.pt``): hold each kernel
   against its plain PyTorch version on the card (TF32 off), and time the
   kernel, the plain version and one PyTorch library call computing the
   same function (the yardstick, used nowhere in the port), as device
   time from CUDA-graph replays where the function can be captured; each
   conv row also prints the launch plan the conv template took; K5's second
   route (the windowed iDFT) at a length outside its FFT's domain;
3. run ``generate`` end to end through the entry point, with every launch
   counter set to 0 just before and read just after; check the five WAVs
   and hold the waveforms against the same latents through the plain
   versions on the card (with the counters showing that the kernel pass
   launched every kernel and the plain pass none), and print both float32
   paths' image and waveform against the plain path in float64; time warm
   runs.

4. at the train step's shapes (stage 7, batch 6, full width): K2 at the 16
   generator convs, K1 at the 18 critic convs (up to 160 channels) and at
   every input-gradient conv (swapped channels, no bias), each against its
   plain version, with the three times as in phase 2 and the sums over the
   shapes up to 32x32; then K1, K2 and K3 with PixelNorm past 128 channels;
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
   versions on the card in float32 and in float64, the gradients of both
   float32 paths printed against the float64 ones and the kernels' held
   there (2-norm: generator 1e-2, critic 2e-2); warm timings.

7. the whole-block kernel K4 at every generator block of the 5 x nb_vec 10
   call, its time beside the pair's and conv1's recompute factor; at the
   blocks its size rule ``fused_block_fits`` gives it (4 to 7) against its
   plain version and against K1 then K3 at 1e-6, with its bound, the plain
   version's time and two ``F.conv2d`` calls'; at one width past 128
   channels against its plain version; then ``generate`` with
   ``conv_impl="pallas_block"``, launches counted, waveforms against the
   default path's, warm synthesis under both values;
8. the ``train`` entry point at full width on a seeded synthetic corpus of
   24 samples, the schedule cut to 12 samples a stage so that 32 iterations
   pass through all eight stages with their fades: once uninterrupted
   (launches held against the formula summed over the trajectory, plus the
   previews'), once uninterrupted again and once stopped half way and
   resumed, no cuDNN flag set by the caller (the three final states are
   equal bit for bit), once streaming through the host pipeline, once as a
   subprocess of the CLI that is sent SIGTERM (exit code 75, a complete
   off-cadence save); the Saver's preview images; ``generate`` from the
   run directory through K4; the time of a save and of a restore.

The last lines are a ``{"kernels": [...]}`` record, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.  Per-shape numbers also go
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import io
import json
import math
import os
import re
import signal
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
from musicgan_tpu_torch.audio.ingest import ShardWriter
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
from musicgan_tpu_torch.train import (
    CheckpointManager,
    Grower,
    Saver,
    build_chunk_step,
    build_step,
    init_train_state,
    train,
)

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "saved_models" / "quality_r4" / "gen_final.pt"
NB_MUSIC, NB_VEC, SEED = 5, 10, 0
WARM_REPS = 20  # warm synthesis calls timed one by one; the median is quoted

# H100 SXM published peaks: float32 outside the tensor cores, TF32 on the
# tensor cores (dense), HBM3.  The conv template's large-image route
# (plan route "large_tc") multiplies in 3xTF32: three TF32 products for
# each float32 product, so its operations bound is 3 * flops / 495e12.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_S = 3.35e12

# Kernel vs plain version, both float32 on the card: the sums run in
# another order (K up to 9 * 128 = 1152 products for the convs, 4104 for
# the iSTFT), about 1e-6 relative on outputs of order 1.
TOL = {
    "fused_conv3x3": 1e-4, "fused_conv3x3_msq": 1e-4, "fused_upconv3x3": 1e-4,
    "istft_fused": 2e-4,
    # The weight gradient sums up to 1.5 million pixels into outputs of order
    # 1, held against the plain version in float64: float32 sums of that
    # length keep about 1e-5.
    "weight_grad3x3": 1e-4,
    # K4 is two convs, the second on the first's output: their errors
    # compound (against K1 then K3: TOL_BLOCK_VS_PAIR).
    "fused_block": 2e-4,
}
TOL_MSQ_REL = 1e-4  # K2's mean-square map, relative to its largest value
# K4 against K1 then K3 where both take the tensor-core route: K4 is built
# from their pieces and sums every pixel in their order (bit for bit on an
# H100); 1e-6 leaves room for nothing but a different rounding of one sum.
TOL_BLOCK_VS_PAIR = 1e-6
# K4 past 128 channels (a cluster of 2 blocks for each conv), at a size
# where its tiles fill a quarter of the card.
WIDE_BLOCK = (5, 144, 144, 160, 32, 320)
# K5's second route (the windowed iDFT) is held at a length outside the
# FFT's domain: n_fft 768 = 3 x 256, hop 256.
DFT_LENGTH = (768, 256)
# End to end, kernels vs plain versions on the same latents.  The image:
# each conv disagrees by up to ~1.3e-5 (the per-shape check above), and
# 16 convs compound it; an H100 showed 8.8e-4 with float32 kernels, so
# 2e-3.  The 3xTF32 route is nearer float64 than cuDNN per conv, but its
# rounding no longer follows cuDNN's, and an H100 shows 1.9e-3.  The waveform: the
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
# The critic's whole gradient in the first D+G iteration at random init,
# against the same iteration in float64.  Its Wasserstein part is the
# difference of two nearly equal batch means, so float32 rounding anywhere
# moves it by about 1e-2: on an H100 the plain versions (cuDNN, float32)
# read 1.5e-2 against float64 and the kernels 1.3e-2.  The bar sits above
# what a correct float32 path reads; the generator's gradient, which does
# not cancel, keeps TOL_BACKWARD_L2.
TOL_CRITIC_ITERATION_L2 = 2e-2
# One whole iteration, kernels vs plain versions: the repo's own bar for
# two lowerings of the train step (tests/test_ops_vjp.py).
TOL_METRIC_REL, TOL_METRIC_ABS = 1e-3, 1e-4

SOURCES = {
    "fused_conv3x3": ("musicgan_tpu_torch/csrc/conv3x3.cu", "musicgan_tpu/ops/conv.py:90"),
    "fused_conv3x3_msq": ("musicgan_tpu_torch/csrc/conv3x3.cu", "musicgan_tpu/ops/conv.py:625"),
    "fused_upconv3x3": ("musicgan_tpu_torch/csrc/upconv3x3.cu", "musicgan_tpu/ops/conv.py:139"),
    "istft_fused": ("musicgan_tpu_torch/csrc/istft.cu", "musicgan_tpu/ops/istft_pallas.py:60"),
    "fused_block": ("musicgan_tpu_torch/csrc/block3x3.cu", "musicgan_tpu/ops/conv.py:234"),
    # No Pallas kernel: XLA's conv-backward-weights in the JAX package.
    "weight_grad3x3": ("musicgan_tpu_torch/csrc/wgrad3x3.cu", "musicgan_tpu/ops/conv_vjp.py:107"),
}
IDFT = "istft_fused.idft"  # K5's second route, counted apart in read_launches
WRAPPERS = {
    "fused_conv3x3": conv_ops.fused_conv3x3,
    "fused_conv3x3_msq": conv_ops.fused_conv3x3_msq,
    "fused_upconv3x3": conv_ops.fused_upconv3x3,
    "istft_fused": istft_ops.istft_fused,
    "fused_block": conv_ops.fused_block,
    "weight_grad3x3": conv_vjp.weight_grad3x3,
}

# The train entry point (phase 8): 24 samples, 12 a stage at batch 6, so
# stage 0 takes 3 iterations, stages 1-6 two each and stage 7 the last 17 of
# 32; every stage but 0 fades in over its first two iterations.
LOOP_SAMPLES, LOOP_ITERS = 24, 32
LOOP_CFG = dict(
    fadein_lengths=(1,) + (12,) * 7, train_lengths=(12,) * 7, save_every=8, log_every=4,
    chunk_steps=4,
)
# A resumed run against the uninterrupted one, and two uninterrupted runs,
# are held bit for bit with no cuDNN flag set by the caller: the weight
# gradient is the fixed-order kernel ops/conv_vjp.py::weight_grad3x3.  Under
# cuDNN's default algorithms the same run twice differed on an H100 by 1e-8
# (relative 2-norm) after one iteration and, through this schedule's
# random-init trajectory, by a tenth after 32.


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


def time_ms(fn, graph: bool = True) -> float:
    """Mean device time of one call of ``fn`` in ms, after a warm-up call.
    ``graph``: the calls captured into one CUDA graph and the graph
    replayed, timed by CUDA events, so the host's time to issue a call
    (Python, the wrapper, the launch) is not counted: what a caller with
    work queued ahead sees, as the stage-7 train step is.  Without (a
    function that synchronises with the host and cannot be captured):
    back-to-back calls timed by CUDA events, which for small kernels
    measures the host.  Enough calls to cover about 20 ms."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = int(min(50, max(3, math.ceil(20.0 / max(start.elapsed_time(end), 1e-3)))))
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        del g
        return start.elapsed_time(end) / reps
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_terms(flops: float, nbytes: float, route: str | None = None) -> tuple[float, float]:
    """The two lower bounds of a function's time in ms: its operations at the
    peak rate of the route that computes them (3xTF32 on the tensor cores
    for "large_tc", else float32 FMA) and its bytes at the memory rate."""
    ops = 3 * flops / PEAK_TF32_FLOPS if route == "large_tc" else flops / PEAK_FP32_FLOPS
    return 1e3 * ops, 1e3 * nbytes / PEAK_BYTES_S


def bound_ms(flops: float, nbytes: float, route: str | None = None) -> tuple[float, str]:
    t_ops, t_bytes = bound_terms(flops, nbytes, route)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def measure(name, shape, kernel, plain, library, flops, nbytes, role="synthesis", plan=None,
            graph_plain=True, route=None, ref=None):
    """One kernel at one main-path shape: error against the plain version
    (raises past the tolerance) and the three times.  ``plan``: the conv
    template's launch plan for the shape, printed and kept; a conv row keeps
    its route, its bound under that route (``bound_ms``) and both the FP32
    and the 3xTF32 bound; ``route`` gives a kernel without a plan its
    route (K4: "large_tc"); ``ref``, where given, is the plain version the
    error is read against (the weight gradient's, in float64), ``plain`` is
    then only timed."""
    err = (kernel() - (plain if ref is None else ref)()).abs().max().item()
    if not err <= TOL[name]:
        raise AssertionError(f"{name} {shape}: max abs err {err:.3e} > {TOL[name]:.0e}")
    route = plan["route"] if plan is not None else route
    b, by = bound_ms(flops, nbytes, route)
    row = {
        "name": name, "role": role, "shape": shape, "max_abs_err": err,
        "ms": time_ms(kernel), "plain_ms": time_ms(plain, graph_plain),
        "library_ms": time_ms(library, graph_plain), "bound_ms": b, "bound_by": by,
        "flops": flops, "bytes": nbytes, "route": route,
    }
    row["ops_ms"], row["bytes_ms"] = bound_terms(flops, nbytes, route)
    extra = ""
    if route is not None:
        row["bound_fp32_ms"] = bound_ms(flops, nbytes)[0]
        row["bound_3xtf32_ms"] = bound_ms(flops, nbytes, "large_tc")[0]
        extra = f"  (FP32 {row['bound_fp32_ms']:.4f}, 3xTF32 {row['bound_3xtf32_ms']:.4f})"
    if plan is not None:
        row["plan"] = plan
        tile = (f"tile {plan['tile'][0]}x{plan['tile'][1]}, {plan['phases_a_block']} phases a block"
                if plan["tile"] else f"{plan['pixels_a_lane']} pixels a lane")
        print(f"[plan]   {name:17s} {role:10s} {str(shape):26s} {plan['route']}, cluster of "
              f"{plan['cluster']} ({plan['split_k']} over input channels x {plan['nsplit']} over output "
              f"channels), {tile}, {plan['blocks']} blocks of {plan['threads']}")
    print(
        f"[kernel] {name:17s} {role:10s} {str(shape):26s} err {err:.2e}  kernel {row['ms']:.4f} ms"
        f"  plain {row['plain_ms']:.4f}  library {row['library_ms']:.4f}"
        f"  bound {b:.4f} ({by}){extra}  share {b / row['ms']:.2f}"
    )
    return row


def print_row_sums(rows) -> None:
    """Each conv kernel's rows summed by role: all shapes, and those the
    large-image route took, with both bounds and the share of the route's."""
    for name, role in dict.fromkeys((r["name"], r["role"]) for r in rows if "plan" in r):
        mine = [r for r in rows if (r["name"], r["role"]) == (name, role)]
        for part, sel in (("all", mine), ("large_tc", [r for r in mine if r["route"] == "large_tc"])):
            if not sel:
                continue
            tot = {k: sum(r[k] for r in sel) for k in
                   ("ms", "library_ms", "bound_ms", "bound_fp32_ms", "bound_3xtf32_ms")}
            print(f"[sums]   {name:17s} {role:10s} {part:8s} {len(sel):2d} shapes: kernel {tot['ms']:.4f} ms, "
                  f"library {tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f} (FP32 {tot['bound_fp32_ms']:.4f}, "
                  f"3xTF32 {tot['bound_3xtf32_ms']:.4f}), share {tot['bound_ms'] / tot['ms']:.2f}")


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
        w1p = conv_ops.kernel_weights(w1)
        px = NB_MUSIC * h * w
        rows.append(measure(
            "fused_conv3x3", (NB_MUSIC, cin, cin, h, w),
            lambda: conv_ops.fused_conv3x3(x, w1, b1, slope, True, eps, w_packed=w1p),
            lambda: conv_ops.conv3x3_plain(x, w1, b1, slope, True, eps),
            lambda: F.conv2d(x, w1, b1, padding=1),
            2.0 * px * cin * 9 * cin, 4.0 * (2 * px * cin + 9 * cin * cin + cin),
            plan=conv_ops.conv_plan("conv3x3", NB_MUSIC, cin, cin, h, w, True),
        ))
        w2, b2 = blk.conv2.weight.detach(), blk.conv2.bias.detach()
        w2p = conv_ops.kernel_upconv_weights(w2)
        xu = upsample_nearest_2x(x)
        rows.append(measure(
            "fused_upconv3x3", (NB_MUSIC, cin, cout, h, w),
            lambda: conv_ops.fused_upconv3x3(x, w2, b2, slope, True, eps, w_packed=w2p),
            lambda: conv_ops.upconv3x3_plain(x, w2, b2, slope, True, eps),
            lambda: F.conv2d(xu, w2, b2, padding=1),
            2.0 * 4 * px * cout * 4 * cin,
            4.0 * (px * cin + 4 * px * cout + 16 * cin * cout + cout),
            plan=conv_ops.conv_plan("upconv3x3", NB_MUSIC, cin, cout, h, w, True),
        ))
        del xu
        h, w = 2 * h, 2 * w

    acfg = AudioConfig()
    n_fft, hop = acfg.n_fft, acfg.stft_stride
    n_bins, t = n_fft // 2 + 1, w
    re = torch.randn(NB_MUSIC, n_bins, t, generator=rng, device=dev)
    im = torch.randn(NB_MUSIC, n_bins, t, generator=rng, device=dev)
    spec = torch.complex(re, im)
    window = torch.from_numpy(hann_window(n_fft)).to(dev)
    # The function's work: per frame a real inverse FFT of n_fft points (a
    # complex one of m = n_fft / 2, 5 m log2 m FLOP, and about 10 m for the
    # packing, the window, the overlap-add and the envelope); its bytes: the
    # spectra read once, the signal written once, the three tables.
    m = n_fft // 2
    rows.append(measure(
        "istft_fused", (NB_MUSIC, n_bins, t),
        lambda: istft_ops.istft_fused(re, im, n_fft, hop),
        lambda: istft_real_imag(re, im, n_fft, hop),
        lambda: torch.istft(spec, n_fft, hop, window=window, center=True, normalized=True),
        NB_MUSIC * t * (5.0 * m * math.log2(m) + 10.0 * m),
        4.0 * (2 * NB_MUSIC * n_bins * t + NB_MUSIC * (t - 1) * hop
               + 3 * n_fft + (n_fft // hop) ** 2 * hop),
        graph_plain=False,  # both build or check tables on the host
    ))
    rows[-1]["route_name"] = "fft"

    # K5's second route, the windowed iDFT, at a length outside the FFT's
    # domain (n_fft not a power of two) and the synthesis call's frames: per
    # output sample 2 * 2 * r * n_bins FLOP in float32.
    n_fft, hop = DFT_LENGTH
    n_bins = n_fft // 2 + 1
    if istft_ops.uses_fft(n_fft, hop):
        raise AssertionError(f"{DFT_LENGTH} takes the FFT route")
    re2 = torch.randn(NB_MUSIC, n_bins, t, generator=rng, device=dev)
    im2 = torch.randn(NB_MUSIC, n_bins, t, generator=rng, device=dev)
    spec2 = torch.complex(re2, im2)
    window2 = torch.from_numpy(hann_window(n_fft)).to(dev)
    n_out = NB_MUSIC * (t - 1) * hop
    rows.append(measure(
        "istft_fused", (NB_MUSIC, n_bins, t, n_fft, hop),
        lambda: istft_ops.istft_fused(re2, im2, n_fft, hop),
        lambda: istft_real_imag(re2, im2, n_fft, hop),
        lambda: torch.istft(spec2, n_fft, hop, window=window2, center=True, normalized=True),
        n_out * 2.0 * 2 * (n_fft // hop) * n_bins,
        4.0 * (2 * NB_MUSIC * n_bins * t + n_out + 2 * n_bins * n_fft + n_fft),
        role="idft_route", graph_plain=False,
    ))
    rows[-1]["route_name"] = "idft"
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


def istft_float64(real, imag, n_fft: int, hop: int) -> torch.Tensor:
    """``audio/stft.py::istft_real_imag`` in float64 throughout (its window,
    bases and envelope made in float64): the reference the float32 paths
    are read against."""
    dev = real.device
    window = torch.from_numpy(hann_window(n_fft, np.float64)).to(dev)
    n_bins = n_fft // 2 + 1
    f = torch.arange(n_bins, dtype=torch.float64, device=dev)[:, None]
    k = torch.arange(n_fft, dtype=torch.float64, device=dev)[None, :]
    ang = 2.0 * math.pi * f * k / n_fft
    weight = torch.full((n_bins, 1), 2.0 / n_fft, dtype=torch.float64, device=dev)
    weight[0, 0] = weight[-1, 0] = 1.0 / n_fft
    scale = torch.sqrt(torch.sum(window**2))
    frames = ((real * scale).transpose(-1, -2) @ (torch.cos(ang) * weight)
              + (imag * scale).transpose(-1, -2) @ (-torch.sin(ang) * weight)) * window
    t, r = real.shape[-1], n_fft // hop
    acc = frames.new_zeros(*frames.shape[:-2], t + r - 1, hop)
    env = frames.new_zeros(t + r - 1, hop)
    chunks, w2 = frames.reshape(*frames.shape[:-2], t, r, hop), (window**2).reshape(r, hop)
    for j in range(r):
        acc[..., j : j + t, :] += chunks[..., j, :]
        env[j : j + t] += w2[j]
    y = (acc / torch.clamp(env, min=1e-11)).reshape(*acc.shape[:-2], -1)
    return y[..., n_fft // 2 : n_fft // 2 + (t - 1) * hop]


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    istft_ops.istft_fused.idft_launches = 0


def read_launches() -> dict:
    """Each wrapper's launches, and of K5's those on its iDFT route."""
    return {**{name: fn.launches for name, fn in WRAPPERS.items()},
            IDFT: istft_ops.istft_fused.idft_launches}


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
        "fused_upconv3x3": cfg.n_stages, "istft_fused": 1, "fused_block": 0, IDFT: 0,
        "weight_grad3x3": 0,
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

    # Both float32 paths against the plain path in float64, for the margin
    # of the two bars above (read, not held).
    gen64 = load_reference_generator(str(CKPT), cfg, device=dev).double()
    patches = plain_on_card()[:2] + [mock.patch.object(generate_mod, "istft_fused", istft_float64)]
    for p in patches:
        p.start()
    try:
        with torch.no_grad():
            z64 = z.double()
            img64 = gen64.forward_nchw(z64.permute(0, 3, 1, 2), cfg.n_stages - 1)
            waves64 = generate_mod._synthesize(gen64, z64, cfg.n_stages - 1, cfg)
    finally:
        for p in patches:
            p.stop()
    waves_k = synth(gen, z).double()
    float64 = {
        "image_kernels": (img.double() - img64).abs().max().item(),
        "image_cudnn": (img_plain.double() - img64).abs().max().item(),
        "wave_kernels": (waves_k - waves64).abs().max().item(),
        "wave_cudnn": (torch.from_numpy(waves_plain).to(dev).double() - waves64).abs().max().item(),
    }
    print(f"[e2e] against the plain path in float64: image, kernels {float64['image_kernels']:.3e}, "
          f"cuDNN float32 {float64['image_cudnn']:.3e}; waveform, kernels {float64['wave_kernels']:.3e}, "
          f"cuDNN float32 {float64['wave_cudnn']:.3e}")
    del gen64, img64, waves64, waves_k

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
        "err_image": err_img, "err_wave": err_wave, "float64": float64,
    }, np.stack(waves)


def conv_rows(name, role, shapes, rng, dev, slope, bias, pixel_norm=False):
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
        plan = conv_ops.conv_plan("conv3x3", bsz, cin, cout, h, w, pixel_norm or name == "fused_conv3x3_msq")
        if name == "fused_conv3x3_msq":
            m, m_ref = conv_ops.fused_conv3x3_msq(x, wt, b, slope, 1e-8)[1], conv_ops.conv3x3_msq_plain(x, wt, b, slope, 1e-8)[1]
            m_rel = ((m - m_ref).abs().max() / m_ref.abs().max()).item()
            if not m_rel <= TOL_MSQ_REL:
                raise AssertionError(f"{name} {(bsz, cin, cout, h, w)}: mean-square map rel err {m_rel:.3e}")
            row = measure(
                name, (bsz, cin, cout, h, w),
                lambda: conv_ops.fused_conv3x3_msq(x, wt, b, slope, 1e-8)[0],
                lambda: conv_ops.conv3x3_msq_plain(x, wt, b, slope, 1e-8)[0],
                lambda: F.conv2d(x, wt, b, padding=1), flops, nbytes + 4.0 * px, role, plan,
            )
            row["msq_rel_err"] = m_rel
        else:
            row = measure(
                name, (bsz, cin, cout, h, w),
                lambda: conv_ops.fused_conv3x3(x, wt, b, slope, pixel_norm),
                lambda: conv_ops.conv3x3_plain(x, wt, b, slope, pixel_norm),
                lambda: F.conv2d(x, wt, b, padding=1), flops, nbytes, role, plan,
            )
        rows.append(row)
    return rows


def upconv_rows(shapes, rng, dev, slope):
    """K3 with PixelNorm at ``shapes`` = ``[(B, cin, cout, H, W), ...]``."""
    rows = []
    for bsz, cin, cout, h, w in shapes:
        x = torch.randn(bsz, cin, h, w, generator=rng, device=dev)
        wt = torch.randn(cout, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
        b = torch.randn(cout, generator=rng, device=dev) * 0.1
        xu = upsample_nearest_2x(x)
        px = bsz * h * w
        rows.append(measure(
            "fused_upconv3x3", (bsz, cin, cout, h, w),
            lambda: conv_ops.fused_upconv3x3(x, wt, b, slope, True),
            lambda: conv_ops.upconv3x3_plain(x, wt, b, slope, True),
            lambda: F.conv2d(xu, wt, b, padding=1),
            2.0 * 4 * px * cout * 4 * cin, 4.0 * (px * cin + 4 * px * cout + 16 * cin * cout + cout),
            "pn_wide", conv_ops.conv_plan("upconv3x3", bsz, cin, cout, h, w, True),
        ))
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


# PixelNorm past 128 channels (one cluster of blocks shares each pixel's
# sum): the critic's widest shapes at batch 6, as no path of the repo runs
# them with PixelNorm; K3 at the same widths.
WIDE_PN_SHAPES = [(6, 128, 144, 4, 4), (6, 144, 144, 2, 2), (6, 144, 160, 2, 2), (6, 160, 160, 1, 1)]


def check_train_kernels(cfg: ModelConfig, tcfg: TrainConfig, dev) -> list[dict]:
    """Phase 4: every kernel at every shape the train step gives it, and
    PixelNorm past 128 channels."""
    rng = torch.Generator(device=dev).manual_seed(2)
    gen, disc = train_conv_shapes(cfg, tcfg.batch_size, TRAIN_STAGE)
    swap = lambda shapes: [(b, cout, cin, h, w) for b, cin, cout, h, w in shapes]  # noqa: E731
    slope = cfg.leaky_slope
    rows = (
        conv_rows("fused_conv3x3_msq", "gen_fwd", gen, rng, dev, slope, True)
        + conv_rows("fused_conv3x3", "critic_fwd", disc, rng, dev, slope, True)
        + conv_rows("fused_conv3x3", "critic_dx", swap(disc), rng, dev, None, False)
        + conv_rows("fused_conv3x3", "gen_dx", swap(gen[1:]), rng, dev, None, False)
    )
    for role in ("critic_fwd", "critic_dx", "gen_fwd", "gen_dx"):
        small = [r for r in rows if r["role"] == role and r["shape"][3] <= 32]
        print(f"[small]  {role:10s} the {len(small)} shapes up to 32x32: kernel "
              f"{sum(r['ms'] for r in small):.4f} ms, F.conv2d {sum(r['library_ms'] for r in small):.4f} ms")
    return (
        rows
        + conv_rows("fused_conv3x3", "pn_wide", WIDE_PN_SHAPES, rng, dev, slope, True, True)
        + conv_rows("fused_conv3x3_msq", "pn_wide", WIDE_PN_SHAPES, rng, dev, slope, True)
        + upconv_rows(WIDE_PN_SHAPES, rng, dev, slope)
        + wgrad_rows("gen", gen, rng, dev) + wgrad_rows("critic", disc, rng, dev)
    )


def wgrad_rows(role, shapes, rng, dev):
    """The weight-gradient kernel at every trainable conv of a stage-7
    iteration, held against its plain version run in float64 (cuDNN's
    float32, itself up to about 1e-4 off at some of these shapes on an
    H100, is printed beside it), timed beside the plain version in float32
    (cuDNN, TF32 off) and one call of cuDNN's default algorithms (the
    yardstick).  The output gradient is scaled by 1 / sqrt(pixels) so that
    the weight gradient is of order 1."""
    rows = []
    for bsz, cin, cout, h, w in shapes:
        x = torch.randn(bsz, cin, h, w, generator=rng, device=dev)
        d = torch.randn(bsz, cout, h, w, generator=rng, device=dev) / (bsz * h * w) ** 0.5
        shape = (cout, cin, 3, 3)
        px = bsz * h * w
        ref = conv_vjp.weight_grad3x3_plain(x.double(), d.double(), shape).float()
        rows.append(measure(
            "weight_grad3x3", (bsz, cin, cout, h, w), lambda: conv_vjp.weight_grad3x3(x, d, shape),
            lambda: conv_vjp.weight_grad3x3_plain(x, d, shape),
            lambda: torch.nn.grad.conv2d_weight(x, shape, d, padding=1),
            2.0 * px * cin * cout * 9, 4.0 * (px * cin + px * cout + 9 * cin * cout), role=role,
            ref=lambda: ref,
        ))
        rows[-1]["plain_err_vs_float64"] = (conv_vjp.weight_grad3x3_plain(x, d, shape) - ref).abs().max().item()
        print(f"[kernel] weight_grad3x3    {role:10s} {str((bsz, cin, cout, h, w)):26s} cuDNN float32 against "
              f"the plain version in float64: {rows[-1]['plain_err_vs_float64']:.2e}")
        del x, d, ref
    return rows


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
            if n != (3 if name == "kernel" else 0):  # forward, input and weight gradients
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
    latent).  The weight gradient runs once a trainable conv a backward
    pass: 3 c times a critic iteration (the critic's loss through its two
    forwards, and the penalty), g more with the generator."""
    g, c = 2 * (stage + 1), 2 * (stage + 2)
    n = n_d_only + n_d_and_g
    return {
        "fused_conv3x3": n * 7 * c + n_d_and_g * (2 * c + g - 1),
        "fused_conv3x3_msq": n * g + n_d_and_g * g,
        "fused_upconv3x3": 0, "istft_fused": 0, "fused_block": 0, IDFT: 0,
        "weight_grad3x3": n * 3 * c + n_d_and_g * g,
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


def float64_state(state):
    """A copy of ``state`` in float64: both networks, the Adam moments and
    the EMA (the random generator's state is kept)."""
    s = state.clone()
    s.gen.double()
    s.disc.double()
    for tree in (*s.opt_gen[1:], *s.opt_disc[1:], *([s.gen_ema] if s.gen_ema else [])):
        for k, v in tree.items():
            tree[k] = v.double()
    return s


def same_noise(state, cfg: ModelConfig, batch: int):
    """The ``(z, eps, zg)`` that an iteration from ``state`` draws (in
    float32, from a copy of its random generator), in float64 and laid out
    as ``build_step``'s ``noise`` takes them."""
    rng = torch.Generator(device=state.rng.device)
    rng.set_state(state.rng.get_state())
    dev = state.rng.device
    shape = (batch, cfg.rand_channels, cfg.latent_height, cfg.latent_width)
    z = torch.randn(shape, generator=rng, device=dev)
    eps = torch.rand((batch, 1, 1, 1), generator=rng, device=dev)
    zg = torch.randn(shape, generator=rng, device=dev)
    return z.double().permute(0, 2, 3, 1), eps.double(), zg.double().permute(0, 2, 3, 1)


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
    # versions on the card: in float32, and in float64 as the reference
    # that tells rounding from a fault.
    snap64 = float64_state(snap)
    with plain_convs():
        reset_launches()
        snap, m_plain = build_step(TRAIN_STAGE, True, cfg, tcfg)(snap, x, TRAIN_ALPHA)
        m_plain = metrics_floats(m_plain)
        snap64, _ = build_step(TRAIN_STAGE, True, cfg, tcfg)(
            snap64, x.double(), TRAIN_ALPHA, noise=same_noise(snap64, cfg, tcfg.batch_size))
        if any(read_launches().values()):
            raise AssertionError(f"the plain iterations launched kernels: {read_launches()}")
    m_kernel = metrics_floats(snap_metrics)
    print(f"[train] the same iteration through the plain versions: {m_plain}")
    for k, v in m_plain.items():
        if not abs(m_kernel[k] - v) <= TOL_METRIC_ABS + TOL_METRIC_REL * abs(v):
            raise AssertionError(f"{k}: kernels {m_kernel[k]!r} vs plain {v!r}")
    # With b1 = 0 the first moments after an iteration ARE its gradients.
    # Each network's whole gradient is held in the 2-norm, against the
    # float64 iteration.  Leaf by leaf is not a fair bar on this state: at
    # random init the critic's score hardly depends on its input (the biases
    # carry it through 18 layers), so the Wasserstein gradient of a leaf is
    # the difference of two nearly equal batch means and comes out of the
    # rounding; the worst leaf is printed.
    mu_plain, mu64 = first_moments(snap), first_moments(snap64)
    del snap, snap64
    err_mu, err64, worst, worst_err = {}, {}, None, 0.0
    flat = lambda mu, keys: torch.cat([mu[k].flatten().double() for k in keys])  # noqa: E731
    for net in ("gen.", "disc."):
        keys = [k for k in mu_plain if k.startswith(net)]
        ref = flat(mu64, keys)
        err_mu[net] = rel_l2(flat(snap_mu, keys), flat(mu_plain, keys))
        err64[net] = {"kernels": rel_l2(flat(snap_mu, keys), ref), "plain": rel_l2(flat(mu_plain, keys), ref)}
        for k in keys:
            if mu_plain[k].norm() > 0 and rel_l2(snap_mu[k], mu_plain[k]) > worst_err:
                worst, worst_err = k, rel_l2(snap_mu[k], mu_plain[k])
    print(f"[train] gradients of that iteration, rel L2 err against float64: generator kernels "
          f"{err64['gen.']['kernels']:.2e}, plain {err64['gen.']['plain']:.2e}; critic kernels "
          f"{err64['disc.']['kernels']:.2e}, plain {err64['disc.']['plain']:.2e} (tols "
          f"{TOL_BACKWARD_L2:.0e}, {TOL_CRITIC_ITERATION_L2:.0e}); kernels vs float32 plain: generator "
          f"{err_mu['gen.']:.2e}, critic {err_mu['disc.']:.2e}; worst single leaf {worst}: {worst_err:.2e}")
    if not (err64["gen."]["kernels"] <= TOL_BACKWARD_L2 and err64["disc."]["kernels"] <= TOL_CRITIC_ITERATION_L2):
        raise AssertionError("the iteration's gradients disagree with the float64 plain versions")

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
        "plain_d_and_g": m_plain, "grad_rel_l2_err": err_mu, "grad_rel_l2_err_vs_float64": err64,
        "plain_d_only_s": plain_d_s,
        "plain_d_and_g_s": plain_dg_s, "d_only_s": d_s, "d_and_g_s": dg_s, "chunk_s": chunk_s,
        "steps_per_s_stage7": steps_s7, "steps_per_s_stage0": steps_s0, "peak_bytes": peak,
    }


def pair_is_large(cin: int, cout: int, h: int, w: int) -> bool:
    """K1 then K3 at a block's sizes both take the conv template's
    large-image route, the tensor cores in 3xTF32."""
    return (conv_ops.conv_plan("conv3x3", NB_MUSIC, cin, cin, h, w, True)["route"] == "large_tc"
            and conv_ops.conv_plan("upconv3x3", NB_MUSIC, cin, cout, h, w, True)["route"] == "large_tc")


def block_sizes(cfg: ModelConfig, i: int, nb_vec: int = NB_VEC, nb_music: int = NB_MUSIC) -> tuple:
    """``(B, H, W)`` of generator block ``i``'s input in a synthesis call."""
    return nb_music, cfg.latent_height * 2**i, cfg.latent_width * nb_vec * 2**i


def check_block_kernel(gen, cfg: ModelConfig, dev) -> list[dict]:
    """Phase 7: K4 at every block of the main path, against its plain
    version and, where K1 then K3 both take the tensor-core route, against
    that pair at ``TOL_BLOCK_VS_PAIR`` (K4 sums in their order); its time
    beside the pair's and conv1's recompute factor at every block, the
    blocks that its size rule (``fused_block_fits``) gives it and those it
    leaves to the pair alike; then K4 at one width past 128 channels."""
    rng = torch.Generator(device=dev).manual_seed(4)
    slope, eps = cfg.leaky_slope, cfg.pixel_norm_eps
    rows = []

    def library_of(x, w1, b1, w2, b2):
        mid_up = upsample_nearest_2x(conv_ops.conv3x3_plain(x, w1, b1, slope, True, eps))

        def library():  # the two convolutions alone, without epilogues or the upsample
            F.conv2d(x, w1, b1, padding=1)
            return F.conv2d(mid_up, w2, b2, padding=1)
        return library

    def work(bsz, cin, cmid, cout, h, w):
        px = bsz * h * w
        return (2.0 * px * cmid * 9 * cin + 2.0 * 4 * px * cout * 4 * cmid,
                4.0 * (px * cin + 4 * px * cout + 9 * cin * cmid + cmid + 16 * cmid * cout + cout))

    taken = []
    for i, (cin, cout) in enumerate(cfg.gen_channels):
        bsz, h, w = block_sizes(cfg, i)
        blk = gen.blocks[i]
        x = torch.randn(bsz, cin, h, w, generator=rng, device=dev)
        w1, b1 = blk.conv1.weight.detach(), blk.conv1.bias.detach()
        w2, b2 = blk.conv2.weight.detach(), blk.conv2.bias.detach()
        w1p, w2p = conv_ops.kernel_weights(w1), conv_ops.kernel_upconv_weights(w2)

        def kernel():
            return conv_ops.fused_block(x, w1, b1, w2, b2, slope, eps, w1_packed=w1p, w2_packed=w2p)

        def pair():
            mid = conv_ops.fused_conv3x3(x, w1, b1, slope, True, eps, w_packed=w1p)
            return conv_ops.fused_upconv3x3(mid, w2, b2, slope, True, eps, w_packed=w2p)

        takes = conv_ops.fused_block_fits(cin, cin, cout, size=(bsz, h, w), device=dev)
        large = pair_is_large(cin, cout, h, w)
        plan = conv_ops.block_plan(bsz, cin, cin, cout, h, w)
        if not takes:
            err = (kernel() - conv_ops.fused_block_plain(x, w1, b1, w2, b2, slope, eps)).abs().max().item()
            err_pair = (kernel() - pair()).abs().max().item()
            k_ms, p_ms = time_ms(kernel), time_ms(pair)
            print(f"[kernel] fused_block block {i} {(bsz, cin, cin, cout, h, w)} left to K1 then K3 "
                  f"(pair on the tensor cores: {large}; runs of 8 rows fill half the card: no): K4 {k_ms:.4f} ms, "
                  f"K1 then K3 {p_ms:.4f} ms, conv1 recompute {plan['recompute']:.3f}, err against plain "
                  f"{err:.2e} (tol {TOL['fused_block']:.0e}), against the pair {err_pair:.2e}")
            if not err <= TOL["fused_block"]:
                raise AssertionError(f"fused_block block {i} disagrees with its plain version")
            continue
        if not large:
            raise AssertionError(f"block {i}: K4 taken where K1 then K3 are not both on the tensor cores")
        taken.append(i)
        row = measure(
            "fused_block", (bsz, cin, cin, cout, h, w), kernel,
            lambda: conv_ops.fused_block_plain(x, w1, b1, w2, b2, slope, eps), library_of(x, w1, b1, w2, b2),
            *work(bsz, cin, cin, cout, h, w), route="large_tc",
        )
        row["err_pair"] = (kernel() - pair()).abs().max().item()
        row["equal_pair"] = bool(torch.equal(kernel(), pair()))
        row["pair_ms"] = time_ms(pair)
        row["block_plan"], row["tile"] = plan, conv_ops.block_tile(cin, cout)
        print(f"[kernel] fused_block block {i}: runs of {plan['run_rows']} rows x {conv_ops.BLOCK_STRIP} columns, "
              f"{plan['units']} units over {plan['blocks']} blocks, conv1 recompute {plan['recompute']:.3f}, "
              f"{row['tile']['smem_bytes']} B shared, {row['tile']['stages']} stages; against K1 then K3: "
              f"err {row['err_pair']:.2e} (tol {TOL_BLOCK_VS_PAIR:.0e}), bit for bit {row['equal_pair']}, "
              f"pair {row['pair_ms']:.4f} ms")
        if not row["err_pair"] <= TOL_BLOCK_VS_PAIR:
            raise AssertionError(f"fused_block block {i} disagrees with K1 then K3")
        rows.append(row)
    if 6 not in taken or 7 not in taken:
        raise AssertionError(f"blocks 6 and 7 must take K4; taken: {taken}")
    tot_k, tot_p = sum(r["ms"] for r in rows), sum(r["pair_ms"] for r in rows)
    print(f"[sums]   fused_block blocks {taken}: K4 {tot_k:.4f} ms, K1 then K3 {tot_p:.4f} ms, "
          f"bound {sum(r['bound_ms'] for r in rows):.4f} (3xTF32; bytes {sum(r['bytes_ms'] for r in rows):.4f})")

    # A width past 128 channels: each conv split over a cluster of blocks.
    bsz, cin, cmid, cout, h, w = WIDE_BLOCK
    x = torch.randn(bsz, cin, h, w, generator=rng, device=dev)
    w1 = torch.randn(cmid, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
    b1 = torch.randn(cmid, generator=rng, device=dev) * 0.1
    w2 = torch.randn(cout, cmid, 3, 3, generator=rng, device=dev) / (9 * cmid) ** 0.5
    b2 = torch.randn(cout, generator=rng, device=dev) * 0.1
    row = measure(
        "fused_block", WIDE_BLOCK, lambda: conv_ops.fused_block(x, w1, b1, w2, b2, slope, eps),
        lambda: conv_ops.fused_block_plain(x, w1, b1, w2, b2, slope, eps), library_of(x, w1, b1, w2, b2),
        *work(*WIDE_BLOCK), role="past_128", route="large_tc",
    )
    row["tile"] = conv_ops.block_tile(cmid, cout)
    print(f"[kernel] fused_block past 128 channels {WIDE_BLOCK}: a cluster of {row['tile']['cluster']} "
          f"blocks ({row['tile']['n1']} and {row['tile']['n2']} channels a block)")
    rows.append(row)
    return rows


def blocks_taking_k4(cfg: ModelConfig, dev, nb_vec: int, nb_music: int) -> int:
    """How many blocks of a synthesis call K4's size rule gives K4."""
    return sum(conv_ops.fused_block_fits(cin, cin, cout, size=block_sizes(cfg, i, nb_vec, nb_music), device=dev)
               for i, (cin, cout) in enumerate(cfg.gen_channels))


def warm_synthesis_s(synth, gen, z, n: int) -> list[float]:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        synth(gen, z)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def end_to_end_block(cfg: ModelConfig, dev, waves_default: np.ndarray) -> dict:
    """Phase 7, end to end: ``generate`` under ``conv_impl="pallas_block"``."""
    cfg_b = dataclasses.replace(cfg, conv_impl="pallas_block")
    n_fit = blocks_taking_k4(cfg, dev, NB_VEC, NB_MUSIC)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_block_")
    reset_launches()
    paths = generate_mod.generate(
        out_dir, cfg.rand_channels, str(CKPT), nb_vec=NB_VEC, nb_music=NB_MUSIC,
        seed=SEED, model_cfg=cfg_b, device="cuda",
    )
    torch.cuda.synchronize()
    launches = read_launches()
    expect = {
        "fused_block": n_fit, "fused_conv3x3": cfg.n_stages - n_fit,
        "fused_upconv3x3": cfg.n_stages - n_fit, "fused_conv3x3_msq": 0, "istft_fused": 1, IDFT: 0,
        "weight_grad3x3": 0,
    }
    print(f"[e2e-block] generate with conv_impl='pallas_block': launches {launches}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    waves = np.stack([load_wav(p)[0] for p in paths])
    err_wave = float(np.abs(waves - waves_default).max())
    print(f"[e2e-block] waveforms against the default path's: err {err_wave:.3e} (tol {TOL_WAVE:.0e})")
    if not (np.isfinite(waves).all() and err_wave <= TOL_WAVE):
        raise AssertionError("the K4 path's waveforms disagree with the default path's")

    # Warm synthesis under both values, in turns within this one process:
    # default, block, block, default, half of WARM_REPS each.
    z = main_path_latent(cfg, dev)
    gens = {
        "pallas_up": load_reference_generator(str(CKPT), cfg, device=dev),
        "pallas_block": load_reference_generator(str(CKPT), cfg_b, device=dev),
    }
    synth = generate_mod.synthesize_fn(cfg, cfg.n_stages - 1)
    times = {k: [] for k in gens}
    for k in gens:
        warm_synthesis_s(synth, gens[k], z, 2)
    for k in ("pallas_up", "pallas_block", "pallas_block", "pallas_up"):
        times[k] += warm_synthesis_s(synth, gens[k], z, WARM_REPS // 2)
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[e2e-block] warm synthesis, median of {WARM_REPS} each: conv_impl='pallas_up' "
          f"{med['pallas_up'] * 1e3:.3f} ms (min {min(times['pallas_up']) * 1e3:.3f}), "
          f"'pallas_block' {med['pallas_block'] * 1e3:.3f} ms (min {min(times['pallas_block']) * 1e3:.3f})")
    return {"launches": launches, "err_wave": err_wave, "warm_synthesis_s": times,
            "warm_synthesis_median_s": med, "fitting_blocks": n_fit}


def loop_trajectory(tcfg: TrainConfig, cfg: ModelConfig, n_iters: int, start: int = 0):
    """What the loop does over iterations ``start .. n_iters - 1``:
    ``(iterations by stage as {stage: [critic only, with generator]},
    stages at which a save fired)``, from a replay of its bookkeeping."""
    grower = Grower(fadein_lengths=tcfg.fadein_lengths, train_lengths=tcfg.train_lengths)
    by_stage, saves = {}, []
    for it in range(n_iters):
        stage = grower.curr_grow
        if it >= start:
            by_stage.setdefault(stage, [0, 0])[it % tcfg.n_critic == 0] += 1
            if (it + 1) % tcfg.save_every == 0:
                saves.append(stage)
        grower.grow(tcfg.batch_size)
    return by_stage, saves


def expected_loop_launches(tcfg: TrainConfig, cfg: ModelConfig, n_iters: int, start: int = 0) -> dict:
    """Launches of a ``train`` run: the train step's formula summed over the
    stage trajectory, plus one inference forward (K1 and K3 once a block)
    for the previews of every save."""
    by_stage, saves = loop_trajectory(tcfg, cfg, n_iters, start)
    total = {name: 0 for name in (*WRAPPERS, IDFT)}
    for stage, (n_d, n_dg) in by_stage.items():
        for k, v in expected_train_launches(cfg, stage, n_d, n_dg).items():
            total[k] += v
    for stage in saves:
        total["fused_conv3x3"] += stage + 1
        total["fused_upconv3x3"] += stage + 1
    return total


def run_train(name, ds, out, tcfg, cfg, show=True, **kw):
    """``train`` with its output captured (and shown): returns the state,
    the text, the counted launches and the wall seconds."""
    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        state = train(name, ds, out, tcfg, cfg, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    if show:
        print("".join(f"    | {line}\n" for line in text.splitlines()), end="")
    return state, text, read_launches(), wall


def state_diff(a, b) -> dict:
    """Two train states: what must be equal exactly, and each network's
    parameters and moments in the relative 2-norm and the largest
    absolute difference."""
    exact = {
        "iter_idx": int(a.iter_idx) == int(b.iter_idx),
        "rng": torch.equal(a.rng.get_state(), b.rng.get_state()),
        "counts": all(
            torch.equal(oa.count[k], ob.count[k])
            for oa, ob in ((a.opt_gen, b.opt_gen), (a.opt_disc, b.opt_disc)) for k in oa.count
        ),
    }
    groups = {
        "gen": (dict(a.gen.named_parameters()), dict(b.gen.named_parameters())),
        "disc": (dict(a.disc.named_parameters()), dict(b.disc.named_parameters())),
        "opt_gen.mu": (a.opt_gen.mu, b.opt_gen.mu), "opt_gen.nu": (a.opt_gen.nu, b.opt_gen.nu),
        "opt_disc.mu": (a.opt_disc.mu, b.opt_disc.mu), "opt_disc.nu": (a.opt_disc.nu, b.opt_disc.nu),
    }
    rel, worst = {}, 0.0
    for name, (ta, tb) in groups.items():
        va = torch.cat([ta[k].detach().flatten() for k in ta])
        vb = torch.cat([tb[k].detach().flatten() for k in ta])
        rel[name] = rel_l2(va, vb)
        worst = max(worst, (va - vb).abs().max().item())
    return {"exact": exact, "rel_l2": rel, "max_abs": worst}


def stage_rates(text: str) -> dict:
    """``{stage: (iterations, steps/s)}`` from the loop's own lines."""
    found = re.findall(r"stage (\d+): (\d+) iterations in [0-9.]+ s = ([0-9.]+) steps/s", text)
    return {int(s): (int(n), float(r)) for s, n, r in found}


def train_entry_point(cfg: ModelConfig, dev) -> dict:
    """Phase 8: ``train`` at full width through all eight stages."""
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    ds = os.path.join(work, "ds")
    writer = ShardWriter(ds, samples_per_shard=8)
    corpus = torch.randn(LOOP_SAMPLES, 2, 512, 512, generator=torch.Generator().manual_seed(SEED))
    writer.add(corpus.numpy())
    writer.close()
    del corpus
    tcfg = TrainConfig(**LOOP_CFG)
    half = LOOP_ITERS // 2

    # (a) uninterrupted, the corpus resident on the card.
    out_a = os.path.join(work, "a")
    state_a, text_a, launches, wall_a = run_train("smoke", ds, out_a, tcfg, cfg, max_iters=LOOP_ITERS)
    expect = expected_loop_launches(tcfg, cfg, LOOP_ITERS)
    by_stage, saves = loop_trajectory(tcfg, cfg, LOOP_ITERS)
    print(f"[loop] {LOOP_ITERS} iterations in {wall_a:.2f} s; iterations by stage "
          f"[critic only, with generator] {by_stage}; saves at stages {saves}; launches {launches}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    if sorted(by_stage) != list(range(cfg.n_stages)) or by_stage[cfg.n_stages - 1][0] < 3:
        raise AssertionError(f"the run did not pass through all stages: {by_stage}")
    if int(state_a.iter_idx) != LOOP_ITERS:
        raise AssertionError(f"iter_idx {int(state_a.iter_idx)}")
    with open(os.path.join(out_a, "metrics.csv")) as f:
        rows_a = list(csv.DictReader(f))
    if [int(r["step"]) for r in rows_a] != list(range(0, LOOP_ITERS, tcfg.log_every)):
        raise AssertionError(f"metrics.csv steps {[r['step'] for r in rows_a]}")
    for r in rows_a:
        if not all(math.isfinite(float(v)) for v in r.values() if v != ""):
            raise AssertionError(f"non-finite metrics row {r}")
    rates = stage_rates(text_a)
    if sorted(rates) != list(range(cfg.n_stages)):
        raise AssertionError(f"the loop reported rates for stages {sorted(rates)}")
    print("[loop] wall steps/s by stage inside the loop, saves and previews included "
          "(iterations): " + ", ".join(f"s{s} {r:.2f} ({n})" for s, (n, r) in sorted(rates.items())))
    ck_a = CheckpointManager(os.path.join(out_a, "checkpoints"))
    n_saves = LOOP_ITERS // tcfg.save_every
    if ck_a.saved_indices() != list(range(n_saves)):
        raise AssertionError(f"saves {ck_a.saved_indices()}")
    pngs = sorted(f for f in os.listdir(out_a) if f.endswith(".png"))
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    print(f"[loop] matplotlib importable: {have_mpl}; {len(pngs)} preview PNGs written")
    if have_mpl and len(pngs) != 2 * tcfg.nb_preview * n_saves:
        raise AssertionError(f"{len(pngs)} preview PNGs")

    # (b) as users run it, no cuDNN flag set by the caller: uninterrupted
    # again, and to half way by max_iters then on by resume.  All three
    # must be equal bit for bit.
    if torch.backends.cudnn.deterministic:
        raise AssertionError("cudnn.deterministic is set before the train runs")
    out_u, out_b = os.path.join(work, "u"), os.path.join(work, "b")
    state_u, _, launches_u, _ = run_train("smoke", ds, out_u, tcfg, cfg, show=False, max_iters=LOOP_ITERS)
    run_train("smoke", ds, out_b, tcfg, cfg, show=False, max_iters=half)
    state_b, text_b, launches_b, _ = run_train(
        "smoke", ds, out_b, tcfg, cfg, show=False, max_iters=LOOP_ITERS, resume=True)
    resume_line = f"[resume] save_{half // tcfg.save_every - 1}: iter={half}"
    if resume_line not in text_b:
        raise AssertionError("the second half did not resume from the half-way save")
    print(f"    | {next(line for line in text_b.splitlines() if line.startswith(resume_line))}")
    if launches_u != expect or launches_b != expected_loop_launches(tcfg, cfg, LOOP_ITERS, start=half):
        raise AssertionError(f"launch counts {launches_u} and, resumed, {launches_b}")
    diff = state_diff(state_u, state_b)
    metas = []
    for out in (out_u, out_b):
        with open(os.path.join(out, "checkpoints", f"save_{n_saves - 1}", "meta.json")) as f:
            metas.append(json.load(f))
    diff["exact"]["meta"] = metas[0] == metas[1]
    print(f"[loop] resumed at iteration {half} against uninterrupted, no cuDNN flag set: exact "
          f"{diff['exact']}; rel L2 {diff['rel_l2']}; largest absolute difference {diff['max_abs']:.3e} "
          f"(held at 0)")
    if not all(diff["exact"].values()) or max(diff["rel_l2"].values()) != 0.0 or diff["max_abs"] != 0.0:
        raise AssertionError(f"resume is not bit-exact: {diff}")
    spread = state_diff(state_a, state_u)
    print(f"[loop] two uninterrupted runs after {LOOP_ITERS} iterations: exact {spread['exact']}; rel L2 "
          f"{({k: float(f'{v:.3e}') for k, v in spread['rel_l2'].items()})}; largest absolute difference "
          f"{spread['max_abs']:.3e} (held at 0)")
    if not all(spread["exact"].values()) or max(spread["rel_l2"].values()) != 0.0 or spread["max_abs"] != 0.0:
        raise AssertionError(f"two uninterrupted runs differ: {spread}")
    del state_b, state_u

    # (d) streaming through the host pipeline (prepare_batch), stages 0-3.
    out_d = os.path.join(work, "d")
    tcfg_d = dataclasses.replace(tcfg, device_dataset="off")
    n_d = 8
    _, _, launches_d, _ = run_train("smoke", ds, out_d, tcfg_d, cfg, max_iters=n_d)
    if launches_d != expected_loop_launches(tcfg_d, cfg, n_d):
        raise AssertionError(f"streaming run's launch counts {launches_d}")
    with open(os.path.join(out_d, "metrics.csv")) as f:
        rows_d = list(csv.DictReader(f))
    worst = 0.0
    for ra, rd in zip(rows_a, rows_d):
        if (ra["step"], ra["stage"], ra["alpha"]) != (rd["step"], rd["stage"], rd["alpha"]):
            raise AssertionError(f"streaming row {rd} against resident {ra}")
        for k in ("disc_loss", "grad_pen", "e_tp", "e_tn", "gen_loss", "e_gen"):
            va, vd = float(ra[k]), float(rd[k])
            worst = max(worst, abs(va - vd))
            if not abs(va - vd) <= TOL_METRIC_ABS + TOL_METRIC_REL * abs(va):
                raise AssertionError(f"step {ra['step']} {k}: resident {va!r} vs streaming {vd!r}")
    print(f"[loop] streaming through prepare_batch, {n_d} iterations: the {len(rows_d)} logged rows agree "
          f"with the resident run's, largest difference {worst:.2e}")

    # (c) the CLI as a subprocess, sent SIGTERM once it logs an iteration.
    out_c = os.path.join(work, "c")
    cmd = [sys.executable, "-u", "-m", "musicgan_tpu_torch", "train", "smoke_cli", "-i", ds, "-o", out_c,
           "--batch-size", "6", "--log-every", "1", "--save-every", "100000", "--chunk-steps", "4"]
    proc = subprocess.Popen(cmd, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("e000 it"):
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text_c = "".join(lines) + rest
    print("".join(f"    | {line}\n" for line in text_c.splitlines()), end="")
    if proc.returncode != 75 or "[preempt] caught SIGTERM" not in text_c:
        raise AssertionError(f"the CLI exited {proc.returncode} after SIGTERM")
    ck_c = CheckpointManager(os.path.join(out_c, "checkpoints"))
    if ck_c.saved_indices() != [0]:
        raise AssertionError(f"the preempted run left saves {ck_c.saved_indices()}")
    pre, meta_c = ck_c.restore(0, init_train_state(SEED, cfg, TrainConfig(), device="cuda"))
    if int(pre.iter_idx) != meta_c["iter_idx"] or meta_c["iter_idx"] % 4 != 0 or meta_c["saver_counter"] != meta_c["iter_idx"]:
        raise AssertionError(f"the preemption save is not at a chunk's end: {meta_c}")
    print(f"[loop] CLI subprocess: SIGTERM -> exit code 75, complete save at iteration {meta_c['iter_idx']}")
    del pre

    # The Saver's image-computing half, called directly, at stage 7.
    saver = Saver(os.path.join(work, "previews"), tcfg, cfg)
    reset_launches()
    images = saver.preview_images(state_a, cfg.n_stages - 1, 1.0)
    got = read_launches()
    if images.shape != (tcfg.nb_preview, 512, 512, 2) or not np.isfinite(images).all() or np.abs(images).max() > 1.0:
        raise AssertionError(f"preview images {images.shape}")
    if (got["fused_conv3x3"], got["fused_upconv3x3"]) != (cfg.n_stages, cfg.n_stages):
        raise AssertionError(f"the previews launched {got}")
    drawn = saver.draw_previews(images, cfg.n_stages - 1) if have_mpl else []
    print(f"[loop] Saver.preview_images: {images.shape}, K1 and K3 {cfg.n_stages} launches each; "
          f"{len(drawn)} PNGs drawn")

    # The time of a save and of a restore (state to the host and a file, and back).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck_a.save(n_saves, state_a, metas[0])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck_a.restore(n_saves, init_train_state(SEED + 5, cfg, tcfg, device="cuda"))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    size = os.path.getsize(os.path.join(ck_a.root, f"save_{n_saves}", "state.pt"))
    print(f"[loop] a save {save_s * 1e3:.1f} ms, a restore {restore_s * 1e3:.1f} ms "
          f"(a fresh state's init included), state.pt {size / 2**20:.2f} MiB")

    # generate from the run directory (the checkpoint branch), through K4.
    cfg_b = dataclasses.replace(cfg, conv_impl="pallas_block")
    n_fit = blocks_taking_k4(cfg, dev, 2, 2)
    reset_launches()
    paths = generate_mod.generate(
        os.path.join(work, "wav"), cfg.rand_channels, out_a, nb_vec=2, nb_music=2, seed=SEED,
        model_cfg=cfg_b, device="cuda",
    )
    got = read_launches()
    want = {"fused_block": n_fit, "fused_conv3x3": cfg.n_stages - n_fit,
            "fused_upconv3x3": cfg.n_stages - n_fit, "fused_conv3x3_msq": 0, "istft_fused": 1, IDFT: 0,
            "weight_grad3x3": 0}
    if got != want:
        raise AssertionError(f"generate from the run directory launched {got}, not {want}")
    for p in paths:
        wave, sr = load_wav(p)
        if sr != 44100 or wave.shape != ((2 * 512 - 1) * 256,) or not np.isfinite(wave).all():
            raise AssertionError(f"{p}: {sr} Hz, {wave.shape}")
    if n_fit < 2:
        raise AssertionError(f"blocks 6 and 7 of a 2-clip, nb_vec-2 call must take K4: {n_fit} blocks did")
    print(f"[loop] generate from the run directory with conv_impl='pallas_block': {len(paths)} WAVs, launches {got}")

    total = {k: launches[k] + launches_u[k] + launches_b[k] + launches_d[k] for k in launches}
    return {
        "launches": total, "launches_uninterrupted": launches, "wall_s": wall_a,
        "iterations_by_stage": {str(k): v for k, v in by_stage.items()},
        "steps_per_s_by_stage": {str(s): r for s, (_, r) in rates.items()},
        "resume": diff, "uninterrupted_twice": spread, "streaming_worst_abs_diff": worst, "save_s": save_s, "restore_s": restore_s,
        "state_bytes": size, "matplotlib": have_mpl, "preempt_iter": meta_c["iter_idx"],
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
    e2e, waves = end_to_end(cfg, dev)
    torch.cuda.empty_cache()

    tcfg = TrainConfig()
    rows += check_train_kernels(cfg, tcfg, dev)
    print_row_sums(rows)
    grads = check_function_and_gp(cfg, tcfg, dev)
    torch.cuda.empty_cache()
    train_rec = train_path(cfg, tcfg, dev)
    torch.cuda.empty_cache()

    gen = load_reference_generator(str(CKPT), cfg, device=dev)
    rows += check_block_kernel(gen, cfg, dev)
    del gen
    torch.cuda.empty_cache()
    e2e_block = end_to_end_block(cfg, dev, waves)
    torch.cuda.empty_cache()
    loop = train_entry_point(cfg, dev)

    paths = (e2e, train_rec, e2e_block, loop)
    launched = {k: sum(p["launches"][k] for p in paths) for k in (*WRAPPERS, IDFT)}
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        # K5 has two routes, each its own entry; the iDFT route is on no path.
        groups = ([("fft", launched[name] - launched[IDFT]), ("idft", launched[IDFT])]
                  if name == "istft_fused" else [(None, launched[name])])
        for route_name, n_launched in groups:
            mine = [r for r in rows if r["name"] == name and r.get("route_name") == route_name]
            entry = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launched, "max_abs_err": max(r["max_abs_err"] for r in mine),
                **{k: sum(r[k] for r in mine) for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
                "bound_by": "operations" if sum(r["ops_ms"] for r in mine)
                >= sum(r["bytes_ms"] for r in mine) else "bytes",
            }
            if route_name is not None:
                entry["kernel_route"] = route_name
                entry["on_path"] = route_name == "fft"
            if all("plan" in r for r in mine):  # the conv template: its routes
                entry["conv_routes"] = sorted({r["route"] for r in mine})
            if all("bound_fp32_ms" in r for r in mine):  # and both bounds, K4's too
                for k in ("bound_fp32_ms", "bound_3xtf32_ms"):
                    entry[k] = sum(r[k] for r in mine)
            if name == "fused_block":
                entry["pair_ms"] = sum(r["pair_ms"] for r in mine if "pair_ms" in r)
                entry["max_abs_err_vs_pair"] = max(r["err_pair"] for r in mine if "err_pair" in r)
            kernels.append(entry)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "shapes": rows, "end_to_end": e2e, "gradients": grads, "train": train_rec,
         "end_to_end_block": e2e_block, "train_entry_point": loop, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
