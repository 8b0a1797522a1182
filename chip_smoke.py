#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis path, its WGAN-GP train step, its
``train`` entry point, its serving and evaluation entry points, its
ingest and run interchange, its conv_impl selection, its parallelism and
the mixed-dtype calls of its conv kernels on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit (``nvcc``).  Phases, each of which raises on failure:

1. print the card's name and power limit; build every kernel from
   ``musicgan_tpu_torch/csrc`` (one ``nvcc`` per source, all at once, each
   source's seconds printed) and, beside them, the native host tail of
   ``musicgan_tpu_torch/native``;
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
   the weight-gradient kernel at the 34 trainable convs against its plain
   version in float64, each with its launch plan (its route by the size
   rule) and both bounds, and the pass's sums by role, over the shapes up
   to 64x64 and by route beside the plain version's and cuDNN's default
   algorithms';
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
   run directory through K4; the time of a save and of a restore;
9. bf16 synthesis: K1, K3 and K4 in bf16 at the main path's shapes against
   their bf16 plain versions (one bf16 ulp + 1e-5 elementwise; K4, two
   roundings in a chain, 1e-2 in the relative 2-norm), K1 bf16 and K3 bf16
   (``csrc/conv_bf16.cuh``) each with its launch plan, its route
   (``small_bf16_tc`` or ``large_bf16_tc``) and tile, held equal to the
   plan mirror ``ops/conv_bf16.py::plan``; K4 bf16 (``csrc/block_bf16.cuh``)
   at every block with its plan, held equal to the mirror
   ``ops/conv_bf16.py::block_plan``, against K1 bf16 then K3 bf16 bit for
   bit and beside the pair's time, the blocks its size rule takes and those
   it leaves to the pair alike; K4 bf16 past 128 channels
   (``block3x3_bf16_wide.cu``: ``block_bf16.cuh`` over a cluster, on no
   path of this model) at phase 7's width and at a width of three ranks
   against the pair bit for bit with a bf16 and a float32 output, and
   against its plain version in the 2-norm; its template tier
   (``block3x3_bf16_template.cu``, inputs past 608 channels) at
   ``TEMPLATE_BLOCK`` against the pair and its plain version in the
   2-norm, in both output dtypes; each timed beside its plain
   version, ``F.conv2d`` on bf16 tensors and its bound (dense bf16 or
   bytes); ``generate`` once under each of ``pallas``, ``pallas_bf16``,
   ``pallas_up_bf16`` and ``pallas_block_bf16``, launches counted (the bf16
   ones apart; K4 bf16 exactly at the blocks the bf16 rule takes), the five
   WAVs checked, each image and waveform against the
   bf16 plain path on the card, the float32 default path (the bf16 image
   held at 0.08 in the relative 2-norm against both, ``pallas`` at 2e-3
   max-abs) and the plain path in float64; warm synthesis
   under ``pallas_up``, ``pallas_up_bf16``, ``pallas_block`` and
   ``pallas_block_bf16`` in turns; a generator past 128 channels
   (``WIDE_GEN_CHANNELS``, seeded random weights) at stage 7 on phase 9's
   latents under ``pallas_block_bf16`` against ``pallas_up_bf16``, bit
   for bit: under the bf16 rule (K4 bf16 at the blocks it gives it,
   launches counted: none, the cluster route being no faster than the
   pair), and with the rule made to take every block of the cluster route
   (K4 bf16 launched at each), each of those blocks timed beside the pair
   in rounds; the bf16 head kernel (``csrc/head1x1_bf16.cu``) at the
   synthesis cell's shape, block 7's output for 20 clips of nb_vec 10,
   against its plain version (2e-6), timed beside it, beside the library
   lowering's bf16 head and beside its bound (bytes); GANSynth's call
   (``port_bench/configs/gansynth-ifmel-h.json``, 122 notes): every K1 bf16
   and K3 bf16 shape of its generator, its head at 32 channels and K5 at
   n_fft 2048 against their plain versions, then one published-width call
   through ``synthesize_fn`` under ``pallas_up_bf16``, launches counted
   (K1 bf16 7, 4 of them over a cluster; K3 bf16 6, 3; head 1; K5 1; two
   mel products);
10. serving and evaluation: ``wav_to_stft`` and ``stft_to_phase_magn`` (the
   forward STFT half of ``view_audio``) on 3.5 s of seeded noise against
   the same in float64 on the card (2e-3); the ``SynthesisService`` with
   ``gen_final.pt`` at stage 7: a solo request at nb_vec 10 bit for bit
   ``synthesize_fn`` on its latent and within 1e-3 of the plain versions, 4
   concurrent requests in fewer dispatches each within 1e-3 of its solo
   pass, two signatures in separate dispatches, one dispatch under
   ``conv_impl="pallas_block"`` (K4 at the blocks its rule gives), every
   dispatch's launches counted (K1 8, K3 8, K5 1); the HTTP handler in the
   process (a POSTed WAV, whole and streamed, equal to the service's
   waveform; ``/healthz``, ``/stats``); the ``serve`` CLI as a subprocess,
   one request, SIGTERM; ``compare_artifacts`` of ``gen_final.pt`` twice
   (equal rows) and ``audition_run`` over phase 8's run; a solo request's
   latency and the throughput of 8 concurrent requests;
11. ingest and run interchange, at full width: 6 seeded 16-bit WAVs of 7-9
   s; a probe process (the port's ingest initialises no CUDA context, the
   native tail is built into ``_build/``, the native / numpy / torch tails
   of ``process_signal`` within 2e-6 and timed); ``python -m
   musicgan_tpu_torch create_dataset -w 2`` as a subprocess (``index.json``
   complete, the sample count), and ``create_dataset`` from this process,
   which has a CUDA context (a pool that does not fork, the same bytes);
   ``train`` as subprocesses: through all
   eight stages on phase 8's cut schedule with ``--profile`` (the trace
   names the port's conv and weight-gradient kernels), and with
   ``--debug-nans`` on the corpus (exit 0) and on a copy with one sample
   made NaN (a non-zero exit other than 75, naming the first op); ``export
   --full`` of the last save, loaded into reference-shaped modules and
   ``torch.optim.Adam``s grown as the reference's ``train.py`` grows them
   (``weights_only=True``; every weight, moment and step against the
   port's); ``import`` into a new run directory (equal to the save in every
   weight the format carries, every moment and count); ``generate`` from
   that directory and from the exported ``gen_{i}.pt`` (the same WAVs bit
   for bit, launches counted); ``train --resume`` for 4 iterations at stage
   7 (launches against ``expected_train_launches``); ``run_supervised``
   with the CLI's own ``supervised_command``, the first child sent SIGTERM (exit
   75), relaunched with ``--resume`` to exit 0 and the expected last save.
12. conv_impl selection (``ops/autotune.py``), in a fresh
   ``MUSICGAN_AUTOTUNE_DIR`` (phases 1-11 run their impls by name, and their
   CLI subprocesses through a table seeded with those winners): the six
   inference candidates at synth-5x10 timed and resolved, the winner
   persisted; both vocoders timed, K5 against the plain iSTFT at 1e-4;
   ``generate --conv-impl auto`` as a subprocess (no measurement) and in
   this process beside ``--conv-impl <winner>`` (the same launches, the
   same WAV bytes); ``generate`` under the library lowerings ``xla`` and
   ``subpixel`` (no conv kernel launched; image and waveform against the
   float32 plain path at phase 3's bars, as phase 3 holds the kernels, and
   the waveform against float64 too; warm times); at train-s7-b6 the
   four train impls timed, the first D+G iteration of each counted and held
   against the float64 plain step at phase 6's bars; ``bfloat16`` and
   ``bfloat16_f32gp`` training under ``xla`` finite, with steps/s beside
   float32 ``pallas_gp``'s; ``train()`` under "auto" through the eight
   stages (the impl each resolved to and what its measurement cost),
   stopped half way and resumed bit for bit; ``info`` as a subprocess.
13. parallelism (``musicgan_tpu_torch/parallel``), the only way one card
   allows: a request of nb_vec 16 (32 latent columns, 47.5 s of audio) from
   ``gen_final.pt`` through ``sharded_synthesize_fn`` on 2 and 4 shards,
   all on cuda:0 (launches K1 8, K3 8 and K5 1 a shard), against unsharded
   ``synthesize_fn`` at phase 3's waveform bar and beside float64, warm
   times of both (no claim: the shards run in turn, each widened by a
   3-column halo), and once more under "auto" in a fresh table (one
   float32 impl resolved for the clip under the widest shard's latent, the
   vocoder per shard length; every shard served by that impl, the waveform
   within 5e-4 (max abs, JAX's long-clip bar) of the unsharded float32
   one, and bit for bit the pinned clip where it picks ``pallas_up``; the
   relative 2-norms of the sharded and the unsharded float32 clips against
   float64 printed beside each other); the
   ``SynthesisService`` over 4 shards: a solo nb_vec 16 request takes the
   long-clip route bit for bit, three concurrent nb_vec 4 requests one
   batch; two ranks of the data-parallel step (``python3 chip_smoke.py
   --dp-rank``), both on cuda:0 so gloo by the backend rule, global batch 6
   at stage 7 under ``pallas_gp``: a D-only and a D+G iteration held
   against the one-process step from the same state, batch and noise
   (phase 6's bars on the updates, the metrics), the two ranks' states bit
   for bit equal, launches against ``expected_train_launches``, warm
   per-rank times and the all_reduces' ms and bytes; one D+G iteration in
   a one-rank NCCL group bit for bit the step without a group; ``train
   --coordinator / --num-processes 2 / --process-id`` as two subprocesses
   through the eight stages (rank 0 measures stage 7's train impls, rank 1
   takes its winner; only rank 0 writes), then SIGTERM to rank 1 (both
   exit 75) and ``--resume`` bit for bit the uninterrupted run.  NCCL
   across cards and shards on several cards are not run.
14. the mixed-dtype calls of K1-K4 (the JAX functions' bf16 ``x`` with
   ``out_dtype=float32`` and float32 ``x`` with ``out_dtype=bfloat16``;
   K2 with bf16 ``x``), each a kernel of its own that stores the output's
   type: K1 and K3 both ways at the 8 blocks of synth-5x10 (the shipped
   generator's weights), K4 both ways at blocks 4-7 and at phase 7's
   width past 128 channels, bf16 -> float32 at ``TEMPLATE_BLOCK`` (the
   template tier), K2 at the 16 generator convs of train-s7-b6;
   each driven once a shape with its launches counted, then held against
   its plain version (float32 in: the float32 bar plus one bf16 ulp; bf16
   in: the float32 bar, K4 the 2-norm) and its same-dtype kernel (float32
   in: that kernel's output rounded, bit for bit; bf16 in: rounded to bf16
   that kernel's bits, with values bf16 cannot hold; K4 bf16 -> float32:
   K1 bf16 then K3 bf16 -> float32 bit for bit, past 128 channels too,
   the template tier within the 2-norm), and
   timed beside both, its library call and its bound.  No path makes a
   mixed call: phases 2-13 each show 0 mixed launches.

The script stops every process it starts.  It is the subreaper of its
descendants, so a grandchild orphaned by its parent (the forkserver of the
``create_dataset`` subprocess) comes back to it; when it ends, pass or
fail, it stops the forkserver and the resource tracker of its own
``create_dataset`` pool, which would otherwise outlive it by a moment, and
then stops and reaps any child still there, naming each on stderr.

The last lines are a ``{"kernels": [...]}`` record, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.  Per-shape numbers also go
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import csv
import ctypes
import dataclasses
import filecmp
import functools
import io
import json
import math
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from scipy.io import wavfile

from musicgan_tpu_torch import generate as generate_mod
from musicgan_tpu_torch import native
from musicgan_tpu_torch.audio import (
    load_wav,
    mp_to_real_imag,
    save_wav,
    signal_to_stft,
    stft_to_phase_magn,
    wav_to_stft,
)
from musicgan_tpu_torch.audio import functions as audio_functions
from musicgan_tpu_torch.audio import ingest
from musicgan_tpu_torch.audio.ingest import ShardWriter
from musicgan_tpu_torch.audio.stft import hann_window, istft_real_imag
from musicgan_tpu_torch.config import AudioConfig, ModelConfig, TrainConfig
from musicgan_tpu_torch.evaluate import audition_run, compare_artifacts
from musicgan_tpu_torch.models import (
    Discriminator,
    Generator,
    critic_input_grad_nchw_train,
    load_reference_generator,
)
from musicgan_tpu_torch.models.layers import upsample_nearest_2x
from musicgan_tpu_torch.ops import _build
from musicgan_tpu_torch.ops import autotune
from musicgan_tpu_torch.ops import conv as conv_ops
from musicgan_tpu_torch.ops import conv_bf16
from musicgan_tpu_torch.ops import conv_vjp
from musicgan_tpu_torch.ops import head as head_ops
from musicgan_tpu_torch.ops import istft_fused as istft_ops
from musicgan_tpu_torch.serve import SynthesisService, _make_handler
from musicgan_tpu_torch.train import (
    CheckpointManager,
    Grower,
    Saver,
    build_chunk_step,
    build_step,
    init_train_state,
    train,
)
from musicgan_tpu_torch.utils import profiling
from musicgan_tpu_torch.utils.watchdog import EXIT_STALLED

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "saved_models" / "quality_r4" / "gen_final.pt"
NB_MUSIC, NB_VEC, SEED = 5, 10, 0
WARM_REPS = 20  # warm synthesis calls timed one by one; the median is quoted

# H100 SXM published peaks: float32 outside the tensor cores, TF32 on the
# tensor cores (dense), HBM3.  The conv template's large-image route
# (plan route "large_tc") and the weight-gradient kernel's tensor-core
# route (conv_vjp.WGRAD_TC) multiply in 3xTF32: three TF32 products for
# each float32 product, so their operations bound is 3 * flops / 495e12.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_S = 3.35e12
TC_ROUTES = ("large_tc", conv_vjp.WGRAD_TC)

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
# K4 bf16 past 128 channels over a cluster of three ranks (272 and 288
# channels: three splits of 96 each).
THREE_RANK_BLOCK = (5, 272, 272, 288, 16, 160)
# K4 bf16's template tier (widths ops/conv_bf16.py::cluster_fits refuses:
# inputs past 608 channels, at these c1 and output widths): block3x3.cuh at
# bf16.
TEMPLATE_BLOCK = (1, 640, 640, 640, 4, 40)
# A generator past 128 channels (phase 9): the shipped model's depth and
# latents with its blocks widened (K4 bf16's cluster route at every block
# the bf16 rule gives it; block 0 with one split of conv1, block 7 with one
# of conv2).
WIDE_GEN_CHANNELS = ((32, 256), (256, 256), (256, 256), (256, 256), (256, 192), (192, 160), (160, 144), (144, 128))
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
    # No Pallas kernel: XLA's head (_head_nchw) in the JAX package; bf16 in.
    "head1x1": ("musicgan_tpu_torch/csrc/head1x1_bf16.cu", "musicgan_tpu/models/generator.py:250"),
}
IDFT = "istft_fused.idft"  # K5's second route, counted apart in read_launches
WRAPPERS = {
    "fused_conv3x3": conv_ops.fused_conv3x3,
    "fused_conv3x3_msq": conv_ops.fused_conv3x3_msq,
    "fused_upconv3x3": conv_ops.fused_upconv3x3,
    "istft_fused": istft_ops.istft_fused,
    "fused_block": conv_ops.fused_block,
    "weight_grad3x3": conv_vjp.weight_grad3x3,
    "head1x1": head_ops.head1x1,
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
    return generate_mod.latents(cfg, NB_VEC, NB_MUSIC, SEED, dev)


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
    for the routes of TC_ROUTES, else float32 FMA) and its bytes at the
    memory rate."""
    ops = 3 * flops / PEAK_TF32_FLOPS if route in TC_ROUTES else flops / PEAK_FP32_FLOPS
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
    route (K4: "large_tc"; the weight gradient: its plan's); ``ref``,
    where given, is the plain version the error is read against (the
    weight gradient's, in float64), ``plain`` is then only timed."""
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
        mock.patch.object(conv_ops, "fused_conv3x3",
                          lambda *a, w_packed=None, out_dtype=None: conv_ops.conv3x3_plain(*a, out_dtype=out_dtype)),
        mock.patch.object(conv_ops, "fused_upconv3x3",
                          lambda *a, w_packed=None, out_dtype=None: conv_ops.upconv3x3_plain(*a, out_dtype=out_dtype)),
        mock.patch.object(generate_mod, "istft_fused", istft_real_imag),
        mock.patch.object(head_ops, "head1x1", head_ops.head1x1_plain),
    ]


def istft_float64(real, imag, n_fft: int, hop: int, normalized: bool = True) -> torch.Tensor:
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
    scale = torch.sqrt(torch.sum(window**2)) if normalized else 1.0
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
        if hasattr(fn, "bf16_launches"):
            fn.bf16_launches = 0
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
        "weight_grad3x3": 0, "head1x1": 0,
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
            waves64 = generate_mod._synthesize(gen64, z64, cfg.n_stages - 1, cfg, "pallas")
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
    yardstick).  Each row keeps the launch plan and its route (3xTF32 on
    the tensor cores, or float32 FMAs for images up to 16x16), so its
    bound is the route's and both bounds are kept.  The output gradient is scaled by 1 / sqrt(pixels) so that the
    weight gradient is of order 1."""
    rows = []
    for bsz, cin, cout, h, w in shapes:
        x = torch.randn(bsz, cin, h, w, generator=rng, device=dev)
        d = torch.randn(bsz, cout, h, w, generator=rng, device=dev) / (bsz * h * w) ** 0.5
        shape = (cout, cin, 3, 3)
        px = bsz * h * w
        plan = conv_vjp.wgrad_kernel_plan(bsz, cin, cout, h, w)
        if plan["route"] == conv_vjp.WGRAD_TC:
            how = (f"wgmma N {3 * plan['nb']} ({plan['nb']} output channels x 3 ky) x {plan['nsplit']}, "
                   f"{plan['tiles']} m64 tiles a block x {plan['groups']}, chunks of {plan['tr']}x{plan['tc']}, "
                   f"{plan['stages']} stages, {plan['kblocks']} runs of up to {plan['cpb']} chunks")
        else:
            how = (f"{plan['nti']} x {plan['nto']} tiles of 32 x 32 channels, a cluster of {plan['cluster']} "
                   f"a tile, {plan['rpb']} image rows a block in chunks of {plan['rch']}")
        print(f"[plan]   weight_grad3x3    {role:10s} {str((bsz, cin, cout, h, w)):26s} {plan['route']}, "
              f"{how}, {plan['blocks']} blocks, {plan['smem']} B")
        ref = conv_vjp.weight_grad3x3_plain(x.double(), d.double(), shape).float()
        rows.append(measure(
            "weight_grad3x3", (bsz, cin, cout, h, w), lambda: conv_vjp.weight_grad3x3(x, d, shape),
            lambda: conv_vjp.weight_grad3x3_plain(x, d, shape),
            lambda: torch.nn.grad.conv2d_weight(x, shape, d, padding=1),
            2.0 * px * cin * cout * 9, 4.0 * (px * cin + px * cout + 9 * cin * cout), role=role,
            route=plan["route"], ref=lambda: ref,
        ))
        rows[-1]["wgrad_plan"] = plan
        rows[-1]["plain_err_vs_float64"] = (conv_vjp.weight_grad3x3_plain(x, d, shape) - ref).abs().max().item()
        print(f"[kernel] weight_grad3x3    {role:10s} {str((bsz, cin, cout, h, w)):26s} cuDNN float32 against "
              f"the plain version in float64: {rows[-1]['plain_err_vs_float64']:.2e}")
        del x, d, ref
    return rows


def print_wgrad_sums(rows) -> None:
    """The weight gradient's pass summed by role, over all 34 convs, over
    those up to 64x64 and over each route's: kernel, plain version and
    cuDNN's default, both bounds and the share of the route's; and the
    slowest shape up to 64x64 against cuDNN's default."""
    mine = [r for r in rows if r["name"] == "weight_grad3x3"]
    parts = {"all": lambda r: True, "up to 64x64": lambda r: r["shape"][3] <= 64}
    parts.update({route: lambda r, route=route: r["route"] == route for route in conv_vjp.WGRAD_ROUTES})
    for role in ("gen", "critic", "all"):
        for part, keep in parts.items():
            sel = [r for r in mine if role in ("all", r["role"]) and keep(r)]
            if not sel:
                continue
            tot = {k: sum(r[k] for r in sel) for k in
                   ("ms", "plain_ms", "library_ms", "bound_ms", "bound_fp32_ms", "bound_3xtf32_ms")}
            print(f"[wgrad]  {role:6s} {part:11s} {len(sel):2d} shapes: kernel {tot['ms']:.4f} ms, plain "
                  f"{tot['plain_ms']:.4f}, cuDNN default {tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f} "
                  f"(FP32 {tot['bound_fp32_ms']:.4f}, 3xTF32 {tot['bound_3xtf32_ms']:.4f}), share "
                  f"{tot['bound_ms'] / tot['ms']:.2f}")
    small = [r for r in mine if r["shape"][3] <= 64]
    worst = max(small, key=lambda r: r["ms"] / r["library_ms"])
    print(f"[wgrad]  slowest against cuDNN's default up to 64x64: {worst['role']} {tuple(worst['shape'])} "
          f"{worst['ms']:.4f} ms against {worst['library_ms']:.4f} ({worst['ms'] / worst['library_ms']:.2f}x)")


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
        "weight_grad3x3": n * 3 * c + n_d_and_g * g, "head1x1": 0,
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


def blocks_taking_k4(cfg: ModelConfig, dev, nb_vec: int, nb_music: int, dtype=torch.float32) -> int:
    """How many blocks of a synthesis call K4's size rule (``dtype``'s)
    gives K4."""
    return sum(conv_ops.fused_block_fits(cin, cin, cout, size=block_sizes(cfg, i, nb_vec, nb_music), device=dev,
                                         dtype=dtype)
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
        "weight_grad3x3": 0, "head1x1": 0,
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
    # synthesize_fn's model config, not the generator's, picks the impl.
    synths = {k: generate_mod.synthesize_fn(c, cfg.n_stages - 1) for k, c in (("pallas_up", cfg), ("pallas_block", cfg_b))}
    times = {k: [] for k in gens}
    for k in gens:
        warm_synthesis_s(synths[k], gens[k], z, 2)
    for k in ("pallas_up", "pallas_block", "pallas_block", "pallas_up"):
        times[k] += warm_synthesis_s(synths[k], gens[k], z, WARM_REPS // 2)
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
    """Launches of a ``train`` run under ``conv_impl="pallas_gp"``: the
    train step's formula summed over the stage trajectory, plus one forward
    for the previews of every save, through the run's conv_impl as JAX's
    Saver runs it: the trainable kernels' forward, K2 twice a block."""
    by_stage, saves = loop_trajectory(tcfg, cfg, n_iters, start)
    total = {name: 0 for name in (*WRAPPERS, IDFT)}
    for stage, (n_d, n_dg) in by_stage.items():
        for k, v in expected_train_launches(cfg, stage, n_d, n_dg).items():
            total[k] += v
    for stage in saves:
        total["fused_conv3x3_msq"] += 2 * (stage + 1)
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
    # Under an inference impl the previews are K1 and K3 (a run's Saver
    # previews through the run's conv_impl).
    saver = Saver(os.path.join(work, "previews"), tcfg, dataclasses.replace(cfg, conv_impl="pallas_up"))
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
            "weight_grad3x3": 0, "head1x1": 0}
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
        "run_dir": out_a,
    }


# ---------------------------------------------------------------------------
# Phase 9: bf16 synthesis (conv_impl "pallas_bf16", "pallas_up_bf16",
# "pallas_block_bf16") and the float32 "pallas" impl.

# H100 SXM dense bf16 on the tensor cores: the operations bound of a bf16
# kernel, whatever route it takes.
PEAK_BF16_FLOPS = 989e12
# A bf16 kernel against its plain version (float32 on the same bf16
# operands, rounded once): within one bf16 ulp elementwise, plus 1e-5 for
# results near zero whose float32 sums, taken in another order, fall on
# the two sides of LeakyReLU's kink.
BF16_ULP, BF16_ABS = 2.0**-7, 1e-5
# K4 bf16 against its plain version: two bf16 roundings in a chain.  K4
# equals K1 bf16 then K3 bf16 bit for bit (held), and each of those is
# within one ulp of its plain version (held); but where conv1's output
# lands one ulp off the plain one, conv2 and PixelNorm carry that into
# every output that reads it as an absolute change, |w2| x ulp(c1) x the
# pixel's scale, which no ulp of the output bounds (outputs near zero;
# this phase prints how many outputs lie past one ulp, about 1e-4 of them
# on an H100).  So K4 is held against its plain version in the 2-norm,
# relative: bf16's own rounding is 2^-9 rms; 1e-2.
TOL_K4_BF16_L2 = 1e-2
# The bf16 image against the float32 default path's, in the 2-norm relative
# to it.  bf16 rounds every activation (2^-9 relative) and 16 convs,
# PixelNorm and the phase head's tanh compound it: on this generator the
# exact bf16 path (the plain versions, the JAX package's semantics) lies
# about 0.03 from float32 (this phase prints it), almost all of it in the
# phase channel, with
# single pixels far apart where the phase's tanh saturates the other way,
# and so does the JAX package's own "pallas_up_bf16"
# (tests/test_torch_bf16.py::test_bf16_synthesis_of_the_shipped_generator_matches_jax).
# The JAX package's max-abs bar of 0.08 (its TINY_MODEL at random init) does
# not transfer to the trained generator.  Held at 0.08 in the 2-norm, for
# the kernels against the float32 path and against the bf16 plain path
# alike; the max-abs differences are printed.
TOL_IMAGE_BF16_L2 = 0.08
BF16_SOURCES = {
    "fused_conv3x3_bf16": ("musicgan_tpu_torch/csrc/conv3x3_bf16.cu", "musicgan_tpu/ops/conv.py:90"),
    "fused_upconv3x3_bf16": ("musicgan_tpu_torch/csrc/upconv3x3_bf16.cu", "musicgan_tpu/ops/conv.py:139"),
    "fused_block_bf16": ("musicgan_tpu_torch/csrc/block3x3_bf16.cu", "musicgan_tpu/ops/conv.py:234"),
}
BF16_WRAPPERS = {
    "fused_conv3x3_bf16": conv_ops.fused_conv3x3,
    "fused_upconv3x3_bf16": conv_ops.fused_upconv3x3,
    "fused_block_bf16": conv_ops.fused_block,
}
NEW_IMPLS = ("pallas", "pallas_bf16", "pallas_up_bf16", "pallas_block_bf16")


def read_bf16_launches() -> dict:
    return {name: fn.bf16_launches for name, fn in BF16_WRAPPERS.items()}


def bf16_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, int]:
    """Max abs difference of two bf16 tensors and how many elements lie
    past one bf16 ulp (+ ``BF16_ABS``)."""
    if got.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16 or got.shape != ref.shape:
        raise AssertionError(f"bf16 check of {got.dtype} {tuple(got.shape)} against {ref.dtype} {tuple(ref.shape)}")
    a, b = got.float(), ref.float()
    diff = (a - b).abs()
    bad = int((diff > BF16_ULP * torch.maximum(a.abs(), b.abs()) + BF16_ABS).sum())
    return diff.max().item(), bad


def measure_bf16(name, shape, kernel, plain, library, flops, nbytes, plan=None, l2_tol=None) -> dict:
    """One bf16 kernel at one main-path shape: held within one bf16 ulp
    (+ ``BF16_ABS``) of its plain version elementwise, or, with ``l2_tol``,
    within that in the 2-norm relative to it (raises otherwise); its time,
    the plain version's and the library call's, and its bound (operations
    at dense bf16, bytes at the memory rate, the larger)."""
    got, ref = kernel(), plain()
    err, past_one = bf16_err(got, ref)
    l2 = rel_l2(got.float(), ref.float())
    if (past_one if l2_tol is None else not l2 <= l2_tol):
        raise AssertionError(f"{name} {shape}: {past_one} elements past one bf16 ulp of the plain version, "
                             f"max abs err {err:.3e}, relative 2-norm {l2:.3e} (tol {l2_tol})")
    del got, ref
    t_ops, t_bytes = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_S
    row = {
        "name": name, "role": "synthesis", "dtype": "bfloat16", "shape": shape, "max_abs_err": err,
        "ms": time_ms(kernel), "plain_ms": time_ms(plain), "library_ms": time_ms(library),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "ops_ms": t_ops, "bytes_ms": t_bytes, "flops": flops, "bytes": nbytes, "past_one_ulp": past_one,
        "l2_err": l2,
    }
    where = ""
    if plan is not None:
        row["plan"], row["route"] = plan, plan["route"]
        where = (f"  [{plan['route']}, tile {plan['nb']} x {plan['th']} x {plan['tc']} (images x rows x "
                 f"columns), {plan['mb']} m64 blocks x {plan['ppb']} phases, weights "
                 f"{'resident' if plan['resident'] else 'streamed'}, {plan['stages']} stages, "
                 f"{plan['nwg']} warpgroups, cluster of {plan['cluster']}, {plan['ntiles']} tiles, "
                 f"{plan['blocks']} blocks, {plan['smem_bytes']} B shared]")
    print(f"[bf16]   {name:20s} {str(shape):26s} err {err:.2e} ({past_one} past one ulp, 2-norm {l2:.1e})"
          f"  kernel {row['ms']:.4f} ms"
          f"  plain {row['plain_ms']:.4f}  library {row['library_ms']:.4f} ({row['ms'] / row['library_ms']:.2f}x)"
          f"  bound {row['bound_ms']:.4f} ({row['bound_by']}: ops {t_ops:.4f}, bytes {t_bytes:.4f})"
          f"  share {row['bound_ms'] / row['ms']:.2f}{where}")
    return row


def bf16_plan(kind: str, bsz: int, cin: int, cout: int, h: int, w: int, dev) -> dict:
    """K1 bf16 / K3 bf16's launch plan at these sizes, held equal to the plan
    mirror ``ops/conv_bf16.py::plan`` at the card's SM count."""
    plan = conv_ops.conv_plan(kind, bsz, cin, cout, h, w, True, torch.bfloat16)
    mirror = conv_bf16.plan(3 if kind == "conv3x3" else 2, bsz, cin, cout, h, w, True,
                            torch.cuda.get_device_properties(dev).multi_processor_count)
    keys = ("route", "tc", "th", "nb", "ntiles", "resident", "stages", "nwg", "blocks", "smem_bytes", "n",
            "nsplit", "cluster", "mb", "ppb")
    if any(plan[k] != mirror[k] for k in keys):
        raise AssertionError(f"{kind} bf16 {(bsz, cin, cout, h, w)}: the launcher's plan "
                             f"{ {k: plan[k] for k in keys} } is not the mirror's { {k: mirror[k] for k in keys} }")
    return plan


def k4_bf16_plan(bsz: int, cin: int, cmid: int, cout: int, h: int, w: int, dev) -> dict:
    """K4 bf16's launch plan at these sizes, held equal to the plan mirror
    ``ops/conv_bf16.py::block_plan`` at the card's SM count."""
    plan = conv_ops.block_plan(bsz, cin, cmid, cout, h, w, dtype=torch.bfloat16)
    mirror = conv_bf16.block_plan(bsz, cin, cmid, cout, h, w, torch.cuda.get_device_properties(dev).multi_processor_count)
    keys = (("tc", "tc"), ("run_rows", "run"), ("units", "units"), ("blocks", "blocks"), ("nwg", "nwg"),
            ("res1", "res1"), ("res2", "res2"), ("stages", "stages"), ("smem_bytes", "smem_bytes"), ("cost", "cost"),
            ("pair_cost", "pair_cost"), ("takes", "takes"), ("cluster", "cluster"), ("nsplit1", "nsplit1"),
            ("nsplit2", "nsplit2"))
    if any(plan[k] != mirror[m] for k, m in keys):
        raise AssertionError(f"K4 bf16 {(bsz, cin, cmid, cout, h, w)}: the launcher's plan "
                             f"{ {k: plan[k] for k, _ in keys} } is not the mirror's { {m: mirror[m] for _, m in keys} }")
    return plan


def wide_bf16_row(shape, rng, slope: float, eps: float, dev) -> dict:
    """K4 bf16 past 128 channels at ``shape`` (random weights): its route by
    the widths (``conv_bf16.block_route``) and plan, against K1 bf16 then K3
    bf16 with a bf16 and with a float32 output (the float32 one rounded to
    bf16 is the bf16 one), against its plain version in the 2-norm, timed
    beside the pair, two bf16 ``F.conv2d`` and its bound.  The cluster route
    (plan held to the mirror) gives the pair's bits; the template (inputs too
    wide for the cluster, ``block3x3.cuh`` at bf16, its own weight layout
    made ahead) sums in another order, so it is held to the pair in the
    2-norm, as K4 bf16 to its plain version."""
    bsz, cin, cmid, cout, h, w = shape
    bf = torch.bfloat16
    route = conv_bf16.block_route(cmid, cout, cin)
    if route == "bf16_tc":
        raise AssertionError(f"{shape} takes K4 bf16's narrow route")
    kplan = (k4_bf16_plan(bsz, cin, cmid, cout, h, w, dev) if route == "bf16_cluster"
             else conv_ops.block_plan(bsz, cin, cmid, cout, h, w, dtype=bf))
    x = torch.randn(bsz, cin, h, w, generator=rng, device=dev).to(bf)
    w1 = torch.randn(cmid, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
    b1 = torch.randn(cmid, generator=rng, device=dev) * 0.1
    w2 = torch.randn(cout, cmid, 3, 3, generator=rng, device=dev) / (9 * cmid) ** 0.5
    b2 = torch.randn(cout, generator=rng, device=dev) * 0.1
    w1t, w2t = conv_ops.kernel_weights_tc(w1), conv_ops.kernel_weights_tc(w2, True)
    w1k, w2k = ((w1t, w2t) if route == "bf16_cluster"
                else (conv_ops.kernel_weights(w1, bf), conv_ops.kernel_upconv_weights(w2, bf)))
    w1b, b1b, w2b, b2b = w1.to(bf), b1.to(bf), w2.to(bf), b2.to(bf)
    mid_up = upsample_nearest_2x(conv_ops.conv3x3_plain(x, w1, b1, slope, True, eps))

    def kernel(out=bf):
        return conv_ops.fused_block(x, w1, b1, w2, b2, slope, eps, w1_packed=w1k, w2_packed=w2k, out_dtype=out)

    def pair(out=bf):
        mid = conv_ops.fused_conv3x3(x, w1, b1, slope, True, eps, w_packed=w1t, out_dtype=bf)
        return conv_ops.fused_upconv3x3(mid, w2, b2, slope, True, eps, w_packed=w2t, out_dtype=out)

    def library():
        F.conv2d(x, w1b, b1b, padding=1)
        return F.conv2d(mid_up, w2b, b2b, padding=1)

    px = bsz * h * w
    row = measure_bf16(
        "fused_block_bf16", shape, kernel, lambda: conv_ops.fused_block_plain(x, w1, b1, w2, b2, slope, eps),
        library, 2.0 * px * cin * 9 * cmid + 2.0 * 4 * px * cout * 4 * cmid,
        2.0 * (px * cin + 4 * px * cout + 9 * cin * cmid + 16 * cmid * cout) + 4.0 * (cmid + cout),
        l2_tol=TOL_K4_BF16_L2,
    )
    # The float32 output's comparison is no path's call: its mixed launches
    # are not counted (phases 1-13 must show none).
    counts = {fn: (fn.launches, fn.mixed_launches) for fn in (conv_ops.fused_block, conv_ops.fused_upconv3x3)}
    y, y32 = kernel(), kernel(torch.float32)
    want, want32 = pair(), pair(torch.float32)
    row.update(role="wide" if route == "bf16_cluster" else "template", block=None, k4_plan=kplan, route_name=route,
               equal_pair=bool(torch.equal(y, want)), equal_pair_f32=bool(torch.equal(y32, want32)),
               l2_vs_pair=rel_l2(y.float(), want.float()), l2_vs_pair_f32=rel_l2(y32, want32),
               f32_rounded_is_bf16=bool(torch.equal(y32.to(bf), y)), pair_ms=time_ms(pair))
    for fn, (n, m) in counts.items():
        fn.launches, fn.mixed_launches = n, m
    if route == "bf16_cluster":
        how = (f"a cluster of {kplan['cluster']} (splits {kplan['nsplit1']} / {kplan['nsplit2']}), strip "
               f"{kplan['tc']}, runs of {kplan['run_rows']}, {kplan['units']} units over {kplan['blocks']} blocks, "
               f"{kplan['stages']} stages, {kplan['smem_bytes']} B shared, modelled {kplan['cost']} against the "
               f"pair's {kplan['pair_cost']} (takes {kplan['takes']})")
        agree = row["equal_pair"] and row["equal_pair_f32"]
    else:
        how = f"block3x3.cuh at bf16, a cluster of {kplan['cluster']}, {kplan['blocks']} blocks"
        agree = row["l2_vs_pair"] <= TOL_K4_BF16_L2 and row["l2_vs_pair_f32"] <= TOL_K4_BF16_L2
    print(f"[bf16]   fused_block_bf16 past 128 channels {shape}: route {route} ({_block_source(route)}), {how}; "
          f"against K1 bf16 then K3 bf16 bit for bit: bf16 out {row['equal_pair']}, float32 out "
          f"{row['equal_pair_f32']} (2-norm {row['l2_vs_pair']:.2e} / {row['l2_vs_pair_f32']:.2e}, tol "
          f"{TOL_K4_BF16_L2:.0e} where the sums differ), float32 rounded = bf16 {row['f32_rounded_is_bf16']}; K4 "
          f"{row['ms']:.4f} ms, pair {row['pair_ms']:.4f} ms, two bf16 F.conv2d {row['library_ms']:.4f}, bound "
          f"{row['bound_ms']:.4f} ({row['bound_by']})")
    if not (agree and row["f32_rounded_is_bf16"]):
        raise AssertionError(f"K4 bf16 past 128 channels {shape} ({route}) disagrees with K1 bf16 then K3 bf16")
    del x, mid_up, y, y32, want, want32
    return row


# The synthesis cell's call (port_bench's synth-offline-b20x10): 20 clips of
# nb_vec 10, so the stage-7 head's input is (20, 16, 512, 5120).  The kernel
# and its plain version both sum in float32, in other orders.
HEAD_CLIPS = 20
TOL_HEAD = 2e-6


def check_head_kernel(gen, cfg: ModelConfig, dev) -> list[dict]:
    """Phase 9 (d): the bf16 head kernel at the synthesis cell's shape with
    the shipped generator's stage-7 head (:func:`head_row`)."""
    stage = cfg.n_stages - 1
    cin, side = cfg.gen_channels[stage][1], 2**cfg.n_stages
    shape = (HEAD_CLIPS, cin, cfg.latent_height * side, cfg.latent_width * NB_VEC * side)
    head = gen.heads[stage]
    return [head_row(shape, head.weight.detach()[:, :, 0, 0], head.bias.detach(), dev, "synthesis", SEED + 21)]


def head_row(shape, w, b, dev, role: str, seed: int) -> dict:
    """The bf16 head kernel on a random bf16 activation of ``shape`` with the
    head ``w`` ``(2, cin)``, ``b``, against its plain version (the upcast,
    the float32 batched product, the bias, tanh: four launches) at
    ``TOL_HEAD`` and twice the same bits; timed beside it, beside the library
    lowering's bf16 head (a bf16 1x1 ``F.conv2d`` and tanh) and beside its
    bound: the bf16 input read once and the float32 image written once
    (float32 products outside the tensor cores)."""
    cin = shape[1]
    wb, bb = w[:, :, None, None].to(torch.bfloat16), b.to(torch.bfloat16)
    x = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(seed), device=dev).to(torch.bfloat16)

    def kernel():
        return head_ops.head1x1(x, w, b)

    def plain():
        return head_ops.head1x1_plain(x, w, b)

    def library():
        return torch.tanh(F.conv2d(x, wb, bb))

    got = kernel()
    err = (got - plain()).abs().max().item()
    repeatable = bool(torch.equal(got, kernel()))
    del got
    if not (err <= TOL_HEAD and repeatable):
        raise AssertionError(f"head1x1 {shape}: max abs err {err:.3e} from its plain version (tol {TOL_HEAD:.0e}), "
                             f"twice the same bits {repeatable}")
    px = shape[0] * shape[2] * shape[3]
    flops, nbytes = 4.0 * px * cin, 2.0 * px * cin + 4.0 * 2 * px
    t_ops, t_bytes = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_S
    row = {
        "name": "head1x1", "role": role, "dtype": "bfloat16", "shape": shape, "max_abs_err": err,
        "repeatable": repeatable, "ms": time_ms(kernel), "plain_ms": time_ms(plain), "library_ms": time_ms(library),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "ops_ms": t_ops, "bytes_ms": t_bytes, "flops": flops, "bytes": nbytes,
    }
    print(f"[bf16]   head1x1 {role} {shape}: err {err:.2e} (tol {TOL_HEAD:.0e}), twice the same bits; kernel "
          f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ({row['plain_ms'] / row['ms']:.2f}x)  library "
          f"{row['library_ms']:.4f}  bound {row['bound_ms']:.4f} ({row['bound_by']}: ops {t_ops:.4f}, bytes "
          f"{t_bytes:.4f})  share {row['bound_ms'] / row['ms']:.2f}")
    del x
    return row


def _block_source(route: str) -> str:
    return {"bf16_cluster": "block3x3_bf16_wide.cu", "template": "block3x3_bf16_template.cu"}[route]


def check_bf16_kernels(gen, cfg: ModelConfig, dev) -> list[dict]:
    """Phase 9: K1, K3 and K4 in bf16 at the main path's shapes (5 clips x
    nb_vec 10, the shipped generator's weights): each against its bf16
    plain version, with their times and bounds; K4 bf16 at every block
    against K1 bf16 then K3 bf16 bit for bit and beside the pair's time, with
    its plan (held to the mirror) and whether the bf16 rule takes it (the
    blocks it leaves to the pair are timed too, and kept out of the kernels
    record's sums).  The library call: ``F.conv2d`` on bf16 tensors without
    the epilogue (for K3 on the upsampled input; for K4 both convs)."""
    rng = torch.Generator(device=dev).manual_seed(9)
    slope, eps, bf = cfg.leaky_slope, cfg.pixel_norm_eps, torch.bfloat16
    rows = []
    for i, (cin, cout) in enumerate(cfg.gen_channels):
        bsz, h, w = block_sizes(cfg, i)
        blk = gen.blocks[i]
        x = torch.randn(bsz, cin, h, w, generator=rng, device=dev).to(bf)
        w1, b1 = blk.conv1.weight.detach(), blk.conv1.bias.detach()
        w2, b2 = blk.conv2.weight.detach(), blk.conv2.bias.detach()
        w1t, w2t = conv_ops.kernel_weights_tc(w1), conv_ops.kernel_weights_tc(w2, True)  # K1 bf16's, K3 bf16's, K4 bf16's
        w1b, b1b, w2b, b2b = w1.to(bf), b1.to(bf), w2.to(bf), b2.to(bf)
        xu = upsample_nearest_2x(x)
        px = bsz * h * w
        rows.append(measure_bf16(
            "fused_conv3x3_bf16", (bsz, cin, cin, h, w),
            lambda: conv_ops.fused_conv3x3(x, w1, b1, slope, True, eps, w_packed=w1t, out_dtype=bf),
            lambda: conv_ops.conv3x3_plain(x, w1, b1, slope, True, eps),
            lambda: F.conv2d(x, w1b, b1b, padding=1),
            2.0 * px * cin * 9 * cin, 2.0 * (2 * px * cin + 9 * cin * cin) + 4.0 * cin,
            plan=bf16_plan("conv3x3", bsz, cin, cin, h, w, dev),
        ))
        rows.append(measure_bf16(
            "fused_upconv3x3_bf16", (bsz, cin, cout, h, w),
            lambda: conv_ops.fused_upconv3x3(x, w2, b2, slope, True, eps, w_packed=w2t, out_dtype=bf),
            lambda: conv_ops.upconv3x3_plain(x, w2, b2, slope, True, eps),
            lambda: F.conv2d(xu, w2b, b2b, padding=1),
            2.0 * 4 * px * cout * 4 * cin, 2.0 * (px * cin + 4 * px * cout + 16 * cin * cout) + 4.0 * cout,
            plan=bf16_plan("upconv3x3", bsz, cin, cout, h, w, dev),
        ))
        # K4 bf16 at every block, the blocks its size rule leaves to the pair
        # alike: its plan, its bits against the pair's (bf16 up to 128
        # channels sums in the pair's order), its time beside the pair's.
        takes = conv_ops.fused_block_fits(cin, cin, cout, size=(bsz, h, w), device=dev, dtype=bf)
        kplan = k4_bf16_plan(bsz, cin, cin, cout, h, w, dev)

        def kernel():
            return conv_ops.fused_block(x, w1, b1, w2, b2, slope, eps, w1_packed=w1t, w2_packed=w2t, out_dtype=bf)

        def pair():
            mid = conv_ops.fused_conv3x3(x, w1, b1, slope, True, eps, w_packed=w1t, out_dtype=bf)
            return conv_ops.fused_upconv3x3(mid, w2, b2, slope, True, eps, w_packed=w2t, out_dtype=bf)

        mid_up = upsample_nearest_2x(conv_ops.conv3x3_plain(x, w1, b1, slope, True, eps))

        def library():
            F.conv2d(x, w1b, b1b, padding=1)
            return F.conv2d(mid_up, w2b, b2b, padding=1)

        row = measure_bf16(
            "fused_block_bf16", (bsz, cin, cin, cout, h, w), kernel,
            lambda: conv_ops.fused_block_plain(x, w1, b1, w2, b2, slope, eps), library,
            2.0 * px * cin * 9 * cin + 2.0 * 4 * px * cout * 4 * cin,
            2.0 * (px * cin + 4 * px * cout + 9 * cin * cin + 16 * cin * cout) + 4.0 * (cin + cout),
            l2_tol=TOL_K4_BF16_L2,
        )
        if takes != kplan["takes"]:
            raise AssertionError(f"block {i}: fused_block_fits in bf16 {takes}, the plan's takes {kplan['takes']}")
        row.update(taken=takes, block=i, k4_plan=kplan, equal_pair=bool(torch.equal(kernel(), pair())),
                   pair_ms=time_ms(pair))
        if not takes:
            row["role"] = "off_path"  # timed, not on the path: left out of the kernels record's sums
        print(f"[bf16]   fused_block_bf16 block {i}: {'taken' if takes else 'left to K1 bf16 then K3 bf16'} by the "
              f"bf16 rule (modelled cost {kplan['cost']} against the pair's {kplan['pair_cost']}); strip "
              f"{kplan['tc']} columns, runs of {kplan['run_rows']} rows, {kplan['units']} units over "
              f"{kplan['blocks']} blocks x {kplan['nwg']} warpgroups, weights resident {kplan['res1']}/"
              f"{kplan['res2']}, {kplan['stages']} stages, {kplan['smem_bytes']} B shared; against K1 bf16 then "
              f"K3 bf16 bit for bit {row['equal_pair']}; K4 {row['ms']:.4f} ms, pair {row['pair_ms']:.4f} ms "
              f"({row['ms'] / row['pair_ms']:.2f}x)")
        if not row["equal_pair"]:
            raise AssertionError(f"fused_block_bf16 block {i} differs from K1 bf16 then K3 bf16")
        rows.append(row)
        del mid_up
        del xu
    # K4 bf16 past 128 channels (``csrc/block3x3_bf16_wide.cu``: block_bf16.cuh
    # over a cluster split as K1 bf16 and K3 bf16 split), the route its
    # widths alone give (``conv_bf16.block_route``); no block of this
    # generator is that wide: at phase 7's WIDE_BLOCK and at a width of three
    # ranks, against K1 bf16 then K3 bf16 bit for bit in both output dtypes.
    for shape in (WIDE_BLOCK, THREE_RANK_BLOCK, TEMPLATE_BLOCK):
        rows.append(wide_bf16_row(shape, rng, slope, eps, dev))
    rows += gansynth_rows(rng, slope, eps, dev)
    taken = [r for r in rows if r["name"] == "fused_block_bf16" and r.get("taken")]
    if not taken:
        raise AssertionError("the bf16 rule gives K4 bf16 no block of the main path")
    k4 = [r for r in rows if r["name"] == "fused_block_bf16" and r["role"] not in ("wide", "template")]
    print(f"[sums]   fused_block_bf16 at the {len(taken)} blocks the bf16 rule takes ({[r['block'] for r in taken]}): "
          f"K4 {sum(r['ms'] for r in taken):.4f} ms, pair {sum(r['pair_ms'] for r in taken):.4f}; at blocks 4-7: "
          f"K4 {sum(r['ms'] for r in k4[4:]):.4f} ms, pair {sum(r['pair_ms'] for r in k4[4:]):.4f}, bound "
          f"{sum(r['bound_ms'] for r in k4[4:]):.4f}")
    for name in BF16_SOURCES:
        mine = [r for r in rows if r["name"] == name and r["role"] == "synthesis"]
        print(f"[sums]   {name:20s} {len(mine)} shapes: kernel {sum(r['ms'] for r in mine):.4f} ms, plain "
              f"{sum(r['plain_ms'] for r in mine):.4f}, library {sum(r['library_ms'] for r in mine):.4f}, "
              f"bound {sum(r['bound_ms'] for r in mine):.4f}")
    return rows


# GANSynth's call (port_bench/configs/gansynth-ifmel-h.json: 122 notes, 2
# instruments x 61 pitches): every K1 bf16 and K3 bf16 of its generator
# (at 256 channels PixelNorm splits over a cluster of two; the last K1 is
# the tail), its head at 32 channels and K5 at n_fft 2048, hop 512.
GANSYNTH_NOTES = 122
GANSYNTH_K1 = [(GANSYNTH_NOTES, 256, 256, 2 * 2**i, 16 * 2**i) for i in range(4)] + [
    (GANSYNTH_NOTES, 128, 128, 32, 256), (GANSYNTH_NOTES, 64, 64, 64, 512), (GANSYNTH_NOTES, 32, 32, 128, 1024)]
GANSYNTH_K3 = [(GANSYNTH_NOTES, 256, 256, 2 * 2**i, 16 * 2**i) for i in range(3)] + [
    (GANSYNTH_NOTES, 256, 128, 16, 128), (GANSYNTH_NOTES, 128, 64, 32, 256), (GANSYNTH_NOTES, 64, 32, 64, 512)]
GANSYNTH_HEAD = (GANSYNTH_NOTES, 32, 128, 1024)


def gansynth_rows(rng, slope: float, eps: float, dev) -> list[dict]:
    """Phase 9 (d): GANSynth's bf16 convs at every shape of its call (random
    weights at the He scale) against their plain versions within one bf16
    ulp, with their plans (held to the mirror: a cluster of two past 128
    channels, else none) and times; its head at 32 channels (random weights
    at ``to_rgb``'s scale) at ``TOL_HEAD``; K5 at GANSynth's spectra, not
    normalized, against its plain version.  Role "gansynth": kept out of
    the path's sums."""
    bf, rows = torch.bfloat16, []
    for kind, shapes in (("conv3x3", GANSYNTH_K1), ("upconv3x3", GANSYNTH_K3)):
        up = kind == "upconv3x3"
        for bsz, cin, cout, h, w in shapes:
            x = torch.randn(bsz, cin, h, w, generator=rng, device=dev).to(bf)
            wt = torch.randn(cout, cin, 3, 3, generator=rng, device=dev) * (2.0 / (9 * cin)) ** 0.5
            b = torch.randn(cout, generator=rng, device=dev) * 0.1
            wp, wb = conv_ops.kernel_weights_tc(wt, up), wt.to(bf)
            xin = upsample_nearest_2x(x) if up else x
            fn, plain = (conv_ops.fused_upconv3x3, conv_ops.upconv3x3_plain) if up else \
                (conv_ops.fused_conv3x3, conv_ops.conv3x3_plain)
            px, taps = bsz * h * w, 4 * 4 if up else 9
            out_px = 4 * px if up else px
            row = measure_bf16(
                f"fused_{kind}_bf16", (bsz, cin, cout, h, w),
                lambda x=x, wt=wt, b=b, wp=wp, fn=fn: fn(x, wt, b, slope, True, eps, w_packed=wp, out_dtype=bf),
                lambda x=x, wt=wt, b=b, plain=plain: plain(x, wt, b, slope, True, eps),
                lambda xin=xin, wb=wb, b=b: F.conv2d(xin, wb, b.to(bf), padding=1),
                2.0 * out_px * cout * (4 if up else 9) * cin, 2.0 * (px * cin + out_px * cout + taps * cin * cout)
                + 4.0 * cout, plan=bf16_plan(kind, bsz, cin, cout, h, w, dev),
            )
            if row["plan"]["cluster"] != (2 if cout > 128 else 1):
                raise AssertionError(f"{kind} bf16 {(bsz, cin, cout, h, w)}: cluster {row['plan']['cluster']}")
            row["role"] = "gansynth"
            rows.append(row)
            del x, xin
    cin = GANSYNTH_HEAD[1]
    w = torch.randn(2, cin, generator=rng, device=dev) * (1.0 / cin) ** 0.5
    rows.append(head_row(GANSYNTH_HEAD, w, torch.randn(2, generator=rng, device=dev) * 0.1, dev, "gansynth",
                         SEED + 22))
    n_fft, hop, t = 2048, 512, 128
    re = torch.randn(GANSYNTH_NOTES, n_fft // 2 + 1, t, generator=rng, device=dev)
    im = torch.randn(GANSYNTH_NOTES, n_fft // 2 + 1, t, generator=rng, device=dev)
    spec, window = torch.complex(re, im), torch.from_numpy(hann_window(n_fft)).to(dev)
    m = n_fft // 2
    rows.append(measure(
        "istft_fused", (GANSYNTH_NOTES, n_fft // 2 + 1, t, n_fft, hop),
        lambda: istft_ops.istft_fused(re, im, n_fft, hop, normalized=False),
        lambda: istft_real_imag(re, im, n_fft, hop, normalized=False),
        lambda: torch.istft(spec, n_fft, hop, window=window, center=True, normalized=False),
        GANSYNTH_NOTES * t * (5.0 * m * math.log2(m) + 10.0 * m),
        4.0 * (2 * GANSYNTH_NOTES * (n_fft // 2 + 1) * t + GANSYNTH_NOTES * (t - 1) * hop
               + 3 * n_fft + (n_fft // hop) ** 2 * hop),
        role="gansynth", graph_plain=False,
    ))
    for name in ("fused_conv3x3_bf16", "fused_upconv3x3_bf16", "head1x1", "istft_fused"):
        mine = [r for r in rows if r["name"] == name]
        print(f"[sums]   gansynth {name:20s} {len(mine)} shapes: kernel {sum(r['ms'] for r in mine):.4f} ms, "
              f"library {sum(r['library_ms'] for r in mine):.4f}, bound {sum(r['bound_ms'] for r in mine):.4f}")
    return rows


def gansynth_synthesis(dev) -> dict:
    """Phase 9 (e): one published-width GANSynth call of the cell's size
    (``port_bench/configs/gansynth-ifmel-h.json``, 122 notes, seeded
    weights) through ``synthesize_fn`` under ``pallas_up_bf16``, after a
    warm call, with the counters zeroed just before it: K1 bf16 seven times
    (four over a cluster: the 256-channel blocks), K3 bf16 six (three), the
    head and K5 once, two mel products; 122 finite notes of 64,000 samples."""
    from port_bench.drivers.gansynth_bank import model_config

    gcfg = dataclasses.replace(model_config(json.loads((ROOT / "port_bench/configs/gansynth-ifmel-h.json")
                                                       .read_text())), conv_impl="pallas_up_bf16")
    gen = Generator(gcfg, device=dev, seed=SEED)
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    z = torch.randn(2, 1, 1, gcfg.rand_channels, generator=g, device=dev).repeat_interleave(61, dim=0)
    labels = torch.arange(61, device=dev).repeat(2)
    synth = generate_mod.synthesize_fn(gcfg, gcfg.n_stages - 1)
    fns = (conv_ops.fused_conv3x3, conv_ops.fused_upconv3x3)
    kept = [(f.launches, f.bf16_launches, f.cluster_launches) for f in fns]
    others = (head_ops.head1x1.launches, istft_ops.istft_fused.launches, audio_functions.mel_to_linear.launches)
    with torch.no_grad():
        synth(gen, z, labels)
        torch.cuda.synchronize()
        for f in fns:
            f.launches = f.bf16_launches = f.cluster_launches = 0
        head_ops.head1x1.launches = istft_ops.istft_fused.launches = audio_functions.mel_to_linear.launches = 0
        t0 = time.perf_counter()
        waves = synth(gen, z, labels)
        torch.cuda.synchronize()
        call_ms = 1e3 * (time.perf_counter() - t0)
    got = {"fused_conv3x3": (fns[0].bf16_launches, fns[0].cluster_launches),
           "fused_upconv3x3": (fns[1].bf16_launches, fns[1].cluster_launches),
           "head1x1": head_ops.head1x1.launches, "istft_fused": istft_ops.istft_fused.launches,
           "mel_to_linear": audio_functions.mel_to_linear.launches}
    all_bf16 = all(f.launches == f.bf16_launches for f in fns)
    for f, (a, b, c) in zip(fns, kept):  # no path's: the counters as they were
        f.launches, f.bf16_launches, f.cluster_launches = a, b, c
    head_ops.head1x1.launches, istft_ops.istft_fused.launches, audio_functions.mel_to_linear.launches = others
    rec = {"shape": tuple(waves.shape), "finite": bool(torch.isfinite(waves).all()), "launches": got,
           "all_bf16": all_bf16, "call_ms": call_ms}
    print(f"[bf16]   GANSynth's published call, 122 notes under pallas_up_bf16: waves {rec['shape']}, finite "
          f"{rec['finite']}; launches (bf16, cluster) {got}; {call_ms:.2f} ms on the host's clock")
    want = {"fused_conv3x3": (7, 4), "fused_upconv3x3": (6, 3), "head1x1": 1, "istft_fused": 1, "mel_to_linear": 2}
    if got != want or not all_bf16 or not rec["finite"] or rec["shape"] != (122, 64000):
        raise AssertionError(f"GANSynth's call: {rec}; launches wanted {want}, all bf16")
    del gen, waves
    return rec


def wide_generator_synthesis(cfg: ModelConfig, dev) -> dict:
    """Phase 9 (c): a generator past 128 channels (``WIDE_GEN_CHANNELS``,
    random weights from ``SEED``) synthesizing phase 9's latents at stage 7
    under ``pallas_block_bf16`` and under ``pallas_up_bf16``.  Under the
    bf16 rule: K4 bf16 at the blocks it gives it (launches counted; none
    past 128 channels, where the cluster route is no faster than the pair),
    the pair elsewhere, the two images bit for bit.  Then with the rule
    made to take every block of the cluster route, as a check of that
    route inside a synthesis: K4 bf16 launched at each of those blocks and
    the image still the pair's bit for bit; each of those blocks timed
    beside the pair in rounds."""
    wcfg = dataclasses.replace(cfg, gen_channels=WIDE_GEN_CHANNELS)
    gen = Generator(wcfg, device=dev, seed=SEED)
    z = main_path_latent(wcfg, dev).permute(0, 3, 1, 2)
    stage, bf = wcfg.n_stages - 1, torch.bfloat16
    n = len(wcfg.gen_channels)
    side = 2 ** (stage + 1)
    blocks, cluster_blocks = [], []
    for i, (cin, cout) in enumerate(wcfg.gen_channels):
        bsz, h, w = block_sizes(wcfg, i)
        if conv_ops.fused_block_fits(cin, cin, cout, size=(bsz, h, w), device=dev, dtype=bf):
            blocks.append((i, conv_bf16.block_route(cin, cout, cin)))
        if conv_bf16.block_route(cin, cout, cin) == "bf16_cluster":
            cluster_blocks.append(i)
    real_fits = conv_ops.fused_block_fits

    def cluster_fits(cin, cmid, cout, size=None, device=None, dtype=torch.float32):
        return (dtype == bf and conv_bf16.block_route(cmid, cout, cin) == "bf16_cluster"
                or real_fits(cin, cmid, cout, size=size, device=device, dtype=dtype))

    with torch.no_grad():
        reset_launches()
        k4_image = gen.forward_nchw(z, stage, 1.0, "pallas_block_bf16")
        got = read_launches()
        pair_image = gen.forward_nchw(z, stage, 1.0, "pallas_up_bf16")
        launched = read_bf16_launches()
        counts = {fn: (fn.launches, getattr(fn, "bf16_launches", 0)) for fn in WRAPPERS.values()}
        with mock.patch.object(conv_ops, "fused_block_fits", cluster_fits):
            reset_launches()
            forced_image = gen.forward_nchw(z, stage, 1.0, "pallas_block_bf16")
            forced = read_launches()
            forced_ms = warm_ms(lambda: gen.forward_nchw(z, stage, 1.0, "pallas_block_bf16"), 5)
        for fn, (a, b) in counts.items():  # the forced run is no path's
            fn.launches = a
            if hasattr(fn, "bf16_launches"):
                fn.bf16_launches = b
        rec = {"gen_channels": WIDE_GEN_CHANNELS, "k4_blocks": blocks, "launches": got, "bf16_launches": launched,
               "equal": bool(torch.equal(k4_image, pair_image)), "finite": bool(torch.isfinite(k4_image).all()),
               "cluster_blocks": cluster_blocks, "forced_launches": forced,
               "forced_equal": bool(torch.equal(forced_image, pair_image)),
               "forced_finite": bool(torch.isfinite(forced_image).all()), "forced_ms": forced_ms,
               "k4_ms": warm_ms(lambda: gen.forward_nchw(z, stage, 1.0, "pallas_block_bf16"), 5),
               "pair_ms": warm_ms(lambda: gen.forward_nchw(z, stage, 1.0, "pallas_up_bf16"), 5)}
    rec["block_times"] = [wide_block_times(gen, wcfg, i, dev) for i in cluster_blocks]
    print(f"[bf16]   a generator past 128 channels {WIDE_GEN_CHANNELS} at stage 7, {tuple(z.shape)} latents: "
          f"the bf16 rule gives K4 bf16 blocks {blocks}; pallas_block_bf16 launched {got['fused_block']} K4, "
          f"{got['fused_conv3x3']} K1, {got['fused_upconv3x3']} K3; its image against pallas_up_bf16's bit for bit "
          f"{rec['equal']}; warm {rec['k4_ms']:.3f} ms against {rec['pair_ms']:.3f} ms.  With K4 bf16 made to take "
          f"the cluster route's blocks {cluster_blocks}: {forced['fused_block']} K4, {forced['fused_conv3x3']} K1, "
          f"{forced['fused_upconv3x3']} K3; the image against pallas_up_bf16's bit for bit {rec['forced_equal']}; "
          f"warm {forced_ms:.3f} ms")
    if got["fused_block"] != len(blocks) or got["fused_conv3x3"] != n - len(blocks):
        raise AssertionError(f"the wide generator launched {got}; the rule gives K4 bf16 {blocks}")
    nk = len(set(cluster_blocks) | {i for i, _ in blocks})
    if not cluster_blocks or forced["fused_block"] != nk or forced["fused_conv3x3"] != n - nk:
        raise AssertionError(f"the wide generator with the cluster route taken launched {forced}; its blocks "
                             f"{cluster_blocks}")
    for name, image, finite, equal in (("under the rule", k4_image, rec["finite"], rec["equal"]),
                                       ("with the cluster route taken", forced_image, rec["forced_finite"],
                                        rec["forced_equal"])):
        if not (equal and finite and image.shape == (z.shape[0], 2, z.shape[2] * side, z.shape[3] * side)):
            raise AssertionError(f"the wide generator's image {name} is not the pair's: {rec}")
    del gen, k4_image, pair_image, forced_image
    return rec


# Rounds of K4 bf16 and the pair timed in turn at each block of the cluster
# route in the generator past 128 channels.
WIDE_BLOCK_ROUNDS = 5


def wide_block_times(gen, cfg: ModelConfig, i: int, dev) -> dict:
    """Block ``i`` of the generator past 128 channels at its synthesis
    sizes (its weights, a seeded bf16 input): K4 bf16 and K1 bf16 then K3
    bf16 timed in turn ``WIDE_BLOCK_ROUNDS`` times, the medians and the
    rounds in which K4 was the faster."""
    (cin, cout), (bsz, h, w) = cfg.gen_channels[i], block_sizes(cfg, i)
    slope, eps, bf = cfg.leaky_slope, cfg.pixel_norm_eps, torch.bfloat16
    blk = gen.blocks[i]
    w1, b1 = blk.conv1.weight.detach(), blk.conv1.bias.detach()
    w2, b2 = blk.conv2.weight.detach(), blk.conv2.bias.detach()
    w1t, w2t = conv_ops.kernel_weights_tc(w1), conv_ops.kernel_weights_tc(w2, True)
    x = torch.randn(bsz, cin, h, w, generator=torch.Generator(device=dev).manual_seed(SEED + i), device=dev).to(bf)

    def kernel():
        return conv_ops.fused_block(x, w1, b1, w2, b2, slope, eps, w1_packed=w1t, w2_packed=w2t, out_dtype=bf)

    def pair():
        mid = conv_ops.fused_conv3x3(x, w1, b1, slope, True, eps, w_packed=w1t, out_dtype=bf)
        return conv_ops.fused_upconv3x3(mid, w2, b2, slope, True, eps, w_packed=w2t, out_dtype=bf)

    counts = {fn: (fn.launches, fn.bf16_launches)
              for fn in (conv_ops.fused_block, conv_ops.fused_conv3x3, conv_ops.fused_upconv3x3)}
    k4, two = [], []
    for _ in range(WIDE_BLOCK_ROUNDS):
        k4.append(time_ms(kernel))
        two.append(time_ms(pair))
    for fn, (n, nb) in counts.items():  # timing launches are no path's
        fn.launches, fn.bf16_launches = n, nb
    plan = conv_bf16.block_plan(bsz, cin, cin, cout, h, w, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = {"block": i, "shape": (bsz, cin, cin, cout, h, w), "k4_ms": float(np.median(k4)),
           "pair_ms": float(np.median(two)), "k4_rounds": k4, "pair_rounds": two,
           "k4_faster_rounds": sum(a < b for a, b in zip(k4, two)), "modelled_ratio": plan["cost"] / plan["pair_cost"]}
    print(f"[bf16]   the generator past 128 channels, block {i} {out['shape']}: K4 bf16 {out['k4_ms']:.4f} ms, "
          f"K1 bf16 then K3 bf16 {out['pair_ms']:.4f} ms (medians of {WIDE_BLOCK_ROUNDS} rounds; measured "
          f"{out['k4_ms'] / out['pair_ms']:.3f}x, modelled {out['modelled_ratio']:.3f}x; K4 the faster in "
          f"{out['k4_faster_rounds']} of {WIDE_BLOCK_ROUNDS} rounds)")
    del x
    return out


def plain_on_card_all():
    """``plain_on_card``'s patches and K4's: the synthesis path through its
    plain versions in any impl and dtype."""
    return plain_on_card() + [mock.patch.object(
        conv_ops, "fused_block",
        lambda *a, w1_packed=None, w2_packed=None, out_dtype=None: conv_ops.fused_block_plain(
            *a, out_dtype=out_dtype))]


def end_to_end_new_impls(cfg: ModelConfig, dev) -> dict:
    """Phase 9, end to end: ``generate`` once under each new impl, the
    launch counters set to 0 before and read after; each image and waveform
    against the bf16 plain path on the card (bf16 impls), the float32
    default path and the plain path in float64; warm synthesis under
    ``pallas_up``, ``pallas_up_bf16``, ``pallas_block`` and
    ``pallas_block_bf16`` in turns."""
    acfg = AudioConfig()
    stage = cfg.n_stages - 1
    z = main_path_latent(cfg, dev)
    zc = z.permute(0, 3, 1, 2)
    synth = generate_mod.synthesize_fn(cfg, stage)
    n_samples = (cfg.latent_width * NB_VEC * 2 ** cfg.n_stages - 1) * acfg.stft_stride
    gen_default = load_reference_generator(str(CKPT), cfg, device=dev)
    with torch.no_grad():
        img_default = gen_default.forward_nchw(zc, stage)
    waves_default = synth(gen_default, z)

    gen64 = load_reference_generator(str(CKPT), cfg, device=dev).double()
    patches = plain_on_card()[:2] + [mock.patch.object(generate_mod, "istft_fused", istft_float64)]
    for p in patches:
        p.start()
    try:
        with torch.no_grad():
            img64 = gen64.forward_nchw(zc.double(), stage)
            waves64 = generate_mod._synthesize(gen64, z.double(), stage, cfg, "pallas")
    finally:
        for p in patches:
            p.stop()
    del gen64

    n_fit = blocks_taking_k4(cfg, dev, NB_VEC, NB_MUSIC, torch.bfloat16)
    n = cfg.n_stages
    expect = {
        "pallas": ({"fused_conv3x3": 2 * n}, {}),
        "pallas_bf16": ({"fused_conv3x3": 2 * n, "head1x1": 1}, {"fused_conv3x3_bf16": 2 * n}),
        "pallas_up_bf16": ({"fused_conv3x3": n, "fused_upconv3x3": n, "head1x1": 1},
                           {"fused_conv3x3_bf16": n, "fused_upconv3x3_bf16": n}),
        "pallas_block_bf16": ({"fused_conv3x3": n - n_fit, "fused_upconv3x3": n - n_fit, "fused_block": n_fit,
                               "head1x1": 1},
                              {"fused_conv3x3_bf16": n - n_fit, "fused_upconv3x3_bf16": n - n_fit,
                               "fused_block_bf16": n_fit}),
    }
    rec = {"fitting_blocks": n_fit, "impls": {}}
    for impl in NEW_IMPLS:
        cfg_i = dataclasses.replace(cfg, conv_impl=impl)
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{impl}_")
        reset_launches()
        paths = generate_mod.generate(
            out_dir, cfg.rand_channels, str(CKPT), nb_vec=NB_VEC, nb_music=NB_MUSIC,
            seed=SEED, model_cfg=cfg_i, device="cuda",
        )
        torch.cuda.synchronize()
        launches, bf16_launches = read_launches(), read_bf16_launches()
        want = {**{k: 0 for k in launches}, **expect[impl][0], "istft_fused": 1}
        want_bf16 = {**{k: 0 for k in bf16_launches}, **expect[impl][1]}
        print(f"[e2e-new] generate with conv_impl={impl!r}: launches {launches}, of them in bf16 {bf16_launches}")
        if launches != want or bf16_launches != want_bf16:
            raise AssertionError(f"{impl}: launch counts {launches}, {bf16_launches} != {want}, {want_bf16}")
        waves = []
        for p in paths:
            wave, sr = load_wav(p)
            if sr != acfg.sample_rate or wave.shape != (n_samples,):
                raise AssertionError(f"{p}: {sr} Hz, {wave.shape} samples")
            if not np.isfinite(wave).all() or np.abs(wave).max() < 1e-3:
                raise AssertionError(f"{p}: non-finite or silent waveform")
            waves.append(wave)
        if len(waves) != NB_MUSIC:
            raise AssertionError(f"{impl}: {len(waves)} WAVs")
        waves = torch.from_numpy(np.stack(waves)).to(dev)

        gen = load_reference_generator(str(CKPT), cfg_i, device=dev)
        with torch.no_grad():
            img = gen.forward_nchw(zc, stage)
        if img.dtype != torch.float32 or not torch.isfinite(img).all():
            raise AssertionError(f"{impl}: image {img.dtype}, finite {bool(torch.isfinite(img).all())}")
        errs = {
            "image_vs_default": (img - img_default).abs().max().item(),
            "image_vs_float64": (img.double() - img64).abs().max().item(),
            "image_l2_vs_default": rel_l2(img, img_default),
            "image_share_past_0.08_vs_default": ((img - img_default).abs() > 0.08).float().mean().item(),
            "wave_vs_default": (waves - waves_default).abs().max().item(),
            "wave_vs_float64": (waves.double() - waves64).abs().max().item(),
        }
        if impl.endswith("_bf16"):
            patches = plain_on_card_all()
            for p in patches:
                p.start()
            reset_launches()
            try:
                with torch.no_grad():
                    img_plain = gen.forward_nchw(zc, stage)
                waves_plain = synth(gen, z)
            finally:
                for p in patches:
                    p.stop()
            if any(read_launches().values()):
                raise AssertionError(f"the plain bf16 pass launched kernels: {read_launches()}")
            errs["image_vs_bf16_plain"] = (img - img_plain).abs().max().item()
            errs["image_l2_vs_bf16_plain"] = rel_l2(img, img_plain)
            errs["image_l2_bf16_plain_vs_default"] = rel_l2(img_plain, img_default)
            errs["wave_vs_bf16_plain"] = (waves - waves_plain).abs().max().item()
            del img_plain, waves_plain
        print(f"[e2e-new] {impl}: image against " + ", ".join(
            f"{k[6:]} {v:.3e}" for k, v in errs.items() if k.startswith("image")) + "; waveform against " +
            ", ".join(f"{k[5:]} {v:.3e}" for k, v in errs.items() if k.startswith("wave")))
        if impl.endswith("_bf16"):
            if not (errs["image_l2_vs_default"] <= TOL_IMAGE_BF16_L2
                    and errs["image_l2_vs_bf16_plain"] <= TOL_IMAGE_BF16_L2):
                raise AssertionError(f"{impl}: image {errs['image_l2_vs_default']:.3e} (2-norm, relative) from "
                                     f"the float32 path, {errs['image_l2_vs_bf16_plain']:.3e} from the bf16 plain "
                                     f"path (tol {TOL_IMAGE_BF16_L2})")
        elif not errs["image_vs_default"] <= TOL_IMAGE:
            raise AssertionError(f"{impl}: image {errs['image_vs_default']:.3e} from the float32 default path")
        rec["impls"][impl] = {"launches": launches, "bf16_launches": bf16_launches, **errs}
        del gen, img

    # Warm synthesis in turns within this one process: each impl's half of
    # WARM_REPS forwards, then backwards.
    order = ("pallas_up", "pallas_up_bf16", "pallas_block", "pallas_block_bf16")
    gens = {k: load_reference_generator(str(CKPT), dataclasses.replace(cfg, conv_impl=k), device=dev) for k in order}
    # synthesize_fn's model config, not the generator's, picks the impl.
    synths = {k: generate_mod.synthesize_fn(dataclasses.replace(cfg, conv_impl=k), stage) for k in order}
    times = {k: [] for k in order}
    for k in order:
        warm_synthesis_s(synths[k], gens[k], z, 2)
    for k in order + order[::-1]:
        times[k] += warm_synthesis_s(synths[k], gens[k], z, WARM_REPS // 2)
    med = {k: float(np.median(v)) for k, v in times.items()}
    audio_s = NB_MUSIC * n_samples / acfg.sample_rate
    print("[e2e-new] warm synthesis, median of " + str(WARM_REPS) + " each: " + ", ".join(
        f"{k} {med[k] * 1e3:.3f} ms (min {min(times[k]) * 1e3:.3f}; {audio_s / med[k]:.0f} audio-s/s)" for k in order))
    rec.update({"warm_synthesis_s": times, "warm_synthesis_median_s": med})
    rec["launches"] = {k: sum(r["launches"][k] for r in rec["impls"].values()) for k in (*WRAPPERS, IDFT)}
    rec["bf16_launches"] = {k: sum(r["bf16_launches"][k] for r in rec["impls"].values()) for k in BF16_WRAPPERS}
    return rec


# ---------------------------------------------------------------------------
# Phase 10: serving and evaluation: the forward STFT half (view_audio's),
# the micro-batching service, its HTTP front end and CLI, compare and eval.

# The forward pipeline's images, float32 on the card against float64 on the
# card: the repo's bar for this pipeline (tests/test_ingest.py), on
# broadband noise (for near-silent bins the phase is rounding noise).
TOL_VIEW = 2e-3
VIEW_SECONDS = 3.5
SERVE_NB_VEC = 10
SERVE_TIMED = 10       # solo requests timed one by one; the median is quoted
SERVE_CONCURRENT = 8   # requests sent at once for the throughput, 3 rounds


def expected_serve_launches(cfg: ModelConfig, dispatches: int, k4_blocks: int = 0, bf16: bool = False) -> dict:
    """A synthesis dispatch's launches: K1 and K3 at each block the
    whole-block kernel does not take, K4 at those it does, K5 once; under
    a bf16 impl the head kernel once (synthesis runs at alpha 1: no fade
    head)."""
    pair = (cfg.n_stages - k4_blocks) * dispatches
    return {"fused_conv3x3": pair, "fused_conv3x3_msq": 0, "fused_upconv3x3": pair,
            "istft_fused": dispatches, "fused_block": k4_blocks * dispatches, IDFT: 0,
            "weight_grad3x3": 0, "head1x1": dispatches if bf16 else 0}


def counted(total: dict, want: dict, what: str) -> dict:
    """Read the counters against ``want``, add them to ``total``."""
    got = read_launches()
    if got != want:
        raise AssertionError(f"{what} launched {got}, not {want}")
    for k in total:
        total[k] += got[k]
    return got


def http_post(port: int, query: str) -> tuple[bytes, dict]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize?{query}", method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read(), dict(r.headers)


def wav_of(body: bytes) -> tuple[int, np.ndarray]:
    return wavfile.read(io.BytesIO(body))


def serving_and_evaluation(cfg: ModelConfig, dev, run_dir: str, card: str) -> dict:
    """Phase 10: ``wav_to_stft`` / ``stft_to_phase_magn`` on the card against
    float64; the ``SynthesisService`` (solo, concurrent, two signatures,
    ``pallas_block``), its HTTP handler in the process, the ``serve`` CLI as
    a subprocess, ``compare_artifacts`` and ``audition_run``; timings."""
    def say(line: str) -> None:  # every number of the phase beside the card
        print(f"{line} ({card})")

    acfg = AudioConfig()
    stage = cfg.n_stages - 1
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    total = {k: 0 for k in (*WRAPPERS, IDFT)}
    rec = {}

    # (a) The forward STFT half on the card, against float64 on the card.
    wav_path = os.path.join(work, "noise.wav")
    sig = (np.random.default_rng(SEED).standard_normal(int(acfg.sample_rate * VIEW_SECONDS)) * 0.3)
    save_wav(wav_path, sig.astype(np.float32), acfg.sample_rate)
    magn, phase = stft_to_phase_magn(wav_to_stft(wav_path, device="cuda"))
    sig32 = load_wav(wav_path)[0]
    m64, p64 = stft_to_phase_magn(signal_to_stft(torch.from_numpy(sig32).to(dev, torch.float64)))
    if magn.shape != (1, 512, 512) or magn.device.type != "cuda" or magn.dtype != torch.float32:
        raise AssertionError(f"view: {tuple(magn.shape)} on {magn.device}, {magn.dtype}")
    err_m = (magn.double() - m64).abs().max().item()
    err_p = (phase.double() - p64).abs().max().item()
    view_s = []
    for _ in range(10):
        t0 = time.perf_counter()
        stft_to_phase_magn(wav_to_stft(wav_path, device="cuda"))
        torch.cuda.synchronize()
        view_s.append(time.perf_counter() - t0)
    rec["view"] = {"err_magn": err_m, "err_phase": err_p, "median_s": float(np.median(view_s))}
    say(f"[serve] view: wav_to_stft + stft_to_phase_magn of {VIEW_SECONDS} s of noise on the card, "
        f"against float64 on the card: magnitude {err_m:.2e}, phase {err_p:.2e} (tol {TOL_VIEW:.0e}); "
        f"{rec['view']['median_s'] * 1e3:.2f} ms (median of 10, WAV read included)")
    if not (err_m <= TOL_VIEW and err_p <= TOL_VIEW):
        raise AssertionError("the forward STFT half disagrees with float64")

    # (b) The service: the generator resident on the card, default impl.
    gen = generate_mod.load_generator_params(str(CKPT), cfg, dev)
    svc = SynthesisService(gen, max_batch=8, default_stage=stage, device=dev)  # window 10 ms
    svc_b = svc_h = None
    try:
        t0 = time.perf_counter()
        reset_launches()
        svc.warmup(SERVE_NB_VEC)
        torch.cuda.synchronize()
        rec["warmup_s"] = time.perf_counter() - t0
        counted(total, expected_serve_launches(cfg, 1), "warmup")

        n_samples = (cfg.latent_width * SERVE_NB_VEC * 2 ** cfg.n_stages - 1) * acfg.stft_stride
        reset_launches()
        solo = svc.submit(seed=101, nb_vec=SERVE_NB_VEC).result(timeout=600)
        torch.cuda.synchronize()
        counted(total, expected_serve_launches(cfg, 1), "a solo request")
        if solo.shape != (n_samples,) or solo.device.type != "cuda" or not torch.isfinite(solo).all():
            raise AssertionError(f"solo request: {tuple(solo.shape)} on {solo.device}")
        synth = generate_mod.synthesize_fn(cfg, stage)
        z = generate_mod.latents(cfg, SERVE_NB_VEC, 1, 101, dev)
        ref = synth(svc.gen, z)[0]
        patches = plain_on_card()
        for p in patches:
            p.start()
        reset_launches()
        try:
            plain = synth(svc.gen, z)[0]
        finally:
            for p in patches:
                p.stop()
        if any(read_launches().values()):
            raise AssertionError(f"the plain pass launched kernels: {read_launches()}")
        err_plain = (solo - plain).abs().max().item()
        say(f"[serve] solo request, nb_vec {SERVE_NB_VEC}: equal to synthesize_fn on its latent bit "
            f"for bit: {torch.equal(solo, ref)}; against the plain versions on the card {err_plain:.2e} "
            f"(tol {TOL_WAVE:.0e}); warmup {rec['warmup_s']:.2f} s")
        if not torch.equal(solo, ref):
            raise AssertionError("the service's solo request differs from synthesize_fn")
        if not err_plain <= TOL_WAVE:
            raise AssertionError("the service's waveform disagrees with the plain versions")
        rec["err_solo_vs_plain"] = err_plain

        # Concurrent requests of one signature coalesce.
        seeds = [201, 202, 203, 204]
        before = svc.stats_snapshot()["batches"]
        reset_launches()
        futs = [svc.submit(seed=s, nb_vec=SERVE_NB_VEC) for s in seeds]
        waves = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        n_disp = svc.stats_snapshot()["batches"] - before
        counted(total, expected_serve_launches(cfg, n_disp), f"{len(seeds)} concurrent requests")
        if not n_disp < len(seeds):
            raise AssertionError(f"{len(seeds)} concurrent requests took {n_disp} dispatches")
        reset_launches()
        solos = [svc.submit(seed=s, nb_vec=SERVE_NB_VEC).result(timeout=600) for s in seeds]
        torch.cuda.synchronize()
        counted(total, expected_serve_launches(cfg, len(seeds)), "the solo passes")
        errs = [(w - s).abs().max().item() for w, s in zip(waves, solos)]
        same = [torch.equal(w, s) for w, s in zip(waves, solos)]
        say(f"[serve] {len(seeds)} concurrent requests in {n_disp} dispatch(es) "
            f"({svc.stats_snapshot()['signatures']}); each against its solo pass: "
            f"{', '.join(f'{e:.2e}' for e in errs)} (tol {TOL_WAVE:.0e}; bit for bit {same})")
        if not max(errs) <= TOL_WAVE:
            raise AssertionError("a micro-batched request disagrees with its solo pass")
        rec.update(concurrent_dispatches=n_disp, err_batched_vs_solo=max(errs), batched_bitwise=same)

        # Two signatures never share a dispatch.
        stats0 = svc.stats_snapshot()
        reset_launches()
        mixed = [(s, nv, svc.submit(seed=s, nb_vec=nv)) for s, nv in
                 ((301, SERVE_NB_VEC), (302, 2), (303, SERVE_NB_VEC), (304, 2))]
        for s, nv, f in mixed:
            w = f.result(timeout=600)
            if w.shape != ((cfg.latent_width * nv * 2 ** cfg.n_stages - 1) * acfg.stft_stride,):
                raise AssertionError(f"seed {s}, nb_vec {nv}: {tuple(w.shape)}")
        torch.cuda.synchronize()
        stats1 = svc.stats_snapshot()
        n_mixed = stats1["batches"] - stats0["batches"]
        counted(total, expected_serve_launches(cfg, n_mixed), "two signatures")
        if n_mixed < 2:
            raise AssertionError(f"two signatures took {n_mixed} dispatch")
        say(f"[serve] two signatures (nb_vec {SERVE_NB_VEC} and 2), two requests each: {n_mixed} "
            f"dispatches, signatures {stats1['signatures']}")

        # One dispatch under conv_impl="pallas_block": K4 at the blocks its rule gives.
        cfg_b = dataclasses.replace(cfg, conv_impl="pallas_block")
        svc_b = SynthesisService(generate_mod.load_generator_params(str(CKPT), cfg_b, dev),
                                 default_stage=stage, device=dev)
        n_fit = blocks_taking_k4(cfg, dev, SERVE_NB_VEC, 1)
        reset_launches()
        wb = svc_b.submit(seed=101, nb_vec=SERVE_NB_VEC).result(timeout=600)
        torch.cuda.synchronize()
        counted(total, expected_serve_launches(cfg, 1, n_fit), "a pallas_block dispatch")
        err_b = (wb - solo).abs().max().item()
        say(f"[serve] conv_impl='pallas_block', one request: K4 at {n_fit} blocks, K1 and K3 at "
            f"{cfg.n_stages - n_fit}; against the default impl's {err_b:.2e} (tol {TOL_WAVE:.0e})")
        if n_fit < 1 or not err_b <= TOL_WAVE:
            raise AssertionError(f"pallas_block service: {n_fit} K4 blocks, err {err_b:.2e}")
        rec.update(k4_blocks=n_fit, err_block_vs_default=err_b)

        # One dispatch under conv_impl="pallas_up_bf16": K1 bf16 and K3 bf16
        # at every block, then the bf16 head kernel once.
        cfg_h = dataclasses.replace(cfg, conv_impl="pallas_up_bf16")
        svc_h = SynthesisService(generate_mod.load_generator_params(str(CKPT), cfg_h, dev),
                                 default_stage=stage, device=dev)
        reset_launches()
        wh = svc_h.submit(seed=101, nb_vec=SERVE_NB_VEC).result(timeout=600)
        torch.cuda.synchronize()
        counted(total, expected_serve_launches(cfg, 1, bf16=True), "a pallas_up_bf16 dispatch")
        rec["bf16_launches"] = read_bf16_launches()
        if wh.shape != solo.shape or not torch.isfinite(wh).all():
            raise AssertionError(f"pallas_up_bf16 service: {tuple(wh.shape)}, finite {bool(torch.isfinite(wh).all())}")
        say(f"[serve] conv_impl='pallas_up_bf16', one request: K1 bf16 and K3 bf16 at {cfg.n_stages} blocks, "
            f"the head kernel once; waveform {tuple(wh.shape)}, finite")

        # (c) HTTP in the process.
        server = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(svc))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        port = server.server_address[1]
        try:
            reset_launches()
            n0 = svc.stats_snapshot()["requests"]
            body, hdr = http_post(port, "seed=400&nb_vec=2")
            body_s, hdr_s = http_post(port, "seed=400&nb_vec=2&stream=1")
            want = svc.submit(seed=400, nb_vec=2).result(timeout=600).cpu().numpy()
            counted(total, expected_serve_launches(cfg, 3), "three HTTP-side requests")
            (sr, wav), (sr_s, wav_s) = wav_of(body), wav_of(body_s)
            if hdr.get("Content-Type") != "audio/wav" or hdr_s.get("Transfer-Encoding") != "chunked":
                raise AssertionError(f"headers {hdr} / {hdr_s}")
            if sr != sr_s or sr != acfg.sample_rate or not (np.array_equal(wav, want)
                                                             and np.array_equal(wav_s, want)):
                raise AssertionError("the served WAV differs from the service's waveform")
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                health = json.loads(r.read())
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
                stats = json.loads(r.read())
            name = torch.cuda.get_device_name(0)
            if not (health["ok"] and any("cuda" in d and name in d for d in health["devices"])):
                raise AssertionError(f"/healthz {health}")
            if stats["requests"] - n0 != 3:
                raise AssertionError(f"/stats counted {stats['requests'] - n0} of 3 requests")
            say(f"[serve] HTTP: POST /synthesize (whole and stream=1) equal to the service's waveform "
                f"bit for bit ({wav.shape[0]} samples); /healthz {health['devices']}; /stats "
                f"{stats['requests']} requests, {stats['batches']} batches, "
                f"{stats['padded_slots']} padded slots")
        finally:
            server.shutdown()
            server.server_close()

        # (d) The CLI as a subprocess.
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "musicgan_tpu_torch", "serve", str(CKPT), "--port", "0",
             "--no-warmup"],
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        lines = []
        try:
            port_cli = None
            for line in proc.stdout:
                lines.append(line)
                m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
                if m:
                    port_cli = int(m.group(1))
                    break
            if port_cli is None:
                raise AssertionError("the serve CLI printed no listening line:\n" + "".join(lines))
            t0 = time.perf_counter()
            body, _ = http_post(port_cli, "seed=7&nb_vec=2")
            cli_s = time.perf_counter() - t0
            sr, wav = wav_of(body)
            if sr != acfg.sample_rate or wav.shape != ((2 * 2 * 2 ** cfg.n_stages - 1) * 256,) \
                    or not np.isfinite(wav).all() or np.abs(wav).max() < 1e-3:
                raise AssertionError(f"the CLI's WAV: {sr} Hz, {wav.shape}")
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        print("".join(f"    | {line}" for line in lines), end="")
        say(f"[serve] CLI subprocess: a valid WAV ({wav.shape[0]} samples) in {cli_s:.2f} s for its "
            f"first request (kernels loaded, no warmup); SIGTERM -> exit code {proc.returncode}")
        rec["cli_first_request_s"] = cli_s

        # (e) compare and eval.
        corpus = os.path.join(work, "corpus")
        os.makedirs(corpus)
        rng = np.random.default_rng(SEED + 1)
        t = np.arange(3 * acfg.sample_rate) / acfg.sample_rate
        for i in range(3):
            gate = 0.5 + 0.5 * np.sign(np.sin(2 * np.pi * (1.5 + i) * t))
            track = 0.3 * gate * np.sin(2 * np.pi * 220.0 * (i + 1) * t) + 0.05 * rng.standard_normal(t.size)
            save_wav(os.path.join(corpus, f"t{i}.wav"), track.astype(np.float32), acfg.sample_rate)
        reset_launches()
        table = compare_artifacts([str(CKPT), str(CKPT)], corpus, seeds=2, nb_vec=2, verbose=False,
                                  device="cuda")
        counted(total, expected_serve_launches(cfg, 2), "compare")
        if table[0] != table[1] or not math.isfinite(table[0]["nearest_track_dist"]):
            raise AssertionError(f"compare of one artifact twice: {table[0]} vs {table[1]}")
        ck = CheckpointManager(os.path.join(run_dir, "checkpoints"))
        saves = ck.saved_indices()
        stages = []
        for k in saves:
            with open(os.path.join(ck.root, f"save_{k}", "meta.json")) as f:
                stages.append(min(int(json.load(f)["grower"]["curr_grow"]), stage))
        reset_launches()
        aud = audition_run(run_dir, out_dir=os.path.join(work, "audition"), seeds=2, nb_vec=2,
                           verbose=False, device="cuda")
        want = {**expected_serve_launches(cfg, len(saves)),
                "fused_conv3x3": sum(s + 1 for s in stages), "fused_upconv3x3": sum(s + 1 for s in stages)}
        counted(total, want, "audition")
        wavs = sorted(f for f in os.listdir(aud) if f.endswith(".wav"))
        if len(wavs) != 2 * len(saves):
            raise AssertionError(f"audition wrote {len(wavs)} WAVs for {len(saves)} saves")
        for f in wavs:
            w, sr = load_wav(os.path.join(aud, f))
            if sr != acfg.sample_rate or not np.isfinite(w).all():
                raise AssertionError(f"audition {f}: {sr} Hz, finite {np.isfinite(w).all()}")
        say(f"[serve] compare of gen_final.pt twice (seeds 2, nb_vec 2): equal rows, nearest-track "
            f"dist {table[0]['nearest_track_dist']:.4f}; audition of phase 8's run: {len(saves)} saves "
            f"at stages {stages}, {len(wavs)} finite WAVs")
        rec.update(compare_row=table[0], audition_stages=stages)

        # (f) Timings, for the record: a solo request's latency to its samples
        # on the host, and rounds of concurrent requests.
        clip_s = n_samples / acfg.sample_rate
        reset_launches()
        lat = []
        for i in range(SERVE_TIMED):
            t0 = time.perf_counter()
            svc.submit(seed=500 + i, nb_vec=SERVE_NB_VEC).result(timeout=600).cpu()
            lat.append(time.perf_counter() - t0)
        rounds, n_disp = [], 0
        for r in range(3):
            b0 = svc.stats_snapshot()["batches"]
            t0 = time.perf_counter()
            futs = [svc.submit(seed=600 + 10 * r + i, nb_vec=SERVE_NB_VEC) for i in range(SERVE_CONCURRENT)]
            for f in futs:
                f.result(timeout=600).cpu()
            rounds.append(time.perf_counter() - t0)
            n_disp += svc.stats_snapshot()["batches"] - b0
        counted(total, expected_serve_launches(cfg, SERVE_TIMED + n_disp), "the timed requests")
        med = float(np.median(rounds))
        rec.update(solo_latency_s=lat, solo_latency_median_s=float(np.median(lat)),
                   concurrent_wall_s=rounds, concurrent_median_s=med,
                   concurrent_audio_s_per_s=SERVE_CONCURRENT * clip_s / med, concurrent_dispatches_3_rounds=n_disp)
        say(f"[serve] solo request at nb_vec {SERVE_NB_VEC} ({clip_s:.3f} s of audio), submit to samples "
            f"on the host, median of {SERVE_TIMED}: {rec['solo_latency_median_s'] * 1e3:.3f} ms (min "
            f"{min(lat) * 1e3:.3f}, max {max(lat) * 1e3:.3f})")
        say(f"[serve] {SERVE_CONCURRENT} concurrent requests at nb_vec {SERVE_NB_VEC}, 3 rounds: wall "
            f"{', '.join(f'{x * 1e3:.3f}' for x in rounds)} ms ({n_disp} dispatches), median "
            f"{med * 1e3:.3f} ms = {rec['concurrent_audio_s_per_s']:.1f} audio-s/s")
    finally:
        svc.close()
        for extra in (svc_b, svc_h):
            if extra is not None:
                extra.close()
    rec["launches"] = total
    say(f"[serve] launches in phase 10: {total}")
    return rec



# ---------------------------------------------------------------------------
# Phase 11: ingest and run interchange.  WAVs -> ``create_dataset`` ->
# ``train`` (profiled; under --debug-nans on a clean corpus and on one with
# a NaN sample; supervised through a SIGTERM) -> ``export --full`` ->
# ``import`` -> ``generate`` from both -> ``train --resume`` at stage 7.

INGEST_TRACKS, INGEST_SECONDS = 6, (7.0, 9.0)  # 16-bit 44.1 kHz, 2-3 chunks a track
INGEST_WORKERS = 2
# process_signal's three tails against each other: the bar of the JAX
# package's own tests (tests/test_ingest.py:262-275).
TOL_INGEST_BACKENDS = 2e-6
# The profiled run: phase 8's cut schedule (12 samples a stage), 20
# iterations (stage 7 from the 16th), a save every 10: the last save is at
# stage 7.  The resumed run adds 4 iterations at stage 7.
RUN_ITERS, RUN_SAVE_EVERY, RESUME_ITERS = 20, 10, 4
CUT_SCHEDULE_FLAG = "--cli-with-cut-schedule"
# A probe in a process of its own: importing the port's ingest and running
# every backend initialises no CUDA context; per-track times of each tail.
INGEST_PROBE = r"""
import json, sys, time
import numpy as np, torch
from musicgan_tpu_torch import native
from musicgan_tpu_torch.audio import ingest
from musicgan_tpu_torch.audio.io import load_wav
out = {"native": native.is_available(), "lib": native.lib_path(), "ms": {}, "err": {}}
sig = load_wav(sys.argv[1])[0]
res = {}
for backend in ("native", "numpy", "torch"):
    res[backend] = ingest.process_signal(sig, backend=backend)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        ingest.process_signal(sig, backend=backend)
        times.append(time.perf_counter() - t0)
    out["ms"][backend] = 1e3 * float(np.median(times))
for backend in ("numpy", "torch"):
    out["err"][backend] = float(np.abs(res[backend] - res["native"]).max())
out["shape"] = list(res["native"].shape)
out["cuda_initialized"] = torch.cuda.is_initialized()
print(json.dumps(out))
"""


def cli_with_cut_schedule(argv: list[str]) -> None:
    """``python3 chip_smoke.py --cli-with-cut-schedule train ...``: the
    port's CLI with phase 8's cut schedule in the TrainConfig it builds (the
    CLI has no flag for the schedule; depth is what a smoke may cut)."""
    from musicgan_tpu_torch import __main__ as cli
    from musicgan_tpu_torch import config

    real = config.train_config_from_overrides

    def cut(**kw):
        return dataclasses.replace(real(**kw), fadein_lengths=LOOP_CFG["fadein_lengths"],
                                   train_lengths=LOOP_CFG["train_lengths"])

    config.train_config_from_overrides = cut
    cli.main(argv)


def reference_training_objects(cfg: ModelConfig, stage: int, gen_lr: float, disc_lr: float, betas):
    """The reference's training objects at growth ``stage``, built as its
    ``train.py:64-69,262-272`` builds them: modules that register their
    parameters in the reference's order under its ``state_dict`` names
    (``generator.py:54-103``: all blocks, then the head; ``next_layer``
    keeps the previous head behind ``__last_end_block``;
    ``discriminator.py:52-104``: all blocks, the start head 7, the
    classifier; growth walks the head down, the previous one behind an
    AvgPool), and an Adam each over the first module's parameters with one
    group added a growth.  The classes are named ``Generator`` and
    ``Discriminator`` so that Python mangles their attributes as the
    reference's.  Returns ``(gen, disc, optim_gen, optim_disc)``."""
    nn = torch.nn

    class Generator(nn.Module):
        def __init__(self):
            super().__init__()
            self.__gen_blocks = nn.ModuleList(
                nn.Sequential(nn.Conv2d(ci, ci, 3, padding=1), nn.LeakyReLU(0.2), nn.Identity(),
                              nn.Upsample(scale_factor=2), nn.Conv2d(ci, co, 3, padding=1),
                              nn.LeakyReLU(0.2), nn.Identity())
                for ci, co in cfg.gen_channels)
            self.curr = 0
            self.__end_block = self.head(0)

        def head(self, s):
            return nn.Sequential(nn.Conv2d(cfg.gen_channels[s][1], 2, 1), nn.Tanh())

        def next_layer(self):
            self.curr += 1
            self.__last_end_block = nn.Sequential(self.__end_block, nn.Upsample(scale_factor=2))
            self.__end_block = self.head(self.curr)
            return list(self.__end_block.parameters())

    class Discriminator(nn.Module):
        def __init__(self):
            super().__init__()
            self.__conv_blocks = nn.ModuleList(
                nn.Sequential(nn.Conv2d(ci, co, 3, padding=1), nn.LeakyReLU(0.2), nn.AvgPool2d(2),
                              nn.Conv2d(co, co, 3, padding=1), nn.LeakyReLU(0.2))
                for ci, co in cfg.disc_channels)
            self.curr = len(cfg.disc_channels) - 2
            self.__start_block = self.head(self.curr)
            self.__clf = nn.Sequential(nn.Linear(cfg.disc_channels[-1][1], 1))

        def head(self, layer):
            return nn.Sequential(nn.Conv2d(2, cfg.disc_channels[layer][0], 1), nn.LeakyReLU(0.2))

        def next_layer(self):
            self.curr -= 1
            self.__last_start_block = nn.Sequential(nn.AvgPool2d(2), self.__start_block)
            self.__start_block = self.head(self.curr)
            return list(self.__start_block.parameters())

    gen, disc = Generator(), Discriminator()
    opt_g = torch.optim.Adam(gen.parameters(), lr=gen_lr, betas=betas)
    opt_d = torch.optim.Adam(disc.parameters(), lr=disc_lr, betas=betas)
    for _ in range(stage):
        opt_g.add_param_group({"params": gen.next_layer(), "lr": gen_lr, "betas": betas})
        opt_d.add_param_group({"params": disc.next_layer(), "lr": disc_lr, "betas": betas})
    return gen, disc, opt_g, opt_d


def reference_to_port_name(name: str, stage: int, cfg: ModelConfig) -> str:
    """A reference ``state_dict`` name -> the port's parameter name."""
    layer = len(cfg.disc_channels) - 2 - stage
    rules = (
        (r"_Generator__gen_blocks\.(\d+)\.0\.", r"blocks.\1.conv1."),
        (r"_Generator__gen_blocks\.(\d+)\.4\.", r"blocks.\1.conv2."),
        (r"_Generator__end_block\.0\.", f"heads.{stage}."),
        (r"_Generator__last_end_block\.0\.0\.", f"heads.{stage - 1}."),
        (r"_Discriminator__conv_blocks\.(\d+)\.0\.", r"blocks.\1.conv1."),
        (r"_Discriminator__conv_blocks\.(\d+)\.3\.", r"blocks.\1.conv2."),
        (r"_Discriminator__start_block\.0\.", f"heads.{layer}."),
        (r"_Discriminator__last_start_block\.1\.0\.", f"heads.{layer + 1}."),
        (r"_Discriminator__clf\.0\.", "clf."),
    )
    for pat, rep in rules:
        if re.match(pat, name):
            return re.sub(pat, rep, name)
    raise KeyError(name)


def check_reference_load(files: dict, state, stage: int, cfg: ModelConfig, tc: dict) -> dict:
    """Load an ``export --full`` save into the reference's training objects
    (``weights_only=True``, ``strict=True``) and hold every weight, moment
    and step that reaches a reference parameter against the port's state."""
    objs = reference_training_objects(cfg, stage, tc["gen_lr"], tc["disc_lr"], tuple(tc["betas"]))
    gen, disc, opt_g, opt_d = objs
    n = {"weights": 0, "moments": 0}
    for which, module, opt, net, adam in (("gen", gen, opt_g, state.gen, state.opt_gen),
                                          ("disc", disc, opt_d, state.disc, state.opt_disc)):
        module.load_state_dict(torch.load(files[which], map_location="cpu", weights_only=True), strict=True)
        opt.load_state_dict(torch.load(files[f"optim_{which}"], map_location="cpu", weights_only=True))
        own = dict(net.named_parameters())
        for name, p in module.named_parameters():
            port = reference_to_port_name(name, stage, cfg)
            if not torch.equal(p.detach(), own[port].detach().cpu()):
                raise AssertionError(f"{which} weight {name} is not the port's {port}")
            n["weights"] += 1
            st = opt.state.get(p)
            if int(adam.count[port]) == 0:
                if st:
                    raise AssertionError(f"{which} {name}: a state entry for a count of 0")
                continue
            if (float(st["step"]) != int(adam.count[port])
                    or not torch.equal(st["exp_avg"], adam.mu[port].cpu())
                    or not torch.equal(st["exp_avg_sq"], adam.nu[port].cpu())):
                raise AssertionError(f"{which} Adam state of {name} is not the port's {port}")
            n["moments"] += 1
    return n


def carried_names(stage: int, cfg: ModelConfig) -> dict:
    """The parameters a reference save carries at ``stage``: every block,
    the current and previous heads, the classifier."""
    layer = len(cfg.disc_channels) - 2 - stage
    gen = {f"heads.{stage}.{leaf}" for leaf in ("weight", "bias")}
    if stage > 0:
        gen |= {f"heads.{stage - 1}.{leaf}" for leaf in ("weight", "bias")}
    disc = {f"heads.{h}.{leaf}" for h in (layer, layer + 1) for leaf in ("weight", "bias")}
    return {"gen": gen, "disc": disc | {"clf.weight", "clf.bias"}}


def run_cli(argv: list[str]) -> str:
    """The port's CLI in this process (counters readable); its stdout."""
    from musicgan_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    text = buf.getvalue()
    print("".join(f"    | {line}\n" for line in text.splitlines()[-6:]), end="")
    return text


def ingest_and_interchange(cfg: ModelConfig, dev, card: str) -> dict:
    """Phase 11 (see the module's docstring)."""
    from musicgan_tpu_torch.__main__ import supervised_command
    from musicgan_tpu_torch.utils.supervise import run_supervised

    def say(line: str) -> None:  # every number of the phase beside the card
        print(f"{line} ({card})")

    t_phase = time.perf_counter()
    acfg = AudioConfig()
    work = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    total = {k: 0 for k in (*WRAPPERS, IDFT)}
    rec = {"cpu_count": os.cpu_count(), "cpus_usable": len(os.sched_getaffinity(0))}

    # (a) The corpus: seeded 16-bit WAVs, two tones and noise each.
    wav_dir, ds = os.path.join(work, "wavs"), os.path.join(work, "ds")
    os.makedirs(wav_dir)
    rng = np.random.default_rng(SEED)
    sr, lengths, want_samples = acfg.sample_rate, [], 0
    for i in range(INGEST_TRACKS):
        n = int(sr * rng.uniform(*INGEST_SECONDS))
        t = np.arange(n) / sr
        sig = (0.3 * np.sin(2 * np.pi * rng.uniform(110, 880) * t)
               + 0.15 * np.sin(2 * np.pi * rng.uniform(880, 4000) * t) + 0.05 * rng.standard_normal(n))
        wavfile.write(os.path.join(wav_dir, f"track_{i}.wav"), sr, np.round(sig * 32767).astype(np.int16))
        lengths.append(n)
        want_samples += (n // acfg.stft_stride) // acfg.n_vec  # ((1 + n // hop) - 1) // n_vec
    audio_s = sum(lengths) / sr
    longest = os.path.join(wav_dir, f"track_{int(np.argmax(lengths))}.wav")

    # (b) The host path alone, in a process of its own.
    probe = subprocess.run([sys.executable, "-c", INGEST_PROBE, longest], cwd=str(ROOT),
                           capture_output=True, text=True, timeout=300)
    if probe.returncode != 0:
        raise AssertionError(f"ingest probe failed:\n{probe.stderr}")
    pr = json.loads(probe.stdout.strip().splitlines()[-1])
    if not pr["native"] or not pr["lib"].startswith(str(ROOT / "musicgan_tpu_torch" / "_build")):
        raise AssertionError(f"the native host tail did not build into _build/: {pr}")
    if pr["cuda_initialized"]:
        raise AssertionError("importing and running the port's ingest initialised CUDA")
    if max(pr["err"].values()) > TOL_INGEST_BACKENDS:
        raise AssertionError(f"process_signal's backends disagree: {pr['err']}")
    rec["process_signal"] = pr
    say(f"[ingest] process_signal on a {pr['shape'][0]}-chunk track, median of 5: native "
        f"{pr['ms']['native']:.2f} ms, numpy {pr['ms']['numpy']:.2f}, torch {pr['ms']['torch']:.2f}; "
        f"numpy / torch against native {pr['err']['numpy']:.1e} / {pr['err']['torch']:.1e} (bar "
        f"{TOL_INGEST_BACKENDS:.0e}); no CUDA context; {rec['cpu_count']} CPUs, {rec['cpus_usable']} usable")

    # (c) create_dataset, the CLI as a subprocess.
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "musicgan_tpu_torch", "create_dataset", wav_dir, "-o", ds,
                           "-w", str(INGEST_WORKERS)], cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    ingest_s = time.perf_counter() - t0
    with open(os.path.join(ds, "index.json")) as f:
        index = json.load(f)
    printed = proc.stdout.strip().splitlines()
    if (proc.returncode != 0 or not index["complete"] or index["total_samples"] != want_samples
            or not printed or not printed[0].startswith(f"wrote {want_samples} samples in")):
        raise AssertionError(f"create_dataset exited {proc.returncode}, index {index}:\n{proc.stdout}\n{proc.stderr}")
    rec.update(audio_s=audio_s, samples=want_samples, create_dataset_s=ingest_s,
               ingest_audio_s_per_s=audio_s / ingest_s)
    say(f"[ingest] create_dataset -w {INGEST_WORKERS} of {INGEST_TRACKS} WAVs ({audio_s:.2f} s of audio): "
        f"{want_samples} samples in {len(index['shards'])} shards, {ingest_s:.2f} s wall as a subprocess "
        f"(start-up included) = {rec['ingest_audio_s_per_s']:.1f} audio-s/s")

    # (d) train: profiled through all eight stages (cut schedule); under
    # --debug-nans on the clean corpus and on one with a NaN sample.  The
    # three run at once, each in its own process.
    ds_nan = os.path.join(work, "ds_nan")
    os.makedirs(ds_nan)
    for name in os.listdir(ds):
        arr_or = os.path.join(ds, name)
        if name.endswith(".npy"):
            arr = np.load(arr_or)
            if name == index["shards"][0]["file"]:
                arr[0] = np.nan
            np.save(os.path.join(ds_nan, name), arr)
        else:
            with open(arr_or) as f_in, open(os.path.join(ds_nan, name), "w") as f_out:
                f_out.write(f_in.read())
    run_a, trace_dir = os.path.join(work, "run_a"), os.path.join(work, "trace")
    runs = {
        "profile": [sys.executable, str(ROOT / "chip_smoke.py"), CUT_SCHEDULE_FLAG, "train", "p11", "-i", ds,
                    "-o", run_a, "--max-iters", str(RUN_ITERS), "--save-every", str(RUN_SAVE_EVERY),
                    "--log-every", "5", "--chunk-steps", "4", "--profile", trace_dir],
        "nans_clean": [sys.executable, "-m", "musicgan_tpu_torch", "train", "p11_nans", "-i", ds, "-o",
                       os.path.join(work, "run_n"), "--max-iters", "3", "--log-every", "1", "--chunk-steps", "1",
                       "--debug-nans"],
        "nans_bad": [sys.executable, "-m", "musicgan_tpu_torch", "train", "p11_nan", "-i", ds_nan, "-o",
                     os.path.join(work, "run_x"), "--max-iters", "3", "--log-every", "1", "--chunk-steps", "1",
                     "--debug-nans"],
    }
    logs = {k: os.path.join(work, f"{k}.log") for k in runs}
    t0 = time.perf_counter()
    procs = {}
    walls, outs = {}, {}
    try:
        for k, c in runs.items():
            with open(logs[k], "w") as log:
                procs[k] = subprocess.Popen(c, cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT)
        # Meanwhile, ingest from this process, which has a CUDA context and
        # its threads: the pool must not fork, and gives the CLI's bytes.
        method = ingest._start_method()
        ds_here = os.path.join(work, "ds_here")
        ingest.create_dataset(wav_dir, ds_here, num_workers=INGEST_WORKERS, progress=False)
        same = sorted(os.listdir(ds)) == sorted(os.listdir(ds_here)) and all(
            filecmp.cmp(os.path.join(ds, n), os.path.join(ds_here, n), shallow=False) for n in os.listdir(ds))
        if (torch.cuda.is_initialized() and method == "fork") or not same:
            raise AssertionError(f"create_dataset from a process with CUDA: start method {method}, "
                                 f"files equal to the CLI's: {same}")
        while len(walls) < len(procs):
            if time.perf_counter() - t0 > 600:
                raise AssertionError(f"phase 11's train runs still running after 600 s: {sorted(set(procs) - set(walls))}")
            for k, p in procs.items():
                if k not in walls and p.poll() is not None:
                    walls[k] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, path in logs.items():
        with open(path) as f:
            outs[k] = f.read()
    for k in runs:
        print(f"    [{k}] exit {procs[k].returncode}, {walls[k]:.2f} s wall")
        print("".join(f"    | {line}\n" for line in outs[k].splitlines()[-4:]), end="")
    if procs["profile"].returncode != 0 or procs["nans_clean"].returncode != 0:
        raise AssertionError("the profiled or the clean --debug-nans run failed")
    if f"stopped at iter {RUN_ITERS}; stage {cfg.n_stages - 1}" not in outs["profile"]:
        raise AssertionError("the profiled run did not reach stage 7")
    bad = re.search(r"FloatingPointError: (\w+): non-finite value", outs["nans_bad"])
    if procs["nans_bad"].returncode in (0, EXIT_STALLED) or bad is None:
        raise AssertionError(f"the NaN corpus under --debug-nans exited {procs['nans_bad'].returncode}")
    trace_path = os.path.join(trace_dir, "trace.json")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    # the port's kernels by their function names in csrc/ (the demangled
    # name carries the return type and the template arguments)
    names = sorted({m.group(1) for k in kernels
                    for m in [re.search(r"\b((?:conv|wgrad|block|istft)_\w*kernel)\b", k)] if m})
    if not any(n.startswith("conv_") for n in names) or not any(n.startswith("wgrad_") for n in names):
        raise AssertionError(f"the trace's {len(kernels)} kernel events name no conv or weight-gradient "
                             f"kernel: {sorted(set(kernels))[:20]}")
    rec.update(profile_run_s=walls["profile"], trace_bytes=os.path.getsize(trace_path),
               trace_kernel_events=len(kernels), trace_kernels=names, nan_first_op=bad.group(1))
    say(f"[ingest] create_dataset -w {INGEST_WORKERS} from this process (a CUDA context, its threads): "
        f"the '{method}' start method, files byte for byte the CLI's")
    say(f"[train] profiled run, {RUN_ITERS} iterations through 8 stages: {walls['profile']:.2f} s wall "
        f"(start-up and trace included); trace {rec['trace_bytes'] / 2**20:.1f} MiB, {len(kernels)} kernel "
        f"events, the port's {names}; --debug-nans clean: exit 0; NaN sample: exit "
        f"{procs['nans_bad'].returncode}, first op {bad.group(1)}")
    del events, kernels

    # (e) export --full of the last save, loaded into the reference's own
    # training objects.
    src_idx = CheckpointManager(os.path.join(run_a, "checkpoints")).latest()
    src, meta_a = CheckpointManager(os.path.join(run_a, "checkpoints")).restore(
        src_idx, init_train_state(SEED, cfg, device="cuda"), load_rng=False)
    stage = int(meta_a["grower"]["curr_grow"])
    if stage != cfg.n_stages - 1 or meta_a["iter_idx"] != RUN_ITERS:
        raise AssertionError(f"the last save is at stage {stage}, iteration {meta_a['iter_idx']}")
    ref = os.path.join(work, "ref")
    t0 = time.perf_counter()
    run_cli(["export", run_a, "-o", ref, "--full"])
    export_s = time.perf_counter() - t0
    files = {k: os.path.join(ref, f"{k}_{src_idx}.pt") for k in ("gen", "disc", "optim_gen", "optim_disc")}
    loaded = check_reference_load(files, src, stage, cfg, meta_a["train_cfg"])

    # (f) import into a new run directory: equal to the source save in
    # every weight the format carries, every moment and count.
    run_b = os.path.join(work, "run_b")
    t0 = time.perf_counter()
    run_cli(["import", ref, str(src_idx), "-o", run_b, "--iter", str(RUN_ITERS)])
    import_s = time.perf_counter() - t0
    imp, meta_b = CheckpointManager(os.path.join(run_b, "checkpoints")).restore(
        0, init_train_state(SEED + 3, cfg, device="cuda"))
    carried, n_equal = carried_names(stage, cfg), 0
    for which in ("gen", "disc"):
        a_net, b_net = dict(getattr(src, which).named_parameters()), dict(getattr(imp, which).named_parameters())
        a_opt, b_opt = getattr(src, f"opt_{which}"), getattr(imp, f"opt_{which}")
        for k in a_net:
            if (k.startswith("blocks.") or k in carried[which]) and not torch.equal(a_net[k], b_net[k]):
                raise AssertionError(f"imported {which} weight {k} differs")
            for field in ("count", "mu", "nu"):
                if not torch.equal(getattr(a_opt, field)[k], getattr(b_opt, field)[k]):
                    raise AssertionError(f"imported {which} Adam {field} of {k} differs")
                n_equal += 1
    if int(imp.iter_idx) != RUN_ITERS or meta_b["grower"]["curr_grow"] != stage:
        raise AssertionError(f"imported meta {meta_b}")
    rec.update(export_s=export_s, import_s=import_s, reference_load=loaded, adam_leaves_equal=n_equal)
    say(f"[interchange] export --full of save_{src_idx} (stage {stage}) {export_s * 1e3:.1f} ms, loaded "
        f"into the reference's modules and Adams: {loaded['weights']} weights, {loaded['moments']} moment "
        f"pairs equal; import {import_s * 1e3:.1f} ms: carried weights, {n_equal} Adam leaves equal bit for bit")
    del src, imp

    # (g) generate from the imported run directory and from gen_{i}.pt.
    wavs = {}
    for what, ckpt in (("imported run", run_b), ("exported gen", files["gen"])):
        out = os.path.join(work, f"wav_{len(wavs)}")
        reset_launches()
        run_cli(["generate", ckpt, str(cfg.rand_channels), "-o", out, "-n", "2", "-m", "2"])
        counted(total, expected_serve_launches(cfg, 1), f"generate from the {what}")
        wavs[what] = [open(os.path.join(out, f"sound_{i}.wav"), "rb").read() for i in range(2)]
    if wavs["imported run"] != wavs["exported gen"]:
        raise AssertionError("generate from the imported run and from gen_{i}.pt differ")

    # (h) train --resume of the imported run, 4 iterations at stage 7.
    by_kind = [0, 0]
    for it in range(RUN_ITERS, RUN_ITERS + RESUME_ITERS):
        by_kind[it % TrainConfig().n_critic == 0] += 1
    reset_launches()
    t0 = time.perf_counter()
    text = run_cli(["train", "p11_imp", "-i", ds, "-o", run_b, "--resume", "--log-every", "1",
                    "--max-iters", str(RUN_ITERS + RESUME_ITERS)])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    counted(total, expected_train_launches(cfg, stage, *by_kind), "train --resume at stage 7")
    if (f"[resume] save_0: iter={RUN_ITERS} stage={stage}" not in text
            or f"stopped at iter {RUN_ITERS + RESUME_ITERS}; stage {stage}" not in text):
        raise AssertionError("train --resume did not continue the imported run at stage 7")
    rec["resume_s"] = resume_s
    say(f"[interchange] generate from the imported run and from gen_{src_idx}.pt: the same WAVs bit for bit; "
        f"train --resume: {RESUME_ITERS} iterations at stage {stage} in {resume_s:.2f} s (restore included)")

    # (i) --max-restarts: the CLI's supervised_command under run_supervised; the
    # first child is sent SIGTERM once it logs an iteration.
    run_s = os.path.join(work, "run_s")
    argv = ["train", "p11_sup", "-i", ds, "-o", run_s, "--max-iters", "8", "--save-every", "4",
            "--log-every", "1", "--chunk-steps", "1", "--max-restarts", "1"]
    children = []

    def run_child(cmd, env=None):
        p = subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lines = []
        try:
            for line in p.stdout:
                lines.append(line)
                if not children and line.startswith("e000 it"):
                    p.send_signal(signal.SIGTERM)
                    break
            lines.append(p.communicate(timeout=300)[0])
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        children.append((cmd, p.returncode, "".join(lines)))
        return subprocess.CompletedProcess(cmd, p.returncode)

    t0 = time.perf_counter()
    rc = run_supervised(functools.partial(supervised_command, argv), 1, backoff_s=1, _run=run_child)
    sup_s = time.perf_counter() - t0
    last = CheckpointManager(os.path.join(run_s, "checkpoints"))
    with open(os.path.join(last._dir(last.latest()), "meta.json")) as f:
        meta_s = json.load(f)
    cmds = [c for c, _, _ in children]
    if (rc != 0 or [r for _, r, _ in children] != [EXIT_STALLED, 0]
            or "--resume" in cmds[0] or "--resume" not in cmds[1] or "--max-restarts" in " ".join(cmds[0])
            or cmds[0][-2:] != ["--stall-timeout", "900"] or meta_s["iter_idx"] != 8):
        raise AssertionError(f"supervised run: rc {rc}, children {[(c[3:], r) for c, r, _ in children]}, "
                             f"last save {meta_s}")
    rec["supervised_s"] = sup_s
    say(f"[supervise] child 1 sent SIGTERM -> exit 75, relaunched with --resume -> exit 0, last save at "
        f"iteration 8; {sup_s:.2f} s wall with a 1 s backoff")

    rec["launches"] = total
    rec["phase_s"] = time.perf_counter() - t_phase
    say(f"[interchange] launches in phase 11: {total}; the phase took {rec['phase_s']:.2f} s")
    return rec


PR_SET_CHILD_SUBREAPER = 36  # <linux/prctl.h>


# ---------------------------------------------------------------------------
# Phase 12: conv_impl selection (``ops/autotune.py``).  Phases 1-11 run
# fixed impls: in this process by name (``pallas_up`` for synthesis,
# ``pallas_gp`` for training), and in their CLI subprocesses, which run
# "auto", through a table pre-seeded with those winners
# (``seed_autotune_table``, the JAX contract's own mechanism).  Phase 12
# runs "auto" itself in a fresh table: the six inference candidates, the
# two vocoders, the library lowerings, the four train impls, bf16 training
# and ``train()`` with a measurement at each stage.

PHASE12_BF16_ITERS = 10  # bf16 train iterations held finite, in the n_critic pattern


def use_autotune_dir(path: str) -> None:
    """Point the autotuner at ``path``'s table (this process and the
    subprocesses it starts) and forget what it resolved in memory."""
    os.environ["MUSICGAN_AUTOTUNE_DIR"] = path
    autotune._CACHE.clear()


def seed_autotune_table(path: str, dev) -> int:
    """A table with the winners phases 1-11 were written for: ``pallas_up``
    at every inference key they reach (stages 0-7, 1-10 clips, nb_vec
    1-12), K5 (``"pallas"``) at every vocoder length up to the service's
    cap (nb_vec 120), ``pallas_gp`` at every float32 train key (stages 0-7,
    batch 1-8).  Returns the number of keys."""
    backend = autotune._backend(dev)
    table = {}
    for stage in range(8):
        for m in range(1, 11):
            for nv in range(1, 13):
                table[autotune._candidates_and_key(backend, (m, 2, 2 * nv, 32), stage, False, None)[1]] = "pallas_up"
        for b in range(1, 9):
            key = autotune._candidates_and_key(backend, (b, 2, 2, 32), stage, True, TrainConfig(batch_size=b))[1]
            table[key] = "pallas_gp"
    for nv in range(1, 121):
        table[autotune._istft_key(backend, 513, 512 * nv)] = "pallas"
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "conv_autotune.json"), "w") as f:
        json.dump(table, f)
    return len(table)


class Tally:
    """The launches of phase 12's counted paths, and of them the bf16 ones."""

    def __init__(self):
        self.launches = {k: 0 for k in (*WRAPPERS, IDFT)}
        self.bf16 = {k: 0 for k in BF16_WRAPPERS}

    def read(self) -> tuple[dict, dict]:
        got, bf = read_launches(), read_bf16_launches()
        for k in self.launches:
            self.launches[k] += got[k]
        for k in self.bf16:
            self.bf16[k] += bf[k]
        return got, bf


def inference_auto(cfg: ModelConfig, dev, say, work: str, tally: Tally) -> dict:
    """Phase 12 (a): "auto" at synth-5x10.  The six candidates, then the
    resolution (which measures them again) and its persisted winner; the
    two vocoders and K5 against the plain iSTFT; ``generate --conv-impl
    auto`` as a subprocess reads the table (no measurement), and in this
    process beside ``--conv-impl <winner>``: the same launches, and all
    three the same WAV bytes."""
    acfg, stage = AudioConfig(), cfg.n_stages - 1
    auto = dataclasses.replace(cfg, conv_impl="auto")
    z = main_path_latent(cfg, dev)
    t_frames = z.shape[2] * 2**cfg.n_stages
    times = autotune.measure_conv_impls(auto, tuple(z.shape), stage)
    say("[autotune] synth-5x10 generator forward, ms each: "
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in times.items()))
    t0 = time.perf_counter()
    winner = autotune.resolve_conv_impl(auto, tuple(z.shape), stage).conv_impl
    resolve_s = time.perf_counter() - t0
    key = autotune._candidates_and_key(autotune._backend(dev), tuple(z.shape), stage, False, None)[1]
    if autotune._load_persisted().get(key) != winner:
        raise AssertionError(f"the winner {winner!r} is not persisted under {key!r}")
    voc = autotune.measure_istft_impls(acfg.n_bins + 1, t_frames)
    voc_winner = autotune.resolve_istft_impl(t_frames)
    gen_up = load_reference_generator(str(CKPT), cfg, device=dev)
    with torch.no_grad():
        real, imag = mp_to_real_imag(gen_up.forward_nchw(z.permute(0, 3, 1, 2), stage)[:, None], acfg)
        err_voc = (istft_ops.istft_fused(real, imag) - istft_real_imag(real, imag)).abs().max().item()
    del gen_up, real, imag
    say(f"[autotune] resolved conv_impl {winner!r} in {resolve_s:.2f} s (persisted); vocoder, ms each: "
        + ", ".join(f"{k} {v * 1e3:.4f}" for k, v in voc.items())
        + f" -> {voc_winner!r}; K5 against istft_real_imag on the main path's spectra: {err_voc:.2e} (tol 1e-4)")
    if not err_voc <= 1e-4:
        raise AssertionError("K5 disagrees with the plain iSTFT")

    argv = ["generate", str(CKPT), str(cfg.rand_channels), "-n", str(NB_VEC), "-m", str(NB_MUSIC)]
    out_sub = os.path.join(work, "wav_sub")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "musicgan_tpu_torch", *argv, "-o", out_sub, "--conv-impl", "auto"],
                          cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0 or "[autotune]" in proc.stdout + proc.stderr:
        raise AssertionError(f"generate --conv-impl auto: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    wavs, runs = {"subprocess auto": out_sub}, {}
    for impl in (winner, "auto"):
        out = os.path.join(work, f"wav_{impl}")
        reset_launches()
        run_cli([*argv, "-o", out, "--conv-impl", impl])
        runs[impl] = tally.read()
        wavs[f"--conv-impl {impl}"] = out
    if runs["auto"] != runs[winner]:
        raise AssertionError(f"generate under auto launched {runs['auto']}, under {winner!r} {runs[winner]}")
    blobs = {k: [open(os.path.join(d, f"sound_{i}.wav"), "rb").read() for i in range(NB_MUSIC)]
             for k, d in wavs.items()}
    if not all(b == blobs["subprocess auto"] for b in blobs.values()):
        raise AssertionError("the WAVs of generate under auto and under the winner differ")
    say(f"[autotune] generate --conv-impl auto as a subprocess ({sub_s:.2f} s): no measurement, the WAVs of "
        f"--conv-impl {winner} bit for bit; launches under auto {runs['auto'][0]}, of them in bf16 {runs['auto'][1]}, "
        f"equal to {winner!r}'s")
    return {"inference_ms": {k: v * 1e3 for k, v in times.items()}, "winner": winner, "resolve_s": resolve_s,
            "vocoder_ms": {k: v * 1e3 for k, v in voc.items()}, "vocoder_winner": voc_winner,
            "err_vocoder": err_voc, "generate_launches": {k: v[0] for k, v in runs.items()}}


def float64_synthesis(cfg: ModelConfig, dev, z) -> tuple[torch.Tensor, torch.Tensor]:
    """The image and waveforms of ``gen_final.pt`` on ``z`` through the
    plain path in float64 (the library lowering's convs in float64, the
    float64 iSTFT)."""
    cfg_x = dataclasses.replace(cfg, conv_impl="xla")
    gen64 = load_reference_generator(str(CKPT), cfg_x, device=dev).double()
    with torch.no_grad(), mock.patch.object(generate_mod, "istft_fused", istft_float64):
        z64 = z.double()
        img64 = gen64.forward_nchw(z64.permute(0, 3, 1, 2), cfg.n_stages - 1)
        waves64 = generate_mod._synthesize(gen64, z64, cfg.n_stages - 1, cfg_x, "pallas")
    return img64, waves64


def library_inference(cfg: ModelConfig, dev, say, work: str, tally: Tally, voc_winner: str) -> dict:
    """Phase 12 (b): ``generate`` under the library lowerings ``xla`` and
    ``subpixel``: no conv kernel launched; image and waveform held at phase
    3's bars against what phase 3 holds the kernels against, the plain
    path in float32 on the card, and the waveform against the plain path in
    float64 too; the image's distance to float64 is read, as phase 3 reads
    the plain path's (the library lowerings are cuDNN in float32, and cuDNN
    in float32 lies about 2e-3 from float64 on this generator's
    ill-conditioned pixels, the plain path included); warm synthesis."""
    acfg, stage = AudioConfig(), cfg.n_stages - 1
    z = main_path_latent(cfg, dev)
    img64, waves64 = float64_synthesis(cfg, dev, z)
    gen = load_reference_generator(str(CKPT), cfg, device=dev)
    patches = plain_on_card()
    for p in patches:
        p.start()
    try:
        with torch.no_grad():
            img_plain = gen.forward_nchw(z.permute(0, 3, 1, 2), stage)
            waves_plain = generate_mod.synthesize_fn(cfg, stage)(gen, z)
    finally:
        for p in patches:
            p.stop()
    del gen
    n_samples = (cfg.latent_width * NB_VEC * 2**cfg.n_stages - 1) * acfg.stft_stride
    want = {"fused_conv3x3": 0, "fused_conv3x3_msq": 0, "fused_upconv3x3": 0, "fused_block": 0,
            "weight_grad3x3": 0, "head1x1": 0, IDFT: 0, "istft_fused": int(voc_winner == "pallas")}
    rec = {}
    for impl in ("xla", "subpixel"):
        cfg_i = dataclasses.replace(cfg, conv_impl=impl)
        reset_launches()
        paths = generate_mod.generate(os.path.join(work, f"lib_{impl}"), cfg.rand_channels, str(CKPT),
                                      nb_vec=NB_VEC, nb_music=NB_MUSIC, seed=SEED, model_cfg=cfg_i, device="cuda")
        got, _ = tally.read()
        if got != want:
            raise AssertionError(f"generate under {impl!r} launched {got}, not {want}")
        waves = []
        for p in paths:
            wave, sr = load_wav(p)
            if sr != acfg.sample_rate or wave.shape != (n_samples,) or not np.isfinite(wave).all():
                raise AssertionError(f"{p}: {sr} Hz, {wave.shape}")
            waves.append(wave)
        gen_i = load_reference_generator(str(CKPT), cfg_i, device=dev)
        reset_launches()
        with torch.no_grad():
            img = gen_i.forward_nchw(z.permute(0, 3, 1, 2), stage)
        if any(read_launches().values()):
            raise AssertionError(f"the {impl!r} forward launched {read_launches()}")
        wave_t = torch.from_numpy(np.stack(waves)).to(dev)
        errs = {"image": (img - img_plain).abs().max().item(), "wave": (wave_t - waves_plain).abs().max().item(),
                "image_float64": (img.double() - img64).abs().max().item(),
                "wave_float64": (wave_t.double() - waves64).abs().max().item()}
        warm = warm_synthesis_s(generate_mod.synthesize_fn(cfg_i, stage), gen_i, z, WARM_REPS)
        med = float(np.median(warm))
        say(f"[library] generate under {impl!r}: no conv kernel launched ({got}); against the plain path on the "
            f"card: image {errs['image']:.3e} (tol {TOL_IMAGE:.0e}), waveform {errs['wave']:.3e} (tol "
            f"{TOL_WAVE:.0e}); against float64: waveform {errs['wave_float64']:.3e} (tol {TOL_WAVE:.0e}), image "
            f"{errs['image_float64']:.3e} (read); warm synthesis, median of {WARM_REPS}: {med * 1e3:.3f} ms "
            f"(min {min(warm) * 1e3:.3f})")
        if not (errs["image"] <= TOL_IMAGE and errs["wave"] <= TOL_WAVE and errs["wave_float64"] <= TOL_WAVE):
            raise AssertionError(f"{impl!r} disagrees with the plain path")
        rec[impl] = {**errs, "warm_ms": med * 1e3, "warm_s": warm, "launches": got}
        del gen_i, img
    return rec


def train_impls(cfg: ModelConfig, dev, say, tally: Tally) -> dict:
    """Phase 12 (c): at train-s7-b6 the four train impls timed on a chunk
    of the step, then the first D+G iteration of each from one state and
    one noise, counted, against the float64 plain step at phase 6's bars."""
    tcfg = TrainConfig()
    bsz = tcfg.batch_size
    t0 = time.perf_counter()
    train_times = autotune.measure_train_impls(dataclasses.replace(cfg, conv_impl="auto"), tcfg, TRAIN_STAGE)
    measure_s = time.perf_counter() - t0
    say("[autotune] train-s7-b6, ms per iteration (a chunk of 5, one with the generator): "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in train_times.items()) + f"; measured in {measure_s:.2f} s")
    rng = torch.Generator(device=dev).manual_seed(SEED + 12)
    x = torch.randn(bsz, 2, 512, 512, generator=rng, device=dev)
    base = init_train_state(SEED, cfg, tcfg, device="cuda")
    ref = float64_state(base)
    with plain_convs():
        ref, _ = build_step(TRAIN_STAGE, True, dataclasses.replace(cfg, conv_impl="pallas_gp"), tcfg)(
            ref, x.double(), TRAIN_ALPHA, noise=same_noise(ref, cfg, bsz))
    mu64 = first_moments(ref)
    del ref
    c = 2 * (TRAIN_STAGE + 2)
    kernels_all = expected_train_launches(cfg, TRAIN_STAGE, 0, 1)
    expect = {
        "pallas_gp": kernels_all,
        # under pallas_train the penalty's kernels (3 c K1, c weight gradients) are the library critic's
        "pallas_train": {**kernels_all, "fused_conv3x3": kernels_all["fused_conv3x3"] - 3 * c,
                         "weight_grad3x3": kernels_all["weight_grad3x3"] - c},
        "xla": {k: 0 for k in kernels_all}, "subpixel": {k: 0 for k in kernels_all},
    }
    flat = lambda mu, keys: torch.cat([mu[k].flatten().double() for k in keys])  # noqa: E731
    rec = {"ms_per_iteration": {k: v * 1e3 for k, v in train_times.items()}, "measure_s": measure_s}
    for impl in autotune.TRAINING_IMPLS:
        state = base.clone()
        reset_launches()
        state, m = build_step(TRAIN_STAGE, True, dataclasses.replace(cfg, conv_impl=impl), tcfg)(state, x, TRAIN_ALPHA)
        m = metrics_floats(m)
        got, _ = tally.read()
        if got != expect[impl]:
            raise AssertionError(f"the {impl!r} iteration launched {got}, not {expect[impl]}")
        mu = first_moments(state)
        errs = {}
        for net in ("gen.", "disc."):
            keys = [k for k in mu if k.startswith(net)]
            errs[net] = rel_l2(flat(mu, keys), flat(mu64, keys))
        say(f"[train-impls] {impl:12s} first D+G iteration: launches {got}; gradients against the float64 plain "
            f"step, rel L2: generator {errs['gen.']:.2e} (tol {TOL_BACKWARD_L2:.0e}), critic {errs['disc.']:.2e} "
            f"(tol {TOL_CRITIC_ITERATION_L2:.0e}); grad_pen {m['grad_pen']:.4f}")
        if not (errs["gen."] <= TOL_BACKWARD_L2 and errs["disc."] <= TOL_CRITIC_ITERATION_L2):
            raise AssertionError(f"the {impl!r} iteration disagrees with the float64 plain step")
        if torch.backends.cudnn.deterministic or torch.backends.cudnn.allow_tf32:
            raise AssertionError("a train step left cuDNN's flags changed")
        rec[impl] = {"launches": got, "grad_rel_l2_vs_float64": errs, "metrics": m}
        del state, mu
    return rec


def bf16_training(cfg: ModelConfig, dev, say) -> dict:
    """Phase 12 (d): ``bfloat16`` and ``bfloat16_f32gp`` training under
    ``xla`` at train-s7-b6, 10 iterations in the n_critic pattern finite,
    parameters float32; warm steps/s beside float32 ``pallas_gp``'s."""
    tcfg = TrainConfig()
    n_c = tcfg.n_critic
    x = torch.randn(tcfg.batch_size, 2, 512, 512, generator=torch.Generator(device=dev).manual_seed(SEED + 13),
                    device=dev)
    gen_mask = [(i + 1) % n_c == 0 for i in range(PHASE12_BF16_ITERS)]
    rec = {}
    for label, impl, cdt in (("float32 pallas_gp", "pallas_gp", "float32"), ("bfloat16 xla", "xla", "bfloat16"),
                             ("bfloat16_f32gp xla", "xla", "bfloat16_f32gp")):
        tcfg_b = dataclasses.replace(tcfg, compute_dtype=cdt)
        cfg_b = dataclasses.replace(cfg, conv_impl=impl)
        state = init_train_state(SEED, cfg_b, tcfg_b, device="cuda")
        hist = []
        for do_g in gen_mask:
            state, m = build_step(TRAIN_STAGE, do_g, cfg_b, tcfg_b)(state, x, TRAIN_ALPHA)
            hist.append(metrics_floats(m))
        params_f32 = all(p.dtype == torch.float32 for net in (state.gen, state.disc) for p in net.parameters())
        if not params_f32 or not all(h["grad_pen"] >= 0 for h in hist):
            raise AssertionError(f"{label}: parameters float32 {params_f32}, grad_pen {[h['grad_pen'] for h in hist]}")
        d_s = timed_iterations(build_step(TRAIN_STAGE, False, cfg_b, tcfg_b), state, x, TIMED_ITERS)
        dg_s = timed_iterations(build_step(TRAIN_STAGE, True, cfg_b, tcfg_b), state, x, TIMED_ITERS)
        med_d, med_dg = float(np.median(d_s)), float(np.median(dg_s))
        rate = n_c / ((n_c - 1) * med_d + med_dg)
        say(f"[train-bf16] {label}: {PHASE12_BF16_ITERS} iterations finite, grad_pen >= 0, parameters float32; "
            f"warm, median of {TIMED_ITERS}: critic only {med_d * 1e3:.2f} ms, critic + generator "
            f"{med_dg * 1e3:.2f} ms = {rate:.3f} steps/s")
        rec[label] = {"d_only_s": d_s, "d_and_g_s": dg_s, "steps_per_s": rate, "metrics": hist}
        del state
    return rec


def train_under_auto(cfg: ModelConfig, say, work: str) -> dict:
    """Phase 12 (e): ``train()`` under "auto" through the eight stages on
    phase 8's cut schedule: each stage measured at its first step (the impl
    it resolved to and the measurement's cost); stopped half way and
    resumed equals the uninterrupted run bit for bit, whichever impl won."""
    auto = dataclasses.replace(cfg, conv_impl="auto")
    ds = os.path.join(work, "ds")
    writer = ShardWriter(ds, samples_per_shard=8)
    writer.add(torch.randn(LOOP_SAMPLES, 2, 512, 512, generator=torch.Generator().manual_seed(SEED)).numpy())
    writer.close()
    tcfg = TrainConfig(**LOOP_CFG)
    half = LOOP_ITERS // 2
    out_a, out_b = os.path.join(work, "auto_a"), os.path.join(work, "auto_b")
    state_a, text_a, _, wall_a = run_train("auto", ds, out_a, tcfg, auto, max_iters=LOOP_ITERS)
    found = re.findall(r"\[autotune\] train conv_impl \(stage (\d+)\) -> (\w+) .*measured in ([0-9.]+) s", text_a)
    resolved = {int(s): i for s, i, _ in found}
    costs = {int(s): float(t) for s, _, t in found}
    if sorted(resolved) != list(range(cfg.n_stages)):
        raise AssertionError(f"train() under auto measured stages {sorted(resolved)}")
    run_train("auto", ds, out_b, tcfg, auto, show=False, max_iters=half)
    state_b, text_b, _, _ = run_train("auto", ds, out_b, tcfg, auto, show=False, max_iters=LOOP_ITERS, resume=True)
    if "[autotune]" in text_b or f"[resume] save_{half // tcfg.save_every - 1}: iter={half}" not in text_b:
        raise AssertionError("the resumed run under auto measured again or did not resume half way")
    diff = state_diff(state_a, state_b)
    say(f"[train-auto] {LOOP_ITERS} iterations through 8 stages in {wall_a:.2f} s, measurement included; "
        f"resolved {resolved}; measurement per stage, s: {costs} (sum {sum(costs.values()):.2f}); resumed at "
        f"{half} against uninterrupted: exact {diff['exact']}, rel L2 {diff['rel_l2']}, largest absolute "
        f"difference {diff['max_abs']:.3e} (held at 0)")
    if not all(diff["exact"].values()) or max(diff["rel_l2"].values()) != 0.0 or diff["max_abs"] != 0.0:
        raise AssertionError(f"resume under auto is not bit-exact: {diff}")
    return {"resolved": resolved, "measure_s_by_stage": costs, "wall_s": wall_a, "resume": diff}


def info_subprocess(say) -> dict:
    """Phase 12 (f): ``info`` as a subprocess: the card, the native tail,
    the autotune table."""
    proc = subprocess.run([sys.executable, "-m", "musicgan_tpu_torch", "info"], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    info = json.loads(proc.stdout) if proc.returncode == 0 else {}
    table = autotune._load_persisted()
    if (info.get("backend") != "cuda" or info.get("devices") != [torch.cuda.get_device_name(0)]
            or info.get("native_ingest") is not True or info.get("autotune_cache") != table):
        raise AssertionError(f"info: exit {proc.returncode}, {proc.stdout[:2000]}\n{proc.stderr}")
    say(f"[info] backend {info['backend']}, devices {info['devices']}, torch {info['torch']}, native tail "
        f"{os.path.relpath(info['native_lib'], ROOT)}, autotune table of {len(table)} keys")
    return {k: info[k] for k in ("backend", "devices", "torch", "process_count", "native_ingest")}


def conv_impl_selection(cfg: ModelConfig, dev, card: str) -> dict:
    """Phase 12 (see the module's docstring), in a fresh autotune table."""
    def say(line: str) -> None:
        print(f"{line} ({card})")

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    seeded = os.environ["MUSICGAN_AUTOTUNE_DIR"]
    use_autotune_dir(os.path.join(work, "autotune"))
    tally = Tally()
    rec = {"inference": inference_auto(cfg, dev, say, work, tally)}
    rec["library"] = library_inference(cfg, dev, say, work, tally, rec["inference"]["vocoder_winner"])
    rec["train"] = train_impls(cfg, dev, say, tally)
    rec["bf16_training"] = bf16_training(cfg, dev, say)
    rec["train_auto"] = train_under_auto(cfg, say, work)
    rec["info"] = info_subprocess(say)
    use_autotune_dir(seeded)
    rec.update(launches=tally.launches, bf16_launches=tally.bf16, phase_s=time.perf_counter() - t_phase)
    say(f"[autotune] phase 12 in {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# Phase 13: parallelism (``musicgan_tpu_torch/parallel``).  The card machine
# has one H100, so the paths run the only way one card allows: the long
# clip's shards all on cuda:0, one after another; two data-parallel ranks
# sharing the card over gloo (the backend rule), and a one-rank NCCL group
# for the NCCL code path.  NCCL across cards and shards on several cards
# are not verified here.

LONG_NB_VEC = 16        # one request of 32 latent columns, 47.5 s of audio
# The long clip under "auto" against the unsharded float32 synthesis, max
# abs: JAX's bar between its sharded and unsharded clip
# (tests/test_parallel.py's atol), one float32 impl on every shard (a bf16
# shard is about 6e-2 off).  The relative 2-norm is printed, not held: a
# float32 clip of 47.5 s sharded 4 ways is 9.1e-4 from unsharded in it on
# an H100 (the phase's prefix sum split at the shards, a few float32 ulps
# of 25,000 rad, on quiet audio).
TOL_LONGCLIP_AUTO = 5e-4
LONG_SHARDS = (2, 4)
LONG_TIMED = 5          # warm calls timed one by one; the median is quoted
DP_BATCH = 6            # the global batch of the data-parallel step: 3 a rank
DP_TIMED = 3            # warm D-only iterations a rank times
DP_RANK_FLAG = "--dp-rank"
DP_TIMEOUT_S = 300      # a rank's and a CLI run's limit, and the group's
# The sharded waveform against the unsharded one on the card: phase 3's
# waveform bar.  The two differ by the phase prefix sum's rounding (per
# shard plus a carry, against one scan over 8,192 frames: a few float32
# ulps of up to pi x 8,192 radians) and by the convs' sums over other
# widths; both end as a phase error of order 1e-3 radians on magnitudes
# that peak near 0.05.
TOL_LONGCLIP = TOL_WAVE


def expected_longclip_launches(stage: int, shards: int) -> dict:
    """A clip sharded ``shards`` ways under ``pallas_up`` with K5 as the
    vocoder: each shard runs the stage's blocks (K1 and K3 each) and one
    K5."""
    per = {"fused_conv3x3": stage + 1, "fused_upconv3x3": stage + 1, "istft_fused": 1}
    return {k: shards * per.get(k, 0) for k in (*WRAPPERS, IDFT)}


def warm_ms(fn, n: int) -> float:
    """The median of ``n`` warm calls, each timed to the end of its device
    work (the pieces stay on the card)."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(out))


def seed_longclip_vocoder(shards_set) -> None:
    """K5 at the vocoder lengths the shards give (each shard's own frames
    plus its neighbours'), in the table phases 1-13 run their impls from."""
    from musicgan_tpu_torch.parallel.longclip import VOCODER_HALO

    table = autotune._load_persisted()
    backend = autotune._backend(torch.device("cuda", 0))
    frames = 2 * LONG_NB_VEC * 2 ** 8
    for n in shards_set:
        own = frames // n
        for t in {own + VOCODER_HALO[1], own + sum(VOCODER_HALO), own + VOCODER_HALO[0]}:
            table[autotune._istft_key(backend, 513, t)] = "pallas"
    autotune._persist(table)
    autotune._CACHE.clear()


def longclip(cfg: ModelConfig, dev, say) -> dict:
    """Phase 13 (a): one request of nb_vec 16 from ``gen_final.pt`` at stage
    7 through ``sharded_synthesize_fn`` on 2 and 4 shards of the card,
    counted, against unsharded ``synthesize_fn`` and the float64 plain
    path; warm times; then under "auto" in a fresh table."""
    from musicgan_tpu_torch.parallel import Mesh
    from musicgan_tpu_torch.parallel.longclip import VOCODER_HALO, join_pieces, latent_halo, sharded_synthesize_fn

    stage = cfg.n_stages - 1
    seed_longclip_vocoder(LONG_SHARDS)
    gen = load_reference_generator(str(CKPT), cfg, device=dev)
    z = generate_mod.latents(cfg, LONG_NB_VEC, 1, SEED, dev)
    unsharded_fn = generate_mod.synthesize_fn(cfg, stage)
    ref = unsharded_fn(gen, z)[0]
    _, waves64 = float64_synthesis(cfg, dev, z)
    ref64 = waves64[0].cpu()
    err_ref64 = (ref.cpu().double() - ref64).abs().max().item()
    rec = {"launches": {k: 0 for k in (*WRAPPERS, IDFT)}, "shards": {}, "halo_columns": latent_halo(stage),
           "unsharded_ms": warm_ms(lambda: unsharded_fn(gen, z), LONG_TIMED), "unsharded_err_float64": err_ref64,
           "unsharded_rel_l2_float64": rel_l2(ref.cpu().double(), ref64)}
    for n in LONG_SHARDS:
        fn = sharded_synthesize_fn(Mesh((dev,) * n), cfg, stage)
        reset_launches()
        pieces = fn(gen, z)
        got = read_launches()
        want = expected_longclip_launches(stage, n)
        if got != want:
            raise AssertionError(f"the long clip on {n} shards launched {got}, the formula gives {want}")
        for k in rec["launches"]:
            rec["launches"][k] += got[k]
        if len(pieces) != n or any(p.device != dev for p in pieces):
            raise AssertionError(f"{len(pieces)} pieces on {[str(p.device) for p in pieces]}")
        joined = join_pieces(pieces)
        if joined.shape != ref.shape or not torch.isfinite(joined).all():
            raise AssertionError(f"the sharded waveform is {tuple(joined.shape)}, unsharded {tuple(ref.shape)}")
        err = (joined - ref.cpu()).abs().max().item()
        err64 = (joined.double() - ref64).abs().max().item()
        ms = warm_ms(lambda: fn(gen, z), LONG_TIMED)
        rec["shards"][n] = {"err_unsharded": err, "err_float64": err64, "ms": ms, "launches": got,
                            "rel_l2_unsharded": rel_l2(joined, ref.cpu()),
                            "rel_l2_float64": rel_l2(joined.double(), ref64)}
        pinned = joined  # the last: LONG_SHARDS[-1] shards under cfg's impl
        say(f"[longclip] {n} shards of cuda:0, nb_vec {LONG_NB_VEC} ({joined.numel() / 44100:.1f} s of audio), "
            f"halo {latent_halo(stage)} latent columns, {VOCODER_HALO[0]} / {VOCODER_HALO[1]} spectrum frames: "
            f"against unsharded "
            f"{err:.3e} (tol {TOL_LONGCLIP:.0e}; relative 2-norm {rec['shards'][n]['rel_l2_unsharded']:.3e}), "
            f"against float64 {err64:.3e} (unsharded's {err_ref64:.3e}; relative 2-norms to float64: sharded "
            f"{rec['shards'][n]['rel_l2_float64']:.3e}, unsharded {rec['unsharded_rel_l2_float64']:.3e}); "
            f"warm {ms:.3f} ms (unsharded {rec['unsharded_ms']:.3f}); launches {got}")
        if not err <= TOL_LONGCLIP:
            raise AssertionError(f"the long clip on {n} shards is {err:.3e} from unsharded")

    # "auto" with shards: resolved once a clip among the float32 impls (JAX's
    # clip is float32 throughout), under the widest shard's latent; every
    # shard runs it.
    seeded = os.environ["MUSICGAN_AUTOTUNE_DIR"]
    use_autotune_dir(tempfile.mkdtemp(prefix="chip_smoke_longclip_auto_"))
    n = LONG_SHARDS[-1]
    auto = dataclasses.replace(cfg, conv_impl="auto")
    served, forward = [], Generator.forward_nchw

    def spy(self, x, stage_, alpha=1.0, impl=None, **kw):
        if self is gen:  # the clip's shards, not the autotuner's own generator
            served.append(impl)
        return forward(self, x, stage_, alpha, impl, **kw)

    t0 = time.perf_counter()
    with mock.patch.object(Generator, "forward_nchw", spy):
        joined = join_pieces(sharded_synthesize_fn(Mesh((dev,) * n), auto, stage)(gen, z))
    auto_s = time.perf_counter() - t0
    table = autotune._load_persisted()
    use_autotune_dir(seeded)
    if joined.shape != ref.shape or not torch.isfinite(joined).all():
        raise AssertionError("the long clip under auto is not a finite waveform of the clip's length")
    rec["auto"] = {"table": table, "s": auto_s, "rel_l2_float32": rel_l2(joined, ref.cpu()), "served": served,
                   "err_float32": (joined - ref.cpu()).abs().max().item(),
                   "equal_pinned": bool(torch.equal(joined, pinned)) if served[:1] == [cfg.conv_impl] else None}
    say(f"[longclip] under auto on {n} shards: measured and resolved in {auto_s:.2f} s, "
        + ", ".join(f"{k.split('|')[2]}|{k.split('|')[3]} -> {v}" for k, v in sorted(table.items()))
        + f"; shards served by {served}; the waveform {rec['auto']['err_float32']:.3e} from the float32 "
        f"unsharded one (max abs, tol {TOL_LONGCLIP_AUTO:.0e}; relative 2-norm {rec['auto']['rel_l2_float32']:.3e}, "
        f"the {cfg.conv_impl} clip on {n} shards' {rec['shards'][n]['rel_l2_unsharded']:.3e}); bit for bit that "
        f"clip where the impl is its: {rec['auto']['equal_pinned']}")
    if len(served) != n or len(set(served)) != 1 or served[0] not in autotune.FLOAT32_IMPLS:
        raise AssertionError(f"the long clip under auto ran {served} on its {n} shards: not one float32 impl")
    if not rec["auto"]["err_float32"] <= TOL_LONGCLIP_AUTO or rec["auto"]["equal_pinned"] is False:
        raise AssertionError(f"the long clip under auto is {rec['auto']['err_float32']:.3e} from float32, "
                             f"bit for bit the {cfg.conv_impl} clip: {rec['auto']['equal_pinned']}")
    del gen
    return rec


def longclip_serving(cfg: ModelConfig, dev, say) -> dict:
    """Phase 13 (b): the service over a mesh of 4 shards of the card: a solo
    nb_vec 16 request takes the long-clip route (its signature, its samples
    bit for bit ``sharded_synthesize_fn``'s, K1 32, K3 32, K5 4); three
    concurrent nb_vec 4 requests are one batch and do not."""
    from musicgan_tpu_torch.parallel import Mesh
    from musicgan_tpu_torch.parallel.longclip import join_pieces, sharded_synthesize_fn

    stage, n = cfg.n_stages - 1, 4
    gen = load_reference_generator(str(CKPT), cfg, device=dev)
    svc = SynthesisService(gen, window_ms=200.0, mesh=Mesh((dev,) * n), device=dev)
    launches = {k: 0 for k in (*WRAPPERS, IDFT)}
    try:
        reset_launches()
        t0 = time.perf_counter()
        wave = svc.submit(seed=SEED + 1, nb_vec=LONG_NB_VEC).result(timeout=300)
        solo_ms = 1e3 * (time.perf_counter() - t0)
        solo = read_launches()
        want = expected_longclip_launches(stage, n)
        sig = f"stage{stage}/nb_vec{LONG_NB_VEC}/longclip{n}"
        if solo != want or sig not in svc.stats_snapshot()["signatures"]:
            raise AssertionError(f"the solo request launched {solo} ({want} wanted), "
                                 f"signatures {svc.stats_snapshot()['signatures']}")
        z = generate_mod.latents(cfg, LONG_NB_VEC, 1, SEED + 1, dev)
        again = join_pieces(sharded_synthesize_fn(Mesh((dev,) * n), cfg, stage)(gen, z))
        if not torch.equal(wave, again):
            raise AssertionError("the long-clip route's samples are not sharded_synthesize_fn's")
        before = list(svc.stats_snapshot()["signatures"])
        reset_launches()
        futs = [svc.submit(seed=s, nb_vec=4) for s in range(3)]
        waves = [f.result(timeout=300) for f in futs]
        batched = read_launches()
        new = [s for s in svc.stats_snapshot()["signatures"] if s not in before]
        want_b = {k: 0 for k in (*WRAPPERS, IDFT)}
        want_b.update(fused_conv3x3=stage + 1, fused_upconv3x3=stage + 1, istft_fused=1)
        if new != [f"stage{stage}/nb_vec4/b4"] or batched != want_b or not all(torch.isfinite(w).all() for w in waves):
            raise AssertionError(f"three nb_vec 4 requests: signatures {new}, launches {batched}")
        for got in (solo, batched):
            for k in launches:
                launches[k] += got[k]
    finally:
        svc.close()
    say(f"[longclip] the service over {n} shards: a solo nb_vec {LONG_NB_VEC} request took the route ({sig}, "
        f"{solo_ms:.1f} ms submit to samples on the host, the 200 ms window included), bit for bit "
        f"sharded_synthesize_fn, launches {solo}; three concurrent nb_vec 4 requests one batch ({new[0]}), "
        f"launches {batched}")
    del gen
    return {"solo_ms": solo_ms, "solo_launches": solo, "batch_launches": batched, "launches": launches}


def dp_batch(dev) -> torch.Tensor:
    """The data-parallel step's global batch, seeded on the card."""
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    return torch.randn((DP_BATCH, 2, 512, 512), generator=g, device=dev)


def state_sha(state) -> str:
    """A hash of every tensor of a train state, the random generator's state
    included."""
    import hashlib

    h = hashlib.sha256()
    trees = [state.gen.state_dict(), state.disc.state_dict(), *state.opt_gen, *state.opt_disc]
    for tree in trees:
        for k in sorted(tree):
            h.update(k.encode())
            h.update(tree[k].detach().cpu().contiguous().numpy().tobytes())
    h.update(state.rng.get_state().numpy().tobytes())
    h.update(state.iter_idx.cpu().numpy().tobytes())
    return h.hexdigest()


def dp_rank(argv: list[str]) -> None:
    """``python3 chip_smoke.py --dp-rank COORD RANK WORK``: one rank of the
    two-process data-parallel step on the card (both ranks on cuda:0, so
    gloo by the backend rule): from ``init_train_state(SEED)``, one D-only
    and one D+G iteration at stage 7 on this rank's 3 rows of the global
    batch, each counted and hashed; then warm D-only iterations timed, and
    one with its all_reduces timed.  Results in WORK/rank_{r}.json; rank 0
    also saves the state after the two compared iterations."""
    from musicgan_tpu_torch.parallel import mesh as pmesh
    from musicgan_tpu_torch.train import step as step_mod

    coord, rank, work = argv[0], int(argv[1]), argv[2]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pmesh.initialize_distributed(coord, 2, rank, timeout_s=DP_TIMEOUT_S)
    dev, group = pmesh.process_device(), pmesh.process_group()
    cfg = ModelConfig(conv_impl="pallas_gp")
    tcfg = TrainConfig(batch_size=DP_BATCH)
    state = init_train_state(SEED, cfg, tcfg, device=dev)
    b = DP_BATCH // group.world
    x = dp_batch(dev)[rank * b : (rank + 1) * b].contiguous()
    rec = {"backend": pmesh.backend(), "device": str(dev), "hash": [], "launches": [], "metrics": []}
    for with_gen in (False, True):
        step = build_step(TRAIN_STAGE, with_gen, cfg, tcfg, mesh=group, device=dev)
        reset_launches()
        state, metrics = step(state, x, TRAIN_ALPHA)
        torch.cuda.synchronize()
        rec["launches"].append(read_launches())
        rec["metrics"].append(metrics_floats(metrics))
        rec["hash"].append(state_sha(state))
    if rank == 0:
        CheckpointManager(os.path.join(work, "dp")).save(0, state, {})
    step = build_step(TRAIN_STAGE, False, cfg, tcfg, mesh=group, device=dev)
    rec["iteration_ms"] = [1e3 * t for t in timed_iterations(step, state, x, DP_TIMED)]
    real, calls = step_mod.all_reduce_sum, []

    def timed(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t)
        torch.cuda.synchronize()
        calls.append((1e3 * (time.perf_counter() - t0), t.numel() * t.element_size()))
        return out

    step_mod.all_reduce_sum = timed
    step(state, x, TRAIN_ALPHA)
    step_mod.all_reduce_sum = real
    rec["all_reduce"] = [{"ms": ms, "bytes": nbytes} for ms, nbytes in calls]
    with open(os.path.join(work, f"rank_{rank}.json"), "w") as f:
        json.dump(rec, f)
    pmesh.host_barrier()
    pmesh.shutdown_distributed()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_all(procs, timeout: float) -> list[str]:
    """Each process's output once it has exited (killed past ``timeout``)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def data_parallel_step(dev, say, work: str) -> dict:
    """Phase 13 (c): two ranks of the data-parallel step on the card over
    gloo against the one-process step from the same state, batch and noise;
    then one iteration in a one-rank NCCL group against the step without a
    group."""
    from musicgan_tpu_torch.parallel import Group
    from musicgan_tpu_torch.parallel import mesh as pmesh

    cfg = ModelConfig(conv_impl="pallas_gp")
    tcfg = TrainConfig(batch_size=DP_BATCH)
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), DP_RANK_FLAG, coord, str(r), work],
                              cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = wait_all(procs, DP_TIMEOUT_S)
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"a data-parallel rank exited {p.returncode}:\n{o[-4000:]}")
    ranks = [json.load(open(os.path.join(work, f"rank_{r}.json"))) for r in range(2)]
    if "[dist] backend gloo (2 processes, 1 cards)" not in outs[0] or {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError(f"the two ranks on one card did not take gloo:\n{outs[0][-2000:]}")
    if ranks[0]["hash"] != ranks[1]["hash"]:
        raise AssertionError("the two ranks' states differ after a step")

    # The one-process step from the same state, batch and noise.
    x = dp_batch(dev)
    start = init_train_state(SEED, cfg, tcfg, device=dev)
    one = start.clone()
    one_metrics = []
    for with_gen in (False, True):
        one, m = build_step(TRAIN_STAGE, with_gen, cfg, tcfg, device=dev)(one, x, TRAIN_ALPHA)
        one_metrics.append(metrics_floats(m))
    dp = CheckpointManager(os.path.join(work, "dp")).restore(0, init_train_state(0, cfg, tcfg, device=dev))[0]
    deltas = {}
    for net, bar in (("gen", TOL_BACKWARD_L2), ("disc", TOL_CRITIC_ITERATION_L2)):
        p0, p1, pd = (dict(getattr(s, net).named_parameters()) for s in (start, one, dp))
        d1 = torch.cat([(p1[k] - p0[k]).detach().flatten() for k in p0])
        dd = torch.cat([(pd[k] - p0[k]).detach().flatten() for k in p0])
        deltas[net] = rel_l2(dd, d1)
        if not deltas[net] <= bar:
            raise AssertionError(f"the data-parallel {net} update is {deltas[net]:.3e} from one process's")
    for got, ref in zip(ranks[0]["metrics"], one_metrics):
        for k, v in ref.items():
            if not abs(got[k] - v) <= TOL_METRIC_ABS + TOL_METRIC_REL * abs(v):
                raise AssertionError(f"metric {k}: two ranks {got[k]}, one process {v}")
    want = [expected_train_launches(cfg, TRAIN_STAGE, 1, 0), expected_train_launches(cfg, TRAIN_STAGE, 0, 1)]
    for r in ranks:
        if r["launches"] != want:
            raise AssertionError(f"a rank launched {r['launches']}, the formula gives {want}")
    reduce = ranks[0]["all_reduce"]
    say(f"[dp] two ranks on cuda:0 over gloo, global batch {DP_BATCH} (3 a rank), stage 7, pallas_gp: states "
        f"bit for bit equal after each step ({ranks[0]['hash'][-1][:12]}); updates against one process "
        f"(relative 2-norm) generator {deltas['gen']:.3e} (tol {TOL_BACKWARD_L2:.0e}), critic {deltas['disc']:.3e} "
        f"(tol {TOL_CRITIC_ITERATION_L2:.0e}); metrics within rel {TOL_METRIC_REL:.0e} / abs {TOL_METRIC_ABS:.0e}; "
        f"launches a rank {ranks[0]['launches']}")
    say(f"[dp] a D-only iteration, warm, ms: rank 0 {ranks[0]['iteration_ms']}, rank 1 {ranks[1]['iteration_ms']}; "
        f"its all_reduces: " + ", ".join(f"{c['bytes']} B in {c['ms']:.3f} ms" for c in reduce))
    rec = {"deltas_rel_l2": deltas, "ranks": ranks, "launches": {k: 0 for k in (*WRAPPERS, IDFT)}}
    for r in ranks:
        for got in r["launches"]:
            for k in rec["launches"]:
                rec["launches"][k] += got[k]

    # A one-rank group on the card: NCCL by the rule, its collectives run.
    pmesh.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, timeout_s=DP_TIMEOUT_S)
    try:
        if pmesh.backend() != "nccl":
            raise AssertionError(f"one rank on one card took {pmesh.backend()}, not nccl")
        a, b = start.clone(), start.clone()
        reset_launches()
        a, ma = build_step(TRAIN_STAGE, True, cfg, tcfg, mesh=Group(1, 0), device=dev)(a, x, TRAIN_ALPHA)
        torch.cuda.synchronize()
        nccl = read_launches()
        b, mb = build_step(TRAIN_STAGE, True, cfg, tcfg, device=dev)(b, x, TRAIN_ALPHA)
        if state_sha(a) != state_sha(b) or metrics_floats(ma) != metrics_floats(mb):
            raise AssertionError("the one-rank NCCL iteration differs from the step without a group")
        if nccl != expected_train_launches(cfg, TRAIN_STAGE, 0, 1):
            raise AssertionError(f"the one-rank NCCL iteration launched {nccl}")
    finally:
        pmesh.shutdown_distributed()
    for k in rec["launches"]:
        rec["launches"][k] += nccl[k]
    say(f"[dp] one D+G iteration in a one-rank NCCL group: bit for bit the step without a group; launches {nccl}")
    return rec


def seed_train_table(path: str, dev, stages) -> None:
    """A fresh table with ``pallas_gp`` at the float32 train keys of batch
    ``DP_BATCH`` at ``stages``: the other stages are measured."""
    backend = autotune._backend(dev)
    table = {autotune._candidates_and_key(backend, (DP_BATCH, 2, 2, 32), s, True,
                                          TrainConfig(batch_size=DP_BATCH))[1]: "pallas_gp" for s in stages}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "conv_autotune.json"), "w") as f:
        json.dump(table, f)


def cli_two_ranks(dev, say, work: str) -> dict:
    """Phase 13 (d): ``python -m musicgan_tpu_torch train --coordinator
    127.0.0.1:P --num-processes 2 --process-id {0,1}`` (through this script's
    cut-schedule wrapper), both ranks on the card: through the eight stages;
    the lead measures stage 7's train impls and rank 1 takes its winner;
    only the lead writes.  Then a run stopped by SIGTERM to rank 1 (both exit
    75 with a flushed save) and resumed equals the uninterrupted one bit for
    bit."""
    ds = os.path.join(work, "ds")
    writer = ShardWriter(ds, samples_per_shard=8)
    writer.add(torch.randn(LOOP_SAMPLES, 2, 512, 512, generator=torch.Generator().manual_seed(SEED)).numpy())
    writer.close()
    table = os.path.join(work, "table")
    seed_train_table(table, dev, range(TRAIN_STAGE))
    env = {**os.environ, "MUSICGAN_AUTOTUNE_DIR": table}

    def start(out: str, *extra: str):
        coord = f"127.0.0.1:{free_port()}"
        return [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), CUT_SCHEDULE_FLAG, "train", "dp", "-i", ds, "-o", out,
             "--batch-size", str(DP_BATCH), "--save-every", str(LOOP_CFG["save_every"]),
             "--log-every", str(LOOP_CFG["log_every"]), "--chunk-steps", str(LOOP_CFG["chunk_steps"]),
             "--coordinator", coord, "--num-processes", "2", "--process-id", str(r), *extra],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]

    def final_save(out: str) -> dict:
        ck = CheckpointManager(os.path.join(out, "checkpoints"))
        for i in reversed(ck.saved_indices()):
            with open(os.path.join(out, "checkpoints", f"save_{i}", "meta.json")) as f:
                if json.load(f)["iter_idx"] == LOOP_ITERS:
                    return torch.load(os.path.join(out, "checkpoints", f"save_{i}", "state.pt"), weights_only=True)
        raise AssertionError(f"{out} has no save at iteration {LOOP_ITERS}")

    out_a = os.path.join(work, "uninterrupted")
    t0 = time.perf_counter()
    procs = start(out_a, "--max-iters", str(LOOP_ITERS))
    outs = wait_all(procs, DP_TIMEOUT_S)
    wall_a = time.perf_counter() - t0
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"a train rank exited {p.returncode}:\n{o[-4000:]}")
    lead = re.findall(r"\[autotune\] train conv_impl \(stage 7\) -> (\w+) .*measured in ([0-9.]+) s", outs[0])
    other = re.findall(r"\[autotune\] train conv_impl \(stage 7\) -> (\w+)  \(process 0's; measured in 0.00 s\)",
                       outs[1])
    if len(lead) != 1 or other != [lead[0][0]]:
        raise AssertionError(f"stage 7's winner: lead {lead}, rank 1 {other}")
    if "[train:dp]" not in outs[0] or any(s in outs[1] for s in ("[train:dp]", "[saver]", "[grow]", "e000 it")):
        raise AssertionError(f"rank 1 wrote what only the lead writes:\n{outs[1][-2000:]}")
    saves = CheckpointManager(os.path.join(out_a, "checkpoints")).saved_indices()
    if saves != list(range(LOOP_ITERS // LOOP_CFG["save_every"])):
        raise AssertionError(f"the uninterrupted run saved {saves}")

    out_b = os.path.join(work, "stopped")
    procs = start(out_b, "--max-iters", str(LOOP_ITERS))
    deadline = time.time() + DP_TIMEOUT_S
    csv_path = os.path.join(out_b, "metrics.csv")
    while time.time() < deadline:  # a row at iterations 0, 4 and 8: past two stages
        if os.path.exists(csv_path) and len(open(csv_path).read().splitlines()) >= 4:
            break
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.1)
    procs[1].send_signal(signal.SIGTERM)
    outs_b = wait_all(procs, DP_TIMEOUT_S)
    if [p.returncode for p in procs] != [EXIT_STALLED] * 2:
        raise AssertionError(f"SIGTERM to rank 1: exits {[p.returncode for p in procs]}\n{outs_b[0][-3000:]}")
    ck = CheckpointManager(os.path.join(out_b, "checkpoints"))
    last = ck.saved_indices()[-1]
    with open(os.path.join(out_b, "checkpoints", f"save_{last}", "meta.json")) as f:
        stopped_at = json.load(f)["iter_idx"]
    procs = start(out_b, "--max-iters", str(LOOP_ITERS), "--resume")
    outs_c = wait_all(procs, DP_TIMEOUT_S)
    for p, o in zip(procs, outs_c):
        if p.returncode != 0:
            raise AssertionError(f"a resumed rank exited {p.returncode}:\n{o[-4000:]}")
    a, b = final_save(out_a), final_save(out_b)
    exact = all(torch.equal(a[k][j], b[k][j]) for k in ("gen", "disc") for j in a[k]) and all(
        torch.equal(a[o][f][j], b[o][f][j]) for o in ("opt_gen", "opt_disc") for f in a[o] for j in a[o][f]
    ) and torch.equal(a["rng_state"], b["rng_state"])
    if not exact:
        raise AssertionError("the stopped and resumed two-process run differs from the uninterrupted one")
    say(f"[dp-cli] train --coordinator / --num-processes 2 / --process-id: {LOOP_ITERS} iterations through 8 stages "
        f"in {wall_a:.1f} s (two processes on cuda:0), stage 7 measured by rank 0 in {lead[0][1]} s -> "
        f"{lead[0][0]}, rank 1 took it (0 s); only rank 0 wrote (saves {saves}); SIGTERM to rank 1: both exit 75, "
        f"save_{last} flushed at iteration {stopped_at}; --resume to {LOOP_ITERS}: bit for bit the uninterrupted run")
    return {"wall_s": wall_a, "winner": lead[0][0], "measure_s": float(lead[0][1]), "stopped_at": stopped_at}


def parallel_phase(cfg: ModelConfig, dev, card: str) -> dict:
    """Phase 13 (see the module's docstring)."""
    def say(line: str) -> None:
        print(f"{line} ({card})")

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    dev0 = torch.device("cuda", torch.cuda.current_device())
    rec = {"longclip": longclip(cfg, dev0, say)}
    torch.cuda.empty_cache()
    rec["serving"] = longclip_serving(cfg, dev0, say)
    torch.cuda.empty_cache()
    rec["dp"] = data_parallel_step(dev0, say, work)
    torch.cuda.empty_cache()
    rec["cli"] = cli_two_ranks(dev0, say, work)
    rec["launches"] = {k: sum(rec[p]["launches"][k] for p in ("longclip", "serving", "dp")) for k in (*WRAPPERS, IDFT)}
    rec["phase_s"] = time.perf_counter() - t_phase
    say(f"[parallel] launches in phase 13 (in this process and the two step ranks): {rec['launches']}; "
        f"the phase took {rec['phase_s']:.1f} s")
    return rec


# ---- Phase 14: the mixed-dtype calls of K1-K4 (the JAX functions' bf16 x
# with out_dtype=float32, float32 x with out_dtype=bfloat16).  No path of
# the model makes one (the generator passes its compute dtype, as the JAX
# generator does), so phases 1-13 each show 0 mixed launches, and this
# phase drives every mixed kernel once at the shapes the main path gives
# its same-dtype kernel, counted, then holds each against its plain version
# and its same-dtype kernel and times it.

MIXED_SOURCES = {
    "fused_conv3x3_bf16_f32": ("musicgan_tpu_torch/csrc/conv3x3_bf16_f32.cu", "musicgan_tpu/ops/conv.py:90"),
    "fused_conv3x3_f32_bf16": ("musicgan_tpu_torch/csrc/conv3x3_f32_bf16.cu", "musicgan_tpu/ops/conv.py:90"),
    "fused_upconv3x3_bf16_f32": ("musicgan_tpu_torch/csrc/upconv3x3_bf16_f32.cu", "musicgan_tpu/ops/conv.py:139"),
    "fused_upconv3x3_f32_bf16": ("musicgan_tpu_torch/csrc/upconv3x3_f32_bf16.cu", "musicgan_tpu/ops/conv.py:139"),
    "fused_block_bf16_f32": ("musicgan_tpu_torch/csrc/block3x3_bf16_f32.cu", "musicgan_tpu/ops/conv.py:234"),
    "fused_block_bf16_f32_wide": ("musicgan_tpu_torch/csrc/block3x3_bf16_wide_f32.cu", "musicgan_tpu/ops/conv.py:234"),
    "fused_block_bf16_f32_template": ("musicgan_tpu_torch/csrc/block3x3_bf16_template_f32.cu",
                                      "musicgan_tpu/ops/conv.py:234"),
    "fused_block_f32_bf16": ("musicgan_tpu_torch/csrc/block3x3_f32_bf16.cu", "musicgan_tpu/ops/conv.py:234"),
    "fused_conv3x3_msq_bf16": ("musicgan_tpu_torch/csrc/conv3x3_bf16_f32.cu", "musicgan_tpu/ops/conv.py:625"),
}
MIXED_WRAPPERS = (conv_ops.fused_conv3x3, conv_ops.fused_conv3x3_msq, conv_ops.fused_upconv3x3, conv_ops.fused_block)
# A float32-in, bf16-out kernel against its plain version (float32 rounded
# once): the float32 kernel's own bar (TOL) plus one bf16 ulp, the most two
# float32 values that far apart can differ by once rounded.


def mixed_launches() -> int:
    return sum(fn.mixed_launches for fn in MIXED_WRAPPERS)


def assert_no_mixed(phase: str) -> None:
    """No call of phases 1-13 (synthesis, training, serving, ...) was a
    mixed-dtype one: the counts are never reset before phase 14."""
    n = mixed_launches()
    if n:
        raise AssertionError(f"{phase}: {n} mixed-dtype launches; every call of a path keeps x's dtype")
    print(f"[mixed]  {phase}: 0 mixed-dtype launches")


def mixed_cases(cfg: ModelConfig, gen, dev):
    """Every row of phase 14, in the order driven: ``(key, shape, make)``,
    ``make()`` the row's tensors and callables (made anew from one seed on
    each pass).  K1 and K3 in both directions at the 8 synthesis blocks (5
    clips x nb_vec 10, the shipped generator's weights); K4 in both at
    blocks 4-7 and at ``WIDE_BLOCK``, and bf16 -> float32 at
    ``TEMPLATE_BLOCK`` (K4 bf16's template tier); K2 with bf16 x at the 16 generator
    convs of a stage-7 train step at batch 6."""
    slope, eps, bf, f32 = cfg.leaky_slope, cfg.pixel_norm_eps, torch.bfloat16, torch.float32
    rng = torch.Generator(device=dev).manual_seed(14)

    def block_weights(i):
        blk = gen.blocks[i]
        return (blk.conv1.weight.detach(), blk.conv1.bias.detach(), blk.conv2.weight.detach(),
                blk.conv2.bias.detach())

    for i, (cin, cout) in enumerate(cfg.gen_channels):
        bsz, h, w = block_sizes(cfg, i)
        px = bsz * h * w
        for kind, co, flops in (("conv3x3", cin, 2.0 * px * cin * 9 * cin), ("upconv3x3", cout, 32.0 * px * cout * cin)):
            up = kind == "upconv3x3"
            taps = 16 if up else 9
            out_px = 4 * px if up else px
            for pair in ("bf16_f32", "f32_bf16"):
                def make(i=i, cin=cin, co=co, up=up, pair=pair, flops=flops, taps=taps, px=px, out_px=out_px, h=h,
                         w=w, bsz=bsz, kind=kind):
                    xin = bf if pair == "bf16_f32" else f32
                    out, same = (f32, bf) if pair == "bf16_f32" else (bf, f32)
                    w1, b1, w2, b2 = block_weights(i)
                    wt, bb = (w2, b2) if up else (w1, b1)
                    x = torch.randn(bsz, cin, h, w, generator=rng, device=dev).to(xin)
                    wp = (conv_ops.kernel_weights_tc(wt, up) if xin == bf
                          else (conv_ops.kernel_upconv_weights(wt) if up else conv_ops.kernel_weights(wt)))
                    fn = conv_ops.fused_upconv3x3 if up else conv_ops.fused_conv3x3
                    plain = conv_ops.upconv3x3_plain if up else conv_ops.conv3x3_plain
                    xl = upsample_nearest_2x(x) if up else x
                    wl, bl = (wt.to(bf), bb.to(bf)) if xin == bf else (wt, bb)
                    isz, osz = (2, 4) if xin == bf else (4, 2)
                    return dict(
                        kernel=lambda: fn(x, wt, bb, slope, True, eps, w_packed=wp, out_dtype=out),
                        same=lambda: fn(x, wt, bb, slope, True, eps, w_packed=wp, out_dtype=same),
                        plain=lambda: plain(x, wt, bb, slope, True, eps, out_dtype=out),
                        library=lambda: F.conv2d(xl, wl, bl, padding=1),
                        flops=flops, nbytes=isz * (px * cin + taps * cin * co) + osz * out_px * co + 4.0 * co,
                        route=None if xin == bf else conv_ops.conv_plan(kind, bsz, cin, co, h, w, True)["route"],
                        in_dtype=xin, out_dtype=out, tol="fused_upconv3x3" if up else "fused_conv3x3",
                    )
                yield f"fused_{kind}_{pair}", (bsz, cin, co, h, w), make

    # (block, B, H, W, cin, cmid, cout): blocks 4-7, then WIDE_BLOCK (block
    # None), then in bf16 -> float32 TEMPLATE_BLOCK (block "template", K4
    # bf16's template tier).
    blocks = [(i, *block_sizes(cfg, i), cfg.gen_channels[i][0], *cfg.gen_channels[i]) for i in (4, 5, 6, 7)]
    bsz, cin, cmid, cout, h, w = WIDE_BLOCK
    blocks.append((None, bsz, h, w, cin, cmid, cout))
    bsz, cin, cmid, cout, h, w = TEMPLATE_BLOCK
    blocks.append(("template", bsz, h, w, cin, cmid, cout))
    for pair in ("bf16_f32", "f32_bf16"):
        for i, bsz, h, w, cin, cmid, cout in blocks:
            wide = i is None or i == "template"
            if i == "template" and pair != "bf16_f32":
                continue
            key = f"fused_block_{pair}" + ({None: "_wide", "template": "_template"}.get(i, "")
                                           if pair == "bf16_f32" else "")

            def make(i=i, bsz=bsz, h=h, w=w, cin=cin, cmid=cmid, cout=cout, pair=pair, wide=wide):
                xin = bf if pair == "bf16_f32" else f32
                out, same = (f32, bf) if pair == "bf16_f32" else (bf, f32)
                if wide:
                    w1 = torch.randn(cmid, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
                    b1 = torch.randn(cmid, generator=rng, device=dev) * 0.1
                    w2 = torch.randn(cout, cmid, 3, 3, generator=rng, device=dev) / (9 * cmid) ** 0.5
                    b2 = torch.randn(cout, generator=rng, device=dev) * 0.1
                else:
                    w1, b1, w2, b2 = block_weights(i)
                x = torch.randn(bsz, cin, h, w, generator=rng, device=dev).to(xin)
                if wide and xin == f32:
                    w1p = w2p = None
                elif i == "template":  # block3x3.cuh at bf16 reads the kernel layout
                    w1p, w2p = conv_ops.kernel_weights(w1, bf), conv_ops.kernel_upconv_weights(w2, bf)
                elif xin == bf:
                    w1p, w2p = conv_ops.kernel_weights_tc(w1), conv_ops.kernel_weights_tc(w2, True)
                else:
                    w1p, w2p = conv_ops.kernel_weights(w1), conv_ops.kernel_upconv_weights(w2)
                wl = [t.to(bf) for t in (w1, b1, w2, b2)] if xin == bf else [w1, b1, w2, b2]
                mid_up = upsample_nearest_2x(conv_ops.conv3x3_plain(x, w1, b1, slope, True, eps))
                px = bsz * h * w
                isz, osz = (2, 4) if xin == bf else (4, 2)

                def library():  # the two convolutions alone
                    F.conv2d(x, wl[0], wl[1], padding=1)
                    return F.conv2d(mid_up, wl[2], wl[3], padding=1)

                def pair_fn():  # K1 in x's dtype, then K3 with the call's output dtype
                    mid = conv_ops.fused_conv3x3(x, w1, b1, slope, True, eps, out_dtype=xin)
                    return conv_ops.fused_upconv3x3(mid, w2, b2, slope, True, eps, out_dtype=out)

                return dict(
                    kernel=lambda: conv_ops.fused_block(x, w1, b1, w2, b2, slope, eps, w1_packed=w1p, w2_packed=w2p,
                                                        out_dtype=out),
                    same=lambda: conv_ops.fused_block(x, w1, b1, w2, b2, slope, eps, w1_packed=w1p, w2_packed=w2p,
                                                      out_dtype=same),
                    plain=lambda: conv_ops.fused_block_plain(x, w1, b1, w2, b2, slope, eps, out_dtype=out),
                    library=library, pair=pair_fn,
                    flops=2.0 * px * cmid * 9 * cin + 32.0 * px * cout * cmid,
                    nbytes=isz * (px * cin + 9 * cin * cmid + 16 * cmid * cout) + osz * 4 * px * cout
                    + 4.0 * (cmid + cout),
                    route=None if xin == bf else "large_tc", in_dtype=xin, out_dtype=out, tol="fused_block",
                    wide=wide, block=i,
                )
            yield key, (bsz, cin, cmid, cout, h, w), make

    gen_shapes, _ = train_conv_shapes(cfg, TrainConfig().batch_size, TRAIN_STAGE)
    for bsz, cin, cout, h, w in gen_shapes:
        def make(bsz=bsz, cin=cin, cout=cout, h=h, w=w):
            x = torch.randn(bsz, cin, h, w, generator=rng, device=dev).to(bf)
            wt = torch.randn(cout, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
            bb = torch.randn(cout, generator=rng, device=dev) * 0.1
            wp = conv_ops.kernel_weights_tc(wt)
            wl, bl = wt.to(bf), bb.to(bf)
            px = bsz * h * w
            return dict(
                kernel=lambda: conv_ops.fused_conv3x3_msq(x, wt, bb, slope, 1e-8, w_packed=wp),
                same=lambda: conv_ops.fused_conv3x3(x, wt, bb, slope, True, 1e-8, w_packed=wp, out_dtype=bf),
                plain=lambda: conv_ops.conv3x3_msq_plain(x, wt, bb, slope, 1e-8),
                library=lambda: F.conv2d(x, wl, bl, padding=1),
                flops=2.0 * px * cout * 9 * cin, nbytes=2.0 * (px * cin + 9 * cin * cout) + 4.0 * (px * cout + px + cout),
                route=None, in_dtype=bf, out_dtype=torch.float32, tol="fused_conv3x3_msq",
            )
        yield "fused_conv3x3_msq_bf16", (bsz, cin, cout, h, w), make


def mixed_row(key: str, shape, c: dict) -> dict:
    """One mixed kernel at one shape: held against its plain version and
    its same-dtype kernel (the invariants below), then timed."""
    got = c["kernel"]()
    y, m = got if isinstance(got, tuple) else (got, None)
    ref = c["plain"]()
    y_ref, m_ref = ref if isinstance(ref, tuple) else (ref, None)
    if y.dtype != c["out_dtype"] or y.shape != y_ref.shape or not torch.isfinite(y.float()).all():
        raise AssertionError(f"{key} {shape}: {y.dtype} {tuple(y.shape)}, finite {bool(torch.isfinite(y.float()).all())}")
    a, b = y.float(), y_ref.float()
    err = (a - b).abs().max().item()
    pair = "->".join(str(d).removeprefix("torch.") for d in (c["in_dtype"], c["out_dtype"]))
    row = {"name": key, "shape": shape, "pair": pair, "max_abs_err": err,
           "l2_err": rel_l2(a, b)}
    same = c["same"]()
    if c["out_dtype"] == torch.bfloat16:
        # float32 in, bf16 out: the float32 kernel's bits rounded once (the
        # same plan, the same sums), and within the float32 bar plus one
        # bf16 ulp of the plain version.
        row["equal_same_rounded"] = bool(torch.equal(y, same.to(torch.bfloat16)))
        past = int(((a - b).abs() > BF16_ULP * torch.maximum(a.abs(), b.abs()) + TOL[c["tol"]]).sum())
        row["past_bar"] = past
        if past or not row["equal_same_rounded"]:
            raise AssertionError(f"{key} {shape}: {past} past the bar of the plain version, bits of the float32 "
                                 f"kernel rounded: {row['equal_same_rounded']}")
    else:
        # bf16 in, float32 out: stored unrounded (values bf16 cannot hold),
        # its rounding the bf16 kernel's bits.
        row["equal_same_rounded"] = bool(torch.equal(y.to(torch.bfloat16), same))
        row["not_bf16"] = int((a != y.to(torch.bfloat16).float()).sum())
        if not row["equal_same_rounded"] or row["not_bf16"] == 0:
            raise AssertionError(f"{key} {shape}: rounded to bf16 equal to the bf16 kernel's "
                                 f"{row['equal_same_rounded']}, values bf16 cannot hold {row['not_bf16']}")
        if key.startswith("fused_block"):
            # c1 is bf16: a reordered sum can flip one of its roundings, so
            # the 2-norm (phase 9's bar for K4 bf16).
            if not row["l2_err"] <= TOL_K4_BF16_L2:
                raise AssertionError(f"{key} {shape}: relative 2-norm {row['l2_err']:.3e} against the plain version")
            # Past 128 channels too (the cluster route): the pair's bits; the
            # template tier (block3x3.cuh, its own sums) within that 2-norm.
            want = c["pair"]()
            row["equal_pair"] = bool(torch.equal(y, want))
            row["l2_vs_pair"] = rel_l2(a, want)
            if not (row["equal_pair"] or key.endswith("_template") and row["l2_vs_pair"] <= TOL_K4_BF16_L2):
                raise AssertionError(f"{key} {shape}: not K1 bf16 then K3 bf16 -> float32 bit for bit "
                                     f"(2-norm {row['l2_vs_pair']:.3e})")
            del want
        elif not err <= TOL[c["tol"]]:
            raise AssertionError(f"{key} {shape}: max abs err {err:.3e} > {TOL[c['tol']]:.0e}")
    if m is not None:
        row["msq_rel_err"] = ((m - m_ref).abs().max() / m_ref.abs().max()).item()
        if not row["msq_rel_err"] <= TOL_MSQ_REL:
            raise AssertionError(f"{key} {shape}: mean-square map rel err {row['msq_rel_err']:.3e}")
    del got, ref, y, m, a, b, same
    if c["in_dtype"] == torch.bfloat16:
        t_ops = 1e3 * c["flops"] / PEAK_BF16_FLOPS
        t_bytes = 1e3 * c["nbytes"] / PEAK_BYTES_S
    else:
        t_ops, t_bytes = bound_terms(c["flops"], c["nbytes"], c["route"])
    row.update(ms=time_ms(c["kernel"]), same_ms=time_ms(c["same"]), plain_ms=time_ms(c["plain"]),
               library_ms=time_ms(c["library"]),
               bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
               ops_ms=t_ops, bytes_ms=t_bytes, flops=c["flops"], bytes=c["nbytes"], route=c["route"],
               block=c.get("block"))
    print(f"[mixed]  {key:26s} {str(shape):30s} err {err:.2e} (2-norm {row['l2_err']:.1e})  kernel {row['ms']:.4f} ms"
          f"  same-dtype kernel {row['same_ms']:.4f}  plain {row['plain_ms']:.4f}  library {row['library_ms']:.4f}"
          f"  bound {row['bound_ms']:.4f} "
          f"({row['bound_by']})  share {row['bound_ms'] / row['ms']:.2f}"
          + (f"  m rel {row['msq_rel_err']:.1e}" if "msq_rel_err" in row else ""))
    return row


def mixed_dtype(cfg: ModelConfig, dev, card: str) -> dict:
    """Phase 14: each mixed kernel driven once at each of its shapes with
    its count set to 0 just before and read just after (its launches), then
    every row checked and timed."""
    def say(line: str) -> None:
        print(f"{line}  [{card}]")

    t_phase = time.perf_counter()
    gen = load_reference_generator(str(CKPT), cfg, device=dev)
    cases = list(mixed_cases(cfg, gen, dev))
    launches, shapes = {}, {}
    for key, shape, _ in cases:
        shapes.setdefault(key, []).append(shape)
    # The drive: one call a shape, a kernel and pair at a time, counted.
    for key in shapes:
        for fn in MIXED_WRAPPERS:
            fn.mixed_launches = 0
        for k, shape, make in cases:
            if k != key:
                continue
            got = make()["kernel"]()
            y = got[0] if isinstance(got, tuple) else got
            if not torch.isfinite(y.float()).all():
                raise AssertionError(f"{key} {shape}: not finite")
            del got, y
        torch.cuda.synchronize()
        launches[key] = mixed_launches()
        if launches[key] != len(shapes[key]):
            raise AssertionError(f"{key}: {launches[key]} mixed launches for {len(shapes[key])} shapes")
    say(f"[mixed]  launches of the drive: {launches}")
    rows = [mixed_row(key, shape, make()) for key, shape, make in cases]
    del gen
    for key in shapes:
        mine = [r for r in rows if r["name"] == key]
        say(f"[sums]   {key:26s} {len(mine):2d} shapes: kernel {sum(r['ms'] for r in mine):.4f} ms, same-dtype "
            f"kernel {sum(r['same_ms'] for r in mine):.4f}, plain {sum(r['plain_ms'] for r in mine):.4f}, library {sum(r['library_ms'] for r in mine):.4f}, bound "
            f"{sum(r['bound_ms'] for r in mine):.4f}, share {sum(r['bound_ms'] for r in mine) / sum(r['ms'] for r in mine):.2f}")
    phase_s = time.perf_counter() - t_phase
    say(f"[mixed]  phase 14 in {phase_s:.1f} s")
    return {"rows": rows, "launches": launches, "phase_s": phase_s}


def mixed_entries(rec: dict) -> list[dict]:
    """The kernels record's entries of phase 14: one a kernel and pair."""
    out = []
    for key, (source, replaces) in MIXED_SOURCES.items():
        mine = [r for r in rec["rows"] if r["name"] == key]
        out.append({
            "name": key, "route": "cuda", "source": source, "replaces": replaces, "dtype": mine[0]["pair"],
            "on_path": False, "launches": rec["launches"][key], "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{k: sum(r[k] for r in mine) for k in ("ms", "plain_ms", "bound_ms", "library_ms", "same_ms")},
            "bound_by": "operations" if sum(r["ops_ms"] for r in mine) >= sum(r["bytes_ms"] for r in mine)
            else "bytes",
        })
    return out


def become_subreaper() -> None:
    """Adopt the orphans of this script's descendants, so that
    :func:`stop_own_processes` sees every process the script started."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def own_children() -> list[int]:
    """The pids whose parent is this process, zombies included."""
    me, kids = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                state_ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, IndexError):
            continue
        if int(state_ppid[1]) == me:
            kids.append(int(name))
    return kids


def stop_own_processes(grace_s: float = 5.0) -> None:
    """Stop every process this script started that is still there.

    The in-process ``create_dataset`` pool leaves multiprocessing's
    forkserver and resource tracker running; they would see this process's
    end only after it, so they are stopped here, the forkserver first (it
    holds the tracker's pipe).  Then each remaining child is sent SIGTERM,
    then SIGKILL after ``grace_s``, and reaped."""
    for helper in (multiprocessing.forkserver._forkserver, multiprocessing.resource_tracker._resource_tracker):
        helper._stop()
    pending = {}
    for pid in own_children():
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                pending[pid] = f.read().replace(b"\0", b" ").decode(errors="replace").strip()[:160] or "an orphan that had exited"
            os.kill(pid, signal.SIGTERM)
        except (OSError, ProcessLookupError):
            pending.setdefault(pid, "?")
    deadline = time.monotonic() + grace_s
    alive = set(pending)
    while alive:
        for pid in list(alive):
            try:
                if os.waitpid(pid, os.WNOHANG)[0] == pid:
                    alive.discard(pid)
            except ChildProcessError:
                alive.discard(pid)
        if alive and time.monotonic() > deadline:
            for pid in alive:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
            for pid in alive:
                with contextlib.suppress(ChildProcessError):
                    os.waitpid(pid, 0)
            alive.clear()
        time.sleep(0.02)
    for pid, cmd in pending.items():
        print(f"chip_smoke: stopped and reaped process {pid}: {cmd}", file=sys.stderr)


def main() -> None:
    become_subreaper()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    card = card_line()
    print(f"[card] {card}")
    dev = torch.device("cuda")
    # The plain versions and the library yardsticks run in float32, not TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # The native host tail (g++, about a second) builds beside the nvcc jobs.
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: (time.perf_counter(), native.build(), time.perf_counter()))
        start_ns = time.perf_counter_ns()
        build = {"total_s": _build.build_all()}
        build["sources_s"] = sorted(((s.t1_ns - start_ns) * 1e-9 for s in profiling.spans()
                                     if s.name == "mg.build.compile" and s.t0_ns >= start_ns), reverse=True)
        print(f"[build] kernels built in {build['total_s']:.2f} s; each nvcc's end (s from the start): "
              + ", ".join(f"{v:.1f}" for v in build["sources_s"]))
        t0, lib, t1 = host.result()
    if not native.is_available() or native.lib_path() != lib:
        raise AssertionError("the native host tail did not build")
    print(f"[build] native host tail {os.path.relpath(lib, ROOT)} built in {t1 - t0:.2f} s")

    # Phases 1-11 run the impls they were written for: pallas_up for
    # synthesis and pallas_gp for training by name here, and through a table
    # seeded with those winners where an entry point resolves "auto" (their
    # CLI subprocesses, compare, audition).  Phase 12 measures in a table of
    # its own.
    seeded = tempfile.mkdtemp(prefix="chip_smoke_seeded_")
    n_keys = seed_autotune_table(seeded, dev)
    use_autotune_dir(seeded)
    print(f"[autotune] phases 1-11: a table of {n_keys} keys seeded with pallas_up, K5 and pallas_gp")
    cfg = ModelConfig(conv_impl="pallas_up")
    cfg_gp = dataclasses.replace(cfg, conv_impl="pallas_gp")
    gen = load_reference_generator(str(CKPT), cfg, device=dev)
    rows = check_kernels(gen, cfg, dev)
    del gen
    assert_no_mixed("phase 2")
    e2e, waves = end_to_end(cfg, dev)
    torch.cuda.empty_cache()
    assert_no_mixed("phase 3")

    tcfg = TrainConfig()
    rows += check_train_kernels(cfg, tcfg, dev)
    print_row_sums(rows)
    print_wgrad_sums(rows)
    assert_no_mixed("phase 4")
    grads = check_function_and_gp(cfg_gp, tcfg, dev)
    torch.cuda.empty_cache()
    assert_no_mixed("phase 5")
    train_rec = train_path(cfg_gp, tcfg, dev)
    torch.cuda.empty_cache()
    assert_no_mixed("phase 6")

    gen = load_reference_generator(str(CKPT), cfg, device=dev)
    rows += check_block_kernel(gen, cfg, dev)
    del gen
    torch.cuda.empty_cache()
    e2e_block = end_to_end_block(cfg, dev, waves)
    torch.cuda.empty_cache()
    assert_no_mixed("phase 7")
    loop = train_entry_point(cfg_gp, dev)
    torch.cuda.empty_cache()
    assert_no_mixed("phase 8")

    gen = load_reference_generator(str(CKPT), cfg, device=dev)
    bf16_rows = check_bf16_kernels(gen, cfg, dev)
    rows += check_head_kernel(gen, cfg, dev)
    del gen
    torch.cuda.empty_cache()
    e2e_new = end_to_end_new_impls(cfg, dev)
    torch.cuda.empty_cache()
    wide_gen = wide_generator_synthesis(cfg, dev)
    torch.cuda.empty_cache()
    gansynth = gansynth_synthesis(dev)
    torch.cuda.empty_cache()
    assert_no_mixed("phase 9")
    serving = serving_and_evaluation(cfg, dev, loop["run_dir"], card)
    torch.cuda.empty_cache()
    assert_no_mixed("phase 10")
    interchange = ingest_and_interchange(cfg, dev, card)
    torch.cuda.empty_cache()
    assert_no_mixed("phase 11")
    selection = conv_impl_selection(cfg, dev, card)
    torch.cuda.empty_cache()
    assert_no_mixed("phase 12")
    parallel = parallel_phase(cfg, dev, card)
    torch.cuda.empty_cache()
    assert_no_mixed("phase 13")
    mixed = mixed_dtype(cfg, dev, card)
    torch.cuda.empty_cache()

    paths = (e2e, train_rec, e2e_block, loop, e2e_new, serving, interchange, selection, parallel)
    # The float32 kernels' launches: a wrapper's count less its bf16 ones.
    launched = {k: sum(p["launches"][k] for p in paths) for k in (*WRAPPERS, IDFT)}
    bf16_launched = {k: sum(p["bf16_launches"][k] for p in (e2e_new, serving, selection)) for k in BF16_WRAPPERS}
    for name, fn in BF16_WRAPPERS.items():
        launched[fn.__name__] -= bf16_launched[name]
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
            if name == "weight_grad3x3":
                entry["kernel_routes"] = sorted({r["route"] for r in mine})
            if all("plan" in r for r in mine):  # the conv template: its routes
                entry["conv_routes"] = sorted({r["route"] for r in mine})
            if all("bound_fp32_ms" in r for r in mine):  # and both bounds, K4's too
                for k in ("bound_fp32_ms", "bound_3xtf32_ms"):
                    entry[k] = sum(r[k] for r in mine)
            if name == "fused_block":
                entry["pair_ms"] = sum(r["pair_ms"] for r in mine if "pair_ms" in r)
                entry["max_abs_err_vs_pair"] = max(r["err_pair"] for r in mine if "err_pair" in r)
            kernels.append(entry)
    for name, (source, replaces) in BF16_SOURCES.items():
        mine = [r for r in bf16_rows if r["name"] == name and r["role"] == "synthesis"]  # the path's shapes
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "dtype": "bfloat16",
            "launches": bf16_launched[name], "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{k: sum(r[k] for r in mine) for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "operations" if sum(r["ops_ms"] for r in mine) >= sum(r["bytes_ms"] for r in mine)
            else "bytes",
        }
        if all("plan" in r for r in mine):
            entry["conv_routes"] = sorted({r["route"] for r in mine})
        if name == "fused_block_bf16":
            entry["pair_ms"] = sum(r["pair_ms"] for r in mine)
            entry["blocks"] = [r["block"] for r in mine]
        kernels.append(entry)
    # K4 bf16 past 128 channels (the cluster route): its own source, on no
    # path (the bf16 rule gives it no block: no faster than the pair); its
    # launches those of phase 9's generator past 128 channels under the
    # rule, beside those with the rule made to take it; its times at
    # WIDE_BLOCK (and at THREE_RANK_BLOCK).
    wide, three = [r for r in bf16_rows if r["role"] == "wide"]
    kernels.append({
        "name": "fused_block_bf16", "kernel_route": "bf16_cluster", "on_path": False, "route": "cuda",
        "source": "musicgan_tpu_torch/csrc/block3x3_bf16_wide.cu", "replaces": BF16_SOURCES["fused_block_bf16"][1],
        "dtype": "bfloat16", "launches": wide_gen["launches"]["fused_block"], "path": "wide_generator",
        "forced_launches": wide_gen["forced_launches"]["fused_block"],
        "max_abs_err": max(wide["max_abs_err"], three["max_abs_err"]),
        **{k: wide[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by", "pair_ms", "equal_pair",
                                "equal_pair_f32")},
        "three_rank": {k: three[k] for k in ("shape", "ms", "pair_ms", "library_ms", "bound_ms", "equal_pair")},
    })
    # Its template tier (inputs past 608 channels): on no path; held to the
    # pair in the 2-norm at TEMPLATE_BLOCK.
    tmpl, = [r for r in bf16_rows if r["role"] == "template"]
    kernels.append({
        "name": "fused_block_bf16", "kernel_route": "template", "on_path": False, "route": "cuda",
        "source": "musicgan_tpu_torch/csrc/block3x3_bf16_template.cu",
        "replaces": BF16_SOURCES["fused_block_bf16"][1], "dtype": "bfloat16", "launches": 0,
        **{k: tmpl[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms", "bound_by",
                                "pair_ms", "l2_vs_pair", "l2_vs_pair_f32")},
    })
    kernels += mixed_entries(mixed)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build": build, "shapes": rows, "end_to_end": e2e, "gradients": grads, "train": train_rec,
         "end_to_end_block": e2e_block, "train_entry_point": loop, "bf16_shapes": bf16_rows,
         "end_to_end_new_impls": e2e_new, "wide_generator": wide_gen, "gansynth_call": gansynth, "serving": serving, "ingest_and_interchange": interchange,
         "conv_impl_selection": selection, "parallel": parallel, "mixed_dtype": mixed, "kernels": kernels},
        indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == [CUT_SCHEDULE_FLAG]:
        cli_with_cut_schedule(sys.argv[2:])
    elif sys.argv[1:2] == [DP_RANK_FLAG]:
        dp_rank(sys.argv[2:])
    else:
        try:
            main()
        finally:
            stop_own_processes()
