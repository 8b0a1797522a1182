#!/usr/bin/env python3
"""Profile the PyTorch port's train step, at stage 7 and at stage 0, on one
NVIDIA GPU.

    python3 scripts/torch_profile_train_step.py

Builds ``chip_smoke.py``'s seeded train state and synthetic batch on the
card (full width, batch 6, mid fade-in), and for stage 7 (512x512) and then
stage 0 (4x4) warms the step up, runs ``REPS`` critic-only iterations and
``REPS`` critic + generator iterations, each kind in its own
``torch.profiler`` window, and prints per
iteration: the device's busy and idle share of the window, kernel launches,
device time by kernel name, and device time by what the kernel was
launched for:

* the port's own conv kernel by role: K2 forward (generator), K1 forward
  (critic convs), K1 as the transposed conv of the gradient penalty, K1 as
  an input gradient.  The roles come from the order of the wrapper calls,
  which is the order of the kernel's launches on the stream;
* the weight-gradient kernel (``csrc/wgrad3x3.cu``: the small route's one
  launch, or the tensor-core route's products and, where its plan has
  several runs, the second launch that adds them) by name;
* PyTorch's kernels by the labelled region of the step that launched them:
  weight packing for the kernels, the weight gradient's workspace, the
  elementwise epilogue gradient (the rest of ``conv3x3_act``'s backward),
  Adam, the input pipeline, and everything else (heads, pools, upsamples,
  LeakyReLU masks of the penalty, losses, autograd's accumulation).

The same record goes to ``chiprun_out/profile_train_step.json``.  Imports
no JAX.
"""

from __future__ import annotations

import functools
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from unittest import mock

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import SEED, TRAIN_ALPHA, TRAIN_STAGE, card_line  # noqa: E402
from musicgan_tpu_torch.audio import transforms  # noqa: E402
from musicgan_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from musicgan_tpu_torch.ops import _build  # noqa: E402
from musicgan_tpu_torch.ops import conv as conv_ops  # noqa: E402
from musicgan_tpu_torch.ops import conv_vjp  # noqa: E402
from musicgan_tpu_torch.train import build_step, init_train_state  # noqa: E402
from musicgan_tpu_torch.train import optim, step as step_mod  # noqa: E402
from scripts.torch_profile_synthesis import busy_us  # noqa: E402

REPS = 3
OWN_KERNELS = ("conv_tc_kernel", "conv_flat_kernel")  # the conv template's two shapes
WGRAD_KERNELS = ("wgrad_tc_kernel", "wgrad_reduce_kernel", "wgrad_small_kernel")  # csrc/wgrad3x3.cu
WGRAD = "weight gradient kernel (csrc/wgrad3x3.cu)"
LABEL = "mg:"


def is_own(name: str) -> bool:
    return any(k in name for k in OWN_KERNELS)


def is_wgrad(name: str) -> bool:
    return any(k in name for k in WGRAD_KERNELS)


def labelled(name, fn):
    """``fn`` inside a profiler range ``mg:<name>`` (its attributes, such as
    a launch count, carried over)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(LABEL + name):
            return fn(*args, **kwargs)

    return wrapped


def instrument(roles: list):
    """Patches that label the step's regions and log the role of every
    launch of the port's conv kernel, in order."""
    in_backward = [False]
    k1, k2, backward = conv_ops.fused_conv3x3, conv_ops.fused_conv3x3_msq, conv_vjp.conv3x3_act_backward

    def k1_logged(x, w, b, slope=None, *args, **kwargs):
        if in_backward[0]:
            roles.append("K1 input gradient")
        elif slope is None:
            roles.append("K1 transposed conv of the penalty")
        else:
            roles.append("K1 forward (critic conv)")
        return k1(x, w, b, slope, *args, **kwargs)

    def k2_logged(*args, **kwargs):
        roles.append("K2 forward (generator conv)")
        return k2(*args, **kwargs)

    def backward_logged(*args, **kwargs):
        in_backward[0] = True
        try:
            with record_function(LABEL + "epilogue gradient"):
                return backward(*args, **kwargs)
        finally:
            in_backward[0] = False

    return [
        mock.patch.object(conv_vjp, "fused_conv3x3", k1_logged),
        mock.patch.object(conv_vjp, "fused_conv3x3_msq", k2_logged),
        mock.patch.object(conv_vjp, "conv3x3_act_backward", backward_logged),
        mock.patch.object(conv_vjp, "weight_grad3x3", labelled("weight gradient", conv_vjp.weight_grad3x3)),
        mock.patch.object(conv_ops, "kernel_weights", labelled("weight packing", conv_ops.kernel_weights)),
        mock.patch.object(optim.AdamPerLeaf, "update", labelled("Adam", optim.AdamPerLeaf.update)),
        mock.patch.object(step_mod, "grower_transform", labelled("input pipeline", transforms.grower_transform)),
    ]


def region_of(event) -> str:
    """The innermost labelled range around a CPU op, or "other"."""
    while event is not None:
        if event.name.startswith(LABEL):
            return event.name[len(LABEL):]
        event = event.cpu_parent
    return "other (heads, pools, masks, losses, autograd)"


def profile_kind(step, state, x, roles: list) -> dict:
    for _ in range(2):
        step(state, x, TRAIN_ALPHA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        step(state, x, TRAIN_ALPHA)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / REPS

    roles.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            step(state, x, TRAIN_ALPHA)
        torch.cuda.synchronize()
    events = list(prof.events())
    # Device events, without the labelled ranges' mirror images on the device.
    kernels = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(LABEL)
    ]
    if not kernels:
        sys.exit("torch_profile_train_step: the profiler recorded no device activity")
    window = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])

    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1

    # The port's kernel by role: its launches in stream order against the
    # wrapper calls in call order.
    by_cat = defaultdict(lambda: [0.0, 0])
    own = sorted((e for e in kernels if is_own(e.name)), key=lambda e: e.time_range.start)
    if len(own) != len(roles):
        sys.exit(f"torch_profile_train_step: {len(own)} launches of {OWN_KERNELS} for {len(roles)} wrapper calls")
    for e, role in zip(own, roles):
        by_cat[role][0] += e.time_range.end - e.time_range.start
        by_cat[role][1] += 1
    wgrad = [e for e in kernels if is_wgrad(e.name)]
    wgrad_total = sum(e.time_range.end - e.time_range.start for e in wgrad)
    by_cat[WGRAD][0] += wgrad_total
    by_cat[WGRAD][1] += len(wgrad)
    # PyTorch's kernels by the labelled region of the op that launched them.
    attributed = 0.0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels and not e.name.startswith(LABEL):
            kept = [k for k in e.kernels if not (is_own(k.name) or is_wgrad(k.name))]
            t = sum(k.duration for k in kept)
            by_cat[region_of(e)][0] += t
            by_cat[region_of(e)][1] += len(kept)
            attributed += t
    total = sum(t for t, _ in by_name.values())
    own_total = sum(e.time_range.end - e.time_range.start for e in own)
    by_cat["not attributed to an op"][0] += total - own_total - wgrad_total - attributed

    def table(d):
        return sorted(
            ({"name": n, "ms_per_iteration": t / 1e3 / REPS, "launches_per_iteration": c / REPS}
             for n, (t, c) in d.items()), key=lambda r: -r["ms_per_iteration"],
        )

    return {
        "wall_ms_per_iteration_unprofiled": wall_ms,
        "window_ms_per_iteration_profiled": window / 1e3 / REPS,
        "device_busy_ms_per_iteration": busy / 1e3 / REPS,
        "device_idle_share": 1.0 - busy / window,
        "own_kernel_ms_per_iteration": own_total / 1e3 / REPS,
        "pytorch_kernels_ms_per_iteration": (total - own_total) / 1e3 / REPS,
        "kernel_launches_per_iteration": len(kernels) / REPS,
        "by_purpose": table(by_cat), "by_kernel": table(by_name),
    }


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_profile_train_step: no CUDA device")
    card = card_line()
    print(f"[card] {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()

    cfg, tcfg, dev = ModelConfig(conv_impl="pallas_gp"), TrainConfig(), torch.device("cuda")
    state = init_train_state(SEED, cfg, tcfg, device="cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(tcfg.batch_size, 2, 512, 512, generator=rng, device=dev)

    roles: list = []
    patches = instrument(roles)
    for p in patches:
        p.start()
    try:
        result = {"card": card, "reps": REPS, "batch": tcfg.batch_size}
        kinds = [
            (f"stage{stage}_{kind}", stage, with_gen)
            for stage in (TRAIN_STAGE, 0)
            for kind, with_gen in (("critic_only", False), ("critic_and_generator", True))
        ]
        for kind, stage, with_gen in kinds:
            r = result[kind] = profile_kind(build_step(stage, with_gen, cfg, tcfg), state, x, roles)
            print(
                f"[profile] {kind}: unprofiled {r['wall_ms_per_iteration_unprofiled']:.2f} ms/iteration; "
                f"profiled window {r['window_ms_per_iteration_profiled']:.2f} ms, device busy "
                f"{r['device_busy_ms_per_iteration']:.2f} ms, idle share {r['device_idle_share']:.3f}; "
                f"own kernel {r['own_kernel_ms_per_iteration']:.2f} ms, PyTorch kernels "
                f"{r['pytorch_kernels_ms_per_iteration']:.2f} ms, "
                f"{r['kernel_launches_per_iteration']:.0f} launches/iteration"
            )
            for row in r["by_purpose"]:
                print(f"[purpose] {row['ms_per_iteration']:9.4f} ms  x{row['launches_per_iteration']:7.1f}  {row['name']}")
            for row in r["by_kernel"][:15]:
                print(f"[kernel]  {row['ms_per_iteration']:9.4f} ms  x{row['launches_per_iteration']:7.1f}  {row['name'][:100]}")
    finally:
        for p in patches:
            p.stop()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_train_step.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
