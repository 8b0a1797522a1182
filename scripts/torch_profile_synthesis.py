#!/usr/bin/env python3
"""Profile the PyTorch port's synthesis path on one NVIDIA GPU.

    python3 scripts/torch_profile_synthesis.py [--conv-impl pallas_up]

Loads ``saved_models/quality_r4/gen_final.pt`` on the card under
``ModelConfig.conv_impl`` (any of ``config.CONV_IMPLS``: float32 or bf16
blocks), warms
``synthesize_fn`` up on ``chip_smoke.py``'s main path (5 clips x nb_vec
10, the same seeded latents), then runs it ``REPS`` times under
``torch.profiler`` and prints, per call: the
device's busy and idle share of the profiled window (union of kernel
intervals over first-event-to-last-event), device time and launches by
kernel name, and the split between the port's own kernels and PyTorch's.
The same record goes to ``chiprun_out/profile_synthesis_<impl>.json``.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import CKPT, card_line, main_path_latent  # noqa: E402
from musicgan_tpu_torch.config import CONV_IMPLS, ModelConfig  # noqa: E402
from musicgan_tpu_torch.generate import synthesize_fn  # noqa: E402
from musicgan_tpu_torch.models import load_reference_generator  # noqa: E402
from musicgan_tpu_torch.ops import _build  # noqa: E402

REPS = 5
OWN_KERNELS = ("conv_tc_kernel", "conv_flat_kernel", "conv_bf16_kernel", "istft_kernel", "block_tc_kernel",
               "block_split_weights")


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--conv-impl", default="pallas_up", choices=CONV_IMPLS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_synthesis: no CUDA device")
    card = card_line()
    print(f"[card] {card}")
    _build.build_all()

    cfg, dev = ModelConfig(conv_impl=args.conv_impl), torch.device("cuda")
    gen = load_reference_generator(str(CKPT), cfg, device=dev)
    z = main_path_latent(cfg, dev)
    synth = synthesize_fn(cfg, cfg.n_stages - 1)
    for _ in range(3):
        synth(gen, z)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(REPS):
        synth(gen, z)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / REPS

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            synth(gen, z)
        torch.cuda.synchronize()

    events = list(prof.events())
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        sys.exit("torch_profile_synthesis: the profiler recorded no device activity")
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    window = end - start
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])

    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        row = by_name[e.name]
        row[0] += e.time_range.end - e.time_range.start
        row[1] += 1
    rows = sorted(
        ({"name": n, "ms_per_call": t / 1e3 / REPS, "launches_per_call": c / REPS}
         for n, (t, c) in by_name.items()),
        key=lambda r: -r["ms_per_call"],
    )
    own = sum(r["ms_per_call"] for r in rows if any(k in r["name"] for k in OWN_KERNELS))
    other = sum(r["ms_per_call"] for r in rows) - own
    result = {
        "card": card, "conv_impl": args.conv_impl, "reps": REPS,
        "wall_ms_per_call_unprofiled": plain_wall_ms,
        "window_ms_per_call_profiled": window / 1e3 / REPS,
        "device_busy_ms_per_call": busy / 1e3 / REPS,
        "device_idle_share": 1.0 - busy / window,
        "own_kernels_ms_per_call": own, "pytorch_kernels_ms_per_call": other,
        "kernel_launches_per_call": len(kernels) / REPS,
        "by_kernel": rows,
    }
    print(
        f"[profile] {args.conv_impl}: unprofiled {plain_wall_ms:.2f} ms/call; profiled window "
        f"{result['window_ms_per_call_profiled']:.2f} ms/call, device busy "
        f"{result['device_busy_ms_per_call']:.2f} ms, idle share {result['device_idle_share']:.3f}; "
        f"own kernels {own:.2f} ms, PyTorch kernels {other:.2f} ms, "
        f"{result['kernel_launches_per_call']:.0f} launches/call"
    )
    for r in rows[:20]:
        print(f"[kernel] {r['ms_per_call']:8.4f} ms  x{r['launches_per_call']:5.1f}  {r['name'][:100]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_synthesis_{args.conv_impl}.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "by_kernel"}))


if __name__ == "__main__":
    main()
