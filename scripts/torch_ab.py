#!/usr/bin/env python3
"""Measure one tree of the PyTorch port on the card, for A/B comparisons of
two trees on one machine in one run.

    python3 scripts/torch_ab.py --root ROOT --tag NAME

``ROOT`` is the root of a checkout (``.`` for this one, or a parent commit
unpacked with ``git archive`` into a git-ignored directory).  The script
imports that tree's ``musicgan_tpu_torch`` and measures, the same way for
any tree:

* the conv kernel (K1 with LeakyReLU and bias, K1 as input gradient, K2)
  at every shape of one stage-7 train iteration at batch 6, and K1 and K3
  with PixelNorm at the 8 blocks of synthesis (5 clips x nb_vec 10): device
  time of the wrapper as its caller calls it (OIHW weights, packed inside
  for the train step, ahead for synthesis), and of ``F.conv2d`` on the same
  inputs, each from CUDA-graph replays timed by CUDA events, so the host's
  time to issue a call is not counted;
* the host's time to issue one K1 call and one ``F.conv2d`` call (a tiny
  shape back to back, where the card waits on the host);
* the whole-block kernel K4 at blocks 4-7 of that synthesis call, and K1
  then K3 at the same blocks, device time as above;
* the bits of K1, K2, K3 and K5 at those shapes: a SHA-256 of each output,
  so that two trees can be held to the same bits;
* warm synthesis (5 clips x nb_vec 10 from ``gen_final.pt``): median of 20
  calls, each timed to the end of its device work, under
  ``conv_impl="pallas_up"`` and ``"pallas_block"`` in turns;
* the train step at stage 7 (medians of 10 critic-only and 10 critic +
  generator iterations, steps/s at n_critic 5) and at stage 0 (median of
  10 chunks of 10).

Results go to ``chiprun_out/ab_<NAME>.json``; a summary is printed.  Run
the trees in turns in one call (parent, change, change, parent) and
compare only within it.  ``python3 scripts/torch_ab.py --compare A1 B1``
then prints which kernel outputs differ in their bits between two runs
(exit code 1 if any does).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # the checkout this script is in


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root")
    ap.add_argument("--tag")
    ap.add_argument("--compare", nargs=2, metavar=("TAG_A", "TAG_B"))
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(Path(f"chiprun_out/ab_{t}.json").read_text())["bits"] for t in args.compare)
        differ = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
        print(f"[ab bits] {args.compare[0]} against {args.compare[1]}: {len(a)} outputs, "
              f"{len(differ)} differ" + "".join(f"\n  {k}" for k in differ))
        sys.exit(1 if differ else 0)
    if not (args.root and args.tag):
        ap.error("--root and --tag, or --compare")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch
    import torch.nn.functional as F

    from musicgan_tpu_torch import generate as generate_mod
    from musicgan_tpu_torch.config import ModelConfig, TrainConfig
    from musicgan_tpu_torch.models import load_reference_generator
    from musicgan_tpu_torch.ops import _build
    from musicgan_tpu_torch.ops import conv as conv_ops
    from musicgan_tpu_torch.train import build_chunk_step, build_step, init_train_state

    # The yardstick of this checkout's chip_smoke.py (its timing and the
    # train step's conv shapes), for every tree alike; it imports the
    # package of ROOT, which comes first on the path.
    from musicgan_tpu_torch.ops import conv_vjp

    # chip_smoke.py names every wrapper of this checkout; a tree from before
    # the weight-gradient kernel has no such wrapper, which only its launch
    # counting (not used here) would read.
    conv_vjp.__dict__.setdefault("weight_grad3x3", None)
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    if not torch.cuda.is_available():
        sys.exit("torch_ab: no CUDA device")
    if not _build.SRC_DIR.resolve().is_relative_to(root):
        sys.exit(f"torch_ab: imported the package from {_build.SRC_DIR}, not from {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    cfg, tcfg = ModelConfig(), TrainConfig()

    gen, disc = smoke.train_conv_shapes(cfg, tcfg.batch_size, 7)
    cases = ([("gen_fwd", s, True, 0.2) for s in gen]
             + [("critic_fwd", s, True, 0.2) for s in disc]
             + [("critic_dx", (b, co, ci, hh, ww), False, None) for b, ci, co, hh, ww in disc]
             + [("gen_dx", (b, co, ci, hh, ww), False, None) for b, ci, co, hh, ww in gen[1:]])
    rng = torch.Generator(device=dev).manual_seed(2)
    rows, bits = [], {}

    def digest(role, shape, y):
        bits[f"{role} {list(shape)}"] = hashlib.sha256(y.contiguous().cpu().numpy().tobytes()).hexdigest()

    for role, (b, cin, cout, hh, ww), bias, slope in cases:
        x = torch.randn(b, cin, hh, ww, generator=rng, device=dev)
        wt = torch.randn(cout, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
        bb = torch.randn(cout, generator=rng, device=dev) * 0.1 if bias else None
        if role == "gen_fwd":
            kernel = lambda: conv_ops.fused_conv3x3_msq(x, wt, bb, slope, 1e-8)  # noqa: E731
        else:
            kernel = lambda: conv_ops.fused_conv3x3(x, wt, bb, slope)  # noqa: E731
        rows.append({"role": role, "shape": [b, cin, cout, hh, ww], "ms": smoke.time_ms(kernel),
                     "library_ms": smoke.time_ms(lambda: F.conv2d(x, wt, bb, padding=1))})
        y = kernel()
        for j, t in enumerate(y if isinstance(y, tuple) else (y,)):
            digest(f"{role}.{j}", (b, cin, cout, hh, ww), t)
        del x, y
    for i, (cin, cout) in enumerate(cfg.gen_channels):
        hh, ww = cfg.latent_height * 2**i, cfg.latent_width * 10 * 2**i
        x = torch.randn(5, cin, hh, ww, generator=rng, device=dev)
        for role, co in (("synth_k1", cin), ("synth_k3", cout)):
            wt = torch.randn(co, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
            bb = torch.randn(co, generator=rng, device=dev) * 0.1
            if role == "synth_k1":
                wp, xl = conv_ops.kernel_weights(wt), x
                kernel = lambda: conv_ops.fused_conv3x3(x, wt, bb, 0.2, True, w_packed=wp)  # noqa: E731
            else:
                wp = conv_ops.kernel_upconv_weights(wt)
                xl = F.interpolate(x, scale_factor=2, mode="nearest")
                kernel = lambda: conv_ops.fused_upconv3x3(x, wt, bb, 0.2, True, w_packed=wp)  # noqa: E731
            rows.append({"role": role, "shape": [5, cin, co, hh, ww], "ms": smoke.time_ms(kernel),
                         "library_ms": smoke.time_ms(lambda: F.conv2d(xl, wt, bb, padding=1))})
            digest(role, (5, cin, co, hh, ww), kernel())
            del xl
        del x
    torch.cuda.empty_cache()
    re_, im_ = (torch.randn(5, 513, 5120, generator=rng, device=dev) for _ in range(2))
    digest("istft", (5, 513, 5120), smoke.istft_ops.istft_fused(re_, im_, 1024, 256))
    del re_, im_

    # K4 at the blocks of synthesis that take it on an H100 (4-7), with the
    # shipped generator's weights, against K1 then K3.
    ckpt = root / "saved_models" / "quality_r4" / "gen_final.pt"
    g = load_reference_generator(str(ckpt), cfg, device=dev)
    blocks = []
    for i in (4, 5, 6, 7):
        cin, cout = cfg.gen_channels[i]
        hh, ww = cfg.latent_height * 2**i, cfg.latent_width * 10 * 2**i
        x = torch.randn(5, cin, hh, ww, generator=rng, device=dev)
        blk = g.blocks[i]
        w1, b1 = blk.conv1.weight.detach(), blk.conv1.bias.detach()
        w2, b2 = blk.conv2.weight.detach(), blk.conv2.bias.detach()
        w1p, w2p = conv_ops.kernel_weights(w1), conv_ops.kernel_upconv_weights(w2)
        k4 = lambda: conv_ops.fused_block(x, w1, b1, w2, b2, 0.2, 1e-8, w1_packed=w1p, w2_packed=w2p)  # noqa: E731
        pair = lambda: conv_ops.fused_upconv3x3(  # noqa: E731
            conv_ops.fused_conv3x3(x, w1, b1, 0.2, True, 1e-8, w_packed=w1p), w2, b2, 0.2, True, 1e-8, w_packed=w2p)
        blocks.append({"block": i, "shape": [5, cin, cin, cout, hh, ww], "ms": smoke.time_ms(k4),
                       "pair_ms": smoke.time_ms(pair), "max_abs_vs_pair": (k4() - pair()).abs().max().item()})
        del x
    torch.cuda.empty_cache()

    # The host's time to issue one call (back to back on a tiny shape, where
    # the card waits on the host): the wrapper as the train step calls it,
    # and F.conv2d.
    x = torch.randn(1, 8, 4, 4, generator=rng, device=dev)
    wt = torch.randn(16, 8, 3, 3, generator=rng, device=dev)
    bb = torch.randn(16, generator=rng, device=dev)

    def host_us(fn, n=2000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / n

    host = {"k1_us": host_us(lambda: conv_ops.fused_conv3x3(x, wt, bb, 0.2)),
            "f_conv2d_us": host_us(lambda: F.conv2d(x, wt, bb, padding=1))}

    # Warm synthesis under both values of conv_impl, in turns.
    gens = {"pallas_up": g, "pallas_block": load_reference_generator(
        str(ckpt), dataclasses.replace(cfg, conv_impl="pallas_block"), device=dev)}
    z = torch.randn((5, cfg.latent_height, cfg.latent_width * 10, cfg.rand_channels),
                    generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    synth = generate_mod.synthesize_fn(cfg, cfg.n_stages - 1)
    for gg in gens.values():
        for _ in range(3):
            synth(gg, z)
    torch.cuda.synchronize()
    synth_by = {k: [] for k in gens}
    for k in ("pallas_up", "pallas_block", "pallas_block", "pallas_up"):
        for _ in range(10):
            t0 = time.perf_counter()
            synth(gens[k], z)
            torch.cuda.synchronize()
            synth_by[k].append(time.perf_counter() - t0)
    synth_s = synth_by["pallas_up"]
    del g, gens
    torch.cuda.empty_cache()

    # The train step.
    state = init_train_state(0, cfg, tcfg, device="cuda")
    xg = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(tcfg.batch_size, 2, 512, 512, generator=xg, device=dev)
    x_stack = torch.randn(10, tcfg.batch_size, 2, 512, 512, generator=xg, device=dev)

    def timed(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    step_d, step_dg = build_step(7, False, cfg, tcfg), build_step(7, True, cfg, tcfg)
    timed(lambda: step_d(state, x, 0.5), 2)
    timed(lambda: step_dg(state, x, 0.5), 2)
    d_s = timed(lambda: step_d(state, x, 0.5), 10)
    dg_s = timed(lambda: step_dg(state, x, 0.5), 10)
    mask = [(i + 1) % tcfg.n_critic == 0 for i in range(10)]
    chunk = build_chunk_step(0, 10, cfg, tcfg)
    timed(lambda: chunk(state, x_stack, [1.0] * 10, mask), 2)
    chunk_s = timed(lambda: chunk(state, x_stack, [1.0] * 10, mask), 10)
    med = lambda v: float(np.median(v))  # noqa: E731
    n_c = tcfg.n_critic
    out = {
        "tag": args.tag, "root": str(root), "card": card, "rows": rows, "host_per_call": host,
        "synthesis_ms": [1e3 * v for v in synth_s], "synthesis_median_ms": 1e3 * med(synth_s),
        "synthesis_block_ms": [1e3 * v for v in synth_by["pallas_block"]],
        "synthesis_block_median_ms": 1e3 * med(synth_by["pallas_block"]),
        "k4_blocks": blocks, "bits": bits,
        "d_only_ms": [1e3 * v for v in d_s], "d_and_g_ms": [1e3 * v for v in dg_s],
        "steps_per_s_stage7": n_c / ((n_c - 1) * med(d_s) + med(dg_s)),
        "chunk_ms": [1e3 * v for v in chunk_s], "steps_per_s_stage0": 10 / med(chunk_s),
    }
    small, sums = {}, {}
    for r in rows:
        for part, keep in ((small, r["shape"][3] <= 32), (sums, True)):
            if keep:
                s = part.setdefault(r["role"], [0.0, 0.0])
                s[0] += r["ms"]
                s[1] += r["library_ms"]
    out["small_sums_ms"], out["sums_ms"] = small, sums
    os.makedirs("chiprun_out", exist_ok=True)
    Path(f"chiprun_out/ab_{args.tag}.json").write_text(json.dumps(out, indent=1))
    print(f"[ab {args.tag}] {card}; conv up to 32x32, kernel / F.conv2d ms: "
          + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in small.items())
          + "; all shapes, kernel / F.conv2d ms: " + ", ".join(
              f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in sums.items())
          + f"; host per call: K1 {host['k1_us']:.1f} us, F.conv2d {host['f_conv2d_us']:.1f} us"
          + "; K4 / K1 then K3 ms: " + ", ".join(
              f"block {r['block']} {r['ms']:.4f} / {r['pair_ms']:.4f}" for r in blocks)
          + f"; synthesis {out['synthesis_median_ms']:.3f} ms, under pallas_block "
          f"{out['synthesis_block_median_ms']:.3f} ms; stage 7 {1e3 * med(d_s):.2f} / "
          f"{1e3 * med(dg_s):.2f} ms = {out['steps_per_s_stage7']:.3f} steps/s; stage 0 "
          f"{out['steps_per_s_stage0']:.1f} steps/s", flush=True)


if __name__ == "__main__":
    main()
