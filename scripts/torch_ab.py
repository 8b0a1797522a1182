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
* K1 bf16, K3 bf16 and K4 bf16 with PixelNorm at the 8 blocks of that
  synthesis call (bf16 inputs of their own stream, the shipped generator's
  weights packed ahead in the layout each tree's kernel reads): device time
  beside ``F.conv2d`` on bf16 tensors (K4 bf16 also beside K1 bf16 then K3
  bf16, with whether the tree's size rule takes it), and a SHA-256 of each
  output, kept apart from the float32 ones;
* the weight gradient (``ops/conv_vjp.py::weight_grad3x3``) at the 34
  trainable convs of that iteration: device time from CUDA-graph replays
  beside one call of cuDNN's default algorithms (TF32 off), and a SHA-256
  of each output (kept apart from K1-K5's: a redesigned kernel changes
  them);
* warm synthesis (5 clips x nb_vec 10 from ``gen_final.pt``): median of 20
  calls, each timed to the end of its device work, under
  ``conv_impl="pallas_up"``, ``"pallas_block"``, ``"pallas_up_bf16"`` and
  ``"pallas_block_bf16"`` in turns;
* the train step at stage 7 (medians of 10 critic-only and 10 critic +
  generator iterations, steps/s at n_critic 5) and at stage 0 (median of
  10 chunks of 10).

Results go to ``chiprun_out/ab_<NAME>.json``; a summary is printed.  Run
the trees in turns in one call (parent, change, change, parent) and
compare only within it.  ``python3 scripts/torch_ab.py --compare A1 B1``
then prints which kernel outputs of K1-K5 differ in their bits between two
runs (exit code 1 if any does), and how many weight gradients and bf16
outputs differ.  ``python3 scripts/torch_ab.py --bf16-table A1 A2 B1 B2``
prints the bf16 rows as a markdown table: each shape's mean time over the
first runs (the parent's) and over the others, ``F.conv2d``'s mean over
all, and the bound (bf16 operations at 989 TFLOP/s or bytes at 3.35 TB/s,
the larger) with the share of it each reaches; then K4 bf16 against K1 bf16
then K3 bf16 block by block in each tree.
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
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # the checkout this script is in


def bf16_bound_ms(role: str, shape: list) -> tuple[float, str]:
    """The least time of a bf16 row (``chip_smoke.py`` phase 9's terms):
    its operations at dense bf16 (989 TFLOP/s) or its bytes (each input
    read once, the output written once) at 3.35 TB/s, the larger."""
    if role == "synth_k1_bf16":
        b, cin, _, h, w = shape
        px = b * h * w
        flops, nbytes = 2.0 * px * cin * 9 * cin, 2.0 * (2 * px * cin + 9 * cin * cin) + 4.0 * cin
    elif role == "synth_k3_bf16":
        b, cin, cout, h, w = shape
        px = b * h * w
        flops = 2.0 * 4 * px * cout * 4 * cin
        nbytes = 2.0 * (px * cin + 4 * px * cout + 16 * cin * cout) + 4.0 * cout
    else:
        b, cin, _, cout, h, w = shape
        px = b * h * w
        flops = 2.0 * px * cin * 9 * cin + 2.0 * 4 * px * cout * 4 * cin
        nbytes = 2.0 * (px * cin + 4 * px * cout + 9 * cin * cin + 16 * cin * cout) + 4.0 * (cin + cout)
    t_ops, t_bytes = 1e3 * flops / 989e12, 1e3 * nbytes / 3.35e12
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bf16_table(tags) -> None:
    runs = [json.loads(Path(f"chiprun_out/ab_{t}.json").read_text()) for t in tags]
    print(f"card: {runs[0]['card']}; parent = {tags[0]}, {tags[1]}; change = {tags[2]}, {tags[3]}")
    print("| kernel | block | shape | parent ms | change ms | F.conv2d ms | change / F.conv2d | bound ms | share |")
    print("|---|---|---|---|---|---|---|---|---|")
    sums = {}
    for i, row in enumerate(runs[0]["bf16_rows"]):
        rows = [r["bf16_rows"][i] for r in runs]
        par = sum(r["ms"] for r in rows[:2]) / 2
        new = sum(r["ms"] for r in rows[2:]) / 2
        lib = sum(r["library_ms"] for r in rows) / 4
        bound, by = bf16_bound_ms(row["role"], row["shape"])
        s = sums.setdefault(row["role"], [0.0, 0.0, 0.0, 0.0])
        for j, v in enumerate((par, new, lib, bound)):
            s[j] += v
        print(f"| {row['role']} | {row['block']} | {tuple(row['shape'])} | {par:.4f} | {new:.4f} | {lib:.4f} | "
              f"{new / lib:.2f} | {bound:.4f} ({by}) | {bound / new:.2f} |")
    for role, (par, new, lib, bound) in sums.items():
        print(f"| {role} | sum | | {par:.4f} | {new:.4f} | {lib:.4f} | {new / lib:.2f} | {bound:.4f} | {bound / new:.2f} |")
    # K4 bf16 beside K1 bf16 then K3 bf16 in each tree.
    print("\n| K4 bf16 block | parent K4 ms | parent pair ms | change K4 ms | change pair ms | change K4 / pair "
          "| taken (parent, change) |")
    print("|---|---|---|---|---|---|---|")
    for i, row in enumerate(runs[0]["bf16_rows"]):
        if row["role"] != "synth_k4_bf16":
            continue
        rows = [r["bf16_rows"][i] for r in runs]
        pk, pp = (sum(r[k] for r in rows[:2]) / 2 for k in ("ms", "pair_ms"))
        nk, np_ = (sum(r[k] for r in rows[2:]) / 2 for k in ("ms", "pair_ms"))
        print(f"| {row['block']} | {pk:.4f} | {pp:.4f} | {nk:.4f} | {np_:.4f} | {nk / np_:.2f} | "
              f"{rows[0].get('takes')}, {rows[2].get('takes')} |")
    for t, r in zip(tags, runs):
        print(f"{t}: synthesis median ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in r.get("synthesis_by_impl_median_ms", {}).items()))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root")
    ap.add_argument("--tag")
    ap.add_argument("--compare", nargs=2, metavar=("TAG_A", "TAG_B"))
    ap.add_argument("--bf16-table", nargs=4, metavar=("A1", "A2", "B1", "B2"))
    args = ap.parse_args()
    if args.bf16_table:
        bf16_table(args.bf16_table)
        return
    if args.compare:
        runs = [json.loads(Path(f"chiprun_out/ab_{t}.json").read_text()) for t in args.compare]
        a, b = (r["bits"] for r in runs)
        differ = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
        print(f"[ab bits] {args.compare[0]} against {args.compare[1]}: {len(a)} outputs, "
              f"{len(differ)} differ" + "".join(f"\n  {k}" for k in differ))
        wa, wb = (r.get("wgrad_bits", {}) for r in runs)
        print(f"[ab bits] weight gradients: {len(wa)} outputs, "
              f"{sum(wa.get(k) != wb.get(k) for k in wa.keys() | wb.keys())} differ")
        ba, bb = (r.get("bf16_bits", {}) for r in runs)
        bdiff = sorted(k for k in ba.keys() | bb.keys() if ba.get(k) != bb.get(k))
        print(f"[ab bits] bf16 outputs: {len(ba)}, {len(bdiff)} differ" + "".join(f"\n  {k}" for k in bdiff))
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
    # counting (not used here) would read, nor (before its tensor-core form)
    # its route's name.
    conv_vjp.__dict__.setdefault("weight_grad3x3", None)
    conv_vjp.__dict__.setdefault("WGRAD_TC", None)  # read by chip_smoke.py at import
    # Nor, before the bf16 kernels' redesign, their plan module, which
    # chip_smoke.py imports (and uses only in its own phase 9).
    import musicgan_tpu_torch.ops as ops_pkg

    if importlib.util.find_spec("musicgan_tpu_torch.ops.conv_bf16") is None:
        stub = types.ModuleType("musicgan_tpu_torch.ops.conv_bf16")
        sys.modules[stub.__name__] = ops_pkg.conv_bf16 = stub
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
    cfg, tcfg = ModelConfig(conv_impl="pallas_up"), TrainConfig()
    cfg_gp = dataclasses.replace(cfg, conv_impl="pallas_gp")  # the train step on the kernels

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

    # The weight gradient at the 34 trainable convs (its own generator, so
    # the inputs above stay those of earlier trees).
    wrng = torch.Generator(device=dev).manual_seed(5)
    wgrad, wgrad_bits = [], {}
    for role, shapes in (("gen", gen), ("critic", disc)):
        for b, cin, cout, hh, ww in shapes:
            x = torch.randn(b, cin, hh, ww, generator=wrng, device=dev)
            d = torch.randn(b, cout, hh, ww, generator=wrng, device=dev) / (b * hh * ww) ** 0.5
            shape = (cout, cin, 3, 3)
            kernel = lambda: conv_vjp.weight_grad3x3(x, d, shape)  # noqa: E731
            wgrad.append({"role": role, "shape": [b, cin, cout, hh, ww], "ms": smoke.time_ms(kernel),
                          "library_ms": smoke.time_ms(lambda: torch.nn.grad.conv2d_weight(x, shape, d, padding=1))})
            wgrad_bits[f"{role} {[b, cin, cout, hh, ww]}"] = hashlib.sha256(
                kernel().cpu().numpy().tobytes()).hexdigest()
            del x, d
    torch.cuda.empty_cache()
    re_, im_ = (torch.randn(5, 513, 5120, generator=rng, device=dev) for _ in range(2))
    digest("istft", (5, 513, 5120), smoke.istft_ops.istft_fused(re_, im_, 1024, 256))
    del re_, im_

    # K1 bf16, K3 bf16 and K4 bf16 at the 8 blocks of synthesis, the shipped
    # generator's weights, inputs of their own stream.  The weights go in
    # the layout the tree's K1 bf16 / K3 bf16 read (kernel_weights_tc where
    # it has one, else the kernel layout K4 reads as well).
    ckpt = root / "saved_models" / "quality_r4" / "gen_final.pt"
    g = load_reference_generator(str(ckpt), cfg, device=dev)
    brng = torch.Generator(device=dev).manual_seed(9)
    bf, bf16_rows, bf16_bits = torch.bfloat16, [], {}
    tc_pack = getattr(conv_ops, "kernel_weights_tc", None)
    # K4 bf16 reads K1 bf16's and K3 bf16's packs where it is block_bf16.cuh
    # (the tree has ops/conv_bf16.py::block_plan), else the kernel layout.
    k4_tc = hasattr(getattr(conv_ops, "conv_bf16", None), "block_plan")
    for i, (cin, cout) in enumerate(cfg.gen_channels):
        hh, ww = cfg.latent_height * 2**i, cfg.latent_width * 10 * 2**i
        x = torch.randn(5, cin, hh, ww, generator=brng, device=dev).to(bf)
        blk = g.blocks[i]
        w1, b1 = blk.conv1.weight.detach(), blk.conv1.bias.detach()
        w2, b2 = blk.conv2.weight.detach(), blk.conv2.bias.detach()
        k1p, k3p = conv_ops.kernel_weights(w1, bf), conv_ops.kernel_upconv_weights(w2, bf)
        w1p, w2p = (tc_pack(w1), tc_pack(w2, True)) if tc_pack else (k1p, k3p)
        xu = F.interpolate(x, scale_factor=2, mode="nearest")
        mid_up = F.interpolate(conv_ops.fused_conv3x3(x, w1, b1, 0.2, True, w_packed=w1p), scale_factor=2,
                               mode="nearest")
        w1b, b1b, w2b, b2b = w1.to(bf), b1.to(bf), w2.to(bf), b2.to(bf)
        cases = {
            "synth_k1_bf16": (lambda: conv_ops.fused_conv3x3(x, w1, b1, 0.2, True, w_packed=w1p),  # noqa: E731
                              lambda: F.conv2d(x, w1b, b1b, padding=1), [5, cin, cin, hh, ww]),
            "synth_k3_bf16": (lambda: conv_ops.fused_upconv3x3(x, w2, b2, 0.2, True, w_packed=w2p),  # noqa: E731
                              lambda: F.conv2d(xu, w2b, b2b, padding=1), [5, cin, cout, hh, ww]),
            "synth_k4_bf16": (lambda: conv_ops.fused_block(x, w1, b1, w2, b2, 0.2, 1e-8,  # noqa: E731
                                                           w1_packed=w1p if k4_tc else k1p,
                                                           w2_packed=w2p if k4_tc else k3p),
                              lambda: (F.conv2d(x, w1b, b1b, padding=1), F.conv2d(mid_up, w2b, b2b, padding=1)),
                              [5, cin, cin, cout, hh, ww]),
        }
        for role, (kernel, library, shape) in cases.items():
            bf16_rows.append({"role": role, "block": i, "shape": shape, "ms": smoke.time_ms(kernel),
                              "library_ms": smoke.time_ms(library)})
            if role == "synth_k4_bf16":  # beside K1 bf16 then K3 bf16, and whether the size rule takes it
                bf16_rows[-1]["pair_ms"] = smoke.time_ms(lambda: conv_ops.fused_upconv3x3(
                    conv_ops.fused_conv3x3(x, w1, b1, 0.2, True, w_packed=w1p), w2, b2, 0.2, True, w_packed=w2p))
                bf16_rows[-1]["takes"] = conv_ops.fused_block_fits(
                    cin, cin, cout, size=(5, hh, ww), device=dev,
                    **({"dtype": bf} if k4_tc else {}))
            y = kernel()
            bf16_bits[f"{role} {shape}"] = hashlib.sha256(y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            del y
        del x, xu, mid_up
    torch.cuda.empty_cache()

    # K4 at the blocks of synthesis that take it on an H100 (4-7), with the
    # shipped generator's weights, against K1 then K3.
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

    # Warm synthesis under the float32 and bf16 impls, in turns.
    gens = {"pallas_up": g, **{impl: load_reference_generator(
        str(ckpt), dataclasses.replace(cfg, conv_impl=impl), device=dev)
        for impl in ("pallas_block", "pallas_up_bf16", "pallas_block_bf16")}}
    z = torch.randn((5, cfg.latent_height, cfg.latent_width * 10, cfg.rand_channels),
                    generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    synths = {k: generate_mod.synthesize_fn(dataclasses.replace(cfg, conv_impl=k), cfg.n_stages - 1) for k in gens}
    for k, gg in gens.items():
        for _ in range(3):
            synths[k](gg, z)
    torch.cuda.synchronize()
    synth_by = {k: [] for k in gens}
    for k in ("pallas_up", "pallas_block", "pallas_up_bf16", "pallas_block_bf16",
              "pallas_block_bf16", "pallas_up_bf16", "pallas_block", "pallas_up"):
        for _ in range(10):
            t0 = time.perf_counter()
            synths[k](gens[k], z)
            torch.cuda.synchronize()
            synth_by[k].append(time.perf_counter() - t0)
    synth_s = synth_by["pallas_up"]
    del g, gens
    torch.cuda.empty_cache()

    # The train step.
    state = init_train_state(0, cfg_gp, tcfg, device="cuda")
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

    step_d, step_dg = build_step(7, False, cfg_gp, tcfg), build_step(7, True, cfg_gp, tcfg)
    timed(lambda: step_d(state, x, 0.5), 2)
    timed(lambda: step_dg(state, x, 0.5), 2)
    d_s = timed(lambda: step_d(state, x, 0.5), 10)
    dg_s = timed(lambda: step_dg(state, x, 0.5), 10)
    mask = [(i + 1) % tcfg.n_critic == 0 for i in range(10)]
    chunk = build_chunk_step(0, 10, cfg_gp, tcfg)
    timed(lambda: chunk(state, x_stack, [1.0] * 10, mask), 2)
    chunk_s = timed(lambda: chunk(state, x_stack, [1.0] * 10, mask), 10)
    med = lambda v: float(np.median(v))  # noqa: E731
    n_c = tcfg.n_critic
    out = {
        "tag": args.tag, "root": str(root), "card": card, "rows": rows, "host_per_call": host,
        "synthesis_ms": [1e3 * v for v in synth_s], "synthesis_median_ms": 1e3 * med(synth_s),
        "synthesis_block_ms": [1e3 * v for v in synth_by["pallas_block"]],
        "synthesis_block_median_ms": 1e3 * med(synth_by["pallas_block"]),
        "synthesis_by_impl_median_ms": {k: 1e3 * med(v) for k, v in synth_by.items()},
        "synthesis_by_impl_ms": {k: [1e3 * t for t in v] for k, v in synth_by.items()},
        "bf16_rows": bf16_rows, "bf16_bits": bf16_bits,
        "k4_blocks": blocks, "bits": bits, "wgrad": wgrad, "wgrad_bits": wgrad_bits,
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
    wsum = {part: [sum(r[k] for r in wgrad if part == "all" or r["shape"][3] <= 64) for k in ("ms", "library_ms")]
            for part in ("all", "up to 64x64")}
    out["wgrad_sums_ms"] = wsum
    bsum = {}
    for r in bf16_rows:
        s = bsum.setdefault(r["role"], [0.0, 0.0])
        s[0] += r["ms"]
        s[1] += r["library_ms"]
    out["bf16_sums_ms"] = bsum
    os.makedirs("chiprun_out", exist_ok=True)
    Path(f"chiprun_out/ab_{args.tag}.json").write_text(json.dumps(out, indent=1))
    print(f"[ab {args.tag}] {card}; conv up to 32x32, kernel / F.conv2d ms: "
          + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in small.items())
          + "; all shapes, kernel / F.conv2d ms: " + ", ".join(
              f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in sums.items())
          + "; weight gradient, kernel / cuDNN default ms: " + ", ".join(
              f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in wsum.items())
          + f"; host per call: K1 {host['k1_us']:.1f} us, F.conv2d {host['f_conv2d_us']:.1f} us"
          + "; K4 / K1 then K3 ms: " + ", ".join(
              f"block {r['block']} {r['ms']:.4f} / {r['pair_ms']:.4f}" for r in blocks)
          + "; bf16 8 blocks, kernel / F.conv2d ms: " + ", ".join(
              f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in bsum.items())
          + "; synthesis ms: " + ", ".join(
              f"{k} {v:.3f}" for k, v in out["synthesis_by_impl_median_ms"].items())
          + f"; stage 7 {1e3 * med(d_s):.2f} / "
          f"{1e3 * med(dg_s):.2f} ms = {out['steps_per_s_stage7']:.3f} steps/s; stage 0 "
          f"{out['steps_per_s_stage0']:.1f} steps/s", flush=True)


if __name__ == "__main__":
    main()
