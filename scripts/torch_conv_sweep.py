#!/usr/bin/env python3
"""Sweep the conv template's launch plans on the card: at every conv shape
of a stage-7 train iteration (batch 6) from 16x16 to 128x128 and at
synthesis's eight blocks (5 clips x nb_vec 10), the device time of the
wrapper under each plan, against the launcher's own choice and
``F.conv2d``.

    python3 scripts/torch_conv_sweep.py [--part fp32|bf16|k4bf16|k4wide|all]

Plans: the large-image shape (the tensor-core route, "large_tc"), and the
small-image shape at every (pixels a lane in 1, 2, 4) x (cluster split over
input channels in 1, 2, 4, 8) that the cluster allows.  The script builds the kernels with
``-DMG_CONV_SWEEP``, which compiles in ``mg_conv_force`` (a switch that
forces the plan of every later launch) and gives the libraries other
names; the libraries the port loads have no such switch (the other parts
use those).  Weights are packed
ahead; times are CUDA-graph replays timed by CUDA events
(``chip_smoke.time_ms``).  This is what the launcher's rule
(``csrc/conv_tile.cuh::plan_conv``) was fitted to.  Every plan's output is
held against the plain version at 1e-4.  Results go to
``chiprun_out/conv_sweep.json``.

The bf16 part (K1 bf16 and K3 bf16, ``csrc/conv_bf16.cuh``) times, at
synthesis's 16 shapes and a few ragged ones, the size rule's tile
(``ops/conv_bf16.py::plan``) against each route forced and a set of tile
widths forced within each (the wrappers' ``route`` and ``tc``: no special
build), with ``F.conv2d`` on bf16 tensors beside; every forced plan is held
within one bf16 ulp of the plain version and to the size rule's bits (every
tile sums a pixel in one order).  Results go to
``chiprun_out/conv_sweep_bf16.json``.

The k4bf16 part (K4 bf16, ``csrc/block_bf16.cuh``) times, at synthesis's
8 blocks and a ragged one, the size rule's plan (``ops/conv_bf16.py::
block_plan``) against every strip width and a set of run lengths forced
(the wrapper's ``tc`` and ``run``; residency and warpgroups as the rule
picks them for that strip and run), beside K1 bf16 then K3 bf16 and the
rule's modelled costs of both: what the rule's constants (``NWG_EIGHTHS``
and the fixed clocks) were fitted to.  Every plan is held to the pair's
bits.  Results go to ``chiprun_out/conv_sweep_k4bf16.json``.

The k4wide part (K4 bf16 past 128 channels) times, at the eight blocks of
``chip_smoke.py``'s generator past 128 channels (``WIDE_GEN_CHANNELS``, 5
clips x nb_vec 10 at stage 7), at ``WIDE_BLOCK``, ``THREE_RANK_BLOCK``,
three wider shapes and ``TEMPLATE_BLOCK``: the cluster route
(``csrc/block3x3_bf16_wide.cu``) under the size rule's plan, the template
(``csrc/block3x3_bf16_template.cu``, ``block3x3.cuh`` at bf16, launched
at every shape through ``fused_block`` with its route forced to it and
its own weight layout made ahead), K1 bf16 then K3 bf16 and two bf16
``F.conv2d``, in ``--rounds`` rounds of the four one after another,
beside the rule's modelled costs and ``takes``: what
``CLUSTER_WAVE_TWENTIETHS`` was fitted to.  The cluster is held to the
pair's bits, the template to the pair in the relative 2-norm (1e-2).
Results go to ``chiprun_out/conv_sweep_k4wide.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (THREE_RANK_BLOCK, TEMPLATE_BLOCK, WIDE_BLOCK, WIDE_GEN_CHANNELS,  # noqa: E402
                        card_line, rel_l2, time_ms, train_conv_shapes)
from musicgan_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from musicgan_tpu_torch.models.layers import upsample_nearest_2x  # noqa: E402
from musicgan_tpu_torch.ops import _build  # noqa: E402
from musicgan_tpu_torch.ops import conv as conv_ops  # noqa: E402
from musicgan_tpu_torch.ops import conv_bf16  # noqa: E402

TOL = 1e-4
# Tile widths the bf16 part forces (where a tile of that width fits).
BF16_TC = (16, 32, 48, 64, 80, 96, 128, 160, 240)
# Ragged bf16 shapes (B, cin, cout, H, W): W no multiple of 8 or of 64,
# channels no multiple of 16, one image.
BF16_RAGGED = [(2, 12, 20, 9, 33), (1, 24, 40, 64, 70), (3, 21, 20, 96, 130), (2, 5, 7, 130, 300)]


def force_plan(shape: int = 0, pixels_a_lane: int = 0, split_k: int = 0) -> None:
    """Make K1-K3 take one shape (1 large, 2 small) and, for the small one,
    pixels a lane and a cluster split over input channels; 0 for each
    restores the launcher's own choice."""
    for kind in ("conv3x3", "upconv3x3"):
        fn = _build.load(kind).mg_conv_force
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = None
        fn(shape, pixels_a_lane, split_k)


def cases(cfg: ModelConfig) -> list:
    """``(role, kind, (B, cin, cout, H, W), bias, slope, pixel_norm)``."""
    gen, disc = train_conv_shapes(cfg, TrainConfig().batch_size, 7)
    swept = lambda shapes: [s for s in shapes if 16 <= s[3] <= 128]  # noqa: E731
    swap = lambda s: (s[0], s[2], s[1], s[3], s[4])  # noqa: E731
    out = [("critic_fwd", "conv", s, True, 0.2, False) for s in swept(disc)]
    out += [("critic_dx", "conv", swap(s), False, None, False) for s in swept(disc)]
    out += [("gen_fwd", "msq", s, True, 0.2, True) for s in swept(gen)]
    out += [("gen_dx", "conv", swap(s), False, None, False) for s in swept(gen[1:])]
    for i, (c, o) in enumerate(cfg.gen_channels):
        h, w = cfg.latent_height * 2**i, cfg.latent_width * 10 * 2**i
        out += [("synth_k1", "conv", (5, c, c, h, w), True, 0.2, True),
                ("synth_k3", "up", (5, c, o, h, w), True, 0.2, True)]
    return out


def sweep_bf16(card: str, dev) -> None:
    """K1 bf16 / K3 bf16 under the size rule's plan, each route and tile
    width forced, beside F.conv2d on bf16 tensors."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = torch.Generator(device=dev).manual_seed(0)
    cfg = ModelConfig()
    shapes = []
    for i, (c, o) in enumerate(cfg.gen_channels):
        h, w = cfg.latent_height * 2**i, cfg.latent_width * 10 * 2**i
        shapes += [("synth_k1", 3, (5, c, c, h, w)), ("synth_k3", 2, (5, c, o, h, w))]
    shapes += [(f"ragged_k{1 if k == 3 else 3}", k, s) for s in BF16_RAGGED for k in (3, 2)]
    rows = []
    for role, k, (b, cin, cout, h, w) in shapes:
        x = torch.randn(b, cin, h, w, generator=rng, device=dev).to(torch.bfloat16)
        wt = torch.randn(cout, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
        bb = torch.randn(cout, generator=rng, device=dev) * 0.1
        wp = conv_ops.kernel_weights_tc(wt, k == 2)
        fn = conv_ops.fused_conv3x3 if k == 3 else conv_ops.fused_upconv3x3
        xl = upsample_nearest_2x(x) if k == 2 else x
        ref = (conv_ops.conv3x3_plain if k == 3 else conv_ops.upconv3x3_plain)(x, wt, bb, 0.2, True)
        rule = conv_bf16.plan(k, b, cin, cout, h, w, True, sms)
        want = fn(x, wt, bb, 0.2, True, w_packed=wp, out_dtype=torch.bfloat16)
        plans = {}
        for route in conv_bf16.routes_for(k, b, cin, cout, h, w, True, sms):
            for tc in (0, *BF16_TC):
                try:
                    p = conv_bf16.plan(k, b, cin, cout, h, w, True, sms, conv_bf16.ROUTE_CODES[route], tc)
                except ValueError:
                    continue
                name = f"{route.split('_')[0]}:{p['nb']}x{p['th']}x{p['tc']}"
                if name in plans:
                    continue
                run = lambda: fn(x, wt, bb, 0.2, True, w_packed=wp, route=route, tc=p["tc"],  # noqa: E731
                                 out_dtype=torch.bfloat16)
                got = run()
                a, r = got.float(), ref.float()
                if ((a - r).abs() > 2.0**-7 * torch.maximum(a.abs(), r.abs()) + 1e-5).any():
                    raise AssertionError(f"{role} {(b, cin, cout, h, w)} plan {name}: past one bf16 ulp")
                if not torch.equal(got, want):
                    raise AssertionError(f"{role} {(b, cin, cout, h, w)} plan {name}: not the size rule's bits")
                plans[name] = time_ms(run)
        chosen = f"{rule['route'].split('_')[0]}:{rule['nb']}x{rule['th']}x{rule['tc']}"
        best = min(plans, key=plans.get)
        row = {"role": role, "shape": [b, cin, cout, h, w], "chosen": chosen,
               "chosen_ms": time_ms(lambda: fn(x, wt, bb, 0.2, True, w_packed=wp, out_dtype=torch.bfloat16)), "best": best,
               "best_ms": plans[best], "library_ms": time_ms(lambda: F.conv2d(xl, wt.to(torch.bfloat16),
                                                                         bb.to(torch.bfloat16), padding=1)),
               "plans_ms": plans}
        rows.append(row)
        print(f"[sweep bf16] {role:10s} {str((b, cin, cout, h, w)):24s} chosen {chosen:14s} "
              f"{row['chosen_ms'] * 1e3:7.1f} us  best {best:14s} {row['best_ms'] * 1e3:7.1f}  F.conv2d "
              f"{row['library_ms'] * 1e3:7.1f} | " + " ".join(f"{n} {v * 1e3:.0f}" for n, v in plans.items()),
              flush=True)
        del x, xl, ref, want
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "conv_sweep_bf16.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))


def sweep_k4_bf16(card: str, dev) -> None:
    """K4 bf16 under the size rule's plan and each strip width and run
    length forced, beside K1 bf16 then K3 bf16."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = torch.Generator(device=dev).manual_seed(0)
    cfg = ModelConfig()
    shapes = [(5, c, c, o, cfg.latent_height * 2**i, cfg.latent_width * 10 * 2**i)
              for i, (c, o) in enumerate(cfg.gen_channels)] + [(3, 21, 40, 24, 70, 330)]
    rows = []
    for b, cin, cmid, cout, h, w in shapes:
        x = torch.randn(b, cin, h, w, generator=rng, device=dev).to(torch.bfloat16)
        w1 = torch.randn(cmid, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
        w2 = torch.randn(cout, cmid, 3, 3, generator=rng, device=dev) / (9 * cmid) ** 0.5
        b1, b2 = (torch.randn(c, generator=rng, device=dev) * 0.1 for c in (cmid, cout))
        w1p, w2p = conv_ops.kernel_weights_tc(w1), conv_ops.kernel_weights_tc(w2, True)

        def pair():
            mid = conv_ops.fused_conv3x3(x, w1, b1, 0.2, True, w_packed=w1p, out_dtype=torch.bfloat16)
            return conv_ops.fused_upconv3x3(mid, w2, b2, 0.2, True, w_packed=w2p, out_dtype=torch.bfloat16)

        want = pair()
        rule = conv_bf16.block_plan(b, cin, cmid, cout, h, w, sms)
        geo = conv_bf16.block_geometry(cmid, cout)
        plans = {}
        for tc in range(min(geo["max_tc"], -(-w // 16) * 16), 0, -16):
            for run in sorted({0, *(r for r in (h // 16, h // 8, h // 4, h // 2, h) if r >= 1)}):
                try:
                    p = conv_bf16.block_plan(b, cin, cmid, cout, h, w, sms, tc=tc, run=run)
                except ValueError:
                    continue
                name = f"{p['tc']}x{p['run']}:{p['nwg']}wg"
                if name in plans:
                    continue
                fn = lambda: conv_ops.fused_block(x, w1, b1, w2, b2, w1_packed=w1p, w2_packed=w2p,  # noqa: E731
                                                  tc=p["tc"], run=p["run"], out_dtype=torch.bfloat16)
                if not torch.equal(fn(), want):
                    raise AssertionError(f"K4 bf16 {(b, cin, cmid, cout, h, w)} plan {name}: not the pair's bits")
                plans[name] = {"ms": time_ms(fn), "cost": p["cost"]}
        chosen = f"{rule['tc']}x{rule['run']}:{rule['nwg']}wg"
        best = min(plans, key=lambda k: plans[k]["ms"])
        row = {"shape": [b, cin, cmid, cout, h, w], "chosen": chosen,
               "chosen_ms": time_ms(lambda: conv_ops.fused_block(x, w1, b1, w2, b2, w1_packed=w1p, w2_packed=w2p,
                                                                 out_dtype=torch.bfloat16)),
               "best": best, "best_ms": plans[best]["ms"], "pair_ms": time_ms(pair), "cost": rule["cost"],
               "pair_cost": rule["pair_cost"], "takes": rule["takes"], "plans": plans}
        rows.append(row)
        print(f"[sweep k4bf16] {str((b, cin, cmid, cout, h, w)):30s} chosen {chosen:12s} {row['chosen_ms']:.4f} ms  "
              f"best {best:12s} {row['best_ms']:.4f}  pair {row['pair_ms']:.4f}  takes {rule['takes']} (cost "
              f"{rule['cost']} / pair {rule['pair_cost']} = {rule['cost'] / rule['pair_cost']:.2f}; measured "
              f"{row['chosen_ms'] / row['pair_ms']:.2f}) | "
              + " ".join(f"{n} {v['ms']:.3f}" for n, v in plans.items()), flush=True)
        del x, want
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "conv_sweep_k4bf16.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))


def k4_wide_shapes() -> list:
    """(B, cin, cmid, cout, H, W) of the k4wide part."""
    cfg = ModelConfig()
    gen = [(5, c, c, o, cfg.latent_height * 2**i, cfg.latent_width * 10 * 2**i)
           for i, (c, o) in enumerate(WIDE_GEN_CHANNELS)]
    return gen + [WIDE_BLOCK, THREE_RANK_BLOCK, (5, 512, 512, 512, 4, 40), (5, 384, 384, 384, 16, 160),
                  (2, 256, 256, 256, 64, 640), TEMPLATE_BLOCK]


def sweep_k4_wide(card: str, dev, rounds: int) -> None:
    """K4 bf16 past 128 channels: the cluster route, the template, the pair
    and the library, ``rounds`` times each in turn."""
    from unittest import mock

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    rows = []
    for b, cin, cmid, cout, h, w in k4_wide_shapes():
        route = conv_bf16.block_route(cmid, cout, cin)
        x = torch.randn(b, cin, h, w, generator=rng, device=dev).to(bf)
        w1 = torch.randn(cmid, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
        w2 = torch.randn(cout, cmid, 3, 3, generator=rng, device=dev) / (9 * cmid) ** 0.5
        b1, b2 = (torch.randn(c, generator=rng, device=dev) * 0.1 for c in (cmid, cout))
        w1t, w2t = conv_ops.kernel_weights_tc(w1), conv_ops.kernel_weights_tc(w2, True)
        w1k, w2k = conv_ops.kernel_weights(w1, bf), conv_ops.kernel_upconv_weights(w2, bf)
        w1b, b1b, w2b, b2b = (t.to(bf) for t in (w1, b1, w2, b2))
        mid_up = upsample_nearest_2x(conv_ops.fused_conv3x3(x, w1, b1, 0.2, True, w_packed=w1t, out_dtype=bf))

        def pair():
            mid = conv_ops.fused_conv3x3(x, w1, b1, 0.2, True, w_packed=w1t, out_dtype=bf)
            return conv_ops.fused_upconv3x3(mid, w2, b2, 0.2, True, w_packed=w2t, out_dtype=bf)

        def cluster():
            return conv_ops.fused_block(x, w1, b1, w2, b2, w1_packed=w1t, w2_packed=w2t, out_dtype=bf)

        def template():
            with mock.patch.object(conv_bf16, "block_route", lambda *a: "template"):
                return conv_ops.fused_block(x, w1, b1, w2, b2, w1_packed=w1k, w2_packed=w2k, out_dtype=bf)

        def library():
            F.conv2d(x, w1b, b1b, padding=1)
            return F.conv2d(mid_up, w2b, b2b, padding=1)

        want = pair()
        fns = {"template": template, "pair": pair, "library": library}
        row = {"shape": [b, cin, cmid, cout, h, w], "route": route,
               "template_l2_vs_pair": rel_l2(template().float(), want.float())}
        if not row["template_l2_vs_pair"] <= 1e-2:
            raise AssertionError(f"the template at {row['shape']}: {row['template_l2_vs_pair']:.2e} from the pair")
        if route == "bf16_cluster":
            plan = conv_bf16.block_plan(b, cin, cmid, cout, h, w, sms)
            row.update(cost=plan["cost"], pair_cost=plan["pair_cost"], takes=plan["takes"],
                       cluster_plan={k: plan[k] for k in ("cluster", "tc", "run", "units", "blocks", "stages")})
            if not torch.equal(cluster(), want):
                raise AssertionError(f"the cluster route at {row['shape']}: not the pair's bits")
            fns = {"cluster": cluster, **fns}
        times = {k: [] for k in fns}
        for _ in range(rounds):
            for k, fn in fns.items():
                times[k].append(time_ms(fn))
        row["ms"] = times
        row["median_ms"] = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        rows.append(row)
        med = row["median_ms"]
        line = " ".join(f"{k} {med[k]:.4f}" for k in fns)
        extra = ""
        if route == "bf16_cluster":
            wins = sum(c < p for c, p in zip(times["cluster"], times["pair"]))
            extra = (f"; cluster / pair {med['cluster'] / med['pair']:.3f} (below in {wins} of {rounds} rounds), "
                     f"cluster / template {med['cluster'] / med['template']:.3f}, modelled "
                     f"{row['cost'] / row['pair_cost']:.3f}, takes {row['takes']}")
        print(f"[sweep k4wide] {str(tuple(row['shape'])):34s} {route:12s} median ms: {line}{extra}", flush=True)
        del x, want, mid_up
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "conv_sweep_k4wide.json").write_text(json.dumps({"card": card, "rounds": rounds, "rows": rows},
                                                           indent=1))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("fp32", "bf16", "k4bf16", "k4wide", "all"), default="all")
    ap.add_argument("--rounds", type=int, default=5, help="k4wide: rounds of the four calls timed in turn")
    args = ap.parse_args()
    part = args.part
    if not torch.cuda.is_available():
        sys.exit("torch_conv_sweep: no CUDA device")
    if part in ("fp32", "all"):  # mg_conv_force, in libraries of other names
        _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DMG_CONV_SWEEP")
    card = card_line()
    print(f"[card] {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    if part in ("bf16", "all"):
        sweep_bf16(card, dev)
    if part in ("k4bf16", "all"):
        sweep_k4_bf16(card, dev)
    if part in ("k4wide", "all"):
        sweep_k4_wide(card, dev, args.rounds)
    if part in ("bf16", "k4bf16", "k4wide"):
        return
    rng = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for role, kind, (b, cin, cout, h, w), bias, slope, pn in cases(ModelConfig()):
        x = torch.randn(b, cin, h, w, generator=rng, device=dev)
        wt = torch.randn(cout, cin, 3, 3, generator=rng, device=dev) / (9 * cin) ** 0.5
        bb = torch.randn(cout, generator=rng, device=dev) * 0.1 if bias else None
        if kind == "up":
            wp, xl = conv_ops.kernel_upconv_weights(wt), upsample_nearest_2x(x)
            kernel = lambda: conv_ops.fused_upconv3x3(x, wt, bb, slope, pn, w_packed=wp)  # noqa: E731
            ref = conv_ops.upconv3x3_plain(x, wt, bb, slope, pn)
        else:
            wp, xl = conv_ops.kernel_weights(wt), x
            if kind == "msq":
                kernel = lambda: conv_ops.fused_conv3x3_msq(x, wt, bb, slope, w_packed=wp)[0]  # noqa: E731
            else:
                kernel = lambda: conv_ops.fused_conv3x3(x, wt, bb, slope, pn, w_packed=wp)  # noqa: E731
            ref = conv_ops.conv3x3_plain(x, wt, bb, slope, pn)
        plan = conv_ops.conv_plan("upconv3x3" if kind == "up" else "conv3x3", b, cin, cout, h, w, pn)
        chosen = "large" if plan["shape"] == "large" else f"p{plan['pixels_a_lane']}s{plan['split_k']}"
        plans = {}
        forced = [("large", 1, 0, 0)] + [(f"p{p}s{s}", 2, p, s) for p in (1, 2, 4) for s in (1, 2, 4, 8)]
        try:
            for name, shape, p, s in forced:
                force_plan(shape, p, s)
                try:
                    err = (kernel() - ref).abs().max().item()
                except RuntimeError:  # a split the cluster cannot hold
                    continue
                if not err <= TOL:
                    raise AssertionError(f"{role} {(b, cin, cout, h, w)} plan {name}: err {err:.2e}")
                plans[name] = time_ms(kernel)
        finally:
            force_plan(0)
        best = min(plans, key=plans.get)
        row = {"role": role, "shape": [b, cin, cout, h, w], "chosen": chosen, "chosen_ms": time_ms(kernel),
               "best": best, "best_ms": plans[best], "library_ms": time_ms(lambda: F.conv2d(xl, wt, bb, padding=1)),
               "plans_ms": plans}
        rows.append(row)
        print(f"[sweep] {role:10s} {str((b, cin, cout, h, w)):24s} chosen {chosen:5s} {row['chosen_ms'] * 1e3:7.1f} us"
              f"  best {best:5s} {row['best_ms'] * 1e3:7.1f}  F.conv2d {row['library_ms'] * 1e3:7.1f} | "
              + " ".join(f"{k} {v * 1e3:.0f}" for k, v in plans.items()), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "conv_sweep.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
