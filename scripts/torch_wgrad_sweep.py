#!/usr/bin/env python3
"""Time the weight-gradient kernel's two routes at the train step's shapes
on the card: the measurement behind its size rule.

    python3 scripts/torch_wgrad_sweep.py [--max-side 64]

For each trainable conv of a stage-7 iteration at batch 6
(``chip_smoke.py::train_conv_shapes``) whose image is at most
``--max-side`` pixels on a side, and a few sizes around the rule's
boundary, ``ops/conv_vjp.py::weight_grad3x3`` is run on each route of
``conv_vjp.WGRAD_ROUTES`` (forced; the plan of each printed), held to its
plain version in float64 (1e-5 of the largest value) and to its own bits
in a second call, and timed (device time of CUDA-graph replays) beside
one call of cuDNN's default algorithms.  The route the size rule
(``conv_vjp.wgrad_route``) takes is marked.  Results go to
``chiprun_out/wgrad_sweep.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

TOL = 1e-5  # relative to the largest value of the float64 result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-side", type=int, default=64)
    args = ap.parse_args()

    import torch

    from musicgan_tpu_torch.config import ModelConfig
    from musicgan_tpu_torch.ops import conv_vjp

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        sys.exit("torch_wgrad_sweep: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen, disc = smoke.train_conv_shapes(ModelConfig(), 6, 7)
    shapes = [("gen", s) for s in gen] + [("critic", s) for s in disc]
    shapes = [(r, s) for r, s in shapes if max(s[3], s[4]) <= args.max_side]
    shapes += [("edge", s) for s in [(6, 96, 96, 24, 24), (6, 64, 64, 12, 20), (2, 160, 160, 16, 16),
                                     (6, 16, 32, 16, 16), (6, 160, 160, 32, 32)]]
    rng = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for role, (b, cin, cout, h, w) in shapes:
        x = torch.randn(b, cin, h, w, generator=rng, device=dev)
        d = torch.randn(b, cout, h, w, generator=rng, device=dev) / (b * h * w) ** 0.5
        ws = (cout, cin, 3, 3)
        ref = conv_vjp.weight_grad3x3_plain(x.double(), d.double(), ws)
        row = {"role": role, "shape": [b, cin, cout, h, w], "rule": conv_vjp.wgrad_route(h, w),
               "cudnn_ms": smoke.time_ms(lambda: torch.nn.grad.conv2d_weight(x, ws, d, padding=1))}
        for route in conv_vjp.WGRAD_ROUTES:
            try:
                plan = conv_vjp.wgrad_kernel_plan(b, cin, cout, h, w, route=route)
            except ValueError:
                continue
            got = conv_vjp.weight_grad3x3(x, d, ws, route=route)
            err = ((got.double() - ref).abs().max() / ref.abs().max()).item()
            same = torch.equal(got, conv_vjp.weight_grad3x3(x, d, ws, route=route))
            if not (err <= TOL and same):
                raise AssertionError(f"{route} {(b, cin, cout, h, w)}: err {err:.2e}, same bits {same}")
            row[route] = {"ms": smoke.time_ms(lambda: conv_vjp.weight_grad3x3(x, d, ws, route=route)),
                          "err": err, "plan": plan}
        rows.append(row)
        cells = "  ".join(f"{r} {row[r]['ms']:.4f} ms ({row[r]['ms'] / row['cudnn_ms']:.2f}x)"
                          + (" *" if r == row["rule"] else "") for r in conv_vjp.WGRAD_ROUTES if r in row)
        print(f"[sweep] {role:6s} {str((b, cin, cout, h, w)):24s} cuDNN {row['cudnn_ms']:.4f} ms  {cells}",
              flush=True)
    for route in conv_vjp.WGRAD_ROUTES:
        for r in rows:
            if route in r:
                print(f"[plan]  {route:10s} {str(tuple(r['shape'])):24s} {r[route]['plan']}")
    path = [r for r in rows if r["role"] != "edge"]
    rule = sum(r[r["rule"]]["ms"] for r in path)
    print(f"[sweep] {len(path)} path shapes up to {args.max_side}x{args.max_side}: the rule's routes "
          f"{rule:.4f} ms, cuDNN {sum(r['cudnn_ms'] for r in path):.4f} ms; worst against cuDNN "
          f"{max(r[r['rule']]['ms'] / r['cudnn_ms'] for r in path):.2f}x")
    print(card)
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "wgrad_sweep.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
