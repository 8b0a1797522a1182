"""Readings that set a cell's limits: the program's, the control's, the faults'.

    python3 -m port_bench.control --workload NAME --seeds 12 --control-seeds 3

On the card, at the cell's own size, in one process.  Each reading is
judged by the cell's own comparison (``synth_offline.judge``,
``train_step.record``) with the cell's limits, and carries the harness's
``correct`` for it (:func:`port_bench.run.verdict`).  For each seed: the
program's timed path (the lower readings: the largest over the seeds);
for the first ``--control-seeds`` seeds, the control put in the program's
place (the reference in the precision below the one the configuration
states) and, for a training cell, the faults "half of the batch left out,
the mean taken over the rest" (the reference on half the rows) and "a step
that returns its state unchanged".  One JSON line a seed, then a summary
line.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import spec
from .run import Run, prepare_environment, verdict


def judged(run, compare, *args) -> dict:
    """The numbers ``compare(run, *args)`` sets in ``run.checks``, and the
    harness's ``correct`` for them."""
    run.checks = {}
    compare(run, *args)
    return {**{k: v for k, (v, _) in run.checks.items()}, "correct": verdict(run.checks)}


def synth_readings(run, seeds, control_seeds):
    """One call of the cell's size a seed.  Control: the reference's
    generator with fp8 operands and its vocoder with bf16 spectra and
    frames, in the program's place."""
    from musicgan_tpu_torch.generate import synthesize_fn

    from .drivers import synth_offline as drv
    from .drivers.common import device_generator
    from .reference import synthesis as ref
    from .reference.lower import numerics, operand_rounding

    mcfg, _, clips, shape, _, _ = drv._geometry(run)
    gen = drv.load_program(run, mcfg)
    synth = synthesize_fn(mcfg, run.config["stage"])
    box = drv.observe_images(gen)
    n_blocks = run.config["stage"] + 1
    weights = ref.load_generator(str(run.root / run.config["checkpoint"]), n_blocks, run.device)
    low_gen, low_voc = operand_rounding(run.config["control"]), operand_rounding(run.config["vocoder_control"])
    for k, seed in enumerate(seeds):
        z = torch.randn(shape, generator=device_generator(seed, 1, run.device), device=run.device)
        waves = synth(gen, z)
        row = {"seed": seed, "program": judged(run, drv.judge, [(waves, box["last"], z)])}
        del waves
        box["last"] = None
        if k < control_seeds:
            with torch.no_grad(), numerics("float32", run.device):
                image = torch.cat([ref.generator_image(weights, z[a : a + 4], n_blocks, rounding=low_gen)
                                   for a in range(0, clips, 4)])
                waves = torch.cat([ref.vocode(image[a : a + 4], rounding=low_voc) for a in range(0, clips, 4)])
            row["control"] = judged(run, drv.judge, [(waves, image, z)])
            del image, waves
        yield row


def unchanged(prog) -> tuple:
    """What a step that returns its state unchanged reads: no first
    gradient in Adam's moment and no change, the losses as they came."""
    losses, grads, changes = prog
    return (losses, {n: {k: 0.0 for k in d} for n, d in grads.items()},
            {n: {k: 0.0 for k in d} for n, d in changes.items()})


def train_readings(run, seeds, control_seeds):
    from .drivers import train_step as drv
    from .drivers.common import free_device

    for k, seed in enumerate(seeds):
        run.seed = seed
        st = drv.setup(run)
        prog = drv.first_readings(st)
        free_device(run.device)
        refr = drv.reference_steps(run, st, "float32")

        def read(got, against=refr):  # every number the cell could compare, and the verdict
            return {**drv.gaps(got, against), **judged(run, drv.record, got, against)}

        f64 = drv.reference_steps(run, st, "float64")
        row = {"seed": seed, "program": read(prog), "losses": {"program": prog[0], "reference": refr[0], "float64": f64[0]}}
        if k < control_seeds:
            row["control"] = read(drv.reference_steps(run, st, run.config["control"]))
            half = drv.reference_steps(run, st, "float32", half=True)
            row["half_batch"] = read(half)
            row["losses"]["half_batch"] = half[0]
            row["unchanged"] = read(unchanged(prog))
        # a second witness: the float32 reference itself against float64
        row["reference_vs_float64"] = read(refr, f64)
        del st
        free_device(run.device)
        yield row


SIDES = ("program", "control", "half_batch", "unchanged", "reference_vs_float64")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=7_000_000_001)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    root = Path.cwd()
    prepare_environment(root)
    cell = spec.load_cell(args.workload, root)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    run = Run(cell, args.first_seed, 0.0, False, torch.device("cuda"))
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    kind = cell.traffic["driver"]
    readings = (train_readings if kind == "train_step" else synth_readings)(run, seeds, args.control_seeds)
    summary: dict = {}
    for row in readings:
        print(json.dumps(row), flush=True)
        for side in SIDES:
            for name, v in row.get(side, {}).items():
                if isinstance(v, (float, int)):
                    summary.setdefault(side, {}).setdefault(name, []).append(v)
    out = {"workload": args.workload}
    for side, numbers in summary.items():
        pick = max if side in ("program", "reference_vs_float64") else min
        out[side] = {k: (f"{sum(v)} of {len(v)}" if k == "correct" else pick(v)) for k, v in numbers.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
