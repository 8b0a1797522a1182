"""Readings that set the GANSynth cell's limits: the program's, the
controls', the fault's.

    python3 -m port_bench.control_gansynth --workload gansynth-bank-b122 --seeds 12 --control-seeds 3

On the card, at the cell's own size, in one process.  Each reading is one
call of the cell's size (weights and latents from the seed) judged by the
cell's own comparison (``drivers/gansynth_bank.py::judge``) with the
cell's limits, and carries the harness's ``correct`` for it.  For each
seed, the program's timed path (the lower readings: the largest over the
seeds); for the first ``--control-seeds`` seeds, in the program's place:

* ``fp8_generator``: the reference generator with fp8 operands (the
  precision below the configuration's bf16), its image vocoded by the
  float32 reference;
* ``bf16_vocoder``: the float32 reference's image vocoded with bf16 spectra,
  products and frames (the precision below the vocoder's float32);
* ``pitch_dropped``: the program with the pitch's one-hot left out of its
  input (``models/generator.py::condition``).

One JSON line a seed, then a summary line.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

import torch

from . import spec
from .control import judged
from .run import Run, prepare_environment

SIDES = ("program", "fp8_generator", "bf16_vocoder", "pitch_dropped")


def dropped(x: torch.Tensor, labels, n_classes: int) -> torch.Tensor:
    """The latent joined by zeros where the one-hot belongs."""
    return torch.cat([x, x.new_zeros(x.shape[0], n_classes)], dim=1)


def readings(run, seeds, control_seeds):
    from musicgan_tpu_torch.generate import synthesize_fn
    from musicgan_tpu_torch.models import generator as generator_module

    from .drivers import gansynth_bank as drv
    from .drivers.common import device_generator, free_device
    from .drivers.synth_offline import observe_images
    from .reference import gansynth as ref
    from .reference.lower import numerics, operand_rounding

    mcfg = drv.model_config(run.config)
    acfg = mcfg.audio_config
    synth = synthesize_fn(mcfg, int(run.config["stage"]))
    low_gen, low_voc = operand_rounding(run.config["control"]), operand_rounding(run.config["vocoder_control"])
    shape = (int(run.traffic["instruments"]), 1, 1, mcfg.rand_channels)

    def reference(z, labels, weights, gen_rounding, voc_rounding):
        with torch.no_grad(), numerics("float32", run.device):
            image = torch.cat([ref.generator_image(weights, z[a : a + 8], labels[a : a + 8], mcfg.n_classes,
                                                   mcfg.leaky_slope, mcfg.pixel_norm_eps, gen_rounding)
                               for a in range(0, len(z), 8)])
            waves = torch.cat([ref.vocode(image[a : a + 8], acfg.n_fft, acfg.stft_stride, acfg.sample_rate,
                                          acfg.crop, voc_rounding) for a in range(0, len(z), 8)])
        return waves, image

    for k, seed in enumerate(seeds):
        run.seed = seed
        weights = drv.reference_weights(run, mcfg)
        gen = drv.load_program(run, mcfg, weights)
        box = observe_images(gen)
        latents = torch.randn(shape, generator=device_generator(seed, 1, run.device), device=run.device)
        z, labels = drv.call_inputs(run, latents)
        waves = synth(gen, z, labels)
        row = {"seed": seed, "program": judged(run, drv.judge, [(waves, box["last"], latents)], weights)}
        if k < control_seeds:
            with mock.patch.object(generator_module, "condition", dropped):
                waves = synth(gen, z, labels)
            row["pitch_dropped"] = judged(run, drv.judge, [(waves, box["last"], latents)], weights)
            del gen, box, waves
            waves, image = reference(z, labels, weights, low_gen, None)
            row["fp8_generator"] = judged(run, drv.judge, [(waves, image, latents)], weights)
            waves, image = reference(z, labels, weights, None, low_voc)
            row["bf16_vocoder"] = judged(run, drv.judge, [(waves, image, latents)], weights)
        del waves
        free_device(run.device)
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.control_gansynth")
    ap.add_argument("--workload", default="gansynth-bank-b122")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=7_000_000_001)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    root = Path.cwd()
    prepare_environment(root)
    cell = spec.load_cell(args.workload, root)
    if not torch.cuda.is_available():
        print("port_bench.control_gansynth: no CUDA device", file=sys.stderr)
        return 2
    run = Run(cell, args.first_seed, 0.0, False, torch.device("cuda"))
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    summary: dict = {}
    for row in readings(run, seeds, args.control_seeds):
        print(json.dumps(row), flush=True)
        for side in SIDES:
            for name, v in row.get(side, {}).items():
                summary.setdefault(side, {}).setdefault(name, []).append(v)
    out = {"workload": args.workload}
    for side, numbers in summary.items():
        pick = max if side == "program" else min
        out[side] = {k: (f"{sum(v)} of {len(v)}" if k == "correct" else pick(v)) for k, v in numbers.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
