#!/usr/bin/env python3
"""How far two identical ``train`` runs of the PyTorch port drift apart on
one NVIDIA GPU, and whether a resumed run equals the uninterrupted one.

    python3 scripts/torch_resume_determinism.py

Full width, batch 6, the cut schedule of ``chip_smoke.py``'s train phase
(12 samples a stage, so 32 iterations pass through all eight stages) on a
seeded synthetic corpus.  Under cuDNN's default kernels: the same run
twice for 1, 2, 4, 16 and 32 iterations, the two final states compared
(what must be exact, then each network's parameters and moments in the
relative 2-norm, then the largest absolute difference).  Under
``torch.backends.cudnn.deterministic``: the same run twice, and a run
stopped at iteration 16 and resumed against the uninterrupted one.  Prints
one line per comparison.  Last, what the flag costs: warm stage-7
iterations (critic only, and critic + generator) timed under the default
kernels, the deterministic ones, the deterministic ones and the default
ones again, 10 of each kind in every turn, medians in ms.
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from musicgan_tpu_torch.audio.ingest import ShardWriter  # noqa: E402
from musicgan_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from musicgan_tpu_torch.train import build_step, init_train_state, train  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tcfg = ModelConfig(), TrainConfig(**chip_smoke.LOOP_CFG)
    work = tempfile.mkdtemp(prefix="resume_determinism_")
    ds = os.path.join(work, "ds")
    writer = ShardWriter(ds, samples_per_shard=8)
    writer.add(torch.randn(
        chip_smoke.LOOP_SAMPLES, 2, 512, 512, generator=torch.Generator().manual_seed(0)).numpy())
    writer.close()

    def run(name, n, **kw):
        with contextlib.redirect_stdout(io.StringIO()):
            return train("x", ds, os.path.join(work, name), tcfg, cfg, device="cuda", max_iters=n, **kw)

    def show(tag, a, b):
        d = chip_smoke.state_diff(a, b)
        rel = {k: float(f"{v:.2e}") for k, v in d["rel_l2"].items()}
        print(f"{tag}: exact {d['exact']}; rel L2 {rel}; max abs {d['max_abs']:.2e}", flush=True)

    for n in (1, 2, 4, 16, 32):
        show(f"default kernels, the same run twice, {n} iterations", run(f"a{n}", n), run(f"b{n}", n))
    torch.backends.cudnn.deterministic = True
    for n in (4, 32):
        show(f"cudnn.deterministic, the same run twice, {n} iterations", run(f"c{n}", n), run(f"d{n}", n))
    whole = run("e", 32)
    run("f", 16)
    show("cudnn.deterministic, resumed at 16 against uninterrupted, 32 iterations",
         whole, run("f", 32, resume=True))

    state = init_train_state(0, cfg, tcfg, device="cuda")
    x = torch.randn(tcfg.batch_size, 2, 512, 512, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    steps = [build_step(chip_smoke.TRAIN_STAGE, with_gen, cfg, tcfg) for with_gen in (False, True)]
    for flag in (False, True, True, False):
        torch.backends.cudnn.deterministic = flag
        for step in steps:  # the first call under a setting pays cuDNN's search
            chip_smoke.timed_iterations(step, state, x, 2)
        d, dg = (1e3 * float(np.median(chip_smoke.timed_iterations(step, state, x, 10))) for step in steps)
        n_c = tcfg.n_critic
        print(f"stage-7 iteration, cudnn.deterministic={flag}: critic only {d:.2f} ms, critic + generator "
              f"{dg:.2f} ms = {1e3 * n_c / ((n_c - 1) * d + dg):.3f} steps/s", flush=True)
    torch.backends.cudnn.deterministic = False


if __name__ == "__main__":
    main()
