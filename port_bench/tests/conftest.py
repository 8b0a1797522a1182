"""A throwaway benchmark root at a size the CPU runs in seconds.

Its ``BENCHMARK.json`` names the two cells of the real one, each on a
small configuration made from the real file (the shipped generator at
nb_vec 1 and 2 clips; the train step at tiny widths, stage 2, batch 4) and
keeping the real limits, and a mix of the real driver.  The metric readers
are the real ones."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SYNTH, TRAIN = "synth-offline-b20x10", "train-s7-b6"


def make_root(root: Path) -> Path:
    bench = root / "port_bench"
    for d in ("configs", "traffic", "metrics"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    synth = json.loads((REPO / "port_bench/configs/musicgan-r4-synth.json").read_text())
    synth["checkpoint"] = str(REPO / synth["checkpoint"])
    train = json.loads((REPO / "port_bench/configs/musicgan-train.json").read_text())
    train["model"].update(rand_channels=4, gen_channels=[[4, 8], [8, 8], [8, 4]],
                          disc_channels=[[4, 8], [8, 8], [8, 8], [8, 8]])
    train.update(stage=2, batch_size=4)
    files = {
        "configs/small-synth.json": synth,
        "configs/small-train.json": train,
        "traffic/small-offline.json": {"driver": "synth_offline", "clips_per_call": 2, "nb_vec": 1, "queue_ahead": 1,
                                       "warmup_calls": 1, "sampled_calls": 1, "sample_from_first": 2},
        "traffic/small-train.json": {"driver": "train_step", "alpha": 0.5, "corpus_rows": 16, "first_steps": 3,
                                     "max_iterations": 64},
    }
    for name, obj in files.items():
        (bench / name).write_text(json.dumps(obj))
    for f in (REPO / "port_bench/metrics").glob("*.py"):
        shutil.copy(f, bench / "metrics" / f.name)
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    real["configs"] = [
        {"name": "small-synth", "source": "x", "file": "port_bench/configs/small-synth.json", "reduced": [], "why": "x"},
        {"name": "small-train", "source": "x", "file": "port_bench/configs/small-train.json", "reduced": [], "why": "x"},
    ]
    real["workloads"] = [
        {"name": SYNTH, "config": "small-synth", "traffic": "small-offline", "chips": 1, "why": "x"},
        {"name": TRAIN, "config": "small-train", "traffic": "small-train", "chips": 1, "why": "x"},
    ]
    (root / "BENCHMARK.json").write_text(json.dumps(real))
    return root


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    from port_bench.run import prepare_environment

    root = make_root(tmp_path_factory.mktemp("bench_root"))
    prepare_environment(root)
    return root
