"""The harness end to end on the CPU, past its look for a card: sound runs
come out correct, runs with the timed path broken underneath do not, and a
cell, a configuration, a mix and a metric added as new files run without
an edit to any file that is there."""

import json

import pytest
import torch

from port_bench import run as harness
from port_bench import spec

SYNTH, TRAIN = "synth-offline-b20x10", "train-s7-b6"

SEED = 2**33 + 12345  # wider than 32 bits, as the driver's are


def run(root, name, seconds=0.3, traced=False):
    result, record = harness.run_cell(spec.load_cell(name, root), SEED, seconds, traced, torch.device("cpu"))
    return result, record


@pytest.mark.parametrize("name", [SYNTH, TRAIN])
def test_sound_run_is_correct(small_root, name):
    result, record = run(small_root, name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in record.cell.end_to_end}
    assert result["attempted"] > 0 and result["failed"] == 0


def _broken_synthesis(monkeypatch, how):
    import musicgan_tpu_torch.generate as gen_mod

    real = gen_mod.synthesize_fn

    def synthesize_fn(cfg, stage=7):
        f = real(cfg, stage)

        def g(gen, z):
            w = f(gen, z).clone()
            if how == "altered":
                w[0] = w[0].flip(0)  # one answer altered where it is produced
            else:  # half of the batch left out
                w[w.shape[0] // 2 :] = 0.0
            return w

        return g

    monkeypatch.setattr(gen_mod, "synthesize_fn", synthesize_fn)


@pytest.mark.parametrize("how", ["altered", "half_batch"])
def test_synthesis_fault_is_not_correct(small_root, monkeypatch, how):
    _broken_synthesis(monkeypatch, how)
    result, _ = run(small_root, SYNTH)
    assert not result["correct"], result["checks"]


def _broken_step(monkeypatch, how):
    import musicgan_tpu_torch.train.step as step_mod

    real = step_mod.build_step

    def build_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def broken(state, data, idx, alpha, noise=None):
            if how == "unchanged":  # the work is done on a copy; the state comes back as it was
                return state, step(state.clone(), data, idx, alpha, noise=noise)[1]
            half = len(idx) // 2  # half of the batch left out, the mean taken over the rest
            return step(state, data, idx[:half], alpha, noise=tuple(t[:half] for t in noise))

        return broken

    monkeypatch.setattr(step_mod, "build_step", build_step)


@pytest.mark.parametrize("how", ["unchanged", "half_batch"])
def test_train_fault_is_not_correct(small_root, monkeypatch, how):
    _broken_step(monkeypatch, how)
    result, _ = run(small_root, TRAIN)
    assert not result["correct"], result["checks"]


def test_a_cell_added_as_new_files_runs(small_root, tmp_path):
    """A new mix, configuration and metric under a throwaway root, and the
    new cell and metric entries in its BENCHMARK.json: nothing else."""
    root = tmp_path
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "metrics"):
        (root / "port_bench" / sub).mkdir(parents=True)
    cfg = json.loads((small_root / "port_bench/configs/small-synth.json").read_text())
    (root / "port_bench/configs/new-synth.json").write_text(json.dumps(cfg))
    (root / "port_bench/traffic/new-mix.json").write_text(json.dumps(
        {"driver": "synth_offline", "clips_per_call": 1, "nb_vec": 1, "queue_ahead": 1, "warmup_calls": 1,
         "sampled_calls": 1, "sample_from_first": 1}))
    (root / "port_bench/metrics/calls.new.py").write_text(
        '"""Calls completed in the window."""\n\n\ndef read(run):\n    return run.facts.get("calls_completed")\n')
    bench["configs"].append({"name": "new-synth", "source": "x", "file": "port_bench/configs/new-synth.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-cell", "config": "new-synth", "traffic": "new-mix", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("new-cell")
    bench["per_layer"].append({"name": "calls.new", "unit": "calls", "better": "higher", "source": "program_counter",
                               "layer": "synthesis entry and autotuner", "moves": "synth_audio_s_per_s",
                               "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("new-cell", root)
    assert [m["name"] for m in cell.per_layer] == ["calls.new"]
    result, record = harness.run_cell(cell, SEED, 0.2, True, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["metrics"]["calls.new"]["value"] == record.facts["calls_completed"] >= 1
