"""``train --max-restarts`` (``utils/supervise.py`` and the CLI's
``supervised_command``), ``train --profile`` (``utils/profiling.py::trace``)
and ``train --debug-nans`` (``enable_debug_mode``: the kernels' non-finite check of
``ops/nan_check.py`` and autograd's anomaly mode) of the port, on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from musicgan_tpu.utils import supervise as jax_supervise
from musicgan_tpu_torch import __main__ as cli
from musicgan_tpu_torch.audio.ingest import ShardWriter
from musicgan_tpu_torch.config import ModelConfig, TrainConfig
from musicgan_tpu_torch.ops import nan_check
from musicgan_tpu_torch.train import build_step, init_train_state
from musicgan_tpu_torch.utils import profiling, supervise
from musicgan_tpu_torch.utils.watchdog import EXIT_STALLED
from tests.tiny_cfg import TINY_MODEL

# The kernels' path (on the CPU their plain versions, which the check names
# after the kernel the card runs).
CFG = ModelConfig(rand_channels=TINY_MODEL.rand_channels, gen_channels=TINY_MODEL.gen_channels,
                  disc_channels=TINY_MODEL.disc_channels, conv_impl="pallas_gp")


@pytest.fixture
def debug_mode_restored(monkeypatch):
    """Debug mode is process-wide (as ``jax_debug_nans`` is): put it back."""
    monkeypatch.setattr(nan_check, "ENABLED", False)
    yield
    torch.autograd.set_detect_anomaly(False)


def _fake_run(codes):
    """A ``_run`` that returns the next exit code and records the command."""
    seen = []

    def run(cmd, env=None):
        seen.append(list(cmd))
        return subprocess.CompletedProcess(cmd, codes[len(seen) - 1])

    return run, seen


@pytest.mark.parametrize("codes,budget,want_rc,want_calls", [
    ([EXIT_STALLED, 0], 3, 0, 2),                        # a stall, then success
    ([3], 5, 3, 1),                                      # a real crash is not retried
    ([EXIT_STALLED] * 3, 2, EXIT_STALLED, 3),            # the budget
    ([-15, EXIT_STALLED, 0], 2, 0, 3),                   # a signal death is retried
])
def test_retry_rules_match_jax(codes, budget, want_rc, want_calls):
    results = []
    for mod in (supervise, jax_supervise):
        run, seen = _fake_run(codes)
        sleeps = []
        rc = mod.run_supervised(lambda a: ["child", str(a)], budget, _run=run, _sleep=sleeps.append)
        results.append((rc, seen, sleeps))
    assert results[0] == results[1]
    rc, seen, sleeps = results[0]
    assert rc == want_rc and [c[1] for c in seen] == [str(i) for i in range(want_calls)]
    assert sleeps == [30.0 * 2**i for i in range(want_calls - 1)]  # 30 s, doubling


def test_signal_deaths_are_not_retried_when_asked():
    run, seen = _fake_run([-9])
    assert supervise.run_supervised(lambda a: ["x"], 3, retry_signals=False, _run=run, _sleep=lambda s: None) == -9
    assert len(seen) == 1


def test_run_supervised_relaunches_a_real_child(tmp_path):
    """Child exits 75 until the sentinel exists, then 0."""
    sentinel = tmp_path / "ok"
    code = (f"import os, sys; p = {str(sentinel)!r}; "
            f"sys.exit(0) if os.path.exists(p) else (open(p, 'w').close(), sys.exit({EXIT_STALLED}))")
    calls = []

    def make_cmd(attempt):
        calls.append(attempt)
        return [sys.executable, "-c", code]

    assert supervise.run_supervised(make_cmd, max_restarts=3, _sleep=lambda s: None) == 0
    assert calls == [0, 1]


BASE = ["train", "r", "-i", "DS", "-o", "OUT", "--max-iters", "8"]


@pytest.mark.parametrize("spelling", [["--max-restarts", "3"], ["--max-restarts=3"]])
def test_cli_strips_max_restarts_in_both_spellings(spelling):
    prefix = [sys.executable, "-m", "musicgan_tpu_torch"]
    argv = BASE[:3] + spelling + BASE[3:]
    assert cli.supervised_command(argv, 0) == prefix + BASE + ["--stall-timeout", "900"]
    assert cli.supervised_command(argv, 2) == prefix + BASE + ["--stall-timeout", "900", "--resume"]
    for given in (["--stall-timeout", "60"], ["--stall-timeout=60"]):
        assert cli.supervised_command(argv + given, 1) == prefix + BASE + given + ["--resume"]
    assert cli.supervised_command(argv + ["--resume"], 1).count("--resume") == 1


def test_cli_becomes_the_supervisor(monkeypatch):
    got = {}

    def fake(make_cmd, max_restarts, **kw):
        got.update(first=make_cmd(0), second=make_cmd(1), budget=max_restarts, kw=kw)
        return 0

    monkeypatch.setattr(supervise, "run_supervised", fake)
    with pytest.raises(SystemExit) as e:
        cli.main(BASE + ["--max-restarts", "2"])
    assert e.value.code == 0 and got["budget"] == 2 and got["kw"] == {}  # the JAX CLI's 30 s backoff
    assert got["first"][3:] == BASE + ["--stall-timeout", "900"]
    assert got["second"][-1] == "--resume"
    with pytest.raises(SystemExit):  # an abbreviation would survive the strip: refused
        cli.main(BASE + ["--max-restart", "2"])


def test_trace_writes_a_chrome_trace(tmp_path):
    """The operators and the program's own spans, on one timeline."""
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("mg.test.traced"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    profiling.clear_spans()
    with open(tmp_path / "t" / profiling.TRACE_NAME) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.get("name") == "mg.test.traced" for e in events)


def _nan_batch():
    x = torch.rand(2, 2, 512, 512, generator=torch.Generator().manual_seed(0)) * 2 - 1
    x[1, 0, 5, 7] = float("nan")
    return x


def test_debug_nans_raises_at_the_first_op(debug_mode_restored):
    tcfg = TrainConfig(batch_size=2)
    state = init_train_state(0, CFG, tcfg, device="cpu")
    profiling.enable_debug_mode(nans=True)
    assert nan_check.ENABLED and torch.is_anomaly_enabled()
    build_step(1, True, CFG, tcfg)(state, torch.rand(2, 2, 512, 512) * 2 - 1, 1.0)  # clean: passes
    with pytest.raises(FloatingPointError, match=r"^fused_conv3x3: non-finite value"):
        build_step(1, True, CFG, tcfg)(state, _nan_batch(), 1.0)
    with pytest.raises(ValueError, match="disable_jit"):
        profiling.enable_debug_mode(nans=False, disable_jit=True)


def test_with_the_mode_off_no_check_runs(debug_mode_restored, monkeypatch):
    calls = []
    real = torch.isfinite
    monkeypatch.setattr(torch, "isfinite", lambda t: (calls.append(t.shape), real(t))[1])
    tcfg = TrainConfig(batch_size=2)
    state = init_train_state(0, CFG, tcfg, device="cpu")
    build_step(1, True, CFG, tcfg)(state, _nan_batch(), 1.0)  # the NaN goes through unseen
    assert calls == []
    nan_check.ENABLED = True
    state = init_train_state(0, CFG, tcfg, device="cpu")
    build_step(1, False, CFG, tcfg)(state, torch.rand(2, 2, 512, 512) * 2 - 1, 1.0)
    # stage 1: the generator's 4 convs on the fake batch, the critic's 6 (a
    # block of 2 at each of 3 depths) twice and in the penalty: one check each
    assert len(calls) > 10


def _corpus(path, nan=False):
    writer = ShardWriter(path, samples_per_shard=4)
    x = np.random.default_rng(0).uniform(-1, 1, (4, 2, 512, 512)).astype(np.float32)
    if nan:
        x[:, 1, 3, 3] = np.nan
    writer.add(x)
    writer.close()
    return path


def test_cli_profile_and_debug_nans(tmp_path, debug_mode_restored):
    """``train --profile`` writes the trace of a CPU run, the iteration's
    spans in it; ``train --debug-nans`` on a corpus with NaNs raises at the
    first op: the CLI trains under "auto", which is the library lowering on
    the CPU, whose first op is the critic's input head, a
    ``layers.conv2d``."""
    args = ["--max-iters", "1", "--batch-size", "2", "--device", "cpu"]
    trace_dir = str(tmp_path / "trace")
    cli.main(["train", "p", "-i", _corpus(str(tmp_path / "ds")), "-o", str(tmp_path / "run"),
              "--profile", trace_dir, *args])
    with open(os.path.join(trace_dir, profiling.TRACE_NAME)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    profiling.clear_spans()
    assert {"mg.train.iteration", "mg.train.critic", "mg.train.backward"} <= names
    assert not nan_check.ENABLED
    with pytest.raises(FloatingPointError, match=r"^conv2d: non-finite value"):
        cli.main(["train", "n", "-i", _corpus(str(tmp_path / "ds_nan"), nan=True), "-o",
                  str(tmp_path / "run_n"), "--debug-nans", *args])
