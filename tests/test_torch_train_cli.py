"""The port's command line on the CPU: ``train`` under SIGTERM (exit code
75, a complete save, ``--resume``), the flags it refuses, and ``generate``
from the run directory through ``--conv-impl pallas_block``."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from musicgan_tpu_torch.audio.ingest import ShardWriter
from musicgan_tpu_torch.audio.io import load_wav
from musicgan_tpu_torch.train import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus") / "ds")
    w = ShardWriter(path, samples_per_shard=6)
    w.add(np.random.default_rng(0).uniform(-1, 1, (8, 2, 512, 512)).astype(np.float32))
    w.close()
    return path


def _meta(out, k):
    with open(os.path.join(out, "checkpoints", f"save_{k}", "meta.json")) as f:
        return json.load(f)


def test_cli_train_exits_75_on_sigterm_and_generate_reads_the_run(corpus, tmp_path):
    """``python -m musicgan_tpu_torch train`` at full width, capped at stage
    0, is sent SIGTERM once it logs: exit code 75 and a complete off-cadence
    save, from which ``--resume`` and ``generate`` go on."""
    out = str(tmp_path / "run")
    base = [sys.executable, "-u", "-m", "musicgan_tpu_torch", "train", "cli", "-i", corpus, "-o", out,
            "--device", "cpu", "--max-stage", "0", "--batch-size", "2", "--log-every", "1",
            "--save-every", "100000", "--chunk-steps", "1"]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}  # stage 0: tiny images
    proc = subprocess.Popen(base, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        deadline = time.time() + 240
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("e000 it"):
                proc.send_signal(signal.SIGTERM)
                break
            assert time.time() < deadline, "".join(lines)
        rest, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    text = "".join(lines) + rest
    assert proc.returncode == 75, text
    assert "[preempt] caught SIGTERM" in text and "exit retryable" in text
    ck = CheckpointManager(os.path.join(out, "checkpoints"))
    assert ck.saved_indices() == [0]
    meta = _meta(out, 0)
    assert meta["saver_counter"] == meta["iter_idx"] < 100000 and meta["run_name"] == "cli"

    done = subprocess.run(base + ["--resume", "--max-iters", str(meta["iter_idx"] + 2)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stdout + done.stderr
    assert f"[resume] save_0: iter={meta['iter_idx']}" in done.stdout
    # The multi-host flags wait for ROADMAP A16 and are refused; --max-restarts,
    # --profile and --debug-nans are the CLI's (tests/test_torch_supervise_profiling.py).
    for flag in (["--coordinator", "h:1"], ["--num-processes", "2"], ["--process-id", "0"]):
        bad = subprocess.run(base + flag, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert bad.returncode == 2 and "unrecognized arguments" in bad.stderr, flag
    usage = subprocess.run(base[:5] + ["--help"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert usage.returncode == 0, usage.stderr
    for flag in ("--max-restarts", "--profile", "--debug-nans"):
        assert flag in usage.stdout, flag

    wav_dir = str(tmp_path / "wav")
    gen = subprocess.run(
        [sys.executable, "-m", "musicgan_tpu_torch", "generate", out, "32", "-o", wav_dir, "-n", "1", "-m", "1",
         "--conv-impl", "pallas_block", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert gen.returncode == 0, gen.stderr
    wave, sr = load_wav(os.path.join(wav_dir, "sound_0.wav"))
    assert sr == 44100 and wave.shape == (511 * 256,) and np.isfinite(wave).all()
