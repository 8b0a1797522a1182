"""A two-process data-parallel run's failure and growth contracts on the CPU
(gloo): a preemption signal to one rank stops both at one boundary with one
flushed save, streaming ingest agrees on one snapshot per epoch, SIGTERM
gives exit 75 on both ranks and ``--resume`` continues bit for bit, and the
``train`` command line's ``--coordinator`` / ``--num-processes`` /
``--process-id`` (counterparts of ``tests/test_multihost.py``'s).

The ranks run ``tests/test_torch_multihost.py``'s entry point with the
modes of :func:`rank_mode` below; each rank has its own timeout."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tests.test_torch_multihost import (
    ROOT,
    finish,
    free_port,
    launch,
    leaves,
    load_state,
    port_cfg,
    synth_dataset,
    tiny_cfg_json,
)

WAIT_S = 240  # for a rank's first logged iteration, or a log line's arrival
# A long run that only a signal stops: batch 8, a log line an iteration.
LONG_KW = dict(batch_size=8, save_every=10**6, log_every=1, nb_preview=1, chunk_steps=1, seed=0)


def _wait_for(path: str, procs, ready=lambda text: bool(text)) -> None:
    """Until ``ready`` holds of the file at ``path`` (a rank's progress),
    failing early if a rank has exited."""
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        try:
            with open(path) as f:
                if ready(f.read()):
                    return
        except OSError:
            pass
        if any(p.poll() is not None for p in procs):
            outs = finish(procs)
            raise AssertionError("a rank exited early:\n" + "\n".join(o[-3000:] for o in outs))
        time.sleep(0.2)
    finish(procs, timeout=1)
    raise AssertionError(f"no progress in {path} before the deadline")


def test_two_process_preemption_agrees_collectively(tmp_path):
    """SIGUSR1 to the non-lead rank only: the per-boundary agreement stops
    both at one iteration, they flush ONE off-cadence save together, and
    both return from ``train`` with the flag set."""
    from musicgan_tpu_torch.config import TrainConfig
    from musicgan_tpu_torch.train import CheckpointManager

    ds = synth_dataset(str(tmp_path / "ds"))
    out = str(tmp_path / "out")
    cfg_json = tiny_cfg_json()
    procs = launch("preempt", out, cfg_json, ds)
    _wait_for(os.path.join(out, "metrics.csv"), procs)
    procs[1].send_signal(signal.SIGUSR1)
    outs = finish(procs)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    stopped = [int(o.split("preempted at iter ")[1].split()[0]) for o in outs]
    assert stopped[0] == stopped[1] >= 1
    ckpt = CheckpointManager(os.path.join(out, "checkpoints"))
    assert ckpt.saved_indices() == [0]
    state = load_state(os.path.join(out, "checkpoints", "save_0"), port_cfg(cfg_json), TrainConfig(**LONG_KW))
    assert int(state.iter_idx) == stopped[0]
    assert all(torch.isfinite(v).all() for k, v in leaves(state).items() if v.is_floating_point())


@pytest.mark.parametrize("opened", ["same", "divergent"])
def test_two_process_streaming_ingest_agrees_on_snapshot(tmp_path, opened):
    """Each rank reads its own copy of a dataset still being written, and
    the copies grow at different times (``same``: both open at 16 rows;
    ``divergent``: one opens at 24, the other at 16).  The per-epoch
    agreement (the least offered count, then the least realized one) keeps
    the two ranks' views equal at every epoch, so their batches, and their
    collectives, match: the first agreement clamps to 16 and the last sees
    32 (``tests/test_multihost.py``'s two streaming cases)."""
    from musicgan_tpu_torch.audio.ingest import ShardWriter

    rng = np.random.default_rng(0)
    first = rng.uniform(-1, 1, (24, 2, 512, 512)).astype(np.float32)
    second = rng.uniform(-1, 1, (8, 2, 512, 512)).astype(np.float32)
    ds = tmp_path / "ds"
    writers = [ShardWriter(str(ds / str(r)), samples_per_shard=8) for r in range(2)]
    writers[0].add(first if opened == "divergent" else first[:16])
    writers[1].add(first[:16])
    out = str(tmp_path / "out")
    procs = launch("stream", out, tiny_cfg_json(), str(ds))
    _wait_for(os.path.join(out, "metrics.csv"), procs)
    # grow the two copies to 32 rows at different times: the skew is what
    # the agreement exists for
    if opened == "same":
        writers[0].add(first[16:])
    writers[0].add(second)
    writers[0].close()
    time.sleep(1.0)
    writers[1].add(first[16:])
    writers[1].add(second)
    writers[1].close()
    logs = [os.path.join(out, f"sizes_{r}.log") for r in range(2)]
    for log in logs:  # both ranks saw the whole corpus: stop them
        _wait_for(log, procs, lambda text: text.split()[-1:] == ["32"])
    procs[0].send_signal(signal.SIGUSR1)
    outs = finish(procs)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    sizes = [[int(x) for x in open(log).read().split()] for log in logs]
    assert sizes[0] == sizes[1], sizes
    assert sizes[0][0] == 16 and sizes[0][-1] == 32, sizes


def test_two_process_sigterm_exit75_then_bitexact_resume(tmp_path):
    """SIGTERM to the lead mid-run: the agreement flushes ONE common save
    and EVERY rank exits 75 (the supervisor's retry code); the relaunch
    with resume finishes bit for bit where an uninterrupted two-process run
    lands (``tests/test_multihost.py``'s production failure contract)."""
    from musicgan_tpu_torch.config import TrainConfig
    from musicgan_tpu_torch.train import CheckpointManager
    from musicgan_tpu_torch.utils.watchdog import EXIT_STALLED

    ds = synth_dataset(str(tmp_path / "ds"))
    cfg_json = tiny_cfg_json()
    out_a = str(tmp_path / "resumed")
    procs = launch("preempt75", out_a, cfg_json, ds)
    _wait_for(os.path.join(out_a, "metrics.csv"), procs)
    procs[0].send_signal(signal.SIGTERM)
    outs = finish(procs)
    for p, o in zip(procs, outs):
        assert p.returncode == EXIT_STALLED, f"{p.returncode}:\n{o[-3000:]}"
    assert CheckpointManager(os.path.join(out_a, "checkpoints")).saved_indices() == [0]
    k = int(load_state(os.path.join(out_a, "checkpoints", "save_0"), port_cfg(cfg_json),
                       TrainConfig(**LONG_KW)).iter_idx)
    assert k >= 1
    target = k + 3

    for out, mode in ((out_a, f"resume:{target}"), (str(tmp_path / "control"), f"full:{target}")):
        procs = launch(mode, out, cfg_json, ds)
        outs = finish(procs)
        for p, o in zip(procs, outs):
            assert p.returncode == 0, o[-3000:]
    cfg, tcfg = port_cfg(cfg_json), TrainConfig(**LONG_KW)
    a = load_state(os.path.join(out_a, "final", "save_0"), cfg, tcfg)
    b = load_state(str(tmp_path / "control" / "final" / "save_0"), cfg, tcfg)
    assert int(a.iter_idx) == int(b.iter_idx) == target
    la, lb = leaves(a), leaves(b)
    assert all(torch.equal(la[name], lb[name]) for name in la)


def test_cli_two_ranks_train_and_only_the_lead_writes(tmp_path):
    """``python -m musicgan_tpu_torch train --coordinator ... --num-processes
    2 --process-id {0,1} --device cpu`` at full width (stage 0, a batch of 2,
    one row a rank): both exit 0, the lead says which backend the rule chose
    and alone writes the save, the CSV and the previews."""
    from musicgan_tpu_torch.train import CheckpointManager

    ds = synth_dataset(str(tmp_path / "ds"), n=8)
    out = str(tmp_path / "run")
    coord = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "musicgan_tpu_torch", "train", "cli", "-i", ds, "-o", out, "--device", "cpu",
             "--max-stage", "0", "--batch-size", "2", "--max-iters", "3", "--save-every", "3", "--log-every", "1",
             "--chunk-steps", "1", "--coordinator", coord, "--num-processes", "2", "--process-id", str(r)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    outs = finish(procs)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    assert "[dist] backend gloo (2 processes, 0 cards)" in outs[0]
    assert "[train:cli]" in outs[0] and "e000 it0000000" in outs[0]
    assert "[dist]" not in outs[1] and "[train:cli]" not in outs[1] and "e000" not in outs[1]
    assert CheckpointManager(os.path.join(out, "checkpoints")).saved_indices() == [0]
    with open(os.path.join(out, "metrics.csv")) as f:
        assert len(f.read().splitlines()) == 4  # a header and iterations 0-2
    assert len([f for f in os.listdir(out) if f.endswith(".png")]) == 12  # 6 previews x magn, phase


# ---------------------------------------------------------------------------
# The ranks' modes (run by tests/test_torch_multihost.py's entry point).


def rank_mode(mode: str, out: str, rank: int, group, cfg_json: str, ds: str) -> int:
    """Run ``mode`` as rank ``rank``; returns the rank's exit code."""
    from musicgan_tpu_torch.config import TrainConfig
    from musicgan_tpu_torch.train import CheckpointManager, train
    from musicgan_tpu_torch.train.loop import PREEMPTED
    from musicgan_tpu_torch.utils.watchdog import EXIT_STALLED

    cfg, tcfg = port_cfg(cfg_json), TrainConfig(**LONG_KW)
    if mode in ("preempt", "preempt75"):
        state = train("mh", ds, out, tcfg, cfg, max_iters=10**6, device="cpu")
        # the agreement carried the one rank's signal to every rank
        assert PREEMPTED.is_set(), "stopped without the flag"
        print(f"[rank] {rank} preempted at iter {int(state.iter_idx)}", flush=True)
        return EXIT_STALLED if mode == "preempt75" else 0
    if mode == "stream":
        from musicgan_tpu_torch.audio.dataset import SpectrogramDataset

        sizes = os.path.join(out, f"sizes_{rank}.log")
        refresh = SpectrogramDataset.refresh

        def logged_refresh(self, limit=None):
            grew = refresh(self, limit=limit)
            with open(sizes, "a") as f:
                f.write(f"{len(self)}\n")
            return grew

        SpectrogramDataset.refresh = logged_refresh
        train("mh", os.path.join(ds, str(rank)), out, tcfg, cfg, max_iters=10**6, device="cpu")
        return 0
    kind, n = mode.split(":")
    state = train("mh", ds, out, tcfg, cfg, resume=kind == "resume", max_iters=int(n), device="cpu")
    if rank == 0:
        CheckpointManager(os.path.join(out, "final")).save(0, state, {})
    return 0
