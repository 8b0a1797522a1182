"""The port's ``train`` entry point on the CPU: its trajectory against the
JAX package's loop on one synthetic corpus, and its own contracts (chunked
equals single stepping, bit-exact resume after a cadence save and after a
preemption, resident and streaming corpus, the budget guard, ``generate``
from the run directory).  Tiny widths, a schedule of a few dozen samples a
stage.  The command line is driven in ``test_torch_train_cli.py``."""

import csv
import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from musicgan_tpu.config import TrainConfig as JaxTrainConfig
from musicgan_tpu.train import train as jax_train
from musicgan_tpu_torch.audio.ingest import ShardWriter
from musicgan_tpu_torch.audio.io import load_wav
from musicgan_tpu_torch.config import ModelConfig, TrainConfig
from musicgan_tpu_torch.generate import generate, load_generator_params
from musicgan_tpu_torch.parallel import Mesh
from musicgan_tpu_torch.train import CheckpointManager, train
from musicgan_tpu_torch.train import loop as loop_mod
from tests.test_torch_checkpoint import assert_states_equal
from tests.tiny_cfg import TINY_MODEL

CFG = ModelConfig(
    rand_channels=TINY_MODEL.rand_channels,
    gen_channels=TINY_MODEL.gen_channels,
    disc_channels=TINY_MODEL.disc_channels,
)
# 16 samples a stage at batch 4 (a switch every 5th iteration), fades of 12:
# iterations 0-4 run at stage 0, 5-8 at stage 1 (alpha 1/12, 5/12, 9/12, 1),
# 9 and later at stage 2.
SCHEDULE = dict(
    batch_size=4, nb_epoch=50, fadein_lengths=(1,) + (12,) * 7, train_lengths=(16,) * 7,
    nb_preview=1, max_stage=2,
)
TCFG = TrainConfig(save_every=6, log_every=3, chunk_steps=3, **SCHEDULE)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and the
    test workers running beside this one do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus") / "ds")
    w = ShardWriter(path, samples_per_shard=6)
    w.add(np.random.default_rng(0).uniform(-1, 1, (16, 2, 512, 512)).astype(np.float32))
    w.close()
    return path


def _run(corpus, out, cfg=TCFG, **kw):
    return train("t", corpus, str(out), cfg, CFG, device="cpu", mesh=None, **kw)


def _meta(out, k):
    with open(os.path.join(out, "checkpoints", f"save_{k}", "meta.json")) as f:
        return json.load(f)


def _rows(out):
    with open(os.path.join(out, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def test_trajectory_matches_the_jax_loop(corpus, tmp_path):
    """Across a growth boundary with ``log_every=1``: the same rows (step,
    stage, alpha) in ``metrics.csv``, the same saves, counters, grower state
    and preview files.  The losses are not compared here: the two packages
    draw different noise from one seed (the train-step tests feed both the
    same noise)."""
    kw = dict(save_every=4, log_every=1, chunk_steps=2, n_critic=100, **{**SCHEDULE, "max_stage": 1})
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    state = _run(corpus, out_t, TrainConfig(**kw), max_iters=9)
    jax_train("t", corpus, out_j, JaxTrainConfig(**kw), TINY_MODEL, max_iters=9, mesh=None)
    assert int(state.iter_idx) == 9

    rows_t, rows_j = _rows(out_t), _rows(out_j)
    assert list(rows_t[0]) == list(rows_j[0])  # the same columns in the same order
    assert [(r["step"], r["stage"], r["alpha"]) for r in rows_t] == [
        (r["step"], r["stage"], r["alpha"]) for r in rows_j]
    assert [r["stage"] for r in rows_t] == ["0"] * 5 + ["1"] * 4
    assert [float(r["alpha"]) for r in rows_t[5:]] == pytest.approx([1 / 12, 5 / 12, 9 / 12, 1.0], abs=1e-6)
    assert all((r["gen_loss"] == "") == (r_j["gen_loss"] == "") for r, r_j in zip(rows_t, rows_j))

    ck_t = CheckpointManager(os.path.join(out_t, "checkpoints"))
    assert ck_t.saved_indices() == [0, 1]
    assert sorted(os.listdir(os.path.join(out_j, "checkpoints"))) == ["save_0", "save_1"]
    for k in (0, 1):
        mt, mj = _meta(out_t, k), _meta(out_j, k)
        assert list(mt) == list(mj)
        for key in ("grower", "epoch", "epoch_batch_pos", "iter_idx", "run_name", "saver_counter",
                    "save_idx", "has_ema"):
            assert mt[key] == mj[key], key
        assert set(mt["train_cfg"]) == set(mj["train_cfg"])
    pngs = lambda out: sorted(f for f in os.listdir(out) if f.endswith(".png"))  # noqa: E731
    assert pngs(out_t) == pngs(out_j) == [
        "magn_0_ID0.png", "magn_1_ID0.png", "phase_0_ID0.png", "phase_1_ID0.png"]


def test_chunked_equals_single_stepping_exactly(corpus, tmp_path):
    a = _run(corpus, tmp_path / "a", dataclasses.replace(TCFG, chunk_steps=1), max_iters=13)
    b = _run(corpus, tmp_path / "b", dataclasses.replace(TCFG, chunk_steps=3), max_iters=13)
    assert int(a.iter_idx) == 13
    assert_states_equal(a, b)
    for out in ("a", "b"):
        assert [(r["step"], r["stage"]) for r in _rows(str(tmp_path / out))] == [
            ("0", "0"), ("3", "0"), ("6", "1"), ("9", "2"), ("12", "2")]
    assert [r["alpha"] for r in _rows(str(tmp_path / "a"))] == [r["alpha"] for r in _rows(str(tmp_path / "b"))]
    meta_a, meta_b = _meta(str(tmp_path / "a"), 1), _meta(str(tmp_path / "b"), 1)
    assert meta_a.pop("train_cfg")["chunk_steps"] == 1 and meta_b.pop("train_cfg")["chunk_steps"] == 3
    assert meta_a == meta_b


@pytest.mark.parametrize("chunk,ema", [(1, 0.0), (3, 0.9)])
def test_resume_after_a_cadence_save_is_bit_exact(corpus, tmp_path, chunk, ema):
    """Stopped by ``max_iters`` between saves, resumed from the save before:
    through two stage switches with their fades, the resumed run equals the
    uninterrupted one in every parameter, moment, count, in the EMA and in
    the random generator's state."""
    cfg = dataclasses.replace(TCFG, chunk_steps=chunk, ema_decay=ema)
    ctrl = _run(corpus, tmp_path / "ctrl", cfg, max_iters=14)
    out = str(tmp_path / "out")
    _run(corpus, out, cfg, max_iters=8)
    assert CheckpointManager(os.path.join(out, "checkpoints")).saved_indices() == [0]
    assert _meta(out, 0)["iter_idx"] == 6 and _meta(out, 0)["grower"]["curr_grow"] == 1
    resumed = _run(corpus, out, cfg, resume=True, max_iters=14)
    assert int(resumed.iter_idx) == 14
    assert_states_equal(ctrl, resumed)
    assert _meta(out, 1) == {**_meta(str(tmp_path / "ctrl"), 1)}
    # resume with nothing saved starts from scratch
    fresh = _run(corpus, tmp_path / "fresh", cfg, resume=True, max_iters=14)
    assert_states_equal(ctrl, fresh)


def _preempted_run(corpus, out, cfg, monkeypatch, **kw):
    """A run with the preemption flag already up when it starts (the signal
    landed before the first iteration boundary)."""
    monkeypatch.setattr(loop_mod, "_install_preemption_handlers", lambda: None)
    loop_mod.PREEMPTED.set()
    try:
        return _run(corpus, out, cfg, **kw)
    finally:
        loop_mod.PREEMPTED.clear()
        monkeypatch.undo()


def test_preemption_flushes_a_save_and_resume_is_bit_exact(corpus, tmp_path, monkeypatch, capsys):
    cfg = dataclasses.replace(TCFG, save_every=100, log_every=100, chunk_steps=1)
    ctrl = _run(corpus, tmp_path / "ctrl", cfg, max_iters=7)
    out = str(tmp_path / "out")
    s1 = _preempted_run(corpus, out, cfg, monkeypatch, max_iters=7)
    assert int(s1.iter_idx) == 1
    assert "exit retryable and resume with --resume" in capsys.readouterr().out
    assert CheckpointManager(os.path.join(out, "checkpoints")).latest() == 0  # despite save_every=100
    meta = _meta(out, 0)
    assert (meta["epoch_batch_pos"], meta["iter_idx"], meta["saver_counter"]) == (1, 1, 1)
    s2 = _run(corpus, out, cfg, resume=True, max_iters=7)
    assert int(s2.iter_idx) == 7
    assert_states_equal(ctrl, s2)


def test_preemption_mid_chunk_flushes_at_the_chunks_end(corpus, tmp_path, monkeypatch):
    cfg = dataclasses.replace(TCFG, save_every=100, log_every=100, chunk_steps=3)
    ctrl = _run(corpus, tmp_path / "ctrl", cfg, max_iters=8)
    out = str(tmp_path / "out")
    s1 = _preempted_run(corpus, out, cfg, monkeypatch, max_iters=8)
    assert int(s1.iter_idx) == 3  # the first chunk completes, then flush and stop
    meta = _meta(out, 0)
    assert (meta["epoch_batch_pos"], meta["iter_idx"]) == (3, 3)
    s2 = _run(corpus, out, cfg, resume=True, max_iters=8)
    assert_states_equal(ctrl, s2)


def test_preemption_signal_sets_the_event_and_handlers_are_restored():
    before = signal.getsignal(signal.SIGUSR1)
    prev = loop_mod._install_preemption_handlers()
    try:
        assert not loop_mod.PREEMPTED.is_set()
        signal.raise_signal(signal.SIGUSR1)
        assert loop_mod.PREEMPTED.is_set()
    finally:
        loop_mod.PREEMPTED.clear()
        loop_mod._restore_preemption_handlers(prev)
    assert signal.getsignal(signal.SIGUSR1) is before


def test_resume_with_ema_off_drops_a_stale_ema(corpus, tmp_path, capsys):
    out = str(tmp_path / "out")
    cfg = dataclasses.replace(TCFG, save_every=2, chunk_steps=1, ema_decay=0.9)
    s1 = _run(corpus, out, cfg, max_iters=2)
    assert s1.gen_ema is not None and _meta(out, 0)["has_ema"] is True
    s2 = _run(corpus, out, dataclasses.replace(cfg, ema_decay=0.0), resume=True, max_iters=4)
    assert s2.gen_ema is None and _meta(out, 1)["has_ema"] is False
    assert "discarding it" in capsys.readouterr().out


def test_resident_and_streaming_corpus_agree(corpus, tmp_path):
    """The device-resident corpus against streaming with the on-device
    pipeline: exactly the same state (the same rows through the same step).
    Streaming through the host pipeline scales the batch in numpy instead:
    the metrics agree at rel 1e-3 / abs 1e-4, the train step's own bar
    against JAX."""
    on = _run(corpus, tmp_path / "on", dataclasses.replace(TCFG, device_dataset="on", log_every=1), max_iters=7)
    off = _run(
        corpus, tmp_path / "off",
        dataclasses.replace(TCFG, device_dataset="off", host_pipeline=False, log_every=1), max_iters=7)
    assert_states_equal(on, off)
    _run(corpus, tmp_path / "host", dataclasses.replace(TCFG, device_dataset="off", log_every=1), max_iters=7)
    rows_on, rows_host = _rows(str(tmp_path / "on")), _rows(str(tmp_path / "host"))
    assert len(rows_on) == len(rows_host) == 7
    for a, b in zip(rows_on, rows_host):
        assert (a["step"], a["stage"], a["alpha"]) == (b["step"], b["stage"], b["alpha"])
        for k in ("disc_loss", "grad_pen", "e_tp", "e_tn", "gen_loss", "e_gen"):
            assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-3, abs=1e-4), k


def test_bf16_resident_corpus_and_its_budget(corpus, tmp_path, capsys):
    """bfloat16 residency halves the bytes the budget is held against, and
    the rows are upcast at the gather: metrics within 2 % of float32's."""
    nbytes = 16 * 2 * 512 * 512 * 4
    cfg = dataclasses.replace(TCFG, device_dataset="auto", device_dataset_budget_bytes=nbytes // 2,
                              device_dataset_dtype="bfloat16", log_every=1)
    calls = []
    real, real_chunk = loop_mod.build_step, loop_mod.build_chunk_step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop_mod, "build_step", lambda *a, **kw: (calls.append(kw), real(*a, **kw))[1])
        mp.setattr(loop_mod, "build_chunk_step", lambda *a, **kw: (calls.append(kw), real_chunk(*a, **kw))[1])
        _run(corpus, tmp_path / "bf16", cfg, max_iters=3)
        assert calls and all(kw["device_data"] for kw in calls)
        calls.clear()
        _run(corpus, tmp_path / "f32", dataclasses.replace(cfg, device_dataset_dtype="float32"), max_iters=3)
        assert calls and not any(kw["device_data"] for kw in calls)  # float32 is over the budget: streams
    for a, b in zip(_rows(str(tmp_path / "bf16")), _rows(str(tmp_path / "f32"))):
        assert float(a["grad_pen"]) == pytest.approx(float(b["grad_pen"]), rel=2e-2)
    with pytest.raises(ValueError, match="device_dataset_dtype"):
        _run(corpus, tmp_path / "x", dataclasses.replace(cfg, device_dataset_dtype="float16"), max_iters=1)


def test_budget_guard_on_a_grown_corpus(tmp_path, monkeypatch, capsys):
    """A refresh that outgrows ``device_dataset_budget_bytes`` must not
    re-ship the corpus: training goes on with the resident snapshot, and the
    batch indices stay inside it."""
    ds_dir = str(tmp_path / "ds")
    w = ShardWriter(ds_dir, samples_per_shard=2)
    rng = np.random.default_rng(0)
    w.add(rng.uniform(-1, 1, (2, 2, 8, 8)).astype(np.float32))

    class GrowingDS(loop_mod.SpectrogramDataset):
        def refresh(self):
            if len(self) == 2:
                w.add(rng.uniform(-1, 1, (6, 2, 8, 8)).astype(np.float32))
            return super().refresh()

    monkeypatch.setattr(loop_mod, "SpectrogramDataset", GrowingDS)
    cfg = TrainConfig(
        batch_size=2, device_dataset="on", device_dataset_budget_bytes=2 * 2 * 512 * 512 * 4 + 16,
        chunk_steps=1, max_stage=0, save_every=10**9, log_every=10**9, nb_preview=1,
        fadein_lengths=(1,) * 8, train_lengths=(10**9,) * 7, nb_epoch=4,
    )
    state = train("guard", ds_dir, str(tmp_path / "run"), cfg, CFG, max_iters=3, mesh=None, device="cpu")
    assert int(state.iter_idx) == 3
    text = capsys.readouterr().out
    assert "grew to 8 samples" in text and "keeping the resident 2-sample snapshot" in text


def test_generate_reads_the_run_directory(corpus, tmp_path):
    """The checkpoint branch of ``load_generator_params``: a run directory,
    its ``checkpoints`` directory or one save; the EMA weights when the run
    carries them; both values of ``conv_impl``."""
    out = str(tmp_path / "run")
    state = _run(corpus, out, dataclasses.replace(TCFG, ema_decay=0.9, save_every=4), max_iters=12)
    ema_at_save = CheckpointManager(os.path.join(out, "checkpoints"))
    assert ema_at_save.saved_indices() == [0, 1, 2]
    gen = load_generator_params(out, CFG, device="cpu")
    for k, p in gen.named_parameters():  # the final state is the save at iteration 12
        assert torch.equal(p, state.gen_ema[k]), k
    assert any(not torch.equal(p, dict(state.gen.named_parameters())[k]) for k, p in gen.named_parameters())
    first = load_generator_params(os.path.join(out, "checkpoints", "save_0"), CFG, device="cpu")
    assert not torch.equal(first.blocks[0].conv1.weight, gen.blocks[0].conv1.weight)

    z = np.random.default_rng(1).standard_normal((2, 2, 2, CFG.rand_channels)).astype(np.float32)
    waves = {}
    for impl in ("pallas_up", "pallas_block"):
        paths = generate(
            str(tmp_path / impl), CFG.rand_channels, os.path.join(out, "checkpoints"), nb_vec=1, nb_music=2,
            stage=2, model_cfg=dataclasses.replace(CFG, conv_impl=impl), z=torch.from_numpy(z), device="cpu")
        assert [os.path.basename(p) for p in paths] == ["sound_0.wav", "sound_1.wav"]
        waves[impl] = np.stack([load_wav(p)[0] for p in paths])
        assert np.isfinite(waves[impl]).all() and np.abs(waves[impl]).max() > 0
    assert np.array_equal(waves["pallas_up"], waves["pallas_block"])  # one plain version on the CPU
    with pytest.raises(FileNotFoundError):
        load_generator_params(str(tmp_path / "nothing"), CFG, device="cpu")


def test_train_refuses_what_is_not_ported(corpus, tmp_path):
    """Training is data parallel over processes, one a card: a mesh of
    devices in one process is refused (the one deliberate departure from
    JAX's ``train(mesh=...)``), and so is what is no mesh at all."""
    with pytest.raises(NotImplementedError, match="one process per card"):
        train("t", corpus, str(tmp_path / "o"), TCFG, CFG, mesh=Mesh(("cpu", "cpu")), device="cpu")
    with pytest.raises(TypeError, match="parallel.Group"):
        train("t", corpus, str(tmp_path / "o"), TCFG, CFG, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="samples < batch"):
        _run(corpus, tmp_path / "o", dataclasses.replace(TCFG, batch_size=32), max_iters=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train("t", corpus, str(tmp_path / "o"), TCFG, CFG, max_iters=1)


def test_a_device_loss_maps_to_the_retryable_exit(corpus, tmp_path, monkeypatch):
    """A CUDA runtime error whose message says the device went away exits 75
    for a supervised restart; an ordinary exception with the same words keeps
    propagating, and so does a CUDA error that is a bug."""
    def failing(exc):
        def build(*a, **kw):
            def step(*a, **kw):
                raise exc
            return step
        return build

    cfg = dataclasses.replace(TCFG, chunk_steps=1)
    monkeypatch.setattr(loop_mod, "build_step", failing(RuntimeError("CUDA error: unspecified launch failure; device unavailable")))
    with pytest.raises(SystemExit) as e:
        _run(corpus, tmp_path / "a", cfg, max_iters=2)
    assert e.value.code == 75
    monkeypatch.setattr(loop_mod, "build_step", failing(BrokenPipeError("service unavailable")))
    with pytest.raises(BrokenPipeError):
        _run(corpus, tmp_path / "b", cfg, max_iters=2)
    monkeypatch.setattr(loop_mod, "build_step", failing(RuntimeError("CUDA error: invalid argument")))
    with pytest.raises(RuntimeError, match="invalid argument"):
        _run(corpus, tmp_path / "c", cfg, max_iters=2)


def test_a_run_with_the_stall_watchdog_armed_completes(corpus, tmp_path):
    """``stall_timeout_s > 0`` starts the detector; metric reads and saves
    beat it, and it is shut down when the run ends."""
    import threading

    cfg = dataclasses.replace(TCFG, stall_timeout_s=300.0, log_every=1, save_every=2)
    state = _run(corpus, tmp_path / "out", cfg, max_iters=4)
    assert int(state.iter_idx) == 4
    assert not any(t.name == "musicgan-stall-watchdog" for t in threading.enumerate())
