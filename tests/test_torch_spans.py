"""The port's span recorder (``musicgan_tpu_torch/utils/profiling.py``) and
its call sites, on the CPU: nesting and parents per thread, the gate
(profiler, ``recording()``, ``always``), the bounded deque, the shared
clock with the profiler's own events, and the spans of a synthesis call,
of a train iteration, of a kernel build and of an autotune measurement."""

import dataclasses
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from musicgan_tpu_torch.config import ModelConfig, TrainConfig
from musicgan_tpu_torch.generate import synthesize_fn
from musicgan_tpu_torch.models import Generator
from musicgan_tpu_torch.ops import _build, autotune
from musicgan_tpu_torch.train import build_step, init_train_state
from musicgan_tpu_torch.utils import profiling
from musicgan_tpu_torch.utils.profiling import recording, span, spans
from tests.tiny_cfg import TINY_MODEL


@pytest.fixture(autouse=True)
def _no_spans_left():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _by_name(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s.name, []).append(s)
    return out


def _children(recorded, parent):
    return sorted((s for s in recorded if s.parent == parent.index), key=lambda s: s.t0_ns)


def test_spans_nest_and_each_thread_keeps_its_own_stack():
    """Parents are the enclosing span's index on the same thread, however
    two threads interleave their spans; a root's parent is None."""
    barrier = threading.Barrier(2, timeout=10)

    def work(k):
        with span(f"outer.{k}"):
            barrier.wait()
            with span(f"inner.{k}"):
                barrier.wait()
                with span(f"leaf.{k}"):
                    barrier.wait()

    with recording():
        threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    got = {s.name: s for s in spans()}
    assert len(got) == 6 and len({s.index for s in got.values()}) == 6
    for k in range(2):
        outer, inner, leaf = got[f"outer.{k}"], got[f"inner.{k}"], got[f"leaf.{k}"]
        assert outer.parent is None
        assert inner.parent == outer.index and leaf.parent == inner.index
        assert outer.thread_id == inner.thread_id == leaf.thread_id
        assert outer.t0_ns <= inner.t0_ns <= leaf.t0_ns <= leaf.t1_ns <= inner.t1_ns <= outer.t1_ns
    assert got["outer.0"].thread_id != got["outer.1"].thread_id


def test_the_gate_profiler_recording_and_always():
    """Nothing with the profiler off; everything under a CPU profiler
    (also as a ``record_function`` event) and inside ``recording()``; an
    ``always`` span either way."""
    with span("mg.test.off"):
        pass
    with span("mg.test.always", always=True):
        pass
    assert [s.name for s in spans()] == ["mg.test.always"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("mg.test.profiled"):
            torch.ones(4).sum()
    with recording():
        with span("mg.test.recording"):
            pass
    with span("mg.test.off_again"):
        pass
    assert [s.name for s in spans()] == ["mg.test.always", "mg.test.profiled", "mg.test.recording"]
    assert any(e.name() == "mg.test.profiled" for e in prof.profiler.kineto_results.events())


def test_a_span_whose_block_raises_is_kept_and_closed():
    with recording():
        with pytest.raises(ValueError):
            with span("mg.test.raises"):
                raise ValueError("inside")
        with span("mg.test.after"):
            pass
    raised, after = spans()
    assert raised.name == "mg.test.raises" and raised.t1_ns >= raised.t0_ns
    assert after.parent is None


def test_the_deque_keeps_the_newest_and_counts_what_it_drops():
    extra = 10
    with recording():
        for _ in range(profiling.CAPACITY + extra):
            with span("mg.test.s"):
                pass
    kept = spans()
    assert len(kept) == profiling.CAPACITY and profiling.dropped() == extra
    assert kept[-1].index - kept[0].index == profiling.CAPACITY - 1
    profiling.clear_spans()
    assert spans() == [] and profiling.dropped() == 0


def test_to_profiler_ns_meets_the_profilers_own_event():
    """A span's start on the profiler's clock lies within 1 ms of its
    ``record_function`` event's start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("mg.test.warm"):  # the first record_function is slow
            pass
        for k in range(5):
            with span(f"mg.test.clock.{k}"):
                time.sleep(1e-3)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for s in spans()[1:]:
        e = events[s.name]
        assert abs(profiling.to_profiler_ns(s.t0_ns) - e.start_ns()) < 1_000_000
        assert abs(profiling.to_profiler_ns(s.t1_ns) - (e.start_ns() + e.duration_ns())) < 1_000_000


def test_synthesize_fn_spans_one_root_a_call():
    """Each call is one ``mg.synth.call`` with resolve, generator and
    vocoder under it, the spectrum under the vocoder."""
    cfg = ModelConfig(rand_channels=8, gen_channels=TINY_MODEL.gen_channels)
    gen = Generator(cfg, device="cpu", seed=0)
    z = np.random.default_rng(3).standard_normal((2, 2, 2, 8)).astype(np.float32)
    synth = synthesize_fn(cfg, stage=3)
    with recording():
        for _ in range(2):
            synth(gen, z)
    recorded = spans()
    roots = [s for s in recorded if s.parent is None]
    assert [s.name for s in roots] == ["mg.synth.call"] * 2 and len(recorded) == 10
    for root in roots:
        kids = _children(recorded, root)
        assert [s.name for s in kids] == ["mg.synth.resolve", "mg.synth.generator", "mg.synth.vocoder"]
        assert [s.name for s in _children(recorded, kids[2])] == ["mg.synth.spectrum"]
        assert not _children(recorded, kids[0]) and not _children(recorded, kids[1])


@pytest.mark.parametrize("with_gen", [True, False])
def test_train_iteration_spans_follow_the_n_critic_pattern(with_gen):
    """One ``mg.train.iteration`` a step (the device-data gather outside
    it): critic and its Adam, then on generator iterations the generator
    and its Adam; one ``mg.train.backward`` in each gradient phase."""
    cfg = ModelConfig(rand_channels=TINY_MODEL.rand_channels, gen_channels=TINY_MODEL.gen_channels,
                      disc_channels=TINY_MODEL.disc_channels, conv_impl="pallas_gp")
    tcfg = TrainConfig(batch_size=2)
    state = init_train_state(0, cfg, tcfg, device="cpu")
    corpus = torch.rand((4, 2, 16, 16), generator=torch.Generator().manual_seed(0)) * 2 - 1
    step = build_step(0, with_gen, cfg, tcfg, device_data=True, device="cpu")
    with recording():
        step(state, corpus, [1, 3], 1.0)
    recorded = spans()
    (root,) = [s for s in recorded if s.parent is None]
    assert root.name == "mg.train.iteration"
    phases = _children(recorded, root)
    want = ["mg.train.critic", "mg.train.critic_adam"]
    if with_gen:
        want += ["mg.train.generator", "mg.train.gen_adam"]
    assert [s.name for s in phases] == want
    backward = _by_name(recorded)["mg.train.backward"]
    graded = [s.index for s in phases if s.name in ("mg.train.critic", "mg.train.generator")]
    assert sorted(s.parent for s in backward) == graded
    assert len(recorded) == len(want) + len(backward) + 1


def test_each_nvcc_is_an_always_span_from_its_start(tmp_path):
    """``_finish_build`` records ``mg.build.compile`` with the profiler off,
    from the time its job started."""
    tmp, out = tmp_path / "k.tmp", tmp_path / "k.so"
    tmp.write_bytes(b"")
    t0 = time.perf_counter_ns()
    proc = subprocess.Popen([sys.executable, "-c", "pass"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    _build._finish_build((proc, tmp, out, t0))
    (s,) = spans()
    assert s.name == "mg.build.compile" and s.t0_ns == t0 and s.t1_ns > t0 and out.exists()


def test_each_autotune_measurement_is_an_always_span(tmp_path, monkeypatch):
    """A measurement is one ``mg.autotune.measure``; a table hit none."""
    monkeypatch.setenv("MUSICGAN_AUTOTUNE_DIR", str(tmp_path / "autotune"))
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_backend", lambda device: "cuda:test card")
    monkeypatch.setattr(autotune, "_capturing", lambda device: False)
    monkeypatch.setattr(autotune, "measure_conv_impls",
                        lambda cfg, z_shape, stage, candidates, device=None: {c: 1.0 for c in candidates})
    monkeypatch.setattr(autotune, "measure_istft_impls", lambda n_bins, t, device=None, n_fft=1024, hop=256: {"xla": 2.0, "pallas": 1.0})
    card = torch.device("cuda")  # only named: nothing is allocated on it
    auto = dataclasses.replace(ModelConfig(), conv_impl="auto")
    for _ in range(2):
        autotune.resolve_conv_impl(auto, (1, 2, 2, 8), 3, device=card)
        autotune.resolve_istft_impl(512, device=card)
    autotune._CACHE.clear()
    autotune.resolve_conv_impl(auto, (1, 2, 2, 8), 3, device=card)  # the persisted table
    assert [s.name for s in spans()] == ["mg.autotune.measure"] * 2
