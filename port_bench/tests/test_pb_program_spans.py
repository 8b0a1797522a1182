"""The readers of the program's own spans (``musicgan_tpu_torch/utils/
profiling.py``) on hand-built runs: only the roots inside the benchmark's
spans count, children are found by their parents, and a run with no such
span, or a program without the recorder, reads None."""

import pytest
import torch

from musicgan_tpu_torch.utils import profiling
from musicgan_tpu_torch.utils.profiling import Span
from port_bench import spec
from port_bench.run import Run
from port_bench.trace import TraceData

SYNTH = ("generator_host_ms.synth", "vocoder_host_ms.synth")
TRAIN = ("critic_host_ms.train", "backward_host_ms.train", "adam_host_ms.train", "gen_host_ms.train",
         "host_per_device.train")


def read(name, run):
    return spec.load_metric(name).read(run)


class Recorder:
    """Spans written by hand, times in ms: ``add(name, t0, t1, parent)``
    returns the span's index."""

    def __init__(self):
        self.spans = []

    def add(self, name, t0_ms, t1_ms, parent=None):
        index = len(self.spans)
        self.spans.append(Span(name, parent, round(t0_ms * 1e6), round(t1_ms * 1e6), 1, index))
        return index


def make_run(bench_spans, busy_s=None):
    """A run with the benchmark's spans ``(name, t0_ms, t1_ms)`` and, with
    ``busy_s``, a trace whose device was busy that long."""
    run = Run(None, 0, 1.0, True, torch.device("cpu"))
    run.spans = [(name, t0 * 1e-3, t1 * 1e-3) for name, t0, t1 in bench_spans]
    if busy_s is not None:
        run.trace = TraceData(10.0, [("kernel", 0.0, busy_s)], [])
    return run


@pytest.fixture
def recorded(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(profiling, "spans", lambda: list(rec.spans))
    return rec


def test_synthesis_readers_take_the_calls_inside_the_benchmarks_spans(recorded):
    for t, gen_ms, voc_ms in ((1000, 10, 50), (2000, 20, 30), (5000, 900, 900)):
        call = recorded.add("mg.synth.call", t + 1, t + 99)
        recorded.add("mg.synth.resolve", t + 1, t + 2, call)
        recorded.add("mg.synth.generator", t + 2, t + 2 + gen_ms, call)
        voc = recorded.add("mg.synth.vocoder", t + 2 + gen_ms, t + 2 + gen_ms + voc_ms, call)
        recorded.add("mg.synth.spectrum", t + 2 + gen_ms, t + 3 + gen_ms, voc)
    recorded.add("mg.synth.generator", 1010, 1500)  # a root of its own (no call around it)
    run = make_run([("port_bench.synthesize_fn", 1000, 1100), ("port_bench.synthesize_fn", 2000, 2100),
                    ("port_bench.wait", 5000, 5100)])
    assert read("generator_host_ms.synth", run) == pytest.approx(15.0)
    assert read("vocoder_host_ms.synth", run) == pytest.approx(40.0)


def test_train_readers_sum_by_iteration_and_count_generator_iterations_alone(recorded):
    # (start, with the generator, critic ms, its backward ms, critic Adam ms, generator ms, its backward, its Adam)
    plan = ((1000, True, 20, 8, 4, 10, 5, 3), (2000, False, 30, 12, 6, 0, 0, 0), (3000, False, 40, 16, 2, 0, 0, 0),
            (9000, True, 500, 500, 500, 500, 500, 500))
    for t, do_g, crit, crit_bw, crit_adam, gen, gen_bw, gen_adam in plan:
        it = recorded.add("mg.train.iteration", t, t + 100)
        c = recorded.add("mg.train.critic", t, t + crit, it)
        recorded.add("mg.train.backward", t + 1, t + 1 + crit_bw, c)
        recorded.add("mg.train.critic_adam", t + crit, t + crit + crit_adam, it)
        if do_g:
            g = recorded.add("mg.train.generator", t + 50, t + 50 + gen, it)
            recorded.add("mg.train.backward", t + 51, t + 51 + gen_bw, g)
            recorded.add("mg.train.gen_adam", t + 50 + gen, t + 50 + gen + gen_adam, it)
    bench = [("port_bench.train_step", t - 1, t + 101) for t in (1000, 2000, 3000)]
    run = make_run(bench, busy_s=0.2)
    assert read("critic_host_ms.train", run) == pytest.approx(30.0)
    assert read("backward_host_ms.train", run) == pytest.approx(13.0)  # 8 + 5, 12, 16
    assert read("adam_host_ms.train", run) == pytest.approx(6.0)  # 4 + 3, 6, 2
    assert read("gen_host_ms.train", run) == pytest.approx(10.0)
    assert read("host_per_device.train", run) == pytest.approx(0.3 / 0.2)
    assert read("host_per_device.train", make_run(bench)) is None  # no trace


def test_build_tune_s_is_the_union_of_builds_and_measurements(recorded):
    recorded.add("mg.build.compile", 0, 4000)
    recorded.add("mg.build.compile", 0, 6000)  # side by side with the first
    recorded.add("mg.autotune.measure", 7000, 8500)
    recorded.add("mg.synth.call", 9000, 9100)
    assert read("build_tune_s", make_run([])) == pytest.approx(7.5)


def test_no_span_in_the_window_reads_none(recorded):
    recorded.add("mg.synth.call", 1, 99)
    recorded.add("mg.synth.generator", 2, 10, 0)
    recorded.add("mg.train.iteration", 1, 99)
    run = make_run([("port_bench.synthesize_fn", 200, 300), ("port_bench.train_step", 200, 300)], busy_s=0.1)
    for name in SYNTH + TRAIN:
        assert read(name, run) is None, name
    assert read("build_tune_s", run) == 0.0  # a warm checkout: nothing built, nothing timed


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    run = make_run([("port_bench.synthesize_fn", 0, 100), ("port_bench.train_step", 0, 100)], busy_s=0.1)
    for name in SYNTH + TRAIN + ("build_tune_s",):
        assert read(name, run) is None, name
