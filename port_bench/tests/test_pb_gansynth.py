"""The GANSynth cell on the CPU at a tiny size: a sound run is correct; the
pitch's one-hot dropped, an image altered where it is produced and the fp8
control are not; its work counts at the published widths; its files import
neither JAX nor the JAX package, and its reference nothing of the program."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from port_bench import run as harness
from port_bench import spec
from port_bench.tests.test_pb_imports import FORBIDDEN, imported

REPO = Path(__file__).resolve().parents[2]
CELL = "gansynth-bank-b122"
SEED = 2**33 + 4242  # wider than 32 bits, as the driver's are

# GANSynth's topology at tiny widths: a 16-value latent and 5 classes, a
# dense input to 2x4, four blocks to 32x64 (the mel bins of n_fft 128), the
# tail and the head; 32 frames, 900 samples kept.
TINY_MODEL = {"rand_channels": 16, "n_classes": 5, "dense_start": [2, 4],
              "gen_channels": [[32, 32], [32, 32], [32, 16], [16, 8]],
              "audio": {"n_fft": 128, "n_vec": 32, "stft_stride": 32, "sample_rate": 16000, "freq_scale": "mel_if",
                        "crop": 900}}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gansynth_root")
    bench = root / "port_bench"
    for d in ("configs", "traffic", "metrics"):
        (bench / d).mkdir(parents=True)
    cfg = json.loads((REPO / "port_bench/configs/gansynth-ifmel-h.json").read_text())
    cfg["model"].update(TINY_MODEL)
    cfg["stage"] = len(TINY_MODEL["gen_channels"]) - 1
    (bench / "configs/tiny-gansynth.json").write_text(json.dumps(cfg))
    traffic = json.loads((REPO / "port_bench/traffic/bank-2x61.json").read_text())
    traffic.update(pitches=5, warmup_calls=1, sampled_calls=1, sample_from_first=2)
    (bench / "traffic/tiny-bank.json").write_text(json.dumps(traffic))
    for f in (REPO / "port_bench/metrics").glob("*.py"):
        shutil.copy(f, bench / "metrics" / f.name)
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    real["configs"] = [{"name": "tiny-gansynth", "source": "x", "file": "port_bench/configs/tiny-gansynth.json",
                        "reduced": [], "why": "x"}]
    real["workloads"] = [{"name": CELL, "config": "tiny-gansynth", "traffic": "tiny-bank", "chips": 1, "why": "x"}]
    (root / "BENCHMARK.json").write_text(json.dumps(real))
    harness.prepare_environment(root)
    return root


def run_cell(root, traced=False):
    return harness.run_cell(spec.load_cell(CELL, root), SEED, 0.3, traced, torch.device("cpu"))


def test_sound_run_is_correct(tiny_root):
    result, record = run_cell(tiny_root)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"synth_audio_s_per_s", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert record.facts["notes_compared"] == 10 * (1 + (record.facts["calls_completed"] > 1))
    assert record.facts["launches"]["mel"] == 2 * record.facts["calls_issued"]


def test_traced_run_reads_the_program_span_readers(tiny_root):
    """On the CPU there is no device trace: with the recorder on, the span
    readers read, the trace readers read nothing and do not raise."""
    from musicgan_tpu_torch.utils import profiling

    profiling.clear_spans()
    with profiling.recording():
        result, _ = run_cell(tiny_root, traced=True)
    profiling.clear_spans()
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"latent_host_ms.gansynth", "mel_host_ms.gansynth"}
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_trace_readers_attribute_kernels_by_name():
    """A hand-built window of 10 calls: K5, the GEMMs and the spectrum's
    functions are the vocoder's, every other kernel the generator's; the
    calls are the program's counts, not the completed calls."""
    from port_bench.trace import TraceData

    run = harness.Run(None, 0, 1.0, True, torch.device("cpu"))
    kernels = [("void mg::cb::conv_bf16_kernel<3, 128, __nv_bfloat16>", 0.0, 4.0),
               ("void mg_head1x1_bf16_kernel", 4.0, 5.0),
               ("sm90_xmma_gemm_f32f32_f32f32_f32_nn", 5.0, 7.0),
               ("void at::native::vectorized_elementwise_kernel<4, at::native::cos_kernel_cuda>", 7.0, 7.5),
               ("void mg_istft_kernel<2048>", 7.5, 8.0)]
    run.trace = TraceData(10.0, kernels, [])
    run.facts = {"units_done": 9, "launches": {"mel": 20, "istft": 10}, "generator_least_s": 0.2,
                 "mel_least_s": 0.1, "istft_least_s": 0.025, "flops": 1e14, "peak_flops": 1e15}
    read = {m: spec.load_metric(m, REPO).read(run) for m in
            ("conv_roofline.gansynth", "mel_roofline.gansynth", "istft_roofline.gansynth", "mfu.gansynth")}
    assert read["conv_roofline.gansynth"] == pytest.approx(100 * 0.2 * 10 / 5.0)
    assert read["mel_roofline.gansynth"] == pytest.approx(100 * 0.1 * 10 / 2.0)
    assert read["istft_roofline.gansynth"] == pytest.approx(100 * 0.025 * 10 / 0.5)
    assert read["mfu.gansynth"] == pytest.approx(100 * 1e14 * 9 / (10.0 * 1e15))
    run.facts["launches"] = {"mel": 0, "istft": 0}
    assert all(spec.load_metric(m, REPO).read(run) is None for m in read if m != "mfu.gansynth")


def test_pitch_dropped_is_not_correct(tiny_root, monkeypatch):
    from musicgan_tpu_torch.models import generator as generator_module

    from port_bench.control_gansynth import dropped

    monkeypatch.setattr(generator_module, "condition", dropped)
    result, _ = run_cell(tiny_root)
    assert not result["correct"], result["checks"]
    assert result["checks"]["pitch_gap"]["value"] > result["checks"]["pitch_gap"]["limit"]


def test_image_altered_is_not_correct(tiny_root, monkeypatch):
    from musicgan_tpu_torch.models import Generator

    forward = Generator.forward_nchw

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        out[0] = out[0].flip(-1)  # one note's image altered where it is produced
        return out

    monkeypatch.setattr(Generator, "forward_nchw", altered)
    result, _ = run_cell(tiny_root)
    assert not result["correct"], result["checks"]


def test_the_controls_and_the_fault_are_not_correct(tiny_root):
    """control_gansynth's readings at the tiny size: the program correct,
    the fp8 generator failing ``image_gap``, the bf16 vocoder ``wave_gap``,
    the dropped pitch ``pitch_gap``."""
    from port_bench.control_gansynth import readings

    run = harness.Run(spec.load_cell(CELL, tiny_root), SEED, 0.0, False, torch.device("cpu"))
    (row,) = readings(run, [SEED], 1)
    limits = run.config["limits"]
    assert row["program"]["correct"]
    for side, number in (("fp8_generator", "image_gap"), ("bf16_vocoder", "wave_gap"),
                         ("pitch_dropped", "pitch_gap")):
        assert not row[side]["correct"] and row[side][number] > limits[number], (side, row[side])


def test_work_at_the_published_widths():
    """18.33 GFLOP a note in the generator (dense input, six blocks with the
    up-convs as phases, tail, head), 0.537 in the mel products."""
    from port_bench.drivers.gansynth_bank import model_config
    from port_bench.work_gansynth import call_work, generator_call_units, mel_unit

    mcfg = model_config(json.loads((REPO / "port_bench/configs/gansynth-ifmel-h.json").read_text()))
    per_note = sum(u.flops for u in generator_call_units(mcfg, 1, 2))
    assert per_note == pytest.approx(18.33e9, rel=1e-3)
    assert mel_unit(1, 128, 1024, 1024).flops == 2 * 2 * 128 * 1024 * 1024
    work = call_work(mcfg, 122, "bfloat16")
    assert work["flops"] == pytest.approx(122 * 18.875e9, rel=1e-3)
    assert work["generator_flops"] == pytest.approx(122 * per_note)


@pytest.mark.parametrize("path", ["drivers/gansynth_bank.py", "reference/gansynth.py", "control_gansynth.py",
                                  "work_gansynth.py"])
def test_new_files_import_no_jax(path):
    names = imported(REPO / "port_bench" / path)
    assert not {n.split(".")[0] for n in names} & FORBIDDEN
    if path.startswith("reference/"):
        assert not any(n.split(".")[0] == "musicgan_tpu_torch" for n in names)
