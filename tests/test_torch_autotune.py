"""The port's conv-impl autotuner (``musicgan_tpu_torch/ops/autotune.py``)
and its timing primitives against the JAX package's, on the CPU: the
resolution rules and their errors on the same arguments, the persisted
table, the trace-safe mode, a failing candidate, the stall watchdog's
beats, the measurements themselves at ``TINY_MODEL``'s widths."""

import dataclasses
import json

import pytest
import torch

from musicgan_tpu.config import TrainConfig as JaxTrainConfig
from musicgan_tpu.ops import autotune as jax_autotune
from musicgan_tpu_torch.config import CONV_IMPLS, ModelConfig, TrainConfig
from musicgan_tpu_torch.models import Generator
from musicgan_tpu_torch.ops import autotune
from musicgan_tpu_torch.utils import timing, watchdog
from tests.tiny_cfg import TINY_MODEL

CFG = ModelConfig(
    rand_channels=TINY_MODEL.rand_channels,
    gen_channels=TINY_MODEL.gen_channels,
    disc_channels=TINY_MODEL.disc_channels,
)
Z_SHAPE = (1, 2, 2, TINY_MODEL.rand_channels)
DTYPES = (None, "float32", "bfloat16", "bfloat16_f32gp")
CARD = torch.device("cuda")  # only named: the tests below never allocate on it


@pytest.fixture(autouse=True)
def _fresh_tables(tmp_path, monkeypatch):
    """A table directory of the test's own and an empty in-process cache."""
    monkeypatch.setenv("MUSICGAN_AUTOTUNE_DIR", str(tmp_path / "autotune"))
    monkeypatch.setattr(autotune, "_CACHE", {})


def _outcome(fn):
    try:
        return fn().conv_impl
    except Exception as e:  # the class is what both packages must agree on
        return type(e)


@pytest.mark.parametrize("impl", CONV_IMPLS)
def test_resolution_matches_jax_on_the_cpu(impl):
    """Every impl name, for inference and for training under each compute
    dtype: the same resolved name or the same error class as JAX's
    ``resolve_conv_impl`` on its CPU backend ("auto" -> "xla" without
    measuring; explicit impls pass through; training rejects the
    inference-only impls and the float32 kernel impls under bf16)."""
    for for_training in (False, True):
        for cdt in DTYPES:
            tc = None if cdt is None else TrainConfig(batch_size=2, compute_dtype=cdt)
            jtc = None if cdt is None else JaxTrainConfig(batch_size=2, compute_dtype=cdt)
            got = _outcome(lambda: autotune.resolve_conv_impl(
                dataclasses.replace(CFG, conv_impl=impl), Z_SHAPE, 0, for_training, tc, device="cpu"))
            want = _outcome(lambda: jax_autotune.resolve_conv_impl(
                dataclasses.replace(TINY_MODEL, conv_impl=impl), Z_SHAPE, 0, for_training, jtc))
            assert got == want, (impl, for_training, cdt)
    assert autotune._CACHE == {}  # nothing measured, nothing cached


def test_error_messages_match_jax():
    """The two rejections carry JAX's words."""
    with pytest.raises(ValueError, match="inference-only"):
        autotune.resolve_conv_impl(dataclasses.replace(CFG, conv_impl="pallas"), Z_SHAPE, 0, True)
    for cdt in ("bfloat16", "bfloat16_f32gp"):
        with pytest.raises(ValueError, match="float32 only"):
            autotune.resolve_conv_impl(
                dataclasses.replace(CFG, conv_impl="pallas_train"), (1, 2, 32, 32), 0, True,
                TrainConfig(compute_dtype=cdt))


def test_constants_and_keys_match_jax():
    """The impl sets are JAX's, inference candidates all six of JAX's
    ``ALL_IMPLS`` (``pallas_up`` is not dropped on Hopper); training keys
    are JAX's after the version; training and inference never alias."""
    assert autotune.TRAINING_IMPLS == jax_autotune.TRAINING_IMPLS
    assert autotune.SECOND_ORDER_IMPLS == jax_autotune.SECOND_ORDER_IMPLS
    assert autotune.ALL_IMPLS == jax_autotune.ALL_IMPLS
    assert autotune.VOCODER_IMPLS == jax_autotune.VOCODER_IMPLS
    z = (6, 2, 2, 32)
    for cdt in ("float32", "bfloat16", "bfloat16_f32gp"):
        cand, key = autotune._candidates_and_key("tpu", z, 7, True, TrainConfig(compute_dtype=cdt))
        jcand, jkey = jax_autotune._candidates_and_key("tpu", z, 7, True, JaxTrainConfig(compute_dtype=cdt))
        assert cand == jcand and key.split("|", 1)[1] == jkey.split("|", 1)[1]
    cand_i, key_i = autotune._candidates_and_key("tpu", z, 7, False, None)
    assert cand_i == autotune.ALL_IMPLS and "pallas_up" in cand_i
    assert "train" not in key_i and key_i != key
    backend = "cuda:NVIDIA H100 80GB HBM3"
    assert autotune._candidates_and_key(backend, z, 7, False, None)[1].split("|")[1] == backend


@pytest.fixture
def fake_card(monkeypatch):
    """Resolution as on a card, with the measurements replaced by fixed
    times: returns the list of measurement calls."""
    calls = []
    monkeypatch.setattr(autotune, "_backend", lambda device: "cuda:test card")
    monkeypatch.setattr(autotune, "_capturing", lambda device: False)

    def conv(cfg, z_shape, stage, candidates, device=None):
        calls.append(("conv", tuple(candidates)))
        return {c: 0.5 if c == "pallas_up" else 1.0 for c in candidates}

    def train(model_cfg, train_cfg, stage, candidates, device=None):
        calls.append(("train", tuple(candidates)))
        return {c: 0.5 if c == "subpixel" else 1.0 for c in candidates}

    def istft(n_bins, t, candidates=autotune.VOCODER_IMPLS, k=48, device=None):
        calls.append(("istft", tuple(candidates)))
        return {"xla": 2.0, "pallas": 1.0}

    monkeypatch.setattr(autotune, "measure_conv_impls", conv)
    monkeypatch.setattr(autotune, "measure_train_impls", train)
    monkeypatch.setattr(autotune, "measure_istft_impls", istft)
    return calls


def test_the_persisted_table_round_trip(fake_card, capsys):
    """A miss measures once, prints the times, caches and persists; a new
    process (an empty in-process cache) reads the persisted winner without
    measuring.  Training keys carry batch and dtype, and bf16 training
    measures only the library candidates."""
    auto = dataclasses.replace(CFG, conv_impl="auto")
    assert autotune.resolve_conv_impl(auto, Z_SHAPE, 3, device=CARD).conv_impl == "pallas_up"
    assert autotune.resolve_conv_impl(auto, Z_SHAPE, 3, device=CARD).conv_impl == "pallas_up"
    assert fake_card == [("conv", autotune.ALL_IMPLS)]
    assert "[autotune] conv_impl" in capsys.readouterr().out
    tc = TrainConfig(batch_size=2)
    assert autotune.resolve_conv_impl(auto, Z_SHAPE, 3, True, tc, device=CARD).conv_impl == "subpixel"
    bf = TrainConfig(batch_size=2, compute_dtype="bfloat16")
    assert autotune.resolve_conv_impl(auto, Z_SHAPE, 3, True, bf, device=CARD).conv_impl == "subpixel"
    assert fake_card[1:] == [("train", autotune.TRAINING_IMPLS), ("train", autotune.SECOND_ORDER_IMPLS)]
    assert autotune.resolve_istft_impl(512, device=CARD) == "pallas"

    table = json.loads(open(autotune._persist_path()).read())
    assert table == autotune._load_persisted() and len(table) == 4
    assert sorted(table.values()) == ["pallas", "pallas_up", "subpixel", "subpixel"]
    assert capsys.readouterr().out.count("[autotune]") == 3
    autotune._CACHE.clear()
    n = len(fake_card)
    assert autotune.resolve_conv_impl(auto, Z_SHAPE, 3, device=CARD).conv_impl == "pallas_up"
    assert autotune.resolve_conv_impl(auto, Z_SHAPE, 3, True, tc, device=CARD).conv_impl == "subpixel"
    assert autotune.resolve_istft_impl(512, device=CARD) == "pallas"
    assert len(fake_card) == n
    assert "[autotune]" not in capsys.readouterr().out


def test_no_measurement_allowed_reads_the_tables_and_caches_no_miss(fake_card, monkeypatch):
    """``allow_measure=False``: a miss gives "xla" and is not cached (a
    later call still measures); a persisted winner is read; a capture on
    the current stream forces the same mode."""
    auto = dataclasses.replace(CFG, conv_impl="auto")
    assert autotune.resolve_conv_impl(auto, Z_SHAPE, 2, allow_measure=False, device=CARD).conv_impl == "xla"
    assert autotune.resolve_istft_impl(1024, allow_measure=False, device=CARD) == "xla"
    assert autotune._CACHE == {} and fake_card == []
    _, key = autotune._candidates_and_key("cuda:test card", Z_SHAPE, 2, False, None)
    autotune._persist({key: "pallas_bf16", autotune._istft_key("cuda:test card", 513, 1024): "pallas"})
    assert autotune.resolve_conv_impl(auto, Z_SHAPE, 2, allow_measure=False, device=CARD).conv_impl \
        == "pallas_bf16"
    assert autotune.resolve_istft_impl(1024, allow_measure=False, device=CARD) == "pallas"
    assert autotune._CACHE == {} and fake_card == []
    other = (2, 2, 2, TINY_MODEL.rand_channels)
    monkeypatch.setattr(autotune, "_capturing", lambda device: True)
    assert autotune.resolve_conv_impl(auto, other, 2, device=CARD).conv_impl == "xla"
    assert fake_card == [] and autotune._CACHE == {}


def test_a_failing_candidate_makes_the_resolution_raise(monkeypatch):
    """The deliberate deviation from JAX (which scores it ``inf``): a
    candidate that raises makes ``resolve_conv_impl`` raise, naming it;
    nothing is cached or persisted."""
    monkeypatch.setattr(autotune, "_backend", lambda device: "cuda:test card")
    monkeypatch.setattr(autotune, "_capturing", lambda device: False)
    real = autotune.measure_conv_impls
    monkeypatch.setattr(
        autotune, "measure_conv_impls",
        lambda cfg, z, s, cand, device=None: real(cfg, z, s, ("xla", "pallas_up"), device="cpu"),
    )
    forward = Generator.forward_nchw

    def broken(self, z, stage, alpha=1.0, impl=None, compute_dtype=torch.float32):
        if impl == "pallas_up":
            raise RuntimeError("mg_upconv3x3: CUDA error 700 at launch")
        return forward(self, z, stage, alpha, impl, compute_dtype)

    monkeypatch.setattr(Generator, "forward_nchw", broken)
    with pytest.raises(RuntimeError, match="candidate 'pallas_up' failed.*CUDA error 700"):
        autotune.resolve_conv_impl(dataclasses.replace(CFG, conv_impl="auto"), Z_SHAPE, 1, device=CARD)
    assert autotune._CACHE == {} and autotune._load_persisted() == {}


def test_measurements_on_the_cpu():
    """The harnesses run every candidate (the kernels' plain versions here)
    and give a non-negative time each."""
    conv = autotune.measure_conv_impls(CFG, Z_SHAPE, 1, device="cpu")
    assert set(conv) == set(autotune.ALL_IMPLS) and all(t >= 0 for t in conv.values())
    voc = autotune.measure_istft_impls(513, 8, k=2, device="cpu")
    assert set(voc) == {"xla", "pallas"} and all(t >= 0 for t in voc.values())


def test_autotune_measurement_beats_active_watchdog(monkeypatch):
    """As ``tests/test_watchdog.py``'s case: a stage's measurement times
    several train graphs with no metric fetch of the loop, so it witnesses
    its own progress to the run's watchdog; an enabled ``StallWatchdog``
    is the active one until it closes."""

    class _Counting:
        beats = 0

        def beat(self):
            self.beats += 1

    wd = _Counting()
    monkeypatch.setattr(watchdog, "_ACTIVE", wd)
    times = autotune.measure_train_impls(
        CFG, TrainConfig(batch_size=2, chunk_steps=1), stage=0,
        candidates=("xla", "subpixel"), device="cpu",
    )
    assert set(times) == {"xla", "subpixel"}
    assert wd.beats >= 2
    watchdog.beat_active()
    assert wd.beats >= 3

    monkeypatch.setattr(watchdog, "_ACTIVE", None)
    watchdog.beat_active()  # no watchdog: a no-op
    off = watchdog.StallWatchdog(0.0)
    assert watchdog._ACTIVE is None
    on = watchdog.StallWatchdog(3600.0, poll_s=0.05)
    try:
        assert watchdog._ACTIVE is on and on._last is None
        watchdog.beat_active()
        assert on._last is not None
    finally:
        on.close()
        off.close()
    assert watchdog._ACTIVE is None


def test_timing_primitives_on_the_cpu():
    """``scalar_rtt``, ``time_dispatch`` (clamped at half the raw time) and
    ``measure_peak_tflops`` (the precision restored afterwards)."""
    rtt = timing.scalar_rtt(reps=3, device="cpu")
    assert rtt > 0
    calls = []
    t = timing.time_dispatch(lambda: calls.append(1), reps=2, rtt=1.0, device="cpu")
    assert len(calls) == 3 and t > 0
    before = torch.get_float32_matmul_precision()
    peak = timing.measure_peak_tflops(n=32, depth=2, reps=1, precision="high", device="cpu")
    assert peak > 0 and torch.get_float32_matmul_precision() == before
