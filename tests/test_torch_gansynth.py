"""GANSynth's generator and mel-IF vocoder on the port's synthesis path, on
the CPU, against the benchmark's plain reference
(``port_bench/reference/gansynth.py``) on seeded weights: GANSynth's
geometry (a 2x16 dense input, six blocks to 128x1024, n_fft 2048, hop 512,
16 kHz, 64,000 samples) at reduced widths, every impl's plain versions;
the mel-to-linear operator against the formula read again in float64; the
regrouping of the source's blocks into ``GenBlock``s; the dense input
against the source's padded VALID conv; the parameter count at the
published widths; the spans and counters of a call; and MusicGAN's
configs, counts and autotune keys as they were."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from musicgan_tpu_torch.audio import functions, rebin
from musicgan_tpu_torch.config import AudioConfig, ModelConfig, config_to_json
from musicgan_tpu_torch.generate import synthesize_fn
from musicgan_tpu_torch.models import Generator, generator_param_count
from musicgan_tpu_torch.models import generator as generator_module
from musicgan_tpu_torch.ops import autotune
from musicgan_tpu_torch.ops import conv as conv_ops
from musicgan_tpu_torch.utils import profiling
from port_bench.drivers.gansynth_bank import program_state
from port_bench.reference import gansynth as ref

IMPLS = ("xla", "subpixel", "pallas", "pallas_up", "pallas_block", "pallas_bf16", "pallas_up_bf16",
         "pallas_block_bf16")
AUDIO = AudioConfig(n_fft=2048, n_vec=128, stft_stride=512, sample_rate=16000, freq_scale="mel_if", crop=64000)
PUBLISHED = ModelConfig(rand_channels=256, latent_height=1, latent_width=1, n_classes=61, dense_start=(2, 16),
                        tail_conv=True, audio=AUDIO,
                        gen_channels=((256, 256), (256, 256), (256, 256), (256, 128), (128, 64), (64, 32)))
# GANSynth's block widths 256 .. 32 cut to 32 .. 8; a 16-value latent and 5 classes.
WIDTHS = (32, 32, 32, 16, 16, 8, 8)
SMALL = dataclasses.replace(PUBLISHED, rand_channels=16, n_classes=5,
                            gen_channels=tuple(zip(WIDTHS[:-1], WIDTHS[1:])))
BATCH = 3

# Bars.  Float32 impls against the float32 reference: the same operations
# summed in another order (the sub-pixel phases, the dense product for the
# padded conv), about 1e-6 a conv over 14 convs; 1e-4 of the image's
# 2-norm.  The bf16 impls round every activation and weight to bf16 (2^-9
# relative) through the same 14 convs and PixelNorms: 0.05 of the image's
# 2-norm (they read ~0.01 here).  The waveform, the program's vocoder on the
# program's image against the reference's on that image: float32 both, the
# products' order apart; the phase is a prefix sum over 128 frames of up to
# pi, hundreds of radians, so 1e-4 of the waveform's 2-norm.
TOL_IMAGE_F32, TOL_IMAGE_BF16, TOL_WAVE = 1e-4, 5e-2, 1e-4


def rel_gap(a, b):
    """The worst row's relative 2-norm."""
    a, b = a.reshape(len(a), -1).double(), b.reshape(len(b), -1).double()
    return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())


@pytest.fixture(scope="module")
def small():
    """Seeded weights in the program and the reference, latents, labels."""
    g = torch.Generator().manual_seed(7)
    weights = ref.draw_weights(WIDTHS, SMALL.rand_channels, SMALL.n_classes, SMALL.dense_start, g, "cpu")
    gen = Generator(SMALL)
    gen.load_state_dict(program_state(weights, SMALL.n_stages))
    z = torch.randn(BATCH, 1, 1, SMALL.rand_channels, generator=g)
    labels = torch.tensor([0, 4, 2])
    with torch.no_grad():
        image = ref.generator_image(weights, z, labels, SMALL.n_classes)
    return weights, gen, z, labels, image


@pytest.mark.parametrize("impl", IMPLS)
def test_every_impl_matches_the_reference(small, impl, monkeypatch):
    """The image inside ``synthesize_fn`` against the reference generator,
    and the waveform against the reference vocoder on that image."""
    weights, gen, z, labels, want = small
    seen = {}
    forward = Generator.forward_nchw

    def observed(self, *args, **kwargs):
        seen["image"] = forward(self, *args, **kwargs)
        return seen["image"]

    monkeypatch.setattr(Generator, "forward_nchw", observed)
    waves = synthesize_fn(dataclasses.replace(SMALL, conv_impl=impl), SMALL.n_stages - 1)(gen, z, labels)
    image = seen["image"]
    assert image.shape == want.shape == (BATCH, 2, 128, 1024) and image.dtype == torch.float32
    assert rel_gap(image, want) <= (TOL_IMAGE_BF16 if impl.endswith("_bf16") else TOL_IMAGE_F32)
    assert waves.shape == (BATCH, 64000) and waves.is_contiguous()
    with torch.no_grad():
        assert rel_gap(waves, ref.vocode(image)) <= TOL_WAVE


def test_regrouped_blocks_equal_the_sources_order(small):
    """The program's library lowering (six ``GenBlock``s of conv c -> c, up,
    conv c -> c', then the tail) is the source's order of blocks (up, conv
    c -> c', conv c' -> c') to float32 rounding, and the state of the one is
    the other's weights under the mapping ``program_state`` states."""
    weights, gen, z, labels, want = small
    with torch.no_grad():
        got = gen.forward_nchw(z.permute(0, 3, 1, 2), SMALL.n_stages - 1, 1.0, "xla", labels=labels)
    assert rel_gap(got, want) <= TOL_IMAGE_F32
    assert [type(b).__name__ for b in gen.blocks] == ["GenBlock"] * 6
    assert [(b.conv1.in_channels, b.conv2.out_channels) for b in gen.blocks] == list(zip(WIDTHS[:-1], WIDTHS[1:]))
    assert gen.tail.conv.in_channels == gen.tail.conv.out_channels == WIDTHS[-1] and len(gen.heads) == 1


def test_dense_input_is_the_padded_valid_conv(small):
    """``Generator._dense_input`` against the source's first layer written
    as it is: ``F.conv2d`` of the (2, 16) kernel on the 1x1 input padded to
    (3, 31), VALID, then LeakyReLU and PixelNorm."""
    weights, gen, z, labels, _ = small
    with torch.no_grad():
        got = gen._dense_input(z.permute(0, 3, 1, 2), labels)
        x = torch.cat([z.reshape(BATCH, -1), F.one_hot(labels, SMALL.n_classes).float()], dim=1)
        x = x * torch.rsqrt((x * x).mean(dim=1, keepdim=True) + 1e-8)
        x = F.pad(x[:, :, None, None], (15, 15, 1, 1))
        assert x.shape[2:] == (3, 31)
        y = F.conv2d(x, gen.dense.weight, gen.dense.bias)
        y = torch.where(y >= 0, y, 0.2 * y)
        want = y * torch.rsqrt((y * y).mean(dim=1, keepdim=True) + 1e-8)
    assert got.shape == (BATCH, WIDTHS[0], 2, 16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _mel_matrix_by_the_formula(n_fft, sample_rate):
    """GANSynth's mel-to-linear matrix one element at a time, float64."""
    n, nyq = n_fft // 2, sample_rate / 2.0
    mel = lambda f: 1127.0 * math.log(1.0 + f / 700.0)  # noqa: E731
    hz = lambda m: 700.0 * (math.exp(m / 1127.0) - 1.0)  # noqa: E731
    edges = [mel(0.0) + (mel(nyq) - mel(0.0)) * i / (n + 1) for i in range(n + 2)]
    th, widened = 1.5 * nyq / n, 0
    for m in range(n):  # in band order, into the one list: a widened band moves the next one's centre
        lo, c, up = edges[m : m + 3]
        if hz(up) - hz(lo) < th:
            d = 1127.0 * math.asinh(0.5 * th / (hz(c) + 700.0))
            edges[m], edges[m + 2], widened = c - d, c + d, widened + 1
    w = np.zeros((n, n))
    for m in range(n):
        lo, c, up = edges[m : m + 3]
        for f in range(1, n):
            fr = nyq * f / (n - 1)
            w[f, m] = max(0.0, min((fr - hz(lo)) / (hz(c) - hz(lo)), (hz(up) - fr) / (hz(up) - hz(c))))
    s = (w @ w.T).sum(axis=0)
    a = np.zeros((n, n))
    for f in range(n):
        a[:, f] = w[f, :] * (1.0 / s[f] if abs(s[f]) > 1e-8 else s[f])
    return a, widened


@pytest.mark.parametrize("n_fft,rate", [(256, 16000), (512, 22050)])
def test_mel_to_linear_matrix_is_the_formula(n_fft, rate):
    """The program's operator (float64, and float32 on the device) against
    the formula read again element by element: the widened low bands and
    the DC bin's zero column."""
    want, widened = _mel_matrix_by_the_formula(n_fft, rate)
    got = rebin.mel_to_linear_matrix(n_fft, rate)
    assert widened > 0 and got.shape == want.shape == (n_fft // 2, n_fft // 2)
    # float64 both ways (``log1p`` against ``log``, ``linspace`` against a
    # product): some 1e-14 apart.
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert not got[:, 0].any() and got[:, 1:].any()
    dev = functions.mel_to_linear_operator(n_fft, rate, torch.device("cpu"))
    assert dev.dtype == torch.float32 and functions.mel_to_linear_operator(n_fft, rate, torch.device("cpu")) is dev
    np.testing.assert_allclose(dev.numpy(), want, rtol=1e-6, atol=1e-7)


def test_mel_band_widening_moves_the_next_band_worked_by_hand():
    """Three bands at 16 kHz over four bins (``th`` = 1.5 x 8000 / 4 = 3000
    Hz), the edges evenly spaced at ``k e``, ``e = m(8000) / 4`` (0, 614,
    1768, 3934, 8000 Hz).  Band 0 (0-1768 Hz) is narrower than 3000 Hz:
    widened to ``e -+ d``, ``d = 1127 asinh(1500 / (614 + 700))``.  Its
    upper edge is band 1's centre, which moves from 1768 to 2794 Hz; band 1
    (614-3934 Hz) and band 2 (2794-8000 Hz) are then wide enough.  A
    reading that widened each band about its own evenly spaced centre would
    leave band 1's centre at 1768 Hz."""
    mel = lambda f: 1127.0 * math.log(1.0 + f / 700.0)  # noqa: E731
    hz = lambda m: 700.0 * (math.exp(m / 1127.0) - 1.0)  # noqa: E731
    e = mel(8000.0) / 4
    d = 1127.0 * math.asinh(1500.0 / (hz(e) + 700.0))
    want = [e - d, e, e + d, 3 * e, 4 * e]
    got = rebin.mel_band_edges(3, 4, 16000)
    np.testing.assert_allclose(got, want, rtol=1e-13)
    assert round(hz(e)) == 614 and round(hz(2 * e)) == 1768 and round(hz(e + d)) == 2794
    # Band 1's triangle over 614, 2794, 3934 Hz at the bins 2666.7 and
    # 5333.3 Hz; band 2's over 2794, 3934, 8000 Hz; the DC row zero.
    f1, f2 = 8000.0 / 3, 16000.0 / 3
    lo, c, up = hz(e), hz(e + d), hz(3 * e)
    w = rebin.linear_to_mel_weight_matrix(3, 4, 16000)
    assert w.shape == (4, 3) and not w[0].any()
    np.testing.assert_allclose(w[1, 1], min((f1 - lo) / (c - lo), (up - f1) / (up - c)), rtol=1e-12)
    np.testing.assert_allclose(w[2, 2], (hz(4 * e) - f2) / (hz(4 * e) - hz(3 * e)), rtol=1e-12)
    assert w[1, 1] == pytest.approx(0.9414, abs=1e-4)


def test_mel_to_linear_matrix_at_gansynths_size_is_the_references():
    """At n_fft 2048 and 16 kHz the program's and the reference's readings
    of the formula agree to float64 rounding."""
    np.testing.assert_allclose(rebin.mel_to_linear_matrix(2048, 16000), ref.mel_to_linear_matrix(2048, 16000),
                               rtol=0, atol=1e-12)


def test_mel_if_spectrum_is_the_formula():
    """``mel_if_to_real_imag`` against ``sqrt(exp(8 Y0 - 5) @ A + 1e-6)
    e^{i cumsum_t(pi Y1) @ A}`` in float64, with a zero Nyquist row."""
    g = torch.Generator().manual_seed(3)
    img = torch.rand(2, 2, 16, 64, generator=g) * 2 - 1
    cfg = AudioConfig(n_fft=128, n_vec=16, stft_stride=32, sample_rate=16000, freq_scale="mel_if")
    n0 = functions.mel_to_linear.launches
    real, imag = functions.mel_if_to_real_imag(img, cfg)
    assert functions.mel_to_linear.launches == n0 + 2
    a = torch.from_numpy(rebin.mel_to_linear_matrix(128, 16000))
    x = img.double()
    spec = torch.polar(torch.sqrt(torch.exp(x[:, 0] * 8 - 5) @ a + 1e-6), torch.cumsum(x[:, 1] * math.pi, 1) @ a)
    assert real.shape == imag.shape == (2, 65, 16)
    torch.testing.assert_close(real[:, :64].double(), spec.real.transpose(1, 2), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(imag[:, :64].double(), spec.imag.transpose(1, 2), rtol=1e-4, atol=1e-5)
    assert not real[:, 64].any() and not imag[:, 64].any()


def test_published_parameter_count():
    """7,308,802 with the final head: the dense input 2,597,120, block 1's
    conv 590,080, blocks 2-7 6,121,536, the head 66; the module holds as
    many."""
    assert generator_param_count(PUBLISHED) == generator_param_count(PUBLISHED, 5) == 7_308_802
    assert sum(p.numel() for p in Generator(PUBLISHED).parameters()) == 7_308_802
    with pytest.raises(ValueError, match="stage 5 alone"):
        generator_param_count(PUBLISHED, 4)


def test_grown_only_refuses_a_partial_stage_a_fade_and_training(small):
    _, gen, z, labels, _ = small
    zn = z.permute(0, 3, 1, 2)
    for stage, alpha, impl in ((4, 1.0, "xla"), (5, 0.5, "xla"), (5, 1.0, "pallas_gp")):
        with pytest.raises(ValueError, match="runs grown only"):
            gen.forward_nchw(zn, stage, alpha, impl, labels=labels)
    with pytest.raises(ValueError, match="a label a row"):
        gen.forward_nchw(zn, 5, 1.0, "xla")


def test_init_is_the_equalized_learning_rates_scale():
    """Weights ``N(0, 2 / fan_in)`` (the head ``1 / fan_in``), zero biases."""
    gen = Generator(PUBLISHED, seed=5)
    for name, p in gen.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        fan_in = p[0].numel()
        gain = 1.0 if name.startswith("heads") else 2.0
        assert float(p.detach().var()) == pytest.approx(gain / fan_in, rel=0.1 if p.numel() > 1000 else 0.6), name


def _tree(recorded):
    """Each span's name with its parent's name."""
    by = {s.index: s for s in recorded}
    return sorted({(s.name, by[s.parent].name if s.parent is not None else None) for s in recorded})


def test_spans_and_counters_per_call(small):
    """Two calls under ``pallas_up_bf16``'s plain versions: each call's
    spans (``mg.synth.latent`` in the generator, ``mg.synth.mel`` in the
    spectrum), two mel products a call; nothing launches on the CPU."""
    _, gen, z, labels, _ = small
    synth = synthesize_fn(dataclasses.replace(SMALL, conv_impl="pallas_up_bf16"), SMALL.n_stages - 1)
    n0 = (functions.mel_to_linear.launches, conv_ops.fused_conv3x3.cluster_launches,
          conv_ops.fused_upconv3x3.cluster_launches)
    profiling.clear_spans()
    with profiling.recording():
        for _ in range(2):
            synth(gen, z, labels)
    recorded = profiling.spans()
    profiling.clear_spans()
    assert (functions.mel_to_linear.launches, conv_ops.fused_conv3x3.cluster_launches,
            conv_ops.fused_upconv3x3.cluster_launches) == (n0[0] + 4, n0[1], n0[2])
    assert _tree(recorded) == [
        ("mg.synth.call", None), ("mg.synth.generator", "mg.synth.call"), ("mg.synth.latent", "mg.synth.generator"),
        ("mg.synth.mel", "mg.synth.spectrum"), ("mg.synth.resolve", "mg.synth.call"),
        ("mg.synth.spectrum", "mg.synth.vocoder"), ("mg.synth.vocoder", "mg.synth.call")]
    assert sum(s.name == "mg.synth.latent" for s in recorded) == sum(s.name == "mg.synth.mel" for s in recorded) == 2


@pytest.mark.parametrize("cout,pixel_norm,clustered", [(256, True, True), (144, True, True), (128, True, False),
                                                       (256, False, False), (16, True, False)])
def test_cluster_launches_are_pixel_norm_past_one_block(cout, pixel_norm, clustered):
    assert conv_ops.splits_pixel_norm(cout, pixel_norm) is clustered


def test_the_condition_is_the_one_hot_joined():
    x = torch.randn(3, 4)
    got = generator_module.condition(x, torch.tensor([2, 0, 1]), 3)
    torch.testing.assert_close(got, torch.cat([x, torch.eye(3)[[2, 0, 1]]], dim=1), rtol=0, atol=0)
    assert generator_module.condition(x, None, 0) is x


# ---- MusicGAN as it was.

MODEL_JSON = {
    "rand_channels": 32, "latent_height": 2, "latent_width": 2,
    "gen_channels": [[32, 128], [128, 112], [112, 96], [96, 80], [80, 64], [64, 48], [48, 32], [32, 16]],
    "disc_channels": [[16, 32], [32, 48], [48, 64], [64, 80], [80, 96], [96, 112], [112, 128], [128, 144],
                      [144, 160]],
    "leaky_slope": 0.2, "pixel_norm_eps": 1e-08, "conv_impl": "auto",
}
AUDIO_JSON = {"n_fft": 1024, "n_vec": 512, "stft_stride": 256, "sample_rate": 44100}


def test_musicgans_configs_write_what_they_wrote():
    """``config_to_json`` of ``ModelConfig()`` and ``AudioConfig()`` byte for
    byte as before GANSynth's fields; MusicGAN's topology is empty."""
    assert config_to_json(ModelConfig()) == json.dumps(MODEL_JSON, indent=2)
    assert config_to_json(AudioConfig()) == json.dumps(AUDIO_JSON, indent=2)
    assert ModelConfig().topology == "" and not ModelConfig().grown_only
    assert ModelConfig().audio_config == AudioConfig() and ModelConfig().frames((2, 20)) == 5120
    assert json.loads(config_to_json(PUBLISHED))["audio"]["freq_scale"] == "mel_if"


def test_musicgans_generator_and_call_as_before():
    """902,132 parameters at stage 7; the module's parameters as they were
    named; a call's spans without the dense input's or the mel products',
    and no mel product."""
    cfg = dataclasses.replace(ModelConfig(), conv_impl="pallas_up_bf16")
    assert generator_param_count(ModelConfig(), 7) == 902_132
    gen = Generator(ModelConfig(), seed=0)
    assert not hasattr(gen, "dense") and not hasattr(gen, "tail") and len(gen.heads) == 8
    assert {k.split(".")[0] for k in gen.state_dict()} == {"blocks", "heads"}
    n0 = functions.mel_to_linear.launches
    profiling.clear_spans()
    with profiling.recording():
        waves = synthesize_fn(cfg, 0)(gen, torch.randn(1, 2, 2, 32))
    names = {s.name for s in profiling.spans()}
    profiling.clear_spans()
    assert waves.shape == (1, (2 * 2**8 - 1) * 256)
    assert functions.mel_to_linear.launches == n0
    assert names == {"mg.synth.call", "mg.synth.resolve", "mg.synth.generator", "mg.synth.vocoder",
                     "mg.synth.spectrum"}


@pytest.fixture
def fake_card(tmp_path, monkeypatch):
    monkeypatch.setenv("MUSICGAN_AUTOTUNE_DIR", str(tmp_path / "autotune"))
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_backend", lambda device: "cuda:test card")
    monkeypatch.setattr(autotune, "_capturing", lambda device: False)
    monkeypatch.setattr(autotune, "measure_conv_impls",
                        lambda cfg, z, s, cand, device=None: {c: float(c != "pallas_up_bf16") for c in cand})
    monkeypatch.setattr(autotune, "measure_istft_impls",
                        lambda n_bins, t, device=None, **geometry: {"xla": 2.0, "pallas": 1.0})


def test_autotune_keys(fake_card):
    """MusicGAN's keys are the strings they were; GANSynth's carry its
    topology and its n_fft and hop, so neither model's winner is read for
    the other."""
    card = torch.device("cuda")  # only named: nothing is allocated on it
    autotune.resolve_conv_impl(ModelConfig(), (20, 2, 20, 32), 7, device=card)
    autotune.resolve_istft_impl(5120, device=card)
    autotune.resolve_conv_impl(PUBLISHED, (122, 1, 1, 256), 5, device=card)
    autotune.resolve_istft_impl(128, n_bins=1025, device=card, n_fft=2048, hop=512)
    cands = "('xla', 'subpixel', 'pallas', 'pallas_bf16', 'pallas_up', 'pallas_up_bf16')"
    assert sorted(autotune._load_persisted()) == sorted([
        f"v1|cuda:test card|s7|20x2x20x32|float32|{cands}",
        "v1|cuda:test card|istft|513x5120|('xla', 'pallas')",
        f"v1|cuda:test card|s5|122x1x1x256|float32|{cands}|dense2x16+cls61+tail",
        "v1|cuda:test card|istft|1025x128|n2048h512|('xla', 'pallas')",
    ])


def test_a_gansynth_measurement_on_the_cpu():
    """``measure_conv_impls`` builds the topology it is given, labels and
    all, and times its candidates (the plain versions here)."""
    times = autotune.measure_conv_impls(SMALL, (2, 1, 1, SMALL.rand_channels), SMALL.n_stages - 1,
                                        ("xla", "pallas_up_bf16"), device="cpu")
    assert set(times) == {"xla", "pallas_up_bf16"} and all(t >= 0 for t in times.values())
