"""GANSynth on the card: K1 bf16 and K3 bf16 at its 256-channel shapes (the
route that splits PixelNorm over a cluster of two), K5 at n_fft 2048 and hop
512, and the whole published-width path against the benchmark's plain
reference, with the launches of a call; MusicGAN's launches of a call as
they were.

Every test needs the card and skips without one.  The file imports no JAX:

    python -m pytest tests/test_torch_gansynth_cuda.py --noconftest -q
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from musicgan_tpu_torch.audio import functions
from musicgan_tpu_torch.audio.stft import istft_real_imag
from musicgan_tpu_torch.config import ModelConfig
from musicgan_tpu_torch.generate import synthesize_fn
from musicgan_tpu_torch.models import Generator
from musicgan_tpu_torch.ops import conv as conv_ops
from musicgan_tpu_torch.ops import head as head_ops
from musicgan_tpu_torch.ops import istft_fused as istft_ops

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
BF = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def published():
    from port_bench.drivers.gansynth_bank import model_config

    return model_config(json.loads((REPO / "port_bench/configs/gansynth-ifmel-h.json").read_text()))


def assert_within_bf16_ulp(got, ref):
    """One bf16 ulp of the plain version (float32 sums of the same bf16
    operands, rounded once), plus 1e-5 for results near zero that the two
    orders of summing move across LeakyReLU's kink (``PERF.md`` section 6's
    bars, ``tests/test_torch_cuda.py``'s)."""
    assert got.dtype == ref.dtype == BF and got.shape == ref.shape
    a, b = got.float(), ref.float()
    bad = (a - b).abs() > 2.0**-7 * torch.maximum(a.abs(), b.abs()) + 1e-5
    assert not bad.any(), f"{int(bad.sum())} of {bad.numel()} past one bf16 ulp"


# (b, cin, cout, h, w): each K1 (cin -> cin) and K3 (cin -> cout) of a
# 122-note call at 256 channels.
K1_SHAPES = [(122, 256, 256, 2 * 2**i, 16 * 2**i) for i in range(4)]
K3_SHAPES = [(122, 256, 256, 2 * 2**i, 16 * 2**i) for i in range(3)] + [(122, 256, 128, 16, 128)]


@pytest.mark.parametrize("kind,b,cin,cout,h,w", [("conv3x3", *s) for s in K1_SHAPES] +
                         [("upconv3x3", *s) for s in K3_SHAPES])
def test_bf16_at_256_channels_on_the_cluster_route(cuda, kind, b, cin, cout, h, w):
    """Within one bf16 ulp of the plain version; the launcher's plan is the
    mirror's and splits PixelNorm over a cluster of two where ``cout`` is
    past 128; ``.cluster_launches`` counts it; the same bits twice."""
    from musicgan_tpu_torch.ops import conv_bf16

    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(b, cin, h, w, generator=g, device=cuda).to(BF)
    wt = torch.randn(cout, cin, 3, 3, generator=g, device=cuda) * (2.0 / (9 * cin)) ** 0.5
    bias = torch.randn(cout, generator=g, device=cuda) * 0.1
    up = kind == "upconv3x3"
    fn, plain = (conv_ops.fused_upconv3x3, conv_ops.upconv3x3_plain) if up else \
        (conv_ops.fused_conv3x3, conv_ops.conv3x3_plain)
    plan = conv_ops.conv_plan(kind, b, cin, cout, h, w, True, BF)
    mirror = conv_bf16.plan(2 if up else 3, b, cin, cout, h, w, True,
                            torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert all(plan[k] == mirror[k] for k in ("route", "tc", "th", "nb", "nsplit", "cluster", "blocks"))
    assert plan["cluster"] == (2 if cout > 128 else 1)
    wp = conv_ops.kernel_weights_tc(wt, up)
    n0 = (fn.launches, fn.cluster_launches)
    got = fn(x, wt, bias, 0.2, True, 1e-8, w_packed=wp, out_dtype=BF)
    assert (fn.launches, fn.cluster_launches) == (n0[0] + 1, n0[1] + (cout > 128))
    assert_within_bf16_ulp(got, plain(x, wt, bias, 0.2, True, 1e-8))
    assert torch.equal(got, fn(x, wt, bias, 0.2, True, 1e-8, w_packed=wp, out_dtype=BF))


def test_k5_at_2048_and_512_matches_torch_istft(cuda):
    """K5 on the FFT route at GANSynth's call, (122, 1025, 128), not
    normalized, against ``torch.istft`` (centred, periodic Hann) and the
    plain matmul iSTFT, float32 all three: 1e-5 of the 2-norm.  The spectra
    are a real signal's, no imaginary part at DC and Nyquist (cuFFT's
    inverse reads one there, K5 and the plain version do not)."""
    assert istft_ops.uses_fft(2048, 512)
    rng = np.random.default_rng(5)
    re, im = (torch.tensor(rng.standard_normal((122, 1025, 128)), dtype=torch.float32, device=cuda)
              for _ in range(2))
    im[:, 0] = im[:, -1] = 0.0
    n0 = istft_ops.istft_fused.launches
    got = istft_ops.istft_fused(re, im, 2048, 512, normalized=False)
    assert istft_ops.istft_fused.launches == n0 + 1 and got.shape == (122, 127 * 512)
    window = torch.hann_window(2048, periodic=True, device=cuda)
    want = torch.istft(torch.complex(re, im), 2048, 512, window=window, center=True, normalized=False)
    assert float((got - want).norm() / want.norm()) <= 1e-5
    plain = istft_real_imag(re, im, 2048, 512, normalized=False)
    assert float((got - plain).norm() / plain.norm()) <= 1e-5


def test_the_published_path_matches_the_reference(cuda):
    """Eight notes of the published-width generator and vocoder under
    ``pallas_up_bf16`` and "auto", against the reference generator (the
    cell's ``image_gap`` limit) and the reference vocoder on the program's
    image (its ``wave_gap`` limit), the pitch's own effect on the image
    (its ``pitch_gap`` limit); one call's launches: K1 bf16 seven times
    (four of them over a cluster), K3 bf16 six (three), the head and K5 once,
    two mel products."""
    from port_bench.drivers.gansynth_bank import pitch_shares, program_state, widths
    from port_bench.reference import gansynth as ref

    cfg = published()
    limits = json.loads((REPO / "port_bench/configs/gansynth-ifmel-h.json").read_text())["limits"]
    g = torch.Generator(device=cuda).manual_seed(21)
    weights = ref.draw_weights(widths(cfg), cfg.rand_channels, cfg.n_classes, cfg.dense_start, g, cuda)
    gen = Generator(cfg, device=cuda)
    gen.load_state_dict(program_state(weights, cfg.n_stages))
    z = torch.randn(8, 1, 1, cfg.rand_channels, generator=g, device=cuda)
    labels = torch.arange(0, 61, 8, device=cuda)
    with torch.no_grad():
        want = ref.generator_image(weights, z, labels, cfg.n_classes)
        unpitched = ref.generator_image(weights, z, None, cfg.n_classes)
    seen = {}
    forward = gen.forward_nchw

    def observed(*args, **kwargs):
        seen["image"] = forward(*args, **kwargs)
        return seen["image"]

    gen.forward_nchw = observed
    counters = (conv_ops.fused_conv3x3, conv_ops.fused_upconv3x3)

    def counts():
        return ([(f.bf16_launches, f.cluster_launches) for f in counters], head_ops.head1x1.launches,
                istft_ops.istft_fused.launches, functions.mel_to_linear.launches)

    for impl in ("pallas_up_bf16", "auto"):
        synth = synthesize_fn(dataclasses.replace(cfg, conv_impl=impl), cfg.n_stages - 1)
        synth(gen, z, labels)
        before = counts()
        waves = synth(gen, z, labels)
        after = counts()
        image = seen["image"]
        gap = ((image - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max().item()
        assert gap <= limits["image_gap"], (impl, gap)
        assert max(pitch_shares(image, want, unpitched)) <= limits["pitch_gap"], impl
        with torch.no_grad():
            voc = ref.vocode(image)
        wave_gap = ((waves - voc).norm(dim=1) / voc.norm(dim=1)).max().item()
        assert waves.shape == (8, 64000) and wave_gap <= limits["wave_gap"], (impl, wave_gap)
        assert after[3] - before[3] == 2
        if impl == "pallas_up_bf16":
            assert [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after[0], before[0])] == [(7, 4), (6, 3)]
            assert (after[1] - before[1], after[2] - before[2]) == (1, 1)


def test_musicgans_launches_a_call_as_before(cuda):
    """MusicGAN's call under ``pallas_up_bf16``: K1 bf16 and K3 bf16 eight
    times each, none over a cluster, the head and K5 once, no mel product."""
    cfg = dataclasses.replace(ModelConfig(), conv_impl="pallas_up_bf16")
    gen = Generator(cfg, device=cuda)
    synth = synthesize_fn(cfg, 7)
    z = torch.randn(2, 2, 4, 32, device=cuda)
    synth(gen, z)
    fns = (conv_ops.fused_conv3x3, conv_ops.fused_upconv3x3)
    before = ([(f.bf16_launches, f.cluster_launches) for f in fns], head_ops.head1x1.launches,
              istft_ops.istft_fused.launches, functions.mel_to_linear.launches)
    assert synth(gen, z).shape == (2, (4 * 256 - 1) * 256)
    after = ([(f.bf16_launches, f.cluster_launches) for f in fns], head_ops.head1x1.launches,
             istft_ops.istft_fused.launches, functions.mel_to_linear.launches)
    assert [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after[0], before[0])] == [(8, 0), (8, 0)]
    assert (after[1] - before[1], after[2] - before[2], after[3] - before[3]) == (1, 1, 0)
