"""Kernel-vs-plain parity of the port's CUDA kernels, on an NVIDIA GPU.

Every test here needs the card and skips without one.  The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The plain versions run on the same card with TF32 off (cuDNN convolutions
default to TF32), so the comparison measures the kernel, not TF32.
"""

import numpy as np
import pytest
import torch

from musicgan_tpu_torch.audio.stft import istft_real_imag
from musicgan_tpu_torch.ops import conv as conv_ops
from musicgan_tpu_torch.ops import conv_vjp
from musicgan_tpu_torch.ops import istft_fused as istft_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _conv_inputs(seed, b, cin, cout, h, w, device):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((b, cin, h, w)), dtype=torch.float32, device=device)
    wt = torch.tensor(rng.standard_normal((cout, cin, 3, 3)) * 0.1, dtype=torch.float32, device=device)
    bias = torch.tensor(rng.standard_normal(cout) * 0.1, dtype=torch.float32, device=device)
    return x, wt, bias


def _block_inputs(seed, b, cin, cmid, cout, h, w, device):
    x, w1, b1 = _conv_inputs(seed, b, cin, cmid, h, w, device)
    _, w2, b2 = _conv_inputs(seed + 1, 1, cmid, cout, 1, 1, device)
    return x, w1, b1, w2, b2


# K4: the two shapes of tests/test_ops.py (cmid != cin), ragged edges of its
# 62-column strips and of runs and tiles of 2, 4 and 8 rows, one pixel,
# widths that are no multiple of 16, 128 channels, and blocks 5-7 of the
# generator cut down.
BLOCK_SHAPES = [
    (1, 16, 24, 32, 8, 256), (2, 8, 8, 8, 4, 128), (2, 5, 7, 3, 13, 37), (1, 32, 32, 16, 1, 1),
    (1, 48, 48, 32, 7, 61), (3, 64, 64, 48, 31, 29), (1, 32, 32, 128, 2, 20), (1, 20, 100, 120, 5, 33),
    (2, 16, 16, 16, 33, 70), (1, 32, 32, 16, 43, 91), (1, 9, 128, 128, 3, 31),
]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("b,cin,cmid,cout,h,w", BLOCK_SHAPES)
def test_fused_block_kernel_matches_plain_and_the_pair(cuda, b, cin, cmid, cout, h, w, packed):
    """One launch of K4 against its plain version (2e-4: two convs compound)
    and, where K1 and K3 take the conv template's large-image route at these
    sizes, against K1 then K3 at 1e-6: K4 is built from the same tensor-core
    pieces and sums every pixel in their order."""
    x, w1, b1, w2, b2 = _block_inputs(2, b, cin, cmid, cout, h, w, cuda)
    kw = dict(w1_packed=conv_ops.kernel_weights(w1), w2_packed=conv_ops.kernel_upconv_weights(w2)) if packed else {}
    n0 = (conv_ops.fused_block.launches, conv_ops.fused_conv3x3.launches, conv_ops.fused_upconv3x3.launches)
    got = conv_ops.fused_block(x, w1, b1, w2, b2, 0.2, 1e-8, **kw)
    torch.cuda.synchronize()
    assert (conv_ops.fused_block.launches, conv_ops.fused_conv3x3.launches,
            conv_ops.fused_upconv3x3.launches) == (n0[0] + 1, n0[1], n0[2])
    assert got.shape == (b, cout, 2 * h, 2 * w)
    ref = conv_ops.fused_block_plain(x, w1, b1, w2, b2, 0.2, 1e-8)
    assert (got - ref).abs().max().item() < 2e-4
    if _pair_is_large(b, cin, cmid, cout, h, w):
        pair = conv_ops.fused_upconv3x3(
            conv_ops.fused_conv3x3(x, w1, b1, 0.2, True, 1e-8), w2, b2, 0.2, True, 1e-8)
        assert (got - pair).abs().max().item() <= 1e-6


def _pair_is_large(b, cin, cmid, cout, h, w) -> bool:
    """K1 then K3 at a block's sizes both take the large-image route."""
    return (conv_ops.conv_plan("conv3x3", b, cin, cmid, h, w, True)["route"] == "large_tc"
            and conv_ops.conv_plan("upconv3x3", b, cmid, cout, h, w, True)["route"] == "large_tc")


@pytest.mark.parametrize("b,cin,cmid,cout,h,w", [(2, 16, 32, 16, 128, 160), (1, 48, 48, 32, 130, 300)])
def test_fused_block_equals_the_pair_in_the_large_shape(cuda, b, cin, cmid, cout, h, w):
    """Sizes at which K1 and K3 take the large-image route: K4 against the
    pair at 1e-6 (both sum in one order: in fact bit for bit)."""
    assert _pair_is_large(b, cin, cmid, cout, h, w)
    x, w1, b1, w2, b2 = _block_inputs(3, b, cin, cmid, cout, h, w, cuda)
    got = conv_ops.fused_block(x, w1, b1, w2, b2, 0.2, 1e-8)
    pair = conv_ops.fused_upconv3x3(conv_ops.fused_conv3x3(x, w1, b1, 0.2, True, 1e-8), w2, b2, 0.2, True, 1e-8)
    assert (got - pair).abs().max().item() <= 1e-6


# Past 128 channels each conv of K4 is split over a cluster of blocks; the
# second shape is the width past 128 that chip_smoke.py holds at 32 x 320,
# the others reach the cluster of 8 from either side.
@pytest.mark.parametrize("b,cin,cmid,cout,h,w", [
    (1, 8, 144, 136, 5, 9), (2, 16, 144, 160, 32, 320), (1, 16, 1024, 16, 4, 64), (1, 16, 64, 1000, 3, 70),
])
def test_fused_block_past_128_channels(cuda, b, cin, cmid, cout, h, w):
    x, w1, b1, w2, b2 = _block_inputs(5, b, cin, cmid, cout, h, w, cuda)
    assert conv_ops.block_tile(cmid, cout)["cluster"] > 1
    got = conv_ops.fused_block(x, w1, b1, w2, b2, 0.2, 1e-8)
    ref = conv_ops.fused_block_plain(x, w1, b1, w2, b2, 0.2, 1e-8)
    assert got.shape == (b, cout, 2 * h, 2 * w)
    assert (got - ref).abs().max().item() < 2e-4
    assert torch.equal(got, conv_ops.fused_block(x, w1, b1, w2, b2, 0.2, 1e-8))  # rank order: repeatable


def test_fused_block_tile_is_the_kernels_own(cuda):
    """``block_tile`` (what ``fused_block_fits`` rests on) against the
    tile the compiled launcher computes."""
    import ctypes

    from musicgan_tpu_torch.ops import _build

    lib = _build.load("block3x3")
    lib.mg_block3x3_tile.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.mg_block3x3_tile.restype = ctypes.c_int
    keys = ("n1", "n2", "nsplit1", "nsplit2", "cluster", "t1", "dys", "th1", "th2", "ring_rows",
            "stages", "smem_bytes")
    for cmid, cout in [(32, 16), (48, 32), (64, 48), (32, 128), (100, 120), (7, 3), (128, 128),
                       (144, 136), (1024, 16), (16, 1024), (200, 40)]:
        out = (ctypes.c_int * len(keys))()
        assert lib.mg_block3x3_tile(cmid, cout, out) == 0
        tile = conv_ops.block_tile(cmid, cout)
        assert dict(zip(keys, out)) == {k: tile[k] for k in keys}
    assert lib.mg_block3x3_tile(1025, 16, None) == 1 and conv_ops.block_tile(1025, 16) is None
    # The size rule: the launcher's against ops/conv.py's mirror of it.
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for i, (cin, cout) in enumerate(((32, 128), (128, 112), (112, 96), (96, 80), (80, 64), (64, 48),
                                     (48, 32), (32, 16))):
        for bsz, wl in ((5, 20), (2, 4), (1, 2), (6, 40)):
            size = (bsz, cin, cin, cout, 2 * 2**i, wl * 2**i)
            assert conv_ops.block_plan(*size)["takes"] == conv_ops.block_takes(*size, sms), size


def test_fused_block_refuses_what_the_kernel_does_not_take(cuda):
    x, w1, b1, w2, b2 = _block_inputs(0, 1, 8, 8, 8, 4, 4, cuda)
    with pytest.raises(ValueError, match="float32"):
        conv_ops.fused_block(x.double(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="packed weights"):
        conv_ops.fused_block(x, w1, b1, w2, b2, w1_packed=conv_ops.kernel_weights(w2[:, :4]))
    with pytest.raises(ValueError, match="bias"):
        conv_ops.fused_block(x, w1, None, w2, b2)
    # 136 mid channels compute (a cluster of two blocks); past 1,024 raises.
    _, wide, b_wide = _conv_inputs(1, 1, 8, 136, 1, 1, cuda)
    _, w2_wide, _ = _conv_inputs(2, 1, 136, 8, 1, 1, cuda)
    got = conv_ops.fused_block(x, wide, b_wide, w2_wide, b2)
    assert (got - conv_ops.fused_block_plain(x, wide, b_wide, w2_wide, b2)).abs().max().item() < 2e-4
    with pytest.raises(ValueError, match="PixelNorm"):
        conv_ops.fused_block(x, torch.zeros(1025, 8, 3, 3, device=cuda), torch.zeros(1025, device=cuda),
                             torch.zeros(8, 1025, 3, 3, device=cuda), b2)


def test_generator_pallas_block_on_the_card(cuda):
    """The inference forward under ``conv_impl="pallas_block"``: K4 for the
    blocks its size rule takes (5-7 at 2 clips of nb_vec 10), K1 + K3 for
    the others, the image within 1e-6 of the default path's (K4 sums in the
    pair's order)."""
    import dataclasses

    from musicgan_tpu_torch.config import ModelConfig
    from musicgan_tpu_torch.models import Generator

    cfg = ModelConfig(conv_impl="pallas_block")
    gen = Generator(cfg, device=cuda, seed=4)
    ref = Generator(dataclasses.replace(cfg, conv_impl="pallas_up"), device=cuda, seed=4)
    z = torch.randn(2, 32, 2, 20, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    for i in (5, 6, 7):
        cin, cout = cfg.gen_channels[i]
        assert _pair_is_large(2, cin, cin, cout, 2 * 2**i, 20 * 2**i)
    n0 = (conv_ops.fused_block.launches, conv_ops.fused_conv3x3.launches, conv_ops.fused_upconv3x3.launches)
    with torch.no_grad():
        got = gen.forward_nchw(z, 7)
        torch.cuda.synchronize()
        n1 = (conv_ops.fused_block.launches, conv_ops.fused_conv3x3.launches, conv_ops.fused_upconv3x3.launches)
        want = ref.forward_nchw(z, 7)
    assert tuple(a - b for a, b in zip(n1, n0)) == (3, 5, 5)  # blocks 5, 6, 7 take K4
    assert (got - want).abs().max().item() <= 1e-6


# Ragged edges (2x2 and 2x20 of block 0, widths that are not a multiple of
# the 32-column tile), cin not a multiple of the 8-channel step, cout not a
# multiple of the 16-channel warp group, and the largest cout (128).
CONV_SHAPES = [
    (2, 32, 32, 2, 2), (5, 32, 128, 2, 20), (1, 5, 7, 3, 37),
    (2, 12, 20, 9, 33), (1, 128, 112, 8, 80), (1, 32, 16, 64, 160),
]


@pytest.mark.parametrize("epilogue", [True, False])
@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES)
def test_fused_conv3x3_kernel_matches_plain(cuda, b, cin, cout, h, w, epilogue):
    x, wt, bias = _conv_inputs(0, b, cin, cout, h, w, cuda)
    kw = dict(slope=0.2, pixel_norm=True) if epilogue else {}
    n0 = conv_ops.fused_conv3x3.launches
    got = conv_ops.fused_conv3x3(x, wt, bias, **kw)
    torch.cuda.synchronize()
    assert conv_ops.fused_conv3x3.launches == n0 + 1
    ref = conv_ops.conv3x3_plain(x, wt, bias, **kw)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    prepacked = conv_ops.fused_conv3x3(x, wt, bias, **kw, w_packed=conv_ops.kernel_weights(wt))
    torch.testing.assert_close(prepacked, got, atol=0, rtol=0)


# Past 128 channels the kernel splits the channel groups over several blocks
# (the critic's last blocks: 144 and 160, at 2x2 and 1x1 pixels), with and
# without a bias, and in the input-gradient role (cin > 128 too); with
# PixelNorm those blocks are one cluster and share the per-pixel sums.
WIDE_SHAPES = [
    (6, 128, 144, 2, 2), (6, 144, 144, 1, 1), (2, 144, 160, 5, 37),
    (6, 160, 160, 1, 1), (2, 160, 144, 9, 33), (1, 24, 272, 4, 40),
]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("b,cin,cout,h,w", WIDE_SHAPES)
def test_fused_conv3x3_kernel_takes_more_than_128_channels(cuda, b, cin, cout, h, w, bias):
    x, wt, bvec = _conv_inputs(4, b, cin, cout, h, w, cuda)
    bvec = bvec if bias else None
    slope = 0.2 if bias else None
    got = conv_ops.fused_conv3x3(x, wt, bvec, slope)
    torch.cuda.synchronize()
    ref = conv_ops.conv3x3_plain(x, wt, bvec, slope)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    got_pn = conv_ops.fused_conv3x3(x, wt, bvec, slope, pixel_norm=True)
    ref_pn = conv_ops.conv3x3_plain(x, wt, bvec, slope, pixel_norm=True)
    torch.testing.assert_close(got_pn, ref_pn, atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES)
def test_fused_conv3x3_msq_kernel_matches_plain(cuda, b, cin, cout, h, w):
    """K2: ``y`` at the conv bar (1e-4), the pre-norm mean-square map at
    1e-4 relative to its largest value."""
    x, wt, bias = _conv_inputs(5, b, cin, cout, h, w, cuda)
    n0 = conv_ops.fused_conv3x3_msq.launches
    y, m = conv_ops.fused_conv3x3_msq(x, wt, bias, 0.2, 1e-8)
    torch.cuda.synchronize()
    assert conv_ops.fused_conv3x3_msq.launches == n0 + 1
    y_ref, m_ref = conv_ops.conv3x3_msq_plain(x, wt, bias, 0.2, 1e-8)
    assert m.shape == m_ref.shape == (b, 1, h, w)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=0)
    assert float((m - m_ref).abs().max() / m_ref.abs().max()) < 1e-4
    # the same y as K1 with PixelNorm gives
    torch.testing.assert_close(y, conv_ops.fused_conv3x3(x, wt, bias, 0.2, True), atol=0, rtol=0)


@pytest.mark.parametrize("slope,pn", [(0.2, True), (0.2, False), (None, False)])
@pytest.mark.parametrize("b,cin,cout,h,w", [(2, 12, 20, 9, 33), (1, 32, 16, 64, 160), (2, 144, 160, 2, 2)])
def test_conv3x3_act_gradients_match_plain_autograd(cuda, b, cin, cout, h, w, slope, pn):
    """The Function's three gradients (input gradient on K1, the library's
    weight gradient, the bias sum) against ordinary autograd through the
    plain version, each relative to the plain gradient's largest value."""
    x, wt, bias = _conv_inputs(6, b, cin, cout, h, w, cuda)
    cot = torch.tensor(
        np.random.default_rng(7).standard_normal((b, cout, h, w)), dtype=torch.float32, device=cuda
    )
    grads = {}
    for name, fn in (("kernel", conv_vjp.conv3x3_act), ("plain", conv_vjp.conv3x3_act_plain)):
        leaves = [t.clone().requires_grad_(True) for t in (x, wt, bias)]
        n1 = conv_ops.fused_conv3x3.launches + conv_ops.fused_conv3x3_msq.launches
        y = fn(*leaves, slope, pn, 1e-8)
        grads[name] = (y.detach(), *torch.autograd.grad((y * cot).sum(), leaves))
        launched = conv_ops.fused_conv3x3.launches + conv_ops.fused_conv3x3_msq.launches - n1
        assert launched == (2 if name == "kernel" else 0)  # forward + input gradient
    torch.cuda.synchronize()
    for got, ref in zip(grads["kernel"], grads["plain"]):
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-4


def test_conv3x3_act_is_differentiable_once_only(cuda):
    x, wt, bias = _conv_inputs(8, 1, 8, 8, 4, 4, cuda)
    x.requires_grad_(True)
    cot = torch.ones(1, 8, 4, 4, device=cuda, requires_grad=True)
    y = conv_vjp.conv3x3_act(x, wt, bias)
    (dx,) = torch.autograd.grad((y * cot).sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.sum().backward()


@pytest.mark.parametrize("epilogue", [True, False])
@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES)
def test_fused_upconv3x3_kernel_matches_plain(cuda, b, cin, cout, h, w, epilogue):
    x, wt, bias = _conv_inputs(1, b, cin, cout, h, w, cuda)
    kw = dict(slope=0.2, pixel_norm=True) if epilogue else {}
    n0 = conv_ops.fused_upconv3x3.launches
    got = conv_ops.fused_upconv3x3(x, wt, bias, **kw)
    torch.cuda.synchronize()
    assert conv_ops.fused_upconv3x3.launches == n0 + 1
    ref = conv_ops.upconv3x3_plain(x, wt, bias, **kw)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    prepacked = conv_ops.fused_upconv3x3(
        x, wt, bias, **kw, w_packed=conv_ops.kernel_upconv_weights(wt)
    )
    torch.testing.assert_close(prepacked, got, atol=0, rtol=0)


@pytest.mark.parametrize("b,t", [
    (1, 257), (3, 300), (2, 512),
    *[(b, t) for t in (1, 2, 3, 4, 5, 17, 257, 300, 512, 5120) for b in (1, 3, 5, None)],
])
def test_istft_fused_kernel_matches_plain(cuda, b, t):
    """K5 from one frame (no samples) to the synthesis length, batched and
    unbatched (``b`` None), at the 2e-4 bar; and the same bits again."""
    rng = np.random.default_rng(2)
    shape = (513, t) if b is None else (b, 513, t)
    re, im = (
        torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=cuda)
        for _ in range(2)
    )
    n0 = istft_ops.istft_fused.launches
    got = istft_ops.istft_fused(re, im)
    torch.cuda.synchronize()
    assert istft_ops.istft_fused.launches == n0 + (t > 1)  # T = 1: no samples, no launch
    ref = istft_real_imag(re, im)
    assert got.shape == ref.shape == (*shape[:-2], (t - 1) * 256)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=0)
    assert torch.equal(istft_ops.istft_fused(re, im), got)


def test_istft_fused_refuses_what_the_kernel_does_not_take(cuda):
    """The FFT route's domain (a power of two from 16 to 4096, a hop not
    too short for the frames a block transforms); lengths outside it take
    the iDFT route and compute, as the TPU kernel does.  What the TPU
    kernel asserts on (hop not dividing n_fft, bins that are not n_fft / 2
    + 1) and other dtypes raise."""
    assert [istft_ops.kernel_frames(n) for n in (8, 16, 1024, 2048, 4096, 8192, 1000)] == [0, 32, 32, 16, 8, 0, 0]
    for n_fft, hop in [(1000, 250), (8192, 2048), (2048, 128), (4096, 512), (1024, 32)]:
        assert not istft_ops.uses_fft(n_fft, hop)
        rng = np.random.default_rng(n_fft + hop)
        re, im = (torch.tensor(rng.standard_normal((1, n_fft // 2 + 1, 8)), dtype=torch.float32, device=cuda)
                  for _ in range(2))
        torch.testing.assert_close(istft_ops.istft_fused(re, im, n_fft=n_fft, hop=hop),
                                   istft_real_imag(re, im, n_fft, hop), atol=2e-4, rtol=0)
    assert istft_ops.uses_fft(1024, 256) and istft_ops.uses_fft(4096, 1024)
    with pytest.raises(AssertionError):
        istft_ops.istft_fused(torch.zeros(1, 513, 8, device=cuda), torch.zeros(1, 513, 8, device=cuda), hop=300)
    with pytest.raises(ValueError, match="n_fft"):
        istft_ops.istft_fused(torch.zeros(1, 500, 8, device=cuda), torch.zeros(1, 500, 8, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        istft_ops.istft_fused(torch.zeros(1, 513, 8, device=cuda).double(), torch.zeros(1, 513, 8, device=cuda))


@pytest.mark.parametrize("n_fft,hop", [(96, 32), (768, 256), (1024, 16), (99, 33), (4096, 256), (12, 4)])
@pytest.mark.parametrize("b,t", [(3, 37), (None, 70), (2, 2), (1, 1), (5, 300)])
def test_istft_fused_second_route_matches_plain(cuda, n_fft, hop, b, t):
    """K5's iDFT route (lengths outside the FFT's domain) against the plain
    version at the 2e-4 bar, launches counted by the same counter, and the
    same bits again."""
    assert not istft_ops.uses_fft(n_fft, hop)
    rng = np.random.default_rng(n_fft + hop + t)
    shape = (n_fft // 2 + 1, t) if b is None else (b, n_fft // 2 + 1, t)
    re, im = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=cuda) for _ in range(2))
    n0 = istft_ops.istft_fused.launches
    got = istft_ops.istft_fused(re, im, n_fft, hop)
    torch.cuda.synchronize()
    assert istft_ops.istft_fused.launches == n0 + (t > 1)
    ref = istft_real_imag(re, im, n_fft, hop)
    assert got.shape == ref.shape == (*shape[:-2], (t - 1) * hop)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=0)
    assert torch.equal(istft_ops.istft_fused(re, im, n_fft, hop), got)


# Every transform length the kernel is built for, each at the hops of
# r = 2, 4, 8 that its frames a block allow (r = 8 needs more than the 8 a
# block holds at 4096), and r = 16 where a block holds 32.
ISTFT_SIZES = [
    (n_fft, n_fft // r) for n_fft in (16, 32, 64, 128, 256, 512, 2048, 4096) for r in (2, 4, 8)
    if r < (32 if n_fft <= 1024 else 32768 // n_fft)
] + [(64, 4), (512, 32), (1024, 64)]


@pytest.mark.parametrize("n_fft,hop", ISTFT_SIZES)
@pytest.mark.parametrize("b,t", [(3, 37), (None, 70), (2, 2)])
def test_istft_fused_kernel_takes_any_power_of_two_n_fft(cuda, n_fft, hop, b, t):
    """K5 at n_fft 16 to 4096 against the plain version at the 2e-4 bar,
    and the same bits again."""
    rng = np.random.default_rng(n_fft + hop)
    shape = (n_fft // 2 + 1, t) if b is None else (b, n_fft // 2 + 1, t)
    re, im = (
        torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=cuda)
        for _ in range(2)
    )
    got = istft_ops.istft_fused(re, im, n_fft, hop)
    ref = istft_real_imag(re, im, n_fft, hop)
    assert got.shape == ref.shape == (*shape[:-2], (t - 1) * hop)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=0)
    assert torch.equal(istft_ops.istft_fused(re, im, n_fft, hop), got)


@pytest.mark.parametrize("n_fft", [64, 1024])
def test_istft_fused_kernel_with_hop_n_fft(cuda, n_fft):
    """r = 1 (hop = n_fft: the frames do not overlap, and the centring pad
    is half a hop).  The envelope is the window squared, whose zeros turn
    float32 rounding into large values, so the bar is relative to the
    largest output."""
    rng = np.random.default_rng(n_fft)
    re, im = (
        torch.tensor(rng.standard_normal((2, n_fft // 2 + 1, 9)), dtype=torch.float32, device=cuda)
        for _ in range(2)
    )
    got = istft_ops.istft_fused(re, im, n_fft, n_fft)
    ref = istft_real_imag(re, im, n_fft, n_fft)
    assert got.shape == ref.shape == (2, 8 * n_fft)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-4


# The small-image shape of the conv template: 1x1 to 32x32 at batch 1 and
# 6, cin off the 8-channel step and off any split of it, cout 16 to 160.
SMALL_SHAPES = [
    (b, cin, cout, h, w)
    for (h, w) in [(1, 1), (2, 2), (3, 5), (4, 4), (13, 37), (32, 32)]
    for b, cin, cout in [(1, 37, 16), (6, 21, 48), (6, 131, 144), (1, 160, 160)]
]


@pytest.mark.parametrize("b,cin,cout,h,w", SMALL_SHAPES)
def test_small_shape_k1_k2_k3_match_plain(cuda, b, cin, cout, h, w):
    """K1 (with and without PixelNorm), K2 and K3 against their plain
    versions at the small images, PixelNorm past 128 channels included."""
    x, wt, bias = _conv_inputs(9, b, cin, cout, h, w, cuda)
    for pn in (False, True):
        got = conv_ops.fused_conv3x3(x, wt, bias, 0.2, pn)
        torch.testing.assert_close(got, conv_ops.conv3x3_plain(x, wt, bias, 0.2, pn), atol=1e-4, rtol=0)
        up = conv_ops.fused_upconv3x3(x, wt, bias, 0.2, pn)
        torch.testing.assert_close(up, conv_ops.upconv3x3_plain(x, wt, bias, 0.2, pn), atol=1e-4, rtol=0)
    y, m = conv_ops.fused_conv3x3_msq(x, wt, bias, 0.2, 1e-8)
    y_ref, m_ref = conv_ops.conv3x3_msq_plain(x, wt, bias, 0.2, 1e-8)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=0)
    assert float((m - m_ref).abs().max() / m_ref.abs().max()) < 1e-4


@pytest.mark.parametrize("b,cin,cout,h,w", [(6, 128, 128, 4, 4), (6, 144, 160, 2, 2), (6, 160, 160, 1, 1), (6, 96, 112, 16, 16)])
def test_cluster_reduction_is_bit_for_bit_repeatable(cuda, b, cin, cout, h, w):
    """The small shape sums the cluster's partial tiles in rank order: the
    same inputs give the same bits, run after run (here with PixelNorm's
    cross-block sums and K2's map too)."""
    x, wt, bias = _conv_inputs(10, b, cin, cout, h, w, cuda)
    plan = conv_ops.conv_plan("conv3x3", b, cin, cout, h, w, True)
    assert plan["shape"] == "small" and plan["cluster"] > 1
    first = conv_ops.fused_conv3x3_msq(x, wt, bias, 0.2, 1e-8)
    for _ in range(3):
        again = conv_ops.fused_conv3x3_msq(x, wt, bias, 0.2, 1e-8)
        assert all(torch.equal(a, c) for a, c in zip(first, again))


def test_conv_plan_takes_the_small_shape_up_to_32x32(cuda):
    """The launcher's rule at the critic's stage-7 widths (batch 6): the
    small shape up to 16x16, with a cluster split over input channels on
    the images of a few pixels; the large shape, on the tensor cores, from
    32x32, where its tiles fill half the SMs."""
    plans = {
        h: conv_ops.conv_plan("conv3x3", 6, cin, cout, h, h, False)
        for cin, cout, h in [(64, 80, 64), (80, 96, 32), (96, 112, 16), (112, 128, 8), (128, 144, 4), (160, 160, 1)]
    }
    assert all(plans[h]["route"] == "large_tc" and plans[h]["tile"] == (2, 64) for h in (64, 32))
    assert all(plans[h]["shape"] == "small" for h in (16, 8, 4, 1))
    assert all(plans[h]["split_k"] > 1 for h in (8, 4, 1))
    assert plans[4]["nsplit"] == 2 and plans[4]["cluster"] <= 8


def test_kernels_reject_a_wrong_dtype(cuda):
    x, wt, bias = _conv_inputs(3, 1, 8, 8, 4, 4, cuda)
    with pytest.raises(ValueError):
        conv_ops.fused_conv3x3(x.double(), wt.double(), bias.double())


# The large-image route of the conv template (3xTF32 implicit GEMM on the
# tensor cores): ragged columns (W = 70, 130: 4-byte staging; 300, 64:
# 16-byte staging) and rows, cin off the 8-channel step (5, 21), cout off
# the 16-channel group (7, 20, 112), each channel count a block takes (16 to
# 128), and PixelNorm past 128 channels through a cluster of 3 blocks.
LARGE_SHAPES = [
    (2, 5, 7, 130, 300), (3, 21, 20, 96, 130), (4, 16, 32, 70, 130), (4, 8, 16, 300, 64),
    (3, 48, 64, 64, 70), (2, 64, 112, 64, 70), (1, 24, 272, 64, 70),
]
# The input-gradient orientation: channels swapped, no bias, no epilogue.
LARGE_DX_SHAPES = [(6, 32, 16, 70, 130), (3, 64, 48, 64, 70), (2, 272, 24, 130, 130)]


def _assert_large(kind, b, cin, cout, h, w, pixel_norm=True):
    plan = conv_ops.conv_plan(kind, b, cin, cout, h, w, pixel_norm)
    assert plan["shape"] == "large" and plan["route"] == "large_tc", plan


@pytest.mark.parametrize("epilogue", ["pixel_norm", "leaky_relu", "none"])
@pytest.mark.parametrize("b,cin,cout,h,w", LARGE_SHAPES)
def test_large_route_k1_matches_plain(cuda, b, cin, cout, h, w, epilogue):
    kw = {"pixel_norm": dict(slope=0.2, pixel_norm=True), "leaky_relu": dict(slope=0.2), "none": {}}[epilogue]
    _assert_large("conv3x3", b, cin, cout, h, w, epilogue == "pixel_norm")
    x, wt, bias = _conv_inputs(11, b, cin, cout, h, w, cuda)
    got = conv_ops.fused_conv3x3(x, wt, bias, **kw)
    torch.testing.assert_close(got, conv_ops.conv3x3_plain(x, wt, bias, **kw), atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,cin,cout,h,w", LARGE_DX_SHAPES)
def test_large_route_k1_as_input_gradient_matches_plain(cuda, b, cin, cout, h, w):
    _assert_large("conv3x3", b, cin, cout, h, w, False)
    x, wt, _ = _conv_inputs(12, b, cin, cout, h, w, cuda)
    got = conv_ops.fused_conv3x3(x, wt, None)
    torch.testing.assert_close(got, conv_ops.conv3x3_plain(x, wt, None), atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,cin,cout,h,w", LARGE_SHAPES)
def test_large_route_k2_matches_plain(cuda, b, cin, cout, h, w):
    """K2: ``y`` at 1e-4, the mean-square map at ``TOL_MSQ_REL`` (1e-4
    relative to its largest value), and the same ``y`` as K1 with PixelNorm."""
    _assert_large("conv3x3", b, cin, cout, h, w)
    x, wt, bias = _conv_inputs(13, b, cin, cout, h, w, cuda)
    y, m = conv_ops.fused_conv3x3_msq(x, wt, bias, 0.2, 1e-8)
    y_ref, m_ref = conv_ops.conv3x3_msq_plain(x, wt, bias, 0.2, 1e-8)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=0)
    assert float((m - m_ref).abs().max() / m_ref.abs().max()) < 1e-4
    torch.testing.assert_close(y, conv_ops.fused_conv3x3(x, wt, bias, 0.2, True), atol=0, rtol=0)


@pytest.mark.parametrize("epilogue", [True, False])
@pytest.mark.parametrize("b,cin,cout,h,w", LARGE_SHAPES)
def test_large_route_k3_matches_plain(cuda, b, cin, cout, h, w, epilogue):
    _assert_large("upconv3x3", b, cin, cout, h, w, epilogue)
    x, wt, bias = _conv_inputs(14, b, cin, cout, h, w, cuda)
    kw = dict(slope=0.2, pixel_norm=True) if epilogue else {}
    got = conv_ops.fused_upconv3x3(x, wt, bias, **kw)
    assert got.shape == (b, cout, 2 * h, 2 * w)
    torch.testing.assert_close(got, conv_ops.upconv3x3_plain(x, wt, bias, **kw), atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,cin,cout,h,w", [(2, 5, 7, 130, 300), (3, 48, 64, 64, 70), (1, 24, 272, 64, 70)])
def test_large_route_is_bit_for_bit_repeatable(cuda, b, cin, cout, h, w):
    """One fixed order of products and sums, no atomics: K2 (with its map)
    and K3 give the same bits run after run, the cluster's PixelNorm too."""
    _assert_large("conv3x3", b, cin, cout, h, w)
    _assert_large("upconv3x3", b, cin, cout, h, w)
    x, wt, bias = _conv_inputs(15, b, cin, cout, h, w, cuda)
    first = (*conv_ops.fused_conv3x3_msq(x, wt, bias, 0.2, 1e-8), conv_ops.fused_upconv3x3(x, wt, bias, 0.2, True))
    for _ in range(3):
        again = (*conv_ops.fused_conv3x3_msq(x, wt, bias, 0.2, 1e-8), conv_ops.fused_upconv3x3(x, wt, bias, 0.2, True))
        assert all(torch.equal(a, c) for a, c in zip(first, again))


# The weight gradient: the stage-7 iteration's largest shapes, ragged and
# wide channel counts, one pixel, a batch that ends inside a run of chunks;
# and the plan's boundaries (ops/conv_vjp.py::wgrad_plan): 16 output
# channels a block (N 48, up to 3 m64 tiles a block: cin 48 at cout 16) or
# 32 (N 96, one tile), past 32 split over blocks (cout 33 .. 160), several
# groups of tiles and last tiles of padding slabs, chunk columns below 64
# and a ragged last column of chunks (W 8, 12, 63, 65), widths no multiple
# of 4 (4-byte copies in place of TMA), one run (no second launch) and
# many, the path's smallest images (since the size rule, on the small
# route up to 16x16).
@pytest.mark.parametrize("b,cin,cout,h,w", [
    (6, 32, 16, 512, 512), (6, 16, 32, 512, 512), (6, 32, 32, 128, 128), (2, 5, 7, 13, 37),
    (6, 160, 160, 4, 4), (1, 3, 70, 1, 1), (3, 33, 65, 17, 19),
    (6, 160, 160, 1, 1), (6, 144, 160, 2, 2), (6, 128, 144, 4, 4), (2, 40, 129, 9, 12), (1, 16, 17, 5, 64),
    (2, 32, 48, 31, 65), (1, 96, 16, 16, 64), (3, 20, 33, 3, 8), (6, 64, 64, 64, 64), (6, 80, 96, 32, 32),
    (4, 48, 64, 2, 63), (1, 1, 1, 1, 1), (2, 48, 16, 12, 20),
])
def test_weight_grad3x3_kernel_matches_plain(cuda, b, cin, cout, h, w):
    """The fixed-order weight-gradient kernel against its plain version run
    in float64, at 1e-5 relative to the largest value, counted, and the same
    bits again."""
    rng = np.random.default_rng(b * cin + cout)
    x = torch.tensor(rng.standard_normal((b, cin, h, w)), dtype=torch.float32, device=cuda)
    d = torch.tensor(rng.standard_normal((b, cout, h, w)), dtype=torch.float32, device=cuda)
    n0 = conv_vjp.weight_grad3x3.launches
    got = conv_vjp.weight_grad3x3(x, d, (cout, cin, 3, 3))
    torch.cuda.synchronize()
    assert conv_vjp.weight_grad3x3.launches == n0 + 1
    ref = conv_vjp.weight_grad3x3_plain(x.double(), d.double(), (cout, cin, 3, 3))
    assert float((got.double() - ref).abs().max() / ref.abs().max()) < 1e-5
    assert torch.equal(conv_vjp.weight_grad3x3(x, d, (cout, cin, 3, 3)), got)
    with pytest.raises(ValueError, match="float32"):
        conv_vjp.weight_grad3x3(x.double(), d.double(), (cout, cin, 3, 3))


_WGRAD_PLAN_SHAPES = [
    (6, 32, 16, 512, 512), (6, 16, 32, 512, 512), (6, 64, 64, 64, 64), (6, 160, 160, 1, 1), (6, 144, 160, 2, 2),
    (6, 128, 144, 4, 4), (6, 112, 96, 16, 16), (6, 96, 80, 32, 32), (6, 32, 48, 256, 256), (2, 5, 7, 13, 37),
    (1, 3, 70, 1, 1), (2, 40, 129, 9, 12), (1, 96, 16, 16, 64), (2, 32, 48, 31, 65), (1, 1, 1, 1, 1),
    (2, 48, 16, 12, 20),
]


def test_wgrad_plan_mirrors_the_launcher(cuda):
    """ops/conv_vjp.py::wgrad_plan (Python, tested on the CPU) gives the
    plan the launcher makes on the card, at the card's SM count: on the
    size rule's route, and on each route forced where it takes the sizes."""
    for shape in _WGRAD_PLAN_SHAPES:
        for route in (None, *conv_vjp.WGRAD_ROUTES):
            if route == conv_vjp.WGRAD_SMALL and shape[4] > 64:
                continue
            got = conv_vjp.wgrad_kernel_plan(*shape, route=route)
            want = conv_vjp.wgrad_plan(*shape, sms=got["sms"], route=route)
            assert got == {k: want[k] for k in got}, (shape, route)
            assert route is None or got["route"] == route


# Both routes forced on both sides of the size rule (16x16), at the small
# route's boundaries: one block a tile and clusters of 2-8, rows a chunk
# below rows a block (16x16 at 96 channels), chunks across images,
# ragged channel tiles (33, 65, 129), one pixel, widths 1-20.
@pytest.mark.parametrize("route", ["tc_3xtf32", "small_fp32"])
@pytest.mark.parametrize("b,cin,cout,h,w", [
    (6, 160, 160, 1, 1), (6, 32, 128, 4, 4), (6, 112, 128, 8, 8), (6, 96, 96, 16, 16), (6, 96, 80, 17, 17),
    (2, 160, 160, 16, 16), (3, 33, 65, 5, 7), (1, 3, 129, 1, 20), (5, 40, 16, 16, 3), (1, 1, 1, 1, 1),
])
def test_weight_grad3x3_routes_match_plain(cuda, route, b, cin, cout, h, w):
    """Each route of the weight gradient, forced, against the plain version
    run in float64 at 1e-5 relative to the largest value, and the same bits
    again."""
    rng = np.random.default_rng(b * cin + cout + h)
    x = torch.tensor(rng.standard_normal((b, cin, h, w)), dtype=torch.float32, device=cuda)
    d = torch.tensor(rng.standard_normal((b, cout, h, w)), dtype=torch.float32, device=cuda)
    got = conv_vjp.weight_grad3x3(x, d, (cout, cin, 3, 3), route=route)
    ref = conv_vjp.weight_grad3x3_plain(x.double(), d.double(), (cout, cin, 3, 3))
    assert float((got.double() - ref).abs().max() / ref.abs().max()) < 1e-5
    assert torch.equal(conv_vjp.weight_grad3x3(x, d, (cout, cin, 3, 3), route=route), got)


# ---- bf16 I/O of K1, K3 and K4 (csrc/*_bf16.cu).  The plain versions run
# in float32 on the same bf16-rounded operands and round once: a kernel is
# held within one bf16 ulp of them elementwise, plus 1e-5 for results near
# zero that the two sums' float32 rounding moves across LeakyReLU's kink.

BF = torch.bfloat16


def assert_within_bf16_ulp(got, ref):
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
    a, b = got.float(), ref.float()
    bad = (a - b).abs() > 2.0**-7 * torch.maximum(a.abs(), b.abs()) + 1e-5
    assert not bad.any(), f"{int(bad.sum())} of {bad.numel()} past one bf16 ulp"


def assert_k4_bf16_close(got, ref):
    """K4 bf16 (or K1 bf16 then K3 bf16) against the plain block: two bf16
    roundings in a chain.  Where conv1's output lands one ulp off the plain
    one, conv2 and PixelNorm carry that into the outputs that read it as an
    absolute change no ulp of the output bounds, so the block is held in
    the 2-norm, relative (``chip_smoke.py``'s ``TOL_K4_BF16_L2``, 1e-2)."""
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
    a, b = got.float(), ref.float()
    assert ((a - b).norm() / b.norm()).item() <= 1e-2


# Small images (block 0-2 of synthesis cut down, ragged, PixelNorm past 128
# channels) and large ones (ragged columns and rows, every channel count a
# block takes, a cluster of 3 past 128); then the 16 shapes of a 5-clip,
# nb_vec-10 synthesis call, (b, cin, cout, h, w) of K1 (cin -> cin) and of
# K3 (cin -> cout) at each block.
BF16_SHAPES = [
    (2, 32, 128, 2, 20), (1, 5, 7, 3, 37), (6, 131, 144, 4, 4), (2, 12, 20, 9, 33),
    (2, 5, 7, 130, 300), (3, 21, 20, 96, 130), (4, 16, 32, 70, 130), (3, 48, 64, 64, 70),
    (2, 64, 112, 64, 70), (1, 24, 272, 64, 70), (1, 128, 128, 32, 64),
]
SYNTHESIS_BF16 = [(5, c, c, 2 * 2**i, 20 * 2**i) for i, c in enumerate((32, 128, 112, 96, 80, 64, 48, 32))] + [
    (5, ci, co, 2 * 2**i, 20 * 2**i)
    for i, (ci, co) in enumerate(((32, 128), (128, 112), (112, 96), (96, 80), (80, 64), (64, 48), (48, 32), (32, 16)))
]


@pytest.mark.parametrize("epilogue", ["pixel_norm", "leaky_relu"])
@pytest.mark.parametrize("b,cin,cout,h,w", BF16_SHAPES + SYNTHESIS_BF16)
def test_bf16_k1_k3_match_plain(cuda, b, cin, cout, h, w, epilogue):
    """K1 bf16 and K3 bf16 within one bf16 ulp (+ 1e-5) of their plain
    versions, on the size rule's route and on each route forced that has a
    tile at these sizes, the same bits twice, one launch counted a call."""
    from musicgan_tpu_torch.ops import conv_bf16

    pn = epilogue == "pixel_norm"
    x, wt, bias = _conv_inputs(21, b, cin, cout, h, w, cuda)
    x = x.to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    w1, w3 = conv_ops.kernel_weights_tc(wt), conv_ops.kernel_weights_tc(wt, True)
    ref1 = conv_ops.conv3x3_plain(x, wt, bias, 0.2, pn)
    ref3 = conv_ops.upconv3x3_plain(x, wt, bias, 0.2, pn)
    for k, fn, wp, ref in ((3, conv_ops.fused_conv3x3, w1, ref1), (2, conv_ops.fused_upconv3x3, w3, ref3)):
        for route in [None] + conv_bf16.routes_for(k, b, cin, cout, h, w, pn, sms):
            n0 = fn.bf16_launches
            got = fn(x, wt, bias, 0.2, pn, w_packed=wp, route=route, out_dtype=BF)
            assert fn.bf16_launches == n0 + 1
            assert_within_bf16_ulp(got, ref)
            assert torch.equal(got, fn(x, wt, bias, 0.2, pn, w_packed=wp, route=route, out_dtype=BF))
    # The kernel layout (K4's) is taken too, moved into the pack on the card.
    got = conv_ops.fused_conv3x3(x, wt, bias, 0.2, pn, w_packed=conv_ops.kernel_weights(wt, BF), out_dtype=BF)
    assert torch.equal(got, conv_ops.fused_conv3x3(x, wt, bias, 0.2, pn, w_packed=w1, out_dtype=BF))


@pytest.mark.parametrize("b,cin,cout,h,w", BF16_SHAPES + SYNTHESIS_BF16)
def test_bf16_plan_equals_the_mirror(cuda, b, cin, cout, h, w):
    """The launcher's plan (csrc/conv_bf16.cuh::plan_cb) is the Python
    mirror's (ops/conv_bf16.py::plan) at the card's SM count, for the size
    rule and for each route forced, K1 and K3, with PixelNorm and without."""
    from musicgan_tpu_torch.ops import conv_bf16

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    keys = ("route", "tc", "th", "nb", "ntiles", "resident", "stages", "nwg", "blocks", "smem_bytes", "n",
            "nsplit", "cluster", "mb", "ppb")
    for k, kind in ((3, "conv3x3"), (2, "upconv3x3")):
        for pn in (True, False):
            for route in [None] + conv_bf16.routes_for(k, b, cin, cout, h, w, pn, sms):
                code = 0 if route is None else conv_bf16.ROUTE_CODES[route]
                got = conv_ops.conv_plan(kind, b, cin, cout, h, w, pn, torch.bfloat16, route=route)
                want = conv_bf16.plan(k, b, cin, cout, h, w, pn, sms, code)
                assert {key: got[key] for key in keys} == {key: want[key] for key in keys}
                assert got["sms"] == sms


# K4 bf16 (csrc/block_bf16.cuh up to 128 channels): the 8 blocks of a
# 5-clip, nb_vec-10 synthesis call, (b, cin, cmid, cout, h, w).
SYNTHESIS_K4 = [(5, ci, ci, co, 2 * 2**i, 20 * 2**i)
                for i, (ci, co) in enumerate(((32, 128), (128, 112), (112, 96), (96, 80), (80, 64), (64, 48), (48, 32),
                                              (32, 16)))]
K4_PLAN_KEYS = (("tc", "tc"), ("run_rows", "run"), ("runs", "nruns"), ("strips", "ntx"), ("units", "units"),
                ("blocks", "blocks"), ("nwg", "nwg"), ("res1", "res1"), ("res2", "res2"), ("stages", "stages"),
                ("smem_bytes", "smem_bytes"), ("cost", "cost"), ("pair_cost", "pair_cost"), ("mb", "mb"),
                ("takes", "takes"))


def _k4_bf16_pair(x, w1, b1, w2, b2, out_dtype=torch.bfloat16):
    mid = conv_ops.fused_conv3x3(x, w1, b1, 0.2, True, out_dtype=BF)
    return conv_ops.fused_upconv3x3(mid, w2, b2, 0.2, True, out_dtype=out_dtype)


@pytest.mark.parametrize("b,cin,cmid,cout,h,w", BLOCK_SHAPES + [(2, 16, 16, 16, 33, 70), (1, 48, 48, 32, 130, 300)]
                         + SYNTHESIS_K4)
def test_bf16_k4_matches_plain_and_equals_the_bf16_pair(cuda, b, cin, cmid, cout, h, w):
    """K4 bf16 equals K1 bf16 then K3 bf16 bit for bit up to 128 channels
    (block_bf16.cuh sums in conv_bf16.cuh's order and rounds c1 once, as K1
    bf16 stores it), and past them where K1 and K3 both take the tensor-core
    route (block3x3.cuh at bf16); everywhere within ``assert_k4_bf16_close``
    of its plain version, and the same bits twice."""
    from musicgan_tpu_torch.ops import conv_bf16

    x, w1, b1, w2, b2 = _block_inputs(22, b, cin, cmid, cout, h, w, cuda)
    x = x.to(torch.bfloat16)
    n0 = conv_ops.fused_block.bf16_launches
    got = conv_ops.fused_block(x, w1, b1, w2, b2, out_dtype=BF)
    assert conv_ops.fused_block.bf16_launches == n0 + 1
    if conv_bf16.block_route(cmid, cout, cin) != "template" or _pair_is_large(b, cin, cmid, cout, h, w):
        assert torch.equal(got, _k4_bf16_pair(x, w1, b1, w2, b2))
    assert_k4_bf16_close(got, conv_ops.fused_block_plain(x, w1, b1, w2, b2))
    assert torch.equal(got, conv_ops.fused_block(x, w1, b1, w2, b2, out_dtype=BF))


@pytest.mark.parametrize("b,cin,cmid,cout,h,w,tc,run", [
    (2, 5, 7, 3, 13, 37, 16, 4), (1, 48, 48, 32, 130, 300, 96, 16), (1, 48, 48, 32, 130, 300, 112, 130),
    (5, 32, 32, 16, 64, 640, 64, 8), (2, 80, 80, 64, 32, 100, 32, 3), (3, 9, 128, 128, 6, 70, 16, 2),
])
def test_bf16_k4_forced_strips_and_runs_give_the_pairs_bits(cuda, b, cin, cmid, cout, h, w, tc, run):
    """Every strip width and run length sums a pixel in one order: K4 bf16
    with a forced plan equals K1 bf16 then K3 bf16 bit for bit, and takes the
    packs of K1 bf16 and K3 bf16 as they are."""
    x, w1, b1, w2, b2 = _block_inputs(25, b, cin, cmid, cout, h, w, cuda)
    x = x.to(torch.bfloat16)
    plan = conv_ops.block_plan(b, cin, cmid, cout, h, w, dtype=torch.bfloat16, tc=tc, run=run)
    assert (plan["tc"], plan["run_rows"]) == (tc, run)
    got = conv_ops.fused_block(x, w1, b1, w2, b2, tc=tc, run=run, w1_packed=conv_ops.kernel_weights_tc(w1),
                               w2_packed=conv_ops.kernel_weights_tc(w2, True), out_dtype=BF)
    assert torch.equal(got, _k4_bf16_pair(x, w1, b1, w2, b2))


@pytest.mark.parametrize("b,cin,cmid,cout,h,w", BLOCK_SHAPES + SYNTHESIS_K4)
def test_bf16_k4_plan_equals_the_mirror(cuda, b, cin, cmid, cout, h, w):
    """The launcher's plan (block_bf16.cuh::plan_kb) is the Python mirror's
    (ops/conv_bf16.py::block_plan) at the card's SM count, and
    ``fused_block_fits`` in bf16 takes what it takes."""
    from musicgan_tpu_torch.ops import conv_bf16

    assert conv_bf16.block_route(cmid, cout, cin) == "bf16_tc"
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    got = conv_ops.block_plan(b, cin, cmid, cout, h, w, dtype=torch.bfloat16)
    want = conv_bf16.block_plan(b, cin, cmid, cout, h, w, sms)
    assert {k: got[k] for k, _ in K4_PLAN_KEYS} == {k: want[m] for k, m in K4_PLAN_KEYS}
    assert got["sms"] == sms and got["route"] == "bf16_tc"
    assert conv_ops.fused_block_fits(cin, cmid, cout, size=(b, h, w), device=cuda, dtype=torch.bfloat16) == want["takes"]


def test_bf16_k4_past_128_channels(cuda):
    x, w1, b1, w2, b2 = _block_inputs(23, 2, 144, 144, 160, 32, 100, cuda)
    x = x.to(torch.bfloat16)
    assert conv_ops.block_tile(144, 160)["cluster"] == 2
    assert_k4_bf16_close(conv_ops.fused_block(x, w1, b1, w2, b2, out_dtype=BF),
                         conv_ops.fused_block_plain(x, w1, b1, w2, b2))


# K4 bf16's cluster route (past 128 channels): WIDE_BLOCK (chip_smoke.py)
# and cut down, a ragged one, three ranks, a rank past conv2's splits and
# one past conv1's, eight ranks with the widest input that fits.
CLUSTER_SHAPES = [(5, 144, 144, 160, 32, 320), (1, 16, 144, 160, 4, 20), (2, 5, 136, 150, 3, 37),
                  (1, 8, 272, 288, 2, 24), (3, 100, 129, 40, 7, 50), (1, 16, 16, 1024, 6, 30),
                  (1, 608, 1024, 1024, 8, 64)]


@pytest.mark.parametrize("b,cin,cmid,cout,h,w", CLUSTER_SHAPES)
def test_bf16_k4_cluster_gives_the_pairs_bits_in_both_output_dtypes(cuda, b, cin, cmid, cout, h, w):
    """Past 128 channels K4 bf16 is block_bf16.cuh over a cluster split as
    K1 bf16 and K3 bf16 split: K1 bf16 then K3 bf16 bit for bit with a bf16
    and with a float32 output, the float32 one rounded to bf16 the bf16 one,
    its plan the mirror's, the same bits twice."""
    from musicgan_tpu_torch.ops import conv_bf16

    assert conv_bf16.block_route(cmid, cout, cin) == "bf16_cluster"
    x, w1, b1, w2, b2 = _block_inputs(29, b, cin, cmid, cout, h, w, cuda)
    x = x.to(torch.bfloat16)
    got = conv_ops.fused_block(x, w1, b1, w2, b2, out_dtype=BF)
    got32 = conv_ops.fused_block(x, w1, b1, w2, b2, out_dtype=torch.float32)
    assert torch.equal(got, _k4_bf16_pair(x, w1, b1, w2, b2))
    assert torch.equal(got32, _k4_bf16_pair(x, w1, b1, w2, b2, out_dtype=torch.float32))
    assert torch.equal(got32.to(BF), got)
    assert torch.equal(got, conv_ops.fused_block(x, w1, b1, w2, b2, out_dtype=BF))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = conv_ops.block_plan(b, cin, cmid, cout, h, w, dtype=BF)
    want = conv_bf16.block_plan(b, cin, cmid, cout, h, w, sms)
    assert {k: plan[k] for k, _ in K4_PLAN_KEYS} == {k: want[m] for k, m in K4_PLAN_KEYS}
    assert plan["route"] == "bf16_cluster" and plan["cluster"] == want["cluster"]


@pytest.mark.parametrize("b,cin,cmid,cout,h,w,tc,run", [
    (5, 144, 144, 160, 32, 320, 96, 6), (5, 144, 144, 160, 32, 320, 48, 3), (2, 5, 136, 150, 3, 37, 16, 2),
])
def test_bf16_k4_cluster_forced_strips_and_runs_give_the_pairs_bits(cuda, b, cin, cmid, cout, h, w, tc, run):
    x, w1, b1, w2, b2 = _block_inputs(30, b, cin, cmid, cout, h, w, cuda)
    x = x.to(torch.bfloat16)
    got = conv_ops.fused_block(x, w1, b1, w2, b2, tc=tc, run=run, out_dtype=BF)
    assert torch.equal(got, _k4_bf16_pair(x, w1, b1, w2, b2))


# K4 bf16's template tier (block3x3.cuh at bf16, widths cluster_fits
# refuses: inputs past 608 channels at these c1 and output widths):
# TEMPLATE_BLOCK (chip_smoke.py) and a ragged one just past the edge.
TEMPLATE_SHAPES = [(1, 640, 640, 640, 4, 40), (2, 609, 700, 650, 3, 21)]


@pytest.mark.parametrize("out_dtype", [BF, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,cin,cmid,cout,h,w", TEMPLATE_SHAPES)
def test_bf16_k4_template_tier_matches_plain_and_the_pair(cuda, b, cin, cmid, cout, h, w, out_dtype):
    """Inputs too wide for the cluster take the template: within the
    2-norm of K1 bf16 then K3 bf16 and of the plain version (its own sums),
    with a bf16 and a float32 output, the float32 one rounded to bf16 the
    bf16 one, the same bits twice."""
    from musicgan_tpu_torch.ops import conv_bf16

    assert conv_bf16.block_route(cmid, cout, cin) == "template"
    x, w1, b1, w2, b2 = _block_inputs(31, b, cin, cmid, cout, h, w, cuda)
    x = x.to(BF)
    got = conv_ops.fused_block(x, w1, b1, w2, b2, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    pair = _k4_bf16_pair(x, w1, b1, w2, b2, out_dtype=out_dtype).float()
    assert ((got.float() - pair).norm() / pair.norm()).item() <= 1e-2
    assert_k4_bf16_close(got.to(BF), conv_ops.fused_block_plain(x, w1, b1, w2, b2))
    assert torch.equal(got.to(BF), conv_ops.fused_block(x, w1, b1, w2, b2, out_dtype=BF))
    assert torch.equal(got, conv_ops.fused_block(x, w1, b1, w2, b2, out_dtype=out_dtype))


def test_bf16_kernels_refuse_a_mixed_pair_and_mixed_operands(cuda):
    """Operands of two dtypes raise before any launch: a bf16 x with the
    float32 kernel layout, for the bf16 kernels and for K2 with bf16 x.  (A
    mixed pair of x and output dtypes is a kernel of its own.)"""
    x, wt, bias = _conv_inputs(24, 1, 8, 16, 8, 64, cuda)
    xb = x.to(torch.bfloat16)
    for out in (BF, torch.float32):
        with pytest.raises(ValueError):
            conv_ops.fused_conv3x3(xb, wt, bias, 0.2, True, w_packed=conv_ops.kernel_weights(wt), out_dtype=out)
    with pytest.raises(ValueError):
        conv_ops.fused_conv3x3_msq(xb, wt, bias, 0.2, w_packed=conv_ops.kernel_weights(wt))


@pytest.mark.parametrize("impl", ["pallas_bf16", "pallas_up_bf16", "pallas_block_bf16", "pallas"])
def test_generator_new_impls_on_the_card(cuda, impl):
    """The inference forward under the new impls at full width, 2 clips of
    nb_vec 10, stage 7: the bf16 kernels launched (K4 under
    ``pallas_block_bf16``), a float32 image; ``"pallas"`` within 2e-3 of the
    float32 default path's (the float32 kernels' end-to-end bar), a bf16
    impl within 0.08 of it in the 2-norm, relative (``chip_smoke.py``'s
    ``TOL_IMAGE_BF16_L2``: bf16's rounding of every activation through 16
    convs and PixelNorm, which the exact bf16 plain path shows as well)."""
    import dataclasses

    from musicgan_tpu_torch.config import ModelConfig
    from musicgan_tpu_torch.models import Generator

    cfg = ModelConfig(conv_impl=impl)
    gen = Generator(cfg, device=cuda, seed=4)
    ref = Generator(dataclasses.replace(cfg, conv_impl="pallas_up"), device=cuda, seed=4)
    z = torch.randn(2, 32, 2, 20, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    wrappers = (conv_ops.fused_conv3x3, conv_ops.fused_upconv3x3, conv_ops.fused_block)
    n0 = [(f.launches, f.bf16_launches) for f in wrappers]
    with torch.no_grad():
        got = gen.forward_nchw(z, 7)
        torch.cuda.synchronize()
        n1 = [(f.launches, f.bf16_launches) for f in wrappers]
        want = ref.forward_nchw(z, 7)
    d = [(a[0] - b[0], a[1] - b[1]) for a, b in zip(n1, n0)]
    # pallas_block_bf16: K4 bf16 at the blocks its size rule takes.
    n_k4 = sum(conv_ops.fused_block_fits(ci, ci, co, size=(2, 2 * 2**i, 20 * 2**i), device=cuda,
                                         dtype=torch.bfloat16) for i, (ci, co) in enumerate(cfg.gen_channels))
    expect = {"pallas": [(16, 0), (0, 0), (0, 0)], "pallas_bf16": [(16, 16), (0, 0), (0, 0)],
              "pallas_up_bf16": [(8, 8), (8, 8), (0, 0)],
              "pallas_block_bf16": [(8 - n_k4, 8 - n_k4), (8 - n_k4, 8 - n_k4), (n_k4, n_k4)]}
    assert d == expect[impl]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    if impl == "pallas":
        assert (got - want).abs().max().item() <= 2e-3
    else:
        assert ((got - want).norm() / want.norm()).item() <= 0.08


# ---- The mixed-dtype calls (the JAX functions' bf16 x with
# out_dtype=float32, float32 x with out_dtype=bfloat16): each a kernel of its
# own (csrc/*_bf16_f32.cu, *_f32_bf16.cu, block3x3_bf16_wide_f32.cu) that
# stores the output's type itself, with its same-dtype kernel's plan, so:
# float32 in, bf16 out is the float32 kernel's result rounded once, bit for
# bit; bf16 in, float32 out rounded to bf16 is the bf16 kernel's, bit for
# bit, and holds values bf16 cannot.  Against the plain versions: float32
# in, the float32 bar (1e-4) plus one bf16 ulp; bf16 in, 1e-4.
MIXED_CONV_SHAPES = [(2, 32, 128, 2, 20), (1, 5, 7, 3, 37), (6, 131, 144, 4, 4), (2, 5, 7, 130, 300),
                     (4, 16, 32, 70, 130), (2, 64, 112, 64, 70), (1, 24, 272, 64, 70), (5, 80, 64, 32, 320)]
MIXED_PAIRS = [(torch.float32, BF), (BF, torch.float32)]


def _assert_mixed(got, same, ref, x_dtype, out_dtype, tol=1e-4):
    assert got.dtype == out_dtype and got.shape == ref.shape
    if out_dtype == BF:
        assert torch.equal(got, same.to(BF))
        a, b = got.float(), ref.float()
        assert not ((a - b).abs() > 2.0**-7 * torch.maximum(a.abs(), b.abs()) + tol).any()
    else:
        assert torch.equal(got.to(BF), same)
        assert (got != got.to(BF).float()).any()  # stored unrounded


@pytest.mark.parametrize("x_dtype,out_dtype", MIXED_PAIRS, ids=["f32_bf16", "bf16_f32"])
@pytest.mark.parametrize("b,cin,cout,h,w", MIXED_CONV_SHAPES)
def test_mixed_k1_k3_match_plain_and_their_same_dtype_kernels(cuda, b, cin, cout, h, w, x_dtype, out_dtype):
    from musicgan_tpu_torch.ops import conv_bf16

    x, wt, bias = _conv_inputs(26, b, cin, cout, h, w, cuda)
    x = x.to(x_dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for k, fn, plain in ((3, conv_ops.fused_conv3x3, conv_ops.conv3x3_plain),
                         (2, conv_ops.fused_upconv3x3, conv_ops.upconv3x3_plain)):
        ref = plain(x, wt, bias, 0.2, True, out_dtype=out_dtype)
        routes = conv_bf16.routes_for(k, b, cin, cout, h, w, True, sms) if x_dtype == BF else []
        for route in [None] + routes:
            n0 = (fn.launches, fn.mixed_launches, fn.bf16_launches)
            got = fn(x, wt, bias, 0.2, True, route=route, out_dtype=out_dtype)
            assert (fn.launches, fn.mixed_launches, fn.bf16_launches) == (n0[0] + 1, n0[1] + 1, n0[2])
            same = fn(x, wt, bias, 0.2, True, route=route, out_dtype=x_dtype)
            _assert_mixed(got, same, ref, x_dtype, out_dtype)
            if out_dtype == torch.float32:
                assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("b,cin,cout,h,w", MIXED_CONV_SHAPES)
def test_bf16_msq_matches_plain_and_k1_bf16(cuda, b, cin, cout, h, w):
    """K2 with bf16 x: float32 ``y`` at the conv bar and ``m`` at 1e-4
    relative, ``y`` rounded to bf16 K1 bf16's bits (past 128 channels ``m``
    from the cluster's exchanged sums)."""
    x, wt, bias = _conv_inputs(27, b, cin, cout, h, w, cuda)
    x = x.to(BF)
    n0 = conv_ops.fused_conv3x3_msq.mixed_launches
    y, m = conv_ops.fused_conv3x3_msq(x, wt, bias, 0.2)
    assert conv_ops.fused_conv3x3_msq.mixed_launches == n0 + 1
    y_ref, m_ref = conv_ops.conv3x3_msq_plain(x, wt, bias, 0.2)
    assert y.dtype == m.dtype == torch.float32
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=0)
    assert float((m - m_ref).abs().max() / m_ref.abs().max()) < 1e-4
    _assert_mixed(y, conv_ops.fused_conv3x3(x, wt, bias, 0.2, True, out_dtype=BF), y_ref, BF, torch.float32)


@pytest.mark.parametrize("x_dtype,out_dtype", MIXED_PAIRS, ids=["f32_bf16", "bf16_f32"])
@pytest.mark.parametrize("b,cin,cmid,cout,h,w", BLOCK_SHAPES[:6] + SYNTHESIS_K4[4:] + [(2, 144, 144, 160, 32, 100)])
def test_mixed_k4_matches_plain_and_its_same_dtype_kernel(cuda, b, cin, cmid, cout, h, w, x_dtype, out_dtype):
    """K4's mixed pairs: float32 in, bf16 out the float32 K4 rounded; bf16
    in, float32 out K1 bf16 then K3 bf16 -> float32 bit for bit up to 128
    channels (c1 rounded to bf16 once, as the JAX kernel's scratch), and
    rounded to bf16 K4 bf16's bits; within the blocks' bars of the plain
    version (float32: 2e-4 plus one bf16 ulp; bf16 in: the 2-norm)."""
    from musicgan_tpu_torch.ops import conv_bf16

    x, w1, b1, w2, b2 = _block_inputs(28, b, cin, cmid, cout, h, w, cuda)
    x = x.to(x_dtype)
    n0 = conv_ops.fused_block.mixed_launches
    got = conv_ops.fused_block(x, w1, b1, w2, b2, out_dtype=out_dtype)
    assert conv_ops.fused_block.mixed_launches == n0 + 1
    same = conv_ops.fused_block(x, w1, b1, w2, b2, out_dtype=x_dtype)
    ref = conv_ops.fused_block_plain(x, w1, b1, w2, b2, out_dtype=out_dtype)
    _assert_mixed(got, same, ref, x_dtype, out_dtype, tol=2e-4)
    if out_dtype == torch.float32:
        assert ((got - ref).norm() / ref.norm()).item() <= 1e-2
        if conv_bf16.block_route(cmid, cout, cin) != "template":
            assert torch.equal(got, _k4_bf16_pair(x, w1, b1, w2, b2, out_dtype=torch.float32))


def test_spans_record_under_a_device_only_profiler_on_the_profilers_clock(cuda):
    """A profiler of the device alone (``ProfilerActivity.CUDA``, how a
    cell whose host path the operators' recording would slow is traced)
    opens the spans' gate; under CPU and CUDA the spans' starts and ends
    lie within 50 us of their ``record_function`` events' on the profiler's
    clock (``utils/profiling.py::to_profiler_ns``) by the median, and each
    within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    from musicgan_tpu_torch.utils import profiling

    profiling.clear_spans()
    x = torch.ones(1 << 20, device=cuda)
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            with profiling.span("mg.test.device_only"):
                (x * 2).sum()
        assert [s.name for s in profiling.spans()] == ["mg.test.device_only"]
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with profiling.span("mg.test.warm"):  # the first record_function is slow
                (x * 2).sum()
            for k in range(50):
                with profiling.span(f"mg.test.clock.{k}"):
                    (x * 2).sum()
        cpu = torch.autograd.DeviceType.CPU
        events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.device_type() == cpu}
        starts, ends = [], []
        for s in profiling.spans()[1:]:
            e = events[s.name]
            starts.append(abs(profiling.to_profiler_ns(s.t0_ns) - e.start_ns()))
            ends.append(abs(profiling.to_profiler_ns(s.t1_ns) - (e.start_ns() + e.duration_ns())))
        assert len(starts) == 50
        assert float(np.median(starts)) < 50_000 and float(np.median(ends)) < 50_000, (starts, ends)
        assert max(starts + ends) < 1_000_000, (starts, ends)
    finally:
        profiling.clear_spans()


# ---- The ToMagnPhase head on a bf16 activation (csrc/head1x1_bf16.cu): one
# pass from the bf16 activation to the float32 image, against its plain
# version (the upcast, a float32 batched product, the bias, tanh) at every
# head width of the generator.  Both sum in float32, in other orders: 2e-6.
# (B, H, W): planes on the 16-byte route (H * W a multiple of 8, also with a
# W that is not) and off it, a batch of 1.
HEAD_SHAPES = [(2, 64, 640), (1, 8, 37), (3, 7, 37), (2, 33, 70)]


def _head_inputs(seed, b, c, h, w, device):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((b, c, h, w)), dtype=torch.float32, device=device).to(BF)
    wt = torch.tensor(rng.uniform(-1, 1, (2, c)) / np.sqrt(c), dtype=torch.float32, device=device)
    bias = torch.tensor(rng.uniform(-1, 1, 2) / np.sqrt(c), dtype=torch.float32, device=device)
    return x, wt, bias


@pytest.mark.parametrize("c", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("b,h,w", HEAD_SHAPES)
def test_head1x1_kernel_matches_plain(cuda, b, c, h, w):
    from musicgan_tpu_torch.ops import head as head_ops

    x, wt, bias = _head_inputs(c + h, b, c, h, w, cuda)
    n = head_ops.head1x1.launches
    got = head_ops.head1x1(x, wt, bias)
    assert head_ops.head1x1.launches == n + 1
    ref = head_ops.head1x1_plain(x, wt, bias)
    assert got.dtype == torch.float32 and got.shape == (b, 2, h, w)
    assert (got - ref).abs().max().item() <= 2e-6


def test_head1x1_kernel_at_the_synthesis_cells_shape_twice_the_same_bits(cuda):
    """Block 7's output for 20 clips of nb_vec 10: (20, 16, 512, 5120)."""
    from musicgan_tpu_torch.ops import head as head_ops

    x, wt, bias = _head_inputs(7, 20, 16, 512, 5120, cuda)
    got = head_ops.head1x1(x, wt, bias)
    assert (got - head_ops.head1x1_plain(x, wt, bias)).abs().max().item() <= 2e-6
    assert torch.equal(got, head_ops.head1x1(x, wt, bias))


def test_head1x1_kernel_takes_an_input_off_16_bytes(cuda):
    """A contiguous view that starts one element in: the element route."""
    from musicgan_tpu_torch.ops import head as head_ops

    x, wt, bias = _head_inputs(3, 2, 32, 16, 40, cuda)
    flat = torch.empty(x.numel() + 1, dtype=BF, device=cuda)
    xv = flat[1:].view(x.shape)
    xv.copy_(x)
    assert xv.data_ptr() % 16 != 0 and xv.is_contiguous()
    got = head_ops.head1x1(xv, wt, bias)
    assert (got - head_ops.head1x1_plain(x, wt, bias)).abs().max().item() <= 2e-6


def test_head1x1_refuses_what_the_kernel_does_not_take(cuda):
    from musicgan_tpu_torch.ops import head as head_ops

    x, wt, bias = _head_inputs(5, 2, 16, 8, 16, cuda)
    with pytest.raises(ValueError, match="bf16"):
        head_ops.head1x1(x.float(), wt, bias)
    with pytest.raises(ValueError, match="contiguous"):
        head_ops.head1x1(x.transpose(2, 3), wt, bias)
    with pytest.raises(ValueError, match="on cuda"):
        head_ops.head1x1(x, wt.cpu(), bias)
    with pytest.raises(ValueError, match="on cuda"):
        head_ops.head1x1(x, wt, bias.cpu())
    with pytest.raises(ValueError, match="float32"):
        head_ops.head1x1(x, wt.to(BF), bias)
    with pytest.raises(ValueError):
        head_ops.head1x1(x, wt[:, :8], bias)


@pytest.mark.parametrize("stage,alpha", [(7, 1.0), (3, 0.5)])
def test_generator_bf16_heads_take_the_kernel(cuda, monkeypatch, stage, alpha):
    """``forward_nchw`` under ``pallas_up_bf16`` launches the head kernel
    once (twice at a fade), and its image is within 2e-6 of the same call
    with the kernel's route turned off (the plain head on the same bf16
    activations)."""
    from musicgan_tpu_torch.config import ModelConfig
    from musicgan_tpu_torch.models import Generator
    from musicgan_tpu_torch.ops import head as head_ops

    gen = Generator(ModelConfig(conv_impl="pallas_up_bf16"), device=cuda, seed=4)
    z = torch.randn(2, 32, 2, 20, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    n = head_ops.head1x1.launches
    with torch.no_grad():
        got = gen.forward_nchw(z, stage, alpha)
        assert head_ops.head1x1.launches == n + (1 if alpha == 1.0 else 2)
        monkeypatch.setattr(head_ops, "takes_kernel", lambda *a: False)
        want = gen.forward_nchw(z, stage, alpha)
    assert head_ops.head1x1.launches == n + (1 if alpha == 1.0 else 2)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= 2e-6
