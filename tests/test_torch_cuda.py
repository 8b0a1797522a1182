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
# wide channel counts (tiles of 32), one pixel, a batch that ends inside a
# chunk of 1024 pixels.
@pytest.mark.parametrize("b,cin,cout,h,w", [
    (6, 32, 16, 512, 512), (6, 16, 32, 512, 512), (6, 32, 32, 128, 128), (2, 5, 7, 13, 37),
    (6, 160, 160, 4, 4), (1, 3, 70, 1, 1), (3, 33, 65, 17, 19),
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
