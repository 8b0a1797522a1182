"""The port's bf16 synthesis (``conv_impl`` ``"pallas_bf16"``,
``"pallas_up_bf16"``, ``"pallas_block_bf16"``) and the float32 ``"pallas"``
impl against the JAX package, on the CPU.

The port runs the plain versions of K1, K3 and K4 in bf16 (operands rounded
to bf16, products and sums in float32, the output rounded once); JAX runs
its Pallas kernels with bf16 activations and ``out_dtype=bfloat16`` in
interpret mode, as ``tests/test_ops.py`` does.  Inputs are made with numpy
from a seed.  The bar between two bf16 results is one bf16 ulp elementwise,
``|a - b| <= 2^-7 * max(|a|, |b|)``: both sum the same exact products in
float32 in another order, and a float32 difference of one rounding can move
the bf16 result to its neighbour.

The bf16 kernels' operand layouts (``csrc/conv_tile.cuh``: ``AFrag<bf16>``,
``load_weight_chunk`` and ``store_stage_weights`` for bf16, the shared-memory
descriptor) are held here against the convolution they must compute, by a
model of the same index arithmetic and of the PTX fragment layouts of
``wgmma.m64nNk16`` with A in registers; the card tests
(``tests/test_torch_cuda.py``) hold the kernels themselves.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from musicgan_tpu.generate import synthesize_fn as jax_synthesize_fn
from musicgan_tpu.models.generator import generator_forward, init_generator
from musicgan_tpu.ops import conv as jax_conv
from musicgan_tpu_torch.config import ModelConfig
from musicgan_tpu_torch.generate import synthesize_fn
from musicgan_tpu_torch.models import Generator, params_from_jax
from musicgan_tpu_torch.ops import conv as conv_ops
from tests.tiny_cfg import TINY_MODEL

BF16_ULP = 2.0**-7


def _assert_within_one_ulp(got: np.ndarray, ref: np.ndarray) -> None:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    bar = BF16_ULP * np.maximum(np.abs(got), np.abs(ref))
    bad = np.abs(got - ref) > bar
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} past one bf16 ulp; worst "
        f"{float(np.abs(got - ref)[bad].max()):.3e}"
    )


def _inputs(seed, b, cin, cout, h, w):
    """x (NCHW), HWIO weights and the bias, float32, as the JAX package
    keeps them."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(rng.standard_normal((b, cin, h, w))), f32(rng.standard_normal((3, 3, cin, cout)) * 0.1),
            f32(rng.standard_normal(cout) * 0.1))


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _bf16_torch(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _bf16_jax(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _f32(t) -> np.ndarray:
    """A bf16 result (torch or JAX) as float32 numpy, exactly."""
    if isinstance(t, torch.Tensor):
        assert t.dtype == torch.bfloat16
        return t.float().numpy()
    assert t.dtype == jnp.bfloat16
    return np.asarray(t.astype(jnp.float32))


# Widths of the path cut down, a cout that is no multiple of 16, an odd cin
# and ragged images.
CONV_SHAPES = [(1, 16, 32, 8, 40), (2, 12, 20, 5, 9), (1, 5, 7, 13, 37)]


@pytest.mark.parametrize("slope,pn", [(0.2, True), (0.2, False)])
@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES)
def test_bf16_conv3x3_matches_jax_interpret(b, cin, cout, h, w, slope, pn):
    x, wt, bias = _inputs(b + cout, b, cin, cout, h, w)
    ref = jax_conv.fused_conv3x3(_bf16_jax(x), jnp.asarray(wt), jnp.asarray(bias), slope=slope,
                                 pixel_norm=pn, out_dtype=jnp.bfloat16, interpret=True)
    got = conv_ops.fused_conv3x3(_bf16_torch(x), _oihw(wt), torch.from_numpy(bias), slope, pn,
                                 out_dtype=torch.bfloat16)
    _assert_within_one_ulp(_f32(got), _f32(ref))


@pytest.mark.parametrize("slope,pn", [(0.2, True), (0.2, False)])
@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES)
def test_bf16_upconv3x3_matches_jax_interpret(b, cin, cout, h, w, slope, pn):
    x, wt, bias = _inputs(b + cin, b, cin, cout, h, w)
    ref = jax_conv.fused_upconv3x3(_bf16_jax(x), jnp.asarray(wt), jnp.asarray(bias), slope=slope,
                                   pixel_norm=pn, out_dtype=jnp.bfloat16, interpret=True)
    got = conv_ops.fused_upconv3x3(_bf16_torch(x), _oihw(wt), torch.from_numpy(bias), slope, pn,
                                   out_dtype=torch.bfloat16)
    assert got.shape == (b, cout, 2 * h, 2 * w)
    _assert_within_one_ulp(_f32(got), _f32(ref))


# tests/test_ops.py's block shapes, a ragged one, and one past 128 channels
# (K4 splits each conv's channels over a cluster there).
@pytest.mark.parametrize("b,cin,cmid,cout,h,w",
                         [(1, 16, 24, 32, 8, 32), (2, 5, 7, 3, 13, 37), (1, 16, 136, 144, 4, 10)])
def test_bf16_block_matches_jax_interpret(b, cin, cmid, cout, h, w):
    rng = np.random.default_rng(cmid)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    x = f32(rng.standard_normal((b, cin, h, w)))
    w1, b1 = f32(rng.standard_normal((3, 3, cin, cmid)) * 0.1), f32(rng.standard_normal(cmid) * 0.1)
    w2, b2 = f32(rng.standard_normal((3, 3, cmid, cout)) * 0.1), f32(rng.standard_normal(cout) * 0.1)
    ref = jax_conv.fused_block(_bf16_jax(x), *(jnp.asarray(a) for a in (w1, b1, w2, b2)), slope=0.2,
                               eps=1e-8, out_dtype=jnp.bfloat16, interpret=True)
    got = conv_ops.fused_block(_bf16_torch(x), _oihw(w1), torch.from_numpy(b1), _oihw(w2),
                               torch.from_numpy(b2), 0.2, 1e-8, out_dtype=torch.bfloat16)
    _assert_within_one_ulp(_f32(got), _f32(ref))


def test_bf16_block_plain_is_the_bf16_pair_exactly():
    """K4's plain version holds conv1's output in bf16, as the JAX kernel's
    c1 scratch does: it is K1 bf16 then K3 bf16, bit for bit."""
    x, w1, b1 = _inputs(4, 2, 8, 16, 6, 20)
    _, w2, b2 = _inputs(5, 1, 16, 12, 1, 1)
    xt, w1t, w2t = _bf16_torch(x), _oihw(w1), _oihw(w2)
    b1t, b2t = torch.from_numpy(b1), torch.from_numpy(b2)
    bf = torch.bfloat16
    block = conv_ops.fused_block(xt, w1t, b1t, w2t, b2t, 0.2, 1e-8, out_dtype=bf)
    mid = conv_ops.fused_conv3x3(xt, w1t, b1t, 0.2, True, 1e-8, out_dtype=bf)
    pair = conv_ops.fused_upconv3x3(mid, w2t, b2t, 0.2, True, 1e-8, out_dtype=bf)
    assert mid.dtype == block.dtype == torch.bfloat16
    assert torch.equal(block, pair)
    assert torch.equal(block, conv_ops.fused_block_plain(xt, w1t, b1t, w2t, b2t, 0.2, 1e-8))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("cin,cout", [(6, 10), (16, 32), (5, 33)])
def test_bf16_kernel_weights_are_jax_pack_weights_in_bf16(cin, cout):
    """The bf16 kernel layout: JAX's ``pack_weights(w).astype(bfloat16)``
    permuted to ``(cin, 9, coutp)``, zeros past ``cout``, bit for bit."""
    wt = _inputs(cin, 1, cin, cout, 1, 1)[1]
    packed = _bits(jax_conv.pack_weights(jnp.asarray(wt)).astype(jnp.bfloat16))
    coutp = -(-cout // 16) * 16
    want = np.zeros((cin, 9, coutp), np.uint16)
    want[:, :, :cout] = packed.reshape(cout, 9, cin).transpose(2, 1, 0)
    got = conv_ops.kernel_weights(_oihw(wt), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), want)


@pytest.mark.parametrize("cin,cout", [(6, 10), (16, 32), (5, 33)])
def test_bf16_kernel_upconv_weights_round_the_phase_sums(cin, cout):
    """The bf16 up-conv layout: JAX's ``pack_upconv_weights(w)`` (the 2x2
    phase kernels summed in float32) rounded to bf16, permuted, bit for bit;
    rounding the 3x3 taps before the phase sums gives other bits here."""
    wt = _inputs(cout, 1, cin, cout, 1, 1)[1]
    packed = _bits(jax_conv.pack_upconv_weights(jnp.asarray(wt)).astype(jnp.bfloat16))
    coutp = -(-cout // 16) * 16
    want = np.zeros((4, cin, 4, coutp), np.uint16)
    want[..., :cout] = packed.reshape(4, cout, 4, cin).transpose(0, 3, 2, 1)
    got = conv_ops.kernel_upconv_weights(_oihw(wt), torch.bfloat16)
    np.testing.assert_array_equal(_bits(got), want)
    taps_first = conv_ops.kernel_upconv_weights(_oihw(wt).to(torch.bfloat16).float(), torch.bfloat16)
    assert (_bits(taps_first) != want).any()


def test_plain_versions_round_the_weights_as_the_kernels_read_them():
    """The bf16 plain versions compute on the same bf16 weights the kernels'
    packs hold: rounding the OIHW taps (K1), the summed phase kernels (K3)."""
    x, wt, bias = _inputs(8, 1, 6, 10, 5, 7)
    xt, wo, bt = _bf16_torch(x), _oihw(wt), torch.from_numpy(bias)
    k1 = conv_ops.kernel_weights(wo, torch.bfloat16).float()[..., :10]          # (cin, 9, cout)
    w_k1 = k1.permute(2, 0, 1).reshape(10, 6, 3, 3)
    y = conv_ops.conv3x3_plain(xt, wo, bt)
    assert torch.equal(y, torch.nn.functional.conv2d(xt.float(), w_k1, bt, padding=1).to(torch.bfloat16))
    ku = conv_ops.kernel_upconv_weights(wo, torch.bfloat16).float()[..., :10]  # (4, cin, 4, cout)
    phases = [ku[p].permute(2, 0, 1).reshape(10, 6, 2, 2) for p in range(4)]
    from musicgan_tpu_torch.models.layers import subpixel_conv

    want = subpixel_conv(xt.float(), phases, bt).to(torch.bfloat16)
    assert torch.equal(conv_ops.upconv3x3_plain(xt, wo, bt), want)


def test_kernel_operands_are_checked_for_the_call_dtype():
    """``_operands`` (before any launch): x and its packed weights of one
    dtype the kernels take, the bias float32."""
    x = torch.empty(1, 4, 2, 2, device="meta", dtype=torch.bfloat16)
    wp = torch.empty(4, 9, 16, device="meta", dtype=torch.bfloat16)
    b = torch.empty(16, device="meta")
    conv_ops._operands("conv3x3", x, wp, b, True, 16)
    for bad in ((x, wp.float(), b), (x, wp, b.to(torch.bfloat16)), (x.double(), wp.double(), b)):
        with pytest.raises(ValueError):
            conv_ops._operands("conv3x3", *bad, True, 16)


# ---- The bf16 wgmma operand layouts, modelled on the CPU.
#
# PTX ISA, wgmma.mma_async .m64nNk16 with A in registers: warp wq of the
# warpgroup holds rows 16*wq .. 16*wq + 15; its lane 4*g + t holds A's
# register i = 0..3 as the pair (row 16*wq + g + 8*(i & 1), columns
# 2t + 8*(i >> 1) and + 1), the lower column in the low half.  B (K x N)
# K-major in shared memory without swizzle: element (k, n) at byte
# (k // 8) * LBO + (n // 8) * SBO + (n % 8) * 16 + (k % 8) * 2.

def _a_registers(planes: np.ndarray, plane: int, base: int) -> dict:
    """``AFrag<bf16>::load`` for every thread: ``planes`` is a stage's
    staged input as a flat array of bf16 bit patterns, channel c of the
    chunk at ``c * plane``; ``base`` the element offset of the tile's pixel
    0 in channel 0 (the halo row and column shift).  Returns {(wq, g, t):
    [4 registers]}."""
    regs = {}
    for wq in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            ap = base + 2 * t * plane + 16 * wq + g   # a_base: channel CH * t, pixel 16 * wq + g
            offs = (0, 8, 8 * plane, 8 * plane + 8)
            regs[(wq, g, t)] = [int(planes[ap + o]) | (int(planes[ap + o + plane]) << 16) for o in offs]
    return regs


def _a_matrix(regs: dict) -> np.ndarray:
    """The m64 x k16 matrix the tensor cores read from those registers."""
    a = np.zeros((64, 16), np.uint16)
    for (wq, g, t), rr in regs.items():
        for i, r in enumerate(rr):
            row, col = 16 * wq + g + 8 * (i & 1), 2 * t + 8 * (i >> 1)
            a[row, col], a[row, col + 1] = r & 0xFFFF, r >> 16
    return a


def _b_stage(wk: np.ndarray, n: int, nt: int, ci0: int) -> np.ndarray:
    """``load_weight_chunk`` + ``store_stage_weights`` for bf16 (K = 3,
    taps 0 .. nt - 1, co_base 0): the stage's weight plane as 16-byte words
    [e][8] of bf16 bit patterns, e = (tap, octet, n) with n fastest; ``wk``
    the (cin, 9, coutp) kernel layout as bit patterns."""
    cin, _, coutp = wk.shape
    words = np.zeros((nt * 2 * n, 8), np.uint16)
    for e in range(nt * 2 * n):
        nn, tt = e % n, e // n
        octet, tap = tt & 1, tt >> 1
        for j in range(8):
            c = ci0 + 8 * octet + j
            if c < cin and nn < coutp:
                words[e, j] = wk[c, tap, nn]
    return words.reshape(-1)


def _b_matrix(stage_words: np.ndarray, tap: int, n: int) -> np.ndarray:
    """The k16 x N matrix wgmma reads through ``smem_desc(b + tap offset,
    LBO = N * 16, SBO = 128)``, the descriptor the kernels build."""
    flat = stage_words.view(np.uint8)
    base = (tap * n * 32 >> 4) << 4
    b = np.zeros((16, n), np.uint16)
    for k in range(16):
        for nn in range(n):
            byte = base + (k // 8) * n * 16 + (nn // 8) * 128 + (nn % 8) * 16 + (k % 8) * 2
            b[k, nn] = int(flat[byte]) | (int(flat[byte + 1]) << 8)
    return b


def _from_bits(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("n,cin", [(16, 16), (48, 16), (32, 21)])
def test_bf16_wgmma_operand_layouts_compute_the_conv(n, cin):
    """For every tap of one 16-channel chunk, the product the kernel
    issues, A (registers loaded from the staged planes, shifted by the tap's
    column) times B (the stage's weight plane through the descriptor), is
    that tap's part of the 3x3 conv of one 64-pixel row."""
    rng = np.random.default_rng(n + cin)
    ck, sw = 16, 72                              # one halo row of 72 columns a channel
    plane = (2 * sw + 23) // 32 * 32 + 8         # tc_geom's plane of a two-row halo
    x = rng.standard_normal((cin, sw)).astype(np.float32)
    w = (rng.standard_normal((n, cin, 3, 3)) * 0.1).astype(np.float32)
    wk = _bits(conv_ops.kernel_weights(torch.from_numpy(w), torch.bfloat16))     # (cin, 9, n)
    xb = _bits(torch.from_numpy(x).to(torch.bfloat16))
    planes = np.zeros(ck * plane, np.uint16)
    for c in range(min(ck, cin)):
        planes[c * plane : c * plane + sw] = xb[c]
    stage = _b_stage(wk, n, 9, 0)
    xf = _from_bits(xb)
    wf = _from_bits(wk).reshape(cin, 9, n)
    for tap in range(9):
        dx = tap % 3
        # conv_tc_kernel's row(j) + s at s = dx: staged column 0 is image
        # column c0 - 4, so pixel m (image column c0 + m) reads staged column
        # 3 + m + dx, image column c0 + m + dx - 1.
        a = _from_bits(_a_matrix(_a_registers(planes, plane, 3 + dx)))
        b = _from_bits(_b_matrix(stage, tap, n))
        want = np.zeros((64, n), np.float64)
        for m in range(64):
            for c in range(min(ck, cin)):
                want[m] += float(xf[c, 3 + m + dx]) * wf[c, tap].astype(np.float64)
        np.testing.assert_allclose(a.astype(np.float64) @ b.astype(np.float64), want, rtol=0, atol=1e-12)


# ---- The generator and synthesis.

IMPLS = ["pallas", "pallas_bf16", "pallas_up_bf16", "pallas_block_bf16"]


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("impl", IMPLS)
def test_generator_matches_jax_under_the_new_impls(impl, alpha):
    """``Generator.forward_nchw`` against ``generator_forward`` with the
    same impl (Pallas in interpret mode), ``TINY_MODEL`` at stage 3, the
    JAX parameters carried across, on ``tests/test_ops.py``'s own inputs:
    the output is float32; ``"pallas"`` within 2e-5 (the generator bar); a
    bf16 impl within 2e-2 of JAX's bf16 output (a one-ulp difference in an
    activation, 2^-7 relative, is the most either may take) and within JAX's
    own 0.08 of its float32 XLA path (``tests/test_ops.py``: at other seeds
    JAX's bf16 path itself reads up to 0.086 there)."""
    params = jax.tree_util.tree_map(np.asarray, init_generator(jax.random.PRNGKey(0), TINY_MODEL))
    z = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 2, 2, TINY_MODEL.rand_channels)))
    ref = np.asarray(generator_forward(params, jnp.asarray(z), 3, alpha,
                                       dataclasses.replace(TINY_MODEL, conv_impl=impl)))
    f32 = np.asarray(generator_forward(params, jnp.asarray(z), 3, alpha, TINY_MODEL))
    cfg = ModelConfig(rand_channels=TINY_MODEL.rand_channels, gen_channels=TINY_MODEL.gen_channels,
                      conv_impl=impl)
    gen = Generator(cfg)
    gen.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = gen(torch.from_numpy(z), 3, alpha)
    assert got.dtype == torch.float32
    got = got.numpy()
    if impl == "pallas":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
        return
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)
    np.testing.assert_allclose(got, f32, atol=0.08, rtol=0)


def test_generator_runs_its_blocks_in_bf16(monkeypatch):
    """Under a bf16 impl every conv of the stack sees bf16 activations and
    bf16 packed weights (cached apart from the float32 ones)."""
    seen = []
    real = conv_ops.fused_upconv3x3

    def spy(x, *a, w_packed=None, **kw):
        seen.append((x.dtype, w_packed.dtype))
        return real(x, *a, w_packed=w_packed, **kw)

    monkeypatch.setattr(conv_ops, "fused_upconv3x3", spy)
    cfg = ModelConfig(rand_channels=8, gen_channels=TINY_MODEL.gen_channels, conv_impl="pallas_up_bf16")
    gen = Generator(cfg, seed=2)
    z = torch.randn(1, 8, 2, 2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y16 = gen.forward_nchw(z, 2)
        gen.cfg = dataclasses.replace(cfg, conv_impl="pallas_up")
        y32 = gen.forward_nchw(z, 2)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 3 + [(torch.float32, torch.float32)] * 3
    assert y16.dtype == y32.dtype == torch.float32
    assert {k[1] for k in gen.blocks[0]._packs} == {torch.bfloat16, torch.float32}


def test_synthesize_fn_bf16_matches_jax_at_a_partial_stage():
    """``synthesize_fn`` under ``"pallas_up_bf16"`` against JAX's, TINY_MODEL
    stage 3, two clips, at the repo's waveform bar 1e-4: the images agree
    to a few bf16 roundings, the phase prefix sum over 512 frames grows that
    to ~1e-6 here."""
    params = jax.tree_util.tree_map(np.asarray, init_generator(jax.random.PRNGKey(5), TINY_MODEL))
    z = np.random.default_rng(3).standard_normal((2, 2, 2, 8)).astype(np.float32)
    jcfg = dataclasses.replace(TINY_MODEL, conv_impl="pallas_up_bf16")
    ref = np.asarray(jax_synthesize_fn(jcfg, stage=3)(params, z))
    cfg = ModelConfig(rand_channels=8, gen_channels=TINY_MODEL.gen_channels, conv_impl="pallas_up_bf16")
    gen = Generator(cfg)
    gen.load_state_dict(params_from_jax(params))
    got = synthesize_fn(cfg, stage=3)(gen, z).numpy()
    assert got.shape == ref.shape == (2, (512 - 1) * 256)
    assert float(np.abs(ref).max()) > 1e-3
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def _rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_synthesis_of_the_shipped_generator_matches_jax():
    """The trained generator, one clip of nb_vec 1, under
    ``"pallas_up_bf16"`` in both packages.  bf16 rounds every activation and
    16 convs, PixelNorm and the phase head's tanh compound it: each bf16
    path lies about 0.04 (2-norm, relative) from its own float32 path, with
    single pixels of the phase channel far apart where its tanh saturates
    the other way, so no max-abs bar holds there.  The two bf16 paths sum
    the same exact products in another order: held within 0.02 of each
    other, and each within 0.08 of float32 (``chip_smoke.py``'s
    ``TOL_IMAGE_BF16_L2``)."""
    from musicgan_tpu.models.torch_ingest import load_reference_generator as jax_load
    from musicgan_tpu.config import ModelConfig as JaxModelConfig
    from musicgan_tpu_torch.models import load_reference_generator

    gen_pt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "saved_models", "quality_r4", "gen_final.pt")
    z = np.random.default_rng(17).standard_normal((1, 2, 2, 32)).astype(np.float32)
    jcfg = JaxModelConfig()
    params = jax_load(gen_pt, jcfg)
    ref = np.asarray(generator_forward(params, jnp.asarray(z), 7, 1.0,
                                       dataclasses.replace(jcfg, conv_impl="pallas_up_bf16")))
    ref32 = np.asarray(generator_forward(params, jnp.asarray(z), 7, 1.0, jcfg))
    cfg = ModelConfig()
    with torch.no_grad():
        got = load_reference_generator(gen_pt, dataclasses.replace(cfg, conv_impl="pallas_up_bf16"))(
            torch.from_numpy(z), 7).numpy()
        got32 = load_reference_generator(gen_pt, cfg)(torch.from_numpy(z), 7).numpy()
    assert got.shape == ref.shape == (1, 512, 512, 2) and got.dtype == np.float32
    assert _rel_l2(got, ref) <= 0.02
    assert _rel_l2(ref, ref32) <= 0.08 and _rel_l2(got, got32) <= 0.08
