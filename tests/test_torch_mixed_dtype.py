"""The mixed-dtype calls of K1-K4 and the wrappers' default output dtype,
against the JAX package, on the CPU.

The JAX functions ``fused_conv3x3``, ``fused_upconv3x3`` and
``fused_block`` take any ``out_dtype`` (float32 by default, whatever ``x``
is), and ``fused_conv3x3_msq`` returns float32 ``y`` and ``m`` whatever
``x`` is.  Their kernels compute in ``x``'s dtype (weights cast to it, the
products summed in float32, the epilogue in float32; K4's c1 scratch in
``x``'s dtype) and cast to ``out_dtype`` only at the store, so:

* float32 in, bf16 out is the float32 result rounded once: held to one bf16
  ulp elementwise, ``|a - b| <= 2^-7 * max(|a|, |b|) + 1e-5`` (the two sum
  in another order, and one float32 rounding apart can round to
  neighbours; the 1e-5 is for outputs near zero, where the two float32
  sums' difference is no longer small beside the value: K4 at 5e-6 differs
  by 1.2e-7 in float32 already, 2%);
* bf16 in, float32 out is the exact bf16 products summed in float32,
  unrounded: held within 2e-5 of the output's largest magnitude (the same
  products summed in another order);
* K4 bf16 in, float32 out rounds c1 to bf16 on the way, where a reordered
  sum can flip one rounding: one bf16 ulp elementwise, as above.

JAX runs its Pallas kernels in interpret mode (``tests/test_ops.py``), the
port its wrappers on CPU tensors (the plain versions).  Inputs are made
with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from musicgan_tpu.ops import conv as jax_conv
from musicgan_tpu_torch.ops import conv as conv_ops

BF16_ULP, BF16_ABS = 2.0**-7, 1e-5
F32_REL = 2e-5

# Widths of the path cut down, a cout that is no multiple of 16, an odd cin
# and ragged images (tests/test_torch_bf16.py's).
CONV_SHAPES = [(1, 16, 32, 8, 40), (2, 12, 20, 5, 9), (1, 5, 7, 13, 37)]
# tests/test_ops.py's block shape, a ragged one, and one past 128 channels
# (K4 splits each conv's channels over a cluster there).
BLOCK_SHAPES = [(1, 16, 24, 32, 8, 32), (2, 5, 7, 3, 13, 37), (1, 16, 136, 144, 4, 10)]


def _conv_inputs(seed, b, cin, cout, h, w):
    """x (NCHW), HWIO weights and the bias, float32, as the JAX package
    keeps them."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(rng.standard_normal((b, cin, h, w))), f32(rng.standard_normal((3, 3, cin, cout)) * 0.1),
            f32(rng.standard_normal(cout) * 0.1))


def _block_inputs(seed, b, cin, cmid, cout, h, w):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(rng.standard_normal((b, cin, h, w))),
            f32(rng.standard_normal((3, 3, cin, cmid)) * 0.1), f32(rng.standard_normal(cmid) * 0.1),
            f32(rng.standard_normal((3, 3, cmid, cout)) * 0.1), f32(rng.standard_normal(cout) * 0.1))


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _x(x, dtype):
    """x for both packages in ``dtype``: (torch, JAX), the same values."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x).astype(jnp.bfloat16)
    return torch.from_numpy(x), jnp.asarray(x)


JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(t) -> np.ndarray:
    """A result of either package as float64 numpy, exactly."""
    if isinstance(t, torch.Tensor):
        return t.double().numpy()
    return np.asarray(t.astype(jnp.float32), np.float64)


def _assert_within_one_ulp(got, ref) -> None:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    bad = np.abs(got - ref) > BF16_ULP * np.maximum(np.abs(got), np.abs(ref)) + BF16_ABS
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} past one bf16 ulp"


def _assert_close_f32(got, ref) -> None:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= F32_REL, f"max abs err {err:.3e} of the largest magnitude"


def _check(got, ref, x_dtype, out_dtype) -> None:
    assert got.dtype == out_dtype
    assert ref.dtype == JAX_DTYPE[out_dtype]
    if out_dtype == torch.bfloat16:
        _assert_within_one_ulp(got, ref)
    else:
        _assert_close_f32(got, ref)


PAIRS = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("x_dtype,out_dtype", PAIRS, ids=["f32_bf16", "bf16_f32"])
@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES)
def test_mixed_conv3x3_matches_jax_interpret(b, cin, cout, h, w, x_dtype, out_dtype):
    x, wt, bias = _conv_inputs(b + cout, b, cin, cout, h, w)
    xt, xj = _x(x, x_dtype)
    ref = jax_conv.fused_conv3x3(xj, jnp.asarray(wt), jnp.asarray(bias), slope=0.2, pixel_norm=True,
                                 out_dtype=JAX_DTYPE[out_dtype], interpret=True)
    got = conv_ops.fused_conv3x3(xt, _oihw(wt), torch.from_numpy(bias), 0.2, True, out_dtype=out_dtype)
    _check(got, ref, x_dtype, out_dtype)


@pytest.mark.parametrize("x_dtype,out_dtype", PAIRS, ids=["f32_bf16", "bf16_f32"])
@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES)
def test_mixed_upconv3x3_matches_jax_interpret(b, cin, cout, h, w, x_dtype, out_dtype):
    x, wt, bias = _conv_inputs(b + cin, b, cin, cout, h, w)
    xt, xj = _x(x, x_dtype)
    ref = jax_conv.fused_upconv3x3(xj, jnp.asarray(wt), jnp.asarray(bias), slope=0.2, pixel_norm=True,
                                   out_dtype=JAX_DTYPE[out_dtype], interpret=True)
    got = conv_ops.fused_upconv3x3(xt, _oihw(wt), torch.from_numpy(bias), 0.2, True, out_dtype=out_dtype)
    assert got.shape == (b, cout, 2 * h, 2 * w)
    _check(got, ref, x_dtype, out_dtype)


@pytest.mark.parametrize("b,cin,cout,h,w", CONV_SHAPES)
def test_bf16_msq_matches_jax_interpret(b, cin, cout, h, w):
    """K2 with bf16 x: float32 ``y`` and ``m``, as JAX's."""
    x, wt, bias = _conv_inputs(b + h, b, cin, cout, h, w)
    xt, xj = _x(x, torch.bfloat16)
    y_ref, m_ref = jax_conv.fused_conv3x3_msq(xj, jnp.asarray(wt), jnp.asarray(bias), slope=0.2, interpret=True)
    y, m = conv_ops.fused_conv3x3_msq(xt, _oihw(wt), torch.from_numpy(bias), 0.2)
    assert y.dtype == m.dtype == torch.float32 and m.shape == (b, 1, h, w)
    _check(y, y_ref, torch.bfloat16, torch.float32)
    _check(m, m_ref, torch.bfloat16, torch.float32)


@pytest.mark.parametrize("x_dtype,out_dtype", PAIRS, ids=["f32_bf16", "bf16_f32"])
@pytest.mark.parametrize("b,cin,cmid,cout,h,w", BLOCK_SHAPES)
def test_mixed_block_matches_jax_interpret(b, cin, cmid, cout, h, w, x_dtype, out_dtype):
    """Both pairs to one bf16 ulp: the float32 result rounded once, or the
    float32 result of a c1 held in bf16 (one of whose roundings a
    reordered sum can flip)."""
    x, w1, b1, w2, b2 = _block_inputs(cmid, b, cin, cmid, cout, h, w)
    xt, xj = _x(x, x_dtype)
    ref = jax_conv.fused_block(xj, *(jnp.asarray(a) for a in (w1, b1, w2, b2)), slope=0.2, eps=1e-8,
                               out_dtype=JAX_DTYPE[out_dtype], interpret=True)
    got = conv_ops.fused_block(xt, _oihw(w1), torch.from_numpy(b1), _oihw(w2), torch.from_numpy(b2), 0.2, 1e-8,
                               out_dtype=out_dtype)
    assert got.dtype == out_dtype
    _assert_within_one_ulp(got, ref)


@pytest.mark.parametrize("b,cin,cmid,cout,h,w", BLOCK_SHAPES[:2])
def test_block_plain_bf16_to_f32_is_the_pair_exactly(b, cin, cmid, cout, h, w):
    """K4's plain version, bf16 in and float32 out: conv1 rounded to bf16
    (the JAX kernel's c1 scratch), then K3 with a float32 output, bit for
    bit; rounded to bf16 it is the bf16 block's."""
    x, w1, b1, w2, b2 = _block_inputs(cout, b, cin, cmid, cout, h, w)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    w1t, b1t, w2t, b2t = _oihw(w1), torch.from_numpy(b1), _oihw(w2), torch.from_numpy(b2)
    block = conv_ops.fused_block_plain(xt, w1t, b1t, w2t, b2t, 0.2, 1e-8, out_dtype=torch.float32)
    mid = conv_ops.conv3x3_plain(xt, w1t, b1t, 0.2, True, 1e-8)
    pair = conv_ops.upconv3x3_plain(mid, w2t, b2t, 0.2, True, 1e-8, out_dtype=torch.float32)
    assert mid.dtype == torch.bfloat16 and block.dtype == torch.float32
    assert torch.equal(block, pair)
    assert torch.equal(block.to(torch.bfloat16), conv_ops.fused_block_plain(xt, w1t, b1t, w2t, b2t, 0.2, 1e-8))


@pytest.mark.parametrize("wrapper", ["fused_conv3x3", "fused_upconv3x3", "fused_block"])
def test_default_out_dtype_is_float32_as_jax(wrapper):
    """A bf16 ``x`` and no ``out_dtype``: float32 out, as the JAX function's
    default call gives."""
    b, cin, cmid, cout, h, w = 1, 5, 7, 13, 5, 7
    x, w1, b1, w2, b2 = _block_inputs(3, b, cin, cmid, cout, h, w)
    xt, xj = _x(x, torch.bfloat16)
    if wrapper == "fused_block":
        ref = jax_conv.fused_block(xj, *(jnp.asarray(a) for a in (w1, b1, w2, b2)), interpret=True)
        got = conv_ops.fused_block(xt, _oihw(w1), torch.from_numpy(b1), _oihw(w2), torch.from_numpy(b2))
        assert got.dtype == torch.float32
        _assert_within_one_ulp(got, ref)
        return
    ref = getattr(jax_conv, wrapper)(xj, jnp.asarray(w1), jnp.asarray(b1), slope=0.2, pixel_norm=True,
                                     interpret=True)
    got = getattr(conv_ops, wrapper)(xt, _oihw(w1), torch.from_numpy(b1), 0.2, True)
    _check(got, ref, torch.bfloat16, torch.float32)


def test_plain_versions_keep_x_dtype_by_default():
    """The plain versions' default stays ``x``'s dtype (K4's plain version
    relies on it for c1); the wrappers pass them the call's dtype."""
    x, wt, bias = _conv_inputs(5, 1, 4, 6, 3, 5)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert conv_ops.conv3x3_plain(xt, _oihw(wt), torch.from_numpy(bias)).dtype == torch.bfloat16
    assert conv_ops.upconv3x3_plain(xt, _oihw(wt), torch.from_numpy(bias)).dtype == torch.bfloat16


@pytest.mark.parametrize("x_dtype,out_dtype", [(torch.float32, torch.float16), (torch.float64, torch.float32),
                                                (torch.bfloat16, torch.float64)])
def test_other_pairs_raise(x_dtype, out_dtype):
    """Only float32 and bf16 mix; any other pair raises, on the CPU too."""
    x, wt, bias = _conv_inputs(6, 1, 4, 4, 3, 3)
    xt = torch.from_numpy(x).to(x_dtype)
    with pytest.raises(NotImplementedError, match="mixed pair"):
        conv_ops.fused_conv3x3(xt, _oihw(wt), torch.from_numpy(bias), 0.2, True, out_dtype=out_dtype)


def test_mixed_calls_on_the_cpu_launch_nothing():
    """On a CPU tensor a mixed call takes the plain version: no kernel
    launch is counted, mixed or not."""
    x, wt, bias = _conv_inputs(7, 1, 4, 4, 3, 3)
    fns = (conv_ops.fused_conv3x3, conv_ops.fused_conv3x3_msq, conv_ops.fused_upconv3x3, conv_ops.fused_block)
    before = [(f.launches, f.mixed_launches) for f in fns]
    xt, w, b = torch.from_numpy(x), _oihw(wt), torch.from_numpy(bias)
    conv_ops.fused_conv3x3(xt, w, b, 0.2, True, out_dtype=torch.bfloat16)
    conv_ops.fused_conv3x3_msq(xt.to(torch.bfloat16), w, b, 0.2)
    conv_ops.fused_upconv3x3(xt.to(torch.bfloat16), w, b, 0.2, True)
    conv_ops.fused_block(xt, w, b, w, b, out_dtype=torch.bfloat16)
    assert [(f.launches, f.mixed_launches) for f in fns] == before
