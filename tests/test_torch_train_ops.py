"""The train step's building blocks against the JAX package, on the CPU:
K2's plain version, the trainable conv ``conv3x3_act`` and its hand-written
backward, the per-leaf Adam, the input pipeline, the losses and the new
layers.  The JAX side runs its Pallas kernels in interpret mode, as its own
tests do; on the CPU the port runs the plain versions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from musicgan_tpu.audio.transforms import grower_transform as jax_grower_transform
from musicgan_tpu.models import layers as jax_layers
from musicgan_tpu.models import losses as jax_losses
from musicgan_tpu.ops.conv import fused_conv3x3_msq as jax_fused_conv3x3_msq
from musicgan_tpu.ops.conv_vjp import conv3x3_act as jax_conv3x3_act
from musicgan_tpu.train.optim import adam_per_leaf as jax_adam_per_leaf
from musicgan_tpu_torch.audio.transforms import grower_transform
from musicgan_tpu_torch.config import TrainConfig
from musicgan_tpu_torch.models import layers, losses
from musicgan_tpu_torch.ops import conv as conv_ops
from musicgan_tpu_torch.ops import conv_vjp
from musicgan_tpu_torch.train.optim import adam_per_leaf


def _conv_inputs(seed, b, cin, cout, h, w):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cin, h, w)).astype(np.float32)
    w_hwio = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    cot = rng.standard_normal((b, cout, h, w)).astype(np.float32)
    return x, w_hwio, bias, cot


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))


def _relerr(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


@pytest.mark.parametrize("b,cin,cout,h,w", [(2, 3, 4, 8, 10), (1, 12, 20, 9, 33)])
def test_conv3x3_msq_plain_matches_the_pallas_kernel(b, cin, cout, h, w):
    """K2's plain version against the Pallas kernel in interpret mode: ``y``
    at 1e-4, the pre-norm mean-square map at 1e-4 relative."""
    x, w_hwio, bias, _ = _conv_inputs(0, b, cin, cout, h, w)
    y_ref, m_ref = jax_fused_conv3x3_msq(x, w_hwio, bias, slope=0.2, eps=1e-8, interpret=True)
    y, m = conv_ops.conv3x3_msq_plain(torch.from_numpy(x), _oihw(w_hwio), torch.from_numpy(bias), 0.2, 1e-8)
    assert m.shape == (b, 1, h, w)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4, rtol=0)
    assert _relerr(m.numpy(), m_ref) < 1e-4
    # On a CPU tensor the wrapper is the plain version.
    y2, m2 = conv_ops.fused_conv3x3_msq(torch.from_numpy(x), _oihw(w_hwio), torch.from_numpy(bias), 0.2, 1e-8)
    torch.testing.assert_close(y2, y, atol=0, rtol=0)
    torch.testing.assert_close(m2, m, atol=0, rtol=0)


@pytest.mark.parametrize("slope,pn", [(0.2, True), (0.2, False), (None, False)])
def test_conv3x3_act_value_and_gradients_match_jax(slope, pn):
    """Value at 1e-5; the gradients in x, w and b against ``jax.grad`` of the
    custom-VJP conv (its input gradient on the Pallas kernel) at 1e-4
    relative to each gradient's largest value."""
    x, w_hwio, bias, cot = _conv_inputs(1, 1, 3, 4, 8, 10)
    v_ref = jax_conv3x3_act(x, w_hwio, bias, slope, pn, 1e-8)
    g_ref = jax.grad(
        lambda *a: jnp.sum(jax_conv3x3_act(*a, slope, pn, 1e-8) * cot), argnums=(0, 1, 2)
    )(jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(bias))

    leaves = [t.requires_grad_(True) for t in (torch.from_numpy(x), _oihw(w_hwio), torch.from_numpy(bias))]
    v = conv_vjp.conv3x3_act(*leaves, slope, pn, 1e-8)
    dx, dw, db = torch.autograd.grad((v * torch.from_numpy(cot)).sum(), leaves)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(v_ref), atol=1e-5, rtol=0)
    assert _relerr(dx, g_ref[0]) < 1e-4
    assert _relerr(dw.permute(2, 3, 1, 0), g_ref[1]) < 1e-4  # OIHW -> HWIO
    assert _relerr(db, g_ref[2]) < 1e-4


@pytest.mark.parametrize("slope,pn", [(0.2, True), (0.2, False), (None, False)])
@pytest.mark.parametrize("needs", [(True, True, True), (False, True, False), (True, False, False)])
def test_conv3x3_act_backward_formula_matches_autograd(slope, pn, needs):
    """The Function's hand-written backward (epilogue gradient from ``y``
    and ``m``, input gradient as a conv with rotated, swapped weights, the
    library's weight gradient), with the plain conv standing in for K1,
    against ordinary autograd through the plain chain: 1e-5 relative."""
    x, w_hwio, bias, cot = _conv_inputs(2, 2, 5, 7, 6, 9)
    x, w, bias, cot = torch.from_numpy(x), _oihw(w_hwio), torch.from_numpy(bias), torch.from_numpy(cot)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    ref = torch.autograd.grad((conv_vjp.conv3x3_act_plain(*leaves, slope, pn, 1e-8) * cot).sum(), leaves)

    if pn:
        y, m = conv_ops.conv3x3_msq_plain(x, w, bias, slope, 1e-8)
    else:
        y, m = conv_ops.conv3x3_plain(x, w, bias, slope, False, 1e-8), None
    got = conv_vjp.conv3x3_act_backward(x, w, y, m, cot, slope, pn, 1e-8, needs)
    for g, r, need in zip(got, ref, needs):
        if need:
            assert _relerr(g, r) < 1e-5
        else:
            assert g is None


def test_conv3x3_act_subgradient_at_zero_is_one():
    """Where the pre-activation is exactly 0 the LeakyReLU gradient is 1
    (``y >= 0``), in the plain version under autograd and in the
    hand-written backward alike; ``F.leaky_relu`` would give ``slope``."""
    x = torch.zeros(1, 1, 3, 3, requires_grad=True)
    w, b = torch.ones(2, 1, 3, 3), torch.zeros(2)
    y = conv_vjp.conv3x3_act(x, w, b, 0.2, False, 0.0)
    (dx,) = torch.autograd.grad(y.sum(), x)
    dx_hand, _, _ = conv_vjp.conv3x3_act_backward(
        x.detach(), w, y.detach(), None, torch.ones_like(y), 0.2, False, 0.0, (True, False, False)
    )
    assert float(dx[0, 0, 1, 1]) == float(dx_hand[0, 0, 1, 1]) == 18.0


@pytest.mark.parametrize("b,cin,cout,h,w", [(2, 3, 5, 7, 9), (1, 16, 8, 4, 4), (3, 8, 40, 5, 1)])
def test_weight_grad3x3_matches_jax(b, cin, cout, h, w):
    """The weight gradient on the CPU (the kernel's plain version, no launch)
    against JAX's: the vjp of its 3x3 'SAME' conv in the weights, 1e-5
    relative to the largest value."""
    rng = np.random.default_rng(b + cin + cout)
    x = rng.standard_normal((b, cin, h, w)).astype(np.float32)
    d = rng.standard_normal((b, cout, h, w)).astype(np.float32)
    w_hwio = np.zeros((3, 3, cin, cout), np.float32)

    def conv(w_):
        return jax.lax.conv_general_dilated(
            jnp.asarray(x), w_, (1, 1), "SAME", dimension_numbers=("NCHW", "HWIO", "NCHW"))

    _, vjp = jax.vjp(conv, jnp.asarray(w_hwio))
    ref = np.asarray(vjp(jnp.asarray(d))[0]).transpose(3, 2, 0, 1)  # HWIO -> OIHW
    n0 = conv_vjp.weight_grad3x3.launches
    got = conv_vjp.weight_grad3x3(torch.from_numpy(x), torch.from_numpy(d), (cout, cin, 3, 3))
    assert conv_vjp.weight_grad3x3.launches == n0
    assert got.shape == (cout, cin, 3, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError, match="no kernel for device"):
        conv_vjp.weight_grad3x3(torch.from_numpy(x).to("meta"), torch.from_numpy(d).to("meta"),
                                (cout, cin, 3, 3))


def test_conv3x3_act_refuses_other_devices():
    x = torch.zeros(1, 1, 3, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        conv_vjp.conv3x3_act(x, torch.zeros(1, 1, 3, 3, device="meta"), None)
    with pytest.raises(ValueError, match="no kernel for device"):
        conv_ops.fused_conv3x3_msq(x, torch.zeros(1, 1, 3, 3, device="meta"), None)


def test_adam_per_leaf_matches_jax_across_a_growth_boundary():
    """~8 steps with identical given gradients; leaf ``late`` is all-zero
    for the first 5 (a head before its stage) and missing (None) in the
    port for two of those.  Parameters and moments at 1e-6, counts exact."""
    rng = np.random.default_rng(3)
    shapes = {"early": (4, 3), "late": (5,), "never": (2, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    lr, b1, b2 = 1e-3, 0.5, 0.9
    opt_j = jax_adam_per_leaf(lr, b1=b1, b2=b2)
    params_j = {k: jnp.asarray(v) for k, v in p0.items()}
    state_j = opt_j.init(params_j)

    opt_t = adam_per_leaf(lr, b1=b1, b2=b2)
    params_t = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state_t = opt_t.init(params_t)

    for step in range(8):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        if step < 5:
            g["late"][:] = 0.0
        g["never"][:] = 0.0
        upd, state_j = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, state_j)
        params_j = {k: params_j[k] + upd[k] for k in params_j}
        g_t = {k: torch.from_numpy(v) for k, v in g.items()}
        if step in (1, 3):
            g_t["late"] = None
        del g_t["never"]  # a missing entry is an all-zero gradient too
        opt_t.update(g_t, state_t, params_t)

        for k in shapes:
            assert int(state_t.count[k]) == int(state_j.count[k])
            np.testing.assert_allclose(params_t[k].numpy(), np.asarray(params_j[k]), atol=1e-6, rtol=0)
            np.testing.assert_allclose(state_t.mu[k].numpy(), np.asarray(state_j.mu[k]), atol=1e-6, rtol=0)
            np.testing.assert_allclose(state_t.nu[k].numpy(), np.asarray(state_j.nu[k]), atol=1e-6, rtol=0)
    assert [int(state_t.count[k]) for k in ("early", "late", "never")] == [8, 3, 0]
    np.testing.assert_array_equal(params_t["never"].numpy(), p0["never"])  # untouched


def test_adam_per_leaf_with_the_train_steps_betas():
    """``betas = (0, 0.9)`` as the train step sets them: ``0 ** count`` and
    the first update ``-lr * g / (|g| + eps)``."""
    g = np.array([0.5, -2.0, 0.0, 1e-3], np.float32)
    opt_j = jax_adam_per_leaf(1e-3, b1=0.0, b2=0.9)
    upd, _ = opt_j.update({"p": jnp.asarray(g)}, opt_j.init({"p": jnp.zeros(4)}))
    opt_t = adam_per_leaf(1e-3, b1=0.0, b2=0.9)
    p = {"p": torch.zeros(4)}
    state = opt_t.init(p)
    opt_t.update({"p": torch.from_numpy(g)}, state, p)
    np.testing.assert_allclose(p["p"].numpy(), np.asarray(upd["p"]), atol=1e-9, rtol=1e-6)
    np.testing.assert_allclose(state.mu["p"].numpy(), g, atol=0, rtol=0)


@pytest.mark.parametrize("size", [4, 64, 512])
def test_grower_transform_matches_jax(size):
    """Min-max -> [-1, 1] -> bilinear resize, half-pixel centres and no
    antialiasing; 512 -> 4 is where the two resizes could part.  1e-5."""
    x = np.random.default_rng(size).standard_normal((2, 2, 512, 512)).astype(np.float32) * 3 + 1
    ref = np.asarray(jax_grower_transform(jnp.asarray(x), size))
    got = grower_transform(torch.from_numpy(x), size).numpy()
    assert got.shape == ref.shape == (2, 2, size, size)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "name", ["wasserstein_discriminator_loss", "wasserstein_generator_loss", "discriminator_loss", "generator_loss"]
)
def test_losses_match_jax(name):
    rng = np.random.default_rng(5)
    args = [rng.uniform(0.1, 0.9, (6, 1)).astype(np.float32) for _ in range(2 if "discriminator" in name else 1)]
    ref = float(getattr(jax_losses, name)(*map(jnp.asarray, args)))
    got = float(getattr(losses, name)(*map(torch.from_numpy, args)))
    assert got == pytest.approx(ref, rel=1e-6)


def test_linear_and_avg_pool_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 8, 6)).astype(np.float32)
    ref = np.asarray(jax_layers.avg_pool_2x_nchw(jnp.asarray(x)))
    np.testing.assert_allclose(layers.avg_pool_2x(torch.from_numpy(x)).numpy(), ref, atol=1e-6, rtol=0)
    xl = rng.standard_normal((3, 7)).astype(np.float32)
    p = {"w": rng.standard_normal((7, 2)).astype(np.float32), "b": rng.standard_normal(2).astype(np.float32)}
    ref = np.asarray(jax_layers.linear(jnp.asarray(xl), jax.tree_util.tree_map(jnp.asarray, p)))
    got = layers.linear(torch.from_numpy(xl), torch.from_numpy(p["w"].T.copy()), torch.from_numpy(p["b"]))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    up = layers.upsample_nearest_2x(torch.from_numpy(x))
    np.testing.assert_array_equal(up.numpy(), np.asarray(jax_layers.upsample_nearest_2x_nchw(jnp.asarray(x))))


def test_train_config_refuses_other_compute_dtypes():
    """JAX's three compute dtypes are ported; any other raises."""
    assert TrainConfig().betas == (0.0, 0.9) and TrainConfig().n_critic == 5
    for dtype in ("float32", "bfloat16", "bfloat16_f32gp"):
        assert TrainConfig(compute_dtype=dtype).compute_dtype == dtype
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        TrainConfig(compute_dtype="float16")
