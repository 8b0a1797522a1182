"""The port's critic, its hand-unrolled gradient-penalty input gradient and
the generator's training forward against the JAX package, on the CPU (where
``conv3x3_act`` is its plain version under ordinary autograd)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from musicgan_tpu.models import (
    discriminator_forward,
    generator_forward,
    init_discriminator,
    init_generator,
)
from musicgan_tpu.models.discriminator import (
    critic_input_grad_nchw_train as jax_critic_input_grad,
)
from musicgan_tpu_torch.config import ModelConfig
from musicgan_tpu_torch.models import (
    Discriminator,
    Generator,
    critic_input_grad_nchw_train,
    disc_params_from_jax,
    discriminator_param_count,
    params_from_jax,
    params_to_jax_layout,
)
from tests.tiny_cfg import TINY_MODEL

CFG_X = dataclasses.replace(TINY_MODEL, conv_impl="xla")
CFG_T = dataclasses.replace(TINY_MODEL, conv_impl="pallas_train")
CFG_G = dataclasses.replace(TINY_MODEL, conv_impl="pallas_gp")
CFG = ModelConfig(  # the trainable kernels' path
    rand_channels=TINY_MODEL.rand_channels,
    gen_channels=TINY_MODEL.gen_channels,
    disc_channels=TINY_MODEL.disc_channels,
    conv_impl="pallas_gp",
)
N = len(TINY_MODEL.disc_channels)
# (critic stage, input size): a fade stage and the no-fade stage.
STAGES = [(N - 4, 16), (N - 2, 4)]
ALPHA = 0.4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _relerr(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _tree_relerr(got, ref):
    return max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(_relerr, got, ref)))


def _critic(seed):
    params = init_discriminator(jax.random.PRNGKey(seed), TINY_MODEL)
    disc = Discriminator(CFG)
    disc.load_state_dict(disc_params_from_jax(_np_tree(params)))
    return params, disc


def _grad_tree(module):
    """The module's ``.grad``s in the JAX layout; zeros where there is none."""
    return params_to_jax_layout({
        k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in module.named_parameters()
    })


@pytest.mark.parametrize("stage,hw", STAGES)
def test_discriminator_forward_and_gradients_match_jax(stage, hw):
    """Score at 1e-5; parameter and input gradients of the summed score at
    1e-4 relative to each leaf's largest value."""
    params, disc = _critic(4)
    x = np.random.default_rng(stage).standard_normal((2, hw, hw, 2)).astype(np.float32)
    ref = discriminator_forward(params, x, stage, ALPHA, CFG_X)
    g_params, g_x = jax.grad(
        lambda p, xx: jnp.sum(discriminator_forward(p, xx, stage, ALPHA, CFG_X)), argnums=(0, 1)
    )(params, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    got = disc(xt, stage, ALPHA)
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    got.sum().backward()
    assert _relerr(xt.grad, g_x) < 1e-4
    assert _tree_relerr(_grad_tree(disc), _np_tree(g_params)) < 1e-4
    # Heads of other stages took no gradient at all.
    active = {stage, stage + 1} if stage < N - 2 else {stage}
    for i, head in enumerate(disc.heads):
        assert (head.weight.grad is not None) == (i in active)


def test_discriminator_param_count():
    cfg = ModelConfig()
    assert discriminator_param_count(cfg, stage=0) == 1_647_089
    disc = Discriminator(cfg)
    assert sum(p.numel() for p in disc.parameters()) == discriminator_param_count(cfg)
    inactive = sum(2 * cin + cin for cin, _ in cfg.disc_channels[2:])
    assert discriminator_param_count(cfg) == 1_647_089 + inactive
    assert disc.clf.weight.shape == (1, 160)


def test_discriminator_init_is_seeded():
    a, b, c = Discriminator(CFG, seed=5), Discriminator(CFG, seed=5), Discriminator(CFG, seed=6)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, atol=0, rtol=0)
    assert not torch.equal(a.clf.weight, c.clf.weight)
    bound = 1.0 / (18 * 9) ** 0.5  # fan_in of blocks[7].conv1
    assert float(a.blocks[7].conv1.weight.detach().abs().max()) <= bound


def test_critic_state_round_trips_through_the_jax_layout():
    params, disc = _critic(9)
    back = params_to_jax_layout(disc.state_dict())
    ref = _np_tree(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    assert disc.heads[3].weight.shape == (10, 2, 1, 1)


def _gp(g):
    gn = torch.sqrt(torch.sum(torch.square(g.reshape(g.shape[0], -1)), dim=1) + 1e-12)
    return torch.mean(torch.square(gn - 1.0))


@pytest.mark.parametrize("stage,hw", STAGES)
def test_critic_input_grad_matches_jax_and_double_backward(stage, hw):
    """The hand-unrolled input gradient against the JAX function of the
    same name and against ``autograd.grad(create_graph=True)`` through the
    port's own critic: value 1e-5 relative, gradient-penalty value 1e-5
    relative, and the outer parameter gradient of the penalty (the
    grad-of-grad the train step takes) at 1e-4."""
    params, disc = _critic(5)
    x = np.random.default_rng(10 + stage).standard_normal((2, hw, hw, 2)).astype(np.float32)

    g_jax = jax_critic_input_grad(params, jnp.asarray(x), stage, ALPHA, CFG_G)

    def gp_jax(p):
        gg = jax_critic_input_grad(p, jnp.asarray(x), stage, ALPHA, CFG_G)
        gn = jnp.sqrt(jnp.sum(jnp.square(gg.reshape(gg.shape[0], -1)), axis=1) + 1e-12)
        return jnp.mean(jnp.square(gn - 1.0))

    v_jax, d_jax = jax.value_and_grad(gp_jax)(params)

    # the port, hand-unrolled
    g_hand = critic_input_grad_nchw_train(disc, torch.from_numpy(x), stage, ALPHA)
    assert g_hand.shape == x.shape
    v_hand = _gp(g_hand)
    disc.zero_grad()
    v_hand.backward()
    d_hand = _grad_tree(disc)

    # the port, ordinary double backward through the same critic
    xt = torch.from_numpy(x).requires_grad_(True)
    (g_auto,) = torch.autograd.grad(disc(xt, stage, ALPHA).sum(), xt, create_graph=True)
    v_auto = _gp(g_auto)
    disc.zero_grad()
    v_auto.backward()
    d_auto = _grad_tree(disc)

    assert _relerr(g_hand.detach(), g_jax) < 1e-5
    assert _relerr(g_hand.detach(), g_auto.detach()) < 1e-5
    assert float(v_hand) == pytest.approx(float(v_jax), rel=1e-5)
    assert float(v_hand) == pytest.approx(float(v_auto), rel=1e-5)
    assert _tree_relerr(d_hand, _np_tree(d_jax)) < 1e-4
    assert _tree_relerr(d_hand, d_auto) < 1e-4


def test_generator_training_forward_and_gradients_match_jax():
    """The training forward (``conv3x3_act`` with PixelNorm, plain 2x
    upsample, fade head at alpha 0.5) against ``generator_forward`` with
    ``conv_impl="pallas_train"``, stage 1: value 1e-5, parameter gradients
    1e-4 relative."""
    params = init_generator(jax.random.PRNGKey(3), TINY_MODEL)
    stage, alpha = 1, 0.5
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 2, 2, TINY_MODEL.rand_channels)).astype(np.float32)
    ref = generator_forward(params, z, stage, alpha, CFG_T)
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    g_ref = jax.grad(lambda p: jnp.sum(generator_forward(p, z, stage, alpha, CFG_T) * cot))(params)

    gen = Generator(CFG)
    gen.load_state_dict(params_from_jax(_np_tree(params)))
    got = gen(torch.from_numpy(z), stage, alpha, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    (got * torch.from_numpy(cot)).sum().backward()
    assert _tree_relerr(_grad_tree(gen), _np_tree(g_ref)) < 1e-4
    assert gen.heads[0].weight.grad is not None and gen.heads[2].weight.grad is None
    # At alpha 1 the inference forward skips the fade head; the training
    # forward computes it, and both give the same image.
    with torch.no_grad():
        a = gen(torch.from_numpy(z), stage, 1.0)
        b = gen(torch.from_numpy(z), stage, 1.0, train=True)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
