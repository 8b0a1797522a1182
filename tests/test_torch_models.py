"""The port's generator and checkpoint ingest against the JAX package, on
the CPU (where the fused-conv wrappers take their plain versions)."""

import os

import numpy as np
import pytest
import torch

import jax

from musicgan_tpu.models.generator import generator_forward, init_generator
from musicgan_tpu.models.torch_ingest import load_reference_generator as jax_load
from musicgan_tpu_torch.config import ModelConfig
from musicgan_tpu_torch.models import (
    Generator,
    generator_param_count,
    load_reference_generator,
    params_from_jax,
)
from tests.tiny_cfg import TINY_MODEL

GEN_PT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "saved_models", "quality_r4", "gen_final.pt",
)


def _torch_cfg(jax_cfg):
    """The port's ModelConfig with the same widths as a JAX one."""
    return ModelConfig(
        rand_channels=jax_cfg.rand_channels,
        gen_channels=jax_cfg.gen_channels,
        disc_channels=jax_cfg.disc_channels,
    )


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize(
    "width,stage,alpha,z_shape",
    [("tiny", 3, 0.3, (2, 2, 4, 8)), ("full", 7, 1.0, (2, 2, 2, 32))],
)
def test_generator_forward_matches_jax(width, stage, alpha, z_shape):
    """Stage 7 is held at full width: with TINY_MODEL's 4-channel last
    blocks, a random-init stage-7 forward is so ill-conditioned in float32
    that JAX's own lowerings (xla, subpixel, pallas_up) disagree with each
    other by 1.5e-3, far above this 2e-5 bar."""
    jax_cfg = TINY_MODEL if width == "tiny" else _jax_default_cfg()
    params = _np_tree(init_generator(jax.random.PRNGKey(3), jax_cfg))
    z = np.random.default_rng(stage).standard_normal(z_shape).astype(np.float32)
    ref = np.asarray(generator_forward(params, z, stage, alpha, jax_cfg))

    gen = Generator(_torch_cfg(jax_cfg))
    gen.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = gen(torch.from_numpy(z), stage, alpha).numpy()
    scale = 2 ** (stage + 1)
    assert got.shape == ref.shape == (2, 2 * scale, z_shape[2] * scale, 2)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_generator_param_count():
    cfg = ModelConfig()
    gen = Generator(cfg)
    assert generator_param_count(cfg, stage=7) == 902_132
    assert sum(p.numel() for p in gen.parameters()) == generator_param_count(cfg)
    heads_inactive = sum(
        2 * cout + 2 for _, cout in cfg.gen_channels[:6]
    )
    assert generator_param_count(cfg) == 902_132 + heads_inactive


def test_generator_init_is_seeded():
    a, b = Generator(_torch_cfg(TINY_MODEL), seed=5), Generator(_torch_cfg(TINY_MODEL), seed=5)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, atol=0, rtol=0)


def test_generator_packs_weights_once_and_again_after_a_change():
    """A block packs its conv weights for the kernels once; an in-place
    change of a weight (an optimizer step, ``load_state_dict``) repacks."""
    from musicgan_tpu_torch.ops.conv import kernel_upconv_weights, kernel_weights

    blk = Generator(_torch_cfg(TINY_MODEL)).blocks[1]
    p1 = blk._packed("conv1")
    assert blk._packed("conv1") is p1
    torch.testing.assert_close(p1, kernel_weights(blk.conv1.weight.detach()), atol=0, rtol=0)
    with torch.no_grad():
        blk.conv1.weight.mul_(2.0)
    p2 = blk._packed("conv1")
    torch.testing.assert_close(p2, 2.0 * p1, atol=0, rtol=0)
    p3 = blk._packed("conv2")
    blk.load_state_dict({k: v + 1.0 for k, v in blk.state_dict().items()})
    torch.testing.assert_close(
        blk._packed("conv2"), kernel_upconv_weights(blk.conv2.weight.detach()), atol=0, rtol=0,
    )
    assert not torch.equal(blk._packed("conv2"), p3)


def test_load_reference_generator_matches_jax_loader():
    """Every tensor the checkpoint holds lands where the JAX loader puts
    it, after HWIO -> OIHW (exact).  Heads the file does not hold keep
    each framework's own seeded init."""
    ref = _np_tree(jax_load(GEN_PT, _jax_default_cfg()))
    gen = load_reference_generator(GEN_PT, ModelConfig())
    ours = gen.state_dict()
    theirs = params_from_jax(ref)
    loaded = [k for k in theirs if k.startswith("blocks.")] + [
        f"heads.{s}.{leaf}" for s in (6, 7) for leaf in ("weight", "bias")
    ]
    assert len(loaded) == 36
    for k in loaded:
        torch.testing.assert_close(ours[k], theirs[k], atol=0, rtol=0)
    assert ours["blocks.7.conv2.weight"].shape == (16, 32, 3, 3)


def _jax_default_cfg():
    from musicgan_tpu.config import ModelConfig as JaxModelConfig

    return JaxModelConfig()
