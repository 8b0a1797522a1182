"""The library lowerings and the four training impls of the port against
the JAX package, on the CPU, at ``TINY_MODEL``: the generator forward under
``"xla"`` and ``"subpixel"``, generator and critic in bf16, one train
iteration of each of ``TRAINING_IMPLS`` and of the two bf16 compute dtypes
from a state carried over from JAX with JAX's noise, and the routing of the
penalty under ``"pallas_train"``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from musicgan_tpu.config import TrainConfig as JaxTrainConfig
from musicgan_tpu.models import (
    discriminator_forward,
    generator_forward,
    init_discriminator,
    init_generator,
)
from musicgan_tpu.train.step import build_step as jax_build_step
from musicgan_tpu.train.step import init_train_state as jax_init_train_state
from musicgan_tpu_torch.config import ModelConfig, TrainConfig
from musicgan_tpu_torch.models import (
    Discriminator,
    Generator,
    adam_state_to_jax_layout,
    disc_params_from_jax,
    params_from_jax,
    train_state_from_jax,
)
from musicgan_tpu_torch.models import layers
from musicgan_tpu_torch.ops import conv_vjp
from musicgan_tpu_torch.train import build_step, init_train_state
from tests.tiny_cfg import TINY_MODEL

CFG = ModelConfig(
    rand_channels=TINY_MODEL.rand_channels,
    gen_channels=TINY_MODEL.gen_channels,
    disc_channels=TINY_MODEL.disc_channels,
)
STAGE, ALPHA, BATCH = 1, 0.5, 2  # 8x8 images, the fade-in active
N_DISC = len(CFG.disc_channels)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _generator(seed):
    params = _np_tree(init_generator(jax.random.PRNGKey(seed), TINY_MODEL))
    gen = Generator(CFG)
    gen.load_state_dict(params_from_jax(params))
    return params, gen


@pytest.mark.parametrize("impl", ["xla", "subpixel"])
@pytest.mark.parametrize("stage,alpha", [(0, 1.0), (1, 0.5)])
def test_generator_library_lowerings_match_jax(impl, stage, alpha):
    """The float32 library lowerings against JAX's same impl at 2e-5."""
    params, gen = _generator(3)
    z = np.random.default_rng(stage).standard_normal((2, 2, 2, CFG.rand_channels)).astype(np.float32)
    want = np.asarray(generator_forward(
        params, jnp.asarray(z), stage, alpha, dataclasses.replace(TINY_MODEL, conv_impl=impl)))
    with torch.no_grad():
        got = gen.forward(torch.from_numpy(z), stage, alpha, impl=impl).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "subpixel"])
def test_bf16_forwards_match_jax(impl):
    """Generator and critic with bf16 operands (``compute_dtype``) against
    JAX's at 2e-2 (bf16 rounds every conv: the two frameworks round the same
    products in another order)."""
    params, gen = _generator(4)
    jcfg = dataclasses.replace(TINY_MODEL, conv_impl=impl)
    z = np.random.default_rng(5).standard_normal((2, 2, 2, CFG.rand_channels)).astype(np.float32)
    want = np.asarray(generator_forward(params, jnp.asarray(z), STAGE, ALPHA, jcfg, jnp.bfloat16))
    with torch.no_grad():
        got = gen.forward(torch.from_numpy(z), STAGE, ALPHA, impl=impl, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)

    dparams = _np_tree(init_discriminator(jax.random.PRNGKey(6), TINY_MODEL))
    disc = Discriminator(CFG)
    disc.load_state_dict(disc_params_from_jax(dparams))
    stage = N_DISC - 2 - STAGE
    x = np.random.default_rng(7).standard_normal((2, 8, 8, 2)).astype(np.float32)
    want = np.asarray(discriminator_forward(dparams, jnp.asarray(x), stage, ALPHA, jcfg, jnp.bfloat16))
    with torch.no_grad():
        got = disc.forward(torch.from_numpy(x), stage, ALPHA, impl=impl, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2 * float(np.abs(want).max()))


def _jax_noise(state, batch):
    """The draws the JAX iteration makes from ``state.rng``."""
    _, k_z, k_eps, k_zg = jax.random.split(state.rng, 4)
    z_shape = (batch, TINY_MODEL.latent_height, TINY_MODEL.latent_width, TINY_MODEL.rand_channels)
    return tuple(
        torch.from_numpy(np.array(a)) for a in (
            jax.random.normal(k_z, z_shape),
            jax.random.uniform(k_eps, (batch, 1, 1, 1)),
            jax.random.normal(k_zg, z_shape),
        )
    )


def _max_moment_err(got, ref) -> float:
    """First moments (with ``b1 = 0`` they ARE this iteration's gradients),
    max error relative to each leaf's largest value."""
    errs = []
    for g, r in zip(jax.tree_util.tree_leaves(got["mu"]), jax.tree_util.tree_leaves(ref.mu)):
        scale = float(np.abs(r).max())
        errs.append(float(np.abs(g).max()) if scale == 0.0 else float(np.abs(g - r).max()) / scale)
    return max(errs)


def _one_iteration(jax_impl, port_impl, compute_dtype="float32"):
    """One D+G iteration of both packages from the same JAX state, batch
    and noise: ``(metrics_port, metrics_jax, new_state_port, new_state_jax)``."""
    jcfg = JaxTrainConfig(batch_size=BATCH, chunk_steps=1, device_dataset="off", compute_dtype=compute_dtype)
    jmodel = dataclasses.replace(TINY_MODEL, conv_impl=jax_impl)
    state_j = jax_init_train_state(jax.random.PRNGKey(7), jmodel, jcfg)
    size = 4 * 2**STAGE
    x = np.random.default_rng(11).standard_normal((BATCH, 2, size, size)).astype(np.float32)
    noise = _jax_noise(state_j, BATCH)
    tcfg = TrainConfig(batch_size=BATCH, chunk_steps=1, compute_dtype=compute_dtype)
    model = dataclasses.replace(CFG, conv_impl=port_impl)
    state_t = train_state_from_jax(_np_tree(state_j), model, tcfg, device="cpu")

    new_j, m_j = jax_build_step(STAGE, True, jmodel, jcfg, pre_scaled=True)(
        state_j, jnp.asarray(x), jnp.float32(ALPHA))
    new_t, m_t = build_step(STAGE, True, model, tcfg, pre_scaled=True, device="cpu")(
        state_t, torch.from_numpy(x), ALPHA, noise=noise)
    return {k: float(v) for k, v in m_t.items()}, {k: float(v) for k, v in m_j.items()}, new_t, _np_tree(new_j)


@pytest.mark.parametrize("port_impl,jax_impl", [
    ("xla", "xla"), ("subpixel", "subpixel"), ("pallas_train", "xla"), ("pallas_gp", "xla"),
])
def test_one_iteration_of_each_training_impl_matches_jax(port_impl, jax_impl):
    """Each of ``TRAINING_IMPLS`` against JAX's step: ``xla`` and
    ``subpixel`` against the same impl, the kernel impls against JAX's
    ``"xla"`` (as ``tests/test_ops_vjp.py`` holds JAX's own kernel impls):
    metrics at rel 1e-3 / abs 1e-4, both optimizers' first moments at
    1e-4, the iteration counter exact."""
    m_t, m_j, new_t, new_j = _one_iteration(jax_impl, port_impl)
    assert set(m_t) == set(m_j)
    for k in m_j:
        assert m_t[k] == pytest.approx(m_j[k], rel=1e-3, abs=1e-4), k
    assert m_t["grad_pen"] > 0 and m_t["gen_loss"] != 0.0
    assert int(new_t.iter_idx) == int(new_j.iter_idx) == 1
    assert _max_moment_err(adam_state_to_jax_layout(new_t.opt_disc), new_j.opt_disc) < 1e-4
    assert _max_moment_err(adam_state_to_jax_layout(new_t.opt_gen), new_j.opt_gen) < 1e-4


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "bfloat16_f32gp"])
def test_one_bf16_iteration_matches_jax(compute_dtype):
    """bf16 training (library lowering "xla") against JAX's at 2e-2
    relative on the metrics; parameters and Adam's moments stay float32."""
    m_t, m_j, new_t, _ = _one_iteration("xla", "xla", compute_dtype)
    for k in m_j:
        assert m_t[k] == pytest.approx(m_j[k], rel=2e-2, abs=1e-4), k
    assert m_t["grad_pen"] >= 0 and all(np.isfinite(v) for v in m_t.values())
    for module in (new_t.gen, new_t.disc):
        assert all(p.dtype == torch.float32 for p in module.parameters())
    for moments in (new_t.opt_gen, new_t.opt_disc):
        assert all(t.dtype == torch.float32 for t in moments.mu.values())


def test_pallas_train_penalty_runs_the_library_critic(monkeypatch):
    """Under ``"pallas_train"`` the penalty's critic is the library
    lowering, never the kernels (whose gradient is differentiable once: a
    second differentiation through them would be wrong, not slow): in one
    critic-only iteration ``conv3x3_act`` runs for the generator and the
    two first-order critic forwards only, and the library conv for the
    penalty's critic.  Under ``"pallas_gp"`` the penalty adds kernel calls
    and no library conv."""
    calls = {"kernel": 0, "library": 0}
    kernel, library = conv_vjp.conv3x3_act, layers.conv2d

    def count_kernel(*a, **k):
        calls["kernel"] += 1
        return kernel(*a, **k)

    def count_library(*a, **k):
        calls["library"] += 1
        return library(*a, **k)

    monkeypatch.setattr(conv_vjp, "conv3x3_act", count_kernel)
    monkeypatch.setattr(layers, "conv2d", count_library)
    disc_stage = N_DISC - 2 - STAGE
    active = N_DISC - disc_stage  # critic blocks at this stage
    gen_convs, disc_convs = 2 * (STAGE + 1), 2 * active
    x = torch.randn(BATCH, 2, 8, 8, generator=torch.Generator().manual_seed(0))
    tcfg = TrainConfig(batch_size=BATCH)
    got = {}
    for impl in ("pallas_train", "pallas_gp"):
        model = dataclasses.replace(CFG, conv_impl=impl)
        state = init_train_state(0, model, tcfg, device="cpu")
        calls.update(kernel=0, library=0)
        build_step(STAGE, False, model, tcfg, pre_scaled=True, device="cpu")(state, x, ALPHA)
        got[impl] = dict(calls)
    # the library critic: two input heads (fade), 2 convs a block
    assert got["pallas_train"] == {"kernel": gen_convs + 2 * disc_convs, "library": disc_convs + 2}
    assert got["pallas_gp"]["library"] == 0
    assert got["pallas_gp"]["kernel"] == gen_convs + 4 * disc_convs  # + the penalty's forward and transposes
