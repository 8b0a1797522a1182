"""The port's train step as a whole against the JAX package, on the CPU:
one state carried across, the same batch and the same noise through one
iteration of both; then the port's own contracts (a chunk equals single
steps, the device-resident form, the device rule)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from musicgan_tpu.config import TrainConfig as JaxTrainConfig
from musicgan_tpu.train.step import build_step as jax_build_step
from musicgan_tpu.train.step import init_train_state as jax_init_train_state
from musicgan_tpu_torch.config import ModelConfig, TrainConfig
from musicgan_tpu_torch.models import (
    adam_state_to_jax_layout,
    params_to_jax_layout,
    train_state_from_jax,
)
from musicgan_tpu_torch.parallel import Mesh
from musicgan_tpu_torch.train import build_chunk_step, build_step, init_train_state
from tests.tiny_cfg import TINY_MODEL

CFG_G = dataclasses.replace(TINY_MODEL, conv_impl="pallas_gp")
CFG = ModelConfig(  # the kernels' path, as JAX's CFG_G
    rand_channels=TINY_MODEL.rand_channels,
    gen_channels=TINY_MODEL.gen_channels,
    disc_channels=TINY_MODEL.disc_channels,
    conv_impl="pallas_gp",
)
TCFG = TrainConfig(batch_size=2, chunk_steps=5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


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


def _assert_moments_close(got: dict, ref, what):
    """First moments leaf by leaf: with ``b1 = 0`` they ARE the gradients of
    this iteration.  Max error relative to the leaf's largest value, 1e-4;
    a leaf JAX left at zero (an inactive head) must be zero here too."""
    leaves_g, tree_g = jax.tree_util.tree_flatten(got["mu"])
    leaves_r, tree_r = jax.tree_util.tree_flatten(ref.mu)
    assert tree_g == tree_r
    for g, r in zip(leaves_g, leaves_r):
        scale = float(np.abs(r).max())
        if scale == 0.0:
            assert float(np.abs(g).max()) == 0.0, what
        else:
            assert float(np.abs(g - r).max()) / scale < 1e-4, what
    counts_g = jax.tree_util.tree_leaves(got["count"])
    counts_r = jax.tree_util.tree_leaves(ref.count)
    assert [int(c) for c in counts_g] == [int(c) for c in counts_r], what


@pytest.mark.parametrize("with_gen", [False, True])
@pytest.mark.parametrize("stage,alpha", [(0, 1.0), (2, 0.3)])
def test_one_iteration_matches_jax(stage, alpha, with_gen):
    """One D-only and one D+G iteration at stage 0 and at a fade stage,
    ``pre_scaled``, batch 2, against JAX's ``build_step`` with
    ``conv_impl="pallas_gp"``: metrics at rel 1e-3 / abs 1e-4, both
    optimizers' first moments at 1e-4, ``iter_idx`` and Adam counts exact."""
    jcfg = JaxTrainConfig(batch_size=2, chunk_steps=1, device_dataset="off")
    state_j = jax_init_train_state(jax.random.PRNGKey(7), CFG_G, jcfg)
    size = 4 * 2**stage
    x = np.random.default_rng(stage).standard_normal((2, 2, size, size)).astype(np.float32)
    noise = _jax_noise(state_j, 2)
    state_t = train_state_from_jax(_np_tree(state_j), CFG, TCFG, device="cpu")
    before = {k: v.clone() for k, v in state_t.disc.state_dict().items()}

    step_j = jax_build_step(stage, with_gen, CFG_G, jcfg, pre_scaled=True)
    new_j, m_j = step_j(state_j, jnp.asarray(x), jnp.float32(alpha))
    new_j = _np_tree(new_j)

    step_t = build_step(stage, with_gen, CFG, TCFG, pre_scaled=True)
    new_t, m_t = step_t(state_t, torch.from_numpy(x), alpha, noise=noise)

    assert set(m_t) == set(m_j)
    for k in m_j:
        assert float(m_t[k]) == pytest.approx(float(m_j[k]), rel=1e-3, abs=1e-4), k
    assert float(m_t["grad_pen"]) > 0
    assert (float(m_t["gen_loss"]) != 0.0) == with_gen
    assert int(new_t.iter_idx) == int(new_j.iter_idx) == 1
    _assert_moments_close(adam_state_to_jax_layout(new_t.opt_disc), new_j.opt_disc, "critic")
    _assert_moments_close(adam_state_to_jax_layout(new_t.opt_gen), new_j.opt_gen, "generator")

    # Parameters: active leaves moved, heads of other stages did not.  (The
    # values are not held tightly: with b1 = 0 the first update is
    # -lr * sign(g), so a near-zero gradient element may flip by 2 * lr.)
    after = new_t.disc.state_dict()
    disc_stage = len(CFG.disc_channels) - 2 - stage
    for i in range(len(CFG.disc_channels)):
        moved = not torch.equal(after[f"heads.{i}.weight"], before[f"heads.{i}.weight"])
        assert moved == (i == disc_stage or (stage > 0 and i == disc_stage + 1)), i
    p_t = params_to_jax_layout(after)
    for a, b in zip(jax.tree_util.tree_leaves(p_t), jax.tree_util.tree_leaves(new_j.disc_params)):
        assert float(np.abs(a - b).max()) <= 2.5e-3  # at most one flipped first update


def _tiny_batches(k, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(k, 2, 2, 16, 16, generator=g)


def _assert_states_equal(a, b):
    for ma, mb in ((a.gen, b.gen), (a.disc, b.disc)):
        for (ka, va), (kb, vb) in zip(ma.state_dict().items(), mb.state_dict().items()):
            assert ka == kb and torch.equal(va, vb), ka
    for sa, sb in ((a.opt_gen, b.opt_gen), (a.opt_disc, b.opt_disc)):
        for ta, tb in zip(sa, sb):
            for k in ta:
                assert torch.equal(ta[k], tb[k]), k
    assert int(a.iter_idx) == int(b.iter_idx)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())
    if a.gen_ema is not None:
        for k in a.gen_ema:
            assert torch.equal(a.gen_ema[k], b.gen_ema[k]), k


def test_a_chunk_of_five_equals_five_single_steps_exactly():
    """Noise drawn from the state's own generator, the n_critic pattern
    (one G iteration in five), EMA on, the on-device input pipeline."""
    tcfg = TrainConfig(batch_size=2, chunk_steps=5, ema_decay=0.9, drift_eps=1e-3)
    xs = _tiny_batches(5)
    alphas = np.linspace(0.1, 0.9, 5).astype(np.float32)
    gen_mask = [(i + 1) % tcfg.n_critic == 0 for i in range(5)]
    stage = 1  # 8x8: the 16x16 batches are resized down on the way in

    a = init_train_state(3, CFG, tcfg, device="cpu")
    b = a.clone()
    _assert_states_equal(a, b)
    rows = []
    for k in range(5):
        a, m = build_step(stage, gen_mask[k], CFG, tcfg)(a, xs[k], alphas[k])
        rows.append(m)
    b, stacked = build_chunk_step(stage, 5, CFG, tcfg)(b, xs, alphas, gen_mask)
    _assert_states_equal(a, b)
    assert int(b.iter_idx) == 5
    for key in rows[0]:
        assert stacked[key].shape == (5,)
        assert torch.equal(stacked[key], torch.stack([m[key] for m in rows])), key
    assert float(stacked["gen_loss"][4]) != 0.0 and not stacked["gen_loss"][:4].any()
    # The EMA moved towards the updated generator, by (1 - decay) of the way.
    fresh = init_train_state(3, CFG, tcfg, device="cpu")
    k = "blocks.0.conv1.weight"
    want = 0.9 * fresh.gen_ema[k] + 0.1 * b.gen.state_dict()[k]
    torch.testing.assert_close(b.gen_ema[k], want, atol=1e-7, rtol=0)

    with pytest.raises(ValueError, match="built for 5"):
        build_chunk_step(stage, 5, CFG, tcfg)(b, xs[:3], alphas[:3], gen_mask[:3])
    with pytest.raises(ValueError, match="pre_scaled"):
        build_step(stage, True, CFG, tcfg, pre_scaled=True, device_data=True)


def test_device_resident_form_gathers_rows_and_upcasts():
    """``device_data``: the step takes the corpus and row indices; a corpus
    kept in bfloat16 is upcast at the gather.  Same state as the streaming
    form fed the same (rounded) rows."""
    corpus = _tiny_batches(1, seed=4)[0].repeat(3, 1, 1, 1)[:5].to(torch.bfloat16)  # (5, 2, 16, 16)
    corpus[3] = corpus[3] * 0.5
    idx = [3, 1]
    a = init_train_state(1, CFG, TCFG, device="cpu")
    b = a.clone()
    a, m_a = build_step(1, True, CFG, TCFG, device_data=True)(a, corpus, idx, 0.5)
    b, m_b = build_step(1, True, CFG, TCFG)(b, corpus[idx].float(), 0.5)
    _assert_states_equal(a, b)
    assert torch.equal(m_a["disc_loss"], m_b["disc_loss"])

    c = b.clone()
    idx_stack = np.array([[0, 4], [2, 2]])
    a, _ = build_chunk_step(1, 2, CFG, TCFG, device_data=True)(a, corpus, idx_stack, [1.0, 1.0], [False, True])
    for row, do_g in zip(idx_stack, (False, True)):
        c, _ = build_step(1, do_g, CFG, TCFG)(c, corpus[row.tolist()].float(), 1.0)
    _assert_states_equal(a, c)


def test_train_entry_points_follow_the_device_rule():
    """No GPU and no ``device="cpu"``: ``init_train_state`` raises rather
    than carry on on the CPU; the steps take a process group as ``mesh``
    and refuse a mesh of devices in one process (one process a card)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(0, CFG, TCFG)
    with pytest.raises(NotImplementedError, match="one process per card"):
        build_step(0, True, CFG, TCFG, mesh=Mesh(("cpu", "cpu")))
    with pytest.raises(TypeError, match="parallel.Group"):
        build_chunk_step(0, 2, CFG, TCFG, mesh=object(), data_axis="data")
    assert build_step(0, True, CFG, TCFG) is build_step(0, True, CFG, TCFG)  # memoized


def test_init_train_state_is_seeded_and_complete():
    a, b = init_train_state(5, CFG, TCFG, device="cpu"), init_train_state(5, CFG, TCFG, device="cpu")
    _assert_states_equal(a, b)
    assert a.gen_ema is None and a.iter_idx.dtype == torch.int32
    assert set(a.opt_disc.count) == set(dict(a.disc.named_parameters()))
    assert all(int(c) == 0 for c in a.opt_gen.count.values())
    full = init_train_state(0, device="cpu")
    assert sum(p.numel() for p in full.disc.parameters()) == 1_647_089 + sum(
        3 * cin for cin, _ in ModelConfig().disc_channels[2:]
    )
