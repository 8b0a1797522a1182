"""Continuing the JAX package's run ``saved_models/quality_r5/resume_ckpt/
save_80`` (iteration 316,000, stage 7, ``ema_decay`` 0.999) in the port: the
orbax checkpoint restored by JAX on the CPU and exported with JAX's
``export_reference_save`` (the library call behind ``python -m
musicgan_tpu export --full``), then imported by the port, equals the JAX
state exactly in every weight the format carries and every Adam moment and
count; and one iteration of the port's step from that state equals one of
JAX's at the repo's bars for two lowerings of the train step."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from musicgan_tpu.config import ModelConfig as JaxModelConfig
from musicgan_tpu.config import TrainConfig as JaxTrainConfig
from musicgan_tpu.models.torch_ingest import export_reference_save
from musicgan_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from musicgan_tpu.train.step import build_step as jax_build_step
from musicgan_tpu.train.step import init_train_state as jax_init_train_state
from musicgan_tpu_torch.config import ModelConfig, TrainConfig
from musicgan_tpu_torch.models import torch_ingest
from musicgan_tpu_torch.train import build_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "saved_models", "quality_r5", "resume_ckpt")
SAVE, ITER, STAGE = 80, 316_000, 7


def _run_cfg() -> dict:
    with open(os.path.join(CKPT, f"save_{SAVE}", "meta.json")) as f:
        meta = json.load(f)
    return {k: tuple(v) if isinstance(v, list) else v for k, v in meta["train_cfg"].items()}


@pytest.fixture(scope="module")
def restored():
    """The JAX state of save_80 (numpy leaves) and the run's train config."""
    tc = _run_cfg()
    template = jax_init_train_state(jax.random.PRNGKey(0), JaxModelConfig(), JaxTrainConfig(**tc))
    state, meta = JaxCheckpointManager(CKPT).restore(SAVE, template)
    assert meta["iter_idx"] == ITER and meta["grower"]["curr_grow"] == STAGE
    return jax.tree_util.tree_map(np.asarray, state), tc


def _named(state) -> dict:
    out = {f"gen.{k}": v for k, v in state.gen.state_dict().items()}
    out.update({f"disc.{k}": v for k, v in state.disc.state_dict().items()})
    for which in ("gen", "disc"):
        for field in ("count", "mu", "nu"):
            out.update({f"opt_{which}.{field}.{k}": v
                        for k, v in getattr(getattr(state, f"opt_{which}"), field).items()})
    return out


def test_import_of_the_jax_export_is_the_jax_state(restored, tmp_path):
    state_np, tc = restored
    ref = str(tmp_path / "ref")
    export_reference_save(state_np, ref, SAVE, stage=STAGE, gen_lr=tc["gen_lr"], disc_lr=tc["disc_lr"],
                          betas=tc["betas"])
    imported, stage = torch_ingest.import_reference_run(
        ref, SAVE, str(tmp_path / "run"), train_cfg=TrainConfig(**tc), iter_idx=ITER, device="cpu")
    want = torch_ingest.train_state_from_jax(state_np, ModelConfig(), TrainConfig(**tc))
    assert stage == STAGE and int(imported.iter_idx) == int(want.iter_idx) == ITER

    # The format carries every block, the current and the previous head of
    # each network (gen heads 7, 6; critic heads 0, 1), the classifier, and
    # every moment and count; the other heads keep their fresh init.
    got, exp = _named(imported), _named(want)
    fresh = {f"gen.heads.{h}.{leaf}" for h in range(6) for leaf in ("weight", "bias")}
    fresh |= {f"disc.heads.{h}.{leaf}" for h in range(2, 9) for leaf in ("weight", "bias")}
    assert set(got) == set(exp) and fresh < set(got)
    for k in sorted(set(got) - fresh):
        assert got[k].dtype == exp[k].dtype and torch.equal(got[k], exp[k]), k
    assert int(want.opt_gen.count["blocks.7.conv2.weight"]) > 0  # the moments are the run's

    # The EMA: the run's own (0.999) cannot ride the reference format; the
    # import starts it as a copy of the generator's weights.
    for k, v in imported.gen.named_parameters():
        assert torch.equal(imported.gen_ema[k], v), k
    assert not all(torch.equal(want.gen_ema[k], v) for k, v in want.gen.named_parameters())


def test_one_iteration_from_save_80_matches_jax(restored):
    """One D+G iteration from save_80's state with the run's train config
    (drift 1e-3, EMA 0.999, its learning rates) at stage 2, batch 2, in both
    packages: metrics at rel 1e-3 / abs 1e-4, every first moment at 1e-4 of
    its leaf's largest value, counts and ``iter_idx`` exact, the EMA within
    its update's size.  Stage 2 (16x16): a full-width step at stage 7 is not
    run on the CPU; the state is the whole of save_80."""
    state_np, tc = restored
    stage, alpha, batch = 2, 0.6, 2
    jcfg = JaxTrainConfig(**{**tc, "batch_size": batch, "chunk_steps": 1, "device_dataset": "off"})
    cfg_j = dataclasses.replace(JaxModelConfig(), conv_impl="pallas_gp")
    state_j = jax.tree_util.tree_map(jnp.asarray, state_np)
    size = 4 * 2**stage
    x = np.random.default_rng(5).standard_normal((batch, 2, size, size)).astype(np.float32)
    _, k_z, k_eps, k_zg = jax.random.split(state_j.rng, 4)
    z_shape = (batch, cfg_j.latent_height, cfg_j.latent_width, cfg_j.rand_channels)
    noise = tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.normal(k_z, z_shape), jax.random.uniform(k_eps, (batch, 1, 1, 1)),
        jax.random.normal(k_zg, z_shape)))

    new_j, m_j = jax_build_step(stage, True, cfg_j, jcfg, pre_scaled=True)(state_j, jnp.asarray(x), jnp.float32(alpha))
    new_j = jax.tree_util.tree_map(np.asarray, new_j)
    tcfg = TrainConfig(**{**tc, "batch_size": batch, "chunk_steps": 1})
    cfg_t = ModelConfig(conv_impl="pallas_gp")
    state_t = torch_ingest.train_state_from_jax(state_np, cfg_t, tcfg)
    new_t, m_t = build_step(stage, True, cfg_t, tcfg, pre_scaled=True)(
        state_t, torch.from_numpy(x), alpha, noise=noise)

    assert set(m_t) == set(m_j)
    for k in m_j:
        assert float(m_t[k]) == pytest.approx(float(m_j[k]), rel=1e-3, abs=1e-4), k
    assert int(new_t.iter_idx) == int(new_j.iter_idx) == ITER + 1
    for which in ("gen", "disc"):
        got = torch_ingest.adam_state_to_jax_layout(getattr(new_t, f"opt_{which}"))
        ref = getattr(new_j, f"opt_{which}")
        assert ([int(c) for c in jax.tree_util.tree_leaves(got["count"])]
                == [int(c) for c in jax.tree_util.tree_leaves(ref.count)]), which
        for g, r in zip(jax.tree_util.tree_leaves(got["mu"]), jax.tree_util.tree_leaves(ref.mu)):
            scale = float(np.abs(r).max())
            assert float(np.abs(g - r).max()) <= 1e-4 * scale, which
    ema_t = torch_ingest.params_to_jax_layout(new_t.gen_ema)
    for g, r in zip(jax.tree_util.tree_leaves(ema_t), jax.tree_util.tree_leaves(new_j.gen_ema)):
        # (1 - 0.999) x at most one flipped first-step update (2 lr)
        assert float(np.abs(g - r).max()) <= 1e-3 * 2 * tc["gen_lr"] + 1e-7
