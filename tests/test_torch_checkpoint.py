"""The port's checkpoint: exact round trip of the whole train state, the
EMA cases, incomplete saves, path spellings, and its sidecar against the
JAX package's."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from musicgan_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from musicgan_tpu.train.step import init_train_state as jax_init_train_state
from musicgan_tpu_torch.config import ModelConfig, TrainConfig
from musicgan_tpu_torch.train import (
    CheckpointManager,
    build_step,
    init_train_state,
    resolve_checkpoint,
)
from tests.tiny_cfg import TINY_MODEL

CFG = ModelConfig(
    rand_channels=TINY_MODEL.rand_channels,
    gen_channels=TINY_MODEL.gen_channels,
    disc_channels=TINY_MODEL.disc_channels,
)
TCFG = TrainConfig(batch_size=2)
TCFG_EMA = TrainConfig(batch_size=2, ema_decay=0.9)
META = {
    "grower": {"curr_grow": 1, "sample_idx": 40, "step_sample_idx": 4},
    "epoch": 2, "epoch_batch_pos": 3, "iter_idx": 20, "run_name": "r",
    "train_cfg": {"batch_size": 2}, "saver_counter": 20, "save_idx": 0,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast, and the
    test workers running beside this one do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def state_leaves(state) -> dict:
    """Every tensor of a train state by name, the random generator's state
    included."""
    out = {f"gen.{k}": v for k, v in state.gen.state_dict().items()}
    out.update({f"disc.{k}": v for k, v in state.disc.state_dict().items()})
    for name, opt in (("opt_gen", state.opt_gen), ("opt_disc", state.opt_disc)):
        for field in opt._fields:
            out.update({f"{name}.{field}.{k}": v for k, v in getattr(opt, field).items()})
    out["rng"] = state.rng.get_state()
    out["iter_idx"] = state.iter_idx
    if state.gen_ema is not None:
        out.update({f"gen_ema.{k}": v for k, v in state.gen_ema.items()})
    return out


def assert_states_equal(a, b):
    la, lb = state_leaves(a), state_leaves(b)
    assert set(la) == set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k


def _stepped(seed, tcfg, n=2, stage=1):
    state = init_train_state(seed, CFG, tcfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((2, 2, 512, 512)).astype(np.float32))
    for i in range(n):
        state, _ = build_step(stage, i == 0, CFG, tcfg)(state, x, 0.5)
    return state, x


def test_round_trip_is_exact_and_the_run_continues_identically(tmp_path):
    state, x = _stepped(3, TCFG_EMA)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    d = mgr.save(0, state, META)
    assert sorted(os.listdir(d)) == ["meta.json", "state.pt"]
    payload = torch.load(os.path.join(d, "state.pt"), weights_only=True)  # plain tensors only
    assert {"gen", "disc", "opt_gen", "opt_disc", "rng_state", "rng_device", "iter_idx", "gen_ema"} == set(payload)

    other = init_train_state(99, CFG, TCFG_EMA, device="cpu")
    z = torch.randn(1, 8, 2, 2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        stale = other.gen.forward_nchw(z, 2)  # fills the blocks' packed-weight caches
    restored, meta = mgr.restore(0, other)
    assert restored is other
    assert_states_equal(restored, state)
    assert int(restored.iter_idx) == 2 and int(restored.opt_disc.count["blocks.8.conv1.weight"]) == 2
    assert {k: meta[k] for k in META} == META and meta["has_ema"] is True
    with torch.no_grad():  # the in-place load is seen by the forward
        assert torch.equal(restored.gen.forward_nchw(z, 2), state.gen.forward_nchw(z, 2))
        assert not torch.equal(restored.gen.forward_nchw(z, 2), stale)
    # The same next iteration from both: the random stream continues.
    step = build_step(1, True, CFG, TCFG_EMA)
    a, m_a = step(state, x, 0.7)
    b, m_b = step(restored, x, 0.7)
    assert_states_equal(a, b)
    assert all(torch.equal(m_a[k], m_b[k]) for k in m_a)


@pytest.mark.parametrize("saved_ema,template_ema", [(False, False), (True, True), (False, True), (True, False)])
def test_restore_shapes_the_ema_by_has_ema(tmp_path, saved_ema, template_ema):
    state, _ = _stepped(1, TCFG_EMA if saved_ema else TCFG, n=1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state, META)
    got, meta = mgr.restore(4, init_train_state(5, CFG, TCFG_EMA if template_ema else TCFG, device="cpu"))
    assert meta["has_ema"] is saved_ema
    params = dict(state.gen.named_parameters())
    if saved_ema:  # an EMA-off caller still gets the EMA of an EMA-carrying save
        assert set(got.gen_ema) == set(params)
        assert all(torch.equal(got.gen_ema[k], state.gen_ema[k]) for k in params)
        assert any(not torch.equal(got.gen_ema[k], params[k]) for k in params)
    elif template_ema:  # seeded from the restored live weights, as copies
        assert all(torch.equal(got.gen_ema[k], params[k]) for k in params)
        assert all(got.gen_ema[k].data_ptr() != p.data_ptr() for k, p in got.gen.named_parameters())
    else:
        assert got.gen_ema is None


def test_incomplete_save_is_ignored_and_indices_sort_numerically(tmp_path):
    state = init_train_state(0, CFG, TCFG, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest() is None and mgr.saved_indices() == []
    for k in (9, 80):
        mgr.save(k, state, META)
    os.makedirs(tmp_path / "save_100")
    torch.save({}, tmp_path / "save_100" / "state.pt")  # state without meta: a save cut short
    os.makedirs(tmp_path / "not_a_save")
    assert mgr.saved_indices() == [9, 80] and mgr.latest() == 80
    # Writing over an index leaves it incomplete until its meta is back.
    os.remove(tmp_path / "save_80" / "meta.json")
    assert mgr.latest() == 9


@pytest.mark.parametrize("spelling", ["run", "checkpoints", "save", "run/", "save_first"])
def test_resolve_checkpoint_spellings(tmp_path, spelling):
    root = tmp_path / "run" / "checkpoints"
    mgr = CheckpointManager(str(root))
    state = init_train_state(0, CFG, TCFG, device="cpu")
    mgr.save(2, state, META)
    mgr.save(11, state, META)
    path, want = {
        "run": (tmp_path / "run", 11), "checkpoints": (root, 11), "save": (root / "save_11", 11),
        "run/": (str(tmp_path / "run") + "/", 11), "save_first": (root / "save_2", 2),
    }[spelling]
    assert resolve_checkpoint(str(path)) == (str(root), want)


def test_resolve_checkpoint_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="does not exist"):
        resolve_checkpoint(str(tmp_path / "typo"))
    assert not os.path.exists(tmp_path / "typo")
    os.makedirs(tmp_path / "empty" / "checkpoints")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        resolve_checkpoint(str(tmp_path / "empty"))


def test_meta_keys_equal_the_jax_packages(tmp_path):
    jstate = jax_init_train_state(jax.random.PRNGKey(0), TINY_MODEL)
    JaxCheckpointManager(str(tmp_path / "j")).save(0, jstate, META)
    CheckpointManager(str(tmp_path / "t")).save(0, init_train_state(0, CFG, TCFG, device="cpu"), META)
    with open(tmp_path / "j" / "save_0" / "meta.json") as f:
        jmeta = json.load(f)
    with open(tmp_path / "t" / "save_0" / "meta.json") as f:
        tmeta = json.load(f)
    assert jmeta == tmeta
    assert list(jmeta) == list(tmeta)
    # The JAX package's save is another format: recognised, not read.
    with pytest.raises(NotImplementedError, match="orbax"):
        CheckpointManager(str(tmp_path / "j")).restore(0, init_train_state(0, CFG, TCFG, device="cpu"))


def test_restore_refuses_a_state_of_another_shape_or_device_kind(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = init_train_state(0, CFG, TCFG, device="cpu")
    mgr.save(0, state, META)
    narrow = ModelConfig(
        rand_channels=8, gen_channels=CFG.gen_channels,
        disc_channels=(*CFG.disc_channels[:-1], (20, 22)),
    )
    with pytest.raises(RuntimeError, match="size mismatch"):
        mgr.restore(0, init_train_state(0, narrow, TCFG, device="cpu"))
    path = tmp_path / "save_0" / "state.pt"
    payload = torch.load(path, weights_only=True)
    payload["rng_device"] = "cuda"
    torch.save(payload, path)
    with pytest.raises(ValueError, match="cannot continue bit-exactly"):
        mgr.restore(0, init_train_state(0, CFG, TCFG, device="cpu"))
    got, _ = mgr.restore(0, init_train_state(0, CFG, TCFG, device="cpu"), load_rng=False)
    assert torch.equal(got.gen.heads[0].weight, state.gen.heads[0].weight)
