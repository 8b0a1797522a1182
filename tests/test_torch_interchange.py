"""Run interchange of the port (``models/torch_ingest.py``: ``export`` and
``import`` of the reference Saver's four files) against the JAX package's,
carried over by ``train_state_from_jax``, at tiny widths; the CLI's
``export --full`` -> ``import`` -> ``train --resume`` chain at full width on
the CPU; and the reference's own Adam reading the files with
``weights_only=True``."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from chip_smoke import reference_to_port_name, reference_training_objects
from musicgan_tpu.config import ModelConfig as JaxModelConfig
from musicgan_tpu.models import torch_ingest as jax_ingest
from musicgan_tpu.train.step import init_train_state as jax_init_train_state
from musicgan_tpu_torch.__main__ import main
from musicgan_tpu_torch.audio.ingest import ShardWriter
from musicgan_tpu_torch.config import ModelConfig, TrainConfig
from musicgan_tpu_torch.models import torch_ingest
from musicgan_tpu_torch.train import CheckpointManager, init_train_state

# Tiny widths, unique where the loaders infer a stage from a head's width
# (the generator's outputs, the critic's inputs).
GEN = ((8, 16), (16, 14), (14, 12), (12, 10), (10, 9), (9, 8), (8, 7), (7, 6))
DISC = ((6, 8), (8, 10), (10, 12), (12, 14), (14, 16), (16, 18), (18, 20), (20, 22), (22, 24))
JCFG = JaxModelConfig(rand_channels=8, gen_channels=GEN, disc_channels=DISC)
PCFG = ModelConfig(rand_channels=8, gen_channels=GEN, disc_channels=DISC)
FILES = ("gen", "disc", "optim_gen", "optim_disc")
# The keys of a save of the port's train loop (loop.py ``meta_dict``, the
# Saver's two, the manager's ``has_ema``), and an import's two.
LOOP_META = {"grower", "epoch", "epoch_batch_pos", "iter_idx", "run_name", "train_cfg", "saver_counter",
             "save_idx", "has_ema"}


def _fabricated_jax_state(seed: int):
    """A JAX train state (numpy leaves) with seeded moments and per-leaf
    counts, about a third of them 0 (no state entry in torch's format)."""
    rng = np.random.default_rng(seed)
    st = jax.tree_util.tree_map(np.asarray, jax_init_train_state(jax.random.PRNGKey(seed), JCFG))

    def adam(opt):
        return type(opt)(
            count=jax.tree_util.tree_map(lambda c: np.asarray(rng.integers(0, 3) * rng.integers(1, 500), np.int32),
                                         opt.count),
            mu=jax.tree_util.tree_map(lambda m: rng.standard_normal(m.shape).astype(np.float32), opt.mu),
            nu=jax.tree_util.tree_map(lambda m: np.abs(rng.standard_normal(m.shape)).astype(np.float32), opt.nu),
        )

    return st._replace(opt_gen=adam(st.opt_gen), opt_disc=adam(st.opt_disc))


def _load(d, name, idx):
    return torch.load(os.path.join(d, f"{name}_{idx}.pt"), map_location="cpu", weights_only=True)


def _same_save(a, b, idx):
    for name in FILES:
        x, y = _load(a, name, idx), _load(b, name, idx)
        if name.startswith("optim"):
            assert x["param_groups"] == y["param_groups"]
            x, y = x["state"], y["state"]
            assert sorted(x) == sorted(y)
            for k in x:
                assert sorted(x[k]) == ["exp_avg", "exp_avg_sq", "step"]
                for f in x[k]:
                    assert x[k][f].dtype == y[k][f].dtype and torch.equal(x[k][f], y[k][f]), (name, k, f)
        else:
            assert list(x) == list(y)
            for k in x:
                assert torch.equal(x[k], y[k]), (name, k)


@pytest.mark.parametrize("stage", [3, 7])
def test_export_equals_jax_export(tmp_path, stage):
    jst = _fabricated_jax_state(stage)
    state = torch_ingest.train_state_from_jax(jst, PCFG, TrainConfig())
    ours = torch_ingest.export_reference_save(state, str(tmp_path / "ours"), 5, stage=stage, cfg=PCFG,
                                              gen_lr=5e-4, disc_lr=2e-4, betas=(0.0, 0.99))
    jax_ingest.export_reference_save(jst, str(tmp_path / "theirs"), 5, stage=stage, cfg=JCFG,
                                     gen_lr=5e-4, disc_lr=2e-4, betas=(0.0, 0.99))
    assert [os.path.basename(p) for p in ours] == [f"{n}_5.pt" for n in FILES]
    _same_save(str(tmp_path / "ours"), str(tmp_path / "theirs"), 5)
    assert len(_load(str(tmp_path / "ours"), "optim_gen", 5)["param_groups"]) == stage + 1


def _leaves(state):
    out = {f"gen.{k}": v for k, v in state.gen.state_dict().items()}
    out.update({f"disc.{k}": v for k, v in state.disc.state_dict().items()})
    for which in ("gen", "disc"):
        opt = getattr(state, f"opt_{which}")
        for field in ("count", "mu", "nu"):
            out.update({f"opt_{which}.{field}.{k}": v for k, v in getattr(opt, field).items()})
    out["iter_idx"] = state.iter_idx
    return out


def _fresh_heads(stage: int, cfg) -> set:
    """The heads the format does not carry (all but the current and the
    previous one of each network): fresh init on each side."""
    layer = len(cfg.disc_channels) - 2 - stage
    gen = {f"gen.heads.{h}.{leaf}" for h in range(cfg.n_stages) if h not in (stage, stage - 1)
           for leaf in ("weight", "bias")}
    disc = {f"disc.heads.{h}.{leaf}" for h in range(len(cfg.disc_channels)) if h not in (layer, layer + 1)
            for leaf in ("weight", "bias")}
    return gen | disc


def test_import_equals_jax_import(tmp_path):
    stage = 5
    ref = str(tmp_path / "ref")
    jax_ingest.export_reference_save(_fabricated_jax_state(11), ref, 3, stage=stage, cfg=JCFG)
    jstate, jstage = jax_ingest.import_reference_run(ref, 3, str(tmp_path / "jax_run"), model_cfg=JCFG)
    ours, pstage = torch_ingest.import_reference_run(ref, 3, str(tmp_path / "run"), model_cfg=PCFG,
                                                     device="cpu")
    assert pstage == jstage == stage
    want = _leaves(torch_ingest.train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), PCFG))
    got = _leaves(ours)
    skip = _fresh_heads(stage, PCFG)
    assert skip and set(got) == set(want)
    for k in sorted(set(got) - skip):
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert int(ours.iter_idx) == 3000 and ours.gen_ema is None
    # the critic loader alone, against JAX's
    disc = torch_ingest.load_reference_discriminator(os.path.join(ref, "disc_3.pt"), PCFG).state_dict()
    jdisc = jax_ingest.load_reference_discriminator(os.path.join(ref, "disc_3.pt"), JCFG)
    for k, v in torch_ingest.disc_params_from_jax(jax.tree_util.tree_map(np.asarray, jdisc)).items():
        assert f"disc.{k}" in skip or torch.equal(disc[k], v), k

    # on disk: the port's checkpoint, with the loop's keys and the import's
    mgr = CheckpointManager(str(tmp_path / "run" / "checkpoints"))
    assert mgr.saved_indices() == [0]
    back, meta = mgr.restore(0, init_train_state(7, PCFG, device="cpu"))
    for k, v in _leaves(back).items():
        assert torch.equal(v, got[k]), k
    assert set(meta) == LOOP_META | {"imported_from", "imported_save_idx"}
    with open(tmp_path / "jax_run" / "checkpoints" / "save_0" / "meta.json") as f:
        jmeta = json.load(f)
    assert meta["grower"] == jmeta["grower"] and meta["iter_idx"] == jmeta["iter_idx"] == 3000
    assert meta["imported_save_idx"] == 3 and meta["imported_from"] == os.path.abspath(ref)


def test_reference_adam_files_load_with_weights_only(tmp_path):
    """Adam state_dicts the reference's own objects write (after real
    steps, so every entry is torch's) load with ``weights_only=True``, into
    the port as into JAX, and each moment lands on its parameter."""
    stage = 2
    g = torch.Generator().manual_seed(0)
    with torch.random.fork_rng():  # the modules' init draws from the global generator
        gen, disc, opt_g, opt_d = reference_training_objects(PCFG, stage, 1e-3, 1e-3, (0.0, 0.9))
    for module, opt in ((gen, opt_g), (disc, opt_d)):
        live = [p for name, p in module.named_parameters() if "gen_blocks.7" not in name]
        for _ in range(2):
            opt.zero_grad()
            sum((p * torch.randn(p.shape, generator=g)).sum() for p in live).backward()
            opt.step()
    for name, obj in (("optim_gen", opt_g), ("optim_disc", opt_d), ("gen", gen), ("disc", disc)):
        torch.save(obj.state_dict(), str(tmp_path / f"{name}_1.pt"))
    torch.load(str(tmp_path / "optim_gen_1.pt"), weights_only=True)  # no pickled class of its own

    port = init_train_state(0, PCFG, device="cpu")
    for which, module, opt in (("gen", gen, opt_g), ("disc", disc, opt_d)):
        mine, got_stage = torch_ingest.load_reference_adam(
            str(tmp_path / f"optim_{which}_1.pt"), which, getattr(port, f"opt_{which}"), cfg=PCFG)
        assert got_stage == stage
        template = getattr(jax_init_train_state(jax.random.PRNGKey(0), JCFG), f"opt_{which}")
        theirs, _ = jax_ingest.load_reference_adam(str(tmp_path / f"optim_{which}_1.pt"), which, template,
                                                   cfg=JCFG)
        theirs = torch_ingest.adam_state_from_jax(jax.tree_util.tree_map(np.asarray, theirs))
        for field in ("count", "mu", "nu"):
            for k in getattr(mine, field):
                assert torch.equal(getattr(mine, field)[k], getattr(theirs, field)[k]), (which, field, k)
        n_entries = 0
        for name, p in module.named_parameters():
            k = reference_to_port_name(name, stage, PCFG)
            st = opt.state.get(p)
            if not st:
                assert int(mine.count[k]) == 0, name
                continue
            n_entries += 1
            assert int(mine.count[k]) == int(st["step"]) == 2
            assert torch.equal(mine.mu[k], st["exp_avg"]) and torch.equal(mine.nu[k], st["exp_avg_sq"])
        assert n_entries > 10


def test_cli_export_import_resume_round_trip(tmp_path, capsys):
    """At full width on the CPU: a port run saved at stage 2 -> ``export
    --full`` -> ``import`` equals it bit for bit in every weight the format
    carries and every moment and count -> ``train --resume`` runs one
    iteration from the imported state."""
    cfg, stage = ModelConfig(), 2
    state = init_train_state(0, cfg, device="cpu")
    rng = torch.Generator().manual_seed(3)
    with torch.no_grad():
        state.iter_idx.fill_(40)
        # moments on the leaves the reference's optimizers hold at the
        # stage; the rest (heads not grown yet) never stepped, as in a run
        for which, opt in (("gen", state.opt_gen), ("disc", state.opt_disc)):
            for k in torch_ingest._param_order(which, stage, cfg)[0]:
                opt.count[k].fill_(int(torch.randint(1, 40, (), generator=rng)))
                opt.mu[k].normal_(generator=rng)
                opt.nu[k].uniform_(0, 1, generator=rng)
    grower = {"curr_grow": stage, "sample_idx": 160_000, "step_sample_idx": 10_000}
    CheckpointManager(str(tmp_path / "run0" / "checkpoints")).save(0, state, {
        "grower": grower, "epoch": 0, "epoch_batch_pos": 0, "iter_idx": 40, "run_name": "r0",
        "train_cfg": {"gen_lr": 5e-4, "disc_lr": 1e-3, "betas": [0.0, 0.99]}, "saver_counter": 40, "save_idx": 0,
    })
    ref, run1 = str(tmp_path / "ref"), str(tmp_path / "run1")
    main(["export", str(tmp_path / "run0"), "-o", ref, "--full", "--device", "cpu"])
    assert capsys.readouterr().out.startswith(f"exporting save_0 at stage {stage}")
    groups = _load(ref, "optim_gen", 0)["param_groups"]
    assert [(g["lr"], tuple(g["betas"])) for g in groups] == [(5e-4, (0.0, 0.99))] * (stage + 1)
    main(["import", ref, "0", "-o", run1, "--iter", "40", "--device", "cpu"])
    assert f"(stage {stage})" in capsys.readouterr().out

    imp, meta = CheckpointManager(os.path.join(run1, "checkpoints")).restore(
        0, init_train_state(5, cfg, device="cpu"))
    got, want = _leaves(imp), _leaves(state)
    skip = _fresh_heads(stage, cfg)
    for k in sorted(set(want) - skip):
        assert torch.equal(got[k], want[k]), k
    assert meta["grower"]["curr_grow"] == stage

    ds = str(tmp_path / "ds")
    writer = ShardWriter(ds, samples_per_shard=4)
    writer.add(np.random.default_rng(0).uniform(-1, 1, (4, 2, 512, 512)).astype(np.float32))
    writer.close()
    main(["train", "r1", "-i", ds, "-o", run1, "--resume", "--max-iters", "41", "--batch-size", "2",
          "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[resume] save_0: iter=40 stage={stage}" in out and "stopped at iter 41" in out

    # single-file export of the same run: the reference generator format
    main(["export", run1, "-o", str(tmp_path / "gen.pt"), "--stage", str(stage), "--device", "cpu"])
    sd = torch.load(str(tmp_path / "gen.pt"), weights_only=True)
    assert torch.equal(sd["_Generator__end_block.0.weight"], imp.gen.heads[stage].weight)
