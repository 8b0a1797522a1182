"""Data parallelism over a two-process ``torch.distributed`` group on the CPU
(gloo), against one process and against the JAX package's mesh step
(counterparts of ``tests/test_parallel.py``'s gradient and resident-corpus
cases and ``tests/test_multihost.py``'s training case).

Each test starts two ranks of this file (its ``__main__`` block is the
rank's entry point: ``python tests/test_torch_multihost.py MODE COORD RANK
OUT``), each with its own timeout, so a hang fails one test.  The ranks
import neither JAX nor the JAX package; the model's widths reach them as
JSON from ``tests/tiny_cfg.py``.  ``tests/test_torch_multihost_recovery.py``
drives preemption, streaming ingest, SIGTERM and resume and the CLI through
the same entry point."""

import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240  # a rank of any mode here finishes in well under a minute
DIST_TIMEOUT_S = 120  # the process group's, so a lost peer raises in a rank

# The one-process and two-process runs of the train tests: JAX's
# tests/test_multihost.py schedule (4 iterations, a save at the fourth).
TRAIN_KW = dict(batch_size=8, save_every=4, log_every=2, nb_preview=1, chunk_steps=1, seed=0)
# The resident-corpus case: tests/test_parallel.py's (35 rows, not divisible
# by the ranks, so a pad row appears; chunked steps run).
RESIDENT_KW = dict(batch_size=8, save_every=100, log_every=4, nb_preview=1, nb_epoch=50, chunk_steps=3,
                   host_pipeline=False)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tiny_cfg_json(**over) -> str:
    """TINY_MODEL's widths as the port's ModelConfig fields, for the ranks."""
    from tests.tiny_cfg import TINY_MODEL

    return json.dumps({
        "rand_channels": TINY_MODEL.rand_channels,
        "gen_channels": TINY_MODEL.gen_channels,
        "disc_channels": TINY_MODEL.disc_channels,
        **over,
    })


def port_cfg(cfg_json: str):
    from musicgan_tpu_torch.config import ModelConfig

    d = json.loads(cfg_json)
    for k in ("gen_channels", "disc_channels"):
        d[k] = tuple(tuple(c) for c in d[k])
    return ModelConfig(**d)


def launch(mode: str, out: str, *args: str, env: dict | None = None, world: int = 2):
    """Start ``world`` ranks of ``mode``; returns the Popen objects."""
    coord = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1", **(env or {})}
    return [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, coord, str(r), str(world), out, *args],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]


def finish(procs, timeout: float = RANK_TIMEOUT_S) -> list[str]:
    """Wait for every rank (killing all at the first timeout); their output."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_ranks(mode: str, out: str, *args: str, **kw) -> list[str]:
    procs = launch(mode, out, *args, **kw)
    outs = finish(procs)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"rank failed ({p.returncode}):\n{o[-4000:]}"
    return outs


def leaves(state) -> dict:
    """Every tensor of a train state by name, the random generator's state
    included."""
    out = {f"gen.{k}": v for k, v in state.gen.state_dict().items()}
    out.update({f"disc.{k}": v for k, v in state.disc.state_dict().items()})
    for name, opt in (("opt_gen", state.opt_gen), ("opt_disc", state.opt_disc)):
        for field in opt._fields:
            out.update({f"{name}.{field}.{k}": v for k, v in getattr(opt, field).items()})
    out["rng"] = state.rng.get_state()
    out["iter_idx"] = state.iter_idx
    return out


def state_hash(state) -> str:
    h = hashlib.sha256()
    for k, v in sorted(leaves(state).items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def synth_dataset(path: str, n: int = 16, seed: int = 0) -> str:
    from musicgan_tpu_torch.audio.ingest import ShardWriter

    w = ShardWriter(path, samples_per_shard=6)
    w.add(np.random.default_rng(seed).uniform(-1, 1, (n, 2, 512, 512)).astype(np.float32))
    w.close()
    return path


def load_state(path: str, cfg, tcfg):
    from musicgan_tpu_torch.train import CheckpointManager, init_train_state

    root, idx = os.path.split(path)
    state, _ = CheckpointManager(root).restore(int(idx.split("_")[1]), init_train_state(0, cfg, tcfg, device="cpu"))
    return state


def _assert_close_states(a, b, atol, rtol=0.0, skip=("rng",)):
    la, lb = leaves(a), leaves(b)
    assert set(la) == set(lb)
    for k in la:
        if k in skip:
            continue
        np.testing.assert_allclose(la[k].float().numpy(), lb[k].float().numpy(), atol=atol, rtol=rtol, err_msg=k)


# ---------------------------------------------------------------------------
# The tests.


def test_data_parallel_critic_gradients_match_one_device(tmp_path):
    """The gradient of the global mean, each rank's gradient of its local
    mean averaged by the step's one ``all_reduce``, equals the one-device
    gradient within 1e-5 (``tests/test_parallel.py::
    test_data_parallel_grads_match_single_device``: the full-width critic
    at stage 7, a batch of 8 4x4 images)."""
    from musicgan_tpu_torch.config import ModelConfig
    from musicgan_tpu_torch.models import Discriminator

    out = str(tmp_path)
    run_ranks("grads", out)
    disc = Discriminator(ModelConfig(), device="cpu", seed=1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 2, 4, 4)).astype(np.float32))
    loss = disc.forward_nchw(x, 7, 1.0, "xla").mean()
    names = [k for k, _ in disc.named_parameters()]
    single = dict(zip(names, torch.autograd.grad(loss, list(disc.parameters()), allow_unused=True)))
    for r in range(2):
        got = torch.load(os.path.join(out, f"grads_{r}.pt"), weights_only=True)
        assert set(got) == {k for k, g in single.items() if g is not None}
        for k, g in got.items():
            np.testing.assert_allclose(g.numpy(), single[k].numpy(), atol=1e-5, err_msg=k)
    a, b = (torch.load(os.path.join(out, f"grads_{r}.pt"), weights_only=True) for r in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)  # the same bits on both ranks


def _jax_noise(state, batch, cfg):
    """The draws the JAX iteration makes from ``state.rng``."""
    import jax

    _, k_z, k_eps, k_zg = jax.random.split(state.rng, 4)
    z_shape = (batch, cfg.latent_height, cfg.latent_width, cfg.rand_channels)
    return (np.array(jax.random.normal(k_z, z_shape)), np.array(jax.random.uniform(k_eps, (batch, 1, 1, 1))),
            np.array(jax.random.normal(k_zg, z_shape)))


def test_one_iteration_over_two_processes_matches_the_jax_mesh_step(tmp_path):
    """JAX's ``build_step(mesh=...)`` on a 2-device mesh and the port's step
    over 2 ranks, from one state (carried across from JAX after one JAX
    iteration, so that Adam's second moments are not zero), one global
    batch and one noise: a D+G iteration at a fade stage.  Metrics at rel
    1e-3 / abs 1e-4, parameters and Adam's moments at 1e-4, and the two
    ranks' states bit for bit equal."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from musicgan_tpu.config import TrainConfig as JaxTrainConfig
    from musicgan_tpu.train.step import build_step as jax_build_step
    from musicgan_tpu.train.step import init_train_state as jax_init_train_state
    from musicgan_tpu_torch.config import TrainConfig
    from musicgan_tpu_torch.models import train_state_from_jax
    from musicgan_tpu_torch.train import CheckpointManager
    from tests.tiny_cfg import TINY_MODEL

    stage, alpha, batch = 1, 0.5, 4
    jcfg_m = dataclasses.replace(TINY_MODEL, conv_impl="xla")
    jcfg = JaxTrainConfig(batch_size=batch, chunk_steps=1, device_dataset="off")
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("data",))
    step_j = jax_build_step(stage, True, jcfg_m, jcfg, mesh=mesh, data_axis="data", pre_scaled=True)
    size = 4 * 2**stage
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((batch, 2, size, size)).astype(np.float32) for _ in range(2)]
    state_j, _ = step_j(jax_init_train_state(jax.random.PRNGKey(7), jcfg_m, jcfg), jnp.asarray(xs[0]),
                        jnp.float32(alpha))
    state_np = jax.tree_util.tree_map(np.asarray, state_j)
    noise = _jax_noise(state_j, batch, TINY_MODEL)
    new_j, m_j = step_j(state_j, jnp.asarray(xs[1]), jnp.float32(alpha))
    new_j = jax.tree_util.tree_map(np.asarray, new_j)

    cfg_json = tiny_cfg_json(conv_impl="xla")
    tcfg = TrainConfig(batch_size=batch, chunk_steps=1)
    start = train_state_from_jax(state_np, port_cfg(cfg_json), tcfg, device="cpu")
    CheckpointManager(str(tmp_path / "ck")).save(0, start, {})
    np.savez(tmp_path / "inputs.npz", x=xs[1], z=noise[0], eps=noise[1], zg=noise[2])
    run_ranks("step", str(tmp_path), cfg_json, str(stage), str(alpha), str(batch))

    hashes = [open(tmp_path / f"hash_{r}.txt").read() for r in range(2)]
    assert hashes[0] == hashes[1]
    m_t = json.loads(open(tmp_path / "metrics.json").read())
    assert set(m_t) == set(m_j)
    for k in m_j:
        assert abs(m_t[k] - float(m_j[k])) <= 1e-4 + 1e-3 * abs(float(m_j[k])), (k, m_t[k], float(m_j[k]))
    from musicgan_tpu_torch.models import adam_state_to_jax_layout, params_to_jax_layout

    got = load_state(str(tmp_path / "after" / "save_0"), port_cfg(cfg_json), tcfg)
    pairs = [(params_to_jax_layout(got.gen.state_dict()), new_j.gen_params),
             (params_to_jax_layout(got.disc.state_dict()), new_j.disc_params),
             *((adam_state_to_jax_layout(opt)[f], getattr(ref, f))
               for opt, ref in ((got.opt_gen, new_j.opt_gen), (got.opt_disc, new_j.opt_disc))
               for f in ("mu", "nu"))]
    worst = 0.0
    for mine, theirs in pairs:
        la, lb = jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(theirs)
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            worst = max(worst, float(np.abs(np.asarray(a) - np.asarray(b)).max()))
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4, rtol=0)
    print(f"largest difference from JAX's mesh step: {worst:.3e}")


def test_two_process_training_matches_one_process_and_only_the_lead_writes(tmp_path):
    """``train()`` over two ranks (4 rows of each global batch of 8 a
    rank) against the one-process run on the same corpus and schedule: the
    saved states within 1e-4 (tests/test_multihost.py's bar; the gradients
    are summed in another order), the same metrics rows, and only the lead
    wrote the CSV, the previews and the save."""
    from musicgan_tpu_torch.config import TrainConfig
    from musicgan_tpu_torch.train import CheckpointManager, train

    ds = synth_dataset(str(tmp_path / "ds"))
    cfg_json = tiny_cfg_json()
    outs = run_ranks("train", str(tmp_path / "mh"), cfg_json, ds)
    assert "[train:mh]" in outs[0] and "[train:mh]" not in outs[1]
    assert "2 device(s)" in outs[0]
    mh = str(tmp_path / "mh")
    assert sorted(f for f in os.listdir(mh) if f.endswith(".png")) == ["magn_0_ID0.png", "phase_0_ID0.png"]
    assert CheckpointManager(os.path.join(mh, "checkpoints")).saved_indices() == [0]

    cfg, tcfg = port_cfg(cfg_json), TrainConfig(**TRAIN_KW)
    one = str(tmp_path / "one")
    train("one", ds, one, tcfg, cfg, max_iters=4, mesh=None, device="cpu")
    rows = {d: open(os.path.join(d, "metrics.csv")).read().splitlines() for d in (mh, one)}
    assert len(rows[mh]) == len(rows[one]) == 3  # a header and iterations 0 and 2
    for a, b in zip(rows[mh][1:], rows[one][1:]):
        va, vb = a.split(","), b.split(",")
        assert va[:2] == vb[:2]  # step and stage
    a = load_state(os.path.join(mh, "checkpoints", "save_0"), cfg, tcfg)
    b = load_state(os.path.join(one, "checkpoints", "save_0"), cfg, tcfg)
    assert int(a.iter_idx) == int(b.iter_idx) == 4
    _assert_close_states(a, b, atol=1e-4)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())  # the global batch's draws, in step


def test_sharded_resident_corpus_trains_as_streaming(tmp_path):
    """``device_dataset="on"`` over two ranks: each rank holds its row range
    of the 35-row corpus padded to 36 (18 rows, not the corpus), a step
    gathers the batch with one batch-sized all_reduce, and the run equals
    the streaming run over the same ranks within 2e-5
    (``tests/test_parallel.py::test_device_resident_mesh_matches_streaming``;
    4 batches an epoch, chunks of 3)."""
    from musicgan_tpu_torch.config import TrainConfig

    ds = synth_dataset(str(tmp_path / "ds"), n=35)
    cfg_json = tiny_cfg_json()
    run_ranks("resident", str(tmp_path), cfg_json, ds)
    for r in range(2):
        assert json.loads(open(tmp_path / f"resident_{r}.json").read()) == {"rows": 18, "logical": 35}
    cfg, tcfg = port_cfg(cfg_json), TrainConfig(**RESIDENT_KW)
    a = load_state(str(tmp_path / "final_off" / "save_0"), cfg, tcfg)
    b = load_state(str(tmp_path / "final_on" / "save_0"), cfg, tcfg)
    assert int(a.iter_idx) == int(b.iter_idx) == 7
    _assert_close_states(a, b, atol=2e-5, rtol=2e-5)


def test_rank_one_receives_rank_zero_autotune_winner(tmp_path):
    """"auto" in a group: the lead measures (its table, its own directory)
    and every rank runs its winner; rank 1 measures nothing and reads no
    table, for a train key and a vocoder key.  The measurement is replaced
    by one whose winner differs by rank, so that a rank that measured would
    show it."""
    outs = run_ranks("autotune", str(tmp_path))
    got = [json.loads(open(tmp_path / f"autotune_{r}.json").read()) for r in range(2)]
    assert got[0]["measured"] == 2 and got[1]["measured"] == 0
    assert got[0]["winners"] == got[1]["winners"] == ["pallas_gp", "pallas"]
    assert os.path.isfile(tmp_path / "table_0" / "conv_autotune.json")
    assert not os.path.exists(tmp_path / "table_1")
    assert "(process 0's; measured in 0.00 s)" in outs[1]


# ---------------------------------------------------------------------------
# A rank: ``python tests/test_torch_multihost.py MODE COORD RANK WORLD OUT
# [ARGS...]``.  Modes of this file and of test_torch_multihost_recovery.py.


def _rank_grads(out, rank, group):
    from musicgan_tpu_torch.config import ModelConfig
    from musicgan_tpu_torch.models import Discriminator
    from musicgan_tpu_torch.train.step import _mean_over_ranks

    disc = Discriminator(ModelConfig(), device="cpu", seed=1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 2, 4, 4)).astype(np.float32))
    mine = x[rank * 4 : (rank + 1) * 4]
    loss = disc.forward_nchw(mine, 7, 1.0, "xla").mean()
    names = [k for k, _ in disc.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(disc.parameters()), allow_unused=True)))
    grads = _mean_over_ranks(grads, group)
    torch.save({k: g for k, g in grads.items() if g is not None}, os.path.join(out, f"grads_{rank}.pt"))


def _rank_step(out, rank, group, cfg_json, stage, alpha, batch):
    from musicgan_tpu_torch.config import TrainConfig
    from musicgan_tpu_torch.train import CheckpointManager, build_step

    cfg, tcfg = port_cfg(cfg_json), TrainConfig(batch_size=int(batch), chunk_steps=1)
    state = load_state(os.path.join(out, "ck", "save_0"), cfg, tcfg)
    inp = np.load(os.path.join(out, "inputs.npz"))
    b = int(batch) // group.world
    x = torch.from_numpy(inp["x"][rank * b : (rank + 1) * b])
    noise = tuple(torch.from_numpy(inp[k]) for k in ("z", "eps", "zg"))
    step = build_step(int(stage), True, cfg, tcfg, mesh=group, data_axis="data", pre_scaled=True, device="cpu")
    state, metrics = step(state, x, float(alpha), noise=noise)
    with open(os.path.join(out, f"hash_{rank}.txt"), "w") as f:
        f.write(state_hash(state))
    if rank == 0:
        CheckpointManager(os.path.join(out, "after")).save(0, state, {})
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f)


def _rank_train(out, rank, group, cfg_json, ds):
    from musicgan_tpu_torch.config import TrainConfig
    from musicgan_tpu_torch.train import train

    train("mh", ds, out, TrainConfig(**TRAIN_KW), port_cfg(cfg_json), max_iters=4, device="cpu")


def _rank_resident(out, rank, group, cfg_json, ds):
    from musicgan_tpu_torch.config import TrainConfig
    from musicgan_tpu_torch.train import CheckpointManager, train
    from musicgan_tpu_torch.train import step as step_mod

    held = []  # the rows of the corpus this rank's steps gather from
    real = step_mod._gather_sharded

    def spy(data, idx, group):
        held.append(data.shape[0])
        return real(data, idx, group)

    step_mod._gather_sharded = spy
    cfg = port_cfg(cfg_json)
    for mode in ("off", "on"):
        tcfg = TrainConfig(device_dataset=mode, **RESIDENT_KW)
        state = train(f"dev_{mode}", ds, os.path.join(out, f"run_{mode}"), tcfg, cfg, max_iters=7, device="cpu")
        if rank == 0:
            CheckpointManager(os.path.join(out, f"final_{mode}")).save(0, state, {})
    assert held and len(set(held)) == 1, held
    with open(os.path.join(out, f"resident_{rank}.json"), "w") as f:
        json.dump({"rows": held[0], "logical": 35}, f)


def _rank_autotune(out, rank, group):
    os.environ["MUSICGAN_AUTOTUNE_DIR"] = os.path.join(out, f"table_{rank}")
    from musicgan_tpu_torch.config import ModelConfig, TrainConfig
    from musicgan_tpu_torch.ops import autotune

    measured = []

    def fake_train(cfg, train_cfg, stage, candidates, device=None):
        measured.append("train")
        best = "pallas_gp" if rank == 0 else "xla"
        return {c: (0.0 if c == best else 1.0) for c in candidates}

    def fake_istft(n_bins, t, candidates=autotune.VOCODER_IMPLS, k=48, device=None, n_fft=1024, hop=256):
        measured.append("istft")
        best = "pallas" if rank == 0 else "xla"
        return {c: (0.0 if c == best else 1.0) for c in candidates}

    autotune.measure_train_impls, autotune.measure_istft_impls = fake_train, fake_istft
    # A device that is not the CPU, so that "auto" is resolved: nothing is
    # launched on it, the measurements above being stand-ins.
    dev = torch.device("meta")
    cfg = ModelConfig(conv_impl="auto")
    w_train = autotune.resolve_conv_impl(cfg, (8, 2, 2, 32), 3, for_training=True,
                                         train_cfg=TrainConfig(batch_size=8), device=dev).conv_impl
    w_voc = autotune.resolve_istft_impl(512 * 4, device=dev)
    with open(os.path.join(out, f"autotune_{rank}.json"), "w") as f:
        json.dump({"measured": len(measured), "winners": [w_train, w_voc]}, f)


def _rank_main(argv: list[str]) -> None:
    mode, coord, rank, world, out, *args = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from musicgan_tpu_torch.parallel import mesh as pmesh

    pmesh.initialize_distributed(coord, world, rank, device="cpu", timeout_s=DIST_TIMEOUT_S)
    assert pmesh.process_count() == world and pmesh.backend() == "gloo"
    group = pmesh.process_group()
    os.makedirs(out, exist_ok=True)
    code = 0
    if mode in _MODES:
        _MODES[mode](out, rank, group, *args)
    else:  # test_torch_multihost_recovery.py's modes
        from tests.test_torch_multihost_recovery import rank_mode

        code = rank_mode(mode, out, rank, group, *args)
    pmesh.host_barrier()  # the ranks leave together
    pmesh.shutdown_distributed()
    print(f"[rank] {rank} {mode} exits {code}", flush=True)
    raise SystemExit(code)


_MODES = {"grads": _rank_grads, "step": _rank_step, "train": _rank_train, "resident": _rank_resident,
          "autotune": _rank_autotune}

if __name__ == "__main__":
    _rank_main(sys.argv[1:])
