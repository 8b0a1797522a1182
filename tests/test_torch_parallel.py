"""The port's parallelism layer in one process, on the CPU
(``musicgan_tpu_torch/parallel``; counterparts of ``tests/test_parallel.py``'s
long-clip cases): the time-sharded synthesis against JAX's on conftest's
eight virtual devices and against the unsharded path, the mesh and
sharding helpers, a one-rank process group's step against the plain step,
and the watchdog's torch.distributed markers.  The two-process cases are
``tests/test_torch_multihost*.py``."""

import dataclasses
import socket

import numpy as np
import pytest
import torch

import jax

from musicgan_tpu.config import ModelConfig as JaxModelConfig
from musicgan_tpu.generate import synthesize_fn as jax_synthesize_fn
from musicgan_tpu.models import init_generator
from musicgan_tpu.parallel import make_mesh as jax_make_mesh
from musicgan_tpu.parallel.longclip import sharded_synthesize_fn as jax_sharded_synthesize_fn
from musicgan_tpu_torch.config import ModelConfig, TrainConfig
from musicgan_tpu_torch.generate import synthesize_fn
from musicgan_tpu_torch.models import Generator, params_from_jax
from musicgan_tpu_torch.parallel import (
    Group,
    Mesh,
    data_sharding,
    initialize_distributed,
    make_mesh,
    replicated_sharding,
)
from musicgan_tpu_torch.parallel import mesh as pmesh
from musicgan_tpu_torch.parallel.longclip import join_pieces, latent_halo, sharded_synthesize_fn
from musicgan_tpu_torch.utils import watchdog
from tests.tiny_cfg import TINY_MODEL

CFG = ModelConfig(conv_impl="pallas_up")  # the kernels' plain versions on the CPU
TINY = ModelConfig(rand_channels=TINY_MODEL.rand_channels, gen_channels=TINY_MODEL.gen_channels,
                   disc_channels=TINY_MODEL.disc_channels, conv_impl="pallas_up")
# JAX's own bar between its sharded and unsharded synthesis
# (tests/test_parallel.py), held here between the port's sharded synthesis
# and JAX's.
TOL_JAX = 5e-4
# The port's sharded synthesis against its unsharded path: the same convs
# on other widths (their sums in another order), and the phase prefix sum
# split at the shards, a few float32 ulps of its largest value.
TOL_UNSHARDED = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _generator(model_cfg: JaxModelConfig, cfg: ModelConfig, seed: int = 0):
    """JAX's ``init_generator(PRNGKey(seed))`` weights in both packages."""
    params = jax.tree_util.tree_map(np.asarray, init_generator(jax.random.PRNGKey(seed), model_cfg))
    gen = Generator(cfg, device="cpu")
    gen.load_state_dict(params_from_jax(params))
    return params, gen


@pytest.fixture(scope="module")
def full():
    return _generator(JaxModelConfig(), CFG)


@pytest.fixture(scope="module")
def tiny():
    return _generator(TINY_MODEL, TINY)


def _latent(cfg, nb_vec: int, seed: int) -> np.ndarray:
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (1, 2, 2 * nb_vec, cfg.rand_channels)))


def test_longclip_sharded_matches_jax_on_8_shards(full):
    """``tests/test_parallel.py``'s case: the full-width generator from JAX's
    ``init_generator(PRNGKey(0))``, nb_vec 8 (2 latent columns a shard, fewer
    than the 3-column halo) at stage 7 over 8 shards, against JAX's
    ``sharded_synthesize_fn`` on conftest's 8-device mesh; the output comes
    in 8 pieces, one a shard, in time order."""
    params, gen = full
    z = _latent(CFG, 8, 3)
    jax_mesh = jax_make_mesh()
    assert jax_mesh is not None and jax_mesh.size == 8
    ref = np.asarray(jax_sharded_synthesize_fn(jax_mesh, JaxModelConfig(), 7)(params, z))
    mesh = Mesh(("cpu",) * 8)
    pieces = sharded_synthesize_fn(mesh, CFG, 7)(gen, z)
    assert len(pieces) == mesh.size and all(p.device == d for p, d in zip(pieces, mesh.devices))
    hop, frames = 256, 2 * 2**8  # each shard's own frames
    assert [p.shape[0] for p in pieces] == [frames * hop] * 7 + [(frames - 1) * hop]
    out = join_pieces(pieces).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL_JAX)
    unsharded = synthesize_fn(CFG, 7)(gen, z)[0].numpy()
    np.testing.assert_allclose(out, unsharded, atol=TOL_UNSHARDED)


@pytest.mark.parametrize("shards,stage,nb_vec", [
    (2, 7, 4),   # 4 columns a shard, wider than the halo
    (8, 7, 4),   # 1 column a shard: shards far narrower than the halo
    (4, 3, 4),   # a partial stage: nearest-upsampled to 512 bins first
    (8, 0, 8),   # stage 0, one block and the widest upsampling
])
def test_longclip_sharded_cases_match_unsharded(tiny, shards, stage, nb_vec):
    """TINY_MODEL's widths at 2 and 8 shards, partial stages and shards
    narrower than the halo: equal to the port's unsharded synthesis and,
    at the partial stages where TINY_MODEL is well conditioned, to JAX's."""
    params, gen = tiny
    z = _latent(TINY, nb_vec, 11 + shards + stage)
    out = join_pieces(sharded_synthesize_fn(Mesh(("cpu",) * shards), TINY, stage)(gen, z)).numpy()
    unsharded = synthesize_fn(TINY, stage)(gen, z)[0].numpy()
    assert out.shape == unsharded.shape == ((512 * nb_vec - 1) * 256,)
    np.testing.assert_allclose(out, unsharded, atol=TOL_UNSHARDED)
    if stage < 7:  # TINY_MODEL at stage 7 is ill-conditioned in float32 (ROADMAP.md C)
        ref = np.asarray(jax_synthesize_fn(TINY_MODEL, stage)(params, z))[0]
        np.testing.assert_allclose(out, ref, atol=TOL_JAX)


@pytest.fixture(scope="module")
def full_auto(full):
    """``full``'s weights under the default ``conv_impl="auto"``."""
    params, gen = full
    return params, gen, ModelConfig()


@pytest.mark.parametrize("shards", [2, 4])
def test_longclip_auto_matches_jax_auto_and_unsharded(full_auto, shards):
    """The default "auto" clip on 2 and 4 shards against JAX's
    ``sharded_synthesize_fn`` under its own "auto" (float32 throughout) on
    the same latent and weights, and against the port's unsharded float32
    synthesis."""
    params, gen, cfg = full_auto
    z = _latent(cfg, 4, 21 + shards)
    jax_mesh = jax_make_mesh(jax.devices()[:shards])
    ref = np.asarray(jax_sharded_synthesize_fn(jax_mesh, JaxModelConfig(), 7)(params, z))
    out = join_pieces(sharded_synthesize_fn(Mesh(("cpu",) * shards), cfg, 7)(gen, z)).numpy()
    assert out.shape == ref.shape

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(out, ref) < TOL_JAX
    unsharded = synthesize_fn(dataclasses.replace(cfg, conv_impl="xla"), 7)(gen, z)[0].numpy()
    assert rel(out, unsharded) < TOL_JAX


def test_longclip_auto_runs_one_float32_impl_on_every_shard(tiny, monkeypatch):
    """"auto" resolves once a clip among the float32 candidates, under the
    widest shard's latent: with a table (as on a card) whose six-candidate
    winners are bf16 for the inner shards' latents and float32 for the
    edges', every shard still runs the float32 table's one winner."""
    from musicgan_tpu_torch.models import generator as gmod
    from musicgan_tpu_torch.ops import autotune

    _, gen = tiny
    cfg = dataclasses.replace(TINY, conv_impl="auto")
    stage, shards, nb_vec = 3, 4, 4  # 2 columns a shard: widened to 5, 7, 7, 5
    z = _latent(cfg, nb_vec, 31)
    backend = "cuda:stub"
    table = {}
    for width, impl in ((5, "pallas_up"), (7, "pallas_up_bf16")):
        shape = (1, 2, width, cfg.rand_channels)
        table[autotune._candidates_and_key(backend, shape, stage, False, None)[1]] = impl
    widest = (1, 2, 7, cfg.rand_channels)
    f32_key = autotune._candidates_and_key(backend, widest, stage, False, None, autotune.FLOAT32_IMPLS)[1]
    table[f32_key] = "subpixel"
    monkeypatch.setattr(autotune, "_CACHE", table)
    monkeypatch.setattr(autotune, "_device", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(autotune, "_backend", lambda device: backend)
    monkeypatch.setattr(autotune, "_capturing", lambda device: False)
    monkeypatch.setattr(autotune, "resolve_istft_impl", lambda t, **kw: "xla")
    seen = []
    forward = gmod.Generator.forward_nchw

    def spy(self, x, stage, alpha=1.0, impl=None, **kw):
        seen.append(impl)
        return forward(self, x, stage, alpha, impl, **kw)

    monkeypatch.setattr(gmod.Generator, "forward_nchw", spy)
    out = join_pieces(sharded_synthesize_fn(Mesh(("cpu",) * shards), cfg, stage)(gen, z)).numpy()
    assert seen == ["subpixel"] * shards
    assert set(autotune.FLOAT32_IMPLS) == {"xla", "subpixel", "pallas", "pallas_up"}
    unsharded = synthesize_fn(dataclasses.replace(cfg, conv_impl="subpixel"), stage)(gen, z)[0].numpy()
    np.testing.assert_allclose(out, unsharded, atol=TOL_UNSHARDED)


def test_latent_halo_is_what_a_shard_needs(tiny):
    """The halo is the receptive field: 3 latent columns at stages 1-7 (2 at
    stage 0).  With it a shard's own image columns are the unsharded
    image's; one column less and they are not."""
    assert [latent_halo(s) for s in range(8)] == [2, 3, 3, 3, 3, 3, 3, 3]
    _, gen = tiny
    stage, px = 7, 2**8
    z = torch.from_numpy(_latent(TINY, 6, 5)).permute(0, 3, 1, 2)  # 12 columns
    with torch.no_grad():
        whole = gen.forward_nchw(z, stage, 1.0, "pallas_up")
        lo, hi = 5, 7
        for halo, exact in ((latent_halo(stage), True), (latent_halo(stage) - 1, False)):
            part = gen.forward_nchw(z[..., lo - halo : hi + halo], stage, 1.0, "pallas_up")
            own = part[..., halo * px : (halo + hi - lo) * px]
            assert bool(torch.allclose(own, whole[..., lo * px : hi * px], atol=1e-5)) is exact, halo


def test_mesh_and_shardings():
    """``Mesh`` is hashable and takes repeated devices; ``make_mesh`` gives
    none for one device (as JAX's); ``data_sharding`` pads to the shard
    count as JAX's ``as_array(pad_rows=...)``."""
    m = Mesh(["cpu", torch.device("cpu")])
    assert m.size == 2 and m.devices == (torch.device("cpu"),) * 2 and m.axis == "data"
    assert hash(m) == hash(Mesh(("cpu", "cpu"))) and m == Mesh(("cpu", "cpu"))
    assert make_mesh(["cpu"]) is None and make_mesh([]) is None
    assert make_mesh(["cpu"] * 3, axis="time") == Mesh(("cpu",) * 3, "time")
    with pytest.raises(ValueError):
        Mesh(())
    assert data_sharding(Group(2, 0), 35) == [slice(0, 18), slice(18, 36)]
    assert data_sharding(Mesh(("cpu",) * 8), 24) == [slice(3 * k, 3 * k + 3) for k in range(8)]
    assert pmesh.pad_rows(35, 2) == 1 and pmesh.pad_rows(24, 8) == 0 and pmesh.pad_rows(35, 8) == 5
    assert replicated_sharding(Group(4, 1), 10) == [slice(0, 10)] * 4
    assert Group(2, 1).size == 2 and hash(Group(2, 1)) == hash(Group(2, 1))
    # one process: no group, and the host agreements are the identity
    assert pmesh.process_count() == 1 and pmesh.process_index() == 0 and pmesh.process_group() is None
    assert pmesh.host_allgather(7) == [7] and pmesh.host_broadcast("x") == "x"
    initialize_distributed()  # no cluster given: a no-op, as JAX's
    with pytest.raises(ValueError, match="--process-id"):
        initialize_distributed("127.0.0.1:1", 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_one_rank_group_step_equals_the_plain_step():
    """A process group of one (the card's one-rank NCCL case, here gloo):
    the step's collectives run and change nothing, so the D+G iteration and
    a chunk over a one-rank resident corpus equal the step without a group
    bit for bit."""
    from musicgan_tpu_torch.train import build_chunk_step, build_step, init_train_state

    cfg = dataclasses.replace(TINY, conv_impl="pallas_gp")
    tcfg = TrainConfig(batch_size=2, chunk_steps=2)
    x = torch.randn(2, 2, 8, 8, generator=torch.Generator().manual_seed(0))
    data = torch.randn(5, 2, 512, 512, generator=torch.Generator().manual_seed(1))
    idx = np.array([[3, 0], [4, 1]])
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu", timeout_s=60)
    try:
        assert pmesh.backend() == "gloo" and pmesh.process_group() is None  # one rank: no data parallelism
        runs = []
        for group in (None, Group(1, 0)):
            a = init_train_state(3, cfg, tcfg, device="cpu")
            a, m = build_step(1, True, cfg, tcfg, mesh=group, pre_scaled=True, device="cpu")(a, x, 0.5)
            b = init_train_state(3, cfg, tcfg, device="cpu")
            b, mc = build_chunk_step(0, 2, cfg, tcfg, mesh=group, device_data=True, device="cpu")(
                b, data, idx, [1.0, 1.0], [True, False])
            runs.append((a, m, b, mc))
    finally:
        pmesh.shutdown_distributed()
    assert pmesh.process_count() == 1
    (a0, m0, b0, mc0), (a1, m1, b1, mc1) = runs
    for s0, s1 in ((a0, a1), (b0, b1)):
        for (k, v), (k1, v1) in zip(s0.gen.state_dict().items(), s1.gen.state_dict().items()):
            assert k == k1 and torch.equal(v, v1), k
        for k, v in s0.disc.state_dict().items():
            assert torch.equal(v, s1.disc.state_dict()[k]), k
        assert torch.equal(s0.rng.get_state(), s1.rng.get_state())
    assert all(torch.equal(m0[k], m1[k]) for k in m0) and all(torch.equal(mc0[k], mc1[k]) for k in mc0)


@pytest.mark.parametrize("exc", [
    torch.distributed.DistBackendError("NCCL communicator was aborted on rank 1"),
    torch.distributed.DistNetworkError("failed to recv, got 0 bytes"),
    torch.distributed.DistStoreError("Socket Timeout"),
    RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection closed by peer [127.0.0.1]:41235"),
    RuntimeError("[Rank 1] Watchdog caught collective operation timeout: WorkNCCL(SeqNum=5, OpType=ALLREDUCE) "
                 "ran for 600000 milliseconds before timing out."),
    RuntimeError("Timed out after 121 seconds waiting for clients. 1/2 clients joined."),
    RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:589] Read error [127.0.0.1]:5033: "
                 "Connection reset by peer"),
])
def test_torch_distributed_failures_are_retryable(exc):
    """A dead peer surfaces on the others as one of these: each is a
    distributed failure, which a rank of a group maps to exit 75."""
    assert watchdog.is_distributed_failure(exc)


def test_ordinary_errors_are_not_distributed_failures():
    for exc in (ValueError("bad config"), RuntimeError("shape mismatch"), KeyError("gen_loss")):
        assert not watchdog.is_distributed_failure(exc)
