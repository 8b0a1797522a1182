"""The port's synthesis slice against the JAX package, on the CPU: the
``generate`` entry point, the CLI, the device rule and the package's
isolation from JAX."""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from musicgan_tpu.generate import generate as jax_generate
from musicgan_tpu.generate import synthesize_fn as jax_synthesize_fn
from musicgan_tpu.models.generator import init_generator
from musicgan_tpu_torch.audio import load_wav
from musicgan_tpu_torch.config import ModelConfig
from musicgan_tpu_torch.generate import generate, synthesize_fn
from musicgan_tpu_torch.models import Generator, params_from_jax
from tests.tiny_cfg import TINY_MODEL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_PT = os.path.join(ROOT, "saved_models", "quality_r4", "gen_final.pt")


def test_generate_matches_jax_on_the_shipped_generator(tmp_path):
    """The whole slice at full width: the same latent through both
    packages' ``generate`` on the trained stage-7 generator (nb_vec 1,
    one clip), WAVs compared sample by sample at the repo's waveform bar."""
    z = np.random.default_rng(7).standard_normal((1, 2, 2, 32)).astype(np.float32)
    (ref_path,) = jax_generate(str(tmp_path / "jax"), 32, GEN_PT, nb_vec=1, nb_music=1, z=z)
    (our_path,) = generate(
        str(tmp_path / "torch"), 32, GEN_PT, nb_vec=1, nb_music=1, z=z, device="cpu"
    )
    ref, sr_ref = load_wav(ref_path)
    ours, sr = load_wav(our_path)
    assert sr == sr_ref == 44100
    assert ours.shape == ref.shape == ((512 - 1) * 256,)
    assert float(np.abs(ref).max()) > 1e-3  # not a silent pass
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


def test_synthesize_fn_matches_jax_at_a_partial_stage():
    """A partially grown stage is nearest-upsampled to 512 bins before
    vocoding, in both packages (TINY_MODEL, stage 3, two clips)."""
    params = jax.tree_util.tree_map(
        np.asarray, init_generator(jax.random.PRNGKey(5), TINY_MODEL)
    )
    z = np.random.default_rng(3).standard_normal((2, 2, 2, 8)).astype(np.float32)
    ref = np.asarray(jax_synthesize_fn(TINY_MODEL, stage=3)(params, z))

    cfg = ModelConfig(rand_channels=8, gen_channels=TINY_MODEL.gen_channels)
    gen = Generator(cfg)
    gen.load_state_dict(params_from_jax(params))
    got = synthesize_fn(cfg, stage=3)(gen, z).numpy()
    assert got.shape == ref.shape == (2, (512 - 1) * 256)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_cli_generate_on_cpu_writes_a_wav(tmp_path):
    out = tmp_path / "sounds"
    proc = subprocess.run(
        [sys.executable, "-m", "musicgan_tpu_torch", "generate", GEN_PT, "32",
         "-o", str(out), "-n", "1", "-m", "1", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [str(out / "sound_0.wav")]
    wave, sr = load_wav(str(out / "sound_0.wav"))
    assert sr == 44100 and wave.shape == ((512 - 1) * 256,)
    assert np.isfinite(wave).all()


def test_entry_points_raise_without_a_gpu(tmp_path):
    """No GPU and no ``device="cpu"``: the entry points raise; they never
    carry on on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(str(tmp_path / "a"), 32, GEN_PT, nb_vec=1, nb_music=1)
    from musicgan_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["generate", GEN_PT, "32", "-o", str(tmp_path / "b"), "-n", "1", "-m", "1"])
    assert not os.listdir(tmp_path)


def test_orbax_checkpoints_are_refused_with_a_clear_error(tmp_path):
    from musicgan_tpu_torch.generate import load_generator_params

    # What the JAX package's CheckpointManager leaves: save_N/state as an
    # orbax directory beside meta.json.  Each spelling of the path is refused.
    save = tmp_path / "run" / "checkpoints" / "save_3"
    os.makedirs(save / "state")
    (save / "meta.json").write_text('{"has_ema": false}')
    for path in (tmp_path / "run", tmp_path / "run" / "checkpoints", save):
        with pytest.raises(NotImplementedError, match="musicgan_tpu export"):
            load_generator_params(str(path), device="cpu")
    # A directory that holds no checkpoint of either package is just missing.
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        load_generator_params(str(tmp_path / "empty"), device="cpu")


_ISOLATION_PROBE = """
import importlib, pkgutil, sys
import musicgan_tpu_torch
for m in pkgutil.walk_packages(musicgan_tpu_torch.__path__, "musicgan_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
for new in ("train.step", "train.optim", "ops.conv_vjp", "models.discriminator",
            "models.losses", "audio.transforms", "device", "train.loop", "train.grower",
            "train.saver", "train.checkpoint", "audio.dataset", "audio.ingest",
            "audio.host_pipeline", "utils.metrics", "utils.watchdog", "__main__",
            "serve", "evaluate", "view_audio", "audio.rebin", "audio.stft", "audio.functions",
            "native", "utils.supervise", "utils.profiling", "ops.nan_check", "models.torch_ingest",
            "ops.autotune", "utils.timing", "utils.cache", "parallel", "parallel.mesh",
            "parallel.longclip"):
    assert "musicgan_tpu_torch." + new in sys.modules, new
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "orbax", "musicgan_tpu")
    or m.startswith(("jax.", "jaxlib.", "orbax.", "musicgan_tpu."))
)
assert not bad, bad
print("isolated", len(sys.modules))
"""

_IMPORT_RE = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|orbax|musicgan_tpu)(\.|\s|$)", re.M)
# A path into the JAX package's directory in a string the code uses (not a
# docstring): "musicgan_tpu/..." or a "musicgan_tpu" path component.  A
# TPU kernel's "file:line" citation (chip_smoke.py's "replaces") is printed,
# never opened.
_CITATION_RE = re.compile(r"^musicgan_tpu/[\w/]+\.py:\d+$")


def _paths_into_the_jax_package(source: str) -> list:
    tree = ast.parse(source)
    docstrings = {
        id(node.body[0].value) for node in ast.walk(tree)
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
        and node.body and isinstance(node.body[0], ast.Expr) and isinstance(node.body[0].value, ast.Constant)
    }
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docstrings:
            s = node.value
            if (s == "musicgan_tpu" or re.search(r"(^|[^\w])musicgan_tpu/", s)) and not _CITATION_RE.match(s):
                hits.append(s)
    return hits


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATION_PROBE], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("isolated")

    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "musicgan_tpu_torch")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(sources) > 10
    for path in sources:
        with open(path) as f:
            source = f.read()
        hits = _IMPORT_RE.findall(source)
        assert not hits, (path, hits)
        assert not _paths_into_the_jax_package(source), path
    for new in ("native/__init__.py", "utils/supervise.py", "utils/profiling.py", "ops/nan_check.py",
                "ops/autotune.py", "utils/timing.py", "utils/cache.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/longclip.py"):
        assert os.path.join(ROOT, "musicgan_tpu_torch", new) in sources, new
    # the check sees such a path where the code would use one
    assert _paths_into_the_jax_package('p = os.path.join(ROOT, "musicgan_tpu", "native")\n')
    assert _paths_into_the_jax_package('f = open(f"{ROOT}/musicgan_tpu/native/host_ops.cpp")\n')
    assert not _paths_into_the_jax_package('"""a counterpart of ``musicgan_tpu/native``"""\n')
