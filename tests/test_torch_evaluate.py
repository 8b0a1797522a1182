"""The port's evaluation module (``musicgan_tpu_torch/evaluate.py``) and the
command line of its new subcommands, against the JAX package on the CPU:
the numpy scoring copied bit for bit, ``compare_artifacts`` on reference
``.pt`` files written by the JAX package's exporter, ``audition_run`` on a
run directory of the port's ``train``, and the ``view_audio``, ``serve``,
``eval`` and ``compare`` parsers against the JAX CLI's."""

import argparse
import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from musicgan_tpu import evaluate as jax_eval
from musicgan_tpu.audio.io import save_wav
from musicgan_tpu.models import init_generator
from musicgan_tpu.models.torch_ingest import export_reference_generator
from musicgan_tpu_torch import evaluate
from musicgan_tpu_torch import generate as generate_mod
from musicgan_tpu_torch.audio.ingest import ShardWriter
from musicgan_tpu_torch.audio.io import load_wav
from musicgan_tpu_torch.config import ModelConfig, TrainConfig
from musicgan_tpu_torch.train import train
from tests.test_torch_serve import jax_latents
from tests.tiny_cfg import TINY_MODEL

SR = 44100
CFG = ModelConfig(
    rand_channels=TINY_MODEL.rand_channels, gen_channels=TINY_MODEL.gen_channels,
    disc_channels=TINY_MODEL.disc_channels,
)
# TINY_MODEL's widths with the last two blocks' outputs made unique (6, 5,
# 4 instead of 6, 4, 4): a reference ``.pt`` names no stage, and both
# packages' loaders infer it from the head's input width, so TINY_MODEL's
# 4-wide stage 6 would take the stage-7 head.
PT_CHANNELS = TINY_MODEL.gen_channels[:6] + ((6, 5), (5, 4))
JAX_PT_CFG = dataclasses.replace(TINY_MODEL, gen_channels=PT_CHANNELS)
PT_CFG = ModelConfig(rand_channels=TINY_MODEL.rand_channels, gen_channels=PT_CHANNELS)
# compare's table, port against JAX: the waveforms agree to 1e-5 (the
# repo's bar is 1e-4), the log-band profiles of 2.97 s clips to ~1e-5 and
# the onset-modulation profiles (log energies, rectified differences) to
# ~2e-4: every distance within 1e-3 of JAX's.
TOL_TABLE = 1e-3


def _tone_corpus(path, n=3, seconds=2.0, seed=0):
    """``n`` seeded tracks: a tone each, a rhythm of its own, noise."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    for i in range(n):
        gate = 0.5 + 0.5 * np.sign(np.sin(2 * np.pi * (1.5 + i) * t))
        sig = 0.3 * gate * np.sin(2 * np.pi * 220.0 * (i + 1) * t) + 0.05 * rng.standard_normal(t.size)
        save_wav(os.path.join(path, f"t{i}.wav"), sig.astype(np.float32), SR)
    return path


def _assert_tables_close(ours: dict, ref: dict, tol: float) -> None:
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict) and k != "artifacts":
            assert set(ours[k]) == set(v), k
            for m, x in v.items():
                if isinstance(x, int):
                    assert ours[k][m] == x, (k, m)
                else:
                    assert abs(ours[k][m] - x) <= tol, (k, m, ours[k][m], x)
        elif isinstance(v, float):
            assert abs(ours[k] - v) <= tol, (k, ours[k], v)
        else:
            assert ours[k] == v, k


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _tone_corpus(str(tmp_path_factory.mktemp("corpus")))


@pytest.mark.parametrize("fn", ["band_profile", "temporal_profile"])
def test_profiles_equal_jax(rng, fn):
    """The copied numpy: the same bits as JAX's, on tones, noise and the
    short-input edges."""
    t = np.arange(SR) / SR
    for wav in (np.sin(2 * np.pi * 440 * t), rng.standard_normal(3 * SR) * 0.1,
                np.zeros(5000), rng.standard_normal(4000)):
        np.testing.assert_array_equal(getattr(evaluate, fn)(wav, SR), getattr(jax_eval, fn)(wav, SR))
    assert evaluate.N_BANDS == jax_eval.N_BANDS and evaluate.M_BANDS == jax_eval.M_BANDS


def test_scoring_helpers_equal_jax(rng, corpus, tmp_path):
    profiles = rng.standard_normal((5, 48))
    assert evaluate.inter_sample_dist(profiles) == jax_eval.inter_sample_dist(profiles)
    assert np.isnan(evaluate.inter_sample_dist(profiles[:1]))
    corpus_p = evaluate.load_corpus_profiles(corpus)
    np.testing.assert_array_equal(corpus_p, jax_eval.load_corpus_profiles(corpus))
    assert evaluate.score_profiles(profiles, corpus_p) == jax_eval.score_profiles(profiles, corpus_p)
    w = rng.standard_normal(SR)
    assert evaluate.spectral_flatness(w, SR) == jax_eval.spectral_flatness(w, SR)
    big = _tone_corpus(str(tmp_path / "big"), n=7, seconds=0.2, seed=3)
    for frac, seed in ((0.3, 17), (0.5, 4)):
        assert evaluate.split_holdout(big, frac, seed) == jax_eval.split_holdout(big, frac, seed)
    with pytest.raises(ValueError):
        evaluate.split_holdout(big, 1.0)


def test_score_auditions_gives_jax_s_table(tmp_path, corpus, rng):
    """The same audition directory scored by both: the same table, with
    and without a held-out axis, and the same JSON."""
    aud = tmp_path / "aud"
    aud.mkdir()
    t = np.arange(int(SR * 1.5)) / SR
    for k in (0, 3):
        for s in range(3):
            sig = 0.2 * np.sin(2 * np.pi * (300 + 100 * k + 37 * s) * t) + 0.02 * rng.standard_normal(t.size)
            save_wav(str(aud / f"save{k:03d}_s2_seed{s}.wav"), sig.astype(np.float32), SR)
    save_wav(str(aud / "other.wav"), np.zeros(4096, np.float32), SR)  # not a save: skipped
    hold = _tone_corpus(str(tmp_path / "hold"), n=2, seed=9)
    for kw in ({}, {"holdout_dir": hold}):
        ours = evaluate.score_auditions(str(aud), corpus, json_out=str(tmp_path / "a.json"),
                                        verbose=False, **kw)
        ref = jax_eval.score_auditions(str(aud), corpus, json_out=str(tmp_path / "b.json"),
                                       verbose=False, **kw)
        assert ours == ref and sorted(k for k in ours if isinstance(k, int)) == [0, 3]
        assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    big = _tone_corpus(str(tmp_path / "big"), n=5, seed=5)
    ours = evaluate.score_auditions(str(aud), big, verbose=False, holdout_frac=0.4)
    assert ours == jax_eval.score_auditions(str(aud), big, verbose=False, holdout_frac=0.4)
    assert "holdout_gap" in ours[0]


def test_compare_artifacts_matches_jax(tmp_path, corpus, monkeypatch):
    """Two tiny reference ``.pt`` generators written by the JAX package's
    exporter, the same JAX latents through both packages' ``compare``:
    the port's table within 1e-3 of JAX's, and a reused out dir's stale
    WAVs cleared with a notice."""
    pts = []
    for i in range(2):
        path = str(tmp_path / f"gen_{i}.pt")
        export_reference_generator(init_generator(jax.random.PRNGKey(10 + i), JAX_PT_CFG), path,
                                   stage=7, cfg=JAX_PT_CFG)
        pts.append(path)
    ref = jax_eval.compare_artifacts(pts, corpus, seeds=3, nb_vec=1, model_cfg=JAX_PT_CFG,
                                     verbose=False)
    monkeypatch.setattr(generate_mod, "latents", jax_latents)
    out = tmp_path / "out"
    out.mkdir()
    (out / "save009_ID0.wav").write_bytes(b"stale")
    with pytest.warns(UserWarning, match="clearing 1 stale"):
        ours = evaluate.compare_artifacts(pts, corpus, seeds=3, nb_vec=1, model_cfg=PT_CFG,
                                          verbose=False, out_dir=str(out), device="cpu",
                                          json_out=str(tmp_path / "c.json"))
    _assert_tables_close(ours, ref, TOL_TABLE)
    assert sorted(k for k in ours if isinstance(k, int)) == [0, 1]
    assert ours["artifacts"] == {"0": pts[0], "1": pts[1]}
    assert sorted(os.listdir(out)) == [f"save{i:03d}_ID{s}.wav" for i in range(2) for s in range(3)]
    with open(tmp_path / "c.json") as f:
        assert json.load(f)["artifacts"] == ours["artifacts"]


def test_compare_the_same_artifact_twice_gives_equal_rows(corpus):
    """The shipped generator given twice: the same latents through the same
    weights, two equal rows (full width on the CPU, seeds 2 x nb_vec 1)."""
    gen_pt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "saved_models", "quality_r4", "gen_final.pt")
    res = evaluate.compare_artifacts([gen_pt, gen_pt], corpus, seeds=2, nb_vec=1, verbose=False,
                                     device="cpu")
    assert res[0] == res[1] and res[0]["n_samples"] == 2
    assert np.isfinite(res[0]["nearest_track_dist"])


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny run of the port's ``train`` with a generator EMA: 4
    iterations, saves at 3 and at the end."""
    root = tmp_path_factory.mktemp("run")
    w = ShardWriter(str(root / "ds"), samples_per_shard=6)
    w.add(np.random.default_rng(0).uniform(-1, 1, (12, 2, 512, 512)).astype(np.float32))
    w.close()
    tcfg = TrainConfig(batch_size=4, save_every=3, log_every=10, nb_preview=1, chunk_steps=1,
                       ema_decay=0.99)
    train("eval", str(root / "ds"), str(root / "run"), tcfg, CFG, max_iters=4, device="cpu", mesh=None)
    return str(root / "run")


def test_audition_run_renders_every_save_with_the_ema(run_dir, corpus):
    """One WAV per seed and save at the save's stage, through the EMA
    weights (``generate.load_generator_params``'s rule), scored after."""
    from musicgan_tpu_torch.generate import load_generator_params
    from musicgan_tpu_torch.train import CheckpointManager

    saves = CheckpointManager(os.path.join(run_dir, "checkpoints")).saved_indices()
    assert len(saves) >= 1
    out = evaluate.audition_run(run_dir, seeds=2, nb_vec=1, model_cfg=CFG, verbose=False, device="cpu")
    wavs = sorted(f for f in os.listdir(out) if f.endswith(".wav"))
    assert len(wavs) == 2 * len(saves)
    last = saves[-1]
    with open(os.path.join(out, f"save{last:03d}.json")) as f:
        summary = json.load(f)
    assert summary["ema"] is True and len(summary["flatness"]) == 2
    stage = summary["stage"]
    for s in range(2):
        wave, sr = load_wav(os.path.join(out, f"save{last:03d}_s{stage}_seed{s}.wav"))
        assert sr == SR and np.isfinite(wave).all() and wave.shape == ((2 * 2 ** 8 - 1) * 256,)
    # the EMA generator of the last save, on the audition's latents
    gen = load_generator_params(os.path.join(run_dir, "checkpoints", f"save_{last}"), CFG, "cpu")
    z = generate_mod.latents(CFG, 1, 2, 1234, "cpu")
    ref = generate_mod.synthesize_fn(CFG, stage)(gen, z).numpy()
    np.testing.assert_array_equal(wave, ref[1])

    raw = evaluate.audition_run(run_dir, out_dir=os.path.join(run_dir, "raw"), seeds=2, nb_vec=1,
                                saves=[last], raw_weights=True, model_cfg=CFG, verbose=False,
                                device="cpu")
    with open(os.path.join(raw, f"save{last:03d}.json")) as f:
        assert json.load(f)["ema"] is False
    res = evaluate.score_auditions(out, corpus, verbose=False)
    assert sorted(k for k in res if isinstance(k, int)) == saves
    assert res == jax_eval.score_auditions(out, corpus, verbose=False)


def test_cli_eval_on_cpu(run_dir, corpus, tmp_path, capsys, monkeypatch):
    """``eval --device cpu`` auditions and scores the tiny run (the CLI
    builds the default ``ModelConfig``: here it is the run's widths)."""
    from musicgan_tpu_torch import config as config_mod
    from musicgan_tpu_torch.__main__ import main

    monkeypatch.setattr(config_mod, "ModelConfig", lambda: CFG)
    main(["eval", run_dir, "--corpus", corpus, "-o", str(tmp_path / "aud"), "--seeds", "2",
          "--nb-vec", "1", "--json-out", str(tmp_path / "s.json"), "--device", "cpu"])
    with open(tmp_path / "s.json") as f:
        table = json.load(f)
    assert "corpus_inter_track_dist" in table and any(k.isdigit() for k in table)
    with pytest.raises(SystemExit):
        main(["eval", run_dir, "--json-out", str(tmp_path / "t.json"), "--device", "cpu"])
    assert "--json-out requires --corpus" in capsys.readouterr().err


def test_entry_points_raise_without_a_gpu(run_dir, corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.audition_run(run_dir, out_dir=str(tmp_path / "a"), model_cfg=CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.compare_artifacts([run_dir, run_dir], corpus, model_cfg=CFG, out_dir=str(tmp_path / "b"))
    from musicgan_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["eval", run_dir, "-o", str(tmp_path / "c")])
    assert not any(f.endswith(".wav") for d in ("a", "b", "c") if (tmp_path / d).exists()
                   for f in os.listdir(tmp_path / d))


class _Parsed(Exception):
    pass


def _subparsers(main, argv) -> dict:
    """``{subcommand: parser}`` of a CLI whose ``main`` builds its parser
    and parses: the parse is intercepted before anything runs."""
    seen = {}

    def intercept(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", intercept):
        with pytest.raises(_Parsed):
            main(*argv)
    (action,) = [a for a in seen["parser"]._actions if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _flags(parser) -> dict:
    return {
        a.dest: (tuple(a.option_strings), a.default, a.required, a.nargs, type(a).__name__)
        for a in parser._actions if a.dest not in ("help", "platform", "device")
    }


@pytest.mark.parametrize("mode", ["view_audio", "serve", "eval", "compare"])
def test_cli_flags_match_the_jax_cli(mode):
    """Each new subcommand takes the JAX parser's arguments with the same
    names, defaults and kinds (JAX's ``--platform`` aside), and ``--device``
    with ``cuda`` by default."""
    from musicgan_tpu.__main__ import main as jax_main
    from musicgan_tpu_torch.__main__ import main

    theirs = _flags(_subparsers(jax_main, ())[mode])
    ours_parser = _subparsers(main, ([],))[mode]
    ours = _flags(ours_parser)
    assert ours == theirs
    (device,) = [a for a in ours_parser._actions if a.dest == "device"]
    assert device.option_strings == ["--device"] and device.default == "cuda"
