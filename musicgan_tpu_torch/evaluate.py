"""Evaluation: checkpoint audition + corpus-referenced quality scoring.

Counterpart of ``musicgan_tpu/evaluate.py``, exposed as a library and as
the ``eval`` and ``compare`` subcommands.  Two halves:

* :func:`audition_run` and :func:`compare_artifacts` render WAVs through
  ``generate.synthesize_fn`` (``conv_impl`` "auto" by default: the measured
  winner per shape on the card, the kernels or the library lowering): every
  checkpoint of a run of this package's ``train`` at the stage it was saved
  at, or the same latents through each of several artifacts (reference
  ``gen_*.pt`` files or run directories).  They run on ``cuda`` unless the
  caller passes ``device="cpu"``; their latents come from
  ``generate.latents``.
* the scoring, numpy on the host and copied from the JAX module:
  :func:`band_profile` (long-term average log-magnitude profile on a
  log-frequency band grid, gain-normalized), :func:`temporal_profile` (the
  onset-modulation spectrum), :func:`score_profiles` (a sample's distance to
  the NEAREST corpus track, the mean profile's distance, and the diversity
  axes ``inter_sample_dist`` and ``nearest_track_coverage`` against mode
  collapse) and :func:`score_auditions`, with a held-out axis
  (:func:`split_holdout`) that tells memorization from generalization.
  Lower distances = closer to the corpus.
"""

from __future__ import annotations

import glob
import json
import os
import re
from collections import defaultdict

import numpy as np

__all__ = [
    "band_profile", "temporal_profile", "inter_sample_dist",
    "load_corpus_profiles", "score_profiles", "score_auditions",
    "audition_run", "compare_artifacts", "split_holdout",
    "N_BANDS", "M_BANDS",
]

N_BANDS = 48
F_LO, F_HI = 40.0, 10000.0
N_FFT = 2048

# temporal (rhythm) axis: onset-modulation spectrum bands
M_BANDS = 24
MOD_LO, MOD_HI = 0.25, 20.0  # Hz: slow phrasing .. fast note events
ENV_HOP = 1024  # envelope frame = ~23 ms at 44.1 kHz (~43 Hz frame rate)


# ---------------------------------------------------------------------------
# spectral profiles


def band_profile(wav: np.ndarray, sr: int) -> np.ndarray:
    """Gain-normalized log-power profile over log-spaced bands."""
    wav = np.asarray(wav, np.float64)
    if len(wav) < N_FFT:
        raise ValueError(
            f"waveform too short for a spectral profile: {len(wav)} "
            f"samples < N_FFT={N_FFT} (truncated/corrupt WAV?)"
        )
    n = (len(wav) // N_FFT) * N_FFT
    frames = wav[:n].reshape(-1, N_FFT) * np.hanning(N_FFT)
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    power = spec.mean(axis=0)  # long-term average spectrum
    freqs = np.fft.rfftfreq(N_FFT, 1.0 / sr)
    edges = np.geomspace(F_LO, F_HI, N_BANDS + 1)
    centers = np.sqrt(edges[:-1] * edges[1:])
    return _log_band_bin(power, freqs, edges, centers)


def _log_band_bin(power, freqs, edges, centers) -> np.ndarray:
    """Log-power binning over log-spaced bands, mean-subtracted
    (gain-invariant); bands narrower than one FFT bin interpolate."""
    logp = np.log10(power + 1e-20)
    prof = np.empty(len(centers))
    for i in range(len(centers)):
        sel = (freqs >= edges[i]) & (freqs < edges[i + 1])
        prof[i] = (np.log10(power[sel].mean() + 1e-20) if sel.any()
                   else float(np.interp(centers[i], freqs, logp)))
    return prof - prof.mean()


def temporal_profile(wav: np.ndarray, sr: int) -> np.ndarray:
    """Gain-normalized onset-modulation profile — the TEMPORAL-structure
    axis the spectral ``band_profile`` is blind to (a steady chord and a
    rhythmic arpeggio over the same notes share a long-term spectrum but
    not this).

    Frame log-energies at ~43 Hz -> half-wave-rectified flux (onset
    strength) -> log-power modulation spectrum binned over log-spaced
    0.25-20 Hz bands (musical phrasing through fast note events; tempo
    lands at beat/2pi-free FFT bins, so 60-160 BPM = 1-2.7 Hz is well
    inside the range).  Same distance semantics as ``band_profile``:
    mean-subtracted log profile, RMS distance comparable across saves."""
    wav = np.asarray(wav, np.float64)
    n = (len(wav) // ENV_HOP) * ENV_HOP
    if n == 0:
        raise ValueError(
            f"waveform too short for a temporal profile: {len(wav)} "
            f"samples < ENV_HOP={ENV_HOP}"
        )
    frames = wav[:n].reshape(-1, ENV_HOP)
    p = (frames**2).mean(axis=1)
    pmax = p.max()
    if pmax <= 0.0:  # digital silence
        return np.zeros(M_BANDS)
    # floor RELATIVE to the loudest frame (-60 dB gate): an absolute
    # floor would break gain invariance on silent inter-onset frames
    energy = np.log10(p + 1e-6 * pmax)
    onset = np.maximum(np.diff(energy), 0.0)
    if len(onset) < 8:
        # too short to resolve any modulation band: flat (zero) profile
        return np.zeros(M_BANDS)
    onset = (onset - onset.mean()) * np.hanning(len(onset))
    frame_rate = sr / ENV_HOP
    power = np.abs(np.fft.rfft(onset)) ** 2
    freqs = np.fft.rfftfreq(len(onset), 1.0 / frame_rate)
    edges = np.geomspace(MOD_LO, MOD_HI, M_BANDS + 1)
    centers = np.sqrt(edges[:-1] * edges[1:])
    return _log_band_bin(power, freqs, edges, centers)


def inter_sample_dist(profiles: np.ndarray) -> float:
    """Mean pairwise RMS distance between band profiles ``(S, B)`` — the
    mode-collapse detector: ~0 when every sample has the same spectrum."""
    s = len(profiles)
    if s < 2:
        return float("nan")
    d = np.sqrt(
        ((profiles[:, None, :] - profiles[None, :, :]) ** 2).mean(axis=2)
    )
    return float(d[np.triu_indices(s, k=1)].mean())


def _profiles_for_files(files: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """One decode pass -> (spectral ``(T, B)``, temporal ``(T, M)``)
    profiles for the given WAV paths.  The wav decode dominates; a second
    pass over a 640-track corpus would cost minutes."""
    from .audio.io import load_wav

    spec, temp = [], []
    for p in files:
        wav, sr = load_wav(p)
        spec.append(band_profile(wav, sr))
        temp.append(temporal_profile(wav, sr))
    if not spec:
        raise ValueError("no .wav corpus tracks given")
    return np.stack(spec), np.stack(temp)


def _load_corpus_both(corpus_dir: str) -> tuple[np.ndarray, np.ndarray]:
    files = sorted(glob.glob(os.path.join(corpus_dir, "*.wav")))
    if not files:
        raise ValueError(f"no .wav corpus tracks under {corpus_dir}")
    return _profiles_for_files(files)


def split_holdout(
    corpus_dir: str, holdout_frac: float, holdout_seed: int = 17
) -> tuple[list[str], list[str]]:
    """Deterministic track-level train/held-out split of a corpus dir.

    A seeded permutation of the SORTED track list, last
    ``ceil(frac * T)`` tracks held out — stable across runs and across
    machines, so the same flag value names the same split when training
    and evaluation use it."""
    files = sorted(glob.glob(os.path.join(corpus_dir, "*.wav")))
    if not files:
        raise ValueError(f"no .wav corpus tracks under {corpus_dir}")
    if not 0.0 < holdout_frac < 1.0:
        raise ValueError(f"holdout_frac must be in (0, 1): {holdout_frac}")
    k = max(1, int(np.ceil(holdout_frac * len(files))))
    if k >= len(files):
        raise ValueError(
            f"holdout_frac={holdout_frac} holds out all {len(files)} tracks"
        )
    perm = np.random.default_rng(holdout_seed).permutation(len(files))
    held = {int(i) for i in perm[-k:]}
    train = [f for i, f in enumerate(files) if i not in held]
    holdout = [f for i, f in enumerate(files) if i in held]
    return train, holdout


def load_corpus_profiles(corpus_dir: str) -> np.ndarray:
    """Band profiles ``(T, B)`` for every ``*.wav`` under ``corpus_dir``."""
    return _load_corpus_both(corpus_dir)[0]


# ---------------------------------------------------------------------------
# scoring


def score_profiles(gen: np.ndarray, corpus: np.ndarray) -> dict:
    """Score one checkpoint's sample profiles ``(S, B)`` against corpus
    track profiles ``(T, B)``: nearest-track distance, mean-profile
    distance, and the diversity axes."""
    dists = np.sqrt(
        ((gen[:, None, :] - corpus[None, :, :]) ** 2).mean(axis=2)
    )
    d = dists.min(axis=1)
    corpus_mean = corpus.mean(axis=0)
    return {
        "nearest_track_dist": float(d.mean()),
        "mean_profile_dist": float(
            np.sqrt(((gen.mean(axis=0) - corpus_mean) ** 2).mean())
        ),
        "inter_sample_dist": inter_sample_dist(gen),
        "nearest_track_coverage": float(
            len(set(dists.argmin(axis=1).tolist())) / len(gen)
        ),
        "n_samples": int(len(gen)),
    }


def score_auditions(
    audition_dir: str,
    corpus_dir: str,
    json_out: str | None = None,
    verbose: bool = True,
    holdout_frac: float = 0.0,
    holdout_dir: str | None = None,
    holdout_seed: int = 17,
) -> dict:
    """Score every ``saveNNN_*.wav`` under ``audition_dir`` against the
    corpus; returns ``{save_index: metrics, "corpus_inter_track_dist": x}``
    and optionally writes it as JSON.

    Held-out axis (the training-corpus score
    alone cannot tell memorization of a corpus track from generalization):

    * ``holdout_frac``: deterministically split the corpus dir's tracks
      (:func:`split_holdout`); samples are scored against the TRAIN part
      (``nearest_track_dist``, unchanged semantics) AND the held-out part
      (``nearest_holdout_dist``).  Meaningful when training used the same
      split; on an all-tracks training run it still calibrates how close
      "unseen tracks of the same corpus" sit.
    * ``holdout_dir``: an explicit directory of tracks the generator never
      trained on (e.g. fresh draws of the synthetic-corpus recipe) —
      the rigorous option for runs that trained on the full corpus.

    ``holdout_gap = nearest_holdout_dist - nearest_track_dist``: ~0 means
    samples sit no closer to trained tracks than to unseen ones
    (generalization); a large positive gap — especially one exceeding the
    reported ``holdout_to_train_dist`` baseline (how close the held-out
    tracks themselves sit to the train set) — means memorization."""
    from .audio.io import load_wav

    if holdout_dir is not None and holdout_frac:
        raise ValueError("pass either holdout_frac or holdout_dir, not both")
    hold = hold_t = None
    if holdout_dir is not None:
        corpus, corpus_t = _load_corpus_both(corpus_dir)
        hold, hold_t = _load_corpus_both(holdout_dir)
    elif holdout_frac:
        train_files, hold_files = split_holdout(
            corpus_dir, holdout_frac, holdout_seed
        )
        corpus, corpus_t = _profiles_for_files(train_files)
        hold, hold_t = _profiles_for_files(hold_files)
    else:
        corpus, corpus_t = _load_corpus_both(corpus_dir)
    corpus_spread = inter_sample_dist(corpus)
    corpus_t_spread = inter_sample_dist(corpus_t)
    if verbose:
        print(f"corpus: {len(corpus)} tracks, {N_BANDS} bands "
              f"{F_LO:.0f}-{F_HI:.0f} Hz, inter-track dist "
              f"{corpus_spread:.4f} (diversity calibration); temporal "
              f"{M_BANDS} bands {MOD_LO}-{MOD_HI} Hz, spread "
              f"{corpus_t_spread:.4f}")
    holdout_to_train = None
    if hold is not None:
        # Baseline: how close do genuinely-unseen tracks sit to the train
        # set?  A generated sample closer to the train set than THIS is
        # closer than any real unseen track ever gets — memorization.
        holdout_to_train = float(
            np.sqrt(
                ((hold[:, None, :] - corpus[None, :, :]) ** 2).mean(axis=2)
            ).min(axis=1).mean()
        )
        if verbose:
            print(f"held-out: {len(hold)} tracks, nearest-train baseline "
                  f"{holdout_to_train:.4f}")

    per_save: dict[int, list[np.ndarray]] = defaultdict(list)
    per_save_t: dict[int, list[np.ndarray]] = defaultdict(list)
    for p in sorted(glob.glob(os.path.join(audition_dir, "*.wav"))):
        m = re.match(r"save(\d+)_", os.path.basename(p))
        if not m:
            continue
        wav, sr = load_wav(p)
        per_save[int(m.group(1))].append(band_profile(wav, sr))
        per_save_t[int(m.group(1))].append(temporal_profile(wav, sr))

    results: dict = {
        "corpus_inter_track_dist": corpus_spread,
        "corpus_temporal_spread": corpus_t_spread,
    }
    if holdout_to_train is not None:
        results["holdout_to_train_dist"] = holdout_to_train
        results["n_holdout_tracks"] = int(len(hold))
    if verbose:
        print(f"\n{'save':>5} {'nearest-track dist':>19} "
              f"{'mean-profile dist':>18} {'inter-sample dist':>18} "
              f"{'coverage':>9} {'temporal dist':>14} {'t-diversity':>12}"
              + (f" {'holdout dist':>13} {'gap':>8}" if hold is not None
                 else ""))
    for k in sorted(per_save):
        r = score_profiles(np.stack(per_save[k]), corpus)
        # same distance kernel on the temporal profiles (one
        # implementation, provably identical semantics on both axes)
        rt = score_profiles(np.stack(per_save_t[k]), corpus_t)
        r["nearest_temporal_dist"] = rt["nearest_track_dist"]
        r["temporal_inter_sample_dist"] = rt["inter_sample_dist"]
        if hold is not None:
            rh = score_profiles(np.stack(per_save[k]), hold)
            r["nearest_holdout_dist"] = rh["nearest_track_dist"]
            r["holdout_gap"] = (
                rh["nearest_track_dist"] - r["nearest_track_dist"]
            )
        results[k] = r
        if verbose:
            print(f"{k:>5} {r['nearest_track_dist']:>19.4f} "
                  f"{r['mean_profile_dist']:>18.4f} "
                  f"{r['inter_sample_dist']:>18.4f} "
                  f"{r['nearest_track_coverage']:>9.2f} "
                  f"{r['nearest_temporal_dist']:>14.4f} "
                  f"{r['temporal_inter_sample_dist']:>12.4f}"
                  + (f" {r['nearest_holdout_dist']:>13.4f} "
                     f"{r['holdout_gap']:>8.4f}" if hold is not None
                     else ""))

    if json_out:
        with open(json_out, "w") as f:
            json.dump(results, f, indent=1)
    return results


def compare_artifacts(
    ckpts: list[str],
    corpus_dir: str,
    seeds: int = 8,
    nb_vec: int = 2,
    seed: int = 1234,
    out_dir: str | None = None,
    json_out: str | None = None,
    model_cfg=None,
    verbose: bool = True,
    holdout_frac: float = 0.0,
    holdout_dir: str | None = None,
    holdout_seed: int = 17,
    device=None,
) -> dict:
    """Head-to-head scoring of trained generator artifacts: render the
    SAME latents through each (reference ``gen_*.pt`` files or this
    package's checkpoint/run dirs), then score them all with
    :func:`score_auditions` — so table differences are attributable to the
    weights alone.  The table's ``save`` index is the artifact's position in
    ``ckpts``; the returned dict carries an ``artifacts`` index->path
    legend."""
    import shutil
    import tempfile

    from . import generate as generate_mod
    from .config import ModelConfig
    from .device import resolve_device

    device = resolve_device(device)
    cfg = model_cfg if model_cfg is not None else ModelConfig()
    tmp = out_dir or tempfile.mkdtemp(prefix="compare_artifacts_")
    os.makedirs(tmp, exist_ok=True)
    # a reused out_dir may hold save*.wav from a previous compare/eval;
    # score_auditions globs them all, so stale files would inject phantom
    # rows into the table — clear them first, and say so: silently deleting
    # a user's previous audition WAVs would be a destructive surprise
    stale_wavs = sorted(glob.glob(os.path.join(tmp, "save*.wav")))
    if stale_wavs:
        notice = (
            f"[compare] clearing {len(stale_wavs)} stale audition WAV(s) "
            f"from {tmp} (they would corrupt the score table): "
            + ", ".join(os.path.basename(s) for s in stale_wavs[:8])
            + (" …" if len(stale_wavs) > 8 else "")
        )
        if verbose:
            print(notice)
        else:
            # verbose=False silences diagnostics, but a deletion must
            # never be fully silent — route it through the warnings
            # machinery, which callers can filter explicitly.
            import warnings

            warnings.warn(notice, stacklevel=2)
    for stale in stale_wavs:
        os.remove(stale)

    def _artifact_stage(ckpt: str) -> int:
        """Render each run-directory checkpoint at its recorded growth
        stage (a mid-growth save rendered at the top stage would push
        random untrained blocks).  Reference ``.pt`` files are fully grown
        by the reference's own convention."""
        if os.path.isfile(ckpt) and ckpt.endswith(".pt"):
            return cfg.n_stages - 1
        from .train.checkpoint import resolve_checkpoint

        root, save_idx = resolve_checkpoint(ckpt)
        with open(os.path.join(root, f"save_{save_idx}", "meta.json")) as f:
            meta = json.load(f)
        return min(int(meta["grower"]["curr_grow"]), cfg.n_stages - 1)

    z = generate_mod.latents(cfg, nb_vec, seeds, seed, device)
    if verbose:
        print("artifacts under comparison:")
        for i, ckpt in enumerate(ckpts):
            print(f"  save {i:3d} = {ckpt}")

    try:
        for i, ckpt in enumerate(ckpts):
            stage_dir = os.path.join(tmp, f"_render_{i}")
            paths = generate_mod.generate(
                stage_dir, cfg.rand_channels, ckpt,
                nb_vec=nb_vec, nb_music=seeds, z=z,
                stage=_artifact_stage(ckpt), model_cfg=cfg, device=device,
            )
            for s, p in enumerate(paths):
                shutil.move(p, os.path.join(tmp, f"save{i:03d}_ID{s}.wav"))
            shutil.rmtree(stage_dir, ignore_errors=True)

        results = score_auditions(tmp, corpus_dir, json_out=None,
                                  verbose=verbose,
                                  holdout_frac=holdout_frac,
                                  holdout_dir=holdout_dir,
                                  holdout_seed=holdout_seed)
        results["artifacts"] = {str(i): c for i, c in enumerate(ckpts)}
        if json_out:
            with open(json_out, "w") as f:
                json.dump(results, f, indent=1)
        return results
    finally:
        if out_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# audition (checkpoint -> WAVs)


def spectral_flatness(w: np.ndarray, sample_rate: int) -> float:
    """Geometric/arithmetic spectral-mean ratio over 50 Hz-5 kHz (the
    tonality proxy: ~0 = tonal, ~1 = white noise)."""
    spec = np.abs(np.fft.rfft(np.asarray(w, np.float64)))
    freqs = np.fft.rfftfreq(len(w), 1.0 / sample_rate)
    band = spec[(freqs >= 50) & (freqs <= 5000)] + 1e-12
    return float(np.exp(np.mean(np.log(band))) / np.mean(band))


def audition_run(
    run_dir: str,
    out_dir: str | None = None,
    seeds: int = 2,
    nb_vec: int = 2,
    saves: list[int] | None = None,
    raw_weights: bool = False,
    verbose: bool = True,
    model_cfg=None,
    device=None,
) -> str:
    """Render ``seeds`` WAVs (+ a summary JSON) from every checkpoint of
    ``run_dir`` (a run directory of this package's ``train``) at the stage
    each was saved at; returns the output dir.

    Uses the EMA generator copy when the checkpoint carries one (the
    eval-grade weights, as ``generate.load_generator_params`` does;
    ``raw_weights=True`` auditions the raw parameters instead).
    """
    from . import generate as generate_mod
    from .audio.io import save_wav
    from .config import AudioConfig, ModelConfig
    from .device import resolve_device
    from .train.checkpoint import CheckpointManager
    from .train.step import init_train_state
    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()  # kernels built once serve repeated auditions
    device = resolve_device(device)
    mgr = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    saves = saves if saves is not None else mgr.saved_indices()
    out_dir = out_dir or os.path.join(run_dir, "audition")
    os.makedirs(out_dir, exist_ok=True)

    cfg = model_cfg if model_cfg is not None else ModelConfig()
    audio_cfg = AudioConfig()
    template = init_train_state(0, cfg, device=device)
    z = generate_mod.latents(cfg, nb_vec, seeds, 1234, device)

    for k in saves:
        state, meta = mgr.restore(k, template, load_rng=False)
        stage = min(int(meta["grower"]["curr_grow"]), cfg.n_stages - 1)
        ema = bool(meta.get("has_ema")) and not raw_weights
        if ema:
            state.gen.load_state_dict(state.gen_ema)
        waves = generate_mod.synthesize_fn(cfg, stage)(state.gen, z).cpu().numpy()
        flats = []
        for s, w in enumerate(waves):
            p = os.path.join(out_dir, f"save{k:03d}_s{stage}_seed{s}.wav")
            save_wav(p, w, audio_cfg.sample_rate)
            rms = float(np.sqrt(np.mean(np.square(w, dtype=np.float64))))
            flats.append(spectral_flatness(w, audio_cfg.sample_rate))
            if verbose:
                print(f"{p}  iter={meta.get('iter_idx')} stage={stage} "
                      f"len={len(w) / audio_cfg.sample_rate:.1f}s "
                      f"rms={rms:.4f} flatness={flats[-1]:.3f}",
                      flush=True)
        with open(os.path.join(out_dir, f"save{k:03d}.json"), "w") as f:
            json.dump({"save": k, "stage": stage,
                       "iter": int(meta.get("iter_idx", -1)),
                       "flatness": flats, "ema": ema}, f)
    return out_dir
