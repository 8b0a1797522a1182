"""CLI of the PyTorch port: the ``create_dataset``, ``train``,
``generate``, ``view_audio``, ``serve``, ``eval``, ``compare``, ``export``,
``import`` and ``info`` subcommands of ``musicgan_tpu/__main__.py``; every
one that builds tensors takes ``--device``.

    python -m musicgan_tpu_torch create_dataset "/data/*.wav" -o /data/ds [-w N]
    python -m musicgan_tpu_torch train RUN -i DATASET_DIR -o OUT_DIR \\
        [--resume] [--max-iters N] [--batch-size 6] ... [--max-restarts N] \\
        [--compute-dtype float32|bfloat16|bfloat16_f32gp] \\
        [--profile TRACE_DIR] [--debug-nans] [--device cuda|cpu] \\
        [--coordinator HOST:PORT --num-processes N --process-id I]
    python -m musicgan_tpu_torch generate CKPT 32 -o /out [-n 10] [-m 5] \\
        [--seed 0] [--conv-impl IMPL] [--device cuda|cpu]
    python -m musicgan_tpu_torch view_audio --input-audio a.wav --image-idx 0
    python -m musicgan_tpu_torch serve CKPT --port 8765
    python -m musicgan_tpu_torch eval RUN_DIR --corpus /data/wav
    python -m musicgan_tpu_torch compare A.pt RUN_DIR --corpus /data/wav
    python -m musicgan_tpu_torch export RUN_DIR -o gen.pt | -o REF_DIR --full
    python -m musicgan_tpu_torch import REF_DIR I -o RUN_DIR [--iter N]
    python -m musicgan_tpu_torch info

``create_dataset`` runs on the host only and takes no ``--device``.
``--conv-impl`` (``ModelConfig.conv_impl``, any of the JAX package's names):
``auto`` (default: measured per shape on the card and persisted in
``$MUSICGAN_AUTOTUNE_DIR/conv_autotune.json``, ``xla`` on the CPU),
``pallas_up`` (conv + up-conv kernels), ``pallas_block`` (the whole-block
kernel where it fits), ``pallas`` (conv, up2x, conv), any of them with
``_bf16``, ``xla`` / ``subpixel`` (the library lowerings) or
``pallas_train`` / ``pallas_gp`` (the trainable kernels).  ``train`` and
``serve`` run ``auto``; the train step measures the four train impls at
each stage's first step.  Every subcommand but ``create_dataset`` builds its
kernels into ``musicgan_tpu_torch/_build/`` on a GPU host
(``MUSICGAN_COMPILE_CACHE`` elsewhere, ``MUSICGAN_NO_COMPILE_CACHE=1`` a
temporary directory of the process).  ``info`` prints the versions, the
devices, the native host tail and the autotune table as JSON.

``CKPT`` is a reference ``gen_*.pt`` file or a run directory of ``train``
(or its ``checkpoints`` or a ``save_N`` directory).  ``train`` exits 75
(EX_TEMPFAIL) after a SIGTERM/SIGUSR1 preemption, with a checkpoint
flushed: run it again with ``--resume``, or let ``--max-restarts N`` do it.
``export --full`` writes the reference Saver's four files (weights and Adam
state); ``import`` turns such a save (the reference's, or one the JAX
package exported) into a run directory that ``train --resume`` continues.
``train --coordinator HOST:PORT --num-processes N --process-id I`` is one
rank of a data-parallel run: start one such process a card (rank ``I``
takes card ``I % device_count``), each with the same other arguments;
``--max-restarts`` supervises each rank and passes the flags on.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence

from .config import COMPUTE_DTYPES, CONV_IMPLS

_DEVICE_HELP = (
    "'cuda' (default; the hand-written kernels) or 'cpu' (their plain "
    "PyTorch versions)"
)


def _add_holdout_args(p: argparse.ArgumentParser) -> None:
    """Held-out scoring axis, shared by ``eval`` and ``compare``: the
    training-corpus score alone cannot tell memorization from
    generalization."""
    p.add_argument(
        "--holdout-frac", type=float, default=0.0,
        help="deterministically hold out this fraction of corpus tracks "
             "and report nearest-held-out distance + gap beside the "
             "training-corpus score")
    p.add_argument(
        "--holdout-dir", type=str, default=None,
        help="directory of WAV tracks the generator never trained on "
             "(scored as the held-out reference; mutually exclusive "
             "with --holdout-frac)")
    p.add_argument(
        "--holdout-seed", type=int, default=17,
        help="seed for the --holdout-frac track split")


def supervised_command(argv: Sequence[str], attempt: int) -> list[str]:
    """The child command of ``train --max-restarts N`` at ``attempt`` (0 =
    the first run): ``argv`` (the parent's arguments, subcommand first)
    less ``--max-restarts N`` / ``--max-restarts=N``, plus ``--stall-timeout
    900`` where unset, plus ``--resume`` from attempt 1 on."""
    child, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--max-restarts":
            skip = True
        elif not a.startswith("--max-restarts="):
            child.append(a)
    if not any(a == "--stall-timeout" or a.startswith("--stall-timeout=") for a in child):
        child += ["--stall-timeout", "900"]
    if attempt > 0 and "--resume" not in child:
        child.append("--resume")
    return [sys.executable, "-m", "musicgan_tpu_torch", *child]


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser("musicgan_tpu_torch")
    sub = parser.add_subparsers(dest="mode", required=True)

    p = sub.add_parser("create_dataset", help="WAVs -> packed spectrogram shards")
    p.add_argument("audio_path", type=str, help="can be /path/to/*.wav")
    p.add_argument("-o", "--output-dir", type=str, required=True)
    p.add_argument("-w", "--num-workers", type=int, default=None)
    p.add_argument("--samples-per-shard", type=int, default=128)

    # allow_abbrev=False: the supervisor re-invokes this command minus the
    # exact '--max-restarts' token; an abbreviated spelling (--max-restart)
    # would survive the strip and nest supervisors recursively.
    p = sub.add_parser("train", help="progressive WGAN-GP training", allow_abbrev=False)
    p.add_argument("run", type=str, metavar="RUN_NAME")
    p.add_argument("-o", "--out-path", dest="out_path", type=str, required=True)
    p.add_argument("-i", "--input-dataset", dest="input_dataset", type=str,
                   required=True)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in out-path")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--nb-epoch", type=int, default=None)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--max-stage", type=int, default=None,
                   help="cap growth (e.g. 3 => 32x32)")
    p.add_argument("--save-every", type=int, default=None)
    p.add_argument("--log-every", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--compute-dtype", type=str, default=None,
                   choices=list(COMPUTE_DTYPES),
                   help="bfloat16: bf16 conv operands (parameters and Adam "
                        "stay float32); bfloat16_f32gp: the same with the "
                        "gradient penalty in float32")
    p.add_argument("--device-dataset", type=str, default=None,
                   choices=["auto", "on", "off"],
                   help="corpus resident in device memory, indices per step "
                        "(auto: when it fits the byte budget)")
    p.add_argument("--drift-eps", type=float, default=None,
                   help="ProGAN eps-drift penalty on E[D(real)^2] "
                        "(0 = reference-faithful)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="generator weight EMA for preview/generate "
                        "(0 = reference-faithful)")
    p.add_argument("--chunk-steps", type=int, default=None,
                   help="iterations per chunked step call")
    p.add_argument("--tb-dir", type=str, default=None, metavar="LOG_DIR",
                   help="also write metrics to a TensorBoard event log")
    p.add_argument("--mlflow-uri", type=str, default=None, metavar="URI",
                   help="also log params+metrics to an MLflow tracking "
                        "store (requires the mlflow package)")
    p.add_argument("--profile", type=str, default=None, metavar="TRACE_DIR",
                   help="capture a torch.profiler trace of the run "
                        "(TRACE_DIR/trace.json)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise at the first kernel that outputs a "
                        "non-finite value (one sync a launch)")
    # multi-process bring-up (torch.distributed, one process a card)
    p.add_argument("--coordinator", type=str, default=None,
                   help="coordinator address host:port for multi-host runs")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--stall-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="abort (exit 75) when no device progress is seen "
                        "for this long; pairs with --max-restarts "
                        "(default: 900 when --max-restarts is set, else off)")
    p.add_argument("--max-restarts", type=int, default=0, metavar="N",
                   help="supervise the run: relaunch up to N times with "
                        "--resume when it exits 75 (stall watchdog, "
                        "preemption) or dies on a signal; other failures "
                        "are not retried")
    p.add_argument("--device", type=str, default="cuda", help=_DEVICE_HELP)

    p = sub.add_parser("generate", help="sample latents -> WAV files")
    p.add_argument("gen_dict_state", type=str,
                   help="run / checkpoint directory of train, or reference gen_*.pt")
    p.add_argument("rand_channels", type=int)
    p.add_argument("-n", "--nb-vec", type=int, default=10)
    p.add_argument("-m", "--nb-music", type=int, default=5)
    p.add_argument("-o", "--output-dir", type=str, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--conv-impl", type=str, default="auto", choices=CONV_IMPLS,
                   help="'auto' (default: measured per shape on the card and "
                        "persisted; 'xla' on the CPU), 'pallas_up' (conv + up-conv "
                        "kernels), 'pallas_block' (the whole-block kernel where it "
                        "fits), 'pallas' (conv, up2x, conv), '_bf16' the same in bf16, "
                        "'xla' / 'subpixel' (the library lowerings), 'pallas_train' / "
                        "'pallas_gp' (the trainable kernels)")
    p.add_argument("--device", type=str, default="cuda", help=_DEVICE_HELP)

    p = sub.add_parser("view_audio", help="WAV -> magnitude/phase images")
    p.add_argument("--input-audio", type=str, required=True)
    p.add_argument("--image-idx", type=int, required=True)
    p.add_argument("-o", "--output-dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help=_DEVICE_HELP)

    p = sub.add_parser("serve", help="long-running synthesis HTTP server (generator resident)")
    p.add_argument("gen_ckpt", type=str,
                   help="run / checkpoint directory of train, or reference gen_*.pt")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--rand-channels", type=int, default=None)
    p.add_argument("--max-batch", type=int, default=8,
                   help="micro-batch cap per dispatch")
    p.add_argument("--window-ms", type=float, default=10.0,
                   help="micro-batching collection window")
    p.add_argument("--stage", type=int, default=7)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help=_DEVICE_HELP)

    p = sub.add_parser("eval", help="audition a run's checkpoints and score them against a corpus")
    p.add_argument("run_dir", type=str, help="training output dir (contains checkpoints/)")
    p.add_argument("--corpus", type=str, default=None,
                   help="directory of corpus WAV tracks; when given, score "
                        "each checkpoint's corpus-likeness + diversity "
                        "after rendering")
    p.add_argument("-o", "--out-dir", type=str, default=None,
                   help="audition output dir (default RUN_DIR/audition)")
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--nb-vec", type=int, default=2)
    p.add_argument("--saves", type=str, default=None,
                   help="comma-separated save indices (default: all)")
    p.add_argument("--raw-weights", action="store_true",
                   help="audition raw generator weights even when the "
                        "checkpoint carries an EMA copy")
    p.add_argument("--json-out", type=str, default=None,
                   help="write the score table as JSON (requires --corpus)")
    _add_holdout_args(p)
    p.add_argument("--device", type=str, default="cuda", help=_DEVICE_HELP)

    p = sub.add_parser(
        "compare",
        help="head-to-head artifact scoring: render the SAME latents "
             "through each checkpoint/.pt and score all against a corpus",
    )
    p.add_argument("ckpts", nargs="+",
                   help="two or more artifacts: reference gen_*.pt files "
                        "or run / checkpoint directories of train")
    p.add_argument("--corpus", type=str, required=True,
                   help="directory of corpus WAV tracks")
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--nb-vec", type=int, default=2)
    p.add_argument("--latent-seed", type=int, default=1234,
                   help="latent RNG seed (same latents for every artifact)")
    p.add_argument("-o", "--out-dir", type=str, default=None,
                   help="keep the rendered WAVs here (default: temp dir)")
    p.add_argument("--json-out", type=str, default=None)
    _add_holdout_args(p)
    p.add_argument("--device", type=str, default="cuda", help=_DEVICE_HELP)

    p = sub.add_parser("export", help="export a trained generator as a reference-format .pt")
    p.add_argument("ckpt", type=str, help="run / checkpoint directory of train (single-file "
                                          "export: also a reference gen_*.pt)")
    p.add_argument("-o", "--output", type=str, required=True)
    p.add_argument("--stage", type=int, default=7,
                   help="growth stage for a single-.pt export (ignored "
                        "with --full, which uses the checkpoint's "
                        "recorded stage)")
    p.add_argument("--full", action="store_true",
                   help="write the reference Saver's complete four-file "
                        "save (gen/disc/optim_gen/optim_disc _{i}.pt, "
                        "reference utils.py:118-145) into the OUTPUT "
                        "directory: weights AND Adam state")
    p.add_argument("--save-idx", type=int, default=None,
                   help="index i in the exported file names (--full; "
                        "default: the source checkpoint's save index)")
    p.add_argument("--device", type=str, default="cuda", help=_DEVICE_HELP)

    p = sub.add_parser(
        "import",
        help="convert a reference save directory (the four *_{i}.pt files) "
             "into a run dir that `train -o DIR --resume` continues: "
             "weights, Adam moments and per-param step counts included",
    )
    p.add_argument("ref_dir", type=str,
                   help="directory holding gen_{i}.pt / disc_{i}.pt / "
                        "optim_gen_{i}.pt / optim_disc_{i}.pt")
    p.add_argument("save_idx", type=int, help="reference save index i")
    p.add_argument("-o", "--output", type=str, required=True,
                   help="run directory to create (gets checkpoints/save_0)")
    p.add_argument("--iter", type=int, default=None,
                   help="iteration counter to resume at (default: "
                        "save_idx * 1000, the reference's save cadence)")
    p.add_argument("--device", type=str, default="cuda",
                   help=_DEVICE_HELP + "; resume on the same kind of device")

    sub.add_parser("info", help="versions, devices, native host tail and autotune table as JSON")

    args = parser.parse_args(argv)
    if args.mode != "create_dataset":  # ingest never builds a kernel
        from .utils.cache import enable_compilation_cache

        enable_compilation_cache()

    if args.mode == "create_dataset":  # host only: ingest never touches a device
        from .audio.ingest import create_dataset

        index = create_dataset(
            args.audio_path,
            args.output_dir,
            num_workers=args.num_workers,
            samples_per_shard=args.samples_per_shard,
        )
        print(
            f"wrote {index['total_samples']} samples in "
            f"{len(index['shards'])} shards to {args.output_dir}"
        )
        for path, err in index["errors"]:
            print(f"  ERROR {path}: {err}")

    elif args.mode == "train":
        if args.max_restarts > 0:
            # Become the supervisor: re-invoke this same command as a
            # child and retry stall-watchdog exits / signal deaths.
            import functools

            from .utils.supervise import run_supervised

            raise SystemExit(run_supervised(
                functools.partial(supervised_command, argv), args.max_restarts
            ))

        import contextlib

        from .config import train_config_from_overrides
        from .parallel import mesh as pmesh
        from .train import train
        from .train.loop import PREEMPTED
        from .utils.profiling import enable_debug_mode, trace
        from .utils.watchdog import EXIT_STALLED

        # Before anything touches the card: the rank takes its own.
        pmesh.initialize_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            device=args.device,
        )
        if args.debug_nans:
            enable_debug_mode(nans=True)
        cfg = train_config_from_overrides(
            batch_size=args.batch_size,
            nb_epoch=args.nb_epoch,
            max_stage=args.max_stage,
            save_every=args.save_every,
            log_every=args.log_every,
            seed=args.seed,
            compute_dtype=args.compute_dtype,
            chunk_steps=args.chunk_steps,
            drift_eps=args.drift_eps,
            ema_decay=args.ema_decay,
            device_dataset=args.device_dataset,
            stall_timeout_s=args.stall_timeout,
            tb_dir=args.tb_dir,
            mlflow_uri=args.mlflow_uri,
        )
        with trace(args.profile) if args.profile else contextlib.nullcontext():
            train(
                args.run,
                args.input_dataset,
                args.out_path,
                train_cfg=cfg,
                resume=args.resume,
                max_iters=args.max_iters,
                device=args.device,
            )
        # The ranks leave together (a preempted run stopped at one agreed
        # boundary on all of them).
        pmesh.host_barrier()
        pmesh.shutdown_distributed()
        if PREEMPTED.is_set():
            # SIGTERM/SIGUSR1 preemption: the loop flushed a checkpoint
            # and stopped early; exit EX_TEMPFAIL so schedulers treat this
            # run as retryable.
            raise SystemExit(EXIT_STALLED)

    elif args.mode == "generate":
        import dataclasses

        from .config import ModelConfig
        from .generate import generate

        paths = generate(
            args.output_dir,
            args.rand_channels,
            args.gen_dict_state,
            nb_vec=args.nb_vec,
            nb_music=args.nb_music,
            seed=args.seed,
            model_cfg=dataclasses.replace(
                ModelConfig(), rand_channels=args.rand_channels, conv_impl=args.conv_impl
            ),
            device=args.device,
        )
        print("\n".join(paths))

    elif args.mode == "view_audio":
        from .view_audio import view_audio

        for p_ in view_audio(
            args.input_audio, args.image_idx, output_dir=args.output_dir, device=args.device
        ):
            print(p_)

    elif args.mode == "serve":
        from .config import ModelConfig
        from .serve import serve

        serve(
            args.gen_ckpt,
            host=args.host,
            port=args.port,
            rand_channels=(
                ModelConfig.rand_channels if args.rand_channels is None else args.rand_channels
            ),
            max_batch=args.max_batch,
            window_ms=args.window_ms,
            stage=args.stage,
            warmup=not args.no_warmup,
            device=args.device,
        )

    elif args.mode == "eval":
        if args.json_out and not args.corpus:
            parser.error("eval: --json-out requires --corpus (scores are "
                         "corpus-referenced; without a corpus no JSON is "
                         "produced)")
        from .evaluate import audition_run, score_auditions

        out = audition_run(
            args.run_dir,
            out_dir=args.out_dir,
            seeds=args.seeds,
            nb_vec=args.nb_vec,
            saves=([int(s) for s in args.saves.split(",")] if args.saves else None),
            raw_weights=args.raw_weights,
            device=args.device,
        )
        if args.corpus:
            score_auditions(
                out, args.corpus, json_out=args.json_out,
                holdout_frac=args.holdout_frac,
                holdout_dir=args.holdout_dir,
                holdout_seed=args.holdout_seed,
            )

    elif args.mode == "compare":
        from .evaluate import compare_artifacts

        compare_artifacts(
            args.ckpts, args.corpus, seeds=args.seeds, nb_vec=args.nb_vec,
            seed=args.latent_seed, out_dir=args.out_dir,
            json_out=args.json_out,
            holdout_frac=args.holdout_frac,
            holdout_dir=args.holdout_dir,
            holdout_seed=args.holdout_seed,
            device=args.device,
        )

    elif args.mode == "export":
        from .config import ModelConfig, TrainConfig

        model_cfg = ModelConfig()
        if args.full:
            from .models.torch_ingest import export_reference_save
            from .train.checkpoint import CheckpointManager, resolve_checkpoint
            from .train.step import init_train_state

            root, save_idx = resolve_checkpoint(args.ckpt)
            template = init_train_state(0, model_cfg, device=args.device)
            state, meta = CheckpointManager(root).restore(save_idx, template, load_rng=False)
            stage = min(int(meta["grower"]["curr_grow"]), model_cfg.n_stages - 1)
            # Adam's hyperparameters ride the exported param groups: the
            # RUN's recorded values, not the defaults (a 5e-4 run exported
            # at lr=1e-3 would silently retrain at 2x lr in the reference).
            tc, defaults = meta.get("train_cfg") or {}, TrainConfig()
            out_idx = args.save_idx if args.save_idx is not None else save_idx
            print(f"exporting save_{save_idx} at stage {stage} (from checkpoint meta; "
                  "--stage applies to single-.pt exports only)")
            paths = export_reference_save(
                state, args.output, out_idx, stage=stage, cfg=model_cfg,
                gen_lr=float(tc.get("gen_lr", defaults.gen_lr)),
                disc_lr=float(tc.get("disc_lr", defaults.disc_lr)),
                betas=tuple(tc.get("betas", defaults.betas)),
            )
            for p_ in paths:
                print(p_)
        else:
            from .generate import load_generator_params
            from .models.torch_ingest import export_reference_generator

            gen = load_generator_params(args.ckpt, model_cfg, device=args.device)
            export_reference_generator(gen, args.output, stage=args.stage, cfg=model_cfg)
            print(args.output)

    elif args.mode == "import":
        from .models.torch_ingest import import_reference_run

        _, stage = import_reference_run(
            args.ref_dir, args.save_idx, args.output, iter_idx=args.iter, device=args.device
        )
        print(
            f"{args.output}/checkpoints/save_0 (stage {stage}): continue with: "
            f"python -m musicgan_tpu_torch train RUN -i DATASET -o {args.output} --resume"
        )


    elif args.mode == "info":
        print(json.dumps(info(), indent=1))


def info() -> dict:
    """What ``info`` prints: versions, the devices, the native host tail and
    the persisted autotune table.

    Device enumeration can block for ever on a wedged card (the CUDA runtime
    has no timeout there), and ``info`` is the tool a user reaches for when
    the device misbehaves: so the probe runs in a daemon thread and a hang
    is reported as such instead of becoming one.  A host without a GPU is
    reported, not refused."""
    import platform
    import threading

    import torch

    from . import native
    from .ops import autotune
    from .parallel import mesh as pmesh

    dev: dict = {}

    def probe():
        found = torch.cuda.is_available()
        dev["backend"] = "cuda" if found else "cpu"
        dev["devices"] = (
            [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if found else ["cpu"]
        )
        dev["process_count"] = pmesh.process_count()

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout=60.0)
    if t.is_alive():
        dev = {
            "backend": "UNRESPONSIVE (device init exceeded 60s: a wedged card?)",
            "devices": [],
            "process_count": None,
        }
    return {
        "python": platform.python_version(),
        "torch": torch.__version__,
        **dev,
        "native_ingest": native.is_available(),
        "native_lib": native.lib_path() if native.is_available() else None,
        "autotune_cache": autotune._load_persisted(),
    }


if __name__ == "__main__":
    main()
