"""CLI of the PyTorch port: the ``train``, ``generate``, ``view_audio``,
``serve``, ``eval`` and ``compare`` subcommands of
``musicgan_tpu/__main__.py``, each with ``--device``.

    python -m musicgan_tpu_torch train RUN -i DATASET_DIR -o OUT_DIR \\
        [--resume] [--max-iters N] [--batch-size 6] ... [--device cuda|cpu]
    python -m musicgan_tpu_torch generate CKPT 32 -o /out [-n 10] [-m 5] \\
        [--seed 0] [--conv-impl IMPL] [--device cuda|cpu]
    python -m musicgan_tpu_torch view_audio --input-audio a.wav --image-idx 0
    python -m musicgan_tpu_torch serve CKPT --port 8765
    python -m musicgan_tpu_torch eval RUN_DIR --corpus /data/wav
    python -m musicgan_tpu_torch compare A.pt RUN_DIR --corpus /data/wav

``--conv-impl`` (``ModelConfig.conv_impl``): ``pallas_up`` (default),
``pallas_block``, ``pallas``, or any of them with ``_bf16`` (the same
blocks in bf16 through the bf16 kernels).

``CKPT`` is a reference ``gen_*.pt`` file or a run directory of ``train``
(or its ``checkpoints`` or a ``save_N`` directory).  ``train`` exits 75
(EX_TEMPFAIL) after a SIGTERM/SIGUSR1 preemption, with a checkpoint
flushed: run it again with ``--resume``.  The JAX CLI's ``--max-restarts``,
``--profile``, ``--debug-nans`` and multi-host flags are not ported yet
(ROADMAP.md section A items 16 and 17) and are rejected.  Still to port:
``create_dataset`` (A13), ``info`` (with A13 and A15), ``export`` and
``import`` (A18a).
"""

from __future__ import annotations

import argparse

from .config import CONV_IMPLS

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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("musicgan_tpu_torch")
    sub = parser.add_subparsers(dest="mode", required=True)

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
                   choices=["float32", "bfloat16", "bfloat16_f32gp"],
                   help="only float32 is ported; the others raise")
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
    p.add_argument("--stall-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="abort (exit 75) when no device progress is seen "
                        "for this long (default: off)")
    p.add_argument("--device", type=str, default="cuda", help=_DEVICE_HELP)

    p = sub.add_parser("generate", help="sample latents -> WAV files")
    p.add_argument("gen_dict_state", type=str,
                   help="run / checkpoint directory of train, or reference gen_*.pt")
    p.add_argument("rand_channels", type=int)
    p.add_argument("-n", "--nb-vec", type=int, default=10)
    p.add_argument("-m", "--nb-music", type=int, default=5)
    p.add_argument("-o", "--output-dir", type=str, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--conv-impl", type=str, default="pallas_up", choices=CONV_IMPLS,
                   help="'pallas_up' (default: conv + up-conv kernels), 'pallas_block' "
                        "(the whole-block kernel where it fits), 'pallas' (conv, up2x, "
                        "conv); '_bf16' runs the same in bf16")
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

    args = parser.parse_args(argv)
    if args.mode == "train":
        from .config import train_config_from_overrides
        from .train import train
        from .train.loop import PREEMPTED
        from .utils.watchdog import EXIT_STALLED

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
        train(
            args.run,
            args.input_dataset,
            args.out_path,
            train_cfg=cfg,
            resume=args.resume,
            max_iters=args.max_iters,
            device=args.device,
        )
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


if __name__ == "__main__":
    main()
