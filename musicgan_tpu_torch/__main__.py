"""CLI of the PyTorch port (the ``generate`` subcommand of
``musicgan_tpu/__main__.py``, plus ``--device``).

    python -m musicgan_tpu_torch generate CKPT.pt 32 -o /out [-n 10] [-m 5] \\
        [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("musicgan_tpu_torch")
    sub = parser.add_subparsers(dest="mode", required=True)

    p = sub.add_parser("generate", help="sample latents -> WAV files")
    p.add_argument("gen_dict_state", type=str, help="reference gen_*.pt")
    p.add_argument("rand_channels", type=int)
    p.add_argument("-n", "--nb-vec", type=int, default=10)
    p.add_argument("-m", "--nb-music", type=int, default=5)
    p.add_argument("-o", "--output-dir", type=str, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--device", type=str, default="cuda",
        help="'cuda' (default; the hand-written kernels) or 'cpu' (their "
             "plain PyTorch versions)")

    args = parser.parse_args(argv)
    if args.mode == "generate":
        from .generate import generate

        paths = generate(
            args.output_dir,
            args.rand_channels,
            args.gen_dict_state,
            nb_vec=args.nb_vec,
            nb_music=args.nb_music,
            seed=args.seed,
            device=args.device,
        )
        print("\n".join(paths))


if __name__ == "__main__":
    main()
