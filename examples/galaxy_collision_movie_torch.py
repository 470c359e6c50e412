"""Render a two-galaxy collision as a PNG frame sequence, on the PyTorch /
CUDA port.

The port's counterpart of ``examples/galaxy_collision_movie.py``, on
``nbody_tpu_torch.cli.main`` with the same flags; the equivalent command:

    nbody-torch --config galaxy --numbodies 16384 --frames 120 --render \\
        --camera 0,0,-12 --sprite-size 0.25 --brightness 0.12 \\
        --set time_step=0.004 --steps-per-frame 4 --outdir frames

Runs on the card: ``python examples/galaxy_collision_movie_torch.py
[outdir]``; ``--cpu`` steps and renders on the host. Any other flags go to
the CLI after the example's own, and so override them (the CPU test adds
``--numbodies 256 --frames 2 --width 96 --height 72``).
"""

import argparse

from nbody_tpu_torch.cli import main as cli_main

FLAGS = [
    "--config", "galaxy",
    "--numbodies", "16384",
    "--frames", "120",
    "--steps-per-frame", "4",
    "--no-cycle",
    "--render",
    "--width", "960", "--height", "720",
    "--camera", "0,0,-12",
    "--sprite-size", "0.25",
    "--brightness", "0.12",
    "--set", "time_step=0.004",
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default="galaxy_frames")
    ap.add_argument("--cpu", action="store_true", help="step and render on the host")
    args, rest = ap.parse_known_args(argv)
    return cli_main([*FLAGS, "--outdir", args.outdir, *(["--cpu"] if args.cpu else []), *rest])


if __name__ == "__main__":
    raise SystemExit(main())
