#!/usr/bin/env python3
"""The bits of every double-single (ds) entry point with host-built scalar
blocks, on seeded inputs (chip_smoke.ds_bits): one JSON object of a sha256
(16 hex digits) of each launch's outputs, by launch.

Run from the repository root on a machine with an NVIDIA H100:

    python3 scripts/torch_ds_scal_bits.py [--root DIR]

--root DIR imports DIR's nbody_tpu_torch instead of this checkout's (another
commit unpacked into a directory .gitignore lists, such as compare/parent)
and builds its kernels there: chip_smoke.py's phase 5a holds this checkout's
ds kernels, which read their scalar block from device memory, to the bits
that such a run of the commit before them printed (DS_PARENT_BITS), when
they read it from the host.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=str(ROOT))
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import nbody_tpu_torch

    pkg = pathlib.Path(nbody_tpu_torch.__file__).resolve()
    if not pkg.is_relative_to(root):
        raise SystemExit(f"nbody_tpu_torch imported from {pkg}, not from {root}")
    print(json.dumps(chip_smoke.ds_bits(torch), sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
