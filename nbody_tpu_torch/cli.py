"""Command-line interface of the port: ``nbody-torch`` or
``python -m nbody_tpu_torch.cli``.

The reference's flags that the port's first slice runs
(nbody.cpp:275-285): --benchmark, --compare / --qatest, --numbodies,
-i/--iterations, --blockSize, --hostmem, --cpu, --tipsy, plus --seed and
--variant. Other nbody_tpu flags are not accepted until their slice lands
(ROADMAP.md).

Modes:
* --benchmark            timed run; prints interactions/s and GFLOP/s
* --compare / --qatest   one-step QA against the CPU oracle; exit code = !passed

The run is on the CUDA card; --cpu selects the plain PyTorch path on the
host, and nothing else does: without --cpu and without a card the run fails.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nbody-torch",
        description="All-pairs N-body simulator on an NVIDIA GPU (PyTorch + CUDA)",
    )
    p.add_argument("--benchmark", action="store_true", help="run the timed benchmark")
    p.add_argument("--compare", action="store_true",
                   help="compare one device step against the CPU oracle")
    p.add_argument("--qatest", action="store_true", help="alias of --compare")
    p.add_argument("--numbodies", type=int, default=None,
                   help="number of bodies (default 4 * blockSize * SM count "
                        "on the card, 4096 with --cpu)")
    p.add_argument("-i", "--iterations", type=int, default=10,
                   help="benchmark iterations (default 10)")
    p.add_argument("--blockSize", type=int, default=None, dest="block_size",
                   help="threads per block of the CUDA kernel, and j-bodies "
                        "per shared-memory tile (default 256)")
    p.add_argument("--hostmem", action="store_true",
                   help="keep the state in pinned host memory, copied to "
                        "the card once per call")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch path on the host CPU")
    p.add_argument("--tipsy", type=str, default=None, help="load a tipsy galaxy file")
    p.add_argument("--seed", type=int, default=42, help="initial-condition RNG seed")
    p.add_argument("--variant", choices=["auto", "vpu"], default="auto",
                   help="force kernel: vpu = the one-sided all-pairs kernel; "
                        "auto resolves to it")
    return p


def main(argv=None) -> int:
    """Entry point with the reference's exit codes (nbody.cpp:396-408):
    0 ok / QA pass, 1 QA fail, 2 usage or configuration error, 3 runtime
    error."""
    try:
        return _main(argv)
    except (ValueError, KeyError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:
        print(f"runtime error: {e}", file=sys.stderr)
        return 3


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.benchmark or args.compare or args.qatest):
        raise ValueError("choose --benchmark or --compare/--qatest (the demo "
                         "loop comes with ROADMAP.md Queue 1 #9)")

    import numpy as np
    import torch

    from nbody_tpu_torch.compute import Compute

    tipsy_state = None
    if args.tipsy:
        from nbody_tpu.io import read_tipsy_file

        tpos, tvel = read_tipsy_file(args.tipsy)
        tipsy_state = (tpos.astype(np.float32), tvel.astype(np.float32))
        print(f"Read {tipsy_state[0].shape[0]} bodies from {args.tipsy}")

    compute = Compute(
        num_bodies=args.numbodies,
        device="cpu" if args.cpu else "cuda",
        block_size=args.block_size,
        placement="host" if args.hostmem else "device",
        variant=args.variant,
        seed=args.seed,
        tipsy_state=tipsy_state,
    )
    system = compute.system
    where = (torch.cuda.get_device_name(system.device)
             if system.device.type == "cuda" else "cpu")
    print(f"nbody_tpu_torch: {compute.num_bodies} bodies on {where} "
          f"[{system.backend} kernel"
          + (", host memory" if args.hostmem else "") + ", fp32]")

    if args.benchmark:
        compute.run_benchmark(args.iterations)
        return 0
    return 0 if compute.compare_results() else 1


if __name__ == "__main__":
    sys.exit(main())
