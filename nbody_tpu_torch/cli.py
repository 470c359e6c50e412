"""Command-line interface of the port: ``nbody-torch`` or
``python -m nbody_tpu_torch.cli``.

The reference's flags that the port's slices run so far
(nbody.cpp:275-285): --benchmark, --compare / --qatest, --numbodies,
-i/--iterations, --blockSize, --hostmem, --cpu, --tipsy, plus nbody_tpu's
--seed, --variant {auto,vpu,sym,mxu,mxu_bf16}, --integrator
{euler,leapfrog,hermite}, --drift-check, --precision {fp32,ds} (fp64 is
parsed, as nbody_tpu parses it, and refused until its slice lands) and the
P3M fast mode's --kernel {auto,p3m}, --pm-grid and --p3m-capacity. Other
nbody_tpu flags are not accepted until their slice lands (ROADMAP.md).

Modes:
* --benchmark            timed run; prints interactions/s and GFLOP/s
* --compare / --qatest   one-step QA against the CPU oracle; exit code = !passed
* --drift-check STEPS    energy drift over STEPS steps on the device and on the
                         CPU oracle; exit code 1 when they differ by more than
                         max(5e-4, 0.05 |oracle drift|) (nbody_tpu/cli.py:838-841)
                         and, with --precision ds, by more than
                         max(1e-9, 1e-7 |oracle drift|) over the first 50 steps
                         (nbody_tpu/cli.py:338-376)

--precision ds runs the double-single (fp64-grade) kernels, default N 16384
(BASELINE.json configs[2]), with Euler, leapfrog or Hermite, QA against the
float64 oracle at |dpos| <= 1e-10 and the force (and with Hermite the jerk)
at 1e-10 of its largest value.

--kernel p3m runs the P3M fast mode (PM long range + exact short range on
the CUDA pair kernel), Euler or leapfrog, fp32: its QA gates positions only
and its --drift-check is reported, not gated, as in nbody_tpu (its force
differs from the all-pairs oracle's by the mesh error, by design).

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
    p.add_argument("--variant", choices=["auto", "vpu", "sym", "mxu", "mxu_bf16"],
                   default="auto",
                   help="force kernel: vpu = the one-sided all-pairs kernel, "
                        "sym = each pair once (Newton's third law); mxu* "
                        "reduce the force on the tensor cores in the Euler "
                        "step (leapfrog and hermite keep the one-sided "
                        "kernels): mxu in f32 grade, mxu_bf16 with bf16 "
                        "operands, which is not faithful to energy (at "
                        "N=4096 its drift fails the --drift-check gate); "
                        "auto = the one measured faster on the card, vpu "
                        "with --cpu")
    p.add_argument("--integrator", choices=["euler", "leapfrog", "hermite"], default="euler",
                   help="damped semi-implicit Euler (the reference's), "
                        "drift-kick-drift leapfrog, or the 4th-order Hermite "
                        "predictor-corrector (two accel+jerk evaluations a step)")
    p.add_argument("--precision", choices=["fp32", "fp64", "ds"], default="fp32",
                   help="fp32 (default) or ds, the double-single kernels: fp64-grade "
                        "accuracy from pairs of float32s (default N 16384), with every "
                        "integrator; fp64 is not ported yet")
    p.add_argument("--kernel", choices=["auto", "p3m"], default="auto",
                   help="force algorithm: auto = the all-pairs kernels of --variant; "
                        "p3m = PM + exact short-range correction, sub-percent "
                        "forces at PM speed, Euler or leapfrog (it does not pass "
                        "--qatest's all-pairs force tolerance by design: its QA "
                        "gates positions only)")
    p.add_argument("--pm-grid", type=int, default=64,
                   help="mesh resolution per axis (--kernel p3m)")
    p.add_argument("--p3m-capacity", type=int, default=None,
                   help="p3m neighbor-cell capacity (bodies per cell); "
                        "default auto-sizes from the initial state's max "
                        "occupancy +50%% headroom; overflow at init raises")
    p.add_argument("--drift-check", type=int, default=None, metavar="STEPS",
                   help="run STEPS steps on the device and on the CPU oracle "
                        "from the same state and compare their energy drifts; "
                        "exit code 1 when they differ beyond the gate")
    return p


def drift_failed(drift: dict) -> bool:
    """The gate of --drift-check (nbody_tpu/cli.py:838-841): the device's
    drift may differ from the oracle's by max(5e-4, 5 % of the oracle's).
    A ds drift check also reports its parity horizon (``horizon_delta``),
    where the drifts must agree to max(1e-9, 1e-7 of the oracle's)
    (nbody_tpu/cli.py:362)."""
    scale = max(abs(drift["drift_oracle"]), 1e-12)
    if "horizon_delta" in drift and drift["horizon_delta"] > max(
            1e-9, 1e-7 * abs(drift["horizon_drift_oracle"])):
        return True
    return drift["delta"] > max(5e-4, 0.05 * scale)


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
    if not (args.benchmark or args.compare or args.qatest or args.drift_check is not None):
        raise ValueError("choose --benchmark, --compare/--qatest or --drift-check "
                         "(the demo loop comes with ROADMAP.md Queue 1 #9)")
    if args.drift_check is not None and args.drift_check < 1:
        raise ValueError(f"--drift-check needs at least 1 step; got {args.drift_check}")

    ds = args.precision == "ds"
    if args.precision == "fp64":
        from nbody_tpu_torch.models.body_system import not_ported

        raise not_ported("--precision", "fp64", key="fp64")
    if ds:
        # the scope of nbody_tpu's ds modes (cli.py:447-495) that concerns
        # the port's slices so far
        if args.hostmem:
            raise ValueError("--precision ds keeps its state on the device (no --hostmem), "
                             "as nbody_tpu does")
        if args.variant not in ("auto", "sym"):
            raise ValueError(f"--precision ds variants are auto/sym (got {args.variant})")
    p3m = args.kernel == "p3m"

    import numpy as np
    import torch

    from nbody_tpu_torch.compute import Compute

    tipsy_state = None
    if args.tipsy:
        from nbody_tpu_torch.io import read_tipsy_file

        tpos, tvel = read_tipsy_file(args.tipsy)
        dtype = np.float64 if ds else np.float32
        tipsy_state = (tpos.astype(dtype), tvel.astype(dtype))
        print(f"Read {tipsy_state[0].shape[0]} bodies from {args.tipsy}")

    compute = Compute(
        num_bodies=args.numbodies or (16384 if ds else None),
        device="cpu" if args.cpu else "cuda",
        block_size=args.block_size,
        placement="host" if args.hostmem else "device",
        variant=args.variant,
        integrator=args.integrator,
        precision=args.precision,
        kernel=args.kernel,
        pm_grid=args.pm_grid,
        p3m_capacity=args.p3m_capacity,
        seed=args.seed,
        tipsy_state=tipsy_state,
    )
    system = compute.system
    where = (torch.cuda.get_device_name(system.device)
             if system.device.type == "cuda" else "cpu")
    print(f"nbody_tpu_torch: {compute.num_bodies} bodies on {where} "
          f"[{system.backend} kernel"
          + (", host memory" if args.hostmem else "")
          + (", double-single (fp64-grade)]" if ds else ", fp32]")
          + (f" force p3m (grid {system.pm_grid}, cell capacity {system.p3m_capacity})"
             if p3m else f" force {system.variant}")
          + f", integrator {system.integrator}")

    if args.drift_check is not None:
        drift = compute.drift_check(args.drift_check)
        if p3m:
            # nbody_tpu/cli.py:829-834: the mesh solver's drift differs from
            # the all-pairs oracle's by design, so it is reported, not gated
            print("(mesh-solver drift differs from the all-pairs oracle by design; "
                  "exit-code gate applies to exact kernels only)")
            return 0
        if drift_failed(drift):
            print("drift check FAILED", file=sys.stderr)
            return 1
        return 0
    if args.benchmark:
        compute.run_benchmark(args.iterations)
        return 0
    return 0 if compute.compare_results() else 1


if __name__ == "__main__":
    sys.exit(main())
