"""Command-line interface of the port: ``nbody-torch`` or
``python -m nbody_tpu_torch.cli``.

The reference's flags that the port's slices run so far
(nbody.cpp:275-285): --benchmark, --compare / --qatest, --numbodies,
-i/--iterations, --blockSize, --hostmem, --cpu, --tipsy, --fp64, plus
nbody_tpu's --seed, --variant {auto,vpu,sym,mxu,mxu_bf16}, --integrator
{euler,leapfrog,hermite}, --drift-check, --precision {fp32,fp64,ds} and the
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

--fp64 (or --precision fp64) runs in double precision on the double
all-pairs kernels, with Euler, leapfrog or Hermite; its QA holds the
positions to 5e-4 and the force (with Hermite also the jerk) to the float64
oracle at 1e-10 of its largest value, and its --drift-check keeps the fp32
gate. --variant auto, vpu, mxu and mxu_bf16 run the one-sided double kernels
(nbody_tpu's fp64 XLA path ignores the variant); sym, --kernel p3m and
--devices D > 1 are refused in fp64. --fp64 with --precision ds exits 1, in
nbody_tpu's words (cli.py:449-453).

--precision ds runs the double-single (fp64-grade) kernels, default N 16384
(BASELINE.json configs[2]), with Euler, leapfrog or Hermite, QA against the
float64 oracle at |dpos| <= 1e-10 and the force (and with Hermite the jerk)
at 1e-10 of its largest value. Like nbody_tpu's ds measurement modes it
runs without --hostmem, --kernel and a --variant other than auto or sym
(vpu, mxu and mxu_bf16 run the ds default), and prints one line for each
such flag that has no effect.

--kernel p3m runs the P3M fast mode (PM long range + exact short range on
the CUDA pair kernel), Euler or leapfrog, fp32: its QA gates positions only
and its --drift-check is reported, not gated, as in nbody_tpu (its force
differs from the all-pairs oracle's by the mesh error, by design).

--devices D shards the bodies over D ranks, one a device, with --strategy
allgather, ring or auto (nbody_tpu's cost model), for fp32 and ds, or
ring_fused (fp32 Euler and leapfrog: all D hops of the ring in one launch of
the fused ring kernel, the ranks on one host; the plain ring with --cpu):
start it as ``torchrun --nproc_per_node D nbody-torch --devices D ...``
(NCCL on the cards, gloo with --cpu). --devices 1 builds no mesh, as in
nbody_tpu. A --devices that differs from the number of ranks exits 2; so do
--strategy ring_fused with --precision ds (nbody_tpu's text), and
--mesh-rows and --strategy sym, which are not ported yet. Only rank 0
prints; every rank exits with rank 0's verdict.

The run is on the CUDA card; --cpu selects the plain PyTorch path on the
host, and nothing else does: without --cpu and without a card the run fails.
"""

from __future__ import annotations

import argparse
import os
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
    p.add_argument("--fp64", action="store_true",
                   help="double precision: the double all-pairs kernels, every integrator")
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
    p.add_argument("--precision", choices=["fp32", "fp64", "ds"], default=None,
                   help="fp32 (default); fp64 (= --fp64), the double all-pairs kernels; "
                        "or ds, the double-single kernels: fp64-grade accuracy from "
                        "pairs of float32s (default N 16384); each with every integrator")
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
    p.add_argument("--devices", type=int, default=None,
                   help="shard bodies over this many devices (a 1-D mesh of ranks, one a "
                        "device; start D ranks with torchrun --nproc_per_node D)")
    p.add_argument("--strategy", choices=["auto", "allgather", "ring", "ring_fused", "sym"],
                   default="auto",
                   help="multi-device communication strategy: allgather (one all-gather, "
                        "one fused kernel), ring (the j-shard travels the ring, a force "
                        "kernel a hop), ring_fused (fp32 Euler and leapfrog: all hops in "
                        "one kernel launch that carries the j-shards itself, the ranks on "
                        "one host), auto (nbody_tpu's cost model by shard size, allgather "
                        "or ring); sym is not ported yet")
    p.add_argument("--mesh-rows", type=int, default=None,
                   help="with --devices D: the 2-D (rows x D/rows) decomposition "
                        "(not ported yet)")
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
    import torch.distributed as dist

    started = dist.is_available() and dist.is_initialized()
    try:
        return _main(argv)
    except (ValueError, KeyError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:
        print(f"runtime error: {e}", file=sys.stderr)
        return 3
    finally:
        if not started and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def _mesh(args):
    """The body mesh of --devices, or None: with D > 1 the ranks' process
    group is started from torchrun's environment, and D must be its size."""
    from nbody_tpu_torch.models.body_system import not_ported

    if args.mesh_rows is not None:
        raise not_ported("--mesh-rows", args.mesh_rows, key="mesh")
    if args.strategy == "sym":
        raise not_ported("--strategy", args.strategy)
    if args.devices is not None and args.devices < 1:
        raise ValueError(f"--devices must be at least 1; got {args.devices}")
    if args.devices is None or args.devices == 1:
        return None
    if args.precision == "ds" and args.strategy not in ("auto", "allgather", "ring"):
        # nbody_tpu/cli.py:283-288
        raise ValueError("the sharded ds step gathers or ring-rotates the hi/lo planes; use "
                         "--strategy auto/allgather/ring (ring_fused and sym are fp32 mesh "
                         "paths)")
    from nbody_tpu_torch.parallel import initialize_multihost, make_mesh

    device = "cpu" if args.cpu else "cuda"
    if "WORLD_SIZE" in os.environ:
        initialize_multihost(device=device)
    return make_mesh(args.devices, device="cpu" if args.cpu else None)


def _ds_ignored_flags(args) -> list:
    """The flags the ds measurement modes run without, as nbody_tpu's
    ``_run_ds`` does (cli.py:454-462, 244-427: its DSBodySystem takes no
    variant, placement or kernel): each is reset to what the ds system runs
    and named in the returned list. --variant sym is kept; vpu, mxu and
    mxu_bf16 run the ds default, as ``Compute(precision="ds")`` maps them."""
    ignored = []
    if args.variant not in ("auto", "sym"):
        ignored.append(f"--variant {args.variant} (the ds default, auto, runs)")
        args.variant = "auto"
    if args.hostmem:
        ignored.append("--hostmem (the ds state stays on the device)")
        args.hostmem = False
    if args.kernel != "auto":
        ignored.append(f"--kernel {args.kernel} (the all-pairs ds kernels run)")
        args.kernel = "auto"
    return ignored


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.benchmark or args.compare or args.qatest or args.drift_check is not None):
        raise ValueError("choose --benchmark, --compare/--qatest or --drift-check "
                         "(the demo loop comes with ROADMAP.md Queue 1 #9)")
    if args.drift_check is not None and args.drift_check < 0:
        raise ValueError(f"--drift-check takes a number of steps >= 0; got {args.drift_check}")
    if args.numbodies is not None and args.numbodies < 1:
        raise ValueError(f"--numbodies must be at least 1; got {args.numbodies}")

    ds = args.precision == "ds"
    if args.precision == "fp64":
        args.fp64 = True
    if ds and args.fp64:
        # nbody_tpu/cli.py:449-453, with its exit code
        print("error: --precision ds and --fp64 are exclusive", file=sys.stderr)
        return 1
    ignored = _ds_ignored_flags(args) if ds else []
    p3m = args.kernel == "p3m"

    import numpy as np
    import torch

    from nbody_tpu_torch.compute import Compute

    mesh = _mesh(args)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)

    for flag in ignored:
        say(f"--precision ds: {flag} has no effect")

    tipsy_state = None
    if args.tipsy:
        from nbody_tpu_torch.io import read_tipsy_file

        tpos, tvel = read_tipsy_file(args.tipsy)
        dtype = np.float64 if ds or args.fp64 else np.float32
        tipsy_state = (tpos.astype(dtype), tvel.astype(dtype))
        say(f"Read {tipsy_state[0].shape[0]} bodies from {args.tipsy}")

    compute = Compute(
        num_bodies=16384 if ds and args.numbodies is None else args.numbodies,
        device="cpu" if args.cpu else "cuda",
        block_size=args.block_size,
        placement="host" if args.hostmem else "device",
        variant=args.variant,
        integrator=args.integrator,
        precision=args.precision,
        fp64=args.fp64,
        kernel=args.kernel,
        pm_grid=args.pm_grid,
        p3m_capacity=args.p3m_capacity,
        seed=args.seed,
        tipsy_state=tipsy_state,
        mesh=mesh,
        strategy=args.strategy,
        log=say,
    )
    system = compute.system
    where = (torch.cuda.get_device_name(system.device)
             if system.device.type == "cuda" else "cpu")
    say(f"nbody_tpu_torch: {compute.num_bodies} bodies on {where}"
        + (f", {mesh.size}-device mesh [{system.strategy}]" if mesh is not None else "")
        + f" [{system.backend} kernel"
        + (", host memory" if args.hostmem else "")
        + (", double-single (fp64-grade)]" if ds else ", fp64]" if args.fp64 else ", fp32]")
        + (f" force p3m (grid {system.pm_grid}, cell capacity {system.p3m_capacity})"
           if p3m else f" force {system.variant}")
        + f", integrator {system.integrator}")

    if args.drift_check is not None:
        drift = compute.drift_check(args.drift_check)
        if p3m:
            # nbody_tpu/cli.py:829-834: the mesh solver's drift differs from
            # the all-pairs oracle's by design, so it is reported, not gated
            say("(mesh-solver drift differs from the all-pairs oracle by design; "
                "exit-code gate applies to exact kernels only)")
            return 0
        if drift_failed(drift):
            say("drift check FAILED", file=sys.stderr)
            return 1
        return 0
    if args.benchmark:
        compute.run_benchmark(args.iterations)
        return 0
    return 0 if compute.compare_results() else 1


if __name__ == "__main__":
    sys.exit(main())
