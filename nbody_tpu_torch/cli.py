"""Command-line interface of the port: ``nbody-torch`` or
``python -m nbody_tpu_torch.cli``.

The reference's flags (nbody.cpp:275-285): --benchmark, --compare /
--qatest, --numbodies, -i/--iterations, --blockSize, --hostmem, --cpu,
--tipsy, --fp64, --fullscreen, plus nbody_tpu's --seed, --variant
{auto,vpu,sym,mxu,mxu_bf16}, --integrator {euler,leapfrog,hermite},
--drift-check, --precision {fp32,fp64,ds}, the mesh solvers' --kernel
{auto,pm,p3m}, --pm-grid, --pm-assignment, --pm-fft, --p3m-short-range,
--p3m-capacity and --p3m-auto-refresh, the mesh's --devices, --strategy and
--mesh-rows, the run setup (--config, --demo, --set, --print-params,
--checkpoint-save / --checkpoint-load, --metrics, --profile, --version) and
the demo loop's flags (frames, rendering, viewing, --energy, --autosave,
--selftest). nbody_tpu's other flags (adaptive and block timesteps, the
XLA / Pallas kernel names, --tile-j) are not accepted until their slice
lands (ROADMAP.md).

Modes:
* --benchmark            timed run; prints interactions/s and GFLOP/s
* --compare / --qatest   one-step QA against the CPU oracle; exit code = !passed
* --drift-check STEPS    energy drift over STEPS steps on the device and on the
                         CPU oracle; exit code 1 when they differ by more than
                         max(5e-4, 0.05 |oracle drift|) (nbody_tpu/cli.py:838-841)
                         and, with --precision ds, by more than
                         max(1e-9, 1e-7 |oracle drift|) over the first 50 steps
                         (nbody_tpu/cli.py:338-376)
* --selftest             QA compare, a 3-step drift check against the oracle and
                         a render smoke test; exit code 1 if any fails
* default                the demo loop (nbody_tpu/cli.py:880-1098): --frames
                         frames of --steps-per-frame steps each, a report
                         about once a second, optionally PNG frames
                         (--render), an APNG / AVI animation (--animate), a
                         live view in the terminal (--live) and the
                         reference's key bindings from stdin (--interactive)

--fp64 (or --precision fp64) runs in double precision on the double
all-pairs kernels, with Euler, leapfrog or Hermite; its QA holds the
positions to 5e-4 and the force (with Hermite also the jerk) to the float64
oracle at 1e-10 of its largest value, and its --drift-check keeps the fp32
gate. --variant auto, vpu, mxu and mxu_bf16 run the one-sided double kernels
(nbody_tpu's fp64 XLA path ignores the variant); --kernel pm / p3m run the
exact force there, as nbody_tpu's fp64 does; sym is refused in fp64, and so
are --strategy ring_fused and sym on a mesh. --fp64 with --precision ds
exits 1, in nbody_tpu's words (cli.py:449-453).

--precision ds runs the double-single (fp64-grade) kernels, default N 16384
(BASELINE.json configs[2]), with Euler, leapfrog or Hermite, QA against the
float64 oracle at |dpos| <= 1e-10 and the force (and with Hermite the jerk)
at 1e-10 of its largest value. Like nbody_tpu's ds measurement modes it
runs without --hostmem, --kernel and a --variant other than auto or sym
(vpu, mxu and mxu_bf16 run the ds default), and prints one line for each
such flag that has no effect; its demo loop refuses them (exit 1), and
--selftest, as nbody_tpu's does (cli.py:463-495).

--kernel pm runs plain particle-mesh (the raw 1/r kernel on the --pm-grid
mesh) and --kernel p3m the P3M fast mode (PM long range + exact short range
on the CUDA pair kernel), --pm-assignment cic or tsc, Euler or leapfrog: their
QA gates positions only and their --drift-check is reported, not gated, as
in nbody_tpu (their force differs from the all-pairs oracle's by the mesh
error, by design). --p3m-short-range auto and pallas run the pair kernel;
xla (nbody_tpu's cell-list engine) exits 2 naming ROADMAP.md Queue 1 #16.
--p3m-auto-refresh rewinds a run whose cells outgrew the capacity to the
first breached step and re-sizes the capacity from that state.

--devices D shards the bodies over D ranks, one a device, with --strategy
allgather, ring or auto (nbody_tpu's cost model), for fp32, fp64 and ds,
ring_fused (fp32 Euler and leapfrog: all D hops of the ring in one launch of
the fused ring kernel, the ranks on one host; the plain ring with --cpu) or
sym (fp32: each pair once across the mesh; the plain versions with --cpu,
where nbody_tpu refuses --cpu, its sym being Pallas-only). --mesh-rows R
makes the mesh a 2-D R x D/R grid (the i-block x j-block decomposition) for
fp32, fp64 and ds, with nbody_tpu's checks and words (cli.py:268-300,
600-660), which exit 1. With --kernel pm / p3m a 1-D mesh runs the sharded
mesh solver whatever the strategy, --pm-fft replicated (a fixed-order sum of
the density grid) or slab (the distributed FFT; D must divide 2 * --pm-grid).
Start it as ``torchrun --nproc_per_node D nbody-torch --devices D ...``
(NCCL on the cards, gloo with --cpu). --devices 1 builds no mesh, as in
nbody_tpu. A --devices that differs from the number of ranks exits 2; so do
--strategy ring_fused or sym with --precision ds (nbody_tpu's text). Only
rank 0 prints; every rank exits with rank 0's verdict.

The demo loop and --selftest run on a mesh too: every rank steps its shard,
the state is gathered on every rank before each frame that is drawn, and
rank 0 renders, writes the PNG / APNG / AVI files, draws the HUD, reports
and reads the keys. Each frame ends with a broadcast from rank 0 of the
frame's control state (the keys for the next frame, demo cycling, quit),
which every rank applies, so that their parameters and states stay one; the
other ranks wait for rank 0's frame there, in the collective library, and
not in the fused ring's bounded wait. The process's first deterministic
``index_add_`` (seconds on a card) is paid before the first step.

Checkpoints are nbody_tpu's npz files, read and written by either package:
a resume restores the saved parameters and step counter, a ds resume the
raw hi/lo planes (bit for bit), and an orbax checkpoint directory, which
needs JAX, exits 2.

The run is on the CUDA card; --cpu selects the plain PyTorch path on the
host, and nothing else does: without --cpu and without a card the run fails.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional


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
    p.add_argument("--kernel", choices=["auto", "pm", "p3m"], default="auto",
                   help="force algorithm: auto = the all-pairs kernels of --variant; "
                        "pm = O(N) particle-mesh far-field solver, resolution-limited "
                        "accuracy; p3m = PM + exact short-range correction, sub-percent "
                        "forces at PM speed; pm and p3m take Euler or leapfrog (neither "
                        "passes --qatest's all-pairs force tolerance by design: their "
                        "QA gates positions only)")
    p.add_argument("--pm-grid", type=int, default=64,
                   help="mesh resolution per axis (--kernel pm/p3m)")
    p.add_argument("--pm-assignment", choices=["cic", "tsc"], default="cic",
                   help="mass-assignment scheme for pm/p3m: cic = 8-point "
                        "trilinear, tsc = 27-point quadratic (~2x lower "
                        "mesh force error, same FFT cost)")
    p.add_argument("--pm-fft", choices=["replicated", "slab"], default="replicated",
                   help="multi-device FFT decomposition for pm/p3m: replicated = "
                        "a (2G)^3 solve on every device; slab = the distributed FFT "
                        "over the mesh (D must divide 2 * --pm-grid)")
    p.add_argument("--p3m-short-range", choices=["auto", "xla", "pallas"], default="auto",
                   help="p3m short-range engine: auto and pallas = the CUDA pair "
                        "kernel (on a mesh each device takes a range of its work); "
                        "xla is not ported (ROADMAP.md Queue 1 #16)")
    p.add_argument("--p3m-capacity", type=int, default=None,
                   help="p3m neighbor-cell capacity (bodies per cell); "
                        "default auto-sizes from the initial state's max "
                        "occupancy +50%% headroom; overflow at init raises")
    p.add_argument("--p3m-auto-refresh", action="store_true",
                   help="when a run's per-step probe finds a p3m contract breach "
                        "(collapsing states outgrow the cell capacity), rewind to "
                        "the breach step, re-size from that state, and resume "
                        "instead of warning")
    p.add_argument("--devices", type=int, default=None,
                   help="shard bodies over this many devices (a 1-D mesh of ranks, one a "
                        "device; start D ranks with torchrun --nproc_per_node D)")
    p.add_argument("--strategy", choices=["auto", "allgather", "ring", "ring_fused", "sym"],
                   default="auto",
                   help="multi-device communication strategy: allgather (one all-gather, "
                        "one fused kernel), ring (the j-shard travels the ring, a force "
                        "kernel a hop), ring_fused (fp32 Euler and leapfrog: all hops in "
                        "one kernel launch that carries the j-shards itself, the ranks on "
                        "one host), sym (fp32: each pair once across the mesh, the work "
                        "split by Newton's third law), auto (nbody_tpu's cost model by "
                        "shard size, allgather or ring)")
    p.add_argument("--mesh-rows", type=int, default=None,
                   help="with --devices D: the 2-D (rows x D/rows) force decomposition, "
                        "each rank an i-block x j-block")
    p.add_argument("--drift-check", type=int, default=None, metavar="STEPS",
                   help="run STEPS steps on the device and on the CPU oracle "
                        "from the same state and compare their energy drifts; "
                        "exit code 1 when they differ beyond the gate")
    # run setup and state I/O (nbody_tpu/cli.py:151-158, 194-226)
    p.add_argument("--config", choices=["shell", "random", "expand", "plummer", "galaxy"],
                   default="shell",
                   help="initial condition (galaxy = synthesized two-disk "
                        "collision, the tipsy-demo analogue; plummer = "
                        "self-consistent equilibrium sphere)")
    p.add_argument("--demo", type=int, default=0, help="start at demo preset [0..6]")
    p.add_argument("--set", dest="set_params", type=str, default=None,
                   metavar="NAME=VAL[,NAME=VAL...]",
                   help="set slider parameters (velocity_damping, "
                        "softening_factor, time_step, cluster_scale, "
                        "velocity_scale)")
    p.add_argument("--print-params", action="store_true",
                   help="print the active parameter set (reference 'o' key)")
    p.add_argument("--checkpoint-save", type=str, default=None, metavar="PATH",
                   help="write the final state, parameters and step counter "
                        "to an npz checkpoint (nbody_tpu's format)")
    p.add_argument("--checkpoint-load", type=str, default=None, metavar="PATH",
                   help="resume from an npz checkpoint (nbody_tpu's or this "
                        "port's)")
    p.add_argument("--metrics", type=str, default=None, metavar="PATH",
                   help="append per-report perf metrics as JSON lines")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run to DIR "
                        "(view in Perfetto or chrome://tracing)")
    p.add_argument("--version", action="store_true")
    # the demo loop (nbody_tpu/cli.py:159-218)
    p.add_argument("--frames", type=int, default=120, help="demo frames to simulate")
    p.add_argument("--steps-per-frame", type=int, default=1,
                   help="simulation steps per rendered frame")
    p.add_argument("--no-cycle", action="store_true", help="disable 10s demo cycling")
    p.add_argument("--render", action="store_true", help="write PNG frames (demo mode)")
    p.add_argument("--animate", type=str, default=None, metavar="OUT.png|OUT.avi",
                   help="write the demo as one animation file: lossless "
                        "APNG by default, uncompressed AVI for a .avi "
                        "extension")
    p.add_argument("--outdir", type=str, default="frames", help="PNG output directory")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--fullscreen", action="store_true",
                   help="render at 1920x1080 (reference window default)")
    p.add_argument("--camera", type=str, default=None, metavar="X,Y,Z",
                   help="camera origin override (default: demo preset's)")
    p.add_argument("--sprite-size", type=float, default=1.0,
                   help="point sprite size (reference Point Size slider)")
    p.add_argument("--splat", type=int, default=None,
                   help="splat patch size in pixels (max sprite extent); "
                        "default 16, or 8 above 262144 bodies (the scatter "
                        "cost scales with N*splat^2)")
    p.add_argument("--brightness", type=float, default=0.3,
                   help="splat additive intensity (source-alpha analogue)")
    p.add_argument("--raster", choices=["auto", "scatter", "conv"], default="auto",
                   help="rasterizer path: scatter = exact N*splat^2 "
                        "fragment scatter; conv = N-point deposit + dense "
                        "Hermite-kernel convolutions (~1/255-grade "
                        "approximation); auto switches to conv once "
                        "N*splat^2 >= 2^22")
    p.add_argument("--no-hud", action="store_true",
                   help="disable the HUD overlay on rendered frames")
    p.add_argument("--live", action="store_true",
                   help="live view in the terminal (24-bit half-block "
                        "cells, flicker-free repaint); combine with "
                        "--interactive for the full key map")
    p.add_argument("--interactive", action="store_true",
                   help="read reference key bindings from stdin during the "
                        "demo loop (space=pause, [ ]=demos, 1/2/3/4=reset, "
                        "enter=precision, q=quit, ...)")
    p.add_argument("--energy", action="store_true",
                   help="report total-energy drift over the run")
    p.add_argument("--autosave", type=int, default=None, metavar="N",
                   help="in demo mode, atomically rewrite --checkpoint-save "
                        "every N frames (crash-safe resume point for long "
                        "unattended runs)")
    p.add_argument("--selftest", action="store_true",
                   help="run QA compare + drift check + a render smoke test "
                        "and exit (0 = all pass)")
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


def _mesh_refusal(args) -> Optional[str]:
    """What nbody_tpu's CLI refuses of the mesh flags, in its words, to be
    printed with its exit code 1 (cli.py:268-300 for ds, 600-660 for fp32
    and fp64); None if nothing. Unlike nbody_tpu it runs --strategy sym with
    --cpu, on the plain versions (ROADMAP.md Queue 3, deviations)."""
    multi = (args.devices or 0) > 1
    if args.mesh_rows is not None and args.mesh_rows < 1:
        return f"--mesh-rows must be at least 1; got {args.mesh_rows}"
    if args.precision == "ds":
        if multi and args.mesh_rows is not None:
            if args.strategy != "auto":
                return ("the ds 2-D decomposition is its own communication pattern; leave "
                        "--strategy auto")
            if args.devices % args.mesh_rows:
                return f"--mesh-rows {args.mesh_rows} does not divide --devices {args.devices}"
        return None
    if args.mesh_rows is not None and not multi:
        return "--mesh-rows needs --devices > 1"
    if args.mesh_rows is not None and args.kernel in ("pm", "p3m"):
        return ("--mesh-rows (2-D decomposition) applies to the exact kernels; the mesh "
                "solvers shard over a 1-D body mesh — drop --mesh-rows or use --kernel auto "
                f"(got --kernel {args.kernel})")
    if args.strategy == "sym" and multi:
        if args.kernel in ("pm", "p3m"):
            return ("--strategy sym runs the Newton's-third-law kernels; use --kernel auto "
                    f"(got --kernel {args.kernel})")
        if args.mesh_rows is not None:
            return "--strategy sym uses the 1-D body mesh; drop --mesh-rows"
        if args.fp64:
            return "--strategy sym is a float32 path; it does not combine with --fp64"
    if args.mesh_rows is not None and args.variant not in ("vpu", "auto"):
        return ("--mesh-rows uses the accel-only kernels (no mxu variants); leave --variant "
                f"at vpu/auto (got {args.variant})")
    if multi and args.mesh_rows is not None and args.devices % args.mesh_rows:
        return f"--mesh-rows {args.mesh_rows} does not divide --devices {args.devices}"
    return None


def _mesh(args):
    """The body mesh of --devices, or None: with D > 1 the ranks' process
    group is started from torchrun's environment, and D must be its size;
    with --mesh-rows R the mesh is the R x D/R grid."""
    if args.devices is not None and args.devices < 1:
        raise ValueError(f"--devices must be at least 1; got {args.devices}")
    if args.devices is None or args.devices == 1:
        return None
    if (args.precision == "ds" and args.mesh_rows is None
            and args.strategy not in ("auto", "allgather", "ring")):
        # nbody_tpu/cli.py:283-288
        raise ValueError("the sharded ds step gathers or ring-rotates the hi/lo planes; use "
                         "--strategy auto/allgather/ring (ring_fused and sym are fp32 mesh "
                         "paths)")
    from nbody_tpu_torch.parallel import initialize_multihost, make_mesh, make_mesh_2d

    device = "cpu" if args.cpu else "cuda"
    if "WORLD_SIZE" in os.environ:
        initialize_multihost(device=device)
    if args.mesh_rows is not None:
        return make_mesh_2d(args.mesh_rows, args.devices // args.mesh_rows,
                            device="cpu" if args.cpu else None)
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


def _ds_demo_refusals(args) -> Optional[str]:
    """What nbody_tpu's ds demo, checkpoint and selftest path refuses, in
    its words, to be printed with its exit code 1 (cli.py:463-495); None if
    nothing."""
    if args.hostmem:
        return "--precision ds keeps state on device (no --hostmem)"
    if args.kernel != "auto":
        return ("--precision ds runs the double-single kernels; use --kernel auto "
                f"(got {args.kernel})")
    if args.variant not in ("auto", "sym"):
        return f"--precision ds variants are auto/sym (got {args.variant})"
    if args.selftest:
        return ("--selftest measures the fp32/fp64 paths; use --precision ds with "
                "--qatest/--drift-check instead")
    return None


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _git_commit_id() -> str:
    """The checkout's short commit id, or "unknown" (the reference stamps
    it at build time: cmake/include-git-commit-id.cmake)."""
    import pathlib
    import subprocess

    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=5,
                             cwd=pathlib.Path(__file__).resolve().parent)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "unknown"


def _save(path, compute, *, write: bool = True) -> None:
    """An atomic npz checkpoint of the current state (with the raw hi/lo
    planes in ds), as nbody_tpu's CLI writes it (cli.py:860-873). On a mesh
    every rank must call it (the state is gathered); `write` picks the one
    that writes."""
    from nbody_tpu_torch.io import save_checkpoint

    system = compute.system
    pos, vel = system.positions, system.velocities
    planes = system.get_ds_state() if compute.precision == "ds" else None
    if write:
        save_checkpoint(path, pos, vel, compute.active_params, step=compute.steps_taken,
                        config=system.config, atomic=True, ds_planes=planes)


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        import nbody_tpu_torch

        print(f"nbody_tpu_torch {nbody_tpu_torch.__version__} ({_git_commit_id()})")
        return 0
    # a measurement mode, or else the demo loop
    measuring = bool(args.benchmark or args.compare or args.qatest
                     or args.drift_check is not None)
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
    refusal = _ds_demo_refusals(args) if ds and (args.selftest or not measuring) else None
    refusal = refusal or _mesh_refusal(args)
    if refusal:
        print(f"error: {refusal}", file=sys.stderr)
        return 1
    ignored = _ds_ignored_flags(args) if ds else []
    solver = args.kernel if args.kernel in ("pm", "p3m") else None
    if args.autosave is not None:
        # nbody_tpu/cli.py:681-689, with its exit code
        if args.autosave <= 0:
            print("error: --autosave needs a positive frame interval", file=sys.stderr)
            return 1
        if not args.checkpoint_save:
            print("error: --autosave needs --checkpoint-save PATH (the file it rewrites)",
                  file=sys.stderr)
            return 1

    import numpy as np

    from nbody_tpu_torch import ic
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.config import NBodyConfig
    from nbody_tpu_torch.params import DEMO_PARAMS

    mesh = _mesh(args)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)

    for flag in ignored:
        say(f"--precision ds: {flag} has no effect")

    state_dtype = np.float64 if ds or args.fp64 else np.float32
    tipsy_state = None
    if args.config == "galaxy" and not (args.tipsy or args.checkpoint_load):
        n = args.numbodies or 16384
        tipsy_state = ic.galaxy_collision(n, seed=args.seed, dtype=state_dtype)
    if args.tipsy:
        from nbody_tpu_torch.io import read_tipsy_file

        tpos, tvel = read_tipsy_file(args.tipsy)
        tipsy_state = (tpos.astype(state_dtype), tvel.astype(state_dtype))
        say(f"Read {tipsy_state[0].shape[0]} bodies from {args.tipsy}")

    checkpoint_params = None
    resume_step = 0
    if args.checkpoint_load:
        from nbody_tpu_torch.io import load_checkpoint

        cpos, cvel, checkpoint_params, meta = load_checkpoint(args.checkpoint_load)
        # ds resumes through float64 first; the raw planes come below
        tipsy_state = (cpos.astype(state_dtype), cvel.astype(state_dtype))
        resume_step = int(meta.get("step", 0))
        say(f"Resumed {cpos.shape[0]} bodies at step {resume_step} from "
            f"{args.checkpoint_load}")

    num_bodies = args.numbodies
    if ds and measuring and num_bodies is None:
        num_bodies = 16384  # BASELINE.json configs[2], as nbody_tpu's _run_ds
    compute = Compute(
        num_bodies=num_bodies,
        device="cpu" if args.cpu else "cuda",
        block_size=args.block_size,
        placement="host" if args.hostmem else "device",
        variant=args.variant,
        integrator=args.integrator,
        precision=args.precision,
        fp64=args.fp64,
        kernel=args.kernel,
        pm_grid=args.pm_grid,
        pm_assignment=args.pm_assignment,
        pm_fft=args.pm_fft,
        p3m_capacity=args.p3m_capacity,
        p3m_short_range=args.p3m_short_range,
        p3m_auto_refresh=args.p3m_auto_refresh,
        cycle_demo=not args.no_cycle,
        seed=args.seed,
        tipsy_state=tipsy_state,
        mesh=mesh,
        strategy=args.strategy,
        log=say,
    )
    if checkpoint_params is not None:
        # resume with the exact parameters the checkpoint was written with
        compute.active_params = checkpoint_params
        compute.system.update_params(checkpoint_params)
    compute.steps_taken = resume_step
    if ds and args.checkpoint_load:
        from nbody_tpu_torch.io import load_checkpoint_ds_planes

        planes = load_checkpoint_ds_planes(args.checkpoint_load)
        if planes is not None:
            # the raw hi/lo planes: a bit-exact resume
            compute.system.set_ds_state(*planes)
    system = compute.system
    say(f"nbody_tpu_torch: {compute.num_bodies} bodies on {_device_name(system.device)}"
        + (f", {mesh.size}-device mesh [{system.strategy}]" if mesh is not None else "")
        + f" [{system.backend} kernel"
        + (", host memory" if args.hostmem else "")
        + (", double-single (fp64-grade)]" if ds else ", fp64]" if args.fp64 else ", fp32]")
        + (f" force p3m (grid {system.pm_grid}, {system.pm_assignment}, cell capacity "
           f"{system.p3m_capacity})" if compute.solver == "p3m"
           else f" force pm (grid {system.pm_grid}, {system.pm_assignment})"
           if compute.solver == "pm" else f" force {system.variant}")
        + f", integrator {system.integrator}")

    if not 0 <= args.demo < len(DEMO_PARAMS):
        raise ValueError(f"--demo {args.demo} out of range (presets 0..{len(DEMO_PARAMS) - 1})")

    def with_config_scales(params):
        # plummer: cluster_scale is the Plummer scale radius and
        # velocity_scale is in units of the self-consistent speed
        # (nbody_tpu/cli.py:789-796); --set still overrides below
        if args.config != "plummer":
            return params
        return params.replace(cluster_scale=1.0, velocity_scale=1.0)

    if args.demo != 0 and tipsy_state is None:
        compute.active_demo = args.demo
        compute.active_params = with_config_scales(DEMO_PARAMS[args.demo])
        compute.reset(NBodyConfig.parse(args.config))
    elif tipsy_state is None and args.config not in ("shell", "galaxy"):
        compute.active_params = with_config_scales(compute.active_params)
        compute.reset(NBodyConfig.parse(args.config))

    if args.set_params:
        from nbody_tpu_torch.ui import ParamPanel

        panel = ParamPanel.for_compute(compute)
        for pair in args.set_params.split(","):
            name, _, value = pair.partition("=")
            if not value:
                raise ValueError(f"--set expects NAME=VALUE, got {pair!r}")
            panel.set(name.strip(), float(value))
        compute.reset(compute.system.config)  # re-apply scales to the ICs
        say(panel.render_text())
    if args.print_params:
        say(compute.active_params.print_values())

    from nbody_tpu_torch.utils.profiling import format_memory_line, trace

    status = 0
    with trace(args.profile) as trace_dir:
        if args.selftest:
            status = _run_selftest(compute, say)
        elif args.drift_check is not None:
            drift = compute.drift_check(args.drift_check)
            if solver:
                # nbody_tpu/cli.py:829-834: the mesh solver's drift differs from
                # the all-pairs oracle's by design, so it is reported, not gated
                say("(mesh-solver drift differs from the all-pairs oracle by design; "
                    "exit-code gate applies to exact kernels only)")
            elif drift_failed(drift):
                say("drift check FAILED", file=sys.stderr)
                status = 1
        elif args.benchmark:
            result = compute.run_benchmark(args.iterations)
            mem = format_memory_line(system.device)
            if mem:
                say(mem)
            if args.metrics and (mesh is None or mesh.rank == 0):
                _append_metrics(args.metrics, result)
        elif args.compare or args.qatest:
            status = 0 if compute.compare_results() else 1
        else:
            status = _run_demo(compute, args, mesh)
    if trace_dir:
        say(f"profiler trace written to {trace_dir}")
    if args.checkpoint_save:
        # every rank gathers the state; rank 0 writes it
        _save(args.checkpoint_save, compute, write=mesh is None or mesh.rank == 0)
        say(f"Checkpoint written to {args.checkpoint_save} (step {compute.steps_taken})")
    return status


def _append_metrics(path, record: dict) -> None:
    import json

    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _warm_ordered_scatter(device) -> None:
    """Pay the process's first deterministic ``index_add_`` (seconds on a
    card: the rasterizer's and the deposits' sort) before the first step,
    so that no rank spends it between two steps of a mesh."""
    import torch

    from nbody_tpu_torch.utils.ordered import index_add_ordered

    if device.type != "cuda":
        return
    n = 4096
    index_add_ordered(torch.zeros(n, device=device), torch.arange(n, device=device) % 7,
                      torch.ones(n, device=device))
    torch.cuda.synchronize(device)


def _frame_control(mesh, control):
    """Rank 0's control state of a frame, (keys, cycle, quit), on every rank
    of the mesh: one broadcast, on which the other ranks wait for rank 0's
    frame under the group's timeout."""
    import torch.distributed as dist

    box = [control if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=mesh.group, device=mesh.device)
    return box[0]


def _run_demo(compute, args, mesh=None) -> int:
    """The demo loop (nbody_tpu/cli.py:880-1098): step, report the HUD stats
    about once a second, optionally render, optionally react to the
    reference's key bindings from stdin. The frames are rendered on the
    system's device; only the finished uint8 frames reach the host.

    On a mesh every rank runs the loop: it steps its shard, joins the
    gather of the state before a frame that is drawn, and applies each
    frame's control state, which rank 0 broadcasts at the frame's end (the
    keys it read, whether the demo cycles, quit). Rank 0 alone renders,
    writes, reports and reads the keys."""
    import pathlib
    import time

    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    renderer = camera = None
    want_frames = args.render or args.animate
    if want_frames or args.interactive or args.live:
        from nbody_tpu_torch.render import Camera

        origin = compute.active_params.camera_origin
        if args.camera:
            parts = [float(x) for x in args.camera.split(",")]
            if len(parts) != 3:
                raise ValueError("--camera expects X,Y,Z")
            origin = tuple(parts)
        camera = Camera(origin=origin)
    if want_frames and rank0:
        from nbody_tpu_torch.render import FrameRenderer

        width, height = (1920, 1080) if args.fullscreen else (args.width, args.height)
        splat = args.splat
        if splat is None:
            splat = 16 if compute.num_bodies <= 262144 else 8
        renderer = FrameRenderer(width=width, height=height, splat=splat, method=args.raster)
        if args.render:
            outdir = pathlib.Path(args.outdir)
            outdir.mkdir(parents=True, exist_ok=True)
            _write_run_metadata(outdir, compute, args, width, height)
    anim_frames = [] if args.animate and rank0 else None

    live_view = live_renderer = None
    if args.live and rank0:
        # the reference's real-time window, display-server-free: render at
        # terminal resolution (one half-block cell = two pixels) and
        # repaint in place (ui/terminal_view.py)
        from nbody_tpu_torch.render import FrameRenderer
        from nbody_tpu_torch.ui.terminal_view import TerminalViewer, terminal_cell_size

        cols, rows = terminal_cell_size()
        live_renderer = FrameRenderer(width=cols, height=2 * rows, splat=8, method=args.raster)
        live_view = TerminalViewer()

    controls = None
    live_log = [""]
    if args.interactive:
        from nbody_tpu_torch.ui import Controls

        if live_view is not None:
            # the alternate screen owns stdout: key-handler logs become
            # status lines under the perf report
            controls = Controls(compute, camera,
                                log=lambda msg: live_log.__setitem__(0, str(msg)))
        else:
            controls = Controls(compute, camera, log=say)
        say("interactive: space=pause q=quit enter=precision [ ]=demos "
            "1/2/3/4=reset c=cycle p=mode o=params w/s=zoom a/e=rotate "
            "H/J/K/L=translate")

    if not args.no_hud:
        from nbody_tpu_torch.ui.hud import draw_hud, hud_lines

    # the float64 functional: relative drift in float32 summation noise is
    # meaningless at N >= 65k
    e0 = compute.system.total_energy(precise=True) if args.energy else None
    if mesh is not None:
        _warm_ordered_scatter(compute.system.device)

    def frame_of(r, pos):
        # compute.system, not a local: the Enter key swaps the system
        mode = controls.display_mode if controls is not None else None
        kw = {"mode": mode} if mode is not None else {}
        # ds renders with the fp64 tint: its state is fp64-grade
        return r.render(pos.to(compute.system.device), camera,
                        fp64=compute.precision != "fp32", sprite_size=args.sprite_size,
                        brightness=args.brightness, **kw)

    frames_done = 0
    last_report = time.monotonic()
    frames_since_report = 0
    quit_requested = False
    live_status = ""
    keys, cycle = [], False  # a mesh's control state of the frame
    try:
        while frames_done < args.frames and not quit_requested:
            if controls is not None and mesh is None:
                keys = controls.read_keys()
            for key in keys:
                if not controls.handle(key):
                    if live_view is None:
                        say("quit")
                    quit_requested = True
            if mesh is None:
                compute.update_simulation(camera, steps=args.steps_per_frame)
            else:
                compute.update_simulation(camera, steps=args.steps_per_frame, cycle=cycle)
            shown = controls is None or controls.display_enabled
            drawn = shown and (args.live or want_frames)
            # on a mesh every rank joins the gather; rank 0 draws
            pos = compute.system.state[0] if drawn else None
            if live_view is not None and shown:
                status = live_status or "starting..."
                if live_log[0]:
                    status += "\n" + live_log[0]
                live_view.show(frame_of(live_renderer, pos), status)
            if renderer is not None and shown:
                frame = frame_of(renderer, pos)
                if not args.no_hud:
                    show_inter = controls.show_interactions if controls else False
                    draw_hud(frame, hud_lines(compute, _device_name(compute.system.device),
                                              show_inter))
                if args.render:
                    renderer.write_png(frame, outdir / f"frame_{frames_done:05d}.png")
                if anim_frames is not None:
                    anim_frames.append(frame)
            frames_done += 1
            if args.autosave and frames_done % args.autosave == 0:
                # atomic: a crash mid-write must not eat the last good save;
                # on a mesh every rank gathers, rank 0 writes
                _save(args.checkpoint_save, compute, write=rank0)
            frames_since_report += 1
            now = time.monotonic()
            if rank0 and now - last_report >= 1.0:
                compute.system.hard_sync()
                compute.calculate_fps(frames_since_report, (now - last_report) * 1e3,
                                      steps_per_frame=args.steps_per_frame)
                report = (f"[demo {compute.active_demo}] frame {frames_done}/{args.frames} | "
                          f"{compute.fps:.1f} fps | {compute.interactions_per_second:.2f} "
                          f"G interactions/s | {compute.g_flops:.1f} GFLOP/s "
                          f"({compute.precision})")
                if live_view is not None:
                    # the alternate screen owns stdout: the report becomes
                    # the viewer's status line instead of a print
                    live_status = report
                else:
                    print(report)
                if args.metrics:
                    _append_metrics(args.metrics, {
                        "frame": frames_done,
                        "demo": compute.active_demo,
                        "fps": compute.fps,
                        "gflops": compute.g_flops,
                        "interactions_per_second_e9": compute.interactions_per_second,
                        "fp64": compute.fp64_enabled,
                    })
                last_report = now
                frames_since_report = 0
            if mesh is not None:
                # the frame ends when rank 0's does: its keys, its clock's
                # demo cycling and its quit reach every rank
                mine = ((controls.read_keys() if controls is not None and rank0 else []),
                        compute.cycle_due(), quit_requested) if rank0 else None
                keys, cycle, quit_requested = _frame_control(mesh, mine)
    finally:
        if live_view is not None:
            live_view.close()  # restore the terminal even on an exception

    compute.system.block_until_ready()
    if args.energy:
        e1 = compute.system.total_energy(precise=True)
        drift = (e1 - e0) / abs(e0) if e0 else 0.0
        say(f"energy: E0={e0:.6g} E1={e1:.6g} relative drift={drift:.3e}")
    if args.render:
        say(f"wrote {frames_done} frames to {args.outdir}/")
    if anim_frames:
        if args.animate.lower().endswith(".avi"):
            from nbody_tpu_torch.io.avi import write_avi

            write_avi(anim_frames, args.animate, fps=30)
        else:
            from nbody_tpu_torch.io.apng import write_apng

            write_apng(anim_frames, args.animate, fps=30)
        print(f"wrote {len(anim_frames)}-frame animation to {args.animate}")
    return 0


def _run_selftest(compute, say=print) -> int:
    """End-to-end health check on the current device (nbody_tpu/cli.py:
    1101-1139): the reference's QA criterion, the energy drift against the
    oracle over 3 steps, and a render smoke test. On a mesh every rank runs
    it (the checks give rank 0's verdicts to all, the render draws the
    gathered state) and `say` prints on rank 0."""
    import numpy as np

    from nbody_tpu_torch.render import Camera, FrameRenderer

    failures = []
    if compute.compare_results():
        say("selftest [1/3] QA compare: PASS")
    else:
        failures.append("qa-compare")
        say("selftest [1/3] QA compare: FAIL")

    if not drift_failed(compute.drift_check(3)):
        say("selftest [2/3] energy drift vs oracle: PASS")
    else:
        failures.append("drift")
        say("selftest [2/3] energy drift vs oracle: FAIL")

    system = compute.system
    cam = Camera(origin=compute.active_params.camera_origin)
    frame = FrameRenderer(width=160, height=120).render(
        system.state[0].to(system.device), cam, fp64=compute.fp64_enabled)
    if frame.shape == (120, 160, 3) and np.isfinite(frame.astype(np.float64)).all() \
            and frame.sum() > 0:
        say("selftest [3/3] render smoke: PASS")
    else:
        failures.append("render")
        say("selftest [3/3] render smoke: FAIL")

    if failures:
        say(f"selftest FAILED: {', '.join(failures)}")
        return 1
    say("selftest PASSED")
    return 0


def _write_run_metadata(outdir, compute, args, width, height) -> None:
    """Sidecar metadata for rendered frame sequences (device, params, config)."""
    import dataclasses
    import json

    meta = {
        "device": _device_name(compute.system.device),
        "num_bodies": compute.num_bodies,
        "params": dataclasses.asdict(compute.active_params),
        "fp64": compute.fp64_enabled,
        "precision": compute.precision,
        "resolution": [width, height],
        "seed": args.seed,
        "config": args.config,
        "demo": compute.active_demo,
    }
    (outdir / "metadata.json").write_text(json.dumps(meta, indent=2))


if __name__ == "__main__":
    sys.exit(main())
