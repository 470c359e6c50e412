#!/usr/bin/env python3
"""Measure nbody_tpu_torch's native fp64 mode (the double kernels of
csrc/f64_kernels.cu) on the card, beside the double-single (ds) mode, the
other fp64-grade mode.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_fp64_bench.py [--quick] [--rounds R]

1. ptxas (registers, spills, shared memory) of every kernel of
   csrc/f64_kernels.cu and each double walk's SASS: instructions a pair and
   FP64 instructions a pair (the innermost loop around MUFU.RSQ64H, over
   its MUFU.RSQ64H). --quick stops here.
2. Kernels in turns, R rounds (default 6, the order reversed every other
   round), median and every round printed, CUDA events over several calls
   after one untimed call: the double step, force and accel + jerk beside
   the one-sided ds step, force and accel + jerk, and the double potential
   beside the fp32 one, at N = 16384 (BASELINE.json configs[2]) and 65536;
   each with its bound (the JAX package's flops a pair at 34 TFLOP/s
   FP64) and the FP64 issue bound of its walk (64 FP64 lanes an SM, 1980
   MHz).
3. Steps through Compute in turns: fp64 against ds one_sided, Euler,
   leapfrog and Hermite, at 16384 and 65536 (run_benchmark(10), R rounds).
4. Accuracy against the float64 oracle (the NumPy oracle's arithmetic on
   512 sampled rows, float64): the force and the jerk of the fp64 and the
   ds kernels at 16384 and 65536, and one dt = 1e-3 Euler step's max|dpos|
   at 16384 against the native float64 oracle's step
   (tests/test_ds_kernel.py's bounds: |dpos| < 1e-11, the force within
   1e-10 of its largest value).
5. The drift check, Compute(precision="fp64").drift_check(STEPS), 10 steps
   at 16384 and 3 at 65536: its wall time with the float64 energy
   functional on the card (this build) and with the host functional
   (``energy.total_energy_f64``, which the drift check ran at N <= 131072
   before the double potential kernel), and each functional alone on the
   same state.
Prints one line per measurement and nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402  (the repository root is on sys.path)
    F64_FLOPS,
    F64_WALKS,
    FP64_LANES,
    NOMINAL_MHZ,
    PEAK_FP64_FLOPS,
    oracle_rows_f64,
    timed_ms,
)

SOFT, DT, DAMP = 0.1, 0.016, 0.5


def sass_report() -> dict:
    """Print ptxas and the walks' SASS; return {kernel: FP64 instructions a
    pair} of the 2-row (blocks up to 512 threads) instantiation."""
    from nbody_tpu_torch.ops import _build

    usage, text = _build.sass_of("f64_kernels.cu")
    for line in _build.ptxas_lines("f64_kernels.cu", usage=usage):
        print(line)
    names = _build.demangle(usage)
    per_pair = {}
    for key, piece in F64_WALKS.items():
        for mangled in (k for k in usage if piece in k):
            loops = sorted(_build.sass_loops(text, mangled),
                           key=lambda lp: lp["instructions"] / lp["pairs"])
            lp = loops[0]
            fp64 = lp["mix"].get("fp64", 0) / lp["pairs"]
            ops = ", ".join(f"{op} {k / lp['pairs']:.2f}" for op, k in sorted(lp["ops"].items()))
            print(f"sass {names[mangled]}: {lp['instructions'] / lp['pairs']:.2f} instructions "
                  f"a pair, {fp64:.2f} FP64 ({ops})")
            if "ILi2ELi512E" in mangled:
                per_pair[key] = fp64
    return per_pair


def state64(torch, n, seed=42):
    """Shell ICs in float64 at the tuned scales, masses from [0.5, 2] and a
    random vel.w, on the card."""
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales

    demo = DEMO_PARAMS[0]
    scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
    pos, vel = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed, dtype=np.float64)
    rng = np.random.default_rng(7)
    pos[:, 3] = rng.uniform(0.5, 2.0, n)
    vel[:, 3] = rng.standard_normal(n)
    dev = torch.device("cuda", 0)
    return torch.tensor(pos, device=dev), torch.tensor(vel, device=dev)


def in_turns(measure: dict, rounds: int) -> dict:
    """{label: [ms a round]}: each label's measure() once a round, the order
    reversed every other round."""
    labels = list(measure)
    out = {k: [] for k in labels}
    for r in range(rounds):
        for k in labels if r % 2 == 0 else labels[::-1]:
            out[k].append(measure[k]())
    return out


def show(tag: str, runs: dict, extra: dict | None = None) -> dict:
    med = {k: statistics.median(v) for k, v in runs.items()}
    for k, v in runs.items():
        print(f"{tag} {k}: median {med[k]:.4f} ms ({', '.join(f'{x:.4f}' for x in v)})"
              + (f"; {extra[k]}" if extra and k in extra else ""))
    return med


def kernels(torch, per_pair: dict, rounds: int, smi: str) -> None:
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import ds

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, reps in ((16384, 20), (65536, 3)):
        p, v = state64(torch, n)
        planes = tuple(t for a in (p, v) for t in ds.ds_from_f64(a.cpu().numpy()))
        planes = tuple(t.to(p.device) for t in planes)
        scal = ds.scal_ds(DT, SOFT, DAMP)
        hscal = ds.scal_ds_hermite(DT, SOFT, DAMP)
        bs = ck.ds_default_block_size(n)
        p32 = p.float()
        fns = {
            "fp64 step": lambda: ck.nbody_step_cuda(p, v, DT, SOFT, DAMP),
            "ds step": lambda: ck.nbody_step_ds_cuda(*planes, scal, block_size=bs),
            "fp64 accel": lambda: ck.compute_accel_cuda(p, p, SOFT),
            "ds accel": lambda: ck.compute_accel_ds_cuda_vs(planes[0], planes[1], planes[0],
                                                            planes[1], scal),
            "fp64 accel_jerk": lambda: ck.compute_accel_jerk_cuda(p, v, p, v, SOFT),
            "ds accel_jerk": lambda: ck.compute_accel_jerk_ds_cuda_vs(*planes, *planes, hscal),
            "fp64 potential": lambda: ck.potential_energy_per_row_cuda(p, SOFT),
            "fp32 potential": lambda: ck.potential_energy_per_row_cuda(p32, SOFT),
        }
        runs = in_turns({k: (lambda fn=fn: timed_ms(torch, fn, reps)) for k, fn in fns.items()},
                        rounds)
        extra = {}
        for k in fns:
            kind = k.split(" ", 1)[1] + "_f64"
            if k.startswith("fp64"):
                pairs = float(n) ** 2
                bound = F64_FLOPS[kind] * pairs / PEAK_FP64_FLOPS * 1e3
                issue = pairs * per_pair[kind] / (sms * FP64_LANES * NOMINAL_MHZ * 1e6) * 1e3
                med = statistics.median(runs[k])
                extra[k] = (f"bound {bound:.4f} ms ({100 * bound / med:.1f} %), FP64 issue "
                            f"bound {issue:.4f} ms ({100 * issue / med:.1f} %)")
        med = show(f"kernel N={n}", runs, extra)
        for kind in ("step", "accel", "accel_jerk"):
            ratio = med["ds " + kind] / med["fp64 " + kind]
            print(f"kernel N={n} {kind}: ds / fp64 = {ratio:.2f}x [{smi}]")


def systems(torch, rounds: int, smi: str) -> None:
    from nbody_tpu_torch.compute import Compute

    for n in (16384, 65536):
        for integrator in ("euler", "leapfrog", "hermite"):
            made = {"fp64": Compute(num_bodies=n, device="cuda", precision="fp64",
                                    integrator=integrator, log=lambda s: None),
                    "ds": Compute(num_bodies=n, device="cuda", precision="ds",
                                  variant="one_sided", integrator=integrator,
                                  log=lambda s: None)}
            steps = 10 if n == 16384 else 3

            def measure(c):
                res = c.run_benchmark(steps)
                return res["milliseconds"] / res["iterations"]

            runs = in_turns({k: (lambda c=c: measure(c)) for k, c in made.items()}, rounds)
            med = show(f"step N={n} {integrator}", runs)
            print(f"step N={n} {integrator}: ds / fp64 = {med['ds'] / med['fp64']:.2f}x [{smi}]")


def accuracy(torch) -> None:
    import numpy as np

    from nbody_tpu_torch.compute import QA_DT
    from nbody_tpu_torch.oracle import step_best
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import ds

    rng = np.random.default_rng(3)
    for n in (16384, 65536):
        p, v = state64(torch, n)
        p64, v64 = p.cpu().numpy(), v.cpu().numpy()
        rows = np.sort(rng.choice(n, 512, replace=False))
        o_acc, o_jerk, _ = oracle_rows_f64(rows, p64, v64, SOFT)
        planes = tuple(t.to(p.device) for a in (p64, v64) for t in ds.ds_from_f64(a))
        idx = torch.as_tensor(rows, device=p.device)
        a64, j64 = ck.compute_accel_jerk_cuda(p, v, p, v, SOFT)
        got = {"fp64": (ck.compute_accel_cuda(p, p, SOFT)[idx], a64[idx], j64[idx])}
        a_ds = ck.compute_accel_ds_cuda_vs(planes[0], planes[1], planes[0], planes[1],
                                           ds.scal_ds(DT, SOFT, DAMP))
        aj_ds = ck.compute_accel_jerk_ds_cuda_vs(*planes, *planes,
                                                 ds.scal_ds_hermite(DT, SOFT, DAMP))
        got["ds"] = tuple(torch.tensor(ds.ds_to_f64(h, lo)[:, :3])[rows] for h, lo in (
            a_ds, aj_ds[:2], aj_ds[2:]))
        for mode, (acc, acc_aj, jerk) in got.items():
            e = [float(np.abs(np.asarray(x.cpu()) - ref).max()) / float(np.abs(ref).max())
                 for x, ref in ((acc, o_acc), (acc_aj, o_acc), (jerk, o_jerk))]
            print(f"accuracy N={n} {mode}: against the float64 oracle on 512 rows, max|d| / "
                  f"max: force {e[0]:.3e}, accel + jerk's force {e[1]:.3e}, jerk {e[2]:.3e} "
                  "(bound 1e-10)")
        if n == 16384:
            ref = step_best(p64, v64, QA_DT, SOFT, DAMP)[0]
            new64 = ck.nbody_step_cuda(p, v, QA_DT, SOFT, DAMP)[0].cpu().numpy()
            new_ds = ck.nbody_step_ds_cuda(*planes, ds.scal_ds(QA_DT, SOFT, DAMP),
                                           block_size=ck.ds_default_block_size(n))
            ds_pos = ds.ds_to_f64(new_ds[0], new_ds[1])
            for mode, got_p in (("fp64", new64), ("ds", ds_pos)):
                print(f"accuracy N={n} {mode}: one dt={QA_DT} Euler step, max|dpos| against "
                      f"the native float64 oracle {np.abs(got_p[:, :3] - ref[:, :3]).max():.3e} "
                      "(bound 1e-11)")


@contextlib.contextmanager
def host_functional():
    """The drift check's energies from the host float64 functional, the
    functional it ran on the card at N <= 131072 before the double
    potential kernel."""
    import nbody_tpu_torch.compute as compute
    from nbody_tpu_torch.ops import energy

    kept = compute.total_energy_precise
    compute.total_energy_precise = lambda pos, vel, soft, **kw: energy.total_energy_f64(
        pos, vel, soft)
    try:
        yield
    finally:
        compute.total_energy_precise = kept


def drift(torch, smi: str) -> None:
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.ops import energy

    for n, steps in ((16384, 10), (65536, 3)):
        c = Compute(num_bodies=n, device="cuda", precision="fp64", log=lambda s: None)
        pos, vel = c.system.state
        soft = c.active_params.softening
        energy.total_energy_precise(pos, vel, soft)  # builds and warms
        t0 = time.perf_counter()
        e_card = energy.total_energy_precise(pos, vel, soft)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        e_host = energy.total_energy_f64(pos, vel, soft)
        t_host = time.perf_counter() - t0
        print(f"drift N={n}: the float64 functional on the card {t_card:.4f} s, on the host "
              f"{t_host:.3f} s, relative difference {abs(e_card - e_host) / abs(e_host):.2e} "
              f"[{smi}]")
        for label, ctx in (("card functional", contextlib.nullcontext()),
                           ("host functional", host_functional())):
            with ctx:
                t0 = time.perf_counter()
                out = c.drift_check(steps)
                secs = time.perf_counter() - t0
            print(f"drift N={n}, {steps} steps, {label}: {secs:.2f} s, drift device "
                  f"{out['drift_device']:.6e}, oracle {out['drift_oracle']:.6e}, delta "
                  f"{out['delta']:.3e} [{smi}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="ptxas and SASS only")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    sys.stdout.reconfigure(line_buffering=True)
    import torch

    if not torch.cuda.is_available():
        print("torch_fp64_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from nbody_tpu_torch.utils.timing import card_line

    smi = card_line()
    print(f"card: {smi}")
    per_pair = sass_report()
    if args.quick:
        return 0
    kernels(torch, per_pair, args.rounds, smi)
    systems(torch, args.rounds, smi)
    accuracy(torch)
    drift(torch, smi)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
