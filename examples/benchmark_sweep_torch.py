"""Benchmark sweep across N, force variants and solver families, on the
PyTorch / CUDA port.

The port's counterpart of ``examples/benchmark_sweep.py``: the exact
all-pairs kernels (``vpu``, the one-sided kernel, and ``mxu_bf16``, the
force reduced on the tensor cores) and the mesh solvers (``pm``, ``p3m``)
through ``Compute.run_benchmark(10)``, so that the O(N^2) against O(N)
crossover shows in one table. The N^2 rates of pm and p3m would be
fictitious, so only their ms a step is printed.

Runs on the card: ``python examples/benchmark_sweep_torch.py [N ...]``
(default N = 16384 and 65536); ``--cpu`` runs the plain versions on the
host. A row that fails is printed, and the exit code is 1.
"""

import argparse

import torch

from nbody_tpu_torch.compute import Compute

ROWS = [("auto", "vpu"), ("auto", "mxu_bf16"), ("pm", "-"), ("p3m", "-")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", type=int, nargs="*", default=[16384, 65536],
                    help="the N of the sweep (default 16384 65536)")
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the host")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    failed = 0
    print(f"{'N':>9} {'kernel':>7} {'variant':>9} {'ms/step':>9} "
          f"{'G int/s':>9} {'GFLOP/s':>9}")
    for n in args.sizes:
        for kernel, variant in ROWS:
            kw = {"variant": variant} if kernel == "auto" else {}
            try:
                c = Compute(num_bodies=n, device=device, cycle_demo=False, kernel=kernel,
                            log=lambda *a: None, **kw)
                r = c.run_benchmark(10)
            except Exception as e:  # noqa: BLE001 - a row's failure is reported and counted
                print(f"{n:>9} {kernel:>7} {variant:>9}  failed: {e}")
                failed += 1
                continue
            ms = r["milliseconds"] / 10
            if kernel in ("pm", "p3m"):
                print(f"{n:>9} {kernel:>7} {variant:>9} {ms:>9.3f} {'-':>9} {'-':>9}")
            else:
                print(f"{n:>9} {kernel:>7} {variant:>9} {ms:>9.3f} "
                      f"{r['interactions_per_second_e9']:>9.1f} {r['gflops']:>9.0f}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
