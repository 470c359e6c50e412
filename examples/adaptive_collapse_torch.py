"""Adaptive timestep on a cold collapse, on the PyTorch / CUDA port: the
right dt, only when it is needed.

The port's counterpart of ``examples/adaptive_collapse.py``. A cold
collapse has no single good dt: the quiet shell takes the preset's dt, and
the core bounce needs a far smaller one. ``BodySystem.update_many_adaptive``
picks one global dt a step on the device from the step's force
(``ops/adaptive.py``), so the run takes small steps only through the
bounce. Three leapfrog runs to the same simulated time T, the energy
measured with the float64 functional:

1. fixed dt = dt_max (the quiet phase's step): the bounce is unresolved;
2. adaptive (eta = 0.01, dt in [dt_max / 1024, dt_max]);
3. fixed dt = the smallest dt the adaptive run took: comparable accuracy,
   but every step pays the bounce's price.

Runs on the card: ``python examples/adaptive_collapse_torch.py`` (N = 8192,
T = 1.0, the JAX example's accelerator size); ``--cpu`` runs the plain
versions on the host (N = 1024). ``--numbodies`` and ``--time`` shrink the
run (the CPU test runs N = 128, T = 0.2).
"""

import argparse

import numpy as np
import torch

from nbody_tpu_torch import NBodyConfig, ic
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.params import NBodyParams

P = NBodyParams(softening=0.1, damping=1.0)
DT_MAX = 0.016  # demo 0's preset dt: fine for the quiet shell phase
ETA = 0.01
SEGMENT = 500


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the host")
    ap.add_argument("--numbodies", type=int, default=None,
                    help="N (default 8192 on the card, 1024 with --cpu; the CPU test: 128)")
    ap.add_argument("--time", type=float, default=1.0,
                    help="simulated time T (default 1.0; the CPU test: 0.2)")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    n = args.numbodies or (1024 if args.cpu else 8192)
    t_end = args.time
    pos, vel = ic.generate(NBodyConfig.SHELL, n, 1.5, 0.2, seed=11)
    vel = vel * 0.0  # cold: the shell free-falls and bounces at the core

    def fresh():
        return BodySystem(n, P, device=device, integrator="leapfrog", state=(pos, vel))

    bs = fresh()
    e0 = bs.total_energy(precise=True)

    def drift(s):
        return (s.total_energy(precise=True) - e0) / abs(e0)

    # 1. fixed at the quiet phase's dt: the bounce is unresolved
    k_coarse = int(round(t_end / DT_MAX))
    bs.update_many(k_coarse, DT_MAX)
    d_coarse = drift(bs)
    print(f"N={n} on {device.type}: fixed dt={DT_MAX}: {k_coarse} steps to t={t_end}, "
          f"dE/E = {d_coarse:+.2e}")

    # 2. adaptive, in segments until the simulated time reaches T
    bs = fresh()
    t, steps, dt_lo = 0.0, 0, np.inf
    while t < t_end:
        st = bs.update_many_adaptive(SEGMENT, eta=ETA, dt_max=DT_MAX)
        t += st["t"]
        steps += SEGMENT
        dt_lo = min(dt_lo, st["dt_lo"])
    d_adaptive = drift(bs)
    print(f"adaptive eta={ETA}: {steps} steps to t={t:.3f}, dt spanned "
          f"[{dt_lo:.2e}, {DT_MAX}] ({DT_MAX / dt_lo:.0f}x), dE/E = {d_adaptive:+.2e}")

    # 3. fixed at the adaptive run's smallest dt: every step pays the
    #    bounce's price
    k_fine = int(round(t_end / dt_lo))
    bs = fresh()
    bs.update_many(k_fine, float(dt_lo))
    d_fine = drift(bs)
    print(f"fixed dt={dt_lo:.2e}: {k_fine} steps ({k_fine / steps:.1f}x the adaptive run), "
          f"dE/E = {d_fine:+.2e}")
    return 0 if np.isfinite([d_coarse, d_adaptive, d_fine]).all() else 1


if __name__ == "__main__":
    raise SystemExit(main())
