"""The P3M contract's life cycle on a collapsing cluster, on the PyTorch /
CUDA port.

The port's counterpart of ``examples/collapsing_cluster.py``. The fast
solver's cell capacity is sized from the first state; a cold collapse
packs the bodies until a cell outgrows it. Every step of ``update_many``
probes the contract on the device, and there are two patterns:

1. unattended (the default): ``p3m_auto_refresh=True``, one
   ``update_many(STEPS)`` call; on a breach the system rewinds to the
   breached step, re-sizes the capacity from that state and resumes;
2. manual segments (``--manual``): the run goes in segments, watches for
   the warning (which names the breached step), calls
   ``refresh_p3m_contract()`` and goes on.

It prints the short-range engine the system resolved to: the CUDA pair
kernel for ``auto`` (``--short-range auto|pallas``) or the cell-list
engine (``--short-range xla``).

Runs on the card: ``python examples/collapsing_cluster_torch.py
[--manual]`` (N = 8192, 20000 steps, the JAX example's accelerator run);
``--cpu`` runs the plain versions on the host (400 steps, the JAX
example's host budget). ``--numbodies`` and ``--steps`` shrink the run (the
CPU test runs N = 256, 40 steps).
"""

import argparse
import warnings

import numpy as np
import torch

from nbody_tpu_torch import NBodyConfig, ic
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.params import NBodyParams

DT = 0.004


def make_system(n, device, short_range, **kw):
    pos, vel = ic.generate(NBodyConfig.SHELL, n, 1.5, 0.2, seed=11)  # a cold shell
    return BodySystem(n, NBodyParams(softening=0.05, damping=1.0), device=device,
                      kernel="p3m", pm_grid=48, integrator="leapfrog",
                      p3m_short_range=short_range, state=(pos, vel), **kw)


def run_unattended(s, steps):
    cap0 = s.p3m_capacity
    print(f"start: capacity={cap0}, engine={s.p3m_short_range}, steps={steps} "
          "(one call, auto-refresh on breach)")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s.update_many(steps, DT)
    broken = [w for w in caught if "contract broken" in str(w.message)]
    return len(broken) == 0, (f"capacity {cap0} -> {s.p3m_capacity}, "
                              f"{len(s.p3m_refreshes)} rewinds")


def run_manual(s, steps):
    print(f"start: capacity={s.p3m_capacity}, engine={s.p3m_short_range}")
    segments = 8
    per = max(steps // segments, 1)
    refreshes = 0
    for seg in range(segments):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            s.update_many(per, DT)
        breach = [w for w in caught if "contract broken" in str(w.message)]
        if breach:
            s.refresh_p3m_contract()
            refreshes += 1
            print(f"segment {seg}: {breach[0].message} -> refreshed "
                  f"(capacity now {s.p3m_capacity})")
        else:
            print(f"segment {seg}: ok (capacity {s.p3m_capacity})")
    return True, f"{refreshes} manual refreshes"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the host")
    ap.add_argument("--manual", action="store_true",
                    help="segments with refresh_p3m_contract() on a breach")
    ap.add_argument("--short-range", choices=["auto", "pallas", "xla"], default="auto",
                    help="the P3M short-range engine (auto: the pair kernel)")
    ap.add_argument("--numbodies", type=int, default=8192,
                    help="N (default 8192; the CPU test: 256)")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps (default 20000 on the card, 400 with --cpu; the CPU test: 40)")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    steps = args.steps or (400 if args.cpu else 20_000)
    s = make_system(args.numbodies, device, args.short_range,
                    p3m_auto_refresh=not args.manual)
    ok, note = (run_manual if args.manual else run_unattended)(s, steps)
    pos = s.positions
    r = np.linalg.norm(pos[:, :3] - pos[:, :3].mean(0), axis=1)
    finite = bool(np.isfinite(pos).all())
    print(f"done: {steps} steps, {note}, median radius {np.median(r):.2f} (finite={finite})")
    return 0 if ok and finite else 1


if __name__ == "__main__":
    raise SystemExit(main())
