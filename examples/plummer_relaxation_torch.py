"""Two-body relaxation of a Plummer sphere: the N-scaling law, measured on
the PyTorch / CUDA port.

The port's counterpart of ``examples/plummer_relaxation.py``. Discreteness
makes each body's specific energy e_i = v^2/2 + phi(x_i) random-walk on the
two-body relaxation timescale. With a fixed softening eps the Coulomb
logarithm ln(r_h / eps) does not depend on N, so the diffusion rate
var(delta e / e) / T times N is the invariant:

  1. build an isotropic Plummer sphere in virial equilibrium,
  2. evolve it with the leapfrog for T (``BodySystem(integrator=
     "leapfrog")``, the card's force kernels),
  3. measure the spread of delta e_i from the per-row potential
     (``ops.energy.potential_energy_per_row``), accumulated in float64 on
     the host.

A flat rate * N over the ladder is the 1/N discreteness scaling of
two-body relaxation.

Runs on the card: ``python examples/plummer_relaxation_torch.py`` (N =
1024, 4096, 16384); ``--cpu`` runs the plain versions on the host with the
JAX example's host ladder (N = 256, 1024).
"""

import argparse

import numpy as np
import torch

from nbody_tpu_torch import NBodyConfig, ic
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.ops.energy import potential_energy_per_row
from nbody_tpu_torch.params import NBodyParams

EPS = 0.02  # small softening: close encounters drive relaxation
DT = 0.01
T = 2.0
CARD_LADDER = (1024, 4096, 16384)
HOST_LADDER = (256, 1024)


def specific_energies(pos, vel, device):
    """Per-body e_i = v_i^2/2 + phi(x_i) in float64 on the host: the row
    sums m_i sum_j m_j / r_ij come from the device, phi_i = -row_i / m_i."""
    row = potential_energy_per_row(torch.tensor(pos, device=device), EPS)
    row = row.cpu().numpy().astype(np.float64)
    m = pos[:, 3].astype(np.float64)
    v2 = (vel[:, :3].astype(np.float64) ** 2).sum(axis=1)
    return 0.5 * v2 - row / m


def relaxation_rate(n, device) -> float:
    """var(delta e / |median e|) / T of an N-body Plummer sphere."""
    pos, vel = ic.generate(NBodyConfig.PLUMMER, n, 1.0, 1.0, seed=7)
    e0 = specific_energies(pos, vel, device)
    s = BodySystem(n, NBodyParams(time_step=DT, softening=EPS, damping=1.0), device=device,
                   integrator="leapfrog", state=(pos, vel))
    s.update_many(int(round(T / DT)))
    e1 = specific_energies(s.positions, s.velocities, device)
    return float(np.var((e1 - e0) / abs(np.median(e0))) / T)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions on the host, N = 256 and 1024")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    steps = int(round(T / DT))
    print(f"leapfrog, dt={DT}, T={T} ({steps} steps), eps={EPS}, on {device.type}")
    rates = []
    for n in HOST_LADDER if args.cpu else CARD_LADDER:
        rate = relaxation_rate(n, device)
        rates.append(rate * n)
        print(f"  N={n:6d}: rate={rate:.2e}   rate*N={rate * n:.2f}")
    print("flat rate*N = the 1/N discreteness scaling of two-body "
          "relaxation (fixed-softening Coulomb log)")
    return 0 if all(np.isfinite(rates)) and min(rates) > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
