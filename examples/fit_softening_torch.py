"""Fit a physical parameter to an observed trajectory by Newton steps, on
the PyTorch / CUDA port.

The port's counterpart of ``examples/fit_softening.py``: a short trajectory
made with a hidden softening, and the softening recovered from the final
positions alone by differentiating through the rollout
(``nbody_tpu_torch.ops.diff.rollout_diff``), its curvature a gradient of a
gradient.

Runs on the card: ``python examples/fit_softening_torch.py``; ``--cpu`` runs
the plain step on the host.
"""

import argparse

import torch

from nbody_tpu_torch import NBodyConfig, ic
from nbody_tpu_torch.ops.diff import rollout_diff

N = 256
STEPS = 8
DT = 0.005
TRUE_SOFTENING = 0.30
INIT_SOFTENING = 0.10
MAX_STEP = 0.05  # trust region for the Newton update
ITERS = 30


def fit(device, *, log=print) -> float:
    """The softening recovered from the target's final positions."""
    pos, vel = ic.generate(NBodyConfig.SHELL, N, 1.5, 2.0, seed=11)
    p0 = torch.tensor(pos, device=device)
    v0 = torch.tensor(vel, device=device)
    target, _ = rollout_diff(p0, v0, DT, TRUE_SOFTENING, 1.0, steps=STEPS)

    # second-order fit: the curvature (a gradient of the gradient through
    # the whole rollout) lets a trust-region Newton step handle the
    # decades-spanning gradient scale a fixed-rate descent would stall on
    s = torch.tensor(INIT_SOFTENING, dtype=torch.float32, device=device)
    for i in range(ITERS):
        soft = s.clone().requires_grad_()
        p, _ = rollout_diff(p0, v0, DT, soft, 1.0, steps=STEPS)
        loss = torch.mean((p[:, :3] - target[:, :3]) ** 2)
        (g,) = torch.autograd.grad(loss, soft, create_graph=True)
        (h,) = torch.autograd.grad(g, soft)
        step = torch.clamp(g.detach() / torch.clamp(h.abs(), min=1e-12), -MAX_STEP, MAX_STEP)
        s = s - step
        if i % 5 == 0 or i == ITERS - 1:
            log(f"iter {i:3d}  loss={float(loss.detach()):.3e}  softening={float(s):.4f}")
    return float(s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="the plain step on the host")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    s = fit(device)
    err = abs(s - TRUE_SOFTENING)
    print(f"recovered softening {s:.4f} (true {TRUE_SOFTENING}, |err| {err:.2e})")
    if err >= 5e-3:
        print("gradient fit failed to recover the parameter")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
