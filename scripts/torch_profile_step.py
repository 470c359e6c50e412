#!/usr/bin/env python3
"""Where a step's device time goes: torch.profiler over Compute's steps of
nbody_tpu_torch on the card, one-sided and each-pair-once, Euler and Hermite,
float32 and double-single.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_profile_step.py

For each (variant, N) in {vpu, sym} x {65536, 135168} with Euler, for
each variant with Hermite at N=65536, for the tensor-core variants (mxu,
mxu_bf16) with Euler at N=65536, for precision="ds" with Euler (auto,
the ds triangle) at N in {16384, 69632} and leapfrog at 16384, and for ds
Hermite (auto, the ds accel + jerk triangle, and one_sided) at 16384 and
auto at 36864, above its cap, it builds the Compute of the path, waits one
window and warms up one, then records one active window of 10 steps
(update_many(10) and a synchronise). It prints the device time of each
kernel, the host wall time of the window (launch of the first step to the
end of the synchronise), the device's idle share, 1 - (sum of kernel
times) / wall, and the glue's share of the device time (the kernels other
than the force evaluations: partial sums, updates, predictor and
corrector, elementwise ops); the kernels run on one stream, so they never
overlap. Then the nvidia-smi name and power limit.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STEPS = 10
CONFIGS = [(variant, n, "euler", "fp32") for variant in ("vpu", "sym") for n in (65536, 135168)]
CONFIGS += [(variant, 65536, "hermite", "fp32") for variant in ("vpu", "sym")]
CONFIGS += [(variant, 65536, "euler", "fp32") for variant in ("mxu", "mxu_bf16")]
CONFIGS += [("auto", n, "euler", "ds") for n in (16384, 69632)]
CONFIGS += [("auto", 16384, "leapfrog", "ds")]
CONFIGS += [(variant, 16384, "hermite", "ds") for variant in ("auto", "one_sided")]
CONFIGS += [("auto", 36864, "hermite", "ds")]
# the kernels that evaluate forces; every other kernel of a step is glue
FORCE_KERNELS = ("step_kernel", "accel_kernel", "accel_jerk_kernel", "tri_kernel",
                 "cross_kernel", "leapfrog_kernel")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from nbody_tpu_torch.compute import Compute

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for variant, n, integrator, precision in CONFIGS:
        c = Compute(num_bodies=n, device="cuda", variant=variant, integrator=integrator,
                    precision=precision, log=lambda s: None)
        system = c.system
        walls = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=1, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(3):
                t0 = time.perf_counter()
                system.update_many(STEPS)
                system.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                prof.step()
        kernels = {}
        for evt in prof.key_averages():
            # ProfilerStep# is the profiler's own span around the window
            if (evt.device_type == torch.autograd.DeviceType.CUDA
                    and not evt.key.startswith("ProfilerStep")):
                us = getattr(evt, "device_time_total", None)
                if us is None:
                    us = evt.cuda_time_total
                kernels[evt.key] = (us, evt.count)
        busy_ms = sum(us for us, _ in kernels.values()) / 1e3
        glue_ms = sum(us for key, (us, _) in kernels.items()
                      if not any(f in key for f in FORCE_KERNELS)) / 1e3
        wall_ms = walls[-1]
        print(f"{precision} {variant} {integrator} N={n}: {STEPS} steps, host wall {wall_ms:.4f} ms, "
              f"device busy {busy_ms:.4f} ms, idle share {1 - busy_ms / wall_ms:.4f}, glue share "
              f"{glue_ms / busy_ms:.4f} [{smi}]")
        for key, (us, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
            print(f"    {us / 1e3:10.4f} ms  {count:4d} calls  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
