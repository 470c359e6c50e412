#!/usr/bin/env python3
"""Measure the tensor-core step kernels (csrc/mxu_kernels.cu) and the
transposed-carry rollout kernel (csrc/nbody_kernels.cu::step_t_kernel) of
nbody_tpu_torch on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_mxu_bench.py [--quick]

First it prints what ptxas says of each kernel of csrc/mxu_kernels.cu and
csrc/nbody_kernels.cu (registers, spills, shared memory) and the
instruction mix of the SASS (cuobjdump), by opcode, of the two mxu kernels
and of the one-sided step kernel beside the rollout's. Then
it holds both mxu kernels to their plain versions (ops/reference.py) under
the mxu error model at small ragged shapes with masses from [0.5, 2], a
random vel.w and damping 0.5 (the largest ratio of error to bound, and a
repeat call bit-equal), and the rollout to k launches of the step kernel,
bit for bit. --quick stops there. Then it times, at N = 16384, 65536 and
135168 (shell ICs, demo-0 parameters), the mxu and mxu_bf16 steps beside
the one-sided step kernel and the each-pair-once force (the fp32 `auto`
path's kernel): CUDA events over `reps` calls after one warm-up call, two
rounds taken in turns; and the rollout of 10 steps against 10 step-kernel
launches at N = 4096, 16384 and 65536, in turns. Prints one line per
measurement and the nvidia-smi name and power limit.
"""

from __future__ import annotations

import collections
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def ptxas_report() -> None:
    """Compile the two sources once more with -Xptxas -v and print what
    ptxas says of each kernel."""
    from nbody_tpu_torch.ops import _build

    for src in ("mxu_kernels.cu", "nbody_kernels.cu"):
        for line in _build.ptxas_lines(src):
            print(line)


# (source, {label: a substring of the kernel's mangled name})
SASS_KERNELS = (("mxu_kernels.cu", {"tf32x3": "Tf32x3", "bf16": "Bf16"}),
                ("nbody_kernels.cu", {"step": "11step_kernel", "step_t": "13step_t_kernel"}))


def sass_mix() -> None:
    """The opcodes of the mxu kernels' and of the two one-sided step
    kernels' SASS, counted over the whole function (the j-loops dominate
    it)."""
    from nbody_tpu_torch.ops import _build

    for src, labels in SASS_KERNELS:
        _, sass = _build.sass_of(src)
        kernel, mix = None, {}
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                kernel = next((k for k, key in labels.items() if key in m.group(1)), None)
                if kernel:
                    mix[kernel] = collections.Counter()
                continue
            m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if kernel and m:
                mix[kernel][m.group(1).split(".")[0]] += 1
        for kernel, counts in mix.items():
            top = ", ".join(f"{op} {n}" for op, n in counts.most_common(16))
            print(f"sass {kernel}: {sum(counts.values())} instructions: {top}")


def main() -> int:
    import numpy as np
    import torch

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import reference
    from nbody_tpu_torch.utils.timing import elapsed_ms

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    assert not torch.backends.cuda.matmul.allow_tf32
    ptxas_report()
    sass_mix()
    dev = torch.device("cuda", 0)
    demo = DEMO_PARAMS[0]
    dt, soft = demo.time_step, demo.softening

    def state(n, seed=42, random_w=False):
        scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
        pos, vel = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed)
        if random_w:
            rng = np.random.default_rng(7)
            pos[:, 3] = rng.uniform(0.5, 2.0, n)
            vel[:, 3] = rng.standard_normal(n)
        return torch.tensor(pos, device=dev), torch.tensor(vel, device=dev)

    ok = True
    for m, n in ((1, 33), (33, 1), (100, 100), (333, 1000), (1000, 333), (4099, 4099)):
        pj, _ = state(n, random_w=True)
        pi, vi = state(m, seed=3, random_w=True)
        for variant in reference.MXU_VARIANTS:
            got = ck.nbody_step_mxu_cuda_vs(pi, vi, pj, dt, soft, 0.5, variant=variant)
            again = ck.nbody_step_mxu_cuda_vs(pi, vi, pj, dt, soft, 0.5, variant=variant)
            want = reference.nbody_step_mxu_vs(pi, vi, pj, dt, soft, 0.5,
                                               mxu_dtype=reference.MXU_DTYPES[variant])
            tol_p, tol_v = reference.mxu_step_tolerance(pi, vi, pj, want, dt, soft, 0.5,
                                                        variant=variant)
            ratio = max(((got[0][:, :3] - want[0][:, :3]).abs() / tol_p).max().item(),
                        ((got[1][:, :3] - want[1][:, :3]).abs() / tol_v).max().item())
            same = bool(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
            kept = bool(torch.equal(got[0][:, 3], pi[:, 3]) and torch.equal(got[1][:, 3], vi[:, 3]))
            ok &= ratio <= 1.0 and same and kept
            print(f"check {variant} M={m} N={n}: max error / bound {ratio:.3e}, repeat "
                  f"bit-equal {same}, w lanes kept {kept}")
    for n, bs in ((1, 128), (1000, 128), (4099, 256)):
        p, v = state(n, random_w=True)
        gp, gv = ck.nbody_rollout_cuda(p, v, dt, soft, 0.5, steps=4, block_size=bs)
        sp, sv = p, v
        for _ in range(4):
            sp, sv = ck.nbody_step_cuda(sp, sv, dt, soft, 0.5, block_size=bs)
        same = bool(torch.equal(gp, sp) and torch.equal(gv, sv))
        ok &= same
        print(f"check rollout N={n} block {bs}: 4 steps equal 4 step launches bit for bit: {same}")
    print(f"checks {'passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    if "--quick" in sys.argv:
        print(f"card: {smi}")
        return 0

    for n in (16384, 65536, 135168):
        p, v = state(n)
        out = (torch.empty_like(p), torch.empty_like(v))
        reps = max(3, int(20 * (65536 / n) ** 2))
        runs = {
            "vpu step": lambda: ck.nbody_step_cuda(p, v, dt, soft, 1.0, out=out),
            "sym force": lambda: ck.compute_accel_symmetric_blocked_cuda(p, soft),
            "mxu step": lambda: ck.nbody_step_mxu_cuda(p, v, dt, soft, 1.0, variant="mxu",
                                                       out=out),
            "mxu_bf16 step": lambda: ck.nbody_step_mxu_cuda(p, v, dt, soft, 1.0,
                                                            variant="mxu_bf16", out=out),
        }
        ms = {name: [] for name in runs}
        order = list(runs) + list(reversed(runs))
        for name in order:
            fn = runs[name]
            fn()
            ms[name].append(elapsed_ms(lambda: [fn() for _ in range(reps)], dev) / reps)
        for name in runs:
            print(f"time N={n} {name}: {ms[name][0]:.4f} / {ms[name][1]:.4f} ms per call "
                  f"(two rounds in turns, {reps} calls each) [{smi}]")

    for n in (4096, 16384, 65536):
        p, v = state(n)
        bufs = [(torch.empty_like(p), torch.empty_like(v)) for _ in range(2)]

        def steps10():
            a, b = p, v
            for k in range(10):
                a, b = ck.nbody_step_cuda(a, b, dt, soft, 1.0, out=bufs[k % 2])

        def roll10():
            ck.nbody_rollout_cuda(p, v, dt, soft, 1.0, steps=10)

        steps10()
        roll10()
        ms = {"steps": [], "rollout": []}
        for name in ("steps", "rollout", "rollout", "steps"):
            ms[name].append(elapsed_ms(steps10 if name == "steps" else roll10, dev) / 10)
        print(f"time N={n} 10 steps: step kernel {ms['steps'][0]:.4f} / {ms['steps'][1]:.4f}, "
              f"rollout {ms['rollout'][0]:.4f} / {ms['rollout'][1]:.4f} ms per step "
              f"(in turns) [{smi}]")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
