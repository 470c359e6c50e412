#!/usr/bin/env python3
"""On-card smoke test of nbody_tpu_torch, the PyTorch / CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX. Phases, each printing its result:
  1. device: the card, its compute capability (9.0 required), CUDA, nvcc,
     and nvidia-smi's name and power limit;
  2. build: the CUDA kernels with nvcc from nbody_tpu_torch/csrc;
  3. kernels against their plain PyTorch versions on the card, at
     N in {1000, 4099, 65536}, one i-vs-j case with M != N, block sizes 128
     and 256, random masses, vel.w and damping 0.5 at N in {4099, 65536},
     and their times at N=65536;
  4. QA, the reference's rule, through Compute.compare_results at N=16384;
  5. the main path at full size: Compute.run_benchmark at N=65536, beside
     the plain version's time per step;
  6. placement="host" against placement="device", bit for bit;
  7. the CLI in subprocesses: --qatest and --benchmark.
Phases 4 and 5 are the main path's run: the kernels' launch counters are
set to 0 before it and read after it, and each kernel must have launched.
Any failure raises, and the script exits nonzero. The last lines are one
JSON object per kernel and then the result line.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

N_MAIN = 65536  # BASELINE.json configs[1] and bench.py's N
N_QA = 16384  # nbody_tpu's per-core default N
KERNEL_SOURCE = "nbody_tpu_torch/csrc/nbody_kernels.cu"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_device(torch) -> str:
    from nbody_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    nvcc = _build.find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
    release = [ln for ln in version.splitlines() if "release" in ln]
    smi = nvidia_smi_line()
    print(f"[1 device] {name}, compute capability {cap[0]}.{cap[1]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {release[0].strip() if release else version.strip()}")
    print(f"[1 device] nvidia-smi: {smi}")
    check(cap == (9, 0), f"compute capability {cap} is not 9.0 (Hopper, sm_90a)")
    return smi


def phase_build() -> None:
    from nbody_tpu_torch.ops import _build

    existed = _build.library_path().exists()
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    secs = time.perf_counter() - t0
    print(f"[2 build] {lib.relative_to(ROOT)} "
          f"{'already built' if existed else 'built'} in {secs:.1f} s")


def phase_kernels(torch) -> dict:
    """Kernel against plain on the card. Only the order of the j-sum differs
    (the kernel adds sequentially per thread, PyTorch reduces in tree
    order), so the acceleration is held to 1e-4 * max|a| + 1e-4, the bound
    of tests/test_pallas.py:76. One demo-0 step carries that error into the
    velocity as dt * da and into the position as dt^2 * da; the step bound
    is 1e-5 plus those. (With unit masses, max|a| is ~1800 at N=65536, and
    reduction order alone moves one step's velocity by ~3e-4 there.)

    Shell ICs have unit masses and vel.w = 0, and demo 0 has damping 1, so
    the last cases draw masses from [0.5, 2], a random vel.w and damping
    0.5: a kernel that weights a pair by m_i, drops the damping or zeroes
    vel.w fails them."""
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import reference
    from nbody_tpu_torch.utils.timing import elapsed_ms

    dev = torch.device("cuda", 0)
    demo = DEMO_PARAMS[0]
    dt, soft, damp = demo.time_step, demo.softening, demo.damping
    err = {"step": 0.0, "accel": 0.0}
    # (M, N, block, masses and vel.w drawn at random, damping)
    cases = [(n, n, bs, False, damp) for n in (1000, 4099, N_MAIN) for bs in (128, 256)]
    cases.append((777, 4099, 256, False, damp))  # i-vs-j, M != N
    cases += [(4099, 4099, 256, True, 0.5), (N_MAIN, N_MAIN, 256, True, 0.5)]
    for m, n, bs, rand_w, dmp in cases:
        scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
        pos, vel = ic.generate(NBodyConfig.SHELL, n, *scales, seed=42)
        if rand_w:
            rng = np.random.default_rng(7)
            pos[:, 3] = rng.uniform(0.5, 2.0, n)
            vel[:, 3] = rng.standard_normal(n)
        pj = torch.tensor(pos, device=dev)
        pi = pj[:m].contiguous()
        vi = torch.tensor(vel[:m], device=dev)

        a_k = ck.compute_accel_cuda(pi, pj, soft, block_size=bs)
        a_r = reference.compute_accel_vs(pi, pj, soft)
        p_k, v_k = ck.nbody_step_cuda_vs(pi, vi, pj, dt, soft, dmp, block_size=bs)
        p_r, v_r = reference.nbody_step_vs(pi, vi, pj, dt, soft, dmp)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(a_k).all() and torch.isfinite(p_k).all()
                   and torch.isfinite(v_k).all()), f"non-finite kernel output at M={m} N={n}")
        tol_a = 1e-4 * a_r.abs().max().item() + 1e-4
        tol_v = 1e-5 + dt * tol_a
        tol_p = 1e-5 + dt * dt * tol_a
        e_a = (a_k - a_r).abs().max().item()
        e_p = (p_k - p_r).abs().max().item()
        e_v = (v_k - v_r).abs().max().item()
        passthrough = bool(torch.equal(p_k[:, 3], pi[:, 3]) and torch.equal(v_k[:, 3], vi[:, 3]))
        what = f"M={m} N={n} block={bs} damping={dmp}" + (
            ", random masses and vel.w" if rand_w else "")
        print(f"[3 kernels] {what}: accel max|da|={e_a:.3e} "
              f"(tol {tol_a:.3e}); step max|dpos|={e_p:.3e} (tol {tol_p:.3e}) "
              f"max|dvel|={e_v:.3e} (tol {tol_v:.3e}); w-lanes kept: {passthrough}")
        check(e_a <= tol_a, f"accel kernel disagrees at {what}")
        check(e_p <= tol_p and e_v <= tol_v, f"step kernel disagrees at {what}")
        check(passthrough, f"step kernel changed pos.w or vel.w at {what}")
        err["accel"] = max(err["accel"], e_a)
        err["step"] = max(err["step"], e_p, e_v)

    # times at the main path's shape: N=65536, the default block of 256
    pos, vel = ic.generate(NBodyConfig.SHELL, N_MAIN, demo.cluster_scale,
                           demo.velocity_scale, seed=42)
    p = torch.tensor(pos, device=dev)
    v = torch.tensor(vel, device=dev)
    out = (torch.empty_like(p), torch.empty_like(v))
    reps, plain_reps = 20, 3

    def step_kernel():
        for _ in range(reps):
            ck.nbody_step_cuda(p, v, dt, soft, damp, out=out)

    def accel_kernel():
        for _ in range(reps):
            ck.compute_accel_cuda(p, p, soft)

    def step_plain():
        for _ in range(plain_reps):
            reference.nbody_step(p, v, dt, soft, damp)

    def accel_plain():
        for _ in range(plain_reps):
            reference.compute_accel(p, soft)

    times = {}
    for name, kernel, plain in (("step", step_kernel, step_plain),
                                ("accel", accel_kernel, accel_plain)):
        kernel()
        plain()  # warm-up of both
        t_k = elapsed_ms(kernel, dev) / reps
        t_p = elapsed_ms(plain, dev) / plain_reps
        times[name] = (t_k, t_p)
        print(f"[3 kernels] {name} at N={N_MAIN}, block 256: kernel {t_k:.3f} ms, "
              f"plain {t_p:.3f} ms per call")
    return {"err": err, "times": times}


def phase_qa(torch, ck) -> None:
    from nbody_tpu_torch.compute import Compute

    before = dict(ck.LAUNCHES)
    compute = Compute(num_bodies=N_QA, device="cuda", log=lambda s: print(f"[4 QA] {s}"))
    passed = compute.compare_results()
    check(passed, "QA compare against the CPU oracle failed")
    check(ck.LAUNCHES["step"] > before["step"], "QA step did not launch the step kernel")
    check(ck.LAUNCHES["accel"] > before["accel"], "QA force check did not launch the accel kernel")


def phase_main(torch, smi: str) -> None:
    from nbody_tpu_torch.compute import Compute

    compute = Compute(num_bodies=N_MAIN, device="cuda", log=lambda s: print(f"[5 main] {s}"))
    res = compute.run_benchmark(10)
    check(compute.system.backend == "cuda", "the main path did not select the CUDA backend")
    pos, vel = compute.system.state
    check(tuple(pos.shape) == (N_MAIN, 4), f"state shape {tuple(pos.shape)}")
    check(bool(torch.isfinite(pos).all() and torch.isfinite(vel).all()),
          "non-finite state after the benchmark")
    ms = res["milliseconds"] / res["iterations"]
    print(f"[5 main] kernel: {ms:.3f} ms per step, "
          f"{res['interactions_per_second_e9']:.3f} G interactions/s, "
          f"{res['gflops']:.3f} GFLOP/s at 20 flops per interaction [{smi}]")


def phase_plain_main(smi: str) -> None:
    from nbody_tpu_torch.compute import Compute

    plain = Compute(num_bodies=N_MAIN, device="cuda", backend="torch",
                    log=lambda s: print(f"[5 main, plain] {s}"))
    res = plain.run_benchmark(3)
    print(f"[5 main] plain PyTorch: {res['milliseconds'] / res['iterations']:.3f} ms "
          f"per step [{smi}]")


def phase_host(torch) -> None:
    from nbody_tpu_torch import DEMO_PARAMS, tuned_scales
    from nbody_tpu_torch.models import BodySystem

    cs, vs = tuned_scales(N_QA)
    params = DEMO_PARAMS[0].replace(cluster_scale=cs, velocity_scale=vs)
    dev = BodySystem(N_QA, params, device="cuda", placement="device", seed=42)
    host = BodySystem(N_QA, params, device="cuda", placement="host", seed=42)
    check(host.state[0].is_pinned(), "placement='host' state is not in pinned memory")
    dev.update_many(5)
    host.update_many(5)
    dev.synchronize()
    same = bool((dev.positions == host.positions).all() and
                (dev.velocities == host.velocities).all())
    print(f"[6 host] 5 steps at N={N_QA}: host placement equals device placement "
          f"bit for bit: {same}")
    check(same, "placement='host' differs from placement='device'")


def phase_cli() -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    runs = ((["--qatest", "--numbodies", "4096"], "-> OK"),
            (["--benchmark", "--numbodies", str(N_MAIN), "-i", "10"],
             "billion interactions per second"))
    for args, expect in runs:
        cmd = [sys.executable, "-m", "nbody_tpu_torch.cli", *args]
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        for line in proc.stdout.strip().splitlines():
            print(f"[7 cli] {line}")
        if proc.returncode != 0 or expect not in proc.stdout:
            print(proc.stderr, file=sys.stderr)
        check(proc.returncode == 0, f"{' '.join(args)} exited {proc.returncode}")
        check(expect in proc.stdout, f"{' '.join(args)} printed no {expect!r}")


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    import nbody_tpu_torch

    pkg = pathlib.Path(nbody_tpu_torch.__file__).resolve()
    check(pkg.is_relative_to(ROOT), f"nbody_tpu_torch imported from {pkg}, not "
          f"from this checkout ({ROOT})")
    from nbody_tpu_torch.ops import cuda_kernel as ck

    t0 = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    kern = phase_kernels(torch)

    # the main path's run: counters from 0, read right after
    for k in ck.LAUNCHES:
        ck.LAUNCHES[k] = 0
    phase_qa(torch, ck)
    phase_main(torch, smi)
    launches = dict(ck.LAUNCHES)
    print(f"[5 main] kernel launches on the main path: {launches}")
    for k, count in launches.items():
        check(count > 0, f"kernel {k!r} was not launched on the main path")
    phase_plain_main(smi)

    phase_host(torch)
    phase_cli()
    check("jax" not in sys.modules, "JAX was imported")
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    replaces = {"step": "nbody_tpu/ops/pallas_kernel.py:90",
                "accel": "nbody_tpu/ops/pallas_kernel.py:272"}
    names = {"step": "nbody_step_f32", "accel": "nbody_accel_f32"}
    kernels = [{
        "name": names[k],
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": replaces[k],
        "launches": launches[k],
        "max_abs_err": kern["err"][k],
        "ms": kern["times"][k][0],
        "plain_ms": kern["times"][k][1],
    } for k in ("step", "accel")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
