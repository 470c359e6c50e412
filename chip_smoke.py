#!/usr/bin/env python3
"""On-card smoke test of nbody_tpu_torch, the PyTorch / CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of nbody_tpu. Phases, each printing
its result:
  1. device: the card, its compute capability (9.0 required), CUDA, nvcc,
     and nvidia-smi's name and power limit;
  2. build: the CUDA kernels with nvcc from nbody_tpu_torch/csrc, one nvcc
     per source, started together;
  3. the one-sided kernels against their plain PyTorch versions on the
     card, at N in {1000, 4099, 65536}, one i-vs-j case with M != N, block
     sizes 128 and 256, random masses, vel.w and damping 0.5 at N in
     {4099, 65536}, and their times at N=65536;
  3s. the each-pair-once kernels against their plain versions: the
     triangle at N in {1000, 4099}, the blocked composition at N=65536 and
     at N=135168 (the main path's shapes), the rectangle at (777, 4099) and
     (cap, cap), random masses, vel.w and damping 0.5 through a step at
     N in {4099, 65536}; run-to-run bit equality; momentum; their times;
  3h. the accel + jerk kernels (one-sided, each-pair-once triangle and
     rectangle) and the potential kernel against their plain versions, at
     the cases of 3 and 3s, random masses, vel.w and damping 0.5 through a
     Hermite step of each variant at N in {4099, 65536}; bit equality;
     momentum and its derivative; their times;
  4. QA, the reference's rule, through Compute.compare_results at N=16384;
  5. the main path at full size: Compute.run_benchmark at N=65536, beside
     the plain version's time per step;
  5s. the each-pair-once main path: QA at N=16384 through
     Compute(variant="sym") with Euler and with leapfrog, run_benchmark(10)
     at N=65536, and steps at N=135168, above the composition's cap;
  5t. sym against one-sided steps through Compute at N=65536 and 135168,
     in turns;
  5h. the Hermite path: QA at N=16384 with sym and with vpu (position,
     acceleration and jerk against the oracle), run_benchmark(10) at
     N=65536 for vpu, sym, sym, vpu in turns and for auto, 3 steps at
     N=135168 for each variant, drift_check(5) at N=16384, and
     total_energy() (the potential kernel) at N=65536 beside
     total_energy(precise=True);
  6. placement="host" against placement="device", bit for bit, with Euler
     and with Hermite;
  3d. the double-single kernels (one-sided step and leapfrog, triangle,
     rectangle) against their plain versions at N in {4099, 16384}, with
     masses drawn in float64 from [0.5, 2], a random vel.w and damping 0.5,
     the triangle at both tiles of the dispatch table (256 and 512), the
     rectangle through the composition forced by a small cap; at N=69632,
     above the cap, the composition at its default dispatch (two tile-512
     triangles and one rectangle) and the rectangle alone: each output
     within 1e-12 * max + 1e-14 of the plain version, each force within
     1e-10 * max|a| of the float64 oracle's, repeat calls bit-equal; their
     times at N in {16384, 65536} and the rectangle's at the main path's
     shape;
  5d. the ds path through Compute(precision="ds"): QA at N=16384 against
     the float64 oracle for Euler auto (sym), Euler one_sided and leapfrog,
     run_benchmark at N=16384 beside the fp32 step and at N=69632, above
     the ds composition's cap, drift_check(10) at N=16384 and
     drift_check(60) at N=4096 with the two-tier gate; the ds Euler update
     kernel (glue, not in the kernels line) must have launched too;
  3dh. the double-single accel + jerk kernels (one-sided, triangle,
     rectangle) and the Hermite predictor and corrector against their plain
     versions at N in {4099, 16384}, masses from [0.5, 2] in float64, a
     random vel.w and damping 0.5, the triangle at both tiles of the
     dispatch table, the composition forced by a small cap, and at
     N=36864, above the cap, the default dispatch against the float64
     oracle: each output within 1e-12 * max + 1e-14 of plain, each force
     and jerk within 1e-10 * max of the oracle's, the glue bit-equal to
     plain, repeat calls bit-equal; their times at N=16384 and the
     rectangle's at the main path's shape;
  5dh. the ds Hermite path through Compute(precision="ds",
     integrator="hermite"): QA (position, force and jerk against the
     float64 oracle) for auto (sym) and one_sided at N=16384,
     run_benchmark(10) at 16384 for both beside the fp32 Hermite step, 3
     steps at N=36864, above the cap, drift_check(10) at 16384 and (60) at
     4096; the predictor and corrector kernels (glue, not in the kernels
     line) must have launched too;
  3m. the tensor-core step kernels (mxu: 3xTF32, mxu_bf16) against their
     plain versions under the mxu error model (reference.mxu_step_tolerance)
     at (M, N) in {(1000, 1000), (777, 4099), (4099, 777), (4099, 4099),
     (65536, 65536)}, random masses, vel.w and damping 0.5 at three of them,
     repeat calls bit-equal; the rollout kernel against k launches of the
     step kernel, bit for bit, and one rollout step against the plain step;
     their times at N=65536, the rollout's k=10 both ways in turns;
  5m. the tensor-core path through Compute(variant="mxu" / "mxu_bf16"): QA
     at N=16384 (the mxu force held to the oracle's under the one-sided
     rule plus its error model), run_benchmark(10) at N=65536 in turns with
     vpu, drift_check(10) with the --drift-check gate at N=16384 and 4096
     (mxu_bf16 at 4096 recorded, not gated: it fails there, as nbody_tpu's
     own kernel does), and the relative energy drift of vpu, mxu and
     mxu_bf16 over 1000 steps at N=4096, recorded without a gate;
  5r. nbody_rollout_cuda as a user calls it, 10 steps at N=65536, equal to
     the system's 10 one-sided steps bit for bit;
  3p. the P3M short-range pair kernel against the plain short-range sum
     (reference.p3m_short_range) on the card at rtol 1e-4 / atol 2e-4, the
     bound between nbody_tpu's Pallas and XLA short-range engines
     (tests/test_p3m.py:367), on shell N=65536 at G=64 with the auto-sized
     capacity and its blk, and on the same with masses from [0.5, 2] and 77
     zero-mass bodies at the origin (N not a multiple of blk) at blk 128,
     256 and 512; the overflow against p3m_overflow_count; repeat calls and
     two whole p3m_accel calls (deposit, FFT, kernel) bit-equal; the
     kernel's time at N=65536, its bound and the plain version's time;
  5p. the P3M path through Compute(kernel="p3m"): QA at N=16384 (positions
     gated, as nbody_tpu gates them), the P3M force at N=65536, G=64 against
     the exact each-pair-once force (median relative error < 0.008, 90th
     percentile < 0.02, the envelope of tests/test_p3m.py:36-37),
     run_benchmark(3) at N=1,048,576, G=64 for Euler and leapfrog (README's
     nbody --kernel p3m --numbodies 1000000 --benchmark) at the auto
     capacity, which demo 0 outgrows within a step: a replay of its steps
     (bit-equal to the benchmark's) prints the massive bodies each timed
     force evaluation dropped, and the same run at the capacity auto-sizing
     gives those states' largest occupancy must keep its contract; a
     collapsing demo-0 state at N=65536 through update_many(10), which must
     warn naming its first breached step. After the path (its launches not
     counted): the pair kernel against the plain sum on the Euler run's
     timed state that dropped the most, at its auto capacity, on a sample of
     i-rows (random, the busiest cell's kept bodies, dropped bodies) against
     all N, at rtol 1e-4 / atol 2e-4, dropped bodies 0; one Euler force
     evaluation of the contract-keeping run split by CUDA events into its
     stages (sort and tables, deposit, FFT solve, gather, pair kernel,
     update), with live entries, tiles and the kernel's bound;
  7. the CLI in subprocesses: --qatest, --benchmark, --variant sym with
     --integrator leapfrog --qatest and with --benchmark, --integrator
     hermite with --qatest and with --drift-check 3, --variant mxu --qatest,
     --variant mxu_bf16 --benchmark, and --precision ds with --qatest,
     --benchmark, --integrator leapfrog --qatest, --drift-check 10, and
     --integrator hermite --qatest (N=4096) and --benchmark, and --kernel
     p3m --numbodies 65536 --benchmark -i 3.
Phases 4-5 are the one-sided main path's run, 5s the sym path's, 5h the
Hermite path's, 5d the ds path's, 5dh the ds Hermite path's, 5m the
tensor-core path's, 5r the rollout's and 5p the P3M path's: the kernels' launch counters are
set to 0 before each and read after it, and each kernel of that path must
have launched. Any failure raises, and the script exits nonzero. The last lines
are the card, one JSON object listing every kernel, and the result line.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

N_MAIN = 65536  # BASELINE.json configs[1] and bench.py's N
N_QA = 16384  # nbody_tpu's per-core default N
N_BIG = 4 * 256 * 132  # the CLI's default N on an H100, above the sym cap
N_DS_BIG = 65536 + 4096  # above the ds composition's cap: two blocks
N_DS_AJ_BIG = 32768 + 4096  # above the ds accel + jerk composition's cap: two blocks
N_MXU_DRIFT = 4096  # the 1000-step energy-drift record of the mxu variants
N_P3M_BIG = 1 << 20  # README's nbody --kernel p3m --numbodies 1000000, rounded to 2^20
P3M_GRID = 64  # the CLI's --pm-grid default
P3M_RTOL, P3M_ATOL = 1e-4, 2e-4  # tests/test_p3m.py:367, Pallas against XLA short range
# FP32-pipe instructions the short-range function needs a pair, with FMA:
# 7 to test a candidate pair of neighbouring cells (3 FADD for d, FMUL + 2
# FFMA for r2, the compare), 19 more for a pair within rcut (FADD of eps2,
# 2 FMUL for inv^3, FMUL for y, 10 FFMA of Horner's rule, FFMA for inv^3 -
# s_lr, FMUL by m_j, 3 FFMA for the sums); each counts as 2 flops at the
# fp32 peak, rsqrtf goes to the SFU. The kernel spends 9 / 31, its terms
# rounded unfused as its plain version rounds them (csrc/p3m_kernels.cu):
# a cost of that choice, reported beside the bound and not in it.
P3M_CANDIDATE_INSTR, P3M_NEAR_INSTR = 7, 19
P3M_KERNEL_INSTR = (9, 31)
# the card's peak fp32 rate outside the tensor cores and its memory rate
# (NVIDIA's H100 SXM data sheet, at the full 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SOURCES = {"step": "nbody_tpu_torch/csrc/nbody_kernels.cu",
           "step_t": "nbody_tpu_torch/csrc/nbody_kernels.cu",
           "mxu_step": "nbody_tpu_torch/csrc/mxu_kernels.cu",
           "mxu_bf16_step": "nbody_tpu_torch/csrc/mxu_kernels.cu",
           "accel": "nbody_tpu_torch/csrc/nbody_kernels.cu",
           "sym": "nbody_tpu_torch/csrc/symmetric_kernels.cu",
           "sym_cross": "nbody_tpu_torch/csrc/symmetric_kernels.cu",
           "accel_jerk": "nbody_tpu_torch/csrc/nbody_kernels.cu",
           "potential": "nbody_tpu_torch/csrc/nbody_kernels.cu",
           "aj_sym": "nbody_tpu_torch/csrc/symmetric_aj_kernels.cu",
           "aj_sym_cross": "nbody_tpu_torch/csrc/symmetric_aj_kernels.cu",
           "ds_step": "nbody_tpu_torch/csrc/ds_kernels.cu",
           "ds_leapfrog": "nbody_tpu_torch/csrc/ds_kernels.cu",
           "ds_sym": "nbody_tpu_torch/csrc/ds_symmetric_kernels.cu",
           "ds_sym_cross": "nbody_tpu_torch/csrc/ds_symmetric_kernels.cu",
           "ds_accel_jerk": "nbody_tpu_torch/csrc/ds_aj_kernels.cu",
           "ds_aj_sym": "nbody_tpu_torch/csrc/ds_symmetric_aj_kernels.cu",
           "ds_aj_sym_cross": "nbody_tpu_torch/csrc/ds_symmetric_aj_kernels.cu",
           "p3m_sr": "nbody_tpu_torch/csrc/p3m_kernels.cu"}
REPLACES = {"step": "nbody_tpu/ops/pallas_kernel.py:90",
            "step_t": "nbody_tpu/ops/pallas_kernel.py:202",
            "mxu_step": "nbody_tpu/ops/pallas_kernel.py:171",
            "mxu_bf16_step": "nbody_tpu/ops/pallas_kernel.py:171",
            "accel": "nbody_tpu/ops/pallas_kernel.py:272",
            "sym": "nbody_tpu/ops/symmetric_kernel.py:107",
            "sym_cross": "nbody_tpu/ops/symmetric_kernel.py:334",
            "accel_jerk": "nbody_tpu/ops/pallas_kernel.py:589",
            "potential": "nbody_tpu/ops/pallas_kernel.py:707",
            "aj_sym": "nbody_tpu/ops/symmetric_kernel.py:789",
            "aj_sym_cross": "nbody_tpu/ops/symmetric_kernel.py:577",
            "ds_step": "nbody_tpu/ops/ds_kernel.py:222",
            "ds_leapfrog": "nbody_tpu/ops/ds_kernel.py:575",
            "ds_sym": "nbody_tpu/ops/ds_kernel.py:1059",
            "ds_sym_cross": "nbody_tpu/ops/ds_kernel.py:1339",
            "ds_accel_jerk": "nbody_tpu/ops/ds_kernel.py:756",
            "ds_aj_sym": "nbody_tpu/ops/ds_kernel.py:1585",
            "ds_aj_sym_cross": "nbody_tpu/ops/ds_kernel.py:1839",
            "p3m_sr": "nbody_tpu/ops/p3m_kernel.py:250"}
NAMES = {"step": "nbody_step_f32", "step_t": "nbody_step_t_f32",
         "mxu_step": "nbody_mxu_step_f32", "mxu_bf16_step": "nbody_mxu_step_bf16",
         "accel": "nbody_accel_f32",
         "sym": "nbody_sym_accel_f32", "sym_cross": "nbody_sym_cross_f32",
         "accel_jerk": "nbody_accel_jerk_f32", "potential": "nbody_potential_f32",
         "aj_sym": "nbody_aj_sym_f32", "aj_sym_cross": "nbody_aj_cross_f32",
         "ds_step": "nbody_ds_step", "ds_leapfrog": "nbody_ds_leapfrog",
         "ds_sym": "nbody_ds_sym_accel", "ds_sym_cross": "nbody_ds_sym_cross",
         "ds_accel_jerk": "nbody_ds_accel_jerk", "ds_aj_sym": "nbody_ds_aj_sym",
         "ds_aj_sym_cross": "nbody_ds_aj_cross", "p3m_sr": "nbody_p3m_sr_f32"}
HERMITE_KERNELS = ("accel_jerk", "aj_sym", "aj_sym_cross", "potential")
MXU_KERNELS = ("mxu_step", "mxu_bf16_step")
# FP32-pipe instructions an mxu pair, read from csrc/mxu_kernels.cu: s is 3
# FADD, 3 FMUL + 3 FADD, 2 FMUL (11); the 3xTF32 split of the thread's A
# value is cvt, FADD, cvt (3), of its B values 6 per 4 pairs (1.5); bf16
# packs two A values a cvt (0.5) and its B values 2 per 8 pairs (0.25).
# Each counts as 2 flops at the fp32 peak; rsqrtf goes to the SFU.
MXU_PAIR_INSTR = {"mxu_step": 15.5, "mxu_bf16_step": 11.75}
# the mma work: 16 flops a pair (n = 8) and pass, three TF32 passes or one
# bf16 pass, at the card's dense tensor rates (NVIDIA's H100 SXM data sheet)
MXU_TENSOR = {"mxu_step": (3 * 16.0, 495e12), "mxu_bf16_step": (16.0, 989e12)}
DS_KERNELS = ("ds_step", "ds_leapfrog", "ds_sym", "ds_sym_cross")
DS_AJ_KERNELS = ("ds_accel_jerk", "ds_aj_sym", "ds_aj_sym_cross")
# the ds Hermite step's glue kernels: they must launch on its path, but are
# not ports of a TPU kernel and stay out of the kernels line
DS_HERMITE_GLUE = ("ds_hermite_predict", "ds_hermite_correct")
# FP32-pipe instructions a ds pair, read from the kernels' source (the
# headers of csrc/ds_kernels.cu and csrc/ds_symmetric_kernels.cu): one side
# of a pair, and both sides; each counts as 2 flops at the fp32 peak
DS_PAIR_INSTR = 225
DS_SYM_PAIR_INSTR = 294
# a half-drift of one body's three coordinates in ds: ds_mul + ds_add each
DS_DRIFT_INSTR = 60
# ds accel + jerk: one side of a pair, and both sides (the headers of
# csrc/ds_aj_kernels.cu and csrc/ds_symmetric_aj_kernels.cu)
DS_AJ_PAIR_INSTR = 452
DS_AJ_SYM_PAIR_INSTR = 608


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time for the work: the larger of operations over the fp32
    peak and bytes over the memory rate, and which of the two it is."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    print(f"[2 build] {lib.relative_to(ROOT)} from "
          f"{', '.join(s.name for s in _build.SOURCES)} "
          f"{'already built' if existed else 'built'} in {secs:.1f} s")


def shell_state(torch, n, *, seed=42, random_w=False):
    """Shell ICs at the tuned scales on the card; with random_w, masses from
    [0.5, 2] and a random vel.w, which shell ICs (unit masses, vel.w = 0)
    cannot tell from a kernel that weights a pair by the wrong mass."""
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales

    demo = DEMO_PARAMS[0]
    scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
    pos, vel = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed)
    if random_w:
        rng = np.random.default_rng(7)
        pos[:, 3] = rng.uniform(0.5, 2.0, n)
        vel[:, 3] = rng.standard_normal(n)
    dev = torch.device("cuda", 0)
    return torch.tensor(pos, device=dev), torch.tensor(vel, device=dev)


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
    from nbody_tpu_torch import DEMO_PARAMS
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
        pj, vj = shell_state(torch, n, random_w=rand_w)
        pi = pj[:m].contiguous()
        vi = vj[:m].contiguous()

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
    p, v = shell_state(torch, N_MAIN)
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

    times, bounds = {}, {}
    # 20 flops a pair by the reference's count; each input read once, each
    # output written once
    flops = 20.0 * N_MAIN * N_MAIN
    bounds["step"] = bound_ms(flops, 4 * N_MAIN * 16)
    bounds["accel"] = bound_ms(flops, N_MAIN * 16 + N_MAIN * 12)
    for name, kernel, plain in (("step", step_kernel, step_plain),
                                ("accel", accel_kernel, accel_plain)):
        kernel()
        plain()  # warm-up of both
        t_k = elapsed_ms(kernel, dev) / reps
        t_p = elapsed_ms(plain, dev) / plain_reps
        times[name] = (t_k, t_p)
        print(f"[3 kernels] {name} at N={N_MAIN}, block 256: kernel {t_k:.3f} ms, "
              f"plain {t_p:.3f} ms per call, bound {bounds[name][0]:.3f} ms "
              f"({bounds[name][1]})")
    return {"err": err, "times": times, "bounds": bounds}


def phase_sym_kernels(torch) -> dict:
    """The each-pair-once kernels against their plain versions, with the
    one-sided bounds: only the order of the sums differs, so the force is
    held to 1e-4 * max|a| + 1e-4 and a step carries it as in phase 3."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import reference
    from nbody_tpu_torch.utils.timing import elapsed_ms

    dev = torch.device("cuda", 0)
    demo = DEMO_PARAMS[0]
    dt, soft = demo.time_step, demo.softening
    cap, tile = ck.sym_default_dispatch(N_MAIN)
    err = {"sym": 0.0, "sym_cross": 0.0}

    def held(name, got, want, what):
        tol = 1e-4 * want.abs().max().item() + 1e-4
        e = (got - want).abs().max().item()
        print(f"[3s sym] {what}: max|d|={e:.3e} (tol {tol:.3e})")
        check(bool(torch.isfinite(got).all()), f"non-finite output at {what}")
        check(e <= tol, f"{name} kernel disagrees at {what}")
        err[name] = max(err[name], e)
        return tol

    for n in (1000, 4099):
        p, _ = shell_state(torch, n)
        held("sym", ck.sym_accel_cuda(p, soft, tile=tile),
             reference.compute_accel_symmetric(p, soft), f"triangle N={n} tile={tile}")
    # the blocked composition: N=65536 cut into two blocks of 32768 (two
    # triangles, one rectangle), and the default dispatch at N=135168
    for n, c in ((N_MAIN, N_MAIN // 2), (N_BIG, cap)):
        p, _ = shell_state(torch, n)
        held("sym_cross",
             ck.compute_accel_symmetric_blocked_cuda(p, soft, block_cap=c, tile=tile),
             reference.compute_accel_symmetric_blocked(p, soft, block_cap=c, tile_j=tile),
             f"blocked N={n} cap={c} tile={tile}")
    for bi, bj in ((777, 4099), (cap, cap)):
        pi, _ = shell_state(torch, bi, seed=3)
        pj, _ = shell_state(torch, bj)
        a_k, r_k = ck.sym_cross_cuda(pi, pj, soft, tile=tile)
        a_r, r_r = reference.sym_cross(pi, pj, soft)
        held("sym_cross", a_k, a_r, f"rectangle ({bi},{bj}) action")
        held("sym_cross", r_k, r_r, f"rectangle ({bi},{bj}) reaction")
    # random masses, vel.w and damping 0.5 through the sym step at the
    # default dispatch, against the plain composition
    for n in (4099, N_MAIN):
        p, v = shell_state(torch, n, random_w=True)
        a_k = ck.compute_accel_symmetric_blocked_cuda(p, soft)
        a_r = reference.compute_accel_symmetric_blocked(p, soft, block_cap=cap, tile_j=tile)
        tol_a = held("sym", a_k, a_r, f"N={n} random masses")
        out_k = (torch.empty_like(p), torch.empty_like(v))
        reference.integrate_into(p, v, a_k, dt, 0.5, out_k)
        p_r, v_r = reference.integrate(p, v, a_r, dt, 0.5)
        e_p = (out_k[0] - p_r).abs().max().item()
        e_v = (out_k[1] - v_r).abs().max().item()
        w_kept = bool(torch.equal(out_k[0][:, 3], p[:, 3]) and torch.equal(out_k[1][:, 3], v[:, 3]))
        print(f"[3s sym] step N={n} damping 0.5: max|dpos|={e_p:.3e} "
              f"(tol {1e-5 + dt * dt * tol_a:.3e}) max|dvel|={e_v:.3e} "
              f"(tol {1e-5 + dt * tol_a:.3e}); w-lanes kept: {w_kept}")
        check(e_p <= 1e-5 + dt * dt * tol_a and e_v <= 1e-5 + dt * tol_a,
              f"sym step disagrees at N={n}")
        check(w_kept, f"sym step changed pos.w or vel.w at N={n}")
        # momentum: each pair adds +m_i m_j c d and -m_i m_j c d, so
        # sum m a = 0 up to the rounding of the per-body sums, which grows
        # as sqrt(N): the JAX suite's 1e-6 of sum |m a| at N=384
        # (tests/test_symmetric.py:58-66), scaled by sqrt(N / 384)
        ma = p[:, 3:4].double() * a_k.double()
        net = ma.sum(0).abs().max().item() / ma.abs().sum().item()
        mbound = 1e-6 * math.sqrt(n / 384)
        print(f"[3s sym] momentum N={n}: |sum m a| / sum |m a| = {net:.3e} "
              f"(bound {mbound:.3e})")
        check(net <= mbound, f"sym momentum not conserved at N={n}")
    # run-to-run: no atomics, so the same bits every call
    for n in (N_MAIN, N_BIG):
        p, _ = shell_state(torch, n)
        a1 = ck.compute_accel_symmetric_blocked_cuda(p, soft)
        a2 = ck.compute_accel_symmetric_blocked_cuda(p, soft)
        same = bool(torch.equal(a1, a2))
        print(f"[3s sym] N={n}: repeat call bit-equal: {same}")
        check(same, f"the sym force differs between two calls at N={n}")

    # times at the main path's shapes: the triangle of N=65536 (one block
    # under the cap) and the rectangle of the two blocks of N=135168
    _, blk = reference.sym_blocking(N_BIG, tile, cap)
    p, _ = shell_state(torch, N_MAIN)
    pb, _ = shell_state(torch, N_BIG)
    pi, pj = pb[:blk], pb[blk:2 * blk]
    reps, plain_reps = 20, 2
    runs = {
        "sym": (lambda: ck.sym_accel_cuda(p, soft, tile=tile),
                lambda: reference.compute_accel_symmetric(p, soft)),
        "sym_cross": (lambda: ck.sym_cross_cuda(pi, pj, soft, tile=tile),
                      lambda: reference.sym_cross(pi, pj, soft)),
    }
    # 28 flops a pair for both sides (symmetric_kernel.py:285)
    bounds = {"sym": bound_ms(28.0 * N_MAIN * (N_MAIN - 1) / 2, N_MAIN * (16 + 12)),
              "sym_cross": bound_ms(28.0 * pi.shape[0] * pj.shape[0],
                                    (pi.shape[0] + pj.shape[0]) * 16
                                    + pi.shape[0] * 16 + pj.shape[0] * 12)}
    times = {}
    for name, (kernel, plain) in runs.items():
        kernel()
        plain()
        t_k = elapsed_ms(lambda: [kernel() for _ in range(reps)], dev) / reps
        t_p = elapsed_ms(lambda: [plain() for _ in range(plain_reps)], dev) / plain_reps
        times[name] = (t_k, t_p)
        shape = f"N={N_MAIN}" if name == "sym" else f"({pi.shape[0]},{pj.shape[0]})"
        print(f"[3s sym] {name} at {shape}, tile {tile}: kernel {t_k:.3f} ms, plain "
              f"{t_p:.3f} ms per call, bound {bounds[name][0]:.3f} ms ({bounds[name][1]})")
    return {"err": err, "times": times, "bounds": bounds}


def phase_aj_kernels(torch) -> dict:
    """The accel + jerk kernels and the potential kernel against their plain
    versions. Only the order of the sums differs, so each output (the
    acceleration, the jerk, a reaction, the potential's per-row sums) is
    held to 1e-4 * max + 1e-4 of its own, the bound of phase 3; a Hermite
    step carries the bounds into the velocity as dt * da + dt^2 * dj and
    into the position as dt^2 * da + dt^3 * dj, plus 1e-5."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import energy, reference
    from nbody_tpu_torch.utils.timing import elapsed_ms

    dev = torch.device("cuda", 0)
    dt, soft = DEMO_PARAMS[0].time_step, DEMO_PARAMS[0].softening
    cap, tile = ck.aj_sym_default_dispatch(N_MAIN)
    err = {k: 0.0 for k in HERMITE_KERNELS}
    labels = ("acc", "jerk", "react acc", "react jerk")

    def held(name, got, want, what, names=labels):
        tols = []
        for label, g, w in zip(names, got, want):
            tol = 1e-4 * w.abs().max().item() + 1e-4
            e = (g - w).abs().max().item()
            print(f"[3h aj] {what} {label}: max|d|={e:.3e} (tol {tol:.3e})")
            check(bool(torch.isfinite(g).all()), f"non-finite {label} at {what}")
            check(e <= tol, f"{name} kernel disagrees ({label}) at {what}")
            err[name] = max(err[name], e)
            tols.append(tol)
        return tols

    cases = [(n, n, bs) for n in (1000, 4099, N_MAIN) for bs in (128, 256)]
    cases.append((777, 4099, 256))  # i-vs-j, M != N
    for m, n, bs in cases:
        pj, vj = shell_state(torch, n)
        pi, vi = pj[:m].contiguous(), vj[:m].contiguous()
        held("accel_jerk", ck.compute_accel_jerk_cuda(pi, vi, pj, vj, soft, block_size=bs),
             reference.compute_accel_jerk_vs(pi, vi, pj, vj, soft), f"one-sided M={m} N={n} block={bs}")
    for n in (1000, 4099, N_MAIN):
        p, _ = shell_state(torch, n)
        held("potential", (ck.potential_energy_per_row_cuda(p, soft),),
             (energy.potential_energy_per_row(p, soft),), f"potential N={n}", ("per-row sums",))
    for n in (1000, 4099):
        p, v = shell_state(torch, n)
        held("aj_sym", ck.aj_sym_cuda(p, v, soft, tile=tile),
             reference.compute_accel_jerk_symmetric(p, v, soft), f"triangle N={n} tile={tile}")
    # the blocked composition: N=65536 cut into two blocks, and the default
    # dispatch at N=135168
    for n, c in ((N_MAIN, N_MAIN // 2), (N_BIG, cap)):
        p, v = shell_state(torch, n)
        held("aj_sym_cross",
             ck.compute_accel_jerk_symmetric_blocked_cuda(p, v, soft, block_cap=c, tile=tile),
             reference.compute_accel_jerk_symmetric_blocked(p, v, soft, block_cap=c, tile_j=tile),
             f"blocked N={n} cap={c} tile={tile}")
    for bi, bj in ((777, 4099), (cap, cap)):
        pi, vi = shell_state(torch, bi, seed=3)
        pj, vj = shell_state(torch, bj)
        held("aj_sym_cross", ck.aj_sym_cross_cuda(pi, vi, pj, vj, soft, tile=tile),
             reference.aj_sym_cross(pi, vi, pj, vj, soft), f"rectangle ({bi},{bj})")
    # random masses, vel.w and damping 0.5 through one Hermite step of each
    # variant (the sym one at the default dispatch), against the plain step
    for n in (4099, N_MAIN):
        p, v = shell_state(torch, n, random_w=True)
        for variant, kernel, plain, name in (
                ("vpu", lambda a, b: ck.compute_accel_jerk_cuda(a, b, a, b, soft),
                 lambda a, b: reference.compute_accel_jerk(a, b, soft), "accel_jerk"),
                ("sym", lambda a, b: ck.compute_accel_jerk_symmetric_blocked_cuda(a, b, soft),
                 lambda a, b: reference.compute_accel_jerk_symmetric_blocked(
                     a, b, soft, block_cap=cap, tile_j=tile), "aj_sym")):
            tol_a, tol_j = held(name, kernel(p, v), plain(p, v), f"{variant} N={n} random masses")
            p_k, v_k = reference.nbody_step_hermite(p, v, dt, soft, 0.5, accel_jerk_fn=kernel)
            p_r, v_r = reference.nbody_step_hermite(p, v, dt, soft, 0.5, accel_jerk_fn=plain)
            e_p = (p_k - p_r).abs().max().item()
            e_v = (v_k - v_r).abs().max().item()
            tol_v = 1e-5 + dt * tol_a + dt * dt * tol_j
            tol_p = 1e-5 + dt * dt * tol_a + dt ** 3 * tol_j
            w_kept = bool(torch.equal(p_k[:, 3], p[:, 3]) and torch.equal(v_k[:, 3], v[:, 3]))
            print(f"[3h aj] Hermite step {variant} N={n} damping 0.5: max|dpos|={e_p:.3e} "
                  f"(tol {tol_p:.3e}) max|dvel|={e_v:.3e} (tol {tol_v:.3e}); "
                  f"w-lanes kept: {w_kept}")
            check(e_p <= tol_p and e_v <= tol_v, f"Hermite step ({variant}) disagrees at N={n}")
            check(w_kept, f"Hermite step ({variant}) changed pos.w or vel.w at N={n}")
            if variant == "sym":
                # each pair once: sum m a and sum m j vanish to the rounding
                # of N-term sums, the bound of phase 3s
                a_k, j_k = kernel(p, v)
                mbound = 1e-6 * math.sqrt(n / 384)
                for label, f in (("m a", a_k), ("m j", j_k)):
                    mf = p[:, 3:4].double() * f.double()
                    net = mf.sum(0).abs().max().item() / mf.abs().sum().item()
                    print(f"[3h aj] N={n}: |sum {label}| / sum |{label}| = {net:.3e} "
                          f"(bound {mbound:.3e})")
                    check(net <= mbound, f"sym {label} not conserved at N={n}")
    # run-to-run: no atomics, so the same bits every call
    for n in (N_MAIN, N_BIG):
        p, v = shell_state(torch, n)
        a1 = ck.compute_accel_jerk_symmetric_blocked_cuda(p, v, soft)
        a2 = ck.compute_accel_jerk_symmetric_blocked_cuda(p, v, soft)
        same = all(torch.equal(x, y) for x, y in zip(a1, a2))
        print(f"[3h aj] N={n}: repeat call bit-equal: {same}")
        check(same, f"the sym accel + jerk differs between two calls at N={n}")

    # times at the main path's shapes: N=65536 (the triangle: one block
    # under the cap) and the rectangle of two blocks of N=135168
    _, blk = reference.sym_blocking(N_BIG, tile, cap)
    p, v = shell_state(torch, N_MAIN)
    pb, vb = shell_state(torch, N_BIG)
    pi, vi, pj, vj = pb[:blk], vb[:blk], pb[blk:2 * blk], vb[blk:2 * blk]
    bi, bj = pi.shape[0], pj.shape[0]
    runs = {
        "accel_jerk": (lambda: ck.compute_accel_jerk_cuda(p, v, p, v, soft),
                       lambda: reference.compute_accel_jerk(p, v, soft)),
        "aj_sym": (lambda: ck.aj_sym_cuda(p, v, soft, tile=tile),
                   lambda: reference.compute_accel_jerk_symmetric(p, v, soft)),
        "aj_sym_cross": (lambda: ck.aj_sym_cross_cuda(pi, vi, pj, vj, soft, tile=tile),
                         lambda: reference.aj_sym_cross(pi, vi, pj, vj, soft)),
        "potential": (lambda: ck.potential_energy_per_row_cuda(p, soft),
                      lambda: energy.potential_energy_per_row(p, soft)),
    }
    # flops a pair by the JAX package's counts (48 one-sided, 60 for both
    # sides of a pair, 12 for the potential); each input read once (pos and
    # vel, 32 bytes a body), each output written once
    n = N_MAIN
    bounds = {"accel_jerk": bound_ms(48.0 * n * n, n * 32 + n * 24),
              "aj_sym": bound_ms(60.0 * n * (n - 1) / 2, n * 32 + n * 24),
              "aj_sym_cross": bound_ms(60.0 * bi * bj, (bi + bj) * 32 + bi * 32 + bj * 24),
              "potential": bound_ms(12.0 * n * (n - 1), n * 16 + n * 4)}
    reps, plain_reps = 10, 2
    times = {}
    for name, (kernel, plain) in runs.items():
        kernel()
        plain()
        t_k = elapsed_ms(lambda: [kernel() for _ in range(reps)], dev) / reps
        t_p = elapsed_ms(lambda: [plain() for _ in range(plain_reps)], dev) / plain_reps
        times[name] = (t_k, t_p)
        shape = f"({bi},{bj})" if name == "aj_sym_cross" else f"N={n}"
        print(f"[3h aj] {name} at {shape}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms per call, "
              f"bound {bounds[name][0]:.3f} ms ({bounds[name][1]})")
    return {"err": err, "times": times, "bounds": bounds}


def mxu_bound_ms(key: str, pairs: float, nbytes: float) -> tuple[float, str]:
    """The least time of an mxu step: the larger of its FP32-pipe
    instructions (MXU_PAIR_INSTR, 2 flops each) over the fp32 peak, its mma
    flops over the tensor-core rate, and its bytes over the memory rate."""
    t_fp32 = 2.0 * MXU_PAIR_INSTR[key] * pairs / PEAK_FP32_FLOPS * 1e3
    flops, rate = MXU_TENSOR[key]
    t_ops = max(t_fp32, flops * pairs / rate * 1e3)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_mxu_kernels(torch) -> dict:
    """3m. The tensor-core step kernels against their plain versions, the
    same mxu algebra (ops/reference.py, float32 products with TF32 off),
    under the mxu error model: positions and velocities within
    reference.mxu_step_tolerance (MXU_ERROR_COEF * E carried through the
    update), w lanes copied, repeat calls bit-equal; ragged shapes, odd N,
    M != N, masses from [0.5, 2], a random vel.w and damping 0.5, and
    N=65536. The rollout kernel against k launches of the step kernel, bit
    for bit, and one rollout step against the plain step at phase 3's
    bound. Times at N=65536; the rollout's k=10 both ways, in turns."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import reference
    from nbody_tpu_torch.utils.timing import elapsed_ms

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain mxu step would round its own product")
    dev = torch.device("cuda", 0)
    demo = DEMO_PARAMS[0]
    dt, soft, damp = demo.time_step, demo.softening, demo.damping
    err = {k: 0.0 for k in (*MXU_KERNELS, "step_t")}
    # (M, N, masses and vel.w drawn at random, damping)
    cases = [(1000, 1000, False, damp), (777, 4099, False, damp), (4099, 777, True, 0.5),
             (4099, 4099, True, 0.5), (N_MAIN, N_MAIN, True, 0.5)]
    for m, n, rand_w, dmp in cases:
        pj, vj = shell_state(torch, n, random_w=rand_w)
        pi, vi = (pj, vj) if m == n else shell_state(torch, m, seed=3, random_w=rand_w)
        what = f"M={m} N={n} damping={dmp}" + (", random masses and vel.w" if rand_w else "")
        for variant, key in zip(reference.MXU_VARIANTS, MXU_KERNELS):
            got = ck.nbody_step_mxu_cuda_vs(pi, vi, pj, dt, soft, dmp, variant=variant)
            again = ck.nbody_step_mxu_cuda_vs(pi, vi, pj, dt, soft, dmp, variant=variant)
            want = reference.nbody_step_mxu_vs(pi, vi, pj, dt, soft, dmp,
                                               mxu_dtype=reference.MXU_DTYPES[variant])
            torch.cuda.synchronize()
            tol_p, tol_v = reference.mxu_step_tolerance(pi, vi, pj, want, dt, soft, dmp,
                                                        variant=variant)
            dp = (got[0][:, :3] - want[0][:, :3]).abs()
            dv = (got[1][:, :3] - want[1][:, :3]).abs()
            ratio = max((dp / tol_p).max().item(), (dv / tol_v).max().item())
            same = bool(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
            kept = bool(torch.equal(got[0][:, 3], pi[:, 3]) and torch.equal(got[1][:, 3], vi[:, 3]))
            print(f"[3m mxu] {variant} {what}: max|dpos|={dp.max().item():.3e} "
                  f"max|dvel|={dv.max().item():.3e}, max error / bound = {ratio:.3e}; "
                  f"repeat bit-equal: {same}; w-lanes kept: {kept}")
            check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
                  f"non-finite {variant} output at {what}")
            check(ratio <= 1.0, f"{variant} kernel disagrees with its plain version at {what}")
            check(same, f"{variant} kernel differs between two calls at {what}")
            check(kept, f"{variant} kernel changed pos.w or vel.w at {what}")
            err[key] = max(err[key], dp.max().item(), dv.max().item())
        del pj, vj, pi, vi, got, again, want, tol_p, tol_v, dp, dv

    # the rollout: k launches of step_t against k of the step kernel, and
    # one step against the plain step with phase 3's bound
    for n, bs, k in ((4099, 128, 3), (4099, 256, 3), (N_MAIN, 256, 10)):
        p, v = shell_state(torch, n, random_w=True)
        gp, gv = ck.nbody_rollout_cuda(p, v, dt, soft, 0.5, steps=k, block_size=bs)
        sp, sv = p, v
        for _ in range(k):
            sp, sv = ck.nbody_step_cuda(sp, sv, dt, soft, 0.5, block_size=bs)
        same = bool(torch.equal(gp, sp) and torch.equal(gv, sv))
        op, ov = ck.nbody_rollout_cuda(p, v, dt, soft, 0.5, steps=1, block_size=bs)
        rp, rv = reference.nbody_step(p, v, dt, soft, 0.5)
        tol_a = 1e-4 * reference.compute_accel(p, soft).abs().max().item() + 1e-4
        e_p = (op - rp).abs().max().item()
        e_v = (ov - rv).abs().max().item()
        print(f"[3m rollout] N={n} block {bs}: {k} steps equal {k} step-kernel launches bit for "
              f"bit: {same}; one step against plain max|dpos|={e_p:.3e} (tol "
              f"{1e-5 + dt * dt * tol_a:.3e}) max|dvel|={e_v:.3e} (tol {1e-5 + dt * tol_a:.3e})")
        check(same, f"the rollout differs from {k} step launches at N={n} block {bs}")
        check(e_p <= 1e-5 + dt * dt * tol_a and e_v <= 1e-5 + dt * tol_a,
              f"the rollout step disagrees with plain at N={n}")
        err["step_t"] = max(err["step_t"], e_p, e_v)

    # times at the main path's shape: N=65536, shell ICs, demo 0
    p, v = shell_state(torch, N_MAIN)
    bufs = [(torch.empty_like(p), torch.empty_like(v)) for _ in range(2)]
    pairs = float(N_MAIN) * N_MAIN
    reps, plain_reps = 20, 2
    times, bounds = {}, {}
    for variant, key in zip(reference.MXU_VARIANTS, MXU_KERNELS):
        def kernel(variant=variant):
            for _ in range(reps):
                ck.nbody_step_mxu_cuda(p, v, dt, soft, damp, variant=variant, out=bufs[0])

        def plain(variant=variant):
            for _ in range(plain_reps):
                reference.nbody_step_mxu(p, v, dt, soft, damp,
                                         mxu_dtype=reference.MXU_DTYPES[variant])

        kernel()
        plain()
        t_k = elapsed_ms(kernel, dev) / reps
        t_p = elapsed_ms(plain, dev) / plain_reps
        times[key] = (t_k, t_p)
        # each input read once, each output written once
        bounds[key] = mxu_bound_ms(key, pairs, 4 * N_MAIN * 16)
        print(f"[3m mxu] {key} at N={N_MAIN}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms per call, "
              f"bound {bounds[key][0]:.3f} ms ({bounds[key][1]})")

    def steps10():
        a, b = p, v
        for k in range(10):
            a, b = ck.nbody_step_cuda(a, b, dt, soft, damp, out=bufs[k % 2])

    def roll10():
        ck.nbody_rollout_cuda(p, v, dt, soft, damp, steps=10)

    def plain_step():
        reference.nbody_step(p, v, dt, soft, damp)

    steps10()
    roll10()
    plain_step()
    ms = {"steps": [], "rollout": []}
    for name in ("steps", "rollout", "rollout", "steps"):
        ms[name].append(elapsed_ms(steps10 if name == "steps" else roll10, dev) / 10)
    t_plain = elapsed_ms(plain_step, dev)
    times["step_t"] = (min(ms["rollout"]), t_plain)
    # a step: 20 flops a pair; pos, vel and the planes read once, the new
    # pos, vel and planes written once
    bounds["step_t"] = bound_ms(20.0 * pairs, 6 * N_MAIN * 16)
    print(f"[3m rollout] N={N_MAIN}, 10 steps, in turns (steps, rollout, rollout, steps): "
          f"step kernel {ms['steps'][0]:.4f} / {ms['steps'][1]:.4f} ms, rollout "
          f"{ms['rollout'][0]:.4f} / {ms['rollout'][1]:.4f} ms per step; plain step "
          f"{t_plain:.3f} ms; bound {bounds['step_t'][0]:.3f} ms ({bounds['step_t'][1]})")
    return {"err": err, "times": times, "bounds": bounds}


def ds_state(torch, n, *, seed=42):
    """Shell ICs in float64 with masses from [0.5, 2] (so with a lo part)
    and a random vel.w, as the four ds planes on the card, and the float64
    positions."""
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
    from nbody_tpu_torch.ops import ds

    demo = DEMO_PARAMS[0]
    scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
    pos, vel = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed, dtype=np.float64)
    rng = np.random.default_rng(7)
    pos[:, 3] = rng.uniform(0.5, 2.0, n)
    vel[:, 3] = rng.standard_normal(n)
    dev = torch.device("cuda", 0)
    planes = tuple(t.to(dev) for t in (*ds.ds_from_f64(pos), *ds.ds_from_f64(vel)))
    return planes, pos


def phase_ds_kernels(torch) -> dict:
    """The double-single kernels against their plain versions (ops/ds.py).
    Both are ds-grade and differ only in the order of the ds sums and in
    the float32 rsqrt seed (the card's rsqrtf against PyTorch's), so each
    output, as hi + lo in float64, is held to 1e-12 * max + 1e-14 of the
    plain one, and each force to 1e-10 * max|a| of the float64 oracle's,
    which a float32-grade force misses by three orders. The one-sided
    kernels give their force as one step from zero velocity with dt = 1 and
    damping 1 (v' = a exactly). Masses from [0.5, 2], a random vel.w and
    damping 0.5 catch a kernel that drops m.lo, the damping or vel.w."""
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.compute import _oracle_accel
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import ds, reference
    from nbody_tpu_torch.utils.timing import elapsed_ms

    dev = torch.device("cuda", 0)
    dt, soft = DEMO_PARAMS[0].time_step, DEMO_PARAMS[0].softening
    err = {k: 0.0 for k in DS_KERNELS}

    def held(name, got, want, what):
        for k, (g, w) in enumerate(zip(got, want)):
            g64, w64 = ds.ds_to_f64(*g), ds.ds_to_f64(*w)
            tol = 1e-12 * np.abs(w64).max() + 1e-14
            e = float(np.abs(g64 - w64).max())
            print(f"[3d ds] {what} [{k}]: max|d|={e:.3e} (tol {tol:.3e})")
            check(bool(np.isfinite(g64).all()), f"non-finite output at {what}")
            check(e <= tol, f"{name} kernel disagrees with its plain version at {what}")
            err[name] = max(err[name], e)

    def oracle(name, acc, ref, what):
        e = float(np.abs(ds.ds_to_f64(*acc)[:, :3] - ref).max()) / float(np.abs(ref).max())
        print(f"[3d ds] {what} force against the float64 oracle: max|da|/max|a| = {e:.3e} "
              "(bound 1e-10)")
        check(e <= 1e-10, f"{name} force is not fp64-grade at {what}")

    def repeat(name, fn, what):
        same = all(torch.equal(a, b) for a, b in zip(fn(), fn()))
        print(f"[3d ds] {what}: repeat call bit-equal: {same}")
        check(same, f"{name} differs between two calls at {what}")

    def steps(t):
        return [t[:2], t[2:]]

    for n in (4099, N_QA):
        planes, pos64 = ds_state(torch, n)
        ref = _oracle_accel(pos64, soft)
        zero = torch.zeros_like(planes[2])
        scal = ds.scal_ds(dt, soft, 0.5)
        lscal = ds.scal_ds_leapfrog(dt, soft, 0.5)
        cap, tile = ck.ds_sym_default_dispatch(n)
        small_cap = 2048 if n < N_QA else 4096
        bs = ck.ds_default_block_size(n)
        tri_plain = ds.ds_accel_symmetric(planes[0], planes[1], scal)
        runs = (
            ("ds_step", lambda: ck.nbody_step_ds_cuda(*planes, scal, block_size=bs),
             lambda: ds.nbody_step_ds(*planes, scal),
             lambda: ck.nbody_step_ds_cuda(planes[0], planes[1], zero, zero,
                                           ds.scal_ds(1.0, soft, 1.0), block_size=bs)[2:],
             f"step N={n} block {bs} damping 0.5"),
            ("ds_leapfrog", lambda: ck.nbody_step_ds_leapfrog_cuda(*planes, lscal, block_size=bs),
             lambda: ds.nbody_step_ds_leapfrog(*planes, lscal),
             lambda: ck.nbody_step_ds_leapfrog_cuda(planes[0], planes[1], zero, zero,
                                                    ds.scal_ds_leapfrog(1.0, soft, 1.0),
                                                    block_size=bs)[2:],
             f"leapfrog N={n} block {bs} damping 0.5"),
            # the triangle at every tile of the dispatch table
            *(("ds_sym", lambda t=t: ck.ds_sym_accel_cuda(planes[0], planes[1], scal, tile=t),
               lambda: tri_plain, None, f"triangle N={n} tile {t}") for t in ck.DS_SYM_TILES),
            ("ds_sym_cross", lambda: ck.compute_accel_ds_symmetric_blocked_cuda(
                planes[0], planes[1], scal, block_cap=small_cap, tile=tile),
             lambda: ds.ds_accel_symmetric_blocked(planes[0], planes[1], scal,
                                                   block_cap=small_cap, tile_j=tile), None,
             f"blocked N={n} cap {small_cap} tile {tile}"),
        )
        for name, kernel, plain, force, what in runs:
            got = kernel()
            want = plain()
            if len(got) == 4:
                held(name, steps(got), steps(want), what)
                kept = all(torch.equal(g[:, 3], p[:, 3]) for g, p in zip(got, planes))
                print(f"[3d ds] {what}: mass and vel.w kept in both planes: {kept}")
                check(kept, f"{name} changed a w lane at {what}")
            else:
                held(name, [got], [want], what)
            oracle(name, got if force is None else force(), ref, what)
            repeat(name, kernel, what)
        del planes, zero, tri_plain

    # the main path above the cap, N_DS_BIG at its default dispatch: two
    # tile-512 triangles and one rectangle, composed in ds
    cap, tile = ck.ds_sym_default_dispatch(N_DS_BIG)
    _, blk = reference.sym_blocking(N_DS_BIG, tile, cap)
    big, big64 = ds_state(torch, N_DS_BIG)
    bi, bj = blk, N_DS_BIG - blk
    rect = (big[0][:bi], big[1][:bi], big[0][bi:], big[1][bi:])
    scal = ds.scal_ds(dt, soft, 1.0)
    lscal = ds.scal_ds_leapfrog(dt, soft, 1.0)
    what = f"blocked N={N_DS_BIG} cap {cap} tile {tile} (default dispatch)"

    def composed():
        return ck.compute_accel_ds_symmetric_blocked_cuda(big[0], big[1], scal)

    acc = composed()
    held("ds_sym_cross", [acc], [ds.ds_accel_symmetric_blocked(big[0], big[1], scal,
                                                               block_cap=cap, tile_j=tile)], what)
    oracle("ds_sym_cross", acc, _oracle_accel(big64, soft), what)
    repeat("ds_sym_cross", composed, what)
    del acc, big64

    # times: the one-sided kernels and the triangle at N = 16384 (the ds
    # default N, whose times go into the kernels line) and 65536; the
    # rectangle at the shape of the main path above the cap, two blocks of
    # N_DS_BIG; the plain versions once each at those shapes, the plain
    # rectangle's output kept to hold the kernel's to
    rect_plain = []
    times, bounds = {}, {}
    for n in (N_QA, N_MAIN):
        planes, _ = ds_state(torch, n)
        out = tuple(torch.empty_like(planes[0]) for _ in range(4))
        bs = ck.ds_default_block_size(n)
        _, t = ck.ds_sym_default_dispatch(n)
        runs = {
            "ds_step": (lambda: ck.nbody_step_ds_cuda(*planes, scal, block_size=bs, out=out),
                        lambda: ds.nbody_step_ds(*planes, scal)),
            "ds_leapfrog": (lambda: ck.nbody_step_ds_leapfrog_cuda(*planes, lscal, block_size=bs,
                                                                   out=out),
                            lambda: ds.nbody_step_ds_leapfrog(*planes, lscal)),
            "ds_sym": (lambda: ck.ds_sym_accel_cuda(planes[0], planes[1], scal, tile=t),
                       lambda: ds.ds_accel_symmetric(planes[0], planes[1], scal)),
        }
        if n == N_QA:
            runs["ds_sym_cross"] = (lambda: ck.ds_sym_cross_cuda(*rect, scal, tile=tile),
                                    lambda: rect_plain.append(ds.ds_sym_cross(*rect, scal)))
        pairs = float(n) * n
        # each input read once, each output written once: 16 bytes a plane
        # row, 12 an acceleration row
        shape_bounds = {
            "ds_step": bound_ms(2 * DS_PAIR_INSTR * pairs, 8 * n * 16),
            "ds_leapfrog": bound_ms(2 * (DS_PAIR_INSTR * pairs + 2 * DS_DRIFT_INSTR * n),
                                    8 * n * 16),
            "ds_sym": bound_ms(2 * DS_SYM_PAIR_INSTR * n * (n - 1) / 2, 2 * n * 16 + 2 * n * 12),
            "ds_sym_cross": bound_ms(2 * DS_SYM_PAIR_INSTR * float(bi) * bj,
                                     2 * (bi + bj) * 16 + 2 * bi * 16 + 2 * bj * 12),
        }
        reps = 10 if n == N_QA else 3
        for name, (kernel, plain) in runs.items():
            kernel()
            torch.cuda.synchronize()
            t_k = elapsed_ms(lambda: [kernel() for _ in range(reps)], dev) / reps
            t_p = elapsed_ms(plain, dev) if n == N_QA else None
            shape = f"({bi},{bj})" if name == "ds_sym_cross" else f"N={n}"
            b = shape_bounds[name]
            print(f"[3d ds] {name} at {shape}: kernel {t_k:.3f} ms"
                  + (f", plain {t_p:.3f} ms" if t_p is not None else "")
                  + f" per call, bound {b[0]:.3f} ms ({b[1]})")
            if n == N_QA:
                times[name] = (t_k, t_p)
                bounds[name] = b
        del planes, out, runs
    what = f"rectangle ({bi},{bj}) tile {tile}"
    held("ds_sym_cross", steps(ck.ds_sym_cross_cuda(*rect, scal, tile=tile)),
         steps(rect_plain[0]), what)
    repeat("ds_sym_cross", lambda: ck.ds_sym_cross_cuda(*rect, scal, tile=tile), what)
    del big, rect, rect_plain
    torch.cuda.empty_cache()
    return {"err": err, "times": times, "bounds": bounds}


def phase_ds_main(torch, smi: str) -> None:
    """The ds path through Compute(precision="ds"): QA for Euler auto (sym),
    Euler one_sided and leapfrog at N=16384, benchmarks at 16384 (beside
    the fp32 step) and above the cap, and the two-tier drift check."""
    from nbody_tpu_torch.cli import drift_failed
    from nbody_tpu_torch.compute import Compute

    for variant, integrator, resolved in (("auto", "euler", "sym"),
                                          ("one_sided", "euler", "one_sided"),
                                          ("auto", "leapfrog", "one_sided")):
        c = Compute(num_bodies=N_QA, device="cuda", precision="ds", variant=variant,
                    integrator=integrator, log=lambda s: print(f"[5d QA] {s}"))
        check(c.system.variant == resolved, f"ds variant {c.system.variant} != {resolved}")
        check(c.compare_results(), f"ds QA against the float64 oracle failed ({variant}, "
                                   f"{integrator})")
    ms = {}
    for tag, n, steps, kw in (("ds auto", N_QA, 10, {"precision": "ds"}),
                              ("fp32 auto", N_QA, 10, {}),
                              ("ds one_sided", N_QA, 10, {"precision": "ds",
                                                          "variant": "one_sided"}),
                              ("ds leapfrog", N_QA, 10, {"precision": "ds",
                                                         "integrator": "leapfrog"}),
                              ("ds auto", N_DS_BIG, 3, {"precision": "ds"})):
        c = Compute(num_bodies=n, device="cuda", log=lambda s: print(f"[5d main] {s}"), **kw)
        res = c.run_benchmark(steps)
        check(c.system.backend == "cuda", "the ds path did not select the CUDA backend")
        pos, vel = c.system.state
        check(tuple(pos.shape) == (n, 4) and bool(torch.isfinite(pos).all()
                                                  and torch.isfinite(vel).all()),
              f"bad state after the {tag} benchmark at N={n}")
        ms[(tag, n)] = res["milliseconds"] / res["iterations"]
        print(f"[5d main] {tag} ({c.system.variant}, {c.system.integrator}) N={n}: "
              f"{ms[(tag, n)]:.3f} ms per step [{smi}]")
    print(f"[5d main] N={N_QA}: ds Euler {ms[('ds auto', N_QA)]:.3f} ms against fp32 "
          f"{ms[('fp32 auto', N_QA)]:.3f} ms per step, "
          f"{ms[('ds auto', N_QA)] / ms[('fp32 auto', N_QA)]:.1f}x [{smi}]")
    for n, steps in ((N_QA, 10), (4096, 60)):
        c = Compute(num_bodies=n, device="cuda", precision="ds",
                    log=lambda s: print(f"[5d drift] {s}"))
        t0 = time.perf_counter()
        drift = c.drift_check(steps)
        print(f"[5d drift] N={n}, {steps} steps: horizon delta {drift['horizon_delta']:.3e}, "
              f"delta {drift['delta']:.3e} in {time.perf_counter() - t0:.1f} s")
        check(not drift_failed(drift), f"ds drift check failed at N={n}: {drift}")


def phase_ds_aj_kernels(torch) -> dict:
    """The double-single accel + jerk kernels and the Hermite glue against
    their plain versions (ops/ds.py), by the rules of phase 3d: each output
    within 1e-12 * max + 1e-14 of the plain one, each force and jerk within
    1e-10 * max of the float64 oracle's, repeat calls bit-equal, the
    predictor and corrector bit-equal to theirs with the mass and vel.w
    kept in both planes. Masses from [0.5, 2] in float64 and a random vel.w;
    damping 0.5 in the scalar block. The triangle at both tiles the kernels
    take, the composition forced by a small cap, and the default dispatch
    above the cap against the oracle (its plain version would take a
    minute); the rectangle against plain at a ragged (4096, 4099) and at
    the main path's shape above the cap, where it is also timed."""
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.compute import _oracle_accel_jerk
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import ds, reference
    from nbody_tpu_torch.utils.timing import elapsed_ms

    dev = torch.device("cuda", 0)
    dt, soft = DEMO_PARAMS[0].time_step, DEMO_PARAMS[0].softening
    scal = ds.scal_ds_hermite(dt, soft, 0.5)
    err = {k: 0.0 for k in DS_AJ_KERNELS}

    def held(name, got, want, what):
        for k in range(0, len(got), 2):
            g64, w64 = ds.ds_to_f64(*got[k:k + 2]), ds.ds_to_f64(*want[k:k + 2])
            tol = 1e-12 * np.abs(w64).max() + 1e-14
            e = float(np.abs(g64 - w64).max())
            print(f"[3dh ds aj] {what} [{k // 2}]: max|d|={e:.3e} (tol {tol:.3e})")
            check(bool(np.isfinite(g64).all()), f"non-finite output at {what}")
            check(e <= tol, f"{name} kernel disagrees with its plain version at {what}")
            err[name] = max(err[name], e)

    def oracle(name, fields, ref, what):
        for label, k, r in (("force", 0, ref[0]), ("jerk", 2, ref[1])):
            e = float(np.abs(ds.ds_to_f64(*fields[k:k + 2])[:, :3] - r).max() / np.abs(r).max())
            print(f"[3dh ds aj] {what} {label} against the float64 oracle: max|d|/max = "
                  f"{e:.3e} (bound 1e-10)")
            check(e <= 1e-10, f"{name} {label} is not fp64-grade at {what}")

    def repeat(name, fn, what):
        same = all(torch.equal(a, b) for a, b in zip(fn(), fn()))
        print(f"[3dh ds aj] {what}: repeat call bit-equal: {same}")
        check(same, f"{name} differs between two calls at {what}")

    for n in (4099, N_QA):
        planes, pos64 = ds_state(torch, n)
        ref = _oracle_accel_jerk(pos64, ds.ds_to_f64(*planes[2:]), soft)
        small_cap = 2048 if n < N_QA else 4096
        bs = ck.ds_default_block_size(n)
        _, tile = ck.ds_aj_sym_default_dispatch(n)
        tri_plain = ds.ds_accel_jerk_symmetric(*planes, scal)
        runs = (
            ("ds_accel_jerk", lambda: ck.compute_accel_jerk_ds_cuda_vs(*planes, *planes, scal,
                                                                     block_size=bs),
             lambda: ds.ds_accel_jerk_vs(*planes, *planes, scal), f"one-sided N={n} block {bs}"),
            # the triangle at every tile the kernels take
            *(("ds_aj_sym", lambda t=t: ck.ds_aj_sym_cuda(*planes, scal, tile=t),
               lambda: tri_plain, f"triangle N={n} tile {t}") for t in ck.DS_AJ_TILES),
            ("ds_aj_sym_cross", lambda: ck.compute_accel_jerk_ds_symmetric_blocked_cuda(
                *planes, scal, block_cap=small_cap, tile=tile),
             lambda: ds.ds_accel_jerk_symmetric_blocked(*planes, scal, block_cap=small_cap,
                                                        tile_j=tile),
             f"blocked N={n} cap {small_cap} tile {tile}"),
        )
        for name, kernel, plain, what in runs:
            got = kernel()
            held(name, got, plain(), what)
            oracle(name, got, ref, what)
            repeat(name, kernel, what)
        # the glue, from the one-sided kernel's (N,4) fields and the
        # composition's (N,3) ones: bit-equal to the plain versions
        for what, aj in (("one-sided", lambda st: ck.compute_accel_jerk_ds_cuda_vs(
                              *st, *st, scal, block_size=bs)),
                         ("sym", lambda st: ck.compute_accel_jerk_ds_symmetric_blocked_cuda(
                             *st, scal))):
            f0 = aj(planes)
            pred = ck.ds_hermite_predict_cuda(*planes, *f0, scal)
            f1 = aj(pred)
            new = ck.ds_hermite_correct_cuda(*planes, *f0, *f1, scal)
            same = (all(torch.equal(a, b) for a, b in zip(
                        pred, ds.ds_hermite_predict(*planes, f0[:2], f0[2:], scal)))
                    and all(torch.equal(a, b) for a, b in zip(
                        new, ds.ds_hermite_correct(*planes, f0[:2], f0[2:], f1[:2], f1[2:],
                                                   scal))))
            kept = all(torch.equal(a[:, 3], b[:, 3]) for a, b in zip((*pred, *new),
                                                                     (*planes, *planes)))
            print(f"[3dh ds aj] predictor and corrector N={n} ({what} fields): bit-equal to "
                  f"plain: {same}; mass and vel.w kept in both planes: {kept}")
            check(same and kept, f"the ds Hermite glue disagrees at N={n} ({what})")
        del planes, tri_plain

    # the main path above the cap at its default dispatch: two triangles
    # and one rectangle, composed in ds, against the float64 oracle
    cap, tile = ck.ds_aj_sym_default_dispatch(N_DS_AJ_BIG)
    _, blk = reference.sym_blocking(N_DS_AJ_BIG, tile, cap)
    big, big64 = ds_state(torch, N_DS_AJ_BIG)
    what = f"blocked N={N_DS_AJ_BIG} cap {cap} tile {tile} (default dispatch)"

    def composed():
        return ck.compute_accel_jerk_ds_symmetric_blocked_cuda(*big, scal)

    oracle("ds_aj_sym_cross", composed(),
           _oracle_accel_jerk(big64, ds.ds_to_f64(*big[2:]), soft), what)
    repeat("ds_aj_sym_cross", composed, what)
    bi, bj = blk, N_DS_AJ_BIG - blk
    rect = tuple(t[:bi] for t in big) + tuple(t[bi:] for t in big)
    # the rectangle against plain at (4096, 4099), in the layout of a
    # composition's cross block
    sub = tuple(t[:4096] for t in big) + tuple(t[4096:8195] for t in big)
    held("ds_aj_sym_cross", ck.ds_aj_sym_cross_cuda(*sub, scal, tile=tile),
         ds.ds_aj_sym_cross(*sub, scal), f"rectangle (4096,4099) tile {tile}")
    del big64

    # times: the one-sided kernel and the triangle at N = 16384 (the ds
    # default N), the rectangle at the main path's shape above the cap;
    # the plain versions once each, the plain rectangle's output kept to
    # hold the kernel's to at that shape
    rect_plain = []
    planes, _ = ds_state(torch, N_QA)
    out = tuple(torch.empty_like(planes[0]) for _ in range(4))
    bs = ck.ds_default_block_size(N_QA)
    _, t16 = ck.ds_aj_sym_default_dispatch(N_QA)
    n = N_QA
    runs = {
        "ds_accel_jerk": (lambda: ck.compute_accel_jerk_ds_cuda_vs(*planes, *planes, scal,
                                                                   block_size=bs, out=out),
                          lambda: ds.ds_accel_jerk_vs(*planes, *planes, scal)),
        "ds_aj_sym": (lambda: ck.ds_aj_sym_cuda(*planes, scal, tile=t16),
                      lambda: ds.ds_accel_jerk_symmetric(*planes, scal)),
        "ds_aj_sym_cross": (lambda: ck.ds_aj_sym_cross_cuda(*rect, scal, tile=tile),
                            lambda: rect_plain.append(ds.ds_aj_sym_cross(*rect, scal))),
    }
    # each input read once (four planes of 16 bytes a row), each output
    # written once (four fields of 16 or 12 bytes a row)
    bounds = {
        "ds_accel_jerk": bound_ms(2 * DS_AJ_PAIR_INSTR * float(n) * n, 4 * n * 16 + 4 * n * 16),
        "ds_aj_sym": bound_ms(2 * DS_AJ_SYM_PAIR_INSTR * n * (n - 1) / 2,
                              4 * n * 16 + 4 * n * 12),
        "ds_aj_sym_cross": bound_ms(2 * DS_AJ_SYM_PAIR_INSTR * float(bi) * bj,
                                    4 * (bi + bj) * 16 + 4 * bi * 16 + 4 * bj * 12),
    }
    times = {}
    for name, (kernel, plain) in runs.items():
        kernel()
        torch.cuda.synchronize()
        t_k = elapsed_ms(lambda: [kernel() for _ in range(5)], dev) / 5
        t_p = elapsed_ms(plain, dev)
        times[name] = (t_k, t_p)
        shape = f"({bi},{bj})" if name == "ds_aj_sym_cross" else f"N={n}"
        print(f"[3dh ds aj] {name} at {shape}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms per "
              f"call, bound {bounds[name][0]:.3f} ms ({bounds[name][1]})")
    what = f"rectangle ({bi},{bj}) tile {tile}"
    held("ds_aj_sym_cross", ck.ds_aj_sym_cross_cuda(*rect, scal, tile=tile), rect_plain[0], what)
    repeat("ds_aj_sym_cross", lambda: ck.ds_aj_sym_cross_cuda(*rect, scal, tile=tile), what)
    del big, rect, sub, rect_plain, planes, out, runs
    torch.cuda.empty_cache()
    return {"err": err, "times": times, "bounds": bounds}


def phase_ds_hermite_main(torch, smi: str) -> None:
    """The ds Hermite path through Compute(precision="ds",
    integrator="hermite"): QA against the float64 oracle (position, force
    and jerk) for auto (sym) and one_sided at N=16384, run_benchmark(10) at
    16384 for both beside the fp32 Hermite step, 3 steps above the ds
    accel + jerk composition's cap, and the two-tier drift check."""
    from nbody_tpu_torch.cli import drift_failed
    from nbody_tpu_torch.compute import Compute

    for variant, resolved in (("auto", "sym"), ("one_sided", "one_sided")):
        c = Compute(num_bodies=N_QA, device="cuda", precision="ds", integrator="hermite",
                    variant=variant, log=lambda s: print(f"[5dh QA] {s}"))
        check(c.system.variant == resolved, f"ds Hermite variant {c.system.variant} != {resolved}")
        check(c.compare_results(), f"ds Hermite QA against the float64 oracle failed ({variant})")
    ms = {}
    for tag, n, steps, kw in (("ds auto", N_QA, 10, {"precision": "ds"}),
                              ("fp32 auto", N_QA, 10, {}),
                              ("ds one_sided", N_QA, 10, {"precision": "ds",
                                                          "variant": "one_sided"}),
                              ("ds auto", N_DS_AJ_BIG, 3, {"precision": "ds"})):
        c = Compute(num_bodies=n, device="cuda", integrator="hermite",
                    log=lambda s: print(f"[5dh main] {s}"), **kw)
        res = c.run_benchmark(steps)
        check(c.system.backend == "cuda", "the ds Hermite path did not select the CUDA backend")
        pos, vel = c.system.state
        check(tuple(pos.shape) == (n, 4) and bool(torch.isfinite(pos).all()
                                                  and torch.isfinite(vel).all()),
              f"bad state after the {tag} Hermite benchmark at N={n}")
        ms[(tag, n)] = res["milliseconds"] / res["iterations"]
        print(f"[5dh main] {tag} ({c.system.variant}, hermite) N={n}: {ms[(tag, n)]:.3f} ms per "
              f"step [{smi}]")
    print(f"[5dh main] N={N_QA}: ds Hermite {ms[('ds auto', N_QA)]:.3f} ms (one_sided "
          f"{ms[('ds one_sided', N_QA)]:.3f}) against fp32 Hermite "
          f"{ms[('fp32 auto', N_QA)]:.3f} ms per step, "
          f"{ms[('ds auto', N_QA)] / ms[('fp32 auto', N_QA)]:.1f}x [{smi}]")
    for n, steps in ((N_QA, 10), (4096, 60)):
        c = Compute(num_bodies=n, device="cuda", precision="ds", integrator="hermite",
                    log=lambda s: print(f"[5dh drift] {s}"))
        t0 = time.perf_counter()
        drift = c.drift_check(steps)
        print(f"[5dh drift] N={n}, {steps} steps: horizon delta {drift['horizon_delta']:.3e}, "
              f"delta {drift['delta']:.3e} in {time.perf_counter() - t0:.1f} s")
        check(not drift_failed(drift), f"ds Hermite drift check failed at N={n}: {drift}")


def auto_capacity(occ: int) -> int:
    """BodySystem's auto-sized cell capacity for a largest massive cell
    occupancy: occ + 50 %, rounded up to a multiple of 8."""
    return max(8, -(-int(occ * 1.5 + 1) // 8) * 8)


def p3m_capacity(pos) -> int:
    """BodySystem's auto-sized cell capacity of a state at G=64."""
    from nbody_tpu_torch.ops import p3m

    return auto_capacity(int(p3m.p3m_max_occupancy(pos, grid=P3M_GRID)))


def p3m_bound_ms(work: dict, n: int, instr=(P3M_CANDIDATE_INSTR, P3M_NEAR_INSTR)):
    """The short-range function's bound for this run's data (p3m.pair_work):
    the candidate pairs' test and the near pairs' terms, at 2 flops an FP32
    instruction, against the O(N) bytes of the function (the state in, the
    (N, 3) force out). Pairs of padding rows, and the terms of far pairs,
    are work this kernel does and the function does not need; `instr`
    P3M_KERNEL_INSTR gives what the kernel's unfused rounding costs."""
    flops = 2.0 * (instr[0] * work["candidates"] + instr[1] * work["near"])
    return bound_ms(flops, n * 16 + n * 12)


def p3m_check(torch, acc, plain, what: str) -> float:
    """Hold pair-kernel forces to the plain short-range sum at rtol 1e-4 /
    atol 2e-4; return the largest absolute error."""
    diff = (acc - plain).abs()
    e = diff.max().item()
    ratio = (diff / (P3M_ATOL + P3M_RTOL * plain.abs())).max().item()
    print(f"[p3m check] {what}: max|da|={e:.3e} (max|a| {plain.abs().max().item():.3e}), "
          f"largest error over rtol {P3M_RTOL:g} / atol {P3M_ATOL:g}: {ratio:.3f}")
    check(bool(torch.isfinite(acc).all()), f"non-finite pair kernel output ({what})")
    check(ratio <= 1.0, f"pair kernel disagrees with the plain sum ({what})")
    return e


def phase_p3m_kernels(torch) -> dict:
    """3p. The pair kernel against the plain short-range sum: every term is
    rounded alike (csrc/p3m_kernels.cu), so only the order of the sums
    differs, and the force is held at rtol 1e-4, atol 2e-4, nbody_tpu's
    bound between its two short-range engines."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import p3m, reference
    from nbody_tpu_torch.utils.timing import elapsed_ms

    dev = torch.device("cuda", 0)
    soft = DEMO_PARAMS[0].softening
    shell, _ = shell_state(torch, N_MAIN)
    masses, _ = shell_state(torch, N_MAIN, random_w=True)
    padded = torch.cat([masses, torch.zeros((77, 4), device=dev)])
    err = 0.0
    for name, pos, blks in (("shell", shell, (None,)),
                            ("masses from [0.5, 2] and 77 zero-mass bodies", padded,
                             ck.P3M_BLKS)):
        n = pos.shape[0]
        cap = p3m_capacity(pos)
        plain = reference.p3m_short_range(pos, soft, grid=P3M_GRID, capacity=cap)
        overflow = int(p3m.p3m_overflow_count(pos, grid=P3M_GRID, capacity=cap))
        for blk in blks:
            acc, ovf = ck.p3m_short_range_cuda(pos, soft, grid=P3M_GRID, capacity=cap, blk=blk)
            again, _ = ck.p3m_short_range_cuda(pos, soft, grid=P3M_GRID, capacity=cap, blk=blk)
            torch.cuda.synchronize()
            what = (f"{name}, N={n}, G={P3M_GRID}, capacity {cap}, "
                    f"blk {p3m.p3m_kernel_blk(cap) if blk is None else blk}")
            e = p3m_check(torch, acc, plain, what)
            print(f"[3p p3m kernel] overflow {int(ovf)} (probe {overflow}); repeat bit-equal: "
                  f"{torch.equal(acc, again)}")
            check(int(ovf) == overflow, f"overflow {int(ovf)} != probe {overflow} ({what})")
            check(torch.equal(acc, again), f"pair kernel repeat differs ({what})")
            err = max(err, e)
    cap = p3m_capacity(padded)
    whole = [p3m.p3m_accel(padded, soft, grid=P3M_GRID, capacity=cap)[0] for _ in range(2)]
    same = torch.equal(*whole)
    print(f"[3p p3m kernel] two whole p3m_accel calls (deposit, FFT solve, pair kernel) "
          f"bit-equal: {same}")
    check(same, "two p3m_accel calls on one state differ")

    # the kernel alone on the main path's tables: shell N=65536, G=64
    cap = p3m_capacity(shell)
    tables = p3m.pair_tables(shell, soft, grid=P3M_GRID, capacity=cap,
                             blk=p3m.p3m_kernel_blk(cap))
    reps, plain_reps = 20, 2

    def kernel():
        for _ in range(reps):
            ck.p3m_sr_pairs_cuda(tables)

    def plain():
        for _ in range(plain_reps):
            reference.p3m_short_range(shell, soft, grid=P3M_GRID, capacity=cap)

    kernel()
    plain()
    t_k = elapsed_ms(kernel, dev) / reps
    t_p = elapsed_ms(plain, dev) / plain_reps
    work = p3m.pair_work(tables)
    bound = p3m_bound_ms(work, N_MAIN)
    own = p3m_bound_ms(work, N_MAIN, P3M_KERNEL_INSTR)
    print(f"[3p p3m kernel] shell N={N_MAIN}, G={P3M_GRID}, capacity {cap}, blk {tables.blk}: "
          f"{work['entries']} live entries, {work['tiles']} tiles "
          f"({work['tiles'] * tables.blk ** 2:.4e} row pairs), {work['candidates']:.4e} candidate "
          f"and {work['near']:.4e} near pairs; kernel {t_k:.3f} ms, plain {t_p:.3f} ms per call, "
          f"bound {bound[0]:.3f} ms ({bound[1]}, {P3M_CANDIDATE_INSTR} / {P3M_NEAR_INSTR} "
          f"instructions a candidate / near pair); {own[0]:.3f} ms at the kernel's unfused "
          f"rounding ({P3M_KERNEL_INSTR[0]} / {P3M_KERNEL_INSTR[1]})")
    return {"err": {"p3m_sr": err}, "times": {"p3m_sr": (t_k, t_p)},
            "bounds": {"p3m_sr": bound}}


def p3m_benchmark(torch, integrator: str, smi: str, capacity=None):
    """run_benchmark(3) of Compute(kernel="p3m") at N=1,048,576, G=64:
    (Compute, the contract warnings it gave, its first state)."""
    import warnings

    from nbody_tpu_torch.compute import Compute

    c = Compute(num_bodies=N_P3M_BIG, device="cuda", kernel="p3m", integrator=integrator,
                p3m_capacity=capacity, log=lambda s: print(f"[5p main] {s}"))
    start = tuple(t.clone() for t in c.system.state)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = c.run_benchmark(3)
    msgs = [str(m.message) for m in caught if "contract broken" in str(m.message)]
    pos, vel = c.system.state
    check(c.system.backend == "cuda", "the P3M path did not select the CUDA backend")
    check(tuple(pos.shape) == (N_P3M_BIG, 4) and bool(
        torch.isfinite(pos).all() and torch.isfinite(vel).all()),
        f"bad state after the P3M {integrator} benchmark")
    ms = res["milliseconds"] / res["iterations"]
    print(f"[5p main] P3M {integrator} N={N_P3M_BIG}, G={P3M_GRID}, capacity "
          f"{c.system.p3m_capacity}: {ms:.3f} ms per step [{smi}]; "
          + (msgs[0] if msgs else "the contract held"))
    return c, msgs, start


def p3m_replay(torch, system, start, steps: int) -> list:
    """Step `system` again from `start`, one step at a time; return the
    largest massive occupancy, the overflow count and the positions of each
    state a step starts from and of the last. The last state must equal the
    system's present one bit for bit (the same state gives the same bits)."""
    import warnings

    from nbody_tpu_torch.ops import p3m

    end = tuple(t.clone() for t in system.state)
    system.set_state(*start)
    seen = []
    for k in range(steps + 1):
        pos = system.state[0]
        seen.append((int(p3m.p3m_max_occupancy(pos, grid=P3M_GRID)),
                     int(p3m.p3m_overflow_count(pos, grid=P3M_GRID,
                                                capacity=system.p3m_capacity)),
                     pos.clone()))
        if k < steps:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                system.update()
    check(all(torch.equal(a, b) for a, b in zip(system.state, end)),
          "the replayed P3M steps differ from the benchmark's")
    return seen


def phase_p3m_main(torch, smi: str) -> dict:
    """5p. The P3M path through Compute(kernel="p3m") and BodySystem.
    Returns the N=1,048,576 Euler systems for the checks after the path."""
    import warnings

    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.models import BodySystem
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import p3m

    qa = Compute(num_bodies=N_QA, device="cuda", kernel="p3m",
                 log=lambda s: print(f"[5p QA] {s}"))
    check(qa.compare_results(), "P3M QA against the CPU oracle failed")

    # accuracy: the P3M force against the exact each-pair-once force
    system = Compute(num_bodies=N_MAIN, device="cuda", kernel="p3m", log=lambda s: None).system
    a = system.accelerations()
    ref = ck.compute_accel_symmetric_blocked_cuda(system.state[0], system.params.softening)
    rel = ((a - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-12)).cpu().numpy()
    med, p90 = float(np.median(rel)), float(np.percentile(rel, 90))
    print(f"[5p accuracy] N={N_MAIN}, G={P3M_GRID}, capacity {system.p3m_capacity}: P3M force "
          f"against the exact sym force, relative error median {med:.3e} (bound 0.008), "
          f"90th percentile {p90:.3e} (bound 0.02) [{smi}]")
    check(med < 0.008 and p90 < 0.02, "the P3M force is outside nbody_tpu's envelope")

    # README's run at the auto capacity: demo 0 outgrows it within a step,
    # so its timed steps drop short-range pairs; a replay counts the massive
    # bodies each force evaluation dropped. The same run at the capacity
    # auto-sizing gives the largest occupancy of those states keeps its
    # contract: the time of the whole computation.
    systems = {}
    for integrator in ("euler", "leapfrog"):
        c, _, start = p3m_benchmark(torch, integrator, smi)
        seen = p3m_replay(torch, c.system, start, 4)
        print(f"[5p main] P3M {integrator}, capacity {c.system.p3m_capacity}: massive bodies "
              f"dropped by the warm-up and the 3 timed steps {[o for _, o, _ in seen[:4]]} "
              f"(largest occupancy {[occ for occ, _, _ in seen]}, the last state included)")
        check(seen[0][1] == 0, "the auto capacity does not hold the first state")
        keep = auto_capacity(max(occ for occ, _, _ in seen))
        k, msgs, _ = p3m_benchmark(torch, integrator, smi, capacity=keep)
        check(not msgs, f"the P3M {integrator} run at capacity {keep} broke its contract")
        print(f"[5p main] P3M {integrator}: auto capacity {c.system.p3m_capacity}, blk "
              f"{p3m.p3m_kernel_blk(c.system.p3m_capacity)}; contract-keeping capacity {keep}, "
              f"blk {p3m.p3m_kernel_blk(keep)}")
        if integrator == "euler":
            # the timed state that dropped the most, for the check after the path
            worst = max(seen[1:4], key=lambda x: x[1])[2]
            systems = {"worst": (worst, c.system), "keep": k.system}
        del seen

    # the breach report: demo 0 collapses below the mesh scale within steps
    breach = BodySystem(N_MAIN, DEMO_PARAMS[0], device="cuda", kernel="p3m", seed=42)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        breach.update_many(10)
    msgs = [str(m.message) for m in caught if "contract broken" in str(m.message)]
    print(f"[5p breach] demo 0, N={N_MAIN}, capacity {breach.p3m_capacity}, update_many(10): "
          + (msgs[0] if msgs else "no warning"))
    check(len(msgs) == 1 and "first breach at step" in msgs[0],
          "the collapsing demo-0 rollout did not report its breach")
    return systems


def phase_p3m_big(torch, systems: dict, smi: str) -> float:
    """5p, after the path (these launches are not the path's): the pair
    kernel against the plain sum on the timed state of the N=1,048,576
    Euler benchmark that dropped the most, at its auto capacity, sampled
    i-rows against all N bodies; and one Euler step of the
    contract-keeping run split by CUDA events between stages. Returns the
    sample's largest absolute error."""
    import numpy as np

    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import p3m, pm, reference

    # the timed state that dropped the most, at the auto capacity: random
    # rows, kept bodies of the cell with the longest j-block loop, and
    # dropped bodies
    pos, system = systems["worst"]
    soft, cap = system.params.softening, system.p3m_capacity
    tables = p3m.pair_tables(pos, soft, grid=P3M_GRID, capacity=cap,
                             blk=p3m.p3m_kernel_blk(cap))
    nid, nvalid = p3m._neighbor_stencil(tables.gc, pos.device)
    jblocks = torch.where(nvalid, tables.tpc.long()[nid], 0).sum(dim=1)
    jblocks = torch.where(tables.tpc > 0, jblocks, 0)
    busiest = int(jblocks.argmax())
    cell = p3m._cells(pos, P3M_GRID)[-1]
    rng = np.random.default_rng(0)
    gone = tables.body_row >= tables.padded.shape[0]
    in_busiest = torch.nonzero((cell == busiest) & ~gone).flatten().cpu().numpy()
    out = torch.nonzero(gone).flatten().cpu().numpy()
    rows = np.concatenate([rng.choice(N_P3M_BIG, 2048, replace=False),
                           rng.choice(in_busiest, min(1024, len(in_busiest)), replace=False),
                           rng.choice(out, min(512, len(out)), replace=False)])
    rows = torch.tensor(np.unique(rows), device=pos.device)
    acc = p3m.short_range_from_tables(ck.p3m_sr_pairs_cuda(tables), tables)[rows]
    plain = reference.p3m_short_range(pos, soft, grid=P3M_GRID, capacity=cap, rows=rows)
    dropped = tables.body_row[rows] >= tables.padded.shape[0]
    what = (f"N={N_P3M_BIG} timed Euler state, G={P3M_GRID}, capacity {cap}, blk {tables.blk}, "
            f"overflow {int(tables.overflow)}: {len(rows)} sampled rows ({int(dropped.sum())} "
            f"dropped), {len(in_busiest)} kept bodies in the busiest cell, "
            f"{int(jblocks[busiest])} j-blocks a block there")
    err = p3m_check(torch, acc, plain, what)
    check(int(dropped.sum()) > 0 and bool((acc[dropped] == 0).all())
          and bool((plain[dropped] == 0).all()), "dropped bodies must get a short range of 0")

    # one Euler force evaluation and update, split by CUDA events between
    # stages, on the contract-keeping run's state and capacity
    system = systems["keep"]
    soft, cap = system.params.softening, system.p3m_capacity
    blk = p3m.p3m_kernel_blk(cap)
    pos, vel = system.state
    stages = ("sort and tables", "deposit", "FFT solve", "gather", "pair kernel",
              "map back and update")
    out = (torch.empty_like(pos), torch.empty_like(vel))
    times = {k: 0.0 for k in stages}
    reps = 3
    for r in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        tables = p3m.pair_tables(pos, soft, grid=P3M_GRID, capacity=cap, blk=blk)
        ev[1].record()
        pos3, mass = pos[:, :3], pos[:, 3]
        lo, h = pm._fit_box(pos3, P3M_GRID)
        idx, w = pm._cic_indices_weights(pos3, lo, h, P3M_GRID)
        rho = pm._deposit(idx, w, mass, P3M_GRID)
        ev[2].record()
        grids = pm._solve_force_grids(rho, h, P3M_GRID, p3m.SIGMA_CELLS * h,
                                      sigma_cells=p3m.SIGMA_CELLS)
        ev[3].record()
        acc_lr = pm._gather(grids, idx, w)
        ev[4].record()
        acc_pad = ck.p3m_sr_pairs_cuda(tables)
        ev[5].record()
        acc = acc_lr + p3m.short_range_from_tables(acc_pad, tables)
        reference.integrate_into(pos, vel, acc, system.params.time_step,
                                 system.params.damping, out)
        ev[6].record()
        torch.cuda.synchronize()
        if r:  # the first round is a warm-up
            for k, name in enumerate(stages):
                times[name] += ev[k].elapsed_time(ev[k + 1]) / reps
    total = sum(times.values())
    check(int(tables.overflow) == 0, "the split's state does not keep its contract")
    print(f"[5p split] one Euler step at N={N_P3M_BIG}, G={P3M_GRID}, capacity {cap} "
          f"(overflow 0; mean of {reps} after one warm-up): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f"; total {total:.3f} ms [{smi}]")
    work = p3m.pair_work(tables)
    bound = p3m_bound_ms(work, N_P3M_BIG)
    own = p3m_bound_ms(work, N_P3M_BIG, P3M_KERNEL_INSTR)
    print(f"[5p split] pair kernel at N={N_P3M_BIG}: {work['entries']} live entries, "
          f"{work['tiles']} tiles, {work['candidates']:.4e} candidate and {work['near']:.4e} "
          f"near pairs; {times['pair kernel']:.3f} ms against its bound {bound[0]:.3f} ms "
          f"({bound[1]}; {own[0]:.3f} ms at the kernel's unfused rounding) [{smi}]")
    return err


def phase_qa(torch, ck, variant: str, integrator: str, tag: str) -> None:
    from nbody_tpu_torch.compute import Compute

    compute = Compute(num_bodies=N_QA, device="cuda", variant=variant,
                      integrator=integrator, log=lambda s: print(f"[{tag}] {s}"))
    check(compute.system.variant == variant, f"variant {compute.system.variant} != {variant}")
    passed = compute.compare_results()
    check(passed, f"QA compare against the CPU oracle failed ({variant}, {integrator})")


def phase_main(torch, smi: str, variant: str, n: int, steps: int, tag: str,
               integrator: str = "euler") -> float:
    """run_benchmark through Compute; returns ms per step."""
    from nbody_tpu_torch.compute import Compute

    compute = Compute(num_bodies=n, device="cuda", variant=variant, integrator=integrator,
                      log=lambda s: print(f"[{tag}] {s}"))
    res = compute.run_benchmark(steps)
    check(compute.system.backend == "cuda", "the main path did not select the CUDA backend")
    pos, vel = compute.system.state
    check(tuple(pos.shape) == (n, 4), f"state shape {tuple(pos.shape)}")
    check(bool(torch.isfinite(pos).all() and torch.isfinite(vel).all()),
          "non-finite state after the benchmark")
    ms = res["milliseconds"] / res["iterations"]
    print(f"[{tag}] {variant} ({compute.system.variant}) {integrator} N={n}: {ms:.3f} ms per step, "
          f"{res['interactions_per_second_e9']:.3f} G interactions/s, "
          f"{res['gflops']:.3f} GFLOP/s at 20 flops per interaction [{smi}]")
    return ms


def phase_mxu_main(torch, smi: str) -> None:
    """5m. The tensor-core path through Compute(variant="mxu" / "mxu_bf16"):
    QA at N=16384 (position, and the mxu force against the oracle under the
    one-sided rule plus the error model), run_benchmark(10) at N=65536 in
    turns with vpu, drift_check(10) with the --drift-check gate, and the
    relative energy drift of vpu, mxu and mxu_bf16 over 1000 steps at
    N=4096 with the float64 functional, recorded without a gate."""
    from nbody_tpu_torch.cli import drift_failed
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.ops import cuda_kernel as ck

    for variant in ("mxu", "mxu_bf16"):
        phase_qa(torch, ck, variant, "euler", "5m QA")
    ms = {"vpu": [], "mxu": [], "mxu_bf16": []}
    for variant in ("vpu", "mxu", "mxu_bf16", "mxu_bf16", "mxu", "vpu"):
        ms[variant].append(phase_main(torch, smi, variant, N_MAIN, 10, "5m main"))
    print(f"[5m main] Euler at N={N_MAIN}, best of two in turns: vpu {min(ms['vpu']):.3f}, "
          f"mxu {min(ms['mxu']):.3f}, mxu_bf16 {min(ms['mxu_bf16']):.3f} ms per step [{smi}]")
    # the --drift-check gate, 10 steps; at N=4096 mxu_bf16's drift departs
    # from the oracle's past the gate, as nbody_tpu's own kernel does (its
    # bf16 roundings leave s_ii |p_i| 2^-9 of the self pair uncancelled): it
    # is recorded there, not gated
    for variant, n, gated in (("mxu", N_QA, True), ("mxu_bf16", N_QA, True),
                              ("mxu", N_MXU_DRIFT, True), ("mxu_bf16", N_MXU_DRIFT, False)):
        c = Compute(num_bodies=n, device="cuda", variant=variant,
                    log=lambda s: print(f"[5m drift] {s}"))
        drift = c.drift_check(10)
        failed = drift_failed(drift)
        print(f"[5m drift] {variant} N={n}: delta {drift['delta']:.3e}, the gate "
              f"{'fails' if failed else 'holds'}" + ("" if gated else " (recorded, not gated)"))
        check(not (gated and failed), f"{variant} drift check failed at N={n}: {drift}")
    for variant in ("vpu", "mxu", "mxu_bf16"):
        system = Compute(num_bodies=N_MXU_DRIFT, device="cuda", variant=variant,
                         log=lambda s: None).system
        e0 = system.total_energy(precise=True)
        system.update_many(1000)
        system.synchronize()
        e1 = system.total_energy(precise=True)
        check(math.isfinite(e1), f"non-finite energy after 1000 {variant} steps")
        print(f"[5m drift] {variant} N={N_MXU_DRIFT}, 1000 Euler steps at dt "
              f"{system.params.time_step}: relative energy drift {(e1 - e0) / abs(e0):.6e} "
              f"(float64 functional, no gate) [{smi}]")


def phase_rollout_main(torch, smi: str) -> None:
    """5r. nbody_rollout_cuda as a user calls it (no system path does): 10
    steps at N=65536 from a BodySystem's state equal that system's 10
    update steps (the one-sided step kernel) bit for bit."""
    from nbody_tpu_torch import DEMO_PARAMS, tuned_scales
    from nbody_tpu_torch.models import BodySystem
    from nbody_tpu_torch.ops import cuda_kernel as ck

    demo = DEMO_PARAMS[0]
    cs, vs = tuned_scales(N_MAIN) or (demo.cluster_scale, demo.velocity_scale)
    params = demo.replace(cluster_scale=cs, velocity_scale=vs)
    system = BodySystem(N_MAIN, params, device="cuda", variant="vpu", seed=42)
    p0, v0 = (t.clone() for t in system.state)
    t0 = time.perf_counter()
    pos, vel = ck.nbody_rollout_cuda(p0, v0, params.time_step, params.softening,
                                     params.damping, steps=10)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    system.update_many(10)
    system.synchronize()
    same = bool(torch.equal(pos, system.state[0]) and torch.equal(vel, system.state[1]))
    print(f"[5r rollout] N={N_MAIN}, 10 steps in {secs * 1e3:.3f} ms of host wall: equal to "
          f"BodySystem(variant='vpu').update_many(10) bit for bit: {same} [{smi}]")
    check(bool(torch.isfinite(pos).all() and torch.isfinite(vel).all()),
          "non-finite rollout state")
    check(same, "the rollout differs from the system's steps")


def phase_plain_main(smi: str) -> None:
    from nbody_tpu_torch.compute import Compute

    plain = Compute(num_bodies=N_MAIN, device="cuda", backend="torch", variant="vpu",
                    log=lambda s: print(f"[5 main, plain] {s}"))
    res = plain.run_benchmark(3)
    print(f"[5 main] plain PyTorch: {res['milliseconds'] / res['iterations']:.3f} ms "
          f"per step [{smi}]")


def phase_step_times(torch, smi: str) -> None:
    """sym against one-sided steps through Compute, in turns (vpu, sym,
    sym, vpu), at N=65536 and the CLI's default N."""
    for n in (N_MAIN, N_BIG):
        ms = {"vpu": [], "sym": []}
        for variant in ("vpu", "sym", "sym", "vpu"):
            ms[variant].append(phase_main(torch, smi, variant, n, 10, "5t times"))
        print(f"[5t times] N={n}: one-sided {min(ms['vpu']):.3f} ms, sym "
              f"{min(ms['sym']):.3f} ms per step (best of two, in turns) [{smi}]")


def phase_hermite_extras(torch, smi: str) -> None:
    """drift_check(5) at N=16384 with the --drift-check gate, and the
    potential kernel's total_energy() at N=65536 beside the float64
    functional (the JAX suite's 1e-4 for float32 against float64,
    tests/test_energy.py:175)."""
    from nbody_tpu_torch.cli import drift_failed
    from nbody_tpu_torch.compute import Compute

    c = Compute(num_bodies=N_QA, device="cuda", integrator="hermite",
                log=lambda s: print(f"[5h drift] {s}"))
    t0 = time.perf_counter()
    drift = c.drift_check(5)
    print(f"[5h drift] N={N_QA} {c.system.variant}: delta {drift['delta']:.3e} in "
          f"{time.perf_counter() - t0:.1f} s")
    check(not drift_failed(drift), f"drift check failed: {drift}")
    system = Compute(num_bodies=N_MAIN, device="cuda", integrator="hermite",
                     log=lambda s: None).system
    system.update_many(3)
    t0 = time.perf_counter()
    fast = system.total_energy()
    t_fast = time.perf_counter() - t0
    t0 = time.perf_counter()
    precise = system.total_energy(precise=True)
    t_precise = time.perf_counter() - t0
    rel = abs(fast - precise) / abs(precise)
    print(f"[5h energy] N={N_MAIN} after 3 Hermite steps: total_energy() {fast:.9e} "
          f"({t_fast * 1e3:.1f} ms), precise {precise:.9e} ({t_precise:.1f} s on the host), "
          f"relative difference {rel:.3e} (bound 1e-4) [{smi}]")
    check(math.isfinite(fast) and rel < 1e-4, "total_energy() disagrees with the precise one")


def phase_host(torch) -> None:
    from nbody_tpu_torch import DEMO_PARAMS, tuned_scales
    from nbody_tpu_torch.models import BodySystem

    cs, vs = tuned_scales(N_QA)
    params = DEMO_PARAMS[0].replace(cluster_scale=cs, velocity_scale=vs)
    for integrator in ("euler", "hermite"):
        dev = BodySystem(N_QA, params, device="cuda", placement="device", seed=42,
                         integrator=integrator)
        host = BodySystem(N_QA, params, device="cuda", placement="host", seed=42,
                          integrator=integrator)
        check(host.state[0].is_pinned(), "placement='host' state is not in pinned memory")
        dev.update_many(5)
        host.update_many(5)
        dev.synchronize()
        same = bool((dev.positions == host.positions).all() and
                    (dev.velocities == host.velocities).all())
        print(f"[6 host] 5 {integrator} steps at N={N_QA}, variant {dev.variant}: host "
              f"placement equals device placement bit for bit: {same}")
        check(same, f"placement='host' differs from placement='device' ({integrator})")


def phase_cli() -> None:
    """The CLI lines, each in its own process, all started together: a
    process spends most of its time starting up, and the lines check exit
    codes and output, not speed (the rates the --benchmark lines print are
    taken while the runs share the card)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    rate = "billion interactions per second"
    runs = ((["--qatest", "--numbodies", "4096"], "-> OK"),
            (["--benchmark", "--numbodies", str(N_MAIN), "-i", "10"], rate),
            (["--variant", "sym", "--integrator", "leapfrog", "--qatest",
              "--numbodies", "4096"], "-> OK"),
            (["--variant", "sym", "--benchmark", "--numbodies", str(N_MAIN), "-i", "10"], rate),
            (["--integrator", "hermite", "--qatest", "--numbodies", "4096"], "-> OK"),
            (["--integrator", "hermite", "--drift-check", "3", "--numbodies", "4096"],
             "energy drift over 3 steps"),
            (["--variant", "mxu", "--qatest", "--numbodies", "4096"], "-> OK"),
            (["--variant", "mxu_bf16", "--benchmark", "--numbodies", str(N_MAIN), "-i", "10"],
             rate),
            (["--precision", "ds", "--qatest"], "-> OK"),
            (["--precision", "ds", "--benchmark", "-i", "10"], "double-single-precision"),
            (["--precision", "ds", "--integrator", "leapfrog", "--qatest"], "-> OK"),
            (["--precision", "ds", "--drift-check", "10"], "energy drift over 10 steps"),
            (["--kernel", "p3m", "--numbodies", str(N_MAIN), "--benchmark", "-i", "3"],
             "pairwise-equivalent rate"),
            (["--precision", "ds", "--integrator", "hermite", "--qatest", "--numbodies", "4096"],
             "-> OK"),
            (["--precision", "ds", "--integrator", "hermite", "--benchmark", "-i", "10"],
             "double-single-precision"))
    procs = [subprocess.Popen([sys.executable, "-m", "nbody_tpu_torch.cli", *args], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for args, _ in runs]
    try:
        outs = [proc.communicate(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for (args, expect), proc, (out, err) in zip(runs, procs, outs):
        for line in out.strip().splitlines():
            print(f"[7 cli] {line}")
        if proc.returncode != 0 or expect not in out:
            print(err, file=sys.stderr)
        check(proc.returncode == 0, f"{' '.join(args)} exited {proc.returncode}")
        check(expect in out, f"{' '.join(args)} printed no {expect!r}")


def timed(label: str, fn, *args):
    """fn(*args), printing the seconds it took."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {label}: {time.perf_counter() - t0:.1f} s")
    return out


def run_path(ck, kernels, drive) -> dict:
    """Drive one path with every launch counter at 0 just before it; return
    the counts just after, and fail unless each of `kernels` launched."""
    for k in ck.LAUNCHES:
        ck.LAUNCHES[k] = 0
    drive()
    launches = dict(ck.LAUNCHES)
    print(f"[main] kernel launches on the path of {', '.join(kernels)}: {launches}")
    for k in kernels:
        check(launches[k] > 0, f"kernel {k!r} was not launched on its main path")
    return launches


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
    timed("2 build", phase_build)
    kern = timed("3 kernels", phase_kernels, torch)
    sym_kern = timed("3s sym kernels", phase_sym_kernels, torch)
    aj_kern = timed("3h accel+jerk and potential kernels", phase_aj_kernels, torch)
    ds_kern = timed("3d ds kernels", phase_ds_kernels, torch)
    ds_aj_kern = timed("3dh ds accel+jerk kernels", phase_ds_aj_kernels, torch)
    mxu_kern = timed("3m mxu kernels and rollout", phase_mxu_kernels, torch)
    p3m_kern = timed("3p p3m pair kernel", phase_p3m_kernels, torch)

    def one_sided_path():
        phase_qa(torch, ck, "vpu", "euler", "4 QA")
        phase_main(torch, smi, "vpu", N_MAIN, 10, "5 main")

    def sym_path():
        phase_qa(torch, ck, "sym", "euler", "5s QA")
        phase_qa(torch, ck, "sym", "leapfrog", "5s QA")
        phase_main(torch, smi, "sym", N_MAIN, 10, "5s main")
        phase_main(torch, smi, "sym", N_BIG, 3, "5s main")

    def hermite_path():
        timed("5h QA", lambda: [phase_qa(torch, ck, v, "hermite", "5h QA") for v in ("sym", "vpu")])
        ms = {"vpu": [], "sym": []}
        for variant in ("vpu", "sym", "sym", "vpu"):
            ms[variant].append(phase_main(torch, smi, variant, N_MAIN, 10, "5h main", "hermite"))
        auto = phase_main(torch, smi, "auto", N_MAIN, 10, "5h main", "hermite")
        print(f"[5h main] Hermite at N={N_MAIN}: one-sided {min(ms['vpu']):.3f} ms, sym "
              f"{min(ms['sym']):.3f} ms per step (best of two, in turns), auto {auto:.3f} ms "
              f"[{smi}]")
        for variant in ("vpu", "sym", "auto"):
            phase_main(torch, smi, variant, N_BIG, 3, "5h main", "hermite")
        timed("5h drift and energy", phase_hermite_extras, torch, smi)

    launches = timed("4-5 one-sided path", run_path, ck, ("step", "accel"), one_sided_path)
    sym_launches = timed("5s sym path", run_path, ck, ("sym", "sym_cross"), sym_path)
    hermite_launches = timed("5h Hermite path", run_path, ck, HERMITE_KERNELS, hermite_path)
    # the ds Euler update kernel is glue, not a TPU kernel's port: it must
    # launch on the ds path but is not in the kernels line
    ds_launches = timed("5d ds path", run_path, ck, (*DS_KERNELS, "ds_integrate"),
                        lambda: phase_ds_main(torch, smi))
    ds_hermite_launches = timed("5dh ds Hermite path", run_path, ck,
                                (*DS_AJ_KERNELS, *DS_HERMITE_GLUE),
                                lambda: phase_ds_hermite_main(torch, smi))
    mxu_launches = timed("5m mxu path", run_path, ck, MXU_KERNELS,
                         lambda: phase_mxu_main(torch, smi))
    rollout_launches = timed("5r rollout", run_path, ck, ("step_t",),
                             lambda: phase_rollout_main(torch, smi))
    p3m_systems = {}
    p3m_launches = timed("5p p3m path", run_path, ck, ("p3m_sr",),
                         lambda: p3m_systems.update(phase_p3m_main(torch, smi)))
    launches["p3m_sr"] = p3m_launches["p3m_sr"]
    p3m_big_err = timed("5p p3m kernel at N=1M and split", phase_p3m_big, torch,
                        p3m_systems, smi)
    p3m_kern["err"]["p3m_sr"] = max(p3m_kern["err"]["p3m_sr"], p3m_big_err)
    del p3m_systems
    for k in MXU_KERNELS:
        launches[k] = mxu_launches[k]
    launches["step_t"] = rollout_launches["step_t"]
    for k in ("sym", "sym_cross"):
        launches[k] = sym_launches[k]
    for k in HERMITE_KERNELS:
        launches[k] = hermite_launches[k]
    for k in DS_KERNELS:
        launches[k] = ds_launches[k]
    for k in DS_AJ_KERNELS:
        launches[k] = ds_hermite_launches[k]
    timed("5 plain", phase_plain_main, smi)
    timed("5t step times", phase_step_times, torch, smi)

    timed("6 host", phase_host, torch)
    timed("7 cli", phase_cli)
    bad = sorted(m for m in sys.modules if m in ("jax", "nbody_tpu")
                 or m.startswith(("jax.", "nbody_tpu.")))
    check(not bad, f"modules of JAX or nbody_tpu were imported: {bad}")
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    found = {key: {**kern[key], **sym_kern[key], **aj_kern[key], **ds_kern[key],
                   **ds_aj_kern[key], **mxu_kern[key], **p3m_kern[key]}
             for key in ("err", "times", "bounds")}
    kernels = [{
        "name": NAMES[k],
        "route": "cuda",
        "source": SOURCES[k],
        "replaces": REPLACES[k],
        "launches": launches[k],
        "max_abs_err": found["err"][k],
        "ms": found["times"][k][0],
        "plain_ms": found["times"][k][1],
        "bound_ms": found["bounds"][k][0],
        "bound_by": found["bounds"][k][1],
        # no single PyTorch call computes softened all-pairs gravity, its
        # jerk or its potential, in float32 or in ds (the mxu step's s is
        # no library call's input either), nor a cell-list short-range sum
        "library_ms": None,
    } for k in NAMES]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
