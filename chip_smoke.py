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
     {4099, 65536}; the step also in its j-chunks (step_splits) and in one
     at (1025, 65537), (16384, 65536) and (4099, 4099), masses from [0.5,
     2], a random vel.w and damping 0.5, blocks 128, 256 and 1024
     bit-equal; the force likewise at (1025, 65537), (16384, 65536) and
     (16384, 16384), blocks 64 to 1024 and a repeat bit-equal, at the
     rule's S bit-equal to the velocity of a step from rest (dt = 1,
     damping 1: the force is the step's sum); their times at N=65536;
  3s. the each-pair-once kernels against their plain versions: the
     triangle at N in {1000, 4099}, the blocked composition at N=65536 and
     at N=135168 (the main path's shapes), the rectangle at (777, 4099) and
     (cap, cap), random masses, vel.w and damping 0.5 through a step at
     N in {4099, 65536}; run-to-run bit equality; momentum; their times;
  3h. the accel + jerk kernels (one-sided, each-pair-once triangle and
     rectangle) and the potential kernel against their plain versions, at
     the cases of 3 and 3s, random masses, vel.w and damping 0.5 through a
     Hermite step of each variant at N in {4099, 65536}; the one-sided
     kernel in its j-chunks and in one, at (M, N) from (777, 4099) and
     (1025, 65537) to the four-card hops (16384, 65536) and (16384, 16384),
     at blocks 128, 256 and 1024, bit-equal across blocks; bit equality;
     momentum and its derivative; the potential in its j-chunks
     (step_splits) at N up to 65537, blocks 128, 256 and 1024 and repeats
     bit-equal; their times, the triangle's also at the N=135168
     composition's block, beside the each-pair-once kernels' and the
     potential's ptxas registers and spills (none allowed) and their walks'
     SASS instructions a pair, and the one-sided kernel's registers and
     spills (3dh: the ds one's);
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
     and with Hermite (auto and vpu);
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
     plain, repeat calls bit-equal; the one-sided kernel also on the
     first M rows, (1025, 4099), (4096, 16384) and (4096, 4096), in its
     j-chunks and in one, at blocks 64, 128 and 256, bit-equal across
     blocks and held to the rows of the set's oracle; their times at
     N=16384 and the rectangle's at the main path's shape;
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
     (16384, 65536), (65536, 65536)}, in their j-chunks (mxu_splits), random
     masses, vel.w and damping 0.5 at four of them, repeat calls bit-equal;
     the rollout kernel against k launches of the step kernel, bit for bit,
     and one rollout step against the plain step; their times at N=65536,
     the rollout's k=10 both ways in turns; the mxu walks' registers and
     SASS a pair (a spill fails);
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
     kernel's time at N=65536, its work and pruning (p3m.pair_work), its
     bound (the near pairs) and the plain version's time;
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
     update), with the kernel's work, pruning and bound;
  3q. the pair kernel over a rank's range of its work (the sharded P3M
     step's launch): on the contract-keeping shell states at N=65536 and
     2^20, G=64, cut into D = 2, 4 and 8 ranges (p3m.item_range), every
     range's rows bit-equal to the whole launch's and zero elsewhere, each
     range's time beside the whole launch's / D; at 65536 the two ranges of
     D = 2 against their plain version at rtol 1e-4 / atol 2e-4 and the
     one-range launch of a one-rank mesh timed beside its plain version;
  5q. the mesh solvers: plain PM (CIC, TSC) and TSC P3M at N=65536 and
     2^20, G=64, on the card against their plain versions on the CPU (PM
     and P3M's long range whole at 1e-4 * max|a|, P3M's short range on 256
     rows at rtol 1e-4 / atol 2e-4) and within nbody_tpu's envelopes
     against the all-pairs force on 512 rows (PM median < 0.06, P3M median
     < 0.008 and 90th percentile < 0.02); QA at 16384 of PM (CIC, TSC) and
     TSC P3M (Euler, leapfrog); run_benchmark(3) at 2^20 of PM and TSC P3M
     with the auto-refresh; README's demo-0 P3M run at 2^20 with
     --p3m-auto-refresh, which must give no warning and end within its
     capacity, its rewinds printed; on a one-rank NCCL mesh the sharded PM
     and P3M steps (replicated and slab, CIC and TSC, Euler and leapfrog),
     3 steps at 65536 bit-equal to the single card's, each P3M run
     launching the ranged pair kernel; the demo loop on that mesh under
     ring_fused and sym with --render, 5 frames from the first, the last
     frame equal to rendering the gathered state;
  3da. the ds accel-only kernel of the sharded ring step, the fused ds
     step and the ds leapfrog step, split alike (ds_splits), against their
     plain versions at (M, N) in {(4099, 4099), (4099, 16384), (4099,
     65536), (4096, 16384)}, at the rule's S and at S = 1, i-set and j-set
     two states or a four-card shard, masses from [0.5, 2] and a random
     vel.w: within 1e-12 * max + 1e-14 of plain and 1e-10 * max|a| of the
     float64 oracle, the accel kernel's (M,4) rows' w = 0, blocks 64, 128,
     256 and repeats bit-equal, the leapfrog from rest bit-equal to the
     accel kernel, the accel kernel then the ds Euler update equal to the
     fused ds step on the same j-set bit for bit; the three kernels' times
     in turns at 16384, 65536, (4096, 16384) and (16384, 65536);
  3rf. the fused ring kernel (strategy="ring_fused") on states with masses
     from [0.5, 2], a random vel.w and 77 zero-mass bodies at the origin:
     at D = 1 (M = 4099, 65536) bit-equal to one accel launch, through the
     emulated ring (D virtual ranks in one launch) at D = 2 and 4 with
     shards of 1025 and 16384 every rank bit-equal to the hop-ordered sum
     of accel launches (each hop in step_splits(M, M) j-chunks: 17, 16, 5
     and 64), all within 1e-4 * max|a| + 1e-4 of the plain
     version; 200 emulated D = 4 calls bit-equal to the first; its times at
     D = 1 and emulated D = 4 (N=65536 in all) beside accel, in turns;
  3ri. the fused ring between two processes on the card through CUDA IPC
     (scripts/torch_ring_ipc.py), each call bit-equal to the hop-ordered
     accel launches;
  5x. the body-sharded path on a one-rank NCCL mesh (make_mesh(1)), only
     mesh systems in its count, each run of which must launch its own
     strategy's kernels: Compute(precision="ds", mesh=, strategy="ring")
     QA for Euler, leapfrog and Hermite and strategy="allgather" QA at
     N=16384, fp32 ring_fused QA for Euler and leapfrog at 16384, fp32
     allgather, ring and ring_fused QA and run_benchmark(10) at N=65536,
     ten ring_fused Euler steps at 65536 bit-equal to ten ring steps,
     ds ring Euler run_benchmark at 16384 and 65536, ten ds ring Euler and
     leapfrog and three Hermite steps; after it, outside the count, the
     single-device step times beside the mesh's and the same steps on one
     device: the ring Euler equal bit for bit (leapfrog and Hermite within
     5e-9, bit equality reported);
  5y. the rest of parallel/ on the card: strategy="sym" on the one-rank
     NCCL mesh (QA for Euler, leapfrog and Hermite at 16384, a benchmark at
     65536, steps at 135168 and 73728, above the caps), float64 allgather
     and ring QA on it, a 1x1 make_mesh_2d grid in fp32, ds and float64
     (QA, a benchmark at 65536), each run launching its own kernels and
     each system's launches a step printed; after it, outside the count,
     the one-rank sym force and accel + jerk bit-equal to the single-device
     composition, emulated_sym at D = 2, 3, 4, 8 and at D = 4, N = 2^20
     (sub-blocked rectangles) and emulated_accel_2d 2x2 and 2x4 within
     1e-4 * max|a| + 1e-4 of the plain force (the one-sided force kernel at
     2^20), each bit-equal on a repeat;
  3e. the kernels of the JAX package's three experiment scripts against
     their plain versions at N in {1000, 4099, 65536}, masses from [0.5, 2],
     a random vel.w and damping 0.5 at 4099 and 65536: the dual-bank step
     (blocks 64, 128, 256) and the packed-state step (128, 256) by phase
     3's bounds, each bit-equal to the step kernel at the same block (the
     packed one also to a step_t step, its planes to its new positions);
     the sym triangle's reaction ablations (none, tree_small, full) at
     tiles 128, 256 and 1024: the action and the full reaction within
     1e-4 * max|a| + 1e-4 of plain, the tree_small slots within 1e-4 of
     each tile pair's sum of |terms|, the full total bit-equal to
     sym_accel_cuda, the three actions bit-equal; repeat calls bit-equal;
     the production kernels' registers (step and step_t at 4 rows a
     thread, sym_tri<8>) those of the recorded build, and no spill inside
     the walk of any instantiation of the four step kernels, the force
     kernel and the ring kernel, which run the same walk (SASS); times
     at N=65536 in turns beside the kernel each one varies;
  5e. the ports of the experiment scripts as a user runs them, at N=65536:
     scripts/torch_r3_dualbank.py, scripts/torch_r3_packed.py and
     scripts/torch_r4_sym_budget.py 65536, in this process;
  7. the CLI in subprocesses: --qatest, --benchmark, --variant sym with
     --integrator leapfrog --qatest and with --benchmark, --integrator
     hermite with --qatest and with --drift-check 3, --variant mxu --qatest,
     --variant mxu_bf16 --benchmark, and --precision ds with --qatest,
     --benchmark, --integrator leapfrog --qatest, --drift-check 10, and
     --integrator hermite --qatest (N=4096) and --benchmark, --qatest with
     --variant mxu_bf16 --hostmem --kernel p3m (flags the ds modes run
     without, each named), and --kernel p3m --numbodies 65536 --benchmark
     -i 3.
  8. the demo loop, in this process through the CLI's main(), as a user
     runs it: --config galaxy --numbodies 65536 --frames 30 --render (30
     PNG frames and metadata.json), the same for 600 frames without
     --render (the reported fps), --selftest at N=16384 (PASSED), and a ds
     and an fp64 checkpoint resume at N=16384, 2 + 2 frames bit-equal to 4
     straight (the ds one through its raw hi/lo planes); after it, outside
     the count: the rasterizer's card frames against its CPU frames on the
     same state (|delta| <= 1 level a channel, >= 99.9 % exact; every mode
     and method at 4099 bodies, 256x192, and sprites_color by both methods
     at 16384, 512x384), two renders of one state at 65536, 1024x768,
     bit-equal (scatter, conv and sprites_alpha), the frame's time at
     65536 and 2^20 bodies, 1024x768, sprites_color, by scatter and by
     conv (splat 16 and 8, the CLI's default), and at 65536 the demo
     frame's parts: a sym step, the frame, the HUD and the PNG write.
Phases 4-5 are the one-sided main path's run, 5s the sym path's, 5h the
Hermite path's, 5d the ds path's, 5dh the ds Hermite path's, 5m the
tensor-core path's, 5r the rollout's, 5p the P3M path's, 5q the mesh
solvers' and the demo on a mesh (the ranged pair kernel, the fused ring
and the sym triangle must launch there), 5x the
sharded path's, 5y the sym, grid and float64 mesh paths', 5e the
experiment scripts' and 8 the demo loop's (the sym
kernel must launch there): the kernels' launch counters are
set to 0 before each and read after it, and each kernel of that path must
have launched. Any failure raises, and the script exits nonzero. The last lines
are the card, one JSON object listing every kernel, and the result line.
"""

from __future__ import annotations

import functools
import json
import math
import os
import pathlib
import re
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
SOFT_RING = 0.1  # demo 0's softening, phase 3rf's
P3M_RTOL, P3M_ATOL = 1e-4, 2e-4  # tests/test_p3m.py:367, Pallas against XLA short range
# FP32-pipe instructions the short-range function needs a pair within rcut,
# with FMA: 7 to test it (3 FADD for d, FMUL + 2 FFMA for r2, the compare)
# and 19 for its term (FADD of eps2, 2 FMUL for inv^3, FMUL for y, 10 FFMA
# of Horner's rule, FFMA for inv^3 - s_lr, FMUL by m_j, 3 FFMA for the
# sums); each counts as 2 flops at the fp32 peak, rsqrtf goes to the SFU.
# The bound counts the near pairs alone: a kernel that prunes groups of
# candidate pairs by their boxes never tests most of them. Printed beside
# it: the candidate-based figure (7 for every candidate pair of
# neighbouring cells, 19 more a near pair: a cell list that tests each
# candidate) and the kernel's own rounding (9 + 31 a near pair, its terms
# unfused as its plain version rounds them, csrc/p3m_kernels.cu).
P3M_TEST_INSTR, P3M_TERM_INSTR = 7, 19
P3M_UNFUSED_INSTR = 40
# the card's peak fp32 rate outside the tensor cores and its memory rate
# (NVIDIA's H100 SXM data sheet, at the full 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the native fp64 kernels (csrc/f64_kernels.cu, phases 3f and 5f): they
# replace no pl.pallas_call (the JAX package's fp64 is its XLA path), so they
# stay out of the kernels line and print a line of their own before it. Their
# bound: the JAX package's flops a pair (the fp32 rows' counts: 20 for the
# step and the force, 48 with the jerk, 12 for the potential) at the card's
# FP64 rate outside the tensor cores (NVIDIA's H100 SXM data sheet, 700 W),
# and their issue bound: the walk's FP64 instructions a pair (SASS) at 64
# FP64 lanes an SM.
F64_KERNELS = ("step_f64", "accel_f64", "accel_jerk_f64", "potential_f64")
F64_NAMES = {"step_f64": "nbody_step_f64, nbody_step_split_f64 (+ f64_step_finish_kernel)",
             "accel_f64": "nbody_accel_f64, nbody_accel_split_f64 (+ f64_sum_partials_kernel)",
             "accel_jerk_f64": "nbody_accel_jerk_f64, nbody_accel_jerk_split_f64 "
                               "(+ f64_sum_partials_kernel)",
             "potential_f64": "nbody_potential_f64, nbody_potential_split_f64 "
                              "(+ f64_potential_finish_kernel)"}
F64_REPLACES = {"step_f64": "no pl.pallas_call: nbody_tpu/ops/reference.py:89 (XLA)",
                "accel_f64": "no pl.pallas_call: nbody_tpu/ops/reference.py:52 (XLA)",
                "accel_jerk_f64": "no pl.pallas_call: nbody_tpu/ops/reference.py:149 (XLA)",
                "potential_f64": "no pl.pallas_call: nbody_tpu/ops/energy.py:24 (XLA)"}
F64_FLOPS = {"step_f64": 20.0, "accel_f64": 20.0, "accel_jerk_f64": 48.0, "potential_f64": 12.0}
# each double kernel's walk by a piece of its mangled name
F64_WALKS = {"step_f64": "15f64_step_kernel", "accel_f64": "16f64_accel_kernel",
             "accel_jerk_f64": "21f64_accel_jerk_kernel", "potential_f64": "20f64_potential_kernel"}
PEAK_FP64_FLOPS = 34e12
FP64_LANES = 64
F64_SOURCE = "nbody_tpu_torch/csrc/f64_kernels.cu"
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
           "ds_accel": "nbody_tpu_torch/csrc/ds_kernels.cu",
           "ds_sym": "nbody_tpu_torch/csrc/ds_symmetric_kernels.cu",
           "ds_sym_cross": "nbody_tpu_torch/csrc/ds_symmetric_kernels.cu",
           "ds_accel_jerk": "nbody_tpu_torch/csrc/ds_aj_kernels.cu",
           "ds_aj_sym": "nbody_tpu_torch/csrc/ds_symmetric_aj_kernels.cu",
           "ds_aj_sym_cross": "nbody_tpu_torch/csrc/ds_symmetric_aj_kernels.cu",
           "p3m_sr": "nbody_tpu_torch/csrc/p3m_kernels.cu",
           "p3m_sr_range": "nbody_tpu_torch/csrc/p3m_kernels.cu",
           "ring_fused": "nbody_tpu_torch/csrc/ring_kernels.cu",
           "step_dual": "nbody_tpu_torch/csrc/nbody_kernels.cu",
           "step_packed": "nbody_tpu_torch/csrc/nbody_kernels.cu",
           "sym_ablate_full": "nbody_tpu_torch/csrc/symmetric_kernels.cu",
           "sym_ablate_none": "nbody_tpu_torch/csrc/symmetric_kernels.cu",
           "sym_ablate_tree_small": "nbody_tpu_torch/csrc/symmetric_kernels.cu"}
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
            "ds_accel": "nbody_tpu/ops/ds_kernel.py:363",
            "ds_sym": "nbody_tpu/ops/ds_kernel.py:1059",
            "ds_sym_cross": "nbody_tpu/ops/ds_kernel.py:1339",
            "ds_accel_jerk": "nbody_tpu/ops/ds_kernel.py:756",
            "ds_aj_sym": "nbody_tpu/ops/ds_kernel.py:1585",
            "ds_aj_sym_cross": "nbody_tpu/ops/ds_kernel.py:1839",
            "p3m_sr": "nbody_tpu/ops/p3m_kernel.py:250",
            # the same pallas_call over one device's chunk range of the worklist
            "p3m_sr_range": "nbody_tpu/ops/p3m_kernel.py:352 (chunk range :313-317, 384-386)",
            "ring_fused": "nbody_tpu/ops/ring_kernel.py:219",
            "step_dual": "scripts/tpu_r3_dualbank.py:36",
            "step_packed": "scripts/tpu_r3_packed.py:33",
            "sym_ablate_full": "scripts/tpu_r4_sym_budget.py:58",
            "sym_ablate_none": "scripts/tpu_r4_sym_budget.py:58",
            "sym_ablate_tree_small": "scripts/tpu_r4_sym_budget.py:58"}
NAMES = {"step": "nbody_step_f32, nbody_step_split_f32 (+ step_finish_kernel)",
         "step_t": "nbody_step_t_f32, nbody_step_t_split_f32 (+ step_finish_kernel)",
         "mxu_step": "nbody_mxu_step_f32, nbody_mxu_step_split_f32 (+ mxu_finish_kernel)",
         "mxu_bf16_step": "nbody_mxu_step_bf16, nbody_mxu_step_split_bf16 (+ mxu_finish_kernel)",
         "accel": "nbody_accel_f32, nbody_accel_split_f32 (+ sum_partials_kernel)",
         "sym": "nbody_sym_accel_f32", "sym_cross": "nbody_sym_cross_f32",
         "accel_jerk": "nbody_accel_jerk_f32, nbody_accel_jerk_split_f32",
         "potential": "nbody_potential_f32, nbody_potential_split_f32 "
                      "(+ potential_finish_kernel)",
         "aj_sym": "nbody_aj_sym_f32", "aj_sym_cross": "nbody_aj_cross_f32",
         "ds_step": "nbody_ds_step, nbody_ds_step_split (+ ds_step_finish_kernel)",
         "ds_leapfrog": "nbody_ds_leapfrog, nbody_ds_leapfrog_split "
                        "(+ ds_leapfrog_finish_kernel)",
         "ds_accel": "nbody_ds_accel, nbody_ds_accel_split (+ ds_sum_partials_kernel)",
         "ds_sym": "nbody_ds_sym_accel", "ds_sym_cross": "nbody_ds_sym_cross",
         "ds_accel_jerk": "nbody_ds_accel_jerk, nbody_ds_accel_jerk_split",
         "ds_aj_sym": "nbody_ds_aj_sym",
         "ds_aj_sym_cross": "nbody_ds_aj_cross", "p3m_sr": "nbody_p3m_sr_f32",
         "p3m_sr_range": "nbody_p3m_sr_range_f32",
         "ring_fused": "nbody_ring_accel_f32 (+ ring_finish_kernel)",
         "step_dual": "nbody_step_dual_f32, nbody_step_dual_split_f32 (+ step_finish_kernel)",
         "step_packed": "nbody_step_packed_f32, nbody_step_packed_split_f32 "
                        "(+ step_finish_kernel)",
         "sym_ablate_full": "nbody_sym_ablate_f32 (reaction=full)",
         "sym_ablate_none": "nbody_sym_ablate_f32 (reaction=none)",
         "sym_ablate_tree_small": "nbody_sym_ablate_f32 (reaction=tree_small)"}
HERMITE_KERNELS = ("accel_jerk", "aj_sym", "aj_sym_cross", "potential")
MXU_KERNELS = ("mxu_step", "mxu_bf16_step")
# the mma work: 16 flops a (padded) pair (n = 8) and pass, two TF32 passes
# or one bf16 pass, at the card's dense tensor rates (NVIDIA's H100 SXM data
# sheet)
MXU_TENSOR = {"mxu_step": (2 * 16.0, 495e12), "mxu_bf16_step": (16.0, 989e12)}
# the mxu step's work outside the tensor cores: the JAX package's 20 flops a
# pair for the whole step (pallas_kernel.py:399-400) less the 8 of the s.P
# product (4 columns, a multiply and an add each), which the mma does and
# MXU_TENSOR charges: 12 left, the 3 differences, r2's 6 (3 FFMA), the rsqrt
# and inv^3's 2 FMUL
MXU_FP32_FLOPS = 20.0 - 8.0
# the mxu walks by a piece of their mangled names (csrc/mxu_kernels.cu)
MXU_WALKS = {"mxu_step": "6Tf32x3", "mxu_bf16_step": "4Bf16"}
# MUFU.RSQ a clock an SM (the SFU): one a pair in the mxu and potential walks;
# the H100 SXM's top SM clock, at which PERF.md states issue bounds and floors
SFU_PER_CLOCK = 16
NOMINAL_MHZ = 1980
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
# the kernels of the JAX package's experiment scripts (phases 3e and 5e)
EXPERIMENT_KERNELS = ("step_dual", "step_packed", "sym_ablate_full", "sym_ablate_none",
                      "sym_ablate_tree_small")
# the production kernels whose template the experiment kernels share, by a
# piece of their mangled names, and their registers (ptxas -v): sym_tri's in
# the build whose walk (sym_walk, csrc/symmetric_kernels.cu) the rectangle and
# the ablations run too (127 with the j-shuffle walk before it); the step
# kernels' (4 rows a thread, blocks up to 512) in the build whose shared walk
# (walk_chunk, csrc/allpairs_common.cuh) the force and the ring kernel run
# too (step_t's 64 of the build before it, with 8 bytes spilled outside its
# walk, became 62 and no spill)
PRODUCTION_MANGLED = {"step_kernel<4, 512>": "11step_kernelILi4ELi512EE",
                      "step_t_kernel<4, 512>": "13step_t_kernelILi4ELi512EE",
                      "sym_tri_kernel<8>": "14sym_tri_kernelILi8EE"}
PRODUCTION_REGISTERS = {"step_kernel<4, 512>": 64, "step_t_kernel<4, 512>": 62,
                        "sym_tri_kernel<8>": 123}
# the four step kernels by a piece of their mangled names (phase 3e holds
# every instantiation's walk free of spills), and the kernels that run
# their walk: the force (nbody_kernels.cu) and the fused ring (ring_kernels.cu)
STEP_WALKS = ("11step_kernel", "13step_t_kernel", "16step_dual_kernel", "18step_packed_kernel")
WALK_SHARERS = {"nbody_kernels.cu": ("12accel_kernel",),
                "ring_kernels.cu": ("17ring_accel_kernel",),
                # the each-pair-once kernels, one walk (sym_walk)
                "symmetric_kernels.cu": ("14sym_tri_kernel", "16sym_cross_kernel",
                                         "17sym_ablate_kernel")}


@functools.cache
def sass_of_source(src: str) -> tuple:
    """``_build.sass_of(src)``, one nvcc and one cuobjdump a source a run
    (phases 3s and 3e both read the sym kernels' SASS)."""
    from nbody_tpu_torch.ops import _build

    return _build.sass_of(src)


def sym_walk_lines(tile: int) -> list:
    """The registers and the walk's SASS count a pair (the innermost loop
    around MUFU.RSQ, over its MUFU.RSQ) of the triangle and the rectangle at
    `tile`: the off-diagonal walk and, for the triangle, the diagonal's."""
    from nbody_tpu_torch.ops import _build

    usage, text = sass_of_source("symmetric_kernels.cu")
    names = _build.demangle(usage)
    rows = tile // 128
    lines = []
    for key in (f"14sym_tri_kernelILi{rows}EE", f"16sym_cross_kernelILi{rows}EE"):
        loops = _build.sass_loops(text, key)
        check(bool(loops), f"no rsqrt loop in the SASS of {key}")
        per = sorted(w["instructions"] / w["pairs"] for w in loops)
        regs = ptxas_registers(usage, key)
        name = names.get(loops[0]["function"], loops[0]["function"])
        lines.append(f"{name}: {regs} registers, walk {per[0]:.2f} SASS instructions a pair"
                     + (f" ({per[-1]:.2f} on the diagonal)" if len(per) > 1 else ""))
    return lines


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time for the work: the larger of operations over the fp32
    peak and bytes over the memory rate, and which of the two it is."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device(torch) -> str:
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.utils.timing import card_line

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    nvcc = _build.find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
    release = [ln for ln in version.splitlines() if "release" in ln]
    smi = card_line()
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

    # the step in its j-chunks (step_splits) and in one, at an odd shape, a
    # four-card hop and one card, masses from [0.5, 2], a random vel.w and
    # damping 0.5: within the bounds above, the same bits at blocks 128,
    # 256 (4 rows a thread) and 1024 (one)
    for m, n in ((1025, 65537), (N_QA, N_MAIN), (4099, 4099)):
        pj, vj = shell_state(torch, n, random_w=True)
        pi, vi = pj[:m].contiguous(), vj[:m].contiguous()
        p_r, v_r = reference.nbody_step_vs(pi, vi, pj, dt, soft, 0.5)
        tol_a = 1e-4 * reference.compute_accel_vs(pi, pj, soft).abs().max().item() + 1e-4
        tol_v, tol_p = 1e-5 + dt * tol_a, 1e-5 + dt * dt * tol_a
        for splits in sorted({ck.step_splits(m, n), 1}):
            first = None
            for bs in (128, 256, 1024):
                got = ck.nbody_step_cuda_vs(pi, vi, pj, dt, soft, 0.5, block_size=bs,
                                            splits=splits)
                if first is None:
                    first = got
                    e_p = (got[0] - p_r).abs().max().item()
                    e_v = (got[1] - v_r).abs().max().item()
                    kept = bool(torch.equal(got[0][:, 3], pi[:, 3]) and
                                torch.equal(got[1][:, 3], vi[:, 3]))
                    what = f"M={m} N={n} splits={splits}"
                    print(f"[3 kernels] step {what}: max|dpos|={e_p:.3e} (tol {tol_p:.3e}) "
                          f"max|dvel|={e_v:.3e} (tol {tol_v:.3e}); w-lanes kept: {kept}")
                    check(e_p <= tol_p and e_v <= tol_v and kept,
                          f"split step kernel disagrees at {what}")
                    err["step"] = max(err["step"], e_p, e_v)
                check(all(torch.equal(a, b) for a, b in zip(got, first)),
                      f"step kernel differs between blocks at M={m} N={n} splits={splits}")
            print(f"[3 kernels] step M={m} N={n} splits={splits}: blocks 128, 256, 1024 "
                  "bit-equal")

    # the force in its j-chunks (step_splits) and in one, at an odd shape and
    # the four-card hop shapes, masses from [0.5, 2]: within the bound above,
    # the same bits at blocks 64 to 1024 and on a repeat, and at the rule's S
    # the velocity of a step from rest (dt = 1, damping 1): the step's sums
    for m, n in ((1025, 65537), (N_QA, N_MAIN), (N_QA, N_QA)):
        pj, _ = shell_state(torch, n, random_w=True)
        pi = pj[:m].contiguous()
        a_r = reference.compute_accel_vs(pi, pj, soft)
        tol_a = 1e-4 * a_r.abs().max().item() + 1e-4
        rest = ck.nbody_step_cuda_vs(pi, torch.zeros_like(pi), pj, 1.0, soft, 1.0)[1][:, :3]
        for splits in sorted({ck.step_splits(m, n), 1}):
            first = ck._accel(pi, pj, soft, 256, splits=splits)
            same = all(torch.equal(ck._accel(pi, pj, soft, bs, splits=splits), first)
                       for bs in (64, 128, 256, 512, 1024))
            e_a = (first - a_r).abs().max().item()
            step = bool(torch.equal(first, rest))
            what = f"M={m} N={n} splits={splits}"
            print(f"[3 kernels] accel {what}: max|da|={e_a:.3e} (tol {tol_a:.3e}); blocks 64-1024 "
                  f"and a repeat bit-equal {same}; a step from rest's velocity bit-equal {step}")
            check(e_a <= tol_a, f"split accel kernel disagrees at {what}")
            check(same, f"accel kernel differs between blocks or repeats at {what}")
            check(step or splits != ck.step_splits(m, n),
                  f"accel kernel differs from the step kernel's sum at {what}")
            err["accel"] = max(err["accel"], e_a)

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
    for line in sym_walk_lines(tile):
        print(f"[3s sass] {line}")
    return {"err": err, "times": times, "bounds": bounds}


def phase_aj_kernels(torch) -> dict:
    """The accel + jerk kernels and the potential kernel against their plain
    versions. Only the order of the sums differs, so each output (the
    acceleration, the jerk, a reaction, the potential's per-row sums) is
    held to 1e-4 * max + 1e-4 of its own, the bound of phase 3; a Hermite
    step carries the bounds into the velocity as dt * da + dt^2 * dj and
    into the position as dt^2 * da + dt^3 * dj, plus 1e-5."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import _build, energy, reference
    from nbody_tpu_torch.ops import cuda_kernel as ck
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

    # the one-sided kernel in its j-chunks (aj_splits) and in one chunk: M
    # not a multiple of a block's rows, N odd and not a multiple of the
    # stage or of S, the four-card hops at N = 65536 (M = N / 4 under all N
    # and under one shard); at every block the same bits, and on a repeat
    cases = [(1000, 1000), (4099, 4099), (777, 4099), (1025, 65537), (N_MAIN, N_MAIN),
             (N_MAIN // 4, N_MAIN), (N_MAIN // 4, N_MAIN // 4)]
    for m, n in cases:
        pj, vj = shell_state(torch, n)
        pi, vi = pj[:m].contiguous(), vj[:m].contiguous()
        want = reference.compute_accel_jerk_vs(pi, vi, pj, vj, soft)
        for splits in sorted({ck.aj_splits(m, n), 1}):
            first = None
            for bs in (128, 256, 1024):
                got = ck._accel_jerk(pi, vi, pj, vj, soft, bs, splits=splits)
                again = ck._accel_jerk(pi, vi, pj, vj, soft, bs, splits=splits)
                first = got if first is None else first
                same = all(torch.equal(a, b) for a, b in (*zip(got, again), *zip(got, first)))
                held("accel_jerk", got, want,
                     f"one-sided M={m} N={n} splits={splits} block={bs}")
                check(same, f"the one-sided accel + jerk differs between calls or blocks at "
                      f"M={m} N={n} splits={splits} block={bs}")
        print(f"[3h aj] one-sided M={m} N={n}: repeats and blocks 128, 256, 1024 bit-equal at "
              f"splits {sorted({ck.aj_splits(m, n), 1})}")
    # the potential in its j-chunks (step_splits(N, N)): at blocks 128,
    # 256 and 1024 (four rows a thread, and one) and on a repeat the same
    # bits; N = 65537 ends the set one body past a stage
    for n in (1000, 4099, N_MAIN, N_MAIN + 1):
        p, _ = shell_state(torch, n)
        want = energy.potential_energy_per_row(p, soft)
        first = None
        for bs in (128, 256, 1024):
            got = ck.potential_energy_per_row_cuda(p, soft, block_size=bs)
            first = got if first is None else first
            held("potential", (got,), (want,), f"potential N={n} block={bs}", ("per-row sums",))
            check(torch.equal(got, first)
                  and torch.equal(got, ck.potential_energy_per_row_cuda(p, soft, block_size=bs)),
                  f"the potential differs between blocks or calls at N={n} block={bs}")
        print(f"[3h aj] potential N={n} (S={ck.step_splits(n, n)}): blocks 128, 256, 1024 and "
              f"repeats bit-equal")
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
    # under the cap), the triangle and the rectangle of the blocks of
    # N=135168
    _, blk = reference.sym_blocking(N_BIG, tile, cap)
    p, v = shell_state(torch, N_MAIN)
    pb, vb = shell_state(torch, N_BIG)
    pi, vi, pj, vj = pb[:blk], vb[:blk], pb[blk:2 * blk], vb[blk:2 * blk]
    bi, bj = pi.shape[0], pj.shape[0]
    kernel_ms, t_blk = [], bound_ms(60.0 * bi * (bi - 1) / 2, bi * 32 + bi * 24)
    for _ in range(2):
        ck.aj_sym_cuda(pi, vi, soft, tile=tile)
        kernel_ms.append(elapsed_ms(lambda: [ck.aj_sym_cuda(pi, vi, soft, tile=tile)
                                             for _ in range(5)], dev) / 5)
    print(f"[3h aj] aj_sym at N={bi} (the blocks of N={N_BIG}), tile {tile}: kernel "
          f"{min(kernel_ms):.3f} ms (rounds {', '.join(f'{t:.3f}' for t in kernel_ms)}), "
          f"bound {t_blk[0]:.3f} ms ({t_blk[1]})")
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
    sfu_floor = n * n / (SFU_PER_CLOCK * NOMINAL_MHZ * 1e6 * torch.cuda.get_device_properties(
        0).multi_processor_count) * 1e3
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
              f"bound {bounds[name][0]:.3f} ms ({bounds[name][1]})"
              + (f", SFU floor {sfu_floor:.3f} ms at {NOMINAL_MHZ} MHz" if name == "potential"
                 else ""))
    # ptxas and the SASS of the each-pair-once kernels and of the potential:
    # one more nvcc a source, after the timed loops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {128: 1, 256: 2, 512: 4, 1024: 8}[tile]
    walk_lines(_build, "symmetric_aj_kernels.cu", f"aj_sym_tri_kernelILi{rows}E", "[3h aj]",
               n * (n - 1) / 2, sms)
    walk_lines(_build, "symmetric_aj_kernels.cu", f"aj_sym_cross_kernelILi{rows}E", "[3h aj]",
               float(bi) * bj, sms)
    spills_checked(_build, "nbody_kernels.cu", "17accel_jerk_kernel", "[3h aj]")
    walk_lines(_build, "nbody_kernels.cu", "16potential_kernel", "[3h aj]", n * n, sms)
    return {"err": err, "times": times, "bounds": bounds}


def walk_lines(build, source: str, key: str, tag: str, pairs: float, sms: int) -> None:
    """Print each kernel of `source` whose mangled name holds `key`: its
    registers and its walk's SASS a pair (the cheapest innermost loop
    around MUFU.RSQ, over its MUFU.RSQ, by class; a masked, ragged or
    diagonal twin beside it) with the issue bound of that count for `pairs` pairs on `sms` SMs
    at the nominal clock; fails on a spill (one more nvcc, shared a run)."""
    usage, text = sass_of_source(source)
    names = build.demangle(usage)
    found = [(k, u) for k, u in usage.items() if key in k]
    check(bool(found), f"no kernel {key} in {source}")
    for mangled, u in found:
        loops = sorted(build.sass_loops(text, mangled),
                       key=lambda lp: lp["instructions"] / lp["pairs"])
        check(bool(loops), f"no rsqrt loop in the SASS of {names[mangled]}")
        per = [lp["instructions"] / lp["pairs"] for lp in loops]
        mix = ", ".join(f"{c} {k / loops[0]['pairs']:.2f}"
                        for c, k in sorted(loops[0]["mix"].items()))
        issue = pairs * per[0] / 32 / (sms * 4 * NOMINAL_MHZ * 1e6) * 1e3
        print(f"{tag} {names[mangled]}: {u['registers']} registers, {u['spill_stores']} / "
              f"{u['spill_loads']} bytes spill stores / loads, {u['smem']} bytes smem; walk "
              + " / ".join(f"{x:.2f}" for x in per) + f" SASS instructions a pair ({mix}); "
              f"issue bound {issue:.3f} ms at {NOMINAL_MHZ} MHz")
        check(u["spill_stores"] == 0 and u["spill_loads"] == 0,
              f"{names[mangled]} spills registers")


def spills_checked(build, source: str, key: str, tag: str) -> None:
    """What ptxas says of each kernel of `source` whose mangled name holds
    `key` (one more nvcc); fails on a spill."""
    usage = build.ptxas_usage(source)
    names = build.demangle(usage)
    found = [(k, u) for k, u in usage.items() if key in k]
    check(bool(found), f"no kernel {key} in {source}")
    for mangled, u in found:
        print(f"{tag} {names[mangled]}: {u['registers']} registers, {u['spill_stores']} / "
              f"{u['spill_loads']} bytes spill stores / loads, {u['smem']} bytes smem")
        check(u["spill_stores"] == 0 and u["spill_loads"] == 0,
              f"{names[mangled]} spills registers")


def mxu_bound_ms(key: str, pairs: float, nbytes: float) -> tuple[float, str]:
    """The least time of an mxu step, read from the work whatever implements
    it: the larger of its flops outside the tensor cores (MXU_FP32_FLOPS a
    pair) over the fp32 peak, its mma flops (MXU_TENSOR) over the
    tensor-core rate, and its bytes over the memory rate."""
    t_fp32 = MXU_FP32_FLOPS * pairs / PEAK_FP32_FLOPS * 1e3
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
             (4099, 4099, True, 0.5), (N_MAIN // 4, N_MAIN, True, 0.5),
             (N_MAIN, N_MAIN, True, 0.5)]
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
        sfu = pairs / (SFU_PER_CLOCK * NOMINAL_MHZ * 1e6
                       * torch.cuda.get_device_properties(0).multi_processor_count) * 1e3
        print(f"[3m mxu] {key} at N={N_MAIN} (S={ck.mxu_splits(N_MAIN, N_MAIN)}): kernel "
              f"{t_k:.3f} ms, plain {t_p:.3f} ms per call, bound {bounds[key][0]:.3f} ms "
              f"({bounds[key][1]}), SFU floor {sfu:.3f} ms at {NOMINAL_MHZ} MHz")

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
    # ptxas and the SASS of the mxu walks: one more nvcc, after the timed loops
    from nbody_tpu_torch.ops import _build

    for key in MXU_KERNELS:
        walk_lines(_build, "mxu_kernels.cu", MXU_WALKS[key], "[3m mxu]", pairs,
                   torch.cuda.get_device_properties(0).multi_processor_count)
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


def oracle_accel_vs(pos_i64, pos_j64, soft):
    """The float64 oracle's force on the i-set under the j-set: the oracle's
    self force of the two sets together, the i-bodies massless, so that only
    the j-set pulls them."""
    import numpy as np

    from nbody_tpu_torch.compute import _oracle_accel

    ghosts = pos_i64.copy()
    ghosts[:, 3] = 0.0
    return _oracle_accel(np.concatenate([ghosts, pos_j64]), soft)[:len(pos_i64)]


def phase_ds_accel_kernel(torch) -> dict:
    """3da. The ds accel-only kernel of the ring step (ds_accel), the
    fused ds step (ds_step) and the ds leapfrog step (ds_leapfrog), which
    split the j-range alike (ds_splits),
    against their plain versions (ds.ds_accel_vs, and its force through
    ds.ds_integrate) at (M, N) = (4099, 4099), (4099, 16384) and (4099,
    65536), i-set and j-set two different states, M not a multiple of the
    block, and at (4096, 16384), a four-card shard under its set; each at
    the rule's S and at S = 1, masses from [0.5, 2] and a random vel.w, by
    phase 3d's rules (1e-12 * max + 1e-14 of plain; 1e-10 * max|a| of the
    float64 oracle, the step's force as one step from zero velocity with
    dt = 1 and damping 1), the same bits at blocks 64, 128 and 256 and on a
    repeat, the accel kernel's (M,4) rows' w = 0; the leapfrog step against
    ds.nbody_step_ds_leapfrog_vs by the same rule, its force (a step from
    zero velocity, dt = 1, damping 1, drifts no body) within 1e-10 * max|a|
    of the oracle and bit-equal to the accel kernel's at the same S and
    block; the accel kernel at the
    block the main path gives N bodies, then the ds Euler update, equals the
    fused ds step at the same block on the same j-set bit for bit; the
    kernels' times in turns at N = 16384 and 65536 and at the four-card
    shapes (4096, 16384) and (16384, 65536)."""
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import ds
    from nbody_tpu_torch.utils.timing import elapsed_ms

    dev = torch.device("cuda", 0)
    dt, soft = DEMO_PARAMS[0].time_step, DEMO_PARAMS[0].softening
    err = {"ds_accel": 0.0, "ds_step": 0.0, "ds_leapfrog": 0.0}
    scal = ds.scal_ds(dt, soft, 0.5)
    unit = ds.scal_ds(1.0, soft, 1.0)
    lscal = ds.scal_ds_leapfrog(dt, soft, 0.5)
    lunit = ds.scal_ds_leapfrog(1.0, soft, 1.0)

    def held(name, got, want, what):
        g64, w64 = ds.ds_to_f64(*got), ds.ds_to_f64(*want)
        tol = 1e-12 * np.abs(w64).max() + 1e-14
        e = float(np.abs(g64 - w64).max())
        err[name] = max(err[name], e)
        print(f"[3da ds accel] {what}: max|d| against plain {e:.3e} (tol {tol:.3e})")
        check(bool(np.isfinite(g64).all()) and e <= tol,
              f"{name} kernel disagrees with its plain version at {what}")

    def oracle(name, acc, ref, what):
        e_or = float(np.abs(ds.ds_to_f64(*acc)[:, :3] - ref).max()) / float(np.abs(ref).max())
        print(f"[3da ds accel] {what}: force against the float64 oracle max|da|/max|a| = "
              f"{e_or:.3e} (bound 1e-10)")
        check(e_or <= 1e-10, f"{name} force is not fp64-grade at {what}")

    odd_planes, odd64 = ds_state(torch, 4099, seed=42)
    for m, n in ((4099, 4099), (4099, N_QA), (4099, N_MAIN), (N_QA // 4, N_QA)):
        j_planes, j64 = ds_state(torch, n, seed=43)
        # another state of 4099 bodies, or a four-card shard: the first
        # quarter of the set under the set
        i_planes, i64 = ((odd_planes, odd64) if m == 4099 else
                         (tuple(t[:m].contiguous() for t in j_planes), j64[:m]))
        m, n = len(i64), len(j64)
        bs = ck.ds_default_block_size(n)
        zero = torch.zeros_like(i_planes[2])
        want = ds.ds_accel_vs(i_planes[0], i_planes[1], j_planes[0], j_planes[1], scal)
        want_step = ds.ds_integrate(*i_planes, want, scal)
        want_lf = ds.nbody_step_ds_leapfrog_vs(*i_planes, *j_planes, lscal)
        j_rest = (j_planes[0], j_planes[1], torch.zeros_like(j_planes[2]),
                  torch.zeros_like(j_planes[3]))
        ref = oracle_accel_vs(i64, j64, soft)
        for splits in sorted({ck.ds_splits(m, n), 1}):
            first = None
            for b in (64, 128, 256):
                what = f"({m}, {n}) splits={splits} block {b}"
                acc = tuple(t.clone() for t in ck._ds_accel(
                    i_planes[0], i_planes[1], j_planes[0], j_planes[1], scal, b, None,
                    splits=splits))
                step = ck._ds_step(*i_planes, j_planes[0], j_planes[1], scal, b, None,
                                   splits=splits)
                lf = ck._ds_leapfrog(*i_planes, *j_planes, lscal, b, None, splits=splits)
                got = (*acc, *step, *lf)
                if first is None:
                    first = got
                    held("ds_accel", acc, want, f"ds_accel {what}")
                    oracle("ds_accel", acc, ref, f"ds_accel {what}")
                    held("ds_step", step[:2], want_step[:2], f"ds_step {what} positions")
                    held("ds_step", step[2:], want_step[2:], f"ds_step {what} velocities")
                    force = ck._ds_step(i_planes[0], i_planes[1], zero, zero, j_planes[0],
                                        j_planes[1], unit, b, None, splits=splits)[2:]
                    oracle("ds_step", force, ref, f"ds_step {what}")
                    kept = all(torch.equal(g[:, 3], q[:, 3]) for g, q in zip(step, i_planes))
                    check(kept, f"ds_step changed a w lane at {what}")
                    held("ds_leapfrog", lf[:2], want_lf[:2], f"ds_leapfrog {what} positions")
                    held("ds_leapfrog", lf[2:], want_lf[2:], f"ds_leapfrog {what} velocities")
                    kept = all(torch.equal(g[:, 3], q[:, 3]) for g, q in zip(lf, i_planes))
                    check(kept, f"ds_leapfrog changed a w lane at {what}")
                    lforce = ck._ds_leapfrog(i_planes[0], i_planes[1], zero, zero, *j_rest,
                                             lunit, b, None, splits=splits)[2:]
                    oracle("ds_leapfrog", lforce, ref, f"ds_leapfrog {what}")
                    check(all(torch.equal(f[:, :3], a) for f, a in zip(lforce, acc)),
                          f"ds_leapfrog from rest differs from ds_accel at {what}")
                again = (*ck._ds_accel(i_planes[0], i_planes[1], j_planes[0], j_planes[1], scal,
                                       b, None, splits=splits),
                         *ck._ds_step(*i_planes, j_planes[0], j_planes[1], scal, b, None,
                                      splits=splits),
                         *ck._ds_leapfrog(*i_planes, *j_planes, lscal, b, None, splits=splits))
                check(all(torch.equal(x, y) for x, y in (*zip(got, again), *zip(got, first))),
                      f"ds_accel, ds_step or ds_leapfrog differs between calls or blocks at "
                      f"{what}")
            print(f"[3da ds accel] ({m}, {n}) splits={splits}: the three kernels' repeats and "
                  "blocks 64, 128, 256 bit-equal; the leapfrog from rest = ds_accel")
        what = f"ds_accel ({m}, {n}) block {bs}"
        out = tuple(torch.full((m, 4), 7.0, device=dev) for _ in range(2))

        def kernel():
            return ck.compute_accel_ds_cuda_vs(i_planes[0], i_planes[1], j_planes[0],
                                               j_planes[1], scal, block_size=bs, out=out)

        got = tuple(t.clone() for t in kernel())
        w_zero = all(bool((o[:, 3] == 0).all()) for o in out)
        same = all(torch.equal(a, b) for a, b in zip(got, kernel()))
        print(f"[3da ds accel] {what} (splits={ck.ds_splits(m, n)}): w lanes 0: {w_zero}; "
              f"repeat call bit-equal: {same}")
        check(w_zero and same, f"ds_accel rows or repeat at {what}")
        # a ring hop's blocks against the fused step, on the same j-set
        hop = ck.ds_integrate_cuda(*i_planes, *kernel(), scal)
        fused = ck.nbody_step_ds_cuda_vs(*i_planes, j_planes[0], j_planes[1], scal,
                                         block_size=bs)
        bits = all(torch.equal(a, b) for a, b in zip(hop, fused))
        print(f"[3da ds accel] {what}: ds_accel + ds_integrate equals the fused ds step bit "
              f"for bit: {bits}")
        check(bits, f"ds_accel + ds_integrate differs from the fused ds step at {what}")
        del j_planes, i_planes, out, zero, want, want_step, want_lf, j_rest
    del odd_planes
    times, bounds = {}, {}
    planes = {n: ds_state(torch, n)[0] for n in (N_QA, N_MAIN)}
    for m, n in ((N_QA, N_QA), (N_MAIN, N_MAIN), (N_QA // 4, N_QA), (N_QA, N_MAIN)):
        pj = planes[n]
        pi = tuple(t[:m] for t in pj)
        bs = ck.ds_default_block_size(m)
        out = tuple(torch.empty_like(pi[0]) for _ in range(4))
        # the accel kernel in turns with the fused step kernel, whose j-loop
        # and j-chunks it shares: accel, step, step, accel
        calls = {"ds_accel": lambda: ck.compute_accel_ds_cuda_vs(
                     pi[0], pi[1], pj[0], pj[1], scal, block_size=bs, out=out[:2]),
                 "ds_step": lambda: ck.nbody_step_ds_cuda_vs(*pi, pj[0], pj[1], scal,
                                                              block_size=bs, out=out),
                 "ds_leapfrog": lambda: ck.nbody_step_ds_leapfrog_cuda_vs(
                     *pi, *pj, lscal, block_size=bs, out=out)}
        reps = 10 if n == N_QA else 3
        ms = {name: [] for name in calls}
        for name in ("ds_accel", "ds_step", "ds_leapfrog", "ds_leapfrog", "ds_step", "ds_accel"):
            calls[name]()
            torch.cuda.synchronize()
            ms[name].append(elapsed_ms(lambda: [calls[name]() for _ in range(reps)], dev) / reps)
        plain = {"ds_accel": lambda: ds.ds_accel_vs(pi[0], pi[1], pj[0], pj[1], scal),
                 "ds_step": lambda: ds.nbody_step_ds_vs(*pi, pj[0], pj[1], scal),
                 "ds_leapfrog": lambda: ds.nbody_step_ds_leapfrog_vs(*pi, *pj, lscal)}
        flops = 2 * DS_PAIR_INSTR * float(m) * n
        # each input read once, each output written once: 16 bytes a plane
        # row (the accel kernel four planes in and two out, the step six in
        # and four out)
        shape_bounds = {"ds_accel": bound_ms(flops, (2 * m + 2 * n) * 16 + 2 * m * 16),
                        "ds_step": bound_ms(flops, (4 * m + 2 * n) * 16 + 4 * m * 16),
                        "ds_leapfrog": bound_ms(flops + 2 * 2 * DS_DRIFT_INSTR * (m + n),
                                                (4 * m + 4 * n) * 16 + 4 * m * 16)}
        for name in calls:
            t_k = min(ms[name])
            t_p = elapsed_ms(plain[name], dev) if (m, n) == (N_QA, N_QA) else None
            b = shape_bounds[name]
            print(f"[3da ds accel] {name} at ({m}, {n}) block {bs} splits={ck.ds_splits(m, n)}: "
                  f"kernel {t_k:.3f} ms ({', '.join(f'{t:.3f}' for t in ms[name])} in turns)"
                  + (f", plain {t_p:.3f} ms" if t_p is not None else "")
                  + f" per call, bound {b[0]:.3f} ms ({b[1]}, {100 * b[0] / t_k:.0f} % of it)")
            if (m, n) == (N_QA, N_QA) and name == "ds_accel":
                times[name], bounds[name] = (t_k, t_p), b
        del out
    del planes
    torch.cuda.empty_cache()
    return {"err": {"ds_accel": err["ds_accel"]}, "times": times, "bounds": bounds,
            "step_err": err["ds_step"], "leapfrog_err": err["ds_leapfrog"]}


def ring_state(torch, n, *, seed=42):
    """Phase 3rf's input: shell ICs with masses from [0.5, 2], a random
    vel.w and the last 77 bodies zero-mass at the origin (a ragged ring's
    padding); (pos, vel) on the card."""
    pos, vel = shell_state(torch, n, seed=seed, random_w=True)
    pos[-77:] = 0.0
    return pos, vel


def hop_ordered_accel(torch, ck, shards, block_size=256):
    """Each rank's force as the unfused ring sums it: one accel launch a
    hop, hop h from rank r - h, added in hop order (torch.add)."""
    d = len(shards)
    out = []
    for r in range(d):
        total = ck.compute_accel_cuda(shards[r], shards[r], SOFT_RING, block_size=block_size)
        for h in range(1, d):
            total = torch.add(total, ck.compute_accel_cuda(shards[r], shards[(r - h) % d],
                                                           SOFT_RING, block_size=block_size))
        out.append(total)
    return out


def phase_ring_kernel(torch) -> dict:
    """3rf. The fused ring kernel (ring_fused) against the unfused ring's
    sum and its plain version, on ring_state inputs: at D = 1 (a one-rank
    ring, no copies) at M = 4099 and 65536 bit-equal to one accel launch at
    the same block size; through the emulated ring (D virtual ranks in one
    launch, each with its own slots and flags) at D = 2 and 4 with shards
    of 1025 and 16384 bodies, every rank bit-equal to the hop-ordered sum of
    accel launches; all within phase 3's bound (1e-4 * max|a| + 1e-4) of
    reference.ring_accel_fused_plain; 200 emulated D = 4 calls back to back
    bit-equal to the first (the flags' epochs: a stale flag would let a hop
    read a slot early). Times with CUDA events after a warm-up call, in
    turns: D = 1 at N = 65536 beside accel, and emulated D = 4 at 16384 a
    rank (65536 in all) beside one accel launch at 65536."""
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import reference
    from nbody_tpu_torch.utils.timing import elapsed_ms

    dev = torch.device("cuda", 0)
    err = 0.0
    for d, m in ((1, 4099), (1, N_MAIN), (2, 1025), (4, 1025), (2, N_QA), (4, N_QA)):
        pos, _ = ring_state(torch, d * m)
        shards = [s.contiguous() for s in pos.split(m)]
        if d == 1:
            ring = ck.FusedRing(m, 1, 0, device=dev)
            got = [ck.ring_accel_fused_cuda(shards[0], SOFT_RING, ring)]
            ring.close()
        else:
            got = ck.ring_accel_fused_emulated_cuda(shards, SOFT_RING)
        want = hop_ordered_accel(torch, ck, shards)
        plain = reference.ring_accel_fused_plain(shards, SOFT_RING)
        torch.cuda.synchronize()
        bits = all(torch.equal(g, w) for g, w in zip(got, want))
        e = max((g - q).abs().max().item() for g, q in zip(got, plain))
        tol = 1e-4 * max(q.abs().max().item() for q in plain) + 1e-4
        what = f"D={d} M={m} S={ck.step_splits(m, m)}" + (" (emulated)" if d > 1 else "")
        print(f"[3rf ring kernel] {what}: every rank bit-equal to the hop-ordered accel "
              f"launches {bits}; max|da| against plain {e:.3e} (tol {tol:.3e})")
        check(bits, f"ring_fused differs from the hop-ordered accel launches at {what}")
        check(e <= tol, f"ring_fused disagrees with its plain version at {what}")
        err = max(err, e)
        del pos, shards, got, want, plain
    pos, _ = ring_state(torch, 4 * N_QA)
    shards = [s.contiguous() for s in pos.split(N_QA)]
    rings = ck.emulated_ring(dev, 4, N_QA)  # kept across the calls, as a real ring's
    first = ck.ring_accel_fused_emulated_cuda(shards, SOFT_RING, rings=rings)
    same = 0
    for _ in range(200):
        same += all(torch.equal(a, b) for a, b in zip(
            ck.ring_accel_fused_emulated_cuda(shards, SOFT_RING, rings=rings), first))
    print(f"[3rf ring kernel] 200 emulated D=4 M={N_QA} calls back to back: {same} bit-equal "
          "to the first")
    check(same == 200, "repeated emulated ring calls differ")
    whole = pos  # N_MAIN bodies: the D=1 ring, the emulated D=4 ring, accel
    ring1 = ck.FusedRing(N_MAIN, 1, 0, device=dev)
    calls = {"accel": lambda: ck.compute_accel_cuda(whole, whole, SOFT_RING),
             "ring D=1": lambda: ck.ring_accel_fused_cuda(whole, SOFT_RING, ring1),
             "ring emulated D=4": lambda: ck.ring_accel_fused_emulated_cuda(shards, SOFT_RING,
                                                                            rings=rings)}
    reps = 10
    ms = {k: [] for k in calls}
    for k in ("accel", "ring D=1", "ring emulated D=4", "ring emulated D=4", "ring D=1",
              "accel"):
        calls[k]()
        torch.cuda.synchronize()
        ms[k].append(elapsed_ms(lambda: [calls[k]() for _ in range(reps)], dev) / reps)
    for ring in (ring1, *rings):
        ring.close()
    t_p = elapsed_ms(lambda: reference.ring_accel_fused_plain([whole], SOFT_RING), dev)
    # 20 flops a pair; each input read once, each output written once (a
    # ring's j-shards are its inputs, moved between ranks, not counted)
    b = bound_ms(20.0 * N_MAIN * N_MAIN, N_MAIN * 16 + N_MAIN * 12)
    for k, v in ms.items():
        print(f"[3rf ring kernel] {k} at N={N_MAIN} in all: "
              f"{', '.join(f'{t:.3f}' for t in v)} ms per call, bound {b[0]:.3f} ms ({b[1]})")
    print(f"[3rf ring kernel] plain D=1 at N={N_MAIN}: {t_p:.3f} ms")
    return {"err": {"ring_fused": err}, "times": {"ring_fused": (min(ms["ring D=1"]), t_p)},
            "bounds": {"ring_fused": b}}


def phase_ring_ipc() -> None:
    """3ri. The fused ring between two processes on this card, through CUDA
    IPC (scripts/torch_ring_ipc.py: two gloo ranks on cuda:0, each mapping
    the other's region with cudaIpcOpenMemHandle as a card mesh does, five
    calls, each bit-equal to the hop-ordered accel launches); its own
    launches are in its processes, not in this count."""
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_ring_ipc.py")],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    for line in proc.stdout.splitlines():
        print(f"[3ri ring ipc] {line}")
    check(proc.returncode == 0, f"the two-process ring failed (exit {proc.returncode}): "
          f"{proc.stderr[-2000:]}")


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
        # the one-sided kernel on the first m rows under all n (at N_QA a
        # four-card hop, under all N and under one shard), in its j-chunks
        # (ds_aj_splits) and in one: the i-set's float64 oracle is the
        # rows of the set's; the same bits at every block and on a repeat
        vel64 = ds.ds_to_f64(*planes[2:])
        m = 1025 if n < N_QA else N_QA // 4
        shapes = [(m, n, planes, ref)]
        if n == N_QA:
            shard = tuple(t[:m].contiguous() for t in planes)
            shapes.append((m, m, shard, _oracle_accel_jerk(pos64[:m], vel64[:m], soft)))
        for m, nj, jplanes, jref in shapes:
            sub = tuple(t[:m].contiguous() for t in jplanes)
            want = ds.ds_accel_jerk_vs(*sub, *jplanes, scal)
            for splits in sorted({ck.ds_aj_splits(m, nj), 1}):
                first = None
                for b in (64, 128, 256):
                    what = f"one-sided ({m},{nj}) splits={splits} block {b}"
                    got = ck._ds_accel_jerk(*sub, *jplanes, scal, b, None, splits=splits)
                    again = ck._ds_accel_jerk(*sub, *jplanes, scal, b, None, splits=splits)
                    first = got if first is None else first
                    held("ds_accel_jerk", got, want, what)
                    oracle("ds_accel_jerk", got, (jref[0][:m], jref[1][:m]), what)
                    check(all(torch.equal(a, c) for a, c in (*zip(got, again),
                                                              *zip(got, first))),
                          f"the ds one-sided accel + jerk differs between calls or blocks "
                          f"at {what}")
            print(f"[3dh ds aj] one-sided ({m},{nj}): repeats and blocks 64, 128, 256 "
                  f"bit-equal at splits {sorted({ck.ds_aj_splits(m, nj), 1})}")
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
    from nbody_tpu_torch.ops import _build

    spills_checked(_build, "ds_aj_kernels.cu", "20ds_accel_jerk_kernel", "[3dh ds aj]")
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


def phase_sharded_main(torch, smi: str) -> dict:
    """5x. The body-sharded path (parallel/) on a one-rank NCCL mesh,
    make_mesh(1): hop 0 of the ring and an all-gather of world size 1, the
    real collectives and kernels. Compute(precision="ds", mesh=,
    strategy="ring") QA for Euler, leapfrog and Hermite at N=16384 and
    strategy="allgather" QA; fp32 allgather and ring QA and
    run_benchmark(10) at N=65536; ds ring Euler run_benchmark at 16384 and
    65536; ten ds ring Euler and leapfrog steps and three Hermite steps.
    Only mesh systems run here, and each run must itself launch the kernels
    of its strategy (a count taken around it). Returns the step times and
    the final ds states, which phase_sharded_single holds against the
    single device."""
    import torch.distributed as dist

    from nbody_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1)
    try:
        check(dist.get_backend() == "nccl", f"the CUDA mesh runs {dist.get_backend()}, not nccl")
        print(f"[5x sharded] one-rank mesh on {mesh.device} over NCCL "
              f"{torch.cuda.nccl.version()}")
        return sharded_path(torch, smi, mesh)
    finally:
        dist.destroy_process_group()


# the kernels that each mesh run of 5x must launch itself: the ds ring's
# force is ds_accel (Euler adds the ds_integrate update), its Hermite the ds
# accel + jerk kernel; the allgather Euler steps are the fused step kernels
# on the gathered j-set, the fp32 ring the one-sided force kernel
SHARDED_KERNELS = {
    ("ds", "ring", "euler"): ("ds_accel", "ds_integrate"),
    ("ds", "ring", "leapfrog"): ("ds_accel",),
    ("ds", "ring", "hermite"): ("ds_accel_jerk", *DS_HERMITE_GLUE),
    ("ds", "allgather", "euler"): ("ds_step",),
    ("fp32", "allgather", "euler"): ("step",),
    ("fp32", "ring", "euler"): ("accel",),
    ("fp32", "ring_fused", "euler"): ("ring_fused",),
    ("fp32", "ring_fused", "leapfrog"): ("ring_fused",),
}


def launched_by(ck, key, fn):
    """fn(), failing unless it launched each kernel of SHARDED_KERNELS[key]."""
    before = dict(ck.LAUNCHES)
    out = fn()
    for k in SHARDED_KERNELS[key]:
        check(ck.LAUNCHES[k] > before[k], f"the sharded {'/'.join(key)} run did not launch "
              f"{k!r}")
    return out


def sharded_path(torch, smi: str, mesh) -> dict:
    from nbody_tpu_torch import DEMO_PARAMS, tuned_scales
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.models import BodySystem, DSBodySystem
    from nbody_tpu_torch.ops import cuda_kernel as ck

    for kw in ({"integrator": "euler", "strategy": "ring"},
               {"integrator": "leapfrog", "strategy": "ring"},
               {"integrator": "hermite", "strategy": "ring"},
               {"integrator": "euler", "strategy": "allgather"}):
        c = Compute(num_bodies=N_QA, device="cuda", precision="ds", mesh=mesh,
                    log=lambda s: print(f"[5x QA] {s}"), **kw)
        check(c.system.strategy == kw["strategy"] and c.system.variant == "one_sided",
              f"ds mesh system {c.system.strategy}/{c.system.variant}")
        check(launched_by(ck, ("ds", kw["strategy"], kw["integrator"]), c.compare_results),
              f"sharded ds QA failed ({kw})")
    for integrator in ("euler", "leapfrog"):
        c = Compute(num_bodies=N_QA, device="cuda", mesh=mesh, strategy="ring_fused",
                    integrator=integrator, log=lambda s: print(f"[5x QA] {s}"))
        check(c.system.strategy == "ring_fused", f"fp32 mesh system {c.system.strategy}")
        check(launched_by(ck, ("fp32", "ring_fused", integrator), c.compare_results),
              f"sharded fp32 ring_fused QA failed ({integrator})")
    ms = {}
    for tag, n, kw in (("fp32 allgather", N_MAIN, {"strategy": "allgather"}),
                       ("fp32 ring", N_MAIN, {"strategy": "ring"}),
                       ("fp32 ring_fused", N_MAIN, {"strategy": "ring_fused"}),
                       ("ds ring", N_QA, {"precision": "ds", "strategy": "ring"}),
                       ("ds ring", N_MAIN, {"precision": "ds", "strategy": "ring"})):
        c = Compute(num_bodies=n, device="cuda", mesh=mesh,
                    log=lambda s: print(f"[5x main] {s}"), **kw)
        key = (kw.get("precision", "fp32"), kw["strategy"], "euler")
        if key[0] == "fp32":
            check(launched_by(ck, key, c.compare_results),
                  f"sharded fp32 QA failed ({tag}) at N={n}")
        res = launched_by(ck, key, lambda: c.run_benchmark(10 if n == N_QA or key[0] == "fp32"
                                                           else 3))
        pos, vel = c.system.state
        check(tuple(pos.shape) == (n, 4) and bool(torch.isfinite(pos).all()
                                                  and torch.isfinite(vel).all()),
              f"bad state after the {tag} benchmark at N={n}")
        ms[(tag, n)] = res["milliseconds"] / res["iterations"]
        print(f"[5x main] {tag} N={n}: {ms[(tag, n)]:.3f} ms per step [{smi}]")
    # ten ring_fused Euler steps against ten ring steps from the same state:
    # the fused force is the ring's accel launches' sum, so the bits agree
    main_params = DEMO_PARAMS[0]  # no tuned scales at N_MAIN: demo 0's own
    runs = {}
    for strategy in ("ring_fused", "ring"):
        sys_ = BodySystem(N_MAIN, main_params, device="cuda", mesh=mesh, strategy=strategy)
        launched_by(ck, ("fp32", strategy, "euler"), lambda: sys_.update_many(10))
        runs[strategy] = sys_.state
    bits = all(torch.equal(a, b) for a, b in zip(runs["ring_fused"], runs["ring"]))
    print(f"[5x bits] 10 fp32 ring_fused Euler steps at N={N_MAIN} on the mesh against 10 "
          f"ring steps: bit-equal {bits}")
    check(bits, "ten ring_fused Euler steps differ from ten ring steps")
    params = DEMO_PARAMS[0].replace(**dict(zip(("cluster_scale", "velocity_scale"),
                                               tuned_scales(N_QA))))
    states = {}
    for integrator, steps in SHARDED_BIT_STEPS:
        a = DSBodySystem(N_QA, params, device="cuda", integrator=integrator, mesh=mesh,
                         strategy="ring")
        launched_by(ck, ("ds", "ring", integrator), lambda: a.update_many(steps))
        a.synchronize()
        states[integrator] = a.get_ds_state()
    return {"ms": ms, "params": params, "states": states}


# the ds ring runs of 5x held to the single device: (integrator, steps)
SHARDED_BIT_STEPS = (("euler", 10), ("leapfrog", 10), ("hermite", 3))


def phase_sharded_single(torch, smi: str, mesh_runs: dict) -> None:
    """5x, the single-device side, after the mesh runs and outside their
    count: the one-device fp32 vpu and ds one-sided step times beside the
    mesh's, and the same ds steps from the same state on one device, which
    the mesh's ring must equal bit for bit in Euler and within 5e-9 in
    leapfrog and Hermite."""
    import numpy as np

    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.models import DSBodySystem
    from nbody_tpu_torch.ops import ds

    ms = mesh_runs["ms"]
    for tag, n, kw in (("fp32 vpu, one device", N_MAIN, {"variant": "vpu"}),
                       ("ds one_sided, one device", N_QA,
                        {"precision": "ds", "variant": "one_sided"}),
                       ("ds one_sided, one device", N_MAIN,
                        {"precision": "ds", "variant": "one_sided"})):
        c = Compute(num_bodies=n, device="cuda", log=lambda s: print(f"[5x single] {s}"), **kw)
        res = c.run_benchmark(10 if n == N_QA or "precision" not in kw else 3)
        t = res["milliseconds"] / res["iterations"]
        others = ", ".join(f"{k[0]} {v:.3f} ms" for k, v in ms.items() if k[1] == n
                           and k[0].split()[0] == tag.split()[0])
        print(f"[5x single] {tag} N={n}: {t:.3f} ms per step; on the mesh {others} "
              f"[{smi}]")
    for integrator, steps in SHARDED_BIT_STEPS:
        b = DSBodySystem(N_QA, mesh_runs["params"], device="cuda", integrator=integrator,
                         variant="one_sided")
        b.update_many(steps)
        b.synchronize()
        got, want = mesh_runs["states"][integrator], b.get_ds_state()
        bits = all(bool((x == y).all()) for x, y in zip(got, want))
        e = max(float(np.abs(ds.ds_to_f64(got[i], got[i + 1])
                             - ds.ds_to_f64(want[i], want[i + 1])).max()) for i in (0, 2))
        print(f"[5x bits] {steps} ds ring {integrator} steps at N={N_QA} on the mesh against "
              f"single-device one_sided: bit-equal {bits}, max|d| {e:.3e} (bound 5e-9)")
        check(e < 5e-9, f"sharded ds ring {integrator} departs from the single device")
        if integrator == "euler":
            check(bits, "ten ds ring Euler steps differ from ten one-sided steps")


# the kernels each run of 5y must launch itself, by what the run is
MESH_MORE_KERNELS = {
    ("sym", "euler"): ("sym",),
    ("sym", "leapfrog"): ("sym",),
    ("sym", "hermite"): ("aj_sym",),
    ("sym", "euler", "blocked"): ("sym", "sym_cross"),
    ("sym", "hermite", "blocked"): ("aj_sym", "aj_sym_cross"),
    ("2d", "euler"): ("accel",),
    ("2d", "hermite"): ("accel_jerk",),
    ("2d ds", "euler"): ("ds_accel", "ds_integrate"),
    ("2d ds", "hermite"): ("ds_accel_jerk", *DS_HERMITE_GLUE),
    ("2d fp64", "euler"): ("accel_f64",),
    ("fp64 allgather", "euler"): ("step_f64",),
    ("fp64 ring", "euler"): ("accel_f64",),
    ("fp64 allgather", "hermite"): ("accel_jerk_f64",),
}
N_SYM_CARDS = 1 << 20  # BASELINE.json configs[3]'s N, rounded to 2^20


def ran(ck, key, fn, counts: dict | None = None):
    """fn(), failing unless it launched each kernel of MESH_MORE_KERNELS[key];
    with `counts`, the launches it made are kept there under `key`."""
    before = dict(ck.LAUNCHES)
    out = fn()
    made = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES if ck.LAUNCHES[k] > before[k]}
    for k in MESH_MORE_KERNELS[key]:
        check(k in made, f"the mesh run {'/'.join(key)} did not launch {k!r}")
    if counts is not None:
        counts[key] = made
    return out


def phase_sharded_more_main(torch, smi: str) -> dict:
    """5y. What parallel/ runs beyond 5x, on one card: strategy="sym" on a
    one-rank NCCL mesh (make_mesh(1); at D = 1 each pair once is the
    triangle alone) with QA for Euler, leapfrog and Hermite at N=16384,
    run_benchmark(10) at 65536 and steps above the composition caps
    (135168 for the force, 69632 for accel + jerk); a 1x1 make_mesh_2d
    (the 2-D step's gathers over one-rank line groups and its
    reduce-scatter of one) with QA for fp32 Euler and Hermite, ds Euler and
    Hermite, float64 Euler, and run_benchmark(10) at 65536; float64 on the
    1-D mesh, allgather and ring Euler and allgather Hermite QA (the 5e-4
    rule and the force at 1e-10 of max|a|). Each run must launch its own
    kernels. Returns the states and step times that phase_sharded_more
    holds to the single device, and the launches a step."""
    import torch.distributed as dist

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.models import BodySystem
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.parallel import make_mesh, make_mesh_2d

    out = {"ms": {}, "per_step": {}}

    def per_step(system, key, steps=2):
        ran(ck, key, lambda: system.update_many(steps), out["per_step"])
        out["per_step"][key] = {k: v / steps for k, v in out["per_step"][key].items()}

    mesh = make_mesh(1)
    try:
        for integrator in ("euler", "leapfrog", "hermite"):
            c = Compute(num_bodies=N_QA, device="cuda", mesh=mesh, strategy="sym",
                        integrator=integrator, log=lambda s: print(f"[5y QA] {s}"))
            check(c.system.strategy == "sym", f"sym mesh system runs {c.system.strategy}")
            check(ran(ck, ("sym", integrator), c.compare_results),
                  f"sym on the mesh failed its QA ({integrator})")
        c = Compute(num_bodies=N_MAIN, device="cuda", mesh=mesh, strategy="sym",
                    log=lambda s: print(f"[5y main] {s}"))
        res = ran(ck, ("sym", "euler"), lambda: c.run_benchmark(10))
        out["ms"]["sym"] = res["milliseconds"] / res["iterations"]
        for key, n, steps in ((("sym", "euler"), N_MAIN, 10),
                              (("sym", "euler", "blocked"), N_BIG, 3),
                              (("sym", "hermite", "blocked"), N_DS_AJ_BIG * 2, 2)):
            s = BodySystem(n, DEMO_PARAMS[0], device="cuda", mesh=mesh, strategy="sym",
                           integrator=key[1])
            per_step(s, key, steps)
            fields = (s.accelerations_and_jerks() if key[1] == "hermite"
                      else (s.accelerations(),))
            out[("sym", n)] = (s.state, s.params.softening, fields)
        for strategy, integrator in (("allgather", "euler"), ("ring", "euler"),
                                     ("allgather", "hermite")):
            c = Compute(num_bodies=N_QA, device="cuda", precision="fp64", mesh=mesh,
                        strategy=strategy, integrator=integrator,
                        log=lambda s: print(f"[5y QA] {s}"))
            check(c.system.dtype == torch.float64 and c.system.strategy == strategy,
                  f"float64 mesh system {c.system.dtype} {c.system.strategy}")
            check(ran(ck, (f"fp64 {strategy}", integrator), c.compare_results),
                  f"float64 {strategy} on the mesh failed its QA ({integrator})")
            per_step(c.system, (f"fp64 {strategy}", integrator))
        grid = make_mesh_2d(1, 1)
        check(grid.size == 1 and grid.axis_names == ("rows", "cols"), "the 1x1 grid")
        for kw, key in (({}, ("2d", "euler")), ({"integrator": "hermite"}, ("2d", "hermite")),
                        ({"precision": "ds"}, ("2d ds", "euler")),
                        ({"precision": "ds", "integrator": "hermite"}, ("2d ds", "hermite")),
                        ({"precision": "fp64"}, ("2d fp64", "euler"))):
            c = Compute(num_bodies=N_QA, device="cuda", mesh=grid,
                        log=lambda s: print(f"[5y QA] {s}"), **kw)
            check(c.system.strategy == "2d", f"grid system runs {c.system.strategy}")
            check(ran(ck, key, c.compare_results), f"the 1x1 grid failed its QA ({kw})")
            per_step(c.system, key)
        c = Compute(num_bodies=N_MAIN, device="cuda", mesh=grid,
                    log=lambda s: print(f"[5y main] {s}"))
        res = ran(ck, ("2d", "euler"), lambda: c.run_benchmark(10))
        out["ms"]["2d"] = res["milliseconds"] / res["iterations"]
        for name, ms in out["ms"].items():
            print(f"[5y main] {name} Euler on the one-rank mesh at N={N_MAIN}: {ms:.3f} ms "
                  f"per step [{smi}]")
        for key, made in out["per_step"].items():
            print(f"[5y launches] {'/'.join(key)}: {made} a step")
    finally:
        dist.destroy_process_group()
    return out


def phase_sharded_more(torch, smi: str, runs: dict) -> None:
    """5y, after the path and outside its count: the one-rank sym mesh's
    force (and accel + jerk) against the single-device each-pair-once
    composition, bit for bit; emulated_sym (all D ranks' work in one
    process, summed in the reduce-scatter's order) at D = 2, 3, 4, 8 and
    N = 16384, 65536, accel + jerk at D = 2, 4 and N = 16384, and the force
    at D = 4, N = 2^20 (shards of 262144, above both caps: the sub-blocked
    rectangles), each held to the force gate (max|d| <= 1e-4 max + 1e-4)
    against the plain force (at 2^20 against the one-sided force kernel)
    and bit-equal on a repeat; emulated_accel_2d of 2x2 and 2x4 grids at
    16384 and 65536 against the plain force, and beside them the
    single-device sym step time."""
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import reference
    from nbody_tpu_torch.parallel import emulated_accel_2d, emulated_sym

    for n in (N_MAIN, N_BIG, N_DS_AJ_BIG * 2):
        (pos, vel), soft, fields = runs[("sym", n)]
        want = (ck.compute_accel_jerk_symmetric_blocked_cuda(pos, vel, soft)
                if len(fields) == 2 else (ck.compute_accel_symmetric_blocked_cuda(pos, soft),))
        bits = all(torch.equal(a, b) for a, b in zip(fields, want))
        print(f"[5y bits] sym on the one-rank mesh at N={n}: its "
              f"{'accel + jerk' if len(fields) == 2 else 'force'} bit-equal to the single-device "
              f"composition {bits}")
        check(bits, f"sym at D = 1 departs from the single-device composition at N={n}")

    def gate(got, want, what):
        err = float((got - want).abs().max())
        bound = 1e-4 * float(want.abs().max()) + 1e-4
        print(f"[5y emulated] {what}: max|d| {err:.3e} (bound {bound:.3e})")
        check(err <= bound, f"{what} departs from its reference")
        return err

    def timed_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for n in (N_QA, N_MAIN):
        pos, vel = shell_state(torch, n, random_w=True)
        plain = reference.compute_accel(pos, SOFT_RING)
        for d in (2, 3, 4, 8):
            if n % d:
                pos_d = pos[:n - n % d].contiguous()
                plain_d = reference.compute_accel(pos_d, SOFT_RING)
            else:
                pos_d, plain_d = pos, plain
            (got, ms), (again, _) = (timed_call(lambda: emulated_sym(pos_d, d, SOFT_RING))
                                     for _ in range(2))
            gate(got, plain_d, f"emulated_sym D={d} N={pos_d.shape[0]} force, {ms:.3f} ms")
            check(torch.equal(got, again), f"emulated_sym D={d} N={n} does not repeat")
        for rows, cols in ((2, 2), (2, 4)):
            got = emulated_accel_2d(pos, rows, cols, SOFT_RING)
            gate(got, plain, f"emulated_accel_2d {rows}x{cols} N={n} force")
            check(torch.equal(got, emulated_accel_2d(pos, rows, cols, SOFT_RING)),
                  f"emulated_accel_2d {rows}x{cols} does not repeat")
    pos, vel = shell_state(torch, N_QA, random_w=True)
    plain = reference.compute_accel_jerk(pos, vel, SOFT_RING)
    for d in (2, 4):
        got = emulated_sym(pos, d, SOFT_RING, vel=vel)
        for g, w, name in zip(got, plain, ("acc", "jerk")):
            gate(g, w, f"emulated_sym D={d} N={N_QA} {name}")
        check(all(torch.equal(a, b) for a, b in zip(got, emulated_sym(pos, d, SOFT_RING,
                                                                       vel=vel))),
              f"emulated_sym accel + jerk D={d} does not repeat")
    pos, _ = shell_state(torch, N_SYM_CARDS, random_w=True)
    before = dict(ck.LAUNCHES)
    got, ms = timed_call(lambda: emulated_sym(pos, 4, SOFT_RING))
    made = {k: ck.LAUNCHES[k] - before[k] for k in ("sym", "sym_cross")}
    again, ms2 = timed_call(lambda: emulated_sym(pos, 4, SOFT_RING))
    one_sided, ms_one = timed_call(lambda: ck.compute_accel_cuda(pos, pos, SOFT_RING))
    gate(got, one_sided, f"emulated_sym D=4 N={N_SYM_CARDS} force ({made} launches, "
         f"{made['sym'] // 4} triangles and {made['sym_cross'] // 4} rectangles a rank), "
         f"{ms:.1f} / {ms2:.1f} ms against the one-sided force's {ms_one:.1f} ms [{smi}]")
    check(made["sym_cross"] >= 4 * 5, "the ranks' rectangles were not sub-blocked at 2^20")
    check(torch.equal(got, again), "emulated_sym at 2^20 does not repeat")
    c = Compute(num_bodies=N_MAIN, device="cuda", variant="sym", log=lambda s: None)
    res = c.run_benchmark(10)
    print(f"[5y single] sym Euler on one device at N={N_MAIN}: "
          f"{res['milliseconds'] / res['iterations']:.3f} ms per step; on the one-rank mesh "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in runs["ms"].items()) + f" [{smi}]")


def auto_capacity(occ: int) -> int:
    """BodySystem's auto-sized cell capacity for a largest massive cell
    occupancy: occ + 50 %, rounded up to a multiple of 8."""
    return max(8, -(-int(occ * 1.5 + 1) // 8) * 8)


def p3m_capacity(pos) -> int:
    """BodySystem's auto-sized cell capacity of a state at G=64."""
    from nbody_tpu_torch.ops import p3m

    return auto_capacity(int(p3m.p3m_max_occupancy(pos, grid=P3M_GRID)))


def p3m_bound_ms(work: dict, n: int, per_near=P3M_TEST_INSTR + P3M_TERM_INSTR,
                 per_candidate=0):
    """The short-range function's bound for this run's data (p3m.pair_work):
    `per_near` FP32 instructions a pair within rcut (and `per_candidate` a
    candidate pair), at 2 flops an instruction, against the O(N) bytes of
    the function (the state in, the (N, 3) force out)."""
    flops = 2.0 * (per_candidate * work["candidates"] + per_near * work["near"])
    return bound_ms(flops, n * 16 + n * 12)


def p3m_work_line(work: dict, n: int, kernel_ms: float) -> str:
    """The pair kernel's work on these tables, its pruning and its time
    beside the bound and the two other figures (see P3M_TEST_INSTR)."""
    bound = p3m_bound_ms(work, n)
    cand = p3m_bound_ms(work, n, P3M_TERM_INSTR, P3M_TEST_INSTR)
    unfused = p3m_bound_ms(work, n, P3M_UNFUSED_INSTR)
    return (f"{work['clusters']} i-clusters, {work['items']} items (chunks of up to "
            f"{work['chunk']} j-clusters); {work['cluster_pairs']:.4e} cluster pairs, "
            f"{work['boxed']:.4e} past the box test ({work['visited']:.4e} row pairs loaded), "
            f"{work['tested']:.4e} row pairs tested, {work['termed']:.4e} termed; "
            f"{work['candidates']:.4e} candidate and {work['near']:.4e} near pairs: tested / "
            f"near {work['tested'] / max(1, work['near']):.3f}, termed / near (the pruning's "
            f"efficiency) {work['termed'] / max(1, work['near']):.3f}; kernel {kernel_ms:.3f} "
            f"ms against its bound {bound[0]:.3f} ms ({bound[1]}, {P3M_TEST_INSTR} + "
            f"{P3M_TERM_INSTR} instructions a near pair; {bound[0] / kernel_ms:.1%}); "
            f"candidate-based figure {cand[0]:.3f} ms, at the kernel's unfused rounding "
            f"{unfused[0]:.3f} ms")


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
    print(f"[3p p3m kernel] shell N={N_MAIN}, G={P3M_GRID}, capacity {cap}, blk {tables.blk}: "
          f"{p3m_work_line(work, N_MAIN, t_k)}; plain {t_p:.3f} ms per call")
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
    # rows, kept bodies of the cell whose i-clusters meet the most
    # j-clusters, and dropped bodies
    pos, system = systems["worst"]
    soft, cap = system.params.softening, system.p3m_capacity
    tables = p3m.pair_tables(pos, soft, grid=P3M_GRID, capacity=cap,
                             blk=p3m.p3m_kernel_blk(cap))
    nid, nvalid = p3m._neighbor_stencil(tables.gc, pos.device)
    jclusters = torch.where(nvalid, tables.ncl.long()[nid], 0).sum(dim=1)
    jclusters = torch.where(tables.ncl > 0, jclusters, 0)
    busiest = int(jclusters.argmax())
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
            f"{int(jclusters[busiest])} j-clusters an i-cluster's there, in chunks of up to "
            f"{int(tables.chunk)}")
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
                                      deconvolve="optimal", window_exp=2,
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
    print(f"[5p split] pair kernel at N={N_P3M_BIG}: "
          f"{p3m_work_line(work, N_P3M_BIG, times['pair kernel'])} [{smi}]")
    return err


P3M_RANGE_SPLITS = (2, 4, 8)  # the ranges a state's pair work is cut into (3q)
# nbody_tpu's accuracy envelopes against the all-pairs force: plain PM's
# median relative error at G=64 (tests/test_pm.py:36), P3M's median and 90th
# percentile (tests/test_p3m.py:36-37)
PM_MEDIAN_BOUND = 0.06
P3M_MEDIAN_BOUND, P3M_P90_BOUND = 0.008, 0.02
N_DEMO_MESH_FRAMES = 5  # frames of each demo on the one-rank mesh (5q)


def range_rows_equal(torch, ck, tables, d: int) -> tuple:
    """The pair kernel over the d ranges of the tables' work
    (p3m.item_range): (every range's rows bit-equal to the whole launch's
    and zero elsewhere, the ranges' times in ms by CUDA events, the whole
    launch's time)."""
    from nbody_tpu_torch.ops import p3m

    whole = ck.p3m_sr_launch(tables)
    rows = torch.arange(whole.shape[0], device=whole.device) // p3m.CLUSTER
    ok = True
    times = []
    for r in range(d):
        rng = p3m.item_range(tables, r, d)
        ck.p3m_sr_launch(tables, rng=rng)  # warm
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = ck.p3m_sr_launch(tables, rng=rng)
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
        c0, c1 = rng[2:].tolist()
        mine = ((rows >= c0) & (rows < c1))[:, None]
        ok &= torch.equal(torch.where(mine, whole, 0.0), got) and bool(
            (got[~mine.expand_as(got)] == 0).all())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    ck.p3m_sr_launch(tables)
    ev[1].record()
    torch.cuda.synchronize()
    return ok, times, ev[0].elapsed_time(ev[1])


def phase_p3m_ranges(torch) -> dict:
    """3q. The pair kernel over a rank's range of its work (the sharded P3M
    step's launch, nbody_p3m_sr_range_f32): on the contract-keeping shell
    states at N=65536 and 2^20, G=64, the work cut into D = 2, 4, 8 ranges
    (p3m.item_range), each range's rows bit-equal to the whole launch's and
    zero elsewhere; each range's time against the whole launch's / D; at
    65536 the D = 2 ranges through the wrapper (p3m.short_range_part) against
    their plain version (the plain short range of the range's rows) at rtol
    1e-4 / atol 2e-4, and the one-range launch of a one-rank mesh timed
    beside its plain version."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import p3m
    from nbody_tpu_torch.utils.timing import elapsed_ms

    soft = DEMO_PARAMS[0].softening
    err, result = 0.0, {}
    for n in (N_MAIN, N_P3M_BIG):
        pos, _ = shell_state(torch, n)
        cap = p3m_capacity(pos)
        tables = p3m.pair_tables(pos, soft, grid=P3M_GRID, capacity=cap,
                                 blk=p3m.p3m_kernel_blk(cap))
        check(int(tables.overflow) == 0, f"the shell state at N={n} breaks its contract")
        for d in P3M_RANGE_SPLITS:
            ok, times, whole = range_rows_equal(torch, ck, tables, d)
            print(f"[3q p3m ranges] N={n}, G={P3M_GRID}, capacity {cap}, D={d}: the ranges' "
                  f"rows bit-equal to the whole launch's: {ok}; range times "
                  + ", ".join(f"{t:.3f}" for t in times)
                  + f" ms, largest {max(times):.3f} ms against the whole launch's / D "
                  f"{whole / d:.3f} ms ({whole:.3f} ms)")
            check(ok, f"the pair kernel's {d} ranges differ from the whole launch (N={n})")
        if n != N_MAIN:
            continue
        for r in range(2):
            got, ovf = p3m.short_range_part(pos, soft, grid=P3M_GRID, capacity=cap, rank=r,
                                            ndev=2, tables=tables)
            plain, _ = p3m.short_range_part(pos, soft, grid=P3M_GRID, capacity=cap, rank=r,
                                            ndev=2, backend="torch", tables=tables)
            err = max(err, p3m_check(torch, got, plain, f"range {r} of 2, N={n}"))
            check(int(ovf) == 0, "overflow on a contract-keeping state")
        reps = 10
        one = p3m.item_range(tables, 0, 1)

        def kernel():
            for _ in range(reps):
                ck.p3m_sr_range_cuda(tables, one)

        def plain():
            p3m.short_range_part(pos, soft, grid=P3M_GRID, capacity=cap, rank=0, ndev=1,
                                 backend="torch", tables=tables)

        kernel()
        t_k = elapsed_ms(kernel, pos.device) / reps
        t_p = elapsed_ms(plain, pos.device)
        work = p3m.pair_work(tables)
        result = {"err": {"p3m_sr_range": err}, "times": {"p3m_sr_range": (t_k, t_p)},
                  "bounds": {"p3m_sr_range": p3m_bound_ms(work, n)}}
        print(f"[3q p3m ranges] the one-range launch of a one-rank mesh at N={n}: "
              f"{t_k:.3f} ms, plain {t_p:.3f} ms, bound {result['bounds']['p3m_sr_range'][0]:.3f} "
              f"ms ({result['bounds']['p3m_sr_range'][1]})")
    return result


def solver_envelope(torch, pos, acc, soft, what: str, smi: str) -> tuple:
    """The median and 90th-percentile relative error of `acc` against the
    exact force (the one-sided force kernel) on 512 sampled rows."""
    import numpy as np

    from nbody_tpu_torch.ops import cuda_kernel as ck

    rows = torch.tensor(np.random.default_rng(0).choice(pos.shape[0], 512, replace=False),
                        device=pos.device)
    ref = ck.compute_accel_cuda(pos[rows].contiguous(), pos, soft)
    rel = ((acc[rows] - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-12)).cpu().numpy()
    med, p90 = float(np.median(rel)), float(np.percentile(rel, 90))
    print(f"[5q envelope] {what}: against the all-pairs force on 512 rows, relative error "
          f"median {med:.3e}, 90th percentile {p90:.3e} [{smi}]")
    return med, p90


def mesh_solver_forces(torch, smi: str) -> None:
    """5q, first part: plain PM (CIC and TSC) and TSC P3M at N=65536 and
    2^20, G=64, on the shell state through BodySystem.accelerations(),
    against their plain versions on the CPU (the same state: plain PM
    whole, at 1e-4 * max|a|; P3M's long range whole at 1e-4 * max|a| and its
    short range on 256 sampled rows at rtol 1e-4 / atol 2e-4) and within
    nbody_tpu's envelopes against the all-pairs force."""
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.models import BodySystem
    from nbody_tpu_torch.ops import p3m, pm, reference

    soft = DEMO_PARAMS[0].softening
    for n in (N_MAIN, N_P3M_BIG):
        pos, vel = shell_state(torch, n)
        cpu = pos.cpu()
        for kernel, assignment in (("pm", "cic"), ("pm", "tsc"), ("p3m", "tsc")):
            s = BodySystem(n, DEMO_PARAMS[0], device="cuda", kernel=kernel,
                           pm_assignment=assignment, state=(pos, vel))
            acc = s.accelerations()
            what = f"{kernel} {assignment}, N={n}, G={P3M_GRID}"
            if kernel == "pm":
                plain = pm.pm_accel(cpu, grid=P3M_GRID, assignment=assignment)
                e = (acc.cpu() - plain).abs().max().item()
                scale = plain.abs().max().item()
                print(f"[5q plain] {what}: card against the plain version on the CPU, "
                      f"max|da| {e:.3e} (max|a| {scale:.3e})")
                check(e <= 1e-4 * scale, f"plain PM on the card differs from the CPU ({what})")
                med, _ = solver_envelope(torch, pos, acc, soft, what, smi)
                check(med < PM_MEDIAN_BOUND, f"PM outside nbody_tpu's envelope ({what})")
                continue
            cap = s.p3m_capacity
            lr = p3m.p3m_long_range(cpu, grid=P3M_GRID, assignment=assignment)
            lr_card = p3m.p3m_long_range(pos, grid=P3M_GRID, assignment=assignment)
            e = (lr_card.cpu() - lr).abs().max().item()
            print(f"[5q plain] {what}: long range on the card against the CPU, max|da| {e:.3e} "
                  f"(max|a| {lr.abs().max().item():.3e})")
            check(e <= 1e-4 * lr.abs().max().item(), f"P3M long range differs ({what})")
            rows = torch.tensor(np.random.default_rng(1).choice(n, 256, replace=False))
            sr = (acc - lr_card).cpu()[rows]
            plain = reference.p3m_short_range(cpu, soft, grid=P3M_GRID, capacity=cap, rows=rows)
            p3m_check(torch, sr, plain, f"{what}, short range on 256 rows against the CPU")
            med, p90 = solver_envelope(torch, pos, acc, soft, what, smi)
            check(med < P3M_MEDIAN_BOUND and p90 < P3M_P90_BOUND,
                  f"P3M outside nbody_tpu's envelope ({what})")
        del pos, vel, cpu


def mesh_solver_bits(torch, mesh, ck) -> None:
    """5q: the sharded PM and P3M steps on the one-rank NCCL mesh
    (replicated and slab, CIC and TSC, Euler and leapfrog) equal the
    single-card steps bit for bit, 3 steps at N=65536; every mesh P3M run
    launches the ranged pair kernel."""
    import warnings

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.models import BodySystem

    for kernel in ("pm", "p3m"):
        for assignment in ("cic", "tsc"):
            for integrator in ("euler", "leapfrog"):
                kw = {"kernel": kernel, "pm_assignment": assignment, "integrator": integrator}
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # demo 0 may outgrow the capacity
                    one = BodySystem(N_MAIN, DEMO_PARAMS[0], device="cuda", **kw)
                    one.update_many(3)
                    for fft in ("replicated", "slab"):
                        before = ck.LAUNCHES["p3m_sr_range"]
                        s = BodySystem(N_MAIN, DEMO_PARAMS[0], device="cuda", mesh=mesh,
                                       pm_fft=fft, p3m_capacity=one.p3m_capacity, **kw)
                        s.update_many(3)
                        bits = all(torch.equal(a, b) for a, b in zip(s.state, one.state))
                        print(f"[5q mesh] {kernel} {assignment} {integrator} {fft}, N={N_MAIN}, "
                              f"3 steps on the one-rank mesh bit-equal to the single card: "
                              f"{bits}")
                        check(bits, f"the one-rank mesh {kernel}/{fft}/{assignment}/"
                              f"{integrator} steps differ from the single card's")
                        if kernel == "p3m":
                            check(ck.LAUNCHES["p3m_sr_range"] > before,
                                  "the mesh P3M step did not launch the ranged pair kernel")


def auto_refresh_run(torch, smi: str) -> None:
    """5q: README's demo-0 P3M run at N=2^20 (run_benchmark(3)) with the
    auto-refresh: no contract warning, each rewind printed, and the last
    state within the last capacity."""
    import warnings

    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.ops import p3m

    c = Compute(num_bodies=N_P3M_BIG, device="cuda", kernel="p3m", p3m_auto_refresh=True,
                log=lambda s: print(f"[5q refresh] {s}"))
    cap0 = c.system.p3m_capacity
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = c.run_benchmark(3)
    msgs = [str(m.message) for m in caught if "contract broken" in str(m.message)]
    s = c.system
    over = int(p3m.p3m_overflow_count(s.state[0], grid=P3M_GRID, capacity=s.p3m_capacity))
    print(f"[5q refresh] P3M Euler N={N_P3M_BIG} with --p3m-auto-refresh: capacity {cap0} -> "
          f"{s.p3m_capacity}, rewinds (step of the call, capacity before, after) "
          f"{s.p3m_refreshes}; {res['milliseconds'] / res['iterations']:.3f} ms per step "
          f"(rewinds and re-sizing included); warnings {msgs}; overflow of the last state {over} "
          f"[{smi}]")
    check(not msgs and over == 0, "the auto-refreshed P3M run dropped massive bodies")


def demo_on_mesh(torch, mesh, smi: str, tmp: pathlib.Path) -> None:
    """5q: the demo loop on the one-rank mesh under ring_fused and sym,
    --render, N_DEMO_MESH_FRAMES frames from the first: the PNGs written and
    the last equal to rendering the gathered last state."""
    from nbody_tpu_torch import cli
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.render import Camera, FrameRenderer

    for strategy in ("ring_fused", "sym"):
        outdir = tmp / f"mesh_{strategy}"
        args = cli.build_parser().parse_args(
            ["--numbodies", str(N_MAIN), "--frames", str(N_DEMO_MESH_FRAMES), "--render",
             "--no-hud", "--no-cycle", "--outdir", str(outdir), "--strategy", strategy])
        c = Compute(num_bodies=N_MAIN, device="cuda", mesh=mesh, strategy=strategy,
                    log=lambda s: None)
        t0 = time.perf_counter()
        cli._run_demo(c, args, mesh)
        secs = time.perf_counter() - t0
        pngs = sorted(outdir.glob("frame_*.png"))
        check(len(pngs) == N_DEMO_MESH_FRAMES, f"the {strategy} demo wrote {len(pngs)} frames")
        renderer = FrameRenderer(width=args.width, height=args.height, splat=16)
        renderer.write_png(renderer.render(c.system.state[0],
                                           Camera(origin=c.active_params.camera_origin)),
                           tmp / "want.png")
        # the PNG encoding is deterministic: equal bytes, equal frames
        same = (tmp / "want.png").read_bytes() == pngs[-1].read_bytes()
        print(f"[5q demo] {strategy} on the one-rank mesh, N={N_MAIN}, --render: "
              f"{len(pngs)} frames in {secs:.3f} s (the first frame included), the last equal "
              f"to rendering the gathered state: {same} [{smi}]")
        check(same, f"the {strategy} demo's last frame is not the gathered state's")


def phase_mesh_solvers_main(torch, smi: str) -> None:
    """5q. The mesh solvers and the demo on a mesh (see the docstring)."""
    import tempfile

    import torch.distributed as dist

    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.parallel import make_mesh

    mesh_solver_forces(torch, smi)
    for kw in ({"kernel": "pm"}, {"kernel": "pm", "pm_assignment": "tsc"},
               {"kernel": "p3m", "pm_assignment": "tsc"},
               {"kernel": "p3m", "pm_assignment": "tsc", "integrator": "leapfrog"}):
        qa = Compute(num_bodies=N_QA, device="cuda", log=lambda s: print(f"[5q QA] {s}"), **kw)
        check(qa.compare_results(), f"QA failed ({kw})")
    for kw in ({"kernel": "pm"}, {"kernel": "p3m", "pm_assignment": "tsc",
                                  "p3m_auto_refresh": True}):
        c = Compute(num_bodies=N_P3M_BIG, device="cuda", log=lambda s: None, **kw)
        res = c.run_benchmark(3)
        print(f"[5q main] {kw} N={N_P3M_BIG}, G={P3M_GRID}: "
              f"{res['milliseconds'] / res['iterations']:.3f} ms per step [{smi}]")
    auto_refresh_run(torch, smi)
    mesh = make_mesh(1)
    try:
        check(dist.get_backend() == "nccl", f"the CUDA mesh runs {dist.get_backend()}")
        mesh_solver_bits(torch, mesh, ck)
        with tempfile.TemporaryDirectory() as d:
            demo_on_mesh(torch, mesh, smi, pathlib.Path(d))
    finally:
        dist.destroy_process_group()


def ptxas_registers(usage: dict, key: str) -> int:
    """The registers ptxas gives the one kernel whose mangled name holds `key`."""
    found = [u["registers"] for name, u in usage.items() if key in name]
    check(len(found) == 1, f"ptxas reported {len(found)} kernels matching {key!r}")
    return found[0]


def step_walks_checked(build, usage: dict, text: str, keys=STEP_WALKS,
                       source: str = "nbody_kernels.cu", tag: str = "[3e sass]") -> None:
    """Each instantiation of the kernels `keys` of `source` (by default the
    four step kernels, STEP_WALKS) has a walk, the loop around its rsqrt,
    and no local-memory access (LDL, STL: a spill) inside it; a local
    access elsewhere in the kernel is printed with where it lies: before or
    after the walk, and in a loop around it (the stage loop: once a stage),
    in another loop, or in none (once a launch)."""
    names = build.demangle(usage)
    for key in keys:
        funcs = build.sass_functions(text, key)
        check(bool(funcs), f"no kernel {key} in the SASS of {source}")
        for fname, ins in funcs.items():
            name = names.get(fname, fname)
            walks = build.sass_loops(text, fname)
            check(bool(walks), f"no rsqrt loop in the SASS of {name}")
            inside = sum(w["mix"].get("local", 0) for w in walks)
            lo, hi = min(w["span"][0] for w in walks), max(w["span"][1] for w in walks)
            local = [(a, op) for a, op, _ in ins if build.sass_class(op) == "local"]
            loops = [(int(t.group(1), 16), a) for a, op, args in ins if op.startswith("BRA")
                     and (t := re.search(r"0x([0-9a-f]+)", args)) and int(t.group(1), 16) <= a]

            def at(a, lo=lo, hi=hi, loops=loops):
                side = "before" if a < lo else "after"
                if any(b <= a <= e and b <= lo and hi <= e for b, e in loops):
                    return f"{side} the walk, in a loop around it"
                if any(b <= a <= e for b, e in loops):
                    return f"{side} the walk, in another loop"
                return f"{side} the walk, outside every loop"

            where = ", ".join(f"{op} at {a:#x} ({at(a)})" for a, op in local
                              if not lo <= a <= hi)
            u = usage.get(fname, {})
            print(f"{tag} {name}: walk {lo:#x}-{hi:#x}, "
                  f"{min(w['instructions'] / w['pairs'] for w in walks):.2f} SASS instructions "
                  f"a pair, {inside} local accesses inside; ptxas {u.get('spill_stores')} / "
                  f"{u.get('spill_loads')} bytes spill stores / loads; outside: {where or 'none'}")
            check(inside == 0, f"{name} spills inside its walk")


def phase_experiment_kernels(torch) -> dict:
    """3e. The kernels of the JAX package's three experiment scripts against
    their plain versions on the card, at N in {1000, 4099, 65536}, with
    masses from [0.5, 2], a random vel.w and damping 0.5 at 4099 and 65536:
    the dual-bank step (reference.nbody_step) at blocks 64, 128 and 256 and
    the packed-state step (reference.nbody_step_packed) at 128 and 256, by
    phase 3's bounds, each bit-equal to the step kernel at the same block,
    the packed one also to one step_t step and its planes to its new
    positions; the sym triangle's reaction ablations
    (reference.sym_ablated_accel) at tiles 128, 256 and 1024: the action
    within 1e-4 * max|a| + 1e-4 of the plain action (max|a| of the whole
    force), the full reaction likewise, the tree_small slots within 1e-4
    of each tile pair's sum of |terms| (reference.sym_reaction_slots), the
    full variant's total bit-equal to sym_accel_cuda at the same tile, and
    the none and tree_small actions bit-equal to the full one; every
    repeat call bit-equal. The production kernels' registers (ptxas) must
    be those of the recorded build (PRODUCTION_REGISTERS), and the step
    kernels' walks hold no spill (step_walks_checked). Times at
    N=65536 in turns beside the kernel each one varies."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import reference
    from nbody_tpu_torch.utils.timing import elapsed_ms

    for src, kernels in (("nbody_kernels.cu", ("step_kernel<4, 512>", "step_t_kernel<4, 512>")),
                         ("ring_kernels.cu", ()),
                         ("symmetric_kernels.cu", ("sym_tri_kernel<8>",))):
        if src in WALK_SHARERS:
            usage, text = sass_of_source(src)
            if src == "nbody_kernels.cu":
                step_walks_checked(_build, usage, text)
            step_walks_checked(_build, usage, text, WALK_SHARERS[src], src)
        else:
            usage = _build.ptxas_usage(src)
        for line in _build.ptxas_lines(src, usage=usage):
            print(f"[3e ptxas] {line}")
        for k in kernels:
            regs = ptxas_registers(usage, PRODUCTION_MANGLED[k])
            print(f"[3e ptxas] {k}: {regs} registers (the recorded build: "
                  f"{PRODUCTION_REGISTERS[k]})")
            check(regs == PRODUCTION_REGISTERS[k], f"{k} changed its registers: {regs}")

    dev = torch.device("cuda", 0)
    demo = DEMO_PARAMS[0]
    dt, soft, damp = demo.time_step, demo.softening, demo.damping
    err = {k: 0.0 for k in EXPERIMENT_KERNELS}
    cases = [(1000, False, damp), (4099, True, 0.5), (N_MAIN, True, 0.5)]
    for n, rand_w, dmp in cases:
        p, v = shell_state(torch, n, random_w=rand_w)
        what = f"N={n} damping={dmp}" + (", random masses and vel.w" if rand_w else "")
        rp, rv = reference.nbody_step(p, v, dt, soft, dmp)
        tol_a = 1e-4 * reference.compute_accel(p, soft).abs().max().item() + 1e-4
        tol_v, tol_p = 1e-5 + dt * tol_a, 1e-5 + dt * dt * tol_a
        state = torch.cat([p, v], dim=1)
        planes = p.t().contiguous()
        for bs in (64, 128, 256):
            sp, sv = ck.nbody_step_cuda(p, v, dt, soft, dmp, block_size=bs)
            gp, gv = ck.nbody_step_dual_cuda(p, v, dt, soft, dmp, block_size=bs)
            hp, hv = ck.nbody_step_dual_cuda(p, v, dt, soft, dmp, block_size=bs)
            e_p, e_v = (gp - rp).abs().max().item(), (gv - rv).abs().max().item()
            same = bool(torch.equal(gp, sp) and torch.equal(gv, sv))
            again = bool(torch.equal(gp, hp) and torch.equal(gv, hv))
            print(f"[3e dual] {what} block {bs}: max|dpos|={e_p:.3e} (tol {tol_p:.3e}) "
                  f"max|dvel|={e_v:.3e} (tol {tol_v:.3e}); bit-equal to the step kernel: "
                  f"{same}; repeat bit-equal: {again}")
            check(e_p <= tol_p and e_v <= tol_v, f"dual step disagrees with plain at {what}")
            check(same, f"dual step differs from the step kernel at {what} block {bs}")
            check(again, f"dual step differs between two calls at {what} block {bs}")
            err["step_dual"] = max(err["step_dual"], e_p, e_v)
            if bs == 64:
                continue
            ns, npl = ck.nbody_step_packed_cuda(state, planes, dt, soft, dmp, block_size=bs)
            rs, rpl = ck.nbody_step_packed_cuda(state, planes, dt, soft, dmp, block_size=bs)
            tp, tv = ck.nbody_rollout_cuda(p, v, dt, soft, dmp, steps=1, block_size=bs)
            want_s, want_pl = reference.nbody_step_packed(state, planes, dt, soft, dmp)
            e_p = (ns[:, :4] - want_s[:, :4]).abs().max().item()
            e_v = (ns[:, 4:] - want_s[:, 4:]).abs().max().item()
            same = bool(torch.equal(ns[:, :4], sp) and torch.equal(ns[:, 4:], sv))
            same_t = bool(torch.equal(ns[:, :4], tp) and torch.equal(ns[:, 4:], tv))
            kept = bool(torch.equal(npl, ns[:, :4].t()))
            again = bool(torch.equal(ns, rs) and torch.equal(npl, rpl))
            print(f"[3e packed] {what} block {bs}: max|dpos|={e_p:.3e} max|dvel|={e_v:.3e}; "
                  f"bit-equal to the step kernel: {same}, to step_t: {same_t}; planes are "
                  f"the new positions: {kept}; repeat bit-equal: {again}")
            check(e_p <= tol_p and e_v <= tol_v, f"packed step disagrees with plain at {what}")
            check(same and same_t, f"packed step differs from step / step_t at {what} "
                  f"block {bs}")
            check(kept and again, f"packed planes or repeat wrong at {what} block {bs}")
            err["step_packed"] = max(err["step_packed"], e_p, e_v)
        del p, v, rp, rv, state, planes

        p, _ = shell_state(torch, n, random_w=rand_w)
        act, react = reference.sym_ablated_accel(p, soft, reaction="full", tile=128)
        tol_a = 1e-4 * (act + react.t()).abs().max().item() + 1e-4
        for tile in ((128, 1024) if n == 1000 else (256, 1024) if n == 4099 else (1024,)):
            prod = ck.sym_accel_cuda(p, soft, tile=tile)
            got = {r: ck.sym_ablated_accel_cuda(p, soft, reaction=r, tile=tile)
                   for r in reference.SYM_REACTIONS}
            acc_f, react_f, total = ck.sym_ablated_accel_cuda(p, soft, reaction="full",
                                                              tile=tile, with_total=True)
            again = {r: ck.sym_ablated_accel_cuda(p, soft, reaction=r, tile=tile)
                     for r in reference.SYM_REACTIONS}
            slots, scale = reference.sym_reaction_slots(p, soft, tile=tile)
            for r in reference.SYM_REACTIONS:
                acc, rr = got[r]
                e = (acc - act).abs().max().item()
                line = f"action max|da|={e:.3e} (tol {tol_a:.3e})"
                ok = e <= tol_a
                if r == "full":
                    e_r = (rr - react).abs().max().item()
                    line += f", reaction max|d|={e_r:.3e}"
                    ok = ok and e_r <= tol_a
                    e = max(e, e_r)
                elif r == "tree_small":
                    ratio = ((rr.double() - slots).abs() / (1e-4 * scale + 1e-30)).max().item()
                    line += f", slots max error / (1e-4 sum|terms|) = {ratio:.3e}"
                    ok = ok and ratio <= 1.0
                same = all(torch.equal(a, b) for a, b in zip(got[r], again[r])
                           if a is not None)
                eq_full = bool(torch.equal(acc, acc_f))
                print(f"[3e ablate] {r} {what} tile {tile}: {line}; action bit-equal to "
                      f"full's: {eq_full}; repeat bit-equal: {same}")
                check(ok, f"ablation {r} disagrees with plain at {what} tile {tile}")
                check(same, f"ablation {r} differs between two calls at {what} tile {tile}")
                # one walk, every operation a rounded intrinsic (csrc sym_walk)
                check(eq_full, f"ablation {r}'s action differs from full's at {what}")
                err[f"sym_ablate_{r}"] = max(err[f"sym_ablate_{r}"], e)
            same = bool(torch.equal(total, prod))
            print(f"[3e ablate] full {what} tile {tile}: total bit-equal to sym_accel_cuda: "
                  f"{same}")
            check(same, f"the full ablation's total differs from sym_accel at {what}")

    # times at N=65536 in turns beside the kernel each one varies
    p, v = shell_state(torch, N_MAIN)
    state = torch.cat([p, v], dim=1)
    planes = p.t().contiguous()
    bufs = [(torch.empty_like(p), torch.empty_like(v)) for _ in range(2)]
    reps, k = 20, 10

    def step_roll(step, bs):
        def run():
            a, b = p, v
            for i in range(k):
                a, b = step(a, b, dt, soft, damp, block_size=bs, out=bufs[i % 2])
        return run

    def per_step(fn):
        fn()
        return elapsed_ms(fn, dev) / k

    dual_ms = {}
    for bs in (64, 128, 256):
        ms = {"step": [], "dual": []}
        for name in ("step", "dual", "dual", "step"):
            step = ck.nbody_step_cuda if name == "step" else ck.nbody_step_dual_cuda
            ms[name].append(per_step(step_roll(step, bs)))
        dual_ms[bs] = min(ms["dual"])
        print(f"[3e times] N={N_MAIN} block {bs}, 10-step rolls in turns (step, dual, dual, "
              f"step): step {ms['step'][0]:.4f} / {ms['step'][1]:.4f}, dual "
              f"{ms['dual'][0]:.4f} / {ms['dual'][1]:.4f} ms per step")
    rolls = {"step": step_roll(ck.nbody_step_cuda, 256),
             "step_t": lambda: ck.nbody_rollout_cuda(p, v, dt, soft, damp, steps=k),
             "packed": lambda: ck.nbody_rollout_packed_cuda(state, dt, soft, damp, steps=k)}
    ms = {name: [] for name in rolls}
    for name in ("step", "step_t", "packed", "packed", "step_t", "step"):
        ms[name].append(per_step(rolls[name]))
    print(f"[3e times] N={N_MAIN} block 256, 10-step rolls in turns (step, step_t, packed, "
          f"packed, step_t, step): " + ", ".join(
              f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in ms.items()) + " ms per step")
    packed_ms = min(ms["packed"])
    tile = ck.DEFAULT_SYM_TILE
    runs = {"sym": lambda: ck.sym_accel_cuda(p, soft, tile=tile),
            **{r: (lambda r=r: ck.sym_ablated_accel_cuda(p, soft, reaction=r, tile=tile))
               for r in reference.SYM_REACTIONS}}
    ms = {name: [] for name in runs}
    order = ("sym", "none", "tree_small", "full")
    for name in order + order[::-1]:
        runs[name]()
        ms[name].append(elapsed_ms(lambda name=name: [runs[name]() for _ in range(reps)], dev)
                        / reps)
    print(f"[3e times] N={N_MAIN} tile {tile}, in turns (sym, none, tree_small, full, full, "
          f"tree_small, none, sym): " + ", ".join(
              f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in ms.items()) + " ms per call")

    plain = {"step_dual": lambda: reference.nbody_step(p, v, dt, soft, damp),
             "step_packed": lambda: reference.nbody_step_packed(state, planes, dt, soft, damp),
             **{f"sym_ablate_{r}": (lambda r=r: reference.sym_ablated_accel(
                 p, soft, reaction=r, tile=tile)) for r in reference.SYM_REACTIONS}}
    times = {"step_dual": dual_ms[256], "step_packed": packed_ms,
             **{f"sym_ablate_{r}": min(ms[r]) for r in reference.SYM_REACTIONS}}
    pairs = float(N_MAIN) * N_MAIN
    half = float(N_MAIN) * (N_MAIN - 1) / 2
    tiles = -(-N_MAIN // tile)
    # flops a pair by the reference's counts (20 one side, 28 both sides of
    # a pair); each input read once, each output written once
    bounds = {"step_dual": bound_ms(20.0 * pairs, 4 * N_MAIN * 16),
              "step_packed": bound_ms(20.0 * pairs, N_MAIN * (32 + 16) * 2),
              "sym_ablate_none": bound_ms(20.0 * half, N_MAIN * (16 + 12)),
              "sym_ablate_tree_small": bound_ms(28.0 * half, N_MAIN * (16 + 12)
                                                + tiles * (tiles + 1) // 2 * 12),
              "sym_ablate_full": bound_ms(28.0 * half, N_MAIN * (16 + 12 + 12))}
    out = {}
    for key, fn in plain.items():
        fn()
        t_p = elapsed_ms(fn, dev)
        out[key] = (times[key], t_p)
        print(f"[3e times] {key} at N={N_MAIN}: kernel {times[key]:.4f} ms, plain {t_p:.3f} "
              f"ms, bound {bounds[key][0]:.3f} ms ({bounds[key][1]})")
    return {"err": err, "times": out, "bounds": bounds}

def f64_state(torch, n, *, seed=42):
    """``shell_state(random_w=True)`` in float64: masses from [0.5, 2] and a
    random vel.w, exact in either type."""
    pos, vel = shell_state(torch, n, seed=seed, random_w=True)
    return pos.double(), vel.double()


def oracle_rows_f64(rows, pos64, vel64, soft):
    """The float64 force, jerk and potential of the set's `rows` (indices)
    under the whole set, in the NumPy oracle's arithmetic
    (``oracle/numpy_oracle.py``: 1/r^3 as m / (sqrt(r2) r2), float64
    throughout), the self pair dropped from the potential by its index.
    Sampled rows keep the oracle's O(rows * N) cost inside the phase at
    N = 65537."""
    import numpy as np

    p3, v3, m = pos64[:, :3], vel64[:, :3], pos64[:, 3]
    acc, jerk, pot = [], [], []
    for c in range(0, len(rows), 64):
        i = rows[c:c + 64]
        dx = p3[None, :, :] - p3[i, None, :]
        dv = v3[None, :, :] - v3[i, None, :]
        r2 = np.einsum("cnk,cnk->cn", dx, dx) + soft * soft
        r = np.sqrt(r2)
        s = m[None, :] / (r * r2)
        w = 3.0 * np.einsum("cnk,cnk->cn", dx, dv) / r2
        acc.append(np.einsum("cn,cnk->ck", s, dx))
        jerk.append(np.einsum("cn,cnk->ck", s, dv) - np.einsum("cn,cnk->ck", s * w, dx))
        inv = m[None, :] / r
        inv[np.arange(len(i)), i] = 0.0
        pot.append(m[i] * inv.sum(axis=1))
    return np.concatenate(acc), np.concatenate(jerk), np.concatenate(pot)


def f64_walk_lines(build, pairs: dict, sms: int) -> dict:
    """Each double kernel's registers, spills and walk (the cheapest
    innermost loop around MUFU.RSQ64H, over its MUFU.RSQ64H): SASS a pair,
    FP64 instructions a pair and the issue bound of those at FP64_LANES an
    SM and the nominal clock for `pairs[key]` pairs; fails on a spill or a
    local access inside a walk (one more nvcc). Returns {key: FP64
    instructions a pair} of the 2-row (<= 512 threads) instantiation."""
    usage, text = sass_of_source("f64_kernels.cu")
    names = build.demangle(usage)
    per_pair = {}
    for key, piece in F64_WALKS.items():
        found = [(k, u) for k, u in usage.items() if piece in k]
        check(len(found) == 2, f"{len(found)} instantiations of {piece} in f64_kernels.cu")
        for mangled, u in found:
            loops = sorted(build.sass_loops(text, mangled),
                           key=lambda lp: lp["instructions"] / lp["pairs"])
            check(bool(loops), f"no rsqrt loop in the SASS of {names[mangled]}")
            lp = loops[0]
            fp64 = lp["mix"].get("fp64", 0) / lp["pairs"]
            issue = pairs[key] * fp64 / (sms * FP64_LANES * NOMINAL_MHZ * 1e6) * 1e3
            mix = ", ".join(f"{c} {k / lp['pairs']:.2f}" for c, k in sorted(lp["mix"].items()))
            print(f"[3f sass] {names[mangled]}: {u['registers']} registers, "
                  f"{u['spill_stores']} / {u['spill_loads']} bytes spill stores / loads, "
                  f"{u['smem']} bytes smem; walk {lp['instructions'] / lp['pairs']:.2f} SASS "
                  f"instructions a pair, {fp64:.2f} of them FP64 ({mix}); FP64 issue bound "
                  f"{issue:.3f} ms at {NOMINAL_MHZ} MHz")
            check(u["spill_stores"] == 0 and u["spill_loads"] == 0,
                  f"{names[mangled]} spills registers")
            if "ILi2ELi512E" in mangled:
                per_pair[key] = fp64
    step_walks_checked(build, usage, text, tuple(F64_WALKS.values()), "f64_kernels.cu",
                       tag="[3f sass]")
    return per_pair


def phase_f64_kernels(torch) -> dict:
    """3f. The four double kernels (csrc/f64_kernels.cu) against their plain
    float64 versions on the card and the float64 oracle: at (M, N) in
    {(1000, 1000), (4099, 4099), (16384, 16384), (65537, 65537), (16384,
    65536)} (the last a four-card hop: the i-set the first M bodies of the
    j-set), masses from [0.5, 2], a random vel.w and damping 0.5; each at
    blocks 128, 256 and 1024 bit-equal (S from (M, N) alone) and a repeat
    bit-equal; each output within 1e-12 * max + 1e-14 of plain (both
    float64: only the sums' order and the fused multiply-adds differ), the
    mass and vel.w carried bit for bit; the force, the jerk and the
    potential's rows on up to 512 sampled rows within 1e-10 * max +
    1e-12 of the float64 oracle's (Compute's fp64 QA rule), which the fp32
    force at 16384 must fail. Then each walk's registers, spills and SASS
    and FP64 instructions a pair, and each kernel's time at 16384 and
    65536 beside its bound and issue bound, and the plain version's at
    16384."""
    import numpy as np

    from nbody_tpu_torch.ops import _build, energy, reference
    from nbody_tpu_torch.ops import cuda_kernel as ck

    soft, dt, damp = SOFT_RING, 0.016, 0.5
    err = {k: 0.0 for k in F64_KERNELS}

    def run(pi, vi, pj, vj, bs):
        out = {"accel_f64": (ck.compute_accel_cuda(pi, pj, soft, block_size=bs),),
               "step_f64": ck.nbody_step_cuda_vs(pi, vi, pj, dt, soft, damp, block_size=bs),
               "accel_jerk_f64": ck.compute_accel_jerk_cuda(pi, vi, pj, vj, soft,
                                                            block_size=bs)}
        if pi.shape[0] == pj.shape[0]:
            out["potential_f64"] = (ck.potential_energy_per_row_cuda(pi, soft, block_size=bs),)
        return out

    rng = np.random.default_rng(5)
    for m, n in ((1000, 1000), (4099, 4099), (N_QA, N_QA), (65537, 65537), (N_QA, N_MAIN)):
        pj, vj = f64_state(torch, n)
        pi, vi = pj[:m], vj[:m]
        what = f"(M, N) = ({m}, {n}), S = {ck.f64_splits(m, n)}"
        outs = {bs: run(pi, vi, pj, vj, bs) for bs in (128, 256, 1024)}
        again = run(pi, vi, pj, vj, 256)
        torch.cuda.synchronize()
        for key, got in outs[256].items():
            same = all(torch.equal(a, b) for bs in (128, 1024)
                       for a, b in zip(got, outs[bs][key]))
            rep = all(torch.equal(a, b) for a, b in zip(got, again[key]))
            check(same and rep, f"{key} differs across blocks 128 / 256 / 1024 or repeats at "
                                f"{what}")
        # the plain versions in 2048-row chunks: (2048, 65537) float64
        # temporaries of 1 GB each
        c = 2048
        plain = {"accel_f64": (reference.compute_accel_vs(pi, pj, soft, chunk_size=c),),
                 "step_f64": reference.nbody_step_vs(pi, vi, pj, dt, soft, damp, chunk_size=c),
                 "accel_jerk_f64": reference.compute_accel_jerk_vs(pi, vi, pj, vj, soft,
                                                                   chunk_size=c)}
        if m == n:
            plain["potential_f64"] = (energy.potential_energy_per_row(pi, soft, chunk_size=c),)
        worst = []
        for key, want in plain.items():
            for g, w in zip(outs[256][key], want):
                e = float((g - w).abs().max())
                tol = 1e-12 * float(w.abs().max()) + 1e-14
                check(g.dtype == torch.float64 and bool(torch.isfinite(g).all()),
                      f"{key} output is not finite float64 at {what}")
                check(e <= tol, f"{key} kernel disagrees with its plain version at {what}: "
                                f"{e:.3e} > {tol:.3e}")
                err[key] = max(err[key], e)
                worst.append(e / tol)
        new_pos, new_vel = outs[256]["step_f64"]
        check(torch.equal(new_pos[:, 3], pi[:, 3]) and torch.equal(new_vel[:, 3], vi[:, 3]),
              f"the step changed the mass or vel.w at {what}")
        rows = np.arange(m) if m <= 512 else np.unique(np.concatenate(
            [[0, m - 1], rng.choice(m, 510, replace=False)]))
        p64, v64 = pj.cpu().numpy(), vj.cpu().numpy()
        o_acc, o_jerk, o_pot = oracle_rows_f64(rows, p64, v64, soft)
        idx = torch.as_tensor(rows, device=pi.device)
        fields = [("force", outs[256]["accel_f64"][0], o_acc),
                  ("accel + jerk's force", outs[256]["accel_jerk_f64"][0], o_acc),
                  ("jerk", outs[256]["accel_jerk_f64"][1], o_jerk)]
        if m == n:
            fields.append(("potential", outs[256]["potential_f64"][0], o_pot))
        report = []
        for name, got, ref in fields:
            e = float(np.abs(got[idx].cpu().numpy() - ref).max())
            tol = 1e-10 * float(np.abs(ref).max()) + 1e-12
            check(e <= tol, f"the double {name} is not fp64-grade at {what}: {e:.3e} > {tol:.3e}")
            report.append(f"{name} {e / float(np.abs(ref).max()):.2e}")
        print(f"[3f f64] {what}: blocks 128 / 256 / 1024 and a repeat bit-equal; against plain "
              f"at most {max(worst):.3f} of the bound; against the float64 oracle on "
              f"{len(rows)} rows, max|d| / max: {', '.join(report)} (bound 1e-10)")
        if (m, n) == (N_QA, N_QA):
            f32 = ck.compute_accel_cuda(pi.float(), pj.float(), soft)[idx].double().cpu().numpy()
            e32 = float(np.abs(f32 - o_acc).max()) / float(np.abs(o_acc).max())
            print(f"[3f f64] the fp32 force at {what} against the float64 oracle: max|d| / max "
                  f"{e32:.2e}, which the 1e-10 bound must refuse")
            check(e32 > 1e-10, "the fp32 force passes the fp64 bound: the check cannot fail")
        del outs, again, plain
    p0, v0 = f64_state(torch, 256)
    check(bool(torch.isnan(ck.compute_accel_cuda(p0, p0, 0.0)).all()
               and torch.isnan(ck.compute_accel_jerk_cuda(p0, v0, p0, v0, 0.0)[0]).all()),
          "the double force at eps = 0 is not NaN (the self pair), as plain gives")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_pair = f64_walk_lines(_build, {k: float(N_MAIN) ** 2 for k in F64_KERNELS}, sms)
    times, bounds = {}, {}
    for n, reps in ((N_QA, 10), (N_MAIN, 3)):
        p, v = f64_state(torch, n)
        calls = {"step_f64": lambda: ck.nbody_step_cuda(p, v, dt, soft, damp),
                 "accel_f64": lambda: ck.compute_accel_cuda(p, p, soft),
                 "accel_jerk_f64": lambda: ck.compute_accel_jerk_cuda(p, v, p, v, soft),
                 "potential_f64": lambda: ck.potential_energy_per_row_cuda(p, soft)}
        plains = {"step_f64": lambda: reference.nbody_step(p, v, dt, soft, damp),
                  "accel_f64": lambda: reference.compute_accel(p, soft),
                  "accel_jerk_f64": lambda: reference.compute_accel_jerk(p, v, soft),
                  "potential_f64": lambda: energy.potential_energy_per_row(p, soft)}
        for key, fn in calls.items():
            ms = timed_ms(torch, fn, reps)
            pairs = float(n) ** 2
            # bytes: each input read once, each output written once (32 a
            # body, 24 a force or jerk row, 8 a potential row)
            nbytes = {"step_f64": 128, "accel_f64": 56, "accel_jerk_f64": 112,
                      "potential_f64": 40}[key] * n
            t_ops = F64_FLOPS[key] * pairs / PEAK_FP64_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            issue = pairs * per_pair[key] / (sms * FP64_LANES * NOMINAL_MHZ * 1e6) * 1e3
            line = (f"[3f f64] {key} N={n}: {ms:.4f} ms, bound {bound:.4f} ms "
                    f"({100 * bound / ms:.1f} %), FP64 issue bound {issue:.4f} ms "
                    f"({100 * issue / ms:.1f} %) at {per_pair[key]:.2f} a pair")
            if n == N_QA:
                plain_ms = timed_ms(torch, plains[key], 1)
                times[key] = (ms, plain_ms)
                bounds[key] = (bound, "operations" if t_ops >= t_bytes else "bytes")
                line += f"; plain float64 {plain_ms:.3f} ms"
            print(line)
    return {"err": err, "times": times, "bounds": bounds}


def timed_ms(torch, fn, reps: int) -> float:
    """Milliseconds a call of fn() on the card: one untimed call, then CUDA
    events around `reps` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_f64_main(torch, smi: str) -> None:
    """5f. The fp64 path through Compute(precision="fp64"): QA at N=16384
    (positions, and the force or the jerk against the float64 oracle at
    1e-10 of its largest value) for Euler, leapfrog and Hermite; ten timed
    steps at N=16384 and 65536 beside the ds one_sided step, in turns (fp64,
    ds, ds, fp64); the force of both modes and one QA step against the
    float64 oracle at 16384 (tests/test_ds_kernel.py's bounds: |dpos| <
    1e-11, the force within 1e-10 of its largest value); drift_check(10) at
    N=16384 (BASELINE.json configs[2]) with the --drift-check gate, its wall
    time and the float64 functional's on the card against the host's; and a
    switch_precision round trip (fp32 sym -> fp64 vpu -> fp32 sym, the state
    cast each way). The CLI's --fp64 --qatest runs with phase 7's lines."""
    import numpy as np

    from nbody_tpu_torch.cli import drift_failed
    from nbody_tpu_torch.compute import QA_DT, Compute, _oracle_accel
    from nbody_tpu_torch.oracle import step_best
    from nbody_tpu_torch.ops import energy
    from nbody_tpu_torch.ops.ds import ds_to_f64

    for integrator in ("euler", "leapfrog", "hermite"):
        c = Compute(num_bodies=N_QA, device="cuda", precision="fp64", integrator=integrator,
                    log=lambda s: print(f"[5f QA] {s}"))
        check(c.system.dtype == torch.float64 and c.system.backend == "cuda"
              and c.system.variant == "vpu", "the fp64 path did not select the double kernels")
        check(c.compare_results(), f"fp64 QA against the float64 oracle failed ({integrator})")
    ms = {}
    for n in (N_QA, N_MAIN):
        for mode in ("fp64", "ds", "ds", "fp64"):
            kw = {"precision": "fp64"} if mode == "fp64" else {"precision": "ds",
                                                               "variant": "one_sided"}
            c = Compute(num_bodies=n, device="cuda", log=lambda s: None, **kw)
            res = c.run_benchmark(10)
            pos, vel = c.system.state
            check(tuple(pos.shape) == (n, 4) and bool(torch.isfinite(pos).all()
                                                      and torch.isfinite(vel).all()),
                  f"bad state after the {mode} benchmark at N={n}")
            ms.setdefault((mode, n), []).append(res["milliseconds"] / res["iterations"])
        f, d = min(ms[("fp64", n)]), min(ms[("ds", n)])
        print(f"[5f main] N={n}: fp64 Euler {f:.4f} ms, ds one_sided Euler {d:.4f} ms per step "
              f"(best of two, in turns; runs {ms[('fp64', n)]} / {ms[('ds', n)]}): ds takes "
              f"{d / f:.2f}x fp64 [{smi}]")
    p = Compute(num_bodies=N_QA, device="cuda", precision="fp64", log=lambda s: None)
    q = Compute(num_bodies=N_QA, device="cuda", precision="ds", variant="one_sided",
                log=lambda s: None)
    pos0, vel0 = p.system.positions, p.system.velocities
    q.system.set_state(pos0, vel0)
    ref_acc = _oracle_accel(pos0, p.active_params.softening)
    ref_pos = step_best(pos0, vel0, QA_DT, p.active_params.softening,
                        p.active_params.damping)[0]
    scale = float(np.abs(ref_acc).max())
    acc = {"fp64": p.system.accelerations().cpu().numpy(),
           "ds": ds_to_f64(*q.system.accelerations())}
    for c in (p, q):
        c.system.update(QA_DT)
    dpos = {"fp64": float(np.abs(p.system.positions[:, :3] - ref_pos[:, :3]).max()),
            "ds": float(np.abs(q.system.positions[:, :3] - ref_pos[:, :3]).max())}
    for mode in ("fp64", "ds"):
        da = float(np.abs(acc[mode] - ref_acc).max()) / scale
        print(f"[5f accuracy] N={N_QA} {mode}: force max|da| / max|a| = {da:.3e} (bound 1e-10), "
              f"one dt={QA_DT} step max|dpos| = {dpos[mode]:.3e} (bound 1e-11) against the "
              "float64 oracle")
        check(da <= 1e-10 and dpos[mode] < 1e-11, f"{mode} is not fp64-grade at N={N_QA}")
    c = Compute(num_bodies=N_QA, device="cuda", precision="fp64",
                log=lambda s: print(f"[5f drift] {s}"))
    t0 = time.perf_counter()
    drift = c.drift_check(10)
    t_drift = time.perf_counter() - t0
    check(not drift_failed(drift), f"fp64 drift check failed: {drift}")
    pos, vel = c.system.state
    soft = c.active_params.softening
    t0 = time.perf_counter()
    e_card = energy.total_energy_precise(pos, vel, soft)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_host = energy.total_energy_f64(pos, vel, soft)
    t_host = time.perf_counter() - t0
    print(f"[5f drift] N={N_QA}, 10 steps: delta {drift['delta']:.3e} in {t_drift:.2f} s; the "
          f"float64 functional on the card {t_card * 1e3:.1f} ms ({e_card:.15e}), on the host "
          f"{t_host * 1e3:.1f} ms ({e_host:.15e}), relative difference "
          f"{abs(e_card - e_host) / abs(e_host):.2e} [{smi}]")
    check(abs(e_card - e_host) <= 1e-12 * abs(e_host), "the card's float64 functional "
                                                       "disagrees with the host's")
    c = Compute(num_bodies=N_QA, device="cuda", variant="sym", log=lambda s: print(f"[5f] {s}"))
    pos32 = c.system.positions
    c.switch_precision()
    check(c.precision == "fp64" and c.system.dtype == torch.float64
          and c.system.variant == "vpu"
          and bool(np.array_equal(c.system.positions, pos32.astype(np.float64))),
          "switch_precision to fp64 did not carry the state")
    c.system.update_many(2)
    pos64 = c.system.positions
    c.switch_precision()
    check(c.precision == "fp32" and c.system.dtype == torch.float32
          and c.system.variant == "sym"
          and bool(np.array_equal(c.system.positions, pos64.astype(np.float32))),
          "switch_precision back to fp32 did not restore sym and the state")
    print("[5f] switch_precision: fp32 sym -> fp64 vpu (2 steps) -> fp32 sym, the state cast "
          "each way")


def phase_experiment_main(torch, smi: str) -> None:
    """5e. The ports of the three experiment scripts as a user runs them, at
    N=65536 (their default): scripts/torch_r3_dualbank.py,
    scripts/torch_r3_packed.py and scripts/torch_r4_sym_budget.py 65536,
    each in this process, so that their launches count; each must exit 0."""
    import importlib.util

    for name, argv in (("torch_r3_dualbank", []), ("torch_r3_packed", []),
                       ("torch_r4_sym_budget", [str(N_MAIN)])):
        path = ROOT / "scripts" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        t0 = time.perf_counter()
        code = module.main(argv)
        print(f"[5e scripts] {path.relative_to(ROOT)} {' '.join(argv)} exited {code} in "
              f"{time.perf_counter() - t0:.1f} s [{smi}]")
        check(code == 0, f"{path.name} exited {code}")


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
    for integrator, variant in (("euler", "auto"), ("hermite", "auto"), ("hermite", "vpu")):
        dev = BodySystem(N_QA, params, device="cuda", placement="device", seed=42,
                         integrator=integrator, variant=variant)
        host = BodySystem(N_QA, params, device="cuda", placement="host", seed=42,
                          integrator=integrator, variant=variant)
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
            (["--fp64", "--qatest", "--numbodies", "4096"], "-> OK"),
            (["--precision", "ds", "--integrator", "hermite", "--qatest", "--numbodies", "4096"],
             "-> OK"),
            (["--precision", "ds", "--integrator", "hermite", "--benchmark", "-i", "10"],
             "double-single-precision"),
            # the flags nbody_tpu's ds measurement modes run without
            (["--precision", "ds", "--variant", "mxu_bf16", "--hostmem", "--kernel", "p3m",
              "--qatest", "--numbodies", "4096"], "--kernel p3m (the all-pairs ds kernels "
             "run) has no effect"))
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


N_FRAME_BIG = 1 << 20  # the frame-time cell of a 2^20-body demo


def cli_lines(tag: str, argv: list) -> tuple[str, float]:
    """nbody-torch `argv` in this process (its launches count), its output
    printed under `tag`; returns the output and the call's seconds."""
    import contextlib
    import io

    from nbody_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.strip().splitlines():
        print(f"[{tag}] {line}")
    check(rc == 0, f"nbody-torch {' '.join(argv)} exited {rc}")
    return out, secs


def reported_fps(out: str) -> list:
    return [float(x) for x in re.findall(r"\| ([\d.]+) fps \|", out)]


def call_times(owner, name: str, times: list):
    """A context manager that records (start, end) host times of each call
    of owner.name (a function or staticmethod) inside it."""
    import contextlib

    real = owner.__dict__[name]
    fn = real.__func__ if isinstance(real, staticmethod) else real

    def timed_call(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        times.append((t0, time.perf_counter()))
        return out

    @contextlib.contextmanager
    def patched():
        setattr(owner, name, staticmethod(timed_call) if isinstance(real, staticmethod)
                else timed_call)
        try:
            yield times
        finally:
            setattr(owner, name, real)

    return patched()


def phase_demo_main(torch, smi: str, tmp: pathlib.Path) -> None:
    """The demo loop through the CLI (phase 8, in the count)."""
    from nbody_tpu_torch.io import load_checkpoint, load_checkpoint_ds_planes
    from nbody_tpu_torch.render import FrameRenderer

    outdir = tmp / "frames"
    galaxy = ["--config", "galaxy", "--numbodies", str(N_MAIN)]
    renders, writes = [], []
    with call_times(FrameRenderer, "render", renders), \
            call_times(FrameRenderer, "write_png", writes):
        out, secs = cli_lines("8 demo", [*galaxy, "--frames", "30", "--render", "--outdir",
                                         str(outdir)])
    check(len(list(outdir.glob("frame_*.png"))) == 30, "--render did not write 30 PNG frames")
    meta = json.loads((outdir / "metadata.json").read_text())
    check(meta["num_bodies"] == N_MAIN and meta["device"] == torch.cuda.get_device_name(0),
          f"metadata.json: {meta}")

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    # frames 2..30: from the end of the first frame's PNG write to the last's
    fps = (len(writes) - 1) / (writes[-1][1] - writes[0][1])
    print(f"[8 demo] --render at N={N_MAIN}: {fps:.1f} fps over frames 2-30 (step, frame, HUD, "
          f"PNG write), the first frame {1e3 * (renders[0][1] - renders[0][0]):.1f} ms, then "
          f"frame {1e3 * median([b - a for a, b in renders[1:]]):.3f} ms and PNG write "
          f"{1e3 * median([b - a for a, b in writes[1:]]):.3f} ms (medians); the CLI call "
          f"{secs:.3f} s, fps reported {reported_fps(out)} [{smi}]")
    out, secs = cli_lines("8 demo", [*galaxy, "--frames", "2000"])
    print(f"[8 demo] no --render at N={N_MAIN}: 2000 frames in {secs:.3f} s of the CLI call, "
          f"fps reported {reported_fps(out)} [{smi}]")
    out, _ = cli_lines("8 demo", ["--selftest", "--numbodies", str(N_QA)])
    check("selftest PASSED" in out, "--selftest did not pass")
    for precision in ("ds", "fp64"):
        a, b, c = (str(tmp / f"{precision}_{k}.npz") for k in "abc")
        common = ["--precision", precision, "--numbodies", str(N_QA), "--no-cycle"]
        cli_lines("8 demo", [*common, "--frames", "2", "--checkpoint-save", a])
        cli_lines("8 demo", ["--precision", precision, "--no-cycle", "--frames", "2",
                             "--checkpoint-load", a, "--checkpoint-save", b])
        cli_lines("8 demo", [*common, "--frames", "4", "--checkpoint-save", c])
        resumed, straight = load_checkpoint(b), load_checkpoint(c)
        same = all((x == y).all() for x, y in zip(resumed[:2], straight[:2]))
        same &= resumed[3]["step"] == straight[3]["step"] == 4
        if precision == "ds":
            same &= all((x == y).all() for x, y in zip(load_checkpoint_ds_planes(b),
                                                        load_checkpoint_ds_planes(c)))
        print(f"[8 demo] {precision} resume at N={N_QA}: 2 + 2 frames equal 4 straight bit for "
              f"bit{' (positions, velocities and the hi/lo planes)' if precision == 'ds' else ''}: "
              f"{same}")
        check(same, f"the {precision} checkpoint resume is not bit-exact")


def frames_close(a, b) -> tuple[int, float]:
    d = abs(a.astype("int32") - b.astype("int32"))
    return int(d.max()), float((d == 0).mean())


def phase_demo_frames(torch, smi: str) -> None:
    """The rasterizer on the card (phase 8, after the count): card frames
    against CPU frames, repeats bit-equal, frame times."""
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.render import Camera, DisplayMode, FrameRenderer
    from nbody_tpu_torch.ui.hud import draw_hud, hud_lines

    near = (0.0, 0.0, -25.0)  # the shell fills the frame: a test of many lit pixels
    pos16, _ = ic.generate(NBodyConfig.SHELL, N_QA, *tuned_scales(N_QA), seed=42)
    cases = [(mode, method, 4099, (256, 192)) for mode in DisplayMode
             for method in ("scatter", "conv")]
    cases += [(DisplayMode.SPRITES_COLOR, method, N_QA, (512, 384))
              for method in ("scatter", "conv")]
    for mode, method, n, (w, h) in cases:
        r = FrameRenderer(w, h, splat=16, method=method)
        host = torch.from_numpy(pos16[:n])
        card, cpu = (r.render(x, Camera(near), mode=mode, brightness=0.05)
                     for x in (host.cuda(), host))
        worst, exact = frames_close(card, cpu)
        lit = float((cpu > 0).mean())
        print(f"[8 frames] card against CPU, {mode.value} {method}, N={n}, {w}x{h}: max |delta| "
              f"{worst}, exact {exact:.6f}, lit {lit:.4f}")
        check(lit > 0.01 and worst <= 1 and exact >= 0.999,
              f"the card's {mode.value} {method} frame is not the CPU's")

    origin = DEMO_PARAMS[0].camera_origin

    def shell(n):
        # tuned_scales has no entry above 32768: demo 0's scales there
        scales = tuned_scales(n) or (DEMO_PARAMS[0].cluster_scale, DEMO_PARAMS[0].velocity_scale)
        return torch.tensor(ic.generate(NBodyConfig.SHELL, n, *scales, seed=42)[0], device="cuda")

    pos64 = shell(N_MAIN)
    for mode, method in ((DisplayMode.SPRITES_COLOR, "scatter"),
                         (DisplayMode.SPRITES_COLOR, "conv"),
                         (DisplayMode.SPRITES_ALPHA, "scatter")):
        r = FrameRenderer(1024, 768, splat=16, method=method)
        a, b = (r.render(pos64, Camera(near), mode=mode) for _ in range(2))
        same = bool((a == b).all())
        print(f"[8 frames] two {mode.value} {method} renders at N={N_MAIN}, 1024x768: bit-equal "
              f"{same}, lit {float((a > 0).mean()):.4f}")
        check(same and a.any(), f"two {method} renders of one state differ")

    def median_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[reps // 2]

    big = shell(N_FRAME_BIG)
    for n, pos in ((N_MAIN, pos64), (N_FRAME_BIG, big)):
        splat = 16 if n <= 262144 else 8  # the CLI's default
        for method in ("scatter", "conv"):
            r = FrameRenderer(1024, 768, splat=splat, method=method)
            ms = median_ms(lambda: r.render(pos, Camera(origin)))
            print(f"[8 frames] frame at N={n}, 1024x768, sprites_color, {method}, splat {splat}: "
                  f"{ms:.3f} ms (median of 5, the uint8 frame on the host) [{smi}]")
    del big

    # the demo frame's parts at N=65536, --config galaxy, auto (conv)
    compute = Compute(device="cuda", tipsy_state=ic.galaxy_collision(N_MAIN, seed=42),
                      log=lambda s: None)
    step_ms = median_ms(lambda: compute.update_simulation(None))
    r = FrameRenderer(1024, 768, splat=16)
    state = compute.system.state[0]
    frame_ms = median_ms(lambda: r.render(state, Camera(origin)))
    frame = r.render(state, Camera(origin))
    compute.fps = 60.0
    hud_ms = median_ms(lambda: draw_hud(frame, hud_lines(compute, torch.cuda.get_device_name(0))))
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        png_ms = median_ms(lambda: r.write_png(frame, pathlib.Path(d) / "f.png"))
    print(f"[8 frames] demo frame at N={N_MAIN} (galaxy, {compute.system.variant}, "
          f"{'conv' if r.uses_conv(N_MAIN) else 'scatter'}): step {step_ms:.3f} ms, frame "
          f"{frame_ms:.3f} ms, HUD {hud_ms:.3f} ms, PNG write {png_ms:.3f} ms (medians of 5) "
          f"[{smi}]")
    check(np.isfinite(compute.system.positions).all(), "non-finite galaxy state")


def phase_demo(torch, ck, smi: str) -> dict:
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        launches = timed("8 demo path", run_path, ck, ("sym",),
                         lambda: phase_demo_main(torch, smi, pathlib.Path(d)))
    timed("8 frames", phase_demo_frames, torch, smi)
    return launches


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
    p3m_range_kern = timed("3q p3m pair kernel ranges", phase_p3m_ranges, torch)
    ds_accel_kern = timed("3da ds accel kernel", phase_ds_accel_kernel, torch)
    ds_kern["err"]["ds_step"] = max(ds_kern["err"]["ds_step"], ds_accel_kern.pop("step_err"))
    ds_kern["err"]["ds_leapfrog"] = max(ds_kern["err"]["ds_leapfrog"],
                                        ds_accel_kern.pop("leapfrog_err"))
    ring_kern = timed("3rf ring kernel", phase_ring_kernel, torch)
    timed("3ri ring between two processes", phase_ring_ipc)
    exp_kern = timed("3e experiment kernels", phase_experiment_kernels, torch)
    f64_kern = timed("3f fp64 kernels", phase_f64_kernels, torch)

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
    # plain PM, TSC P3M, the auto-refresh, the sharded PM and P3M steps and
    # the demo on the one-rank mesh: the ranged pair kernel, the fused ring
    # and the sym triangle must launch there
    mesh_solver_launches = timed("5q mesh solvers and the demo on a mesh", run_path, ck,
                                 ("p3m_sr", "p3m_sr_range", "ring_fused", "sym"),
                                 lambda: phase_mesh_solvers_main(torch, smi))
    launches["p3m_sr_range"] = mesh_solver_launches["p3m_sr_range"]
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
    # only mesh systems run in the sharded path's count, and each of its
    # runs is checked for its own kernels (SHARDED_KERNELS)
    mesh_runs = {}
    sharded_launches = timed("5x sharded path", run_path, ck,
                             sorted({k for ks in SHARDED_KERNELS.values() for k in ks}),
                             lambda: mesh_runs.update(phase_sharded_main(torch, smi)))
    launches["ds_accel"] = sharded_launches["ds_accel"]
    launches["ring_fused"] = sharded_launches["ring_fused"]
    timed("5x single-device comparisons", phase_sharded_single, torch, smi, mesh_runs)
    # sym, the 2-D grid and float64 on a mesh: each run checked for its own
    # kernels (MESH_MORE_KERNELS); the emulated meshes after, outside it
    more_runs = {}
    timed("5y sym, 2-D and float64 meshes", run_path, ck,
          sorted({k for ks in MESH_MORE_KERNELS.values() for k in ks}),
          lambda: more_runs.update(phase_sharded_more_main(torch, smi)))
    timed("5y emulated meshes and bit ties", phase_sharded_more, torch, smi, more_runs)
    del more_runs
    exp_launches = timed("5e experiment scripts", run_path, ck, EXPERIMENT_KERNELS,
                         lambda: phase_experiment_main(torch, smi))
    for k in EXPERIMENT_KERNELS:
        launches[k] = exp_launches[k]
    f64_launches = timed("5f fp64 path", run_path, ck, F64_KERNELS,
                         lambda: phase_f64_main(torch, smi))
    timed("5 plain", phase_plain_main, smi)
    timed("5t step times", phase_step_times, torch, smi)

    timed("6 host", phase_host, torch)
    timed("7 cli", phase_cli)
    timed("8 demo", phase_demo, torch, ck, smi)
    bad = sorted(m for m in sys.modules if m in ("jax", "nbody_tpu")
                 or m.startswith(("jax.", "nbody_tpu.")))
    check(not bad, f"modules of JAX or nbody_tpu were imported: {bad}")
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    found = {key: {**kern[key], **sym_kern[key], **aj_kern[key], **ds_kern[key],
                   **ds_aj_kern[key], **mxu_kern[key], **p3m_kern[key], **p3m_range_kern[key],
                   **ds_accel_kern[key],
                   **ring_kern[key], **exp_kern[key]}
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
    # the double kernels replace no TPU kernel: a line of their own
    f64_kernels = [{
        "name": F64_NAMES[k],
        "route": "cuda",
        "source": F64_SOURCE,
        "replaces": F64_REPLACES[k],
        "launches": f64_launches[k],
        "max_abs_err": f64_kern["err"][k],
        "ms": f64_kern["times"][k][0],
        "plain_ms": f64_kern["times"][k][1],
        "bound_ms": f64_kern["bounds"][k][0],
        "bound_by": f64_kern["bounds"][k][1],
        "library_ms": None,
    } for k in F64_KERNELS]
    print(json.dumps({"f64_kernels": f64_kernels}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
