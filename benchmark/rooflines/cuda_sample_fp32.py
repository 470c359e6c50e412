"""The least time of a step of all-pairs gravity on one card, whatever
kernel runs: each pair once, N(N-1)/2 pairs, at the JAX package's flops a
pair of the each-pair-once kernels (28 for the force, 60 for accel + jerk,
two accel + jerk evaluations a Hermite step), the state's bytes read and
written once, at the published fp32 and HBM peaks."""

from benchmark.harness import peaks

FLOPS_PER_PAIR = {"euler": 28, "hermite": 2 * 60}


def bound_s_per_step(workload, config, pos):
    n = workload["n"]
    flops = FLOPS_PER_PAIR[workload["integrator"]] * n * (n - 1) / 2
    state_bytes = 2 * n * 32
    return max(flops / peaks.FP32_FLOPS, state_bytes / peaks.HBM_BYTES)
