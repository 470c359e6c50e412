"""The least time of a step of the body-sharded run: the all-pairs count of
one card's bound (each pair once, 28 flops a pair), spread over the cards."""

from benchmark.harness import peaks

FLOPS_PER_PAIR = {"euler": 28, "hermite": 2 * 60}


def bound_s_per_step(workload, config, pos):
    n, chips = workload["n"], workload["chips"]
    flops = FLOPS_PER_PAIR[workload["integrator"]] * n * (n - 1) / 2
    return max(flops / (chips * peaks.FP32_FLOPS), 2 * n * 32 / (chips * peaks.HBM_BYTES))
