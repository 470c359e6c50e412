"""The least time of a P3M Euler step: the short range's ordered body pairs
within rcut (counted by the plain reference from the seed's initial state,
which every replay starts from, so a later, more clustered state is
charged at the initial one's count: a lower bound), at the JAX package's
40 flops a pair of its pair kernel and the published fp32 peak; and the
mesh stages of plain PM (``pm_cic_1m.py``: the deposit, the solve, the
gather and the update, each stage's bytes once at the HBM peak)."""

from benchmark.harness import peaks
from benchmark.reference import p3m
from benchmark.rooflines.pm_cic_1m import mesh_s_per_step

FLOPS_PER_PAIR = 40


def bound_s_per_step(workload, config, pos):
    n, g = workload["n"], config["pm_grid"]
    pairs = p3m.near_pairs(pos, grid=g)
    return FLOPS_PER_PAIR * pairs / peaks.FP32_FLOPS + mesh_s_per_step(n, g)
