"""The least time of a P3M Euler step: the short range's ordered body pairs
within rcut (counted by the plain reference from the seed's initial state,
which every replay starts from, so a later, more clustered state is
charged at the initial one's count: a lower bound), at the JAX package's
40 flops a pair of its pair kernel; the mesh stages' bytes, each once:
the deposit (positions in, the G^3 density out), the solve (the (2G)^3
padded density in, three (2G)^3 force grids out), the gather (three G^3
grids and the positions in, the accelerations out) and the update (the
state in and out); at the published fp32 and HBM peaks, stage by stage."""

from benchmark.harness import peaks
from benchmark.reference import p3m

FLOPS_PER_PAIR = 40


def bound_s_per_step(workload, config, pos):
    n, g = workload["n"], config["pm_grid"]
    pairs = p3m.near_pairs(pos, grid=g)
    stage_bytes = (n * 16 + g ** 3 * 4,
                   (2 * g) ** 3 * 4 * 4,
                   3 * g ** 3 * 4 + n * 16 + n * 12,
                   2 * n * 32)
    return FLOPS_PER_PAIR * pairs / peaks.FP32_FLOPS + sum(b / peaks.HBM_BYTES
                                                           for b in stage_bytes)
