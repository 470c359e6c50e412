"""The least time of a plain-PM Euler step: the mesh stages' bytes, each
read and written once at the published HBM peak, stage by stage: the
deposit (positions in, the G^3 density out), the solve (the (2G)^3 padded
density in, three (2G)^3 force grids out), the gather (three G^3 grids and
the positions in, the accelerations out) and the update (the state in and
out). The P3M roofline adds its pairs to the same stages."""

from benchmark.harness import peaks


def mesh_s_per_step(n: int, g: int) -> float:
    """Seconds of the mesh stages of a step of n bodies on a G = g mesh."""
    stage_bytes = (n * 16 + g ** 3 * 4,
                   (2 * g) ** 3 * 4 * 4,
                   3 * g ** 3 * 4 + n * 16 + n * 12,
                   2 * n * 32)
    return sum(b / peaks.HBM_BYTES for b in stage_bytes)


def bound_s_per_step(workload, config, pos):
    return mesh_s_per_step(workload["n"], config["pm_grid"])
