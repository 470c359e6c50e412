#!/usr/bin/env python3
"""What the reaction costs in the each-pair-once (sym) triangle on the card:
the port of scripts/tpu_r4_sym_budget.py.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_r4_sym_budget.py [N] [--cpu]

This script times the same Euler step five times. Each version has its
force from a different kernel, and each shares the update
(``reference.integrate``). The versions are taken in turns (A B C D E E D
C B A), each a roll of 25 steps, best of 3. The labels are the TPU
script's:

  A  the one-sided step kernel (block 256)
  B  the production sym step: compute_accel_symmetric_blocked_cuda, one
     triangle launch up to its cap, as BodySystem(variant="sym") runs it
  C  the triangle with the reaction removed (sym_ablate_kernel, kNone):
     the same shuffle walk of the j-bodies, the action only
  D  C with the reaction arithmetic and its lane-to-lane shuffles back,
     each block's reaction total written to one 3-float slot (kTreeSmall)
  E  the production reaction tail (kFull): the warps' shared-memory sum,
     the per-column scratch write and the partial-sum pass

It prints one JSON line a version (G interactions/s at N^2 pairs a step,
as the TPU script counts them), then the budget in ms per step. The budget
names the components as Hopper has them:

  walk_overhead_ms                   C - A/2: the triangle walk beside half
                                     the one-sided work
  reaction_arith_shuffles_ms         D - C
  warp_sum_scratch_partial_sum_ms    E - D
  layout_delta_ms_B_vs_E             B - E (the production kernel against
                                     its ablated twin; the two write the
                                     diagonal differently)

First it checks each version's force: every output is finite. It also
checks two bit-equalities: E's total, summed in the production order,
against the production kernel's force, and C's action against E's. The
ablated versions are timing-only: D's reaction slots are wrong physics by
design. The script also prints what ptxas says of every kernel of
csrc/symmetric_kernels.cu, and the card's name and power limit. Above the
sym composition's cap (131072), B composes blocks while C-E stay one
triangle.

The triangle's tile is the sym dispatch's (``DEFAULT_SYM_TILE``). --cpu
rehearses the same flow on the host with the plain versions, at N = 257
(unless N is given) and tile 128, in rolls of 2 steps, one round each. Its
times are host times of PyTorch's CPU operations, not times of the card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N, ITERS, ROUNDS = 65536, 25, 3
# --cpu: a rehearsal the host runs in moments, at an odd N that fills no tile
CPU_N, CPU_TILE, CPU_ITERS, CPU_ROUNDS = 257, 128, 2, 1
VARIANTS = (("C_no_reaction", "none"), ("D_tree_small_slot", "tree_small"),
            ("E_tree_wide_rmw", "full"))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=None,
                   help=f"bodies (default {N}; {CPU_N} with --cpu)")
    p.add_argument("--cpu", action="store_true",
                   help="rehearse on the host with the plain versions (no device times)")
    args = p.parse_args(argv)
    if args.n is None:
        args.n = CPU_N if args.cpu else N
    return args


def main(argv=None) -> int:
    import torch

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic
    from nbody_tpu_torch.ops import _build, reference
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.utils.timing import best_of_ms, card_line

    args = parse(argv)
    tile, iters, rounds = ((CPU_TILE, CPU_ITERS, CPU_ROUNDS) if args.cpu
                           else (ck.DEFAULT_SYM_TILE, ITERS, ROUNDS))
    if args.cpu:
        device = torch.device("cpu")
        print("cpu rehearsal: the plain versions on the host; times are not device times")
    else:
        if not torch.cuda.is_available():
            print("needs an NVIDIA GPU (or --cpu for a rehearsal)", file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        print(f"card: {card_line()}")
        for line in _build.ptxas_lines("symmetric_kernels.cu"):
            print(line)
    p = DEMO_PARAMS[0]
    dt, soft, damp = p.time_step, p.softening, p.damping
    n = args.n
    pos, vel = ic.generate(NBodyConfig.SHELL, n, p.cluster_scale, p.velocity_scale, seed=42)
    p0, v0 = torch.tensor(pos, device=device), torch.tensor(vel, device=device)

    # every version runs and stays finite; E's total has the production
    # kernel's bits, and C's action E's
    a_prod = ck.sym_accel_cuda(p0, soft, tile=tile)
    acc_none, _ = ck.sym_ablated_accel_cuda(p0, soft, reaction="none", tile=tile)
    acc_tree, slots = ck.sym_ablated_accel_cuda(p0, soft, reaction="tree_small", tile=tile)
    acc_full, react, total = ck.sym_ablated_accel_cuda(p0, soft, reaction="full", tile=tile,
                                                       with_total=True)
    for name, t in (("production", a_prod), ("none", acc_none), ("tree_small", acc_tree),
                    ("tree_small slots", slots), ("full", acc_full), ("full react", react)):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"non-finite {name} output")
    print(json.dumps({"check": {
        "full_total_bit_equal_production": bool(torch.equal(total, a_prod)),
        "none_acc_bit_equal_full_acc": bool(torch.equal(acc_none, acc_full)),
        "tree_small_acc_bit_equal_full_acc": bool(torch.equal(acc_tree, acc_full)),
        "full_total_minus_production_max": (total - a_prod).abs().max().item()}}), flush=True)

    def roll(step):
        def run():
            a, b = p0, v0
            for _ in range(iters):
                a, b = step(a, b)
        return run

    def ablated(reaction):
        def step(a, b):
            acc = ck.sym_ablated_accel_cuda(a, soft, reaction=reaction, tile=tile)[0]
            return reference.integrate(a, b, acc, dt, damp)
        return step

    steps = {
        "A_one_sided": lambda a, b: ck.nbody_step_cuda(a, b, dt, soft, damp),
        "B_sym_production": lambda a, b: reference.integrate(
            a, b, ck.compute_accel_symmetric_blocked_cuda(a, soft, tile=tile), dt, damp),
        **{name: ablated(reaction) for name, reaction in VARIANTS},
    }
    order = list(steps)
    ms = {k: [] for k in steps}
    for name in order + order[::-1]:
        ms[name].append(best_of_ms(roll(steps[name]), device, rounds=rounds) / iters)
    best = {k: min(v) for k, v in ms.items()}
    g = {k: n * n * 1e-9 * (1000.0 / t) for k, t in best.items()}
    for name in order:
        line = {"variant": name, "g_int_s": round(g[name], 1), "ms": round(best[name], 4)}
        if name != "A_one_sided":
            line["x_one_sided"] = round(g[name] / g["A_one_sided"], 3)
        print(json.dumps(line), flush=True)
    budget = {
        "shape": {"N": n, "tile": tile},
        "bound_2x_one_sided_g": round(2 * g["A_one_sided"], 1),
        "walk_overhead_ms": round(best["C_no_reaction"] - best["A_one_sided"] / 2, 4),
        "reaction_arith_shuffles_ms": round(best["D_tree_small_slot"] - best["C_no_reaction"],
                                            4),
        "warp_sum_scratch_partial_sum_ms": round(
            best["E_tree_wide_rmw"] - best["D_tree_small_slot"], 4),
        "layout_delta_ms_B_vs_E": round(best["B_sym_production"] - best["E_tree_wide_rmw"], 4),
        "total_ms": {k: round(v, 4) for k, v in best.items()},
    }
    print(json.dumps({"budget": budget}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
