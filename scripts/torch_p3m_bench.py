#!/usr/bin/env python3
"""Measure the P3M short-range pair kernel (csrc/p3m_kernels.cu) of
nbody_tpu_torch on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_p3m_bench.py [--quick] [--against DIR]

First it prints what ptxas says of each kernel of the source (registers,
spills, shared memory) and the opcode mix of the pair kernel's SASS
(cuobjdump) at each blk, counted over the whole function, for the kernel
and for its contracted form: the same source built with its unfused
intrinsics (__fmul_rn, __fadd_rn, __fsub_rn) defined as plain operators,
which nvcc fuses into FFMAs. Then it holds the kernel to the plain
short-range sum (ops/reference.py::p3m_short_range) at rtol 1e-4 / atol
2e-4 on shell states at N = 4099 (77 zero-mass bodies added, G = 32), 16384
and 65536 (G = 64) with masses from [0.5, 2], at each blk (128, 256, 512),
with a repeat call bit-equal, and prints the contracted form's error over
the same bound beside it (not gated: why the kernel rounds its terms as the
plain version does). --quick stops there.

Then, with demo-0 parameters at G = 64, it times three states: shell ICs at
N = 65536 and 1,048,576 at the auto-sized capacity, and the 1,048,576-body
state after four Euler steps from them (demo 0 collapses, one cell
holding ~3e4 bodies) at the capacity auto-sized from the largest occupancy
of those five states, so that no body drops (the state a contract-keeping
benchmark run steps from). For each it prints the pair kernel's work
(p3m.pair_work: clusters, items, the box and row tests' outcomes, near
pairs, the pruning's efficiency termed / near) and, per blk with the
kernel's ptxas registers, the kernel alone (CUDA events over `reps`
launches on prebuilt tables, after one warm-up launch), its contracted
form, the tables it reads, and the whole p3m_accel, beside the function's
bound (7 + 19 FP32 instructions a near pair with FMA, 2 flops each at 67
TFLOP/s). Rounds are taken in turns. With --against DIR (a checkout of
another commit of this repository, e.g. unpacked by git archive), each
round of the kernel is flanked by a round of DIR's pair_tables and
p3m_sr_pairs_cuda on the same states and blks, run in a child process that
imports DIR's package: DIR, this, this, DIR. Prints one line per
measurement and the nvidia-smi name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

GRID = 64
N_BIG = 1 << 20
# FP32-pipe instructions a near pair with FMA: 7 to test it, 19 for the term
NEAR_INSTR = 7 + 19
PEAK_FP32_FLOPS = 67e12
REPS = {65536: 20, N_BIG: 3}


def contracted_source(tmp: pathlib.Path) -> pathlib.Path:
    """csrc/p3m_kernels.cu with its unfused intrinsics defined as plain
    operators (after the CUDA headers), so nvcc contracts the terms."""
    from nbody_tpu_torch.ops import _build

    src = tmp / "p3m_contracted.cu"
    src.write_text("#include <cuda_runtime.h>\n"
                   "#define __fmul_rn(a, b) ((a) * (b))\n"
                   "#define __fadd_rn(a, b) ((a) + (b))\n"
                   "#define __fsub_rn(a, b) ((a) - (b))\n"
                   f'#include "{_build.CSRC / "p3m_kernels.cu"}"\n')
    return src


def contracted_library(tmp: pathlib.Path) -> ctypes.CDLL:
    from nbody_tpu_torch.ops import _build

    so = tmp / "p3m_contracted.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                    str(contracted_source(tmp))], check=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    _build.declare_p3m_sr(lib)
    # the library's error text comes from another source: name the code only
    lib.nbody_error_string = lambda err: f"code {err}".encode()
    return lib


def ptxas_report(tmp: pathlib.Path) -> dict:
    """Print ptxas's lines for the kernel and its contracted form; return
    {blk: registers} of the pair kernel."""
    from nbody_tpu_torch.ops import _build

    regs = {}
    for name, src in (("kernel", _build.CSRC / "p3m_kernels.cu"),
                      ("contracted", contracted_source(tmp))):
        usage = _build.ptxas_usage(src)
        for line in _build.ptxas_lines(src, label=name, usage=usage):
            print(line)
        if name == "kernel":
            for mangled, u in usage.items():
                m = re.search(r"p3m_sr_kernelILi(\d+)E", mangled)
                if m:
                    regs[int(m.group(1))] = u["registers"]
    return regs


def sass_mix(tmp: pathlib.Path) -> None:
    from nbody_tpu_torch.ops import _build

    for name, src in (("kernel", _build.CSRC / "p3m_kernels.cu"),
                      ("contracted", contracted_source(tmp))):
        sass_mix_of(name, src)


def sass_mix_of(name: str, src: pathlib.Path) -> None:
    from nbody_tpu_torch.ops import _build

    _, sass = _build.sass_of(src)
    kernel, mix = None, {}
    for line in sass.splitlines():
        if "Function : " in line:
            m = re.search(r"Function : \S*p3m_sr_kernelILi(\d+)E", line)
            kernel = f"{name} blk {m.group(1)}" if m else None
            if kernel:
                mix[kernel] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if kernel and m:
            mix[kernel][m.group(1).split(".")[0]] += 1
    for kernel, counts in mix.items():
        top = ", ".join(f"{op} {n}" for op, n in counts.most_common(18))
        print(f"sass {kernel}: {sum(counts.values())} instructions: {top}")


def shell(torch, n, *, masses=False, pads=0):
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic

    demo = DEMO_PARAMS[0]
    pos, _ = ic.generate(NBodyConfig.SHELL, n, demo.cluster_scale, demo.velocity_scale, seed=42)
    if masses:
        pos[:, 3] = np.random.default_rng(7).uniform(0.5, 2.0, n)
    pos = np.concatenate([pos, np.zeros((pads, 4), np.float32)])
    return torch.tensor(pos, device="cuda")


def auto_capacity(occ: int) -> int:
    """BodySystem's auto-sized capacity for a largest massive occupancy."""
    return max(8, -(-int(occ * 1.5 + 1) // 8) * 8)


def checks(torch, contracted) -> None:
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import p3m, reference

    soft = DEMO_PARAMS[0].softening
    for n, pads, grid in ((4099, 77, 32), (16384, 0, GRID), (65536, 0, GRID)):
        pos = shell(torch, n, masses=True, pads=pads)
        cap = auto_capacity(int(p3m.p3m_max_occupancy(pos, grid=grid)))
        plain = reference.p3m_short_range(pos, soft, grid=grid, capacity=cap)
        for blk in ck.P3M_BLKS:
            acc, _ = ck.p3m_short_range_cuda(pos, soft, grid=grid, capacity=cap, blk=blk)
            again, _ = ck.p3m_short_range_cuda(pos, soft, grid=grid, capacity=cap, blk=blk)
            torch.cuda.synchronize()
            tables = p3m.pair_tables(pos, soft, grid=grid, capacity=cap, blk=blk)
            fused = p3m.short_range_from_tables(ck.p3m_sr_launch(tables, contracted), tables)
            ratio, ratio_c = (((a - plain).abs() / (2e-4 + 1e-4 * plain.abs())).max().item()
                              for a in (acc, fused))
            print(f"check N={n + pads} G={grid} capacity {cap} blk {blk}: largest error over "
                  f"the bound {ratio:.3f} (contracted form {ratio_c:.3f}), repeat bit-equal "
                  f"{torch.equal(acc, again)}")
            if ratio > 1.0 or not torch.equal(acc, again):
                raise RuntimeError("the pair kernel disagrees with its plain version")


def timed_states(torch) -> list:
    """[(name, pos, capacity)] of the three timed states (see the module's
    docstring)."""
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.ops import p3m

    out = []
    for n in (65536, N_BIG):
        pos = shell(torch, n)
        out.append((f"shell N={n}", pos, auto_capacity(int(p3m.p3m_max_occupancy(pos,
                                                                                  grid=GRID)))))
    system = Compute(num_bodies=N_BIG, device="cuda", kernel="p3m", p3m_capacity=N_BIG,
                     log=lambda s: None).system
    occ = [int(p3m.p3m_max_occupancy(system.state[0], grid=GRID))]
    for _ in range(4):
        system.update()
        occ.append(int(p3m.p3m_max_occupancy(system.state[0], grid=GRID)))
    out.append((f"demo-0 N={N_BIG} after 4 Euler steps (occupancy {occ})",
                system.state[0].clone(), auto_capacity(max(occ))))
    return out


def time_kernel(torch, tables, reps) -> float:
    """ms of one pair kernel launch over `tables`, after one warm-up."""
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.utils.timing import elapsed_ms

    ck.p3m_sr_pairs_cuda(tables)
    return elapsed_ms(lambda: [ck.p3m_sr_pairs_cuda(tables) for _ in range(reps)],
                      "cuda") / reps


def child(other: str, states_file: str, out_file: str) -> int:
    """Time `other`'s p3m_sr_pairs_cuda and pair_tables on the saved states."""
    sys.path.insert(0, other)
    import torch

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import p3m
    from nbody_tpu_torch.utils.timing import elapsed_ms

    if not pathlib.Path(p3m.__file__).is_relative_to(other):
        raise RuntimeError(f"imported {p3m.__file__}, not {other}'s package")
    soft = DEMO_PARAMS[0].softening
    out = {}
    for name, pos, cap in torch.load(states_file):
        pos = pos.to("cuda")
        for blk in ck.P3M_BLKS:
            tables = p3m.pair_tables(pos, soft, grid=GRID, capacity=cap, blk=blk)
            reps = REPS[pos.shape[0]]
            out[f"{name}|{blk}|kernel"] = time_kernel(torch, tables, reps)
            out[f"{name}|{blk}|tables"] = elapsed_ms(lambda: [p3m.pair_tables(
                pos, soft, grid=GRID, capacity=cap, blk=blk) for _ in range(reps)],
                "cuda") / reps
            del tables
    pathlib.Path(out_file).write_text(json.dumps(out))
    return 0


def times(torch, contracted, regs, other) -> None:
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import p3m
    from nbody_tpu_torch.utils.timing import elapsed_ms

    soft = DEMO_PARAMS[0].softening
    states = timed_states(torch)
    work = {}
    for name, pos, cap in states:
        tables = p3m.pair_tables(pos, soft, grid=GRID, capacity=cap, blk=512)
        w = work[name] = p3m.pair_work(tables)
        print(f"{name}, G={GRID}, capacity {cap}: {w['clusters']} i-clusters, {w['items']} "
              f"items (chunks of up to {w['chunk']}), {w['cluster_pairs']:.4e} cluster pairs, "
              f"{w['boxed']:.4e} past the box test, {w['tested']:.4e} row pairs tested, "
              f"{w['termed']:.4e} termed, {w['candidates']:.4e} candidate and {w['near']:.4e} "
              f"near pairs; pruning efficiency (termed / near) "
              f"{w['termed'] / max(1, w['near']):.3f}; overflow {int(tables.overflow)}")
        del tables
    ms = collections.defaultdict(list)
    with tempfile.TemporaryDirectory() as tmp:
        saved = pathlib.Path(tmp) / "states.pt"
        torch.save([(name, pos.cpu(), cap) for name, pos, cap in states], saved)
        for turn in (("other", "this", "this", "other") if other else ("this", "this")):
            if turn == "other":
                res = pathlib.Path(tmp) / "other.json"
                subprocess.run([sys.executable, __file__, "--child", other, str(saved),
                                str(res)], check=True, timeout=1800)
                for key, t in json.loads(res.read_text()).items():
                    name, blk, what = key.rsplit("|", 2)
                    ms[(name, int(blk), f"other {what}")].append(t)
                continue
            for name, pos, cap in states:
                reps = REPS[pos.shape[0]]
                for blk in ck.P3M_BLKS:
                    tables = p3m.pair_tables(pos, soft, grid=GRID, capacity=cap, blk=blk)
                    fns = {"contracted": lambda: ck.p3m_sr_launch(tables, contracted),
                           "tables": lambda: p3m.pair_tables(pos, soft, grid=GRID,
                                                             capacity=cap, blk=blk),
                           "accel": lambda: p3m.p3m_accel(pos, soft, grid=GRID, capacity=cap,
                                                          blk=blk)}
                    ms[(name, blk, "kernel")].append(time_kernel(torch, tables, reps))
                    for what, fn in fns.items():
                        fn()
                        ms[(name, blk, what)].append(
                            elapsed_ms(lambda: [fn() for _ in range(reps)], "cuda") / reps)
                    del tables
    for name, pos, cap in states:
        w = work[name]
        bound = 2.0 * NEAR_INSTR * w["near"] / PEAK_FP32_FLOPS * 1e3
        for blk in ck.P3M_BLKS:
            k = ms[(name, blk, "kernel")]
            line = (f"{name} capacity {cap} blk {blk} ({regs.get(blk, '?')} registers): kernel "
                    f"{min(k):.3f} ms (rounds {', '.join(f'{t:.3f}' for t in k)}), contracted "
                    f"{min(ms[(name, blk, 'contracted')]):.3f} ms; bound {bound:.3f} ms "
                    f"({bound / min(k):.1%}); tables {min(ms[(name, blk, 'tables')]):.3f} ms; "
                    f"whole p3m_accel {min(ms[(name, blk, 'accel')]):.3f} ms; default blk "
                    f"{p3m.p3m_kernel_blk(cap)}")
            if other:
                o = ms[(name, blk, "other kernel")]
                line += (f"; {other}'s kernel {min(o):.3f} ms (rounds "
                         f"{', '.join(f'{t:.3f}' for t in o)}), {min(o) / min(k):.2f}x, its "
                         f"tables {min(ms[(name, blk, 'other tables')]):.3f} ms")
            print(line)


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    if "--child" in sys.argv:
        i = sys.argv.index("--child")
        return child(*sys.argv[i + 1:i + 4])
    import torch

    if not torch.cuda.is_available():
        print("torch_p3m_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    other = None
    if "--against" in sys.argv:
        other = str(pathlib.Path(sys.argv[sys.argv.index("--against") + 1]).resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        regs = ptxas_report(tmp)
        sass_mix(tmp)
        contracted = contracted_library(tmp)
        checks(torch, contracted)
        if "--quick" not in sys.argv:
            times(torch, contracted, regs, other)
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
