#!/usr/bin/env python3
"""Measure the P3M short-range pair kernel (csrc/p3m_kernels.cu) of
nbody_tpu_torch on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_p3m_bench.py [--quick]

First it prints what ptxas says of each instantiation of the pair kernel
(registers, spills, shared memory) and the opcode mix of its SASS
(cuobjdump), counted over the whole function, for the kernel and for its
contracted form: the same source built with its unfused intrinsics
(__fmul_rn, __fadd_rn, __fsub_rn) defined as plain operators, which nvcc
fuses into FFMAs. Then it holds the kernel to the plain short-range sum
(ops/reference.py::p3m_short_range) at rtol 1e-4 / atol 2e-4 on shell
states at N = 4099 (77 zero-mass bodies added, G = 32), 16384 and 65536
(G = 64) with masses from [0.5, 2], at each blk (128, 256, 512), with a repeat call
bit-equal, and prints the contracted form's error over the same bound
beside it (not gated: why the kernel rounds its terms as the plain version
does). --quick stops there. Then, on shell states with demo-0 parameters
at G = 64 and the auto-sized capacity, at N = 65536 and 1,048,576, it
prints the capacity, live entries and tiles at each blk and times the
kernel alone (CUDA events over `reps` launches on prebuilt tables, after
one warm-up launch), its contracted form, the tables it reads, and the
whole p3m_accel, two rounds taken in turns, beside the bound of the
function for the data (p3m.pair_work at 67 TFLOP/s: with FMA, 7 FP32
instructions a candidate pair of neighbouring cells, 19 more a pair
within rcut) and at the kernel's unfused rounding (9 / 31).
Prints one line per measurement and the nvidia-smi name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

GRID = 64
# FP32-pipe instructions a pair: the function's with FMA (7 to test a
# candidate pair: d, r2, the compare; 19 more for a pair within rcut: the
# term and the sums), and the kernel's, its terms unfused (9 / 31)
FUNCTION_INSTR, KERNEL_INSTR = (7, 19), (9, 31)
PEAK_FP32_FLOPS = 67e12


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
    lib.nbody_p3m_sr_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    lib.nbody_p3m_sr_f32.restype = ctypes.c_int
    return lib


def contracted_pairs(torch, lib, tables):
    """The contracted form's padded-row sums over `tables` (no counter: it
    is no path's kernel)."""
    out = torch.empty_like(tables.padded)
    err = lib.nbody_p3m_sr_f32(
        tables.padded.data_ptr(), out.data_ptr(), tables.ablk.data_ptr(),
        tables.tpc.data_ptr(), tables.e_cell.data_ptr(), tables.e_t.data_ptr(),
        tables.meta.data_ptr(), tables.e_cell.shape[0], tables.gc, tables.blk,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the contracted pair kernel failed: CUDA error {err}")
    return out


def ptxas_report(tmp: pathlib.Path) -> None:
    from nbody_tpu_torch.ops import _build

    for name, src in (("kernel", _build.CSRC / "p3m_kernels.cu"),
                      ("contracted", contracted_source(tmp))):
        for line in _build.ptxas_lines(src, label=name):
            print(line)


def sass_mix(tmp: pathlib.Path) -> None:
    from nbody_tpu_torch.ops import _build

    for name, src in (("kernel", _build.CSRC / "p3m_kernels.cu"),
                      ("contracted", contracted_source(tmp))):
        sass_mix_of(name, src)


def sass_mix_of(name: str, src: pathlib.Path) -> None:
    from nbody_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cubin = pathlib.Path(tmp) / "k.cubin"
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cubin", "-o", str(cubin),
                        str(src)], check=True, timeout=600)
        sass = subprocess.run([str(pathlib.Path(nvcc).with_name("cuobjdump")), "-sass",
                               str(cubin)], capture_output=True, text=True, check=True,
                              timeout=120).stdout
    kernel, mix = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : \S*p3m_sr_kernelILi(\d+)E", line)
        if m:
            kernel = f"{name} blk {m.group(1)}"
            mix[kernel] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if kernel and m:
            mix[kernel][m.group(1).split(".")[0]] += 1
    for kernel, counts in mix.items():
        top = ", ".join(f"{op} {n}" for op, n in counts.most_common(18))
        print(f"sass {kernel}: {sum(counts.values())} instructions: {top}")


def state(torch, n, *, masses=False, pads=0):
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic

    demo = DEMO_PARAMS[0]
    pos, _ = ic.generate(NBodyConfig.SHELL, n, demo.cluster_scale, demo.velocity_scale, seed=42)
    if masses:
        pos[:, 3] = np.random.default_rng(7).uniform(0.5, 2.0, n)
    pos = np.concatenate([pos, np.zeros((pads, 4), np.float32)])
    return torch.tensor(pos, device="cuda")


def auto_capacity(pos, grid) -> int:
    from nbody_tpu_torch.ops import p3m

    occ = int(p3m.p3m_max_occupancy(pos, grid=grid))
    return max(8, -(-int(occ * 1.5 + 1) // 8) * 8)


def checks(torch, contracted) -> None:
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import p3m, reference

    soft = DEMO_PARAMS[0].softening
    for n, pads, grid in ((4099, 77, 32), (16384, 0, GRID), (65536, 0, GRID)):
        pos = state(torch, n, masses=True, pads=pads)
        cap = auto_capacity(pos, grid)
        plain = reference.p3m_short_range(pos, soft, grid=grid, capacity=cap)
        for blk in ck.P3M_BLKS:
            acc, _ = ck.p3m_short_range_cuda(pos, soft, grid=grid, capacity=cap, blk=blk)
            again, _ = ck.p3m_short_range_cuda(pos, soft, grid=grid, capacity=cap, blk=blk)
            torch.cuda.synchronize()
            tables = p3m.pair_tables(pos, soft, grid=grid, capacity=cap, blk=blk)
            fused = p3m.short_range_from_tables(contracted_pairs(torch, contracted, tables),
                                                tables)
            ratio, ratio_c = (((a - plain).abs() / (2e-4 + 1e-4 * plain.abs())).max().item()
                              for a in (acc, fused))
            print(f"check N={n + pads} G={grid} capacity {cap} blk {blk}: largest error over "
                  f"the bound {ratio:.3f} (contracted form {ratio_c:.3f}), repeat bit-equal "
                  f"{torch.equal(acc, again)}")
            if ratio > 1.0 or not torch.equal(acc, again):
                raise RuntimeError("the pair kernel disagrees with its plain version")


def times(torch, contracted) -> None:
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import p3m
    from nbody_tpu_torch.utils.timing import elapsed_ms

    soft = DEMO_PARAMS[0].softening
    for n in (65536, 1 << 20):
        pos = state(torch, n)
        cap = auto_capacity(pos, GRID)
        reps = 20 if n <= 65536 else 3
        rows = {}
        for blk in ck.P3M_BLKS:
            tables = p3m.pair_tables(pos, soft, grid=GRID, capacity=cap, blk=blk)
            work = p3m.pair_work(tables)
            bound, own = (2.0 * (c * work["candidates"] + f * work["near"])
                          / PEAK_FP32_FLOPS * 1e3 for c, f in (FUNCTION_INSTR, KERNEL_INSTR))
            rows[blk] = (tables, work, bound, own)
        whats = ("kernel", "contracted", "tables", "accel")
        ms = {(blk, what): [] for blk in ck.P3M_BLKS for what in whats}
        for blk in (*ck.P3M_BLKS, *reversed(ck.P3M_BLKS)):
            tables = rows[blk][0]
            fns = {"kernel": lambda: ck.p3m_sr_pairs_cuda(tables),
                   "contracted": lambda: contracted_pairs(torch, contracted, tables),
                   "tables": lambda: p3m.pair_tables(pos, soft, grid=GRID, capacity=cap,
                                                     blk=blk),
                   "accel": lambda: p3m.p3m_accel(pos, soft, grid=GRID, capacity=cap, blk=blk)}
            for what, fn in fns.items():
                fn()
                ms[(blk, what)].append(elapsed_ms(lambda: [fn() for _ in range(reps)],
                                                  "cuda") / reps)
        for blk, (_, work, bound, own) in rows.items():
            k = min(ms[(blk, "kernel")])
            print(f"N={n} G={GRID} capacity {cap} blk {blk}: {work['entries']} live entries, "
                  f"{work['tiles']} tiles ({work['tiles'] * blk * blk:.3e} row pairs), "
                  f"{work['candidates']:.3e} candidate and {work['near']:.3e} near pairs; "
                  f"kernel {k:.3f} ms (rounds "
                  f"{', '.join(f'{t:.3f}' for t in ms[(blk, 'kernel')])}), contracted "
                  f"{min(ms[(blk, 'contracted')]):.3f} ms; bound {bound:.3f} ms "
                  f"({bound / k:.0%}), {own:.3f} ms at the kernel's unfused rounding; "
                  f"tables {min(ms[(blk, 'tables')]):.3f} ms; whole "
                  f"p3m_accel {min(ms[(blk, 'accel')]):.3f} ms; default blk "
                  f"{p3m.p3m_kernel_blk(cap)}")


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    import torch

    if not torch.cuda.is_available():
        print("torch_p3m_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        ptxas_report(tmp)
        sass_mix(tmp)
        contracted = contracted_library(tmp)
        checks(torch, contracted)
        if "--quick" not in sys.argv:
            times(torch, contracted)
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
