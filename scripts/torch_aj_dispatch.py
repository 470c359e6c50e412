#!/usr/bin/env python3
"""Measure the accel + jerk kernels of nbody_tpu_torch on the card, to fix
``aj_sym_default_dispatch`` and the one-sided kernel's j-split
(``aj_splits``, ops/cuda_kernel.py) and the Hermite row of
``AUTO_VARIANT_CUDA`` (models/body_system.py).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_aj_dispatch.py [--quick] [--against DIR] [--no-sweep]

First it prints what ptxas says of every kernel of
csrc/symmetric_aj_kernels.cu and csrc/nbody_kernels.cu (registers, spills,
shared memory) and the SASS (cuobjdump) of the accel + jerk kernels' walk
(each-pair-once and one-sided): the instructions of the innermost loop that
holds the rsqrt, by class, over the pairs it covers (one MUFU.RSQ a pair).
It checks on the card that the kernels' rsqrt (PTX rsqrt.approx.ftz.f32)
gives the bits of rsqrtf for every positive normal float. Then it holds the
accel + jerk kernels (one-sided, triangle, rectangle) and the potential
kernel to their plain versions at small ragged shapes for every tile, with
masses from [0.5, 2] and a random vel.w, and the triangle at softening 0:
acceleration and jerk each within 1e-4 * max + 1e-4, the bound of
tests/test_pallas.py:76. The one-sided kernel is held at odd M and N, N
below a stage and not a multiple of it, with one j-chunk and several, at
blocks 32 to 1024, its repeats and its blocks bit-equal. --quick stops
there.

--against DIR builds DIR/csrc/symmetric_aj_kernels.cu and
DIR/csrc/nbody_kernels.cu (another checkout's kernels, with their shared
headers) with the library's nvcc flags into libraries of their own,
launched through the port's wrappers (``cuda_kernel._aj_sym(..., lib=)``,
``cuda_kernel._accel_jerk(..., lib=)``; a build without the j-split entry
point runs one chunk, as it was written), prints their ptxas lines and SASS
counts, holds them to plain, and times them in turns with this checkout's
kernels (DIR, this, this, DIR) at the main path's shapes: the triangle at
N = 65536 and 45056, the rectangle (45056, 45056), the composition at
65536 and 135168 under this checkout's dispatch, one Hermite step
(``reference.nbody_step_hermite``) on each composition; the one-sided
kernel at (M, N) = (65536, 65536), (16384, 65536), (16384, 16384) (a
four-card allgather and ring hop) and (135168, 135168), and a vpu Hermite
step at 65536 and 135168; sampling nvidia-smi's SM clock and power beside
each timed loop. Then, unless --no-sweep, it times at N = 65536, 135168
and 262144 (shell ICs, demo-0 softening) the one-sided accel + jerk kernel
per block size and the each-pair-once composition per tile and block cap,
beside the potential kernel, and the one-sided kernel's j-split at the
one-sided shapes above per fill (blocks the rule aims at) and block size:
CUDA events over `reps` calls after one warm-up call, two rounds taken in
turns. Prints one line per measurement and the nvidia-smi name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import sys
import tempfile
import threading

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

AJ_SOURCE = "symmetric_aj_kernels.cu"
ONE_SIDED_SOURCE = "nbody_kernels.cu"
# (label, a substring of the mangled name) of the kernels whose walk is counted
WALKS = (("tri", "aj_sym_tri_kernelILi"), ("cross", "aj_sym_cross_kernelILi"))
ONE_SIDED_WALKS = (("one-sided", "17accel_jerk_kernel"),)
# the one-sided kernel's timed shapes (M, N): one card at the main N, a
# four-card allgather or ring hop at N = 65536 (M = N / 4 under all N, and
# under one shard), and the CLI's default N on an H100
ONE_SIDED_SHAPES = ((65536, 65536), (16384, 65536), (16384, 16384), (135168, 135168))
SMI_CLOCKS = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
              "--format=csv,noheader,nounits"]


def ptxas_report() -> None:
    """Compile each source once more with -Xptxas -v and print what ptxas
    says of each kernel."""
    from nbody_tpu_torch.ops import _build

    for src in (AJ_SOURCE, "nbody_kernels.cu"):
        for line in _build.ptxas_lines(src):
            print(line)


def walk_counts(label: str, source, walks=WALKS) -> dict:
    """Print the ptxas lines of `source` and, for each kernel of `walks`,
    its walk's SASS count; returns {kernel name: instructions a pair of
    its cheapest walk (the off-diagonal one)}."""
    from nbody_tpu_torch.ops import _build

    usage, sass = _build.sass_of(source)
    for line in _build.ptxas_lines(source, label=label, usage=usage):
        print(line)
    names = _build.demangle(usage)
    per_pair = {}
    for _, key in walks:
        for loop in _build.sass_loops(sass, key):
            pairs = loop["pairs"]
            mix = ", ".join(f"{k} {v}" for k, v in sorted(loop["mix"].items(),
                                                          key=lambda kv: -kv[1]))
            ops = ", ".join(f"{k} {v}" for k, v in sorted(loop["ops"].items(),
                                                          key=lambda kv: -kv[1])[:14])
            name = names.get(loop["function"], loop["function"])
            slots = loop["instructions"] / pairs
            print(f"sass {label}: {name}: walk loop of {loop['instructions']} instructions "
                  f"over {pairs} pairs = {slots:.2f} a pair; by class: {mix}; "
                  f"per pair: " + ", ".join(f"{k} {v / pairs:.2f}" for k, v in
                                            sorted(loop["mix"].items())) + f"; ops: {ops}")
            per_pair[name] = min(per_pair.get(name, slots), slots)
    if not per_pair:
        print(f"sass {label}: no walk loop found")
    return per_pair


RSQRT_CHECK = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void rsqrt_check(unsigned long long* bad, unsigned long long* first) {
  const uint32_t lo = 0x00800000u, hi = 0x7f800000u;  // the positive normal floats
  for (uint64_t b = lo + blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; b < hi;
       b += (uint64_t)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((uint32_t)b);
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    if (__float_as_uint(y) != __float_as_uint(rsqrtf(x))) {
      atomicAdd(bad, 1ull);  // a count of a check, no sum of the kernels
      atomicMin(first, (unsigned long long)b);
    }
  }
}
extern "C" int run_rsqrt_check(unsigned long long* out) {
  unsigned long long* d;
  if (cudaMalloc(&d, 16) != cudaSuccess) return 1;
  const unsigned long long init[2] = {0ull, ~0ull};
  cudaMemcpy(d, init, 16, cudaMemcpyHostToDevice);
  rsqrt_check<<<1056, 256>>>(d, d + 1);
  cudaError_t err = cudaMemcpy(out, d, 16, cudaMemcpyDeviceToHost);
  cudaFree(d);
  return err == cudaSuccess ? 0 : 2;
}
"""


def build_so(source: pathlib.Path, tmp: pathlib.Path) -> ctypes.CDLL:
    """nvcc `source` with the library's flags into a shared library under
    `tmp` and load it."""
    from nbody_tpu_torch.ops import _build

    out = tmp / f"lib{source.stem}.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(source)], check=True, timeout=900)
    return ctypes.CDLL(str(out))


def against_library(source: pathlib.Path, tmp: pathlib.Path) -> ctypes.CDLL:
    """Another checkout's csrc/symmetric_aj_kernels.cu or csrc/nbody_kernels.cu,
    built on its own, with the C signatures the port's wrappers call
    (``ops/cuda_kernel._aj_sym``, ``_accel_jerk``)."""
    from nbody_tpu_torch.ops import _build

    lib = build_so(source, tmp)
    if hasattr(lib, "nbody_aj_sym_f32"):
        _build.declare_aj_sym(lib)
    _build.declare_accel_jerk(lib)
    # the library's error text comes from another source: name the code only
    lib.nbody_error_string = lambda err: f"code {err}".encode()
    return lib


def rsqrt_check(tmp: pathlib.Path) -> bool:
    src = tmp / "rsqrt_check.cu"
    src.write_text(RSQRT_CHECK)
    lib = build_so(src, tmp)
    out = (ctypes.c_ulonglong * 2)()
    rc = lib.run_rsqrt_check(out)
    bad, first = out[0], out[1]
    where = f" (first at bits 0x{first:08x})" if bad else ""
    print(f"rsqrt check: rsqrt.approx.ftz.f32 against rsqrtf over every positive normal "
          f"float: {bad} differ{where} (rc {rc})")
    return rc == 0 and bad == 0


class Clocks:
    """nvidia-smi's SM clock (MHz) and power draw (W) sampled every 0.2 s
    in a thread while the block runs."""

    def __enter__(self):
        self.samples, self._stop = [], threading.Event()

        def run():
            while not self._stop.is_set():
                out = subprocess.run(SMI_CLOCKS, capture_output=True, text=True).stdout
                try:
                    clk, draw, _ = (float(x) for x in out.strip().splitlines()[0].split(","))
                    self.samples.append((clk, draw))
                except (ValueError, IndexError):
                    pass
                self._stop.wait(0.2)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def summary(self) -> str:
        if not self.samples:
            return "no nvidia-smi samples"
        clk = [c for c, _ in self.samples]
        draw = [d for _, d in self.samples]
        return (f"SM clock {min(clk):.0f}-{max(clk):.0f} MHz (median "
                f"{statistics.median(clk):.0f}), power {min(draw):.1f}-{max(draw):.1f} W, "
                f"{len(clk)} samples")

    def median_mhz(self) -> float | None:
        return statistics.median(c for c, _ in self.samples) if self.samples else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="build, count and check only")
    ap.add_argument("--against", type=pathlib.Path, default=None,
                    help="a checkout whose csrc/symmetric_aj_kernels.cu is timed in turns")
    ap.add_argument("--no-sweep", action="store_true", help="skip the tile and cap sweep")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        return run(args, pathlib.Path(tmp))


def run(args, tmp: pathlib.Path) -> int:

    import numpy as np
    import torch

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
    from nbody_tpu_torch.ops import energy, reference
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.utils.timing import card_line, elapsed_ms

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = card_line()
    print(f"card: {smi}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptxas_report()
    slots = {"this": walk_counts("this", AJ_SOURCE)}
    one_slots = {"this": walk_counts("this", ONE_SIDED_SOURCE, ONE_SIDED_WALKS)}
    other = other_one = None
    if args.against is not None:
        args.against = args.against.resolve()
        csrc = args.against / "nbody_tpu_torch" / "csrc"
        if not csrc.is_dir():
            csrc = args.against / "csrc"
        slots["against"] = walk_counts("against", csrc / AJ_SOURCE)
        one_slots["against"] = walk_counts("against", csrc / ONE_SIDED_SOURCE, ONE_SIDED_WALKS)
        other = against_library(csrc / AJ_SOURCE, tmp)
        other_one = against_library(csrc / ONE_SIDED_SOURCE, tmp)
    ok = rsqrt_check(tmp)

    dev = torch.device("cuda", 0)
    demo = DEMO_PARAMS[0]
    soft = demo.softening

    def state(n, seed=42, masses=False):
        scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
        pos, vel = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed)
        if masses:
            rng = np.random.default_rng(7)
            pos[:, 3] = rng.uniform(0.5, 2.0, n)
            vel[:, 3] = rng.standard_normal(n)
        return torch.tensor(pos, device=dev), torch.tensor(vel, device=dev)

    def held(what, got, want, names=("acc", "jerk", "react acc", "react jerk")):
        nonlocal ok
        for name, g, w in zip(names, got, want):
            tol = 1e-4 * w.abs().max().item() + 1e-4
            e = (g - w).abs().max().item()
            ok &= bool(e <= tol and torch.isfinite(g).all())
            print(f"check {what} {name}: max|d|={e:.3e} tol={tol:.3e}")

    libs = {"this": None, **({"against": other} if other else {})}
    for label, lib in libs.items():
        def tri(p, v, s, t, lib=lib):
            return ck._aj_sym(p, v, s, t, None, lib=lib)

        def cross(pi, vi, pj, vj, s, t, lib=lib):
            return ck._aj_sym_cross(pi, vi, pj, vj, s, t, None, lib=lib)

        for tile in ck.SYM_TILES:
            for n in (1, 33, 1000, 4099):
                p, v = state(n, masses=True)
                got = tri(p, v, soft, tile)
                same = all(torch.equal(a, b) for a, b in zip(got, tri(p, v, soft, tile)))
                ok &= same
                held(f"{label} tri tile={tile} N={n} (repeat bit-equal {same})", got,
                     reference.compute_accel_jerk_symmetric(p, v, soft))
            # softening 0: the diagonal's self pair must add exactly 0
            p, v = state(1000, masses=True)
            held(f"{label} tri tile={tile} N=1000 softening 0", tri(p, v, 0.0, tile),
                 reference.compute_accel_jerk_symmetric(p, v, 0.0))
            for bi, bj in ((777, 4099), (33, 1), (1, 33), (4099, 777)):
                (pi, vi), (pj, vj) = state(bi, seed=3, masses=True), state(bj, masses=True)
                held(f"{label} cross tile={tile} ({bi},{bj})", cross(pi, vi, pj, vj, soft, tile),
                     reference.aj_sym_cross(pi, vi, pj, vj, soft))
    # the one-sided kernel: odd M and N, N below a stage and not a multiple
    # of it, one j-chunk (1), the rule's (None) and three; every block-size
    # class (rows a thread: 4 up to 512 threads, 1 above); the same S gives
    # the same bits at every block and on a repeat
    for label, lib in {"this": None, **({"against": other_one} if other_one else {})}.items():
        split = lib is None or hasattr(lib, "nbody_accel_jerk_split_f32")
        for m, n in ((1000, 1000), (777, 4099), (4099, 777), (1, 33), (33, 1), (1025, 255),
                     (4099, 65537)):
            pi, vi = state(m, seed=3, masses=True)
            pj, vj = state(n, masses=True)
            want = reference.compute_accel_jerk_vs(pi, vi, pj, vj, soft)
            for sp in ((None, 1, 3) if split else (1,)):
                first = None
                for bs in (32, 128, 256, 512, 1024):
                    got = ck._accel_jerk(pi, vi, pj, vj, soft, bs, splits=sp, lib=lib)
                    again = ck._accel_jerk(pi, vi, pj, vj, soft, bs, splits=sp, lib=lib)
                    first = got if first is None else first
                    same = all(torch.equal(a, b) for a, b in zip(got, again)) and all(
                        torch.equal(a, b) for a, b in zip(got, first))
                    ok &= same
                    held(f"{label} one-sided ({m},{n}) splits="
                         f"{ck.aj_splits(m, n) if sp is None else sp} block={bs} (repeat and "
                         f"block 32 bit-equal {same})", got, want)
    for bs in (128, 256):
        for n in (1, 1000, 4099):
            p, _ = state(n, masses=True)
            got = ck.potential_energy_per_row_cuda(p, soft, block_size=bs)
            held(f"potential block={bs} N={n}", (got,),
                 (energy.potential_energy_per_row(p, soft),), names=("per-row sums",))
    torch.cuda.synchronize()
    print(f"checks {'passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    if args.quick:
        return 0

    reps = 5
    cap, tile = ck.aj_sym_default_dispatch(135168)

    def turns(runs: dict, pairs: dict, rounds: int = 2) -> None:
        """Time each run in turns, `rounds` times each way round (A B B A),
        with the clock sampled beside; print ms and the issue-bound time of
        its SASS count at the sampled clock."""
        for fn in runs.values():
            fn()
        times = {k: [] for k in runs}
        with Clocks() as clocks:
            for r in range(rounds):
                order = list(runs) if r % 2 == 0 else list(reversed(runs))
                for k in order:
                    times[k].append(elapsed_ms(lambda fn=runs[k]: [fn() for _ in range(reps)],
                                               dev) / reps)
        mhz = clocks.median_mhz()
        for k, ts in times.items():
            extra = ""
            if k in pairs and mhz:
                n_pairs, per_pair = pairs[k]
                if per_pair:
                    issue = n_pairs * per_pair / 32 / (sms * 4 * mhz * 1e6) * 1e3
                    extra = f"; issue bound {issue:.3f} ms at {per_pair:.2f} a pair, {mhz:.0f} MHz"
            print(f"{k}: {min(ts):.4f} ms per call (rounds: " + ", ".join(f"{t:.4f}" for t in ts)
                  + f"){extra} [{smi}]")
        print(f"  clocks beside it: {clocks.summary()}")

    def per_pair_of(label, kind):
        # the walk's SASS count of this label's ROWS-4 kernel of that kind;
        # of the one-sided kernel, its cheapest walk (at blocks up to 512)
        if kind == "one":
            return min(one_slots.get(label, {}).values(), default=None)
        keys = (f"aj_sym_{kind}_kernel<(int)4>", f"aj_sym_{kind}_kernelILi4E")
        return next((v for k, v in slots.get(label, {}).items() if any(x in k for x in keys)),
                    None)

    p65, v65 = state(65536)
    p135, v135 = state(135168)
    _, blk = reference.sym_blocking(135168, tile, cap)
    p45, v45 = p135[:blk], v135[:blk]
    pj45, vj45 = p135[blk:2 * blk], v135[blk:2 * blk]
    dt = demo.time_step
    pairs_tri = {65536: 65536 * 65535 / 2, blk: blk * (blk - 1) / 2}

    def runs_of(label, lib, t):
        def tri(p, v):
            return ck._aj_sym(p, v, soft, t, None, lib=lib)

        def cross():
            return ck._aj_sym_cross(p45, v45, pj45, vj45, soft, t, None, lib=lib)

        def comp(p, v):
            return reference.compose_symmetric_blocked(
                (p, v), soft, block_cap=cap, tile_j=t,
                triangle=lambda a, b, s: ck._aj_sym(a, b, s, t, None, lib=lib),
                cross=lambda a, b, c, d, s: ck._aj_sym_cross(a, b, c, d, s, t, None, lib=lib))

        return {
            f"{label} tri N=65536 tile={t}": (lambda: tri(p65, v65), (pairs_tri[65536], "tri")),
            f"{label} tri N={blk} tile={t}": (lambda: tri(p45, v45), (pairs_tri[blk], "tri")),
            f"{label} cross ({blk},{blk}) tile={t}": (cross, (blk * blk, "cross")),
            f"{label} composition N=135168 cap={cap} tile={t}": (lambda: comp(p135, v135), None),
            f"{label} Hermite step N=65536": (lambda: reference.nbody_step_hermite(
                p65, v65, dt, soft, 1.0, accel_jerk_fn=lambda a, b: comp(a, b)), None),
            f"{label} Hermite step N=135168": (lambda: reference.nbody_step_hermite(
                p135, v135, dt, soft, 1.0, accel_jerk_fn=lambda a, b: comp(a, b)), None),
        }

    def timed_turns(groups):
        # groups: [(label, {name: (fn, pairs)})]; the same shape of each group in turns
        names = [list(g.keys()) for _, g in groups]
        for idx in range(len(names[0])):
            runs, pairs = {}, {}
            for (label, g), ns in zip(groups, names):
                fn, pr = g[ns[idx]]
                runs[ns[idx]] = fn
                if pr is not None:
                    pairs[ns[idx]] = (pr[0], per_pair_of(label, pr[1]))
            turns(runs, pairs)

    def one_sided_runs(label, lib):
        # a build without the split entry point runs one chunk, as written
        sp = None if lib is None or hasattr(lib, "nbody_accel_jerk_split_f32") else 1

        def aj(a, b, c, d):
            return ck._accel_jerk(a, b, c, d, soft, ck.DEFAULT_BLOCK_SIZE, splits=sp, lib=lib)

        runs = {}
        for m, n in ONE_SIDED_SHAPES:
            pj, vj = (p65, v65) if n == 65536 else (p135, v135) if n == 135168 else (
                p65[:n], v65[:n])
            pi, vi = pj[:m], vj[:m]
            runs[f"{label} one-sided ({m},{n}) block=256"] = (
                lambda pi=pi, vi=vi, pj=pj, vj=vj: aj(pi, vi, pj, vj), (m * n, "one"))
        for n, (p, v) in ((65536, (p65, v65)), (135168, (p135, v135))):
            runs[f"{label} vpu Hermite step N={n}"] = (
                lambda p=p, v=v: reference.nbody_step_hermite(
                    p, v, dt, soft, 1.0, accel_jerk_fn=lambda a, b: aj(a, b, a, b)), None)
        return runs

    if other is not None:
        timed_turns([("against", runs_of("against", other, 512)),
                     ("this", runs_of("this", None, tile))])
        timed_turns([("against", one_sided_runs("against", other_one)),
                     ("this", one_sided_runs("this", None))])
    if args.no_sweep:
        return 0

    # the one-sided kernel's j-split: S by the rule at each fill, per block
    # size, at each one-sided shape
    for m, n in ONE_SIDED_SHAPES:
        pj, vj = (p65, v65) if n == 65536 else (p135, v135) if n == 135168 else (
            p65[:n], v65[:n])
        pi, vi = pj[:m], vj[:m]
        runs = {}
        for bs in (128, 256, 512):
            for fill in (264, 528, 1056, 2112, 4224):
                sp = ck.one_sided_splits(m, n, tile_i=ck.AJ_TILE_I, stage=ck.AJ_STAGE,
                                         fill=fill)
                key = f"one-sided ({m},{n}) block={bs} splits={sp}"
                runs.setdefault(key, (lambda bs=bs, sp=sp: ck._accel_jerk(
                    pi, vi, pj, vj, soft, bs, splits=sp), (m * n, "one")))
        turns({k: fn for k, (fn, _) in runs.items()},
              {k: (pr[0], per_pair_of("this", pr[1])) for k, (_, pr) in runs.items()},
              rounds=1)
    del p45, v45, pj45, vj45

    for n in (65536, 135168, 262144):
        p, v = state(n)
        runs = {}
        for bs in (128, 256, 512):
            if n <= 135168 or bs == 256:
                runs[f"one-sided accel+jerk block={bs}"] = (
                    lambda bs=bs: ck.compute_accel_jerk_cuda(p, v, p, v, soft, block_size=bs))
        caps = sorted({n, n // 2, 131072, 98304, 65536, 32768})
        for t in ck.SYM_TILES:
            for c in caps:
                if c > n or (t < 512 and n > 135168):
                    continue
                runs[f"sym accel+jerk tile={t} cap={c}"] = (
                    lambda t=t, c=c: ck.compute_accel_jerk_symmetric_blocked_cuda(
                        p, v, soft, block_cap=c, tile=t))
        if n == 65536:
            for bs in (128, 256, 512):
                runs[f"potential block={bs}"] = (
                    lambda bs=bs: ck.potential_energy_per_row_cuda(p, soft, block_size=bs))
        times = {k: [] for k in runs}
        for fn in runs.values():
            fn()
        for _ in range(2):  # two rounds, in turns
            for k, fn in runs.items():
                times[k].append(elapsed_ms(lambda fn=fn: [fn() for _ in range(reps)], dev) / reps)
        for k, ts in times.items():
            print(f"N={n} {k}: {min(ts):.4f} ms per call (rounds: "
                  + ", ".join(f"{t:.4f}" for t in ts) + f") [{smi}]")
        del p, v, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
