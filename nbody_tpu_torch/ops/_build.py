"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

The library is built from ``nbody_tpu_torch/csrc/*.cu`` at the first CUDA
launch, into ``build/nbody_tpu_torch/`` beside the package, under a name
that carries a hash of the sources, their shared headers and the flags, so
an edited source builds anew. Each source is compiled by its own nvcc, all started
together, and the objects are linked into one library. The build writes a
temporary file and renames it into place, so a process that has an older
library mapped keeps a valid file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
SOURCES = (CSRC / "nbody_kernels.cu", CSRC / "symmetric_kernels.cu",
           CSRC / "symmetric_aj_kernels.cu", CSRC / "ds_kernels.cu",
           CSRC / "ds_symmetric_kernels.cu", CSRC / "ds_aj_kernels.cu",
           CSRC / "ds_symmetric_aj_kernels.cu", CSRC / "mxu_kernels.cu",
           CSRC / "p3m_kernels.cu", CSRC / "ring_kernels.cu", CSRC / "f64_kernels.cu")
HEADERS = (CSRC / "allpairs_common.cuh", CSRC / "sym_common.cuh", CSRC / "ds_common.cuh",
           CSRC / "ds_sym_common.cuh")
BUILD_DIR = PKG.parent / "build" / "nbody_tpu_torch"

# sm_90a, not sm_90: the Hopper-only instructions (wgmma, setmaxnreg) that
# later kernels use exist only for the 'a' target
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc, else nvcc on PATH. Raises
    RuntimeError naming what is missing."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        nvcc = pathlib.Path(cuda_home) / "bin" / "nvcc"
        if nvcc.is_file():
            return str(nvcc)
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError(
        "nvcc (the CUDA toolkit's compiler) was not found: set CUDA_HOME to "
        "the toolkit's root or put nvcc on PATH; the CUDA kernels of "
        "nbody_tpu_torch are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libnbody_kernels_{_digest()}.so"


def nvcc_commands(nvcc: str, out: pathlib.Path) -> tuple[list[list[str]], list[str]]:
    """(one compile command per source, the link command) that build `out`;
    the objects go beside it."""
    objs = [out.with_name(f"{out.name}.{src.stem}.o") for src in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(SOURCES, objs)]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), *(str(o) for o in objs)]
    return compiles, link


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {p.returncode}): {' '.join(cmd)}\n{text}")


def build() -> pathlib.Path:
    """Build the library if no library of these sources exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    compiles, link = nvcc_commands(nvcc, tmp)
    objs = [pathlib.Path(c[c.index("-o") + 1]) for c in compiles]
    try:
        _run_all(compiles)
        _run_all([link])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return out


def parse_ptxas(text: str) -> dict:
    """{mangled name: {"registers", "smem", "stack", "spill_stores",
    "spill_loads"}} from what ``-Xptxas -v`` prints, the last four in bytes."""
    usage, entry, props, frame = {}, None, None, {}
    # a kernel's lines come as: Compiling entry function 'K'; Function
    # properties for K (and for any callee it did not inline); its frame
    # line; Used ... registers
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry, frame = line.split("'")[1], {}
        elif "Function properties for" in line:
            props = line.rsplit(" ", 1)[1]
        elif (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                             r"(\d+) bytes spill loads", line)) and props == entry:
            frame = dict(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            usage[entry] = {"registers": int(m.group(1)),
                            "smem": int(smem.group(1)) if smem else 0,
                            "stack": 0, "spill_stores": 0, "spill_loads": 0, **frame}
            entry = None
    return usage


def ptxas_usage(source) -> dict:
    """What ptxas says of each kernel of `source` (a file name in csrc, or a
    path), compiled once more with -Xptxas -v and the library's flags
    (``parse_ptxas``)."""
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.devnull,
                           str(CSRC / source)], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return parse_ptxas(proc.stderr)


def sass_of(source) -> tuple[dict, str]:
    """(``ptxas_usage``, the SASS as ``cuobjdump -sass`` prints it) of
    `source` compiled once more to a cubin with the library's flags: one
    nvcc and one cuobjdump."""
    import tempfile

    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cubin = pathlib.Path(tmp) / "k.cubin"
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o",
                               str(cubin), str(CSRC / source)], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        sass = subprocess.run([str(pathlib.Path(nvcc).with_name("cuobjdump")), "-sass",
                               str(cubin)], capture_output=True, text=True, check=True,
                              timeout=120).stdout
    return parse_ptxas(proc.stderr), sass


# SASS opcodes (the part before the first '.') by the unit or kind that issues them
SASS_CLASSES = {
    "fp32": ("FFMA", "FMUL", "FADD", "FMNMX", "FFMA32I", "FMUL32I", "FADD32I", "FSWZADD"),
    "fp64": ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX"),
    "select": ("FSEL", "FSETP", "FSET", "SEL", "FCHK"),
    "mufu": ("MUFU",),
    "shfl": ("SHFL",),
    "shared": ("LDS", "STS", "LDSM"),
    "global": ("LDG", "STG", "LD", "ST", "LDC", "ATOM", "ATOMG", "RED"),
    "local": ("LDL", "STL"),
    "branch": ("BRA", "BAR", "BSSY", "BSYNC", "WARPSYNC", "EXIT", "RET", "CALL", "NOP"),
}


def sass_class(op: str) -> str:
    base = op.split(".")[0]
    for cls, ops in SASS_CLASSES.items():
        if base in ops:
            return cls
    return "uniform" if base.startswith("U") else "integer"


_SASS_INSTR = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_functions(sass: str, key: str) -> dict:
    """{mangled name: [(address, opcode, operands), ...]} of each function of
    `sass` whose mangled name contains `key`."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if key in m.group(1) else None
            if name:
                funcs[name] = []
            continue
        m = _SASS_INSTR.match(line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def sass_loops(sass: str, key: str) -> list:
    """The innermost loops that hold an rsqrt (MUFU.RSQ) of each function of
    `sass` whose mangled name contains `key`: one dict a loop, {"function",
    "span" (the addresses of its first and last instruction),
    "instructions", "pairs" (its MUFU.RSQ, one a pair), "mix" (instructions
    by ``sass_class``), "ops" (by opcode)}. A loop is a backward branch and
    the instructions from its target to it."""
    import collections

    out = []
    for fname, ins in sass_functions(sass, key).items():
        spans = []
        for addr, op, args in ins:
            t = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
            if t and int(t.group(1), 16) <= addr:
                spans.append((int(t.group(1), 16), addr))

        def body(lo, hi, ins=ins):
            return [(op, args) for addr, op, args in ins if lo <= addr <= hi]

        rsq = [sp for sp in spans if any(op.startswith("MUFU.RSQ") for op, _ in body(*sp))]
        for lo, hi in rsq:
            if any((a, b) != (lo, hi) and lo <= a and b <= hi for a, b in rsq):
                continue  # holds an inner rsqrt loop
            b = body(lo, hi)
            out.append({"function": fname, "span": (lo, hi), "instructions": len(b),
                        "pairs": sum(op.startswith("MUFU.RSQ") for op, _ in b),
                        "mix": dict(collections.Counter(sass_class(op) for op, _ in b)),
                        "ops": dict(collections.Counter(op for op, _ in b))})
    return out


def demangle(names) -> dict:
    """{mangled: readable} kernel names by the toolkit's cu++filt; each name
    maps to itself where cu++filt is missing."""
    names = list(names)
    filt = pathlib.Path(find_nvcc()).with_name("cu++filt")
    if not filt.is_file() or not names:
        return {n: n for n in names}
    out = subprocess.run([str(filt), *names], capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()
    return dict(zip(names, (line.replace("(anonymous namespace)::", "") for line in out)))


def ptxas_lines(source, *, label: str | None = None, usage: dict | None = None) -> list:
    """One line per kernel of `source`: its readable name, registers, shared
    memory, stack frame and spills (``ptxas_usage``, or `usage` where the
    caller has it), each line led by `label` (by default the file's name)."""
    usage = ptxas_usage(source) if usage is None else usage
    names = demangle(usage)
    label = label or pathlib.Path(source).name
    return [f"ptxas {label}: {names[k]}: {u['registers']} registers, {u['smem']} bytes smem, "
            f"{u['stack']} bytes stack frame, {u['spill_stores']} bytes spill stores, "
            f"{u['spill_loads']} bytes spill loads" for k, u in usage.items()]


def declare_p3m_sr(lib) -> None:
    """The C signatures of ``nbody_p3m_sr_f32`` and, where `lib` has it,
    ``nbody_p3m_sr_range_f32`` (csrc/p3m_kernels.cu) on `lib`."""
    lib.nbody_p3m_sr_f32.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p]
    lib.nbody_p3m_sr_f32.restype = ctypes.c_int
    if hasattr(lib, "nbody_p3m_sr_range_f32"):
        lib.nbody_p3m_sr_range_f32.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int64] * 4 + [
            ctypes.c_void_p]
        lib.nbody_p3m_sr_range_f32.restype = ctypes.c_int


def declare_sym(lib) -> None:
    """The C signatures of ``nbody_sym_accel_f32``, ``nbody_sym_cross_f32``
    and ``nbody_sym_ablate_f32`` (csrc/symmetric_kernels.cu) on `lib`."""
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.nbody_sym_accel_f32.argtypes = [ptr, i64, f32, i64, ptr, ptr, ptr]
    lib.nbody_sym_accel_f32.restype = ctypes.c_int
    lib.nbody_sym_cross_f32.argtypes = [ptr, i64, ptr, i64, f32, i64, ptr, ptr,
                                        ptr, ptr, ptr]
    lib.nbody_sym_cross_f32.restype = ctypes.c_int
    lib.nbody_sym_ablate_f32.argtypes = [ptr, i64, f32, i64, ctypes.c_int] + [ptr] * 7
    lib.nbody_sym_ablate_f32.restype = ctypes.c_int


def declare_aj_sym(lib) -> None:
    """The C signatures of ``nbody_aj_sym_f32`` and ``nbody_aj_cross_f32``
    (csrc/symmetric_aj_kernels.cu) on `lib`."""
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.nbody_aj_sym_f32.argtypes = [ptr, ptr, i64, f32, i64, ptr, ptr, ptr, ptr]
    lib.nbody_aj_sym_f32.restype = ctypes.c_int
    lib.nbody_aj_cross_f32.argtypes = [ptr, ptr, i64, ptr, ptr, i64, f32, i64, ptr, ptr,
                                       ptr, ptr, ptr, ptr, ptr]
    lib.nbody_aj_cross_f32.restype = ctypes.c_int


def declare_accel_jerk(lib) -> None:
    """The C signatures of the one-sided accel + jerk entry points that `lib`
    has: ``nbody_accel_jerk_f32`` (csrc/nbody_kernels.cu) and
    ``nbody_ds_accel_jerk`` (csrc/ds_aj_kernels.cu), one j-chunk each, and
    their ``_split`` forms, which take the chunk count and the partials."""
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    sigs = {"nbody_accel_jerk_f32": [ptr] * 6 + [i64, i64, f32, i64, ptr],
            "nbody_accel_jerk_split_f32": [ptr] * 6 + [i64, i64, f32, i64, i64, ptr, ptr],
            "nbody_ds_accel_jerk": [ptr] * 12 + [i64, i64, ptr, i64, ptr],
            "nbody_ds_accel_jerk_split": [ptr] * 12 + [i64, i64, ptr, i64, i64, ptr, ptr]}
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int


def declare_ds_force(lib) -> None:
    """The C signatures of the one-sided ds entry points that `lib` has
    (csrc/ds_kernels.cu): ``nbody_ds_step``, ``nbody_ds_accel`` (one j-chunk
    each) and their ``_split`` forms, which take the chunk count and the
    partials, and ``nbody_ds_leapfrog`` and its ``_split`` form. Each takes
    the (2, 4) scalar block as a host pointer."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    sigs = {"nbody_ds_step": [ptr] * 10 + [i64, i64, ptr, i64, ptr],
            "nbody_ds_step_split": [ptr] * 10 + [i64, i64, ptr, i64, i64, ptr, ptr],
            "nbody_ds_accel": [ptr] * 6 + [i64, i64, ptr, i64, ptr],
            "nbody_ds_accel_split": [ptr] * 6 + [i64, i64, ptr, i64, i64, ptr, ptr],
            "nbody_ds_leapfrog": [ptr] * 12 + [i64, i64, ptr, i64, ptr],
            "nbody_ds_leapfrog_split": [ptr] * 12 + [i64, i64, ptr, i64, i64, ptr, ptr]}
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int


def declare_accel(lib) -> None:
    """The C signatures of the fp32 force entry points that `lib` has
    (csrc/nbody_kernels.cu): ``nbody_accel_f32`` (one j-chunk) and its
    ``_split`` form, which takes the chunk count and the partials."""
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    sigs = {"nbody_accel_f32": [ptr] * 3 + [i64, i64, f32, i64, ptr],
            "nbody_accel_split_f32": [ptr] * 3 + [i64, i64, f32, i64, i64, ptr, ptr]}
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int


def declare_step(lib) -> None:
    """The C signatures of the fused one-sided Euler step entry points that
    `lib` has (csrc/nbody_kernels.cu): ``nbody_step_f32``, its rollout,
    dual-bank and packed-state twins (one j-chunk each), and their
    ``_split`` forms, which take the chunk count and the partials."""
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    step = [ptr] * 5 + [i64, i64, f32, f32, f32, i64]
    step_t = [ptr] * 6 + [i64, f32, f32, f32, i64]
    packed = [ptr] * 4 + [i64, f32, f32, f32, i64]
    split = [i64, ptr]
    sigs = {"nbody_step_f32": step + [ptr], "nbody_step_split_f32": step + split + [ptr],
            "nbody_step_t_f32": step_t + [ptr], "nbody_step_t_split_f32": step_t + split + [ptr],
            "nbody_step_dual_f32": step + [ptr],
            "nbody_step_dual_split_f32": step + split + [ptr],
            "nbody_step_packed_f32": packed + [ptr],
            "nbody_step_packed_split_f32": packed + split + [ptr]}
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int


def declare_mxu(lib) -> None:
    """The C signatures of the tensor-core step entry points that `lib` has
    (csrc/mxu_kernels.cu): ``nbody_mxu_step_f32`` / ``_bf16`` (one j-chunk)
    and their ``_split`` forms, which take the chunk count and the
    partials."""
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    step = [ptr] * 5 + [i64, i64, f32, f32, f32]
    for kind in ("f32", "bf16"):
        for name, argtypes in ((f"nbody_mxu_step_{kind}", step + [ptr]),
                               (f"nbody_mxu_step_split_{kind}", step + [i64, ptr, ptr])):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int


def declare_potential(lib) -> None:
    """The C signatures of the potential entry points that `lib` has
    (csrc/nbody_kernels.cu): ``nbody_potential_f32`` (one j-chunk) and its
    ``_split`` form, which takes the chunk count and the partials."""
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    sigs = {"nbody_potential_f32": [ptr, ptr, i64, f32, i64, ptr],
            "nbody_potential_split_f32": [ptr, ptr, i64, f32, i64, i64, ptr, ptr]}
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int


def declare_f64(lib) -> None:
    """The C signatures of the double-precision entry points that `lib` has
    (csrc/f64_kernels.cu): ``nbody_step_f64``, ``nbody_accel_f64``,
    ``nbody_accel_jerk_f64`` and ``nbody_potential_f64`` (one j-chunk each)
    and their ``_split`` forms, which take the chunk count and the
    partials."""
    ptr, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    split = [i64, ptr]
    step = [ptr] * 5 + [i64, i64, f64, f64, f64, i64]
    accel = [ptr] * 3 + [i64, i64, f64, i64]
    aj = [ptr] * 6 + [i64, i64, f64, i64]
    pot = [ptr, ptr, i64, f64, i64]
    sigs = {"nbody_step_f64": step + [ptr], "nbody_step_split_f64": step + split + [ptr],
            "nbody_accel_f64": accel + [ptr], "nbody_accel_split_f64": accel + split + [ptr],
            "nbody_accel_jerk_f64": aj + [ptr],
            "nbody_accel_jerk_split_f64": aj + split + [ptr],
            "nbody_potential_f64": pot + [ptr],
            "nbody_potential_split_f64": pot + split + [ptr]}
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures (once per process)."""
    lib = ctypes.CDLL(str(build()))
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    declare_step(lib)
    declare_mxu(lib)
    declare_accel(lib)
    declare_sym(lib)
    declare_potential(lib)
    declare_accel_jerk(lib)
    declare_aj_sym(lib)
    declare_f64(lib)
    # the ds entry points take the (2, 4) scalar block as a host pointer
    declare_ds_force(lib)
    lib.nbody_ds_sym_accel.argtypes = [ptr, ptr, i64, ptr, i64, ptr, ptr, ptr, ptr]
    lib.nbody_ds_sym_accel.restype = ctypes.c_int
    lib.nbody_ds_sym_cross.argtypes = [ptr, ptr, i64, ptr, ptr, i64, ptr, i64] + [ptr] * 7
    lib.nbody_ds_sym_cross.restype = ctypes.c_int
    lib.nbody_ds_integrate.argtypes = [ptr] * 6 + [i64] + [ptr] * 4 + [i64, ptr, ptr]
    lib.nbody_ds_integrate.restype = ctypes.c_int
    lib.nbody_ds_aj_sym.argtypes = [ptr] * 4 + [i64, ptr, i64] + [ptr] * 6
    lib.nbody_ds_aj_sym.restype = ctypes.c_int
    lib.nbody_ds_aj_cross.argtypes = ([ptr] * 4 + [i64] + [ptr] * 4 + [i64, ptr, i64]
                                      + [ptr] * 11)
    lib.nbody_ds_aj_cross.restype = ctypes.c_int
    lib.nbody_ds_hermite_predict.argtypes = [ptr] * 8 + [i64] + [ptr] * 4 + [i64, ptr, ptr]
    lib.nbody_ds_hermite_predict.restype = ctypes.c_int
    lib.nbody_ds_hermite_correct.argtypes = [ptr] * 12 + [i64] + [ptr] * 4 + [i64, ptr, ptr]
    lib.nbody_ds_hermite_correct.restype = ctypes.c_int
    declare_p3m_sr(lib)
    lib.nbody_ring_alloc.argtypes = [i64, i64, ctypes.POINTER(ptr)]
    lib.nbody_ring_free.argtypes = [ptr]
    lib.nbody_ring_ipc_handle.argtypes = [ptr, ctypes.c_char_p]
    lib.nbody_ring_ipc_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ptr)]
    lib.nbody_ring_ipc_close.argtypes = [ptr]
    lib.nbody_ring_ipc_handle_bytes.argtypes = []
    lib.nbody_ring_coresident_blocks.argtypes = [i64, ctypes.POINTER(i64)]
    lib.nbody_ring_accel_f32.argtypes = [ctypes.POINTER(i64), i64, i64, i64, i64, i64, f32,
                                         i64, ctypes.c_uint64, i64, ptr]
    lib.nbody_ring_read_error.argtypes = [ptr, i64, i64, ptr, ctypes.POINTER(ctypes.c_uint64)]
    for name in ("nbody_ring_alloc", "nbody_ring_free", "nbody_ring_ipc_handle",
                 "nbody_ring_ipc_open", "nbody_ring_ipc_close", "nbody_ring_ipc_handle_bytes",
                 "nbody_ring_coresident_blocks", "nbody_ring_accel_f32",
                 "nbody_ring_read_error"):
        getattr(lib, name).restype = ctypes.c_int
    lib.nbody_error_string.argtypes = [ctypes.c_int]
    lib.nbody_error_string.restype = ctypes.c_char_p
    return lib
