"""The walk of the port's each-pair-once force kernels (csrc/symmetric_kernels.cu:
``sym_walk``, run by ``sym_tri_kernel``, ``sym_cross_kernel`` and
``sym_ablate_kernel``) against nbody_tpu.

The kernels cannot run here, so these tests emulate the walk's order in
torch: a block of 128 threads takes a T x T tile pair (T = 128 * ROWS), each
thread ROWS rows; the column tile is staged in sub-tiles of 128 bodies, each
32-body chunk walked in 32 steps in which lane l meets chunk body
(l + k) & 31, with r2 = fma(dz, dz, fma(dy, dy, fma(dx, dx, eps2))) (a fused
multiply-add taken as a product and a sum) and the diagonal's j > i a select;
the reaction sums of a chunk body are carried from lane to lane, so each is
summed over the rows in step order, ROWS rows a step in row order, then the
four warps' sums in warp order once a sub-tile. Each block writes its
partials into the (tiles, 3, N) scratch (on the diagonal action + reaction),
and the slots are added in tile order. That is held to the JAX package's
interpret-mode ``compute_accel_symmetric`` and ``_sym_cross`` within
1e-4 * max|a| + 1e-4 (tests/test_pallas.py:76), the bound chip_smoke.py
holds the kernels to on the card, at odd N, N not a multiple of the tile
and with zero-mass padding. The tests also hold the kernels' constants in
csrc/ to the dispatch table, that the three kernels run one walk, and phase
3e's spill guard over it. The card's bits are held in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.ops import symmetric_kernel as jsym

from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import reference

SOFT = 0.1
CSRC = pathlib.Path(ck.__file__).resolve().parents[1] / "csrc"
THREADS = 128


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The emulation is many small eager ops; beside the suite's other
    worker processes, intra-op threads only wait for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cdiv(a, b):
    return -(-a // b)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _pos(n, seed=4, pad=7):
    """A shell state of n bodies, masses from [0.5, 2], the last `pad` bodies
    zero-mass at the origin (a ragged block's padding)."""
    pos, _ = jax_ic.generate(JaxNBodyConfig.SHELL, n, 1.52, 2.0, seed=seed)
    pos[:, 3] = np.random.default_rng(seed + 100).uniform(0.5, 2.0, n).astype(np.float32)
    if pad:
        pos[-pad:] = 0.0
    return pos


def _walk(pi, pj, eps2, rows, diag, reaction=True):
    """One block's tile pair in the walk's order: pi, pj (T, 4), zero-padded.
    Returns (act (T, 3) by row, react (T, 3) by column, the block's reaction
    as its flushes write it; None without the reaction)."""
    tid = torch.arange(THREADS)
    lane, warp = tid & 31, tid >> 5
    t_rows = THREADS * rows
    p_i = [pi[tid + u * THREADS] for u in range(rows)]
    act = [torch.zeros((THREADS, 3)) for _ in range(rows)]
    react = torch.zeros((t_rows, 3)) if reaction else None
    for sub in range(rows):
        js0 = sub * THREADS
        red = torch.zeros((4, THREADS, 3))  # the warps' sums of the sub-tile
        for c in range(4):
            carry = torch.zeros((4, 32, 3))  # (warp, chunk body): a lane's carried sums
            for k in range(32):
                b = (lane + k) & 31
                pj_k = pj[js0 + c * 32 + b]
                for u in range(rows):
                    d = pj_k[:, :3] - p_i[u][:, :3]
                    dx, dy, dz = d.unbind(-1)
                    r2 = ((dx * dx + eps2) + dy * dy) + dz * dz
                    inv = torch.rsqrt(r2)
                    c3 = (inv * inv) * inv
                    s = pj_k[:, 3] * c3
                    t = p_i[u][:, 3] * c3
                    if diag:
                        keep = js0 + c * 32 + b > tid + u * THREADS
                        s = torch.where(keep, s, torch.zeros_like(s))
                        t = torch.where(keep, t, torch.zeros_like(t))
                    act[u] = act[u] + s[:, None] * d
                    if reaction:
                        carry[warp, b] = carry[warp, b] - t[:, None] * d
            red[:, c * 32:(c + 1) * 32] = carry
        if reaction:
            react[js0:js0 + THREADS] = ((red[0] + red[1]) + red[2]) + red[3]
    return torch.cat(act), react


def _tile_pairs(n, tile):
    tiles = _cdiv(n, tile)
    return [(r, c) for r in range(tiles) for c in range(r, tiles)]


def _padded(pos, tiles, tile):
    out = torch.zeros((tiles * tile, 4))
    out[:pos.shape[0]] = pos
    return out


def _sum_slots(scratch):
    """sum_partials: each body's slots added in tile order from 0."""
    total = torch.zeros(scratch.shape[1:])
    for part in scratch:
        total = total + part
    return total.t()


def _triangle(pos, tile, eps2):
    """sym_tri_kernel's scratch and sum_partials: (N, 3)."""
    n, rows = pos.shape[0], tile // THREADS
    tiles = _cdiv(n, tile)
    p = _padded(pos, tiles, tile)
    scratch = torch.zeros((tiles, 3, tiles * tile))
    for r, c in _tile_pairs(n, tile):
        act, react = _walk(p[r * tile:(r + 1) * tile], p[c * tile:(c + 1) * tile], eps2, rows,
                           r == c)
        if r == c:
            scratch[c, :, r * tile:(r + 1) * tile] = (act + react).t()
        else:
            scratch[c, :, r * tile:(r + 1) * tile] = act.t()
            scratch[r, :, c * tile:(c + 1) * tile] = react.t()
    return _sum_slots(scratch[:, :, :n])


def _ablated(pos, tile, eps2, reaction):
    """sym_ablate_kernel and ablate_sums_kernel: (acc (N, 3), react (3, N) or
    None, total (N, 3) in the triangle's order or None)."""
    n, rows = pos.shape[0], tile // THREADS
    tiles = _cdiv(n, tile)
    p = _padded(pos, tiles, tile)
    full = reaction == "full"
    scratch = torch.zeros((tiles, 3, tiles * tile))
    side = torch.zeros((3, tiles * tile))
    for r, c in _tile_pairs(n, tile):
        act, react = _walk(p[r * tile:(r + 1) * tile], p[c * tile:(c + 1) * tile], eps2, rows,
                           r == c, reaction=full)
        scratch[c, :, r * tile:(r + 1) * tile] = act.t()
        if full:
            where = side if r == c else scratch[r]
            where[:, c * tile:(c + 1) * tile] = react.t()
    scratch, side = scratch[:, :, :n], side[:, :n]
    acc = torch.zeros((n, 3))
    react = torch.zeros((3, n)) if full else None
    total = torch.zeros((n, 3)) if full else None
    for x in range(n):
        b = x // tile
        a = torch.zeros(3)
        for t in range(b, tiles):
            a = a + scratch[t, :, x]
        acc[x] = a
        if full:
            below = torch.zeros(3)
            for t in range(b):
                below = below + scratch[t, :, x]
            react[:, x] = below + side[:, x]
            s = below + (scratch[b, :, x] + side[:, x])
            for t in range(b + 1, tiles):
                s = s + scratch[t, :, x]
            total[x] = s
    return acc, react, total


def _cross(pos_i, pos_j, tile, eps2):
    """sym_cross_kernel's scratches and sum_partials: (acc_i (Bi, 4) with
    w = 0, react_j (3, Bj))."""
    bi, bj, rows = pos_i.shape[0], pos_j.shape[0], tile // THREADS
    ri, cj = _cdiv(bi, tile), _cdiv(bj, tile)
    pi, pj = _padded(pos_i, ri, tile), _padded(pos_j, cj, tile)
    act_s = torch.zeros((cj, 3, ri * tile))
    react_s = torch.zeros((ri, 3, cj * tile))
    for r in range(ri):
        for c in range(cj):
            act, react = _walk(pi[r * tile:(r + 1) * tile], pj[c * tile:(c + 1) * tile], eps2,
                               rows, False)
            act_s[c, :, r * tile:(r + 1) * tile] = act.t()
            react_s[r, :, c * tile:(c + 1) * tile] = react.t()
    acc = torch.zeros((bi, 4))
    acc[:, :3] = _sum_slots(act_s[:, :, :bi])
    return acc, _sum_slots(react_s[:, :, :bj]).t()


def _held(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-4


@functools.lru_cache(maxsize=None)
def _jax_triangle(n):
    return np.asarray(jsym.compute_accel_symmetric(jnp.asarray(_pos(n)), SOFT, tile_i=64,
                                                   tile_j=256, interpret=True))


@pytest.mark.parametrize("n, tile", [(333, 128), (333, 256), (1001, 128), (129, 128)])
def test_walk_triangle_matches_jax_sym_kernel(n, tile):
    """The triangle in the walk's order, at odd N and N not a multiple of the
    tile (the last block ragged, 7 zero-mass bodies), against the
    interpret-mode _sym_kernel."""
    got = _triangle(_t(_pos(n)), tile, SOFT * SOFT)
    _held(got, _jax_triangle(n))


@pytest.mark.parametrize("bi, bj, tile", [(128, 200, 128), (77, 301, 128), (300, 129, 256)])
def test_walk_rectangle_matches_jax_cross_kernel_both_outputs(bi, bj, tile):
    """The rectangle in the walk's order against the interpret-mode
    _sym_cross_kernel (inputs zero-padded to its tiles), the action and the
    reaction."""
    pos = _pos(bi + bj, seed=9)
    pos_i, pos_j = pos[:bi], pos[bi:]
    acc, react = _cross(_t(pos_i), _t(pos_j), tile, SOFT * SOFT)
    pad_i, pad_j = _cdiv(bi, 64) * 64, _cdiv(bj, 128) * 128
    ji = np.zeros((pad_i, 4), np.float32)
    jj = np.zeros((pad_j, 4), np.float32)
    ji[:bi], jj[:bj] = pos_i, pos_j
    j_acc, j_react = jsym._sym_cross(jnp.asarray(ji), jnp.asarray(jj).T, SOFT, tile_i=64,
                                     tile_j=128, interpret=True)
    assert not acc[:, 3].any()
    _held(acc, np.asarray(j_acc)[:bi])
    _held(react, np.asarray(j_react)[:, :bj])


@pytest.mark.parametrize("n, tile", [(333, 128), (300, 256)])
def test_walk_ablations_match_plain_and_tie_to_the_triangle(n, tile):
    """The ablations on the same walk: every action equal to the full one
    bit for bit (one arithmetic), within the bound of the plain action; the
    full reaction within the bound of the plain reaction; the full total,
    summed as ablate_sums_kernel sums it, equal to the triangle's bits."""
    pos = _t(_pos(n))
    eps2 = SOFT * SOFT
    acc_f, react_f, total = _ablated(pos, tile, eps2, "full")
    acc_n, _, _ = _ablated(pos, tile, eps2, "none")
    assert torch.equal(acc_n, acc_f)
    act, react = reference.sym_ablated_accel(pos, SOFT, reaction="full", tile=tile)
    bound = 1e-4 * (act + react.t()).abs().max().item() + 1e-4
    assert (acc_f - act).abs().max().item() <= bound
    assert (react_f - react).abs().max().item() <= bound
    assert torch.equal(total, _triangle(pos, tile, eps2))


def test_walk_zero_softening_drops_the_self_pair_by_select():
    """At eps = 0 the self pair's inv is inf: the diagonal keeps j > i as a
    select, so the masked pairs add exactly 0 and the force stays finite."""
    pos = _t(_pos(200, pad=0))
    got = _triangle(pos, 128, 0.0)
    assert torch.isfinite(got).all()
    _held(got, reference.compute_accel_symmetric(pos, 0.0))


# ---- the kernels' constants, the dispatch table and the one walk ----


def _source():
    return (CSRC / "symmetric_kernels.cu").read_text()


def test_the_walk_constants_are_the_dispatch_tables():
    """The sub-tile the walk stages, its unroll, and the tiles the kernels
    take are the ones ops/cuda_kernel.py names and measured its table with;
    a launch's scratch at the default dispatch stays at or under 201 MB."""
    text = _source()
    (sub,) = re.findall(r"constexpr int kSub = (\w+);", text)
    (unroll,) = re.findall(r"constexpr int kUnroll = (\d+);", text)
    common = (CSRC / "sym_common.cuh").read_text()
    (threads,) = re.findall(r"constexpr int kThreads = (\d+);", common)
    assert sub == "kThreads" and int(threads) == THREADS == ck.SYM_SUB
    assert int(unroll) == ck.SYM_UNROLL and 32 % ck.SYM_UNROLL == 0
    tiles = dict((int(t), int(r)) for t, r in re.findall(r"case (\d+): return (\d+);", common))
    assert tuple(sorted(tiles)) == ck.SYM_TILES
    assert all(t == THREADS * r for t, r in tiles.items())
    cap, tile = ck.sym_default_dispatch(65536)
    assert (cap, tile) == (ck.SYM_BLOCK_CAP, ck.DEFAULT_SYM_TILE) and tile in ck.SYM_TILES
    assert 12 * cap * cap // tile <= 12 * 131072 * 131072 // 1024  # 201 MB
    assert all(ck.sym_default_dispatch(n) == (cap, tile) for n in (1, 65536, 135168, 262144))


def test_the_three_kernels_run_one_walk():
    """The triangle, the rectangle and the ablation each call sym_walk, the
    only walk of the source; the j-shuffle walk (tile_pair) and its pinned
    contraction (PIN) are gone, no j-body travels by __shfl_sync, and the
    pair's arithmetic is written with rounded intrinsics and rsqrt_ftz."""
    text = _source()
    assert "tile_pair" not in text and not re.search(r"\bPIN\b", text)
    assert not re.search(r"pj\.[xyzw] = __shfl_sync", text)
    assert "rsqrtf(" not in text and "atomicAdd" not in text
    walk = text[text.index("void sym_walk("):text.index("sym_tri_kernel(")]
    assert "rsqrt_ftz(r2)" in walk
    assert "__fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, eps2)))" in walk
    assert walk.count("__shfl_sync") == 3  # the three reaction sums only
    kernels = {k: text[text.index(f"{k}(const"):] for k in
               ("sym_tri_kernel", "sym_cross_kernel", "sym_ablate_kernel")}
    for name, body in kernels.items():
        body = body[:body.index("\n}\n")]
        assert "sym_walk<ROWS, " in body, name
    assert len(re.findall(r"__device__ __forceinline__ void \w+\(", text)) == 1


# ---- the CPU wrappers and chip_smoke.py's guard on the walk ----


@pytest.mark.parametrize("tile", [128, 1024])
def test_cpu_wrappers_take_the_plain_versions_and_count_nothing(tile):
    """On CPU tensors every sym wrapper, with or without another build's
    library, returns its plain version and counts no launch."""
    pos = _t(_pos(301))
    launches = dict(ck.LAUNCHES)
    want = reference.compute_accel_symmetric(pos, SOFT)
    other = object()
    assert torch.equal(ck._sym(pos, SOFT, tile, None, other), want)
    assert torch.equal(ck.sym_accel_cuda(pos, SOFT, tile=tile), want)
    a, r = ck._sym_cross(pos[:100], pos[100:], SOFT, tile, None, other)
    a_r, r_r = reference.sym_cross(pos[:100], pos[100:], SOFT)
    assert torch.equal(a, a_r) and torch.equal(r, r_r)
    blocked = ck._sym_blocked(pos, SOFT, tile, tile, other)
    want_b = reference.compute_accel_symmetric_blocked(pos, SOFT, block_cap=tile, tile_j=tile)
    assert torch.equal(blocked, want_b)
    acc, react = ck._sym_ablated(pos, SOFT, "full", tile, False, other)
    act, react_r = reference.sym_ablated_accel(pos, SOFT, reaction="full", tile=tile)
    assert torch.equal(acc, act) and torch.equal(react, react_r)
    assert ck.LAUNCHES == launches


def _walk_sass(key: str, inside: bool) -> str:
    """cuobjdump-like SASS of one kernel: a walk (the loop around MUFU.RSQ),
    with an STL inside it when `inside`."""
    ins = ["LDS.128 R4, [R2]", "MUFU.RSQ R10, R9", "SHFL.IDX R3, R3, R5, 0x1f",
           "STL [R1+0x8], R3" if inside else "FFMA R3, R10, R4, R3", "@!P0 BRA 0x0", "EXIT"]
    out = ["\tcode for sm_90a", f"\t\tFunction : _ZN12_GLOBAL__N_1{key}ILi8EEEvPK6float4"]
    out += [f"        /*{16 * k:04x}*/                   {op} ;" for k, op in enumerate(ins)]
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("inside", [False, True])
@pytest.mark.parametrize("key", ["14sym_tri_kernel", "16sym_cross_kernel",
                                 "17sym_ablate_kernel"])
def test_chip_smoke_guards_the_sym_walk(key, inside, capsys):
    """Phase 3e's step_walks_checked also runs over the sym kernels
    (WALK_SHARERS): a local-memory access inside their walk fails the phase,
    none passes and prints the walk's SASS count a pair."""
    import importlib.util
    import types

    from nbody_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    keys = smoke.WALK_SHARERS["symmetric_kernels.cu"]
    assert key in keys
    build = types.SimpleNamespace(**{k: getattr(_build, k) for k in (
        "sass_functions", "sass_loops", "sass_class")}, demangle=lambda u: {})
    text = "".join(_walk_sass(k, inside and k == key) for k in keys)
    if inside:
        with pytest.raises(RuntimeError, match="spills inside its walk"):
            smoke.step_walks_checked(build, {}, text, keys, "symmetric_kernels.cu")
        return
    smoke.step_walks_checked(build, {}, text, keys, "symmetric_kernels.cu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[3e sass]")]
    assert len(lines) == 3 and all("5.00 SASS instructions a pair, 0 local accesses inside"
                                   in ln for ln in lines)
