"""Launch-configuration auto-tuner of the port: sweep the kernels'
configurations on the card and cache the winner, per kernel family.

Counterpart of ``nbody_tpu/tune.py``. The reference exposes --blockSize and
leaves tuning to the user (``nbody.cpp:285``); ``autotune(n, family=...)``
times each candidate, a (variant, block_size, tile) of the port's kernels,
with CUDA events around a rollout of the system that runs it, and keeps the
fastest per (card, family, N-bucket) in
``$XDG_CACHE_HOME/nbody_tpu_torch/tune.json`` (``~/.cache`` without the
variable), which ``best_config(n, family=...)`` serves back. The JAX
package's cache is another file; neither reads the other's.

Families and their consumers (each on a CUDA device with the kernel backend
and no mesh; on the CPU and on meshes the cache is not read, as
``nbody_tpu`` reads its cache only on the TPU):

* ``euler``       — the fp32 Euler step: the fused one-sided step kernel at
                    a block size, the each-pair-once composition at a tile,
                    the tensor-core steps. ``BodySystem(variant="auto")``
                    with Euler or leapfrog.
* ``hermite``     — the fp32 accel + jerk kernels, one-sided at a block size
                    or each pair once at a tile. ``BodySystem(variant=
                    "auto", integrator="hermite")``.
* ``ds``, ``ds_leapfrog``, ``ds_hermite`` — the double-single Euler,
                    leapfrog and Hermite steps, one-sided at a block size or
                    each pair once at a tile. ``DSBodySystem`` by integrator.
* ``p3m``         — the P3M pair kernel's ``blk``, bucketed by the cell
                    CAPACITY, not N: ``ops/p3m.py::p3m_kernel_blk`` resolves
                    it for every caller.

The sym candidates run at the dispatch table's ``block_cap``, as
``nbody_tpu``'s run at ``sym_default_dispatch(n)[0]``; no candidate varies
the cap or the split rules' fills.

Drift gate: only the euler family carries a variant that changes the
arithmetic (mxu_bf16's bf16 operands); its candidates must match the exact
float32 ``vpu`` anchor's energy drift over DRIFT_GATE_STEPS steps. Every
other family's candidates compute the same sums in another order or split.

CLI: ``nbody-tune-torch [--family F | --all]`` /
``python -m nbody_tpu_torch.tune [--numbodies N]``.
"""

from __future__ import annotations

import json
import os
import pathlib
import warnings

# The candidates bracket the port's measured defaults (PERF.md §6, the
# kernel table): DEFAULT_BLOCK_SIZE 256 of the one-sided fp32 step and
# accel + jerk (rows 1, 5), DEFAULT_SYM_TILE 1024 of the sym force (rows 7,
# 8), AJ_SYM_TILE 512 of the sym accel + jerk (rows 9, 10), the ds tables
# (ds_default_block_size 128 / 256, DS_SYM_TILES 256 / 512, DS_AJ_SYM_TILES
# 128 / 256; rows 11-18), the mxu steps (row 3, one tile each) and the P3M
# ladder (row 19). A candidate is (variant, block_size, tile), in the
# variant names of the system that runs it (BodySystem's "vpu",
# DSBodySystem's "one_sided"): the block size of a one-sided kernel (no bits
# change: the split kernels take their chunks from (M, N) alone) or the
# j-tile of an each-pair-once one.
FAMILY_CANDIDATES = {
    "euler": (
        ("sym", None, 1024),
        ("sym", None, 512),
        ("vpu", 128, None),
        ("vpu", 256, None),
        ("vpu", 512, None),
        ("vpu", 1024, None),
        ("mxu", None, None),
        ("mxu_bf16", None, None),
    ),
    "hermite": (
        ("sym", None, 256),
        ("sym", None, 512),
        ("sym", None, 1024),
        ("vpu", 128, None),
        ("vpu", 256, None),
        ("vpu", 512, None),
    ),
    "ds": (
        ("sym", None, 128),
        ("sym", None, 256),
        ("sym", None, 512),
        ("one_sided", 64, None),
        ("one_sided", 128, None),
        ("one_sided", 256, None),
    ),
    "ds_leapfrog": (
        ("one_sided", 64, None),
        ("one_sided", 128, None),
        ("one_sided", 256, None),
        ("one_sided", 512, None),
    ),
    "ds_hermite": (
        ("sym", None, 128),
        ("sym", None, 256),
        ("one_sided", 64, None),
        ("one_sided", 128, None),
        ("one_sided", 256, None),
    ),
    # blk sweep; candidates are (blk,) tuples
    "p3m": ((128,), (256,), (512,)),
}

# Drift gate: a candidate only qualifies if its relative energy drift over
# DRIFT_GATE_STEPS steps agrees with the exact-fp32 `vpu` anchor to within
# max(DRIFT_GATE_ABS, DRIFT_GATE_REL * |anchor drift|) — the same shape of
# criterion as the oracle drift check (compute.drift_check), so speed can
# never silently buy a different simulation.
#
# Constants carried over from nbody_tpu/tune.py, which set them from its
# measured N=65536 table on the TPU (PARITY.md "Long-horizon drift"): at
# 1,000 steps mxu_bf16 deviated 4.0% from the vpu anchor and by 10,000
# steps it had exploded — bf16 reduction noise stochastically heats the
# system. mxu (3-pass) deviated 0.2%. A 1,000-step window at 2% rejects
# the former and passes the latter; 100 steps (0.4% deviation) would NOT
# have caught it.
DRIFT_GATE_STEPS = 1000
DRIFT_GATE_REL = 0.02
DRIFT_GATE_ABS = 5e-4

FAMILIES = tuple(FAMILY_CANDIDATES)
DS_FAMILIES = {"ds": "euler", "ds_leapfrog": "leapfrog", "ds_hermite": "hermite"}


def _cache_path() -> pathlib.Path:
    root = pathlib.Path(os.environ.get("XDG_CACHE_HOME", "~/.cache")).expanduser()
    return root / "nbody_tpu_torch" / "tune.json"


def _bucket(n: int) -> str:
    b = 1 << max(n - 1, 1).bit_length()  # next power of two
    return str(b)


def _key() -> str:
    """The card's cache key, ``cuda:<torch.cuda.get_device_name()>``; "cpu"
    where there is no card, which autotune never writes."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return f"cuda:{torch.cuda.get_device_name()}"


def load_cache() -> dict:
    p = _cache_path()
    if p.exists():
        try:
            return json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            return {}
    return {}


def best_config(n: int, family: str = "euler") -> dict | None:
    """Cached best candidate for this card, family and N-bucket.

    Schema: cache[device][family][bucket]. Flat euler entries under
    cache[device][bucket] (``nbody_tpu``'s schema before its families) are
    still served for family='euler'."""
    dev = load_cache().get(_key(), {})
    entry = dev.get(family, {}).get(_bucket(n)) if isinstance(
        dev.get(family), dict) else None
    if entry is None and family == "euler":
        legacy = dev.get(_bucket(n))
        if isinstance(legacy, dict) and "variant" in legacy:
            entry = legacy
    return dict(entry) if entry else None


def resolve_cached(entry, *, variant: str = "auto", block_size=None, tile=None,
                   sym_ok: bool = True) -> tuple:
    """The (variant, block_size, tile) a system runs for the cache `entry`
    (None: no entry) and its request. With variant "auto" the entry's
    variant is taken (a cached "sym" where sym does not apply, ``sym_ok``
    False, gives "one_sided"); an entry of another variant than the one
    resolved leaves the request as it is. An explicit block_size or tile
    wins over the entry's, with a warning where the two differ; a None is
    taken from the entry (None there too: the dispatch table's default)."""
    if entry is None:
        return variant, block_size, tile
    cached = entry.get("variant")
    if variant == "auto":
        variant = cached if cached != "sym" or sym_ok else "one_sided"
    if cached != variant:
        return variant, block_size, tile
    overridden = [(k, mine, entry.get(k)) for k, mine in (("block_size", block_size),
                                                        ("tile", tile))
                  if mine is not None and entry.get(k) is not None and entry.get(k) != mine]
    if overridden:
        warnings.warn(
            "explicit " + ", ".join(f"{k}={mine}" for k, mine, _ in overridden)
            + " override the autotuner cache ("
            + ", ".join(f"{k}={theirs}" for k, _, theirs in overridden) + ")",
            stacklevel=3)
    return (variant, entry.get("block_size") if block_size is None else block_size,
            entry.get("tile") if tile is None else tile)


def _gate_by_drift(results, drift_of, *, log=print) -> list:
    """Qualifying candidates, fastest first, stopping at the first pass.

    ``drift_of(variant, block_size, tile)`` returns the relative energy
    drift over DRIFT_GATE_STEPS steps. vpu candidates pass by definition
    (they ARE the anchor kernel), and so do sym ones (the same exact-fp32
    arithmetic a pair, each pair once); others must match the anchor's
    drift to within max(DRIFT_GATE_ABS, DRIFT_GATE_REL * |anchor|).
    Candidates are walked in descending speed order and the walk STOPS at
    the first qualifier — slower candidates can never win, and each skipped
    drift test saves DRIFT_GATE_STEPS steps on the card. The anchor rollout
    itself only runs if a candidate other than vpu or sym leads."""
    from nbody_tpu_torch.ops.cuda_kernel import DEFAULT_BLOCK_SIZE

    anchor = None
    bound = None
    gated = []
    for r in sorted(results, key=lambda r: -r["g_interactions_per_s"]):
        if r["variant"] in ("vpu", "sym"):
            r["drift_delta"] = 0.0
            gated.append(r)
            break
        if anchor is None:
            anchor = drift_of("vpu", DEFAULT_BLOCK_SIZE, None)
            bound = max(DRIFT_GATE_ABS, DRIFT_GATE_REL * abs(anchor))
            log(f"drift gate: vpu anchor {anchor:+.3e}, bound {bound:.1e} "
                f"over {DRIFT_GATE_STEPS} steps")
        delta = abs(drift_of(r["variant"], r["block_size"], r["tile"]) - anchor)
        r["drift_delta"] = round(delta, 8)
        if delta <= bound:
            gated.append(r)
            break
        log(f"  REJECTED {r['variant']} block_size={r['block_size']} "
            f"tile={r['tile']}: drift delta {delta:.2e} > {bound:.1e}")
    if not gated:
        raise RuntimeError("every tuning candidate failed the drift gate")
    return gated


def system_kwargs(family: str, cand) -> dict:
    """The keywords of ``BodySystem`` (euler, hermite) or ``DSBodySystem``
    (the ds families) that run candidate `cand` of `family`."""
    variant, block_size, tile = cand
    integrator = DS_FAMILIES.get(family, "hermite" if family == "hermite" else "euler")
    return {"variant": variant, "block_size": block_size, "tile": tile,
            "integrator": integrator}


def _cand_record(family: str, cand, gips: float) -> dict:
    if family == "p3m":
        return {"blk": cand[0], "g_interactions_per_s": round(gips, 1)}
    variant, block_size, tile = cand
    return {"variant": variant, "block_size": block_size, "tile": tile,
            "g_interactions_per_s": round(gips, 1)}


def _make_family_harness(family: str, n: int, device):
    """(make_roll, meta): make_roll(candidate) -> roll(steps), which runs
    `steps` steps of the candidate on the card from the family's state
    (shell, nbody_tpu's harness: cluster 1.54, velocity 8.0, seed 0, dt
    0.016, softening 0.1, damping 1)."""
    import numpy as np
    import torch

    from nbody_tpu_torch import NBodyConfig, NBodyParams, ic

    params = NBodyParams()
    if family in DS_FAMILIES:
        from nbody_tpu_torch.models import DSBodySystem

        state = ic.generate(NBodyConfig.SHELL, n, 1.54, 8.0, seed=0, dtype=np.float64)

        def make_roll(cand):
            return DSBodySystem(n, params, device=device, state=state,
                                **system_kwargs(family, cand)).update_many

        return make_roll, {}

    pos, vel = ic.generate(NBodyConfig.SHELL, n, 1.54, 8.0, seed=0)

    if family == "p3m":
        from nbody_tpu_torch.ops.p3m import nbody_step_p3m, p3m_max_occupancy

        p = torch.tensor(pos, device=device)
        v = torch.tensor(vel, device=device)
        # BodySystem's auto-size rule: max occupancy + 50%, multiple of 8
        occ = int(p3m_max_occupancy(p, grid=64))
        cap = max(8, -(-int(occ * 1.5 + 1) // 8) * 8)

        def make_roll(cand):
            (blk,) = cand

            def roll(steps):
                pp, vv = p, v
                for _ in range(steps):
                    pp, vv, _ = nbody_step_p3m(pp, vv, params.time_step, params.softening,
                                               params.damping, grid=64, capacity=cap, blk=blk)
            return roll

        # the winner is consumed through p3m_kernel_blk(capacity), so it
        # is cached under the CAPACITY bucket, not the N bucket
        return make_roll, {"bucket_value": cap}

    from nbody_tpu_torch.models import BodySystem

    def make_roll(cand):
        return BodySystem(n, params, device=device, state=(pos, vel),
                          **system_kwargs(family, cand)).update_many

    return make_roll, {"state": (pos, vel), "params": params}


def _card():
    """The current CUDA device; RuntimeError without one."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("autotune needs an accelerator (no CUDA device; "
                           "the cache is read only on a card)")
    return torch.device("cuda", torch.cuda.current_device())


def autotune(n: int = 65536, *, family: str = "euler", steps: int = 20,
             candidates=None, save: bool = True,
             drift_gate: bool = True, log=print) -> dict:
    """Time each candidate of `family` at N = `n` on the card (CUDA events
    around a `steps`-step rollout after one untimed warm-up rollout, the
    reference's method, ``compute_cuda.cpp:183-195``), gate the euler
    family's winner by drift, and cache the fastest (``save``). Returns the
    winner's record. A candidate that raises fails the sweep: every
    candidate is a configuration the kernels accept, so a failure is a
    fault, not a configuration to pass over."""
    from nbody_tpu_torch.utils.timing import elapsed_ms

    if family not in FAMILY_CANDIDATES:
        raise ValueError(f"unknown family {family!r}; one of {FAMILIES}")
    device = _card()
    if candidates is None:
        candidates = FAMILY_CANDIDATES[family]
    if not candidates:
        raise ValueError("no tuning candidate")

    make_roll, harness_meta = _make_family_harness(family, n, device)

    # Hermite runs 2 force evaluations a step: count interactions so that
    # the family's rate reads as its kernels'
    evals = 2 if family in ("hermite", "ds_hermite") else 1

    results = []
    for cand in candidates:
        roll = make_roll(cand)
        roll(steps)
        ms = elapsed_ms(lambda: roll(steps), device)
        gips = n * n * steps * evals / (ms * 1e-3) * 1e-9
        log(f"  {family} {cand}: {gips:7.1f} G interactions/s")
        results.append(_cand_record(family, cand, gips))

    if drift_gate and family == "euler":
        # only the euler family carries arithmetic-changing variants
        # (mxu_bf16); see module docstring
        from nbody_tpu_torch.models import BodySystem

        def drift_of(variant, block_size, tile):
            system = BodySystem(n, harness_meta["params"], device=device,
                                state=harness_meta["state"],
                                **system_kwargs(family, (variant, block_size, tile)))
            e0 = system.total_energy()
            system.update_many(DRIFT_GATE_STEPS)
            return (system.total_energy() - e0) / abs(e0)

        results = _gate_by_drift(results, drift_of, log=log)

    best = max(results, key=lambda r: r["g_interactions_per_s"])
    log(f"best[{family}]: {best}")

    if save:
        cache = load_cache()
        dev = cache.setdefault(_key(), {})
        fam = dev.get(family)
        if not isinstance(fam, dict):
            fam = dev[family] = {}
        fam[_bucket(harness_meta.get("bucket_value", n))] = best
        path = _cache_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cache, indent=2))
        # consumers that memoize cache READS must see the new winner in
        # this same process (tune, then build a system)
        from nbody_tpu_torch.ops.p3m import _tuned_blk

        _tuned_blk.cache_clear()
        log(f"cached to {path}")
    return best


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="nbody-tune-torch")
    ap.add_argument("--numbodies", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--family", choices=FAMILIES, default="euler",
                    help="kernel family to sweep (see module docstring)")
    ap.add_argument("--all", action="store_true",
                    help="sweep every family at this N")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--no-drift-gate", action="store_true",
                    help="skip the energy-drift-vs-vpu qualification pass")
    args = ap.parse_args(argv)
    families = FAMILIES if args.all else (args.family,)
    for family in families:
        autotune(args.numbodies, family=family, steps=args.steps,
                 save=not args.no_save,
                 drift_gate=not args.no_drift_gate)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
