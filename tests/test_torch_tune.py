"""The port's tuner (``nbody_tpu_torch/tune.py``): cache plumbing, the drift
gate and the resolution of a cache entry, on the CPU (a sweep needs a card;
``chip_smoke.py`` runs it), each a counterpart of ``tests/test_tune.py``,
and the consumers. Every test points ``XDG_CACHE_HOME`` at its own
temporary directory: none touches the real cache.
"""

import json
import os
import subprocess
import sys
import warnings

import pytest
import torch

from nbody_tpu import tune as jax_tune

from nbody_tpu_torch import DEMO_PARAMS, tune
from nbody_tpu_torch.models import BodySystem, DSBodySystem
from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import p3m

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fake_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    p3m._tuned_blk.cache_clear()
    yield tmp_path
    p3m._tuned_blk.cache_clear()


def _write(cache: dict) -> None:
    path = tune._cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cache))


def test_bucket_rounds_to_power_of_two():
    assert tune._bucket(65536) == "65536"
    assert tune._bucket(65537) == "131072"
    assert tune._bucket(1000) == "1024"


def test_best_config_roundtrip():
    entry = {"variant": "mxu_bf16", "block_size": None, "tile": None,
             "g_interactions_per_s": 205.0}
    _write({tune._key(): {"euler": {"65536": entry}}})
    assert tune.best_config(65536) == entry
    assert tune.best_config(50000) == entry  # same bucket
    assert tune.best_config(200000) is None
    assert tune.best_config(65536, family="hermite") is None


def test_best_config_legacy_flat_schema_served_for_euler():
    entry = {"variant": "sym", "block_size": None, "tile": 1024,
             "g_interactions_per_s": 285.0}
    _write({tune._key(): {"65536": entry}})
    assert tune.best_config(65536) == entry
    assert tune.best_config(65536, family="hermite") is None


def test_best_config_families_are_independent():
    euler = {"variant": "sym", "block_size": None, "tile": 1024,
             "g_interactions_per_s": 285.0}
    hermite = {"variant": "vpu", "block_size": 128, "tile": None,
               "g_interactions_per_s": 52.0}
    blk = {"blk": 256, "g_interactions_per_s": 900.0}
    _write({tune._key(): {"euler": {"65536": euler}, "hermite": {"65536": hermite},
                          "p3m": {"64": blk}}})
    assert tune.best_config(65536) == euler
    assert tune.best_config(65536, family="hermite") == hermite
    assert tune.best_config(48, family="p3m") == blk
    assert tune.best_config(65536, family="ds") is None


def test_p3m_kernel_blk_consumes_tuned_winner():
    _write({tune._key(): {"p3m": {"1024": {"blk": 512, "g_interactions_per_s": 1.0}}}})
    assert p3m.p3m_kernel_blk(1000) == 512
    # untuned capacity buckets fall back to the ladder
    assert p3m.p3m_kernel_blk(128) == 128
    assert p3m.p3m_kernel_blk(200) == 256
    assert p3m.p3m_kernel_blk(6680) == 512


def test_best_config_empty_cache():
    assert tune.best_config(65536) is None
    assert tune.best_config(65536, family="ds_hermite") is None


def test_unknown_family_rejected():
    with pytest.raises((ValueError, RuntimeError)):
        tune.autotune(1024, family="nope")


def test_autotune_requires_accelerator():
    with pytest.raises(RuntimeError, match="accelerator"):
        tune.autotune(1024)


@pytest.mark.parametrize("entry", [
    {"variant": "sym", "block_size": None, "tile": 512},
    {"variant": "mxu_bf16", "block_size": None, "tile": None},
])
def test_auto_variant_is_vpu_on_cpu_whatever_the_cache(entry):
    _write({tune._key(): {"euler": {"128": entry}, "hermite": {"128": entry}}})
    for integrator in ("euler", "hermite"):
        s = BodySystem(128, DEMO_PARAMS[0], device="cpu", variant="auto",
                       integrator=integrator)
        assert (s.variant, s.block_size, s.tile) == ("vpu", ck.DEFAULT_BLOCK_SIZE, None)
    d = DSBodySystem(128, DEMO_PARAMS[0], device="cpu")
    assert (d.variant, d.tile) == ("sym", None)


def test_corrupt_cache_ignored():
    path = tune._cache_path()
    path.parent.mkdir(parents=True)
    path.write_text("{not json")
    assert tune.best_config(65536) is None
    assert p3m.p3m_kernel_blk(1000) == 256


def test_drift_gate_rejects_divergent_variants():
    """The fastest candidate cannot win if its energy drift departs from
    the exact vpu anchor's; the walk stops at the first that passes."""
    results = [
        {"variant": "vpu", "block_size": 256, "tile": None, "g_interactions_per_s": 140.0},
        {"variant": "mxu", "block_size": None, "tile": None, "g_interactions_per_s": 205.0},
        {"variant": "mxu_bf16", "block_size": None, "tile": None,
         "g_interactions_per_s": 210.0},
    ]
    drifts = {("vpu", ck.DEFAULT_BLOCK_SIZE, None): 0.566,  # the anchor
              ("mxu", None, None): 0.571,        # 0.9% off: passes the 2% gate
              ("mxu_bf16", None, None): 0.589}   # 4.1% off: rejected
    logs = []
    gated = tune._gate_by_drift(results, lambda *c: drifts[c], log=logs.append)
    assert [r["variant"] for r in gated] == ["mxu"]
    assert any("REJECTED mxu_bf16" in line for line in logs)


def test_drift_gate_exact_leader_skips_anchor_rollout():
    """A vpu or sym leader runs no drift rollout at all."""
    for leader in ("vpu", "sym"):
        calls = []
        results = [
            {"variant": leader, "block_size": None, "tile": 1024,
             "g_interactions_per_s": 200.0},
            {"variant": "mxu_bf16", "block_size": None, "tile": None,
             "g_interactions_per_s": 150.0},
        ]
        gated = tune._gate_by_drift(results, lambda *c: calls.append(c) or 0.0,
                                    log=lambda *a: None)
        assert [r["variant"] for r in gated] == [leader]
        assert calls == []


def test_drift_gate_all_rejected_raises():
    results = [{"variant": "mxu_bf16", "block_size": None, "tile": None,
                "g_interactions_per_s": 205.0}]
    with pytest.raises(RuntimeError, match="drift gate"):
        tune._gate_by_drift(results, lambda v, bs, t: 0.0 if v == "vpu" else 1.0,
                            log=lambda *a: None)


def test_p3m_tuned_blk_cache_invalidation(monkeypatch):
    """p3m_kernel_blk memoizes its cache reads; a winner written later in
    the same process is served after autotune(save=True)'s cache_clear."""
    monkeypatch.setattr(tune, "best_config", lambda n, family="euler": None)
    assert p3m.p3m_kernel_blk(100) == 128  # the ladder, the miss memoized
    monkeypatch.setattr(tune, "best_config", lambda n, family="euler": {"blk": 512})
    assert p3m.p3m_kernel_blk(100) == 128  # still the memoized miss
    p3m._tuned_blk.cache_clear()  # what autotune(save=True) does
    assert p3m.p3m_kernel_blk(100) == 512


def test_a_failing_candidate_fails_the_sweep(monkeypatch, fake_cache):
    """A candidate that raises is a fault: the sweep raises with it, caches
    nothing and times no later candidate."""
    ran = []

    def make_roll(cand):
        if cand == ("vpu", 256, None):
            raise RuntimeError("invalid configuration argument")
        return lambda steps: ran.append(cand)

    monkeypatch.setattr(tune, "_card", lambda: torch.device("cpu"))
    monkeypatch.setattr(tune, "_make_family_harness", lambda family, n, device: (make_roll, {}))
    with pytest.raises(RuntimeError, match="invalid configuration"):
        tune.autotune(64, family="euler", drift_gate=False, log=lambda *a: None)
    assert ("vpu", 512, None) not in ran and ("sym", None, 1024) in ran
    assert not tune._cache_path().exists()


def test_cache_path_is_not_nbody_tpus(fake_cache):
    assert tune._cache_path() == fake_cache / "nbody_tpu_torch" / "tune.json"
    assert tune._cache_path() != jax_tune._cache_path()


def test_families_and_gate_carried_over():
    assert tune.FAMILIES == jax_tune.FAMILIES
    assert (tune.DRIFT_GATE_STEPS, tune.DRIFT_GATE_REL, tune.DRIFT_GATE_ABS) == (
        jax_tune.DRIFT_GATE_STEPS, jax_tune.DRIFT_GATE_REL, jax_tune.DRIFT_GATE_ABS)
    for n in (1, 2, 1000, 1024, 1025, 65536, 65537):
        assert tune._bucket(n) == jax_tune._bucket(n)


@pytest.mark.parametrize("family", tune.FAMILIES)
def test_every_candidate_passes_the_kernels_checks(family):
    """At most 8 a family, each a configuration the kernels accept."""
    cands = tune.FAMILY_CANDIDATES[family]
    assert 1 <= len(cands) <= 8 and len(set(cands)) == len(cands)
    for cand in cands:
        if family == "p3m":
            assert cand[0] in (128, 256, 512)
            continue
        variant, block_size, tile = cand
        kw = tune.system_kwargs(family, cand)
        if block_size is not None:
            assert ck.check_block_size(block_size) == block_size
            assert variant in ("vpu", "one_sided")
        if tile is not None:
            tiles = ck.DS_AJ_TILES if family == "ds_hermite" else ck.SYM_TILES
            assert ck.check_sym_tile(tile, tiles) == tile
            assert variant == "sym"
        if variant in ("mxu", "mxu_bf16"):
            assert family == "euler" and block_size is None and tile is None
        # the system the candidate names builds (on the CPU, plain versions)
        system = DSBodySystem if family.startswith("ds") else BodySystem
        s = system(64, DEMO_PARAMS[0], device="cpu", **kw)
        assert s.tile == tile


@pytest.mark.parametrize("family, entry, request_, want", [
    ("euler", {"variant": "sym", "block_size": None, "tile": 512}, {}, ("sym", None, 512)),
    ("euler", {"variant": "vpu", "block_size": 128, "tile": None}, {}, ("vpu", 128, None)),
    ("euler", {"variant": "mxu_bf16", "block_size": None, "tile": None}, {},
     ("mxu_bf16", None, None)),
    ("euler", None, {}, ("auto", None, None)),
    ("hermite", {"variant": "vpu", "block_size": 512, "tile": None}, {},
     ("vpu", 512, None)),
    ("hermite", {"variant": "sym", "block_size": None, "tile": 256}, {"tile": 1024},
     ("sym", None, 1024)),
    ("ds", {"variant": "sym", "block_size": None, "tile": 128}, {}, ("sym", None, 128)),
    ("ds", {"variant": "sym", "block_size": None, "tile": 128}, {"variant": "one_sided"},
     ("one_sided", None, None)),
    ("ds", {"variant": "one_sided", "block_size": 64, "tile": None}, {"variant": "one_sided"},
     ("one_sided", 64, None)),
    ("ds_leapfrog", {"variant": "sym", "block_size": None, "tile": 256}, {"sym_ok": False},
     ("one_sided", None, None)),
    ("ds_leapfrog", {"variant": "one_sided", "block_size": 512, "tile": None},
     {"sym_ok": False}, ("one_sided", 512, None)),
    ("ds_hermite", {"variant": "sym", "block_size": None, "tile": 256}, {},
     ("sym", None, 256)),
])
def test_resolve_cached(family, entry, request_, want):
    """The resolution of a cache entry into (variant, block_size, tile) for
    each family, a pure function of the entry and the request."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tune.resolve_cached(entry, **request_) == want


def test_explicit_value_wins_with_a_warning():
    entry = {"variant": "vpu", "block_size": 128, "tile": None}
    with pytest.warns(UserWarning, match=r"explicit block_size=512 override the "
                                         r"autotuner cache \(block_size=128\)"):
        assert tune.resolve_cached(entry, block_size=512) == ("vpu", 512, None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the same value, or a knob the entry lacks: silent
        assert tune.resolve_cached(entry, block_size=128) == ("vpu", 128, None)
        assert tune.resolve_cached(entry, tile=256) == ("vpu", 128, 256)


@pytest.mark.parametrize("family, cand, kind", [
    ("euler", ("sym", None, 512), BodySystem),
    ("euler", ("vpu", 128, None), BodySystem),
    ("hermite", ("vpu", 512, None), BodySystem),
    ("ds_hermite", ("sym", None, 128), DSBodySystem),
])
def test_explicit_configuration_steps_like_the_default_on_the_cpu(family, cand, kind):
    """The tuner's knobs change how the work is cut, not the physics: on
    the CPU a system at a candidate's configuration steps as the default
    one does, to float32 (ds: float64) rounding of other sum orders."""
    kw = tune.system_kwargs(family, cand)
    a = kind(64, DEMO_PARAMS[0], device="cpu", **kw)
    b = kind(64, DEMO_PARAMS[0], device="cpu", integrator=kw["integrator"],
             variant=kw["variant"])
    a.update_many(2)
    b.update_many(2)
    torch.testing.assert_close(torch.as_tensor(a.positions), torch.as_tensor(b.positions),
                               rtol=1e-5, atol=1e-6)


def test_module_help_lists_the_families():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "nbody_tpu_torch.tune", "--help"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "nbody-tune-torch" in proc.stdout
    assert "{" + ",".join(tune.FAMILIES) + "}" in proc.stdout
    for flag in ("--numbodies", "--steps", "--family", "--all", "--no-save",
                 "--no-drift-gate"):
        assert flag in proc.stdout
    bad = subprocess.run([sys.executable, "-m", "nbody_tpu_torch.tune", "--family", "nope"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "invalid choice" in bad.stderr
