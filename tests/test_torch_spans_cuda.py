"""The program's spans on the card: a step adds no host synchronisation,
with or without a profiler, and a P3M step synchronises only in its
counted host reads (``utils.timing.host_read``).

Every test here needs an NVIDIA GPU: each carries the ``cuda`` marker and
skips without a card. The file imports no JAX:

    python -m pytest tests/test_torch_spans_cuda.py --noconftest -q -m cuda
"""

import contextlib
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.utils import timing

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _system(n, dev, **kw):
    pos, vel = ic.generate(NBodyConfig.SHELL, n, 1.54, 8.0, seed=3)
    s = BodySystem(n, DEMO_PARAMS[0], device=dev, state=(pos, vel), **kw)
    s.update_many(1)  # the library, the allocations, the influence table
    s.synchronize()
    return s


@contextlib.contextmanager
def _sync_debug(mode):
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("profiled", [False, True])
@pytest.mark.parametrize("integrator", ["euler", "hermite"])
def test_step_spans_add_no_sync(dev, integrator, profiled):
    s = _system(8192, dev, variant="sym", integrator=integrator)
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
            else contextlib.nullcontext())
    with prof:
        with _sync_debug("error"):
            s.update_many(1)
        s.synchronize()
    if profiled:
        names = {e.name() for e in prof.profiler.kineto_results.events()}
        assert {"nbody.step", "nbody.force", "nbody.integrate"} <= names


def test_p3m_step_syncs_only_in_host_reads(dev):
    s = _system(65536, dev, kernel="p3m", p3m_auto_refresh=True)
    before = dict(timing.HOST_READS)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        with _sync_debug("warn"):
            s.update_many(1)
    syncs = [str(w.message) for w in got if "synchroniz" in str(w.message)]
    reads = {k: v - before.get(k, 0) for k, v in timing.HOST_READS.items()
             if v != before.get(k, 0)}
    assert reads == {"p3m_probe": 1}
    assert len(syncs) == sum(reads.values()), syncs


def test_p3m_spans_nest_on_the_card(dev):
    from test_torch_spans import span_paths

    s = _system(65536, dev, kernel="p3m", p3m_auto_refresh=True)
    # a new softening is a new graph key: the first step's force runs
    # eagerly, then captures; the second replays
    s.update_params(DEMO_PARAMS[0].replace(softening=0.2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s.update_many(2)
        s.synchronize()
    got = span_paths(prof)
    force = ("nbody.step", "nbody.force")
    for stage in ("nbody.p3m.tables", "nbody.p3m.pairs", "nbody.pm.deposit", "nbody.pm.solve",
                  "nbody.pm.gather"):
        assert force + (stage,) in got
        assert force + ("nbody.graph.capture", stage) in got
    assert force + ("nbody.graph.replay",) in got
    assert ("nbody.p3m.probe", "nbody.host_read") in got
