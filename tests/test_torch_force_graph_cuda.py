"""The one-card mesh-solver force replayed as a CUDA graph
(``nbody_tpu_torch/ops/force_graph.py``), held bit for bit to the eager
chain composed by hand from the ops functions, which never capture:
``p3m.p3m_accel`` or ``pm.pm_accel`` with ``reference.integrate``,
``reference.nbody_step_leapfrog`` or ``adaptive.make_adaptive_rollout``,
at the capacities that the system recorded in ``p3m_refreshes``.

Every test here needs an NVIDIA GPU: each carries the ``cuda`` marker and
skips without a card. The file imports no JAX:

    python -m pytest tests/test_torch_force_graph_cuda.py --noconftest -q -m cuda
"""

import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.ops import cuda_kernel, force_graph, p3m, pm, reference
from nbody_tpu_torch.ops.adaptive import make_adaptive_rollout

pytestmark = pytest.mark.cuda

PARAMS = DEMO_PARAMS[0]
GRID = 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _state(n, dev, dtype=torch.float32):
    pos, vel = ic.generate(NBodyConfig.SHELL, n, PARAMS.cluster_scale, PARAMS.velocity_scale,
                           seed=3)
    return (torch.tensor(pos, device=dev, dtype=dtype),
            torch.tensor(vel, device=dev, dtype=dtype))


def _system(n, dev, dtype=torch.float32, **kw):
    pos, vel = _state(n, dev, dtype)
    return BodySystem(n, PARAMS, device=dev, dtype=dtype, state=(pos, vel), pm_grid=GRID, **kw)


def _p3m_eager(cap, soft):
    """The eager P3M force at capacity `cap`, in the state's type."""
    def accel(p):
        return p3m.p3m_accel(p.to(torch.float32), soft, grid=GRID, capacity=cap,
                             backend="cuda", short_range="pallas")[0].to(p.dtype)

    return accel


def _pm_eager(p):
    return pm.pm_accel(p.to(torch.float32), grid=GRID).to(p.dtype)


def _eager_steps(pos, vel, steps, integrator, params, accel_of_step):
    """`steps` steps of the eager chain; `accel_of_step(j)` is step j's force."""
    dt, soft, damping = params.time_step, params.softening, params.damping
    for j in range(steps):
        accel = accel_of_step(j)
        if integrator == "leapfrog":
            pos, vel = reference.nbody_step_leapfrog(pos, vel, dt, soft, damping, accel_fn=accel)
        else:
            pos, vel = reference.integrate(pos, vel, accel(pos), dt, damping)
    return pos, vel


def _capacity_of_step(cap0, refreshes):
    """Step j's capacity: cap0, then each refresh's from the step after it."""
    def cap(j):
        out = cap0
        for step, before, after in refreshes:
            if step < j:
                assert before == out
                out = after
        return out

    return cap


def _assert_same_state(s, pos, vel):
    got_pos, got_vel = s.state
    assert torch.equal(got_pos, pos)
    assert torch.equal(got_vel, vel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_graphed_p3m_steps_are_the_eager_bits(dev, integrator, dtype):
    """200 steps at N = 65536 with the auto-refresh, across at least one
    capacity change; a capture at most once a key."""
    s = _system(65536, dev, dtype, kernel="p3m", integrator=integrator, p3m_auto_refresh=True)
    pos0, vel0 = (t.clone() for t in s.state)
    cap0 = s.p3m_capacity
    s.update_many(200)
    assert s.p3m_refreshes, "no capacity change in 200 steps"
    caps = {cap0} | {after for _, _, after in s.p3m_refreshes}
    calls = s.force_calls
    assert calls["capture"] == calls["eager"] <= len(caps)
    assert calls["replay"] >= 200 - len(caps)
    cap = _capacity_of_step(cap0, s.p3m_refreshes)
    pos, vel = _eager_steps(pos0, vel0, 200, integrator, PARAMS,
                            lambda j: _p3m_eager(cap(j), PARAMS.softening))
    _assert_same_state(s, pos, vel)


def test_graphed_pm_steps_are_the_eager_bits(dev):
    s = _system(65536, dev, kernel="pm")
    pos0, vel0 = (t.clone() for t in s.state)
    s.update_many(200)
    assert s.force_calls == {"eager": 1, "capture": 1, "replay": 199}
    pos, vel = _eager_steps(pos0, vel0, 200, "euler", PARAMS, lambda j: _pm_eager)
    _assert_same_state(s, pos, vel)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_graphed_adaptive_steps_are_the_eager_bits(dev, integrator):
    """update_many_adaptive: the rollout's forces, the leapfrog's carried
    one too, are the eager bits; a breach warns and advances (no refresh),
    as the eager rollout does."""
    s = _system(65536, dev, kernel="p3m", integrator=integrator)
    pos0, vel0 = (t.clone() for t in s.state)
    cap = s.p3m_capacity
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.update_many_adaptive(60)
    dt_max = PARAMS.time_step
    run = make_adaptive_rollout(
        integrator, accel_fn=_p3m_eager(cap, PARAMS.softening), softening=PARAMS.softening,
        damping=PARAMS.damping, eta=0.025, dt_min=dt_max / 1024.0, dt_max=dt_max, steps=60,
        probe_fn=lambda p: p3m.p3m_overflow_count(p.to(torch.float32), grid=GRID,
                                                  capacity=cap) > 0)
    pos, vel = run(pos0, vel0)[:2]
    _assert_same_state(s, pos, vel)
    assert s.force_calls["replay"] >= 59


def test_a_softening_change_gives_the_eager_bits(dev):
    s = _system(65536, dev, kernel="p3m")
    pos0, vel0 = (t.clone() for t in s.state)
    cap = s.p3m_capacity
    other = PARAMS.replace(softening=0.2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.update_many(10)
        s.update_params(other)
        s.update_many(10)
    assert s.force_calls == {"eager": 2, "capture": 2, "replay": 18}
    pos, vel = _eager_steps(pos0, vel0, 10, "euler", PARAMS,
                            lambda j: _p3m_eager(cap, PARAMS.softening))
    pos, vel = _eager_steps(pos, vel, 10, "euler", other, lambda j: _p3m_eager(cap, 0.2))
    _assert_same_state(s, pos, vel)


def test_accelerations_across_a_replay_are_the_callers_own(dev):
    s = _system(16384, dev, kernel="p3m")
    s.update_many(2)  # eager and its capture, then a replay
    first = s.accelerations()
    kept = first.clone()
    s.update_many(1)
    second = s.accelerations()
    assert s.force_calls == {"eager": 1, "capture": 1, "replay": 4}
    assert second.data_ptr() != first.data_ptr()
    assert torch.equal(first, kept)
    assert torch.equal(second, _p3m_eager(s.p3m_capacity, PARAMS.softening)(s.state[0]))


def test_each_step_counts_one_pair_kernel_launch(dev):
    s = _system(16384, dev, kernel="p3m", p3m_auto_refresh=True)
    kinds = []
    for _ in range(6):
        before = cuda_kernel.LAUNCHES["p3m_sr"]
        calls = dict(s.force_calls)
        s.update_many(1)
        assert cuda_kernel.LAUNCHES["p3m_sr"] == before + 1
        kinds += [k for k, v in s.force_calls.items() if v != calls[k]]
    # the first step's force runs eagerly and captures; the next replays
    assert kinds[:3] == ["eager", "capture", "replay"]


@pytest.mark.parametrize("kernel", ["p3m", "pm"])
def test_a_one_step_warm_up_covers_the_capture(dev, kernel):
    """Compute.run_benchmark's one untimed step runs each key's eager call
    and its capture, so every timed step replays."""
    from nbody_tpu_torch.compute import Compute

    c = Compute(num_bodies=16384, device=dev, kernel=kernel, log=lambda line: None)
    c.run_benchmark(5)
    assert c.system.force_calls == {"eager": 1, "capture": 1, "replay": 5}


def test_a_system_keeps_at_most_max_graphs(dev):
    s = _system(8192, dev, kernel="p3m")
    for k in range(force_graph.MAX_GRAPHS + 2):
        s.update_params(PARAMS.replace(softening=0.1 + 0.01 * k))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s.update_many(2)
    assert len(s._force_graphs._graphs) == force_graph.MAX_GRAPHS
    assert s.force_calls["capture"] == force_graph.MAX_GRAPHS + 2


def test_a_profiled_replay_holds_the_pair_kernel(dev):
    from test_torch_spans import span_paths

    s = _system(65536, dev, kernel="p3m", p3m_auto_refresh=True)
    s.update_many(1)  # eager, then its capture
    s.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s.update_many(1)
        s.synchronize()
    assert s.force_calls["replay"] == 1
    got = span_paths(prof)
    force = ("nbody.step", "nbody.force")
    assert force + ("nbody.graph.replay",) in got
    assert not any("nbody.p3m.tables" in p or "nbody.graph.capture" in p for p in got)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    replays = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
               if e.device_type() == cpu and e.name() == "nbody.graph.replay"]
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == cpu and "GraphLaunch" in e.name()}
    kernels = [e for e in events if e.device_type() == cuda and "p3m_sr_kernel" in e.name()]
    assert len(kernels) == 1
    t = launches[kernels[0].correlation_id()]
    assert any(a <= t <= b for a, b in replays)
