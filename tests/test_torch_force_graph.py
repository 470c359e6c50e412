"""The rule that decides where a system's force is replayed as a CUDA graph
(``nbody_tpu_torch/ops/force_graph.py``), and the CPU path, which never
captures: its force calls count as eager only, with the eager bits. The
graphs themselves are held to the eager chain on the card
(``tests/test_torch_force_graph_cuda.py``)."""

import pytest
import torch

from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.ops import cuda_kernel, p3m, pm
from nbody_tpu_torch.ops.force_graph import ForceGraphs, graph_engages

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
MESH = object()  # any mesh


@pytest.mark.parametrize("device, mesh, kernel, backend, short_range, engages", [
    (CUDA, None, "p3m", "cuda", "pallas", True),
    (CUDA, None, "p3m", "cuda", "auto", True),
    (CUDA, None, "pm", "cuda", "pallas", True),
    (CUDA, None, "pm", "cuda", "xla", True),   # pm has no short range
    (CPU, None, "p3m", "torch", "pallas", False),
    (CPU, None, "pm", "torch", "pallas", False),
    (CUDA, MESH, "p3m", "cuda", "pallas", False),
    (CUDA, MESH, "pm", "cuda", "pallas", False),
    (CUDA, None, "p3m", "cuda", "xla", False),
    (CUDA, None, "p3m", "torch", "pallas", False),
    (CUDA, None, "pm", "torch", "pallas", False),
    (CUDA, None, "auto", "cuda", "pallas", False),
    (CUDA, MESH, "auto", "cuda", "pallas", False),
])
def test_graph_engages(device, mesh, kernel, backend, short_range, engages):
    assert graph_engages(device, mesh=mesh, kernel=kernel, backend=backend,
                         short_range=short_range) is engages


def _system(n=1024, **kw):
    pos, vel = ic.generate(NBodyConfig.SHELL, n, 1.54, 8.0, seed=5)
    return BodySystem(n, DEMO_PARAMS[0], device="cpu", state=(pos, vel), pm_grid=16, **kw)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("kw", [dict(kernel="p3m"), dict(kernel="p3m", p3m_short_range="xla"),
                                dict(kernel="pm"), dict(kernel="p3m", dtype=torch.float64)],
                         ids=["p3m", "p3m-xla", "pm", "p3m-fp64"])
def test_the_cpu_path_never_captures(kw, integrator):
    s = _system(integrator=integrator, **kw)
    launches = dict(cuda_kernel.LAUNCHES)
    s.update_many(3)
    _ = s.accelerations()
    assert not s._force_graphs.enabled
    assert s.force_calls == {"eager": 4, "capture": 0, "replay": 0}
    assert not s._force_graphs._graphs
    assert cuda_kernel.LAUNCHES == launches


def test_adaptive_forces_count_as_eager_on_the_cpu():
    s = _system(kernel="p3m", integrator="leapfrog")
    s.update_many_adaptive(3)
    # the leapfrog's starting force, then one a step
    assert s.force_calls == {"eager": 4, "capture": 0, "replay": 0}


@pytest.mark.parametrize("integrator", ["euler", "hermite"])
def test_all_pairs_forces_are_not_counted(integrator):
    s = _system(256, integrator=integrator)
    s.update_many(2)
    _ = s.accelerations()
    assert s.force_calls == {"eager": 0, "capture": 0, "replay": 0}


def test_a_disabled_force_graphs_runs_every_call_eagerly():
    graphs = ForceGraphs(False)
    pos = torch.ones((8, 4), dtype=torch.float64)
    calls = []

    def fn(p):
        calls.append(p)
        return p[:, :3].to(torch.float32) * 2

    outs = [graphs("key", fn, pos) for _ in range(3)]
    assert len(calls) == 3 and graphs.calls == {"eager": 3, "capture": 0, "replay": 0}
    assert all(o.dtype == torch.float64 and torch.equal(o, pos[:, :3] * 2) for o in outs)


def test_the_key_holds_what_the_launches_bake_in():
    """The P3M key changes with the capacity and the softening (and holds
    N, the grid and the assignment); its function is the system's force."""
    s = _system(kernel="p3m")
    n, soft = s.num_bodies, s.params.softening
    key, fn = s._mesh_solver_force(n, soft)
    assert key == ("p3m", n, 16, "cic", s.p3m_capacity, p3m.p3m_kernel_blk(s.p3m_capacity), soft)
    assert s._mesh_solver_force(n, soft)[0] == key
    assert s._mesh_solver_force(n, soft * 2)[0] != key
    s.p3m_capacity += 8
    assert s._mesh_solver_force(n, soft)[0] != key
    s.p3m_capacity -= 8
    pos = s.state[0]
    want = p3m.p3m_accel(pos, soft, grid=16, capacity=s.p3m_capacity)[0]
    assert torch.equal(fn(pos), want)
    assert torch.equal(s.accelerations(), want)


def test_the_pm_key_and_force():
    s = _system(kernel="pm", pm_assignment="tsc")
    key, fn = s._mesh_solver_force(s.num_bodies, s.params.softening)
    assert key == ("pm", s.num_bodies, 16, "tsc")
    pos = s.state[0]
    assert torch.equal(fn(pos), pm.pm_accel(pos, grid=16, assignment="tsc"))
