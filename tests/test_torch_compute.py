"""nbody_tpu_torch.compute.Compute: QA compare, benchmark, perf formulas, demos."""

import types

import pytest
import torch

from nbody_tpu.compute import Compute as JaxCompute
from nbody_tpu.params import gflops, interactions_per_second

from nbody_tpu_torch import DEMO_PARAMS
from nbody_tpu_torch import compute as compute_mod
from nbody_tpu_torch.compute import Compute, default_num_bodies


def _quiet(**kw):
    lines = []
    return Compute(device="cpu", log=lines.append, **kw), lines


def test_compare_results_passes_on_cpu():
    c, lines = _quiet(num_bodies=1024)
    before = c.system.positions
    assert c.compare_results() is True
    assert "-> OK" in lines[-1] and "max |dacc|" in lines[-1]
    # the compare leaves the state as it found it
    assert (c.system.positions == before).all()


def test_compare_results_fails_on_a_wrong_step():
    c, lines = _quiet(num_bodies=256)
    c.system.update_params(c.active_params.replace(damping=0.0))
    assert c.compare_results() is False
    assert "FAILED" in lines[-1]


def test_run_benchmark_returns_the_jax_keys():
    c, lines = _quiet(num_bodies=256)
    res = c.run_benchmark(2)
    ref = JaxCompute(num_bodies=128, backend="xla", log=lambda s: None).run_benchmark(1)
    assert set(res) == set(ref)
    assert res["num_bodies"] == 256 and res["iterations"] == 2 and res["fp64"] is False
    assert lines[0].startswith("256 bodies, total time for 2 iterations:")
    assert "billion interactions per second" in lines[1]
    assert "single-precision GFLOP/s at 20 flops per interaction" in lines[2]


def test_perf_formulas_equal_nbody_tpu():
    c, _ = _quiet(num_bodies=4096)
    c.compute_perf_stats(123.0)
    assert c.interactions_per_second == interactions_per_second(4096, 123.0)
    assert c.g_flops == gflops(4096, 123.0, False)


def test_default_num_bodies(monkeypatch):
    assert default_num_bodies("cpu") == 4096
    props = types.SimpleNamespace(multi_processor_count=132)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: props)
    assert default_num_bodies("cuda") == 4 * 256 * 132
    assert default_num_bodies("cuda", 128) == 4 * 128 * 132
    c, _ = _quiet()
    assert c.num_bodies == 4096


def test_demo_state_machine():
    c, _ = _quiet(num_bodies=256, cycle_demo=False)
    c.next_demo()
    assert c.active_demo == 1 and c.active_params == DEMO_PARAMS[1]
    c.previous_demo()
    c.previous_demo()
    assert c.active_demo == len(DEMO_PARAMS) - 1
    c.pause()
    before = c.system.positions
    c.update_simulation(steps=2)
    assert (c.system.positions == before).all() and c.steps_taken == 0
    c.pause()
    c.update_simulation(steps=2)
    assert c.steps_taken == 2 and not (c.system.positions == before).all()
    c.update_params(softening=0.5)
    assert c.system.params.softening == 0.5


def test_tipsy_state_sets_n_and_reset_restores_it():
    c0, _ = _quiet(num_bodies=300)
    state = (c0.system.positions, c0.system.velocities)
    c, _ = _quiet(tipsy_state=state)
    assert c.num_bodies == 300
    c.update_simulation(steps=1)
    c.reset(None)
    assert (c.system.positions == state[0]).all()


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Compute(device="cuda", num_bodies=64)
    with pytest.raises(RuntimeError):
        Compute(num_bodies=64)  # the default device is the card


def test_qa_constants_are_the_references():
    assert compute_mod.QA_TOLERANCE == 5e-4 and compute_mod.QA_DT == 0.001
