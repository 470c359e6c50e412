"""The port's own copies of nbody_tpu's numpy modules, held to the originals.

nbody_tpu_torch imports nothing of nbody_tpu: it keeps copies of params,
config, ic, the tipsy and checkpoint readers and the CPU oracle. The two
packages' enums and dataclasses are distinct types, so they are compared by
name and value."""

import dataclasses
import pathlib

import numpy as np
import pytest

import nbody_tpu
import nbody_tpu.oracle as jax_oracle
from nbody_tpu import ic as jax_ic
from nbody_tpu import params as jax_params
from nbody_tpu.config import NBodyConfig as JaxNBodyConfig
from nbody_tpu.io import read_tipsy_file as jax_read_tipsy
from nbody_tpu.io import save_checkpoint, write_tipsy_file

import nbody_tpu_torch
from nbody_tpu_torch import ic, params
from nbody_tpu_torch.config import NBodyConfig
from nbody_tpu_torch.io import load_checkpoint, read_tipsy_file
from nbody_tpu_torch.oracle import build as oracle_build
from nbody_tpu_torch.oracle import native, step_best

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_config_is_its_own_enum_with_the_same_members():
    assert NBodyConfig is not JaxNBodyConfig
    assert [(c.name, c.value) for c in NBodyConfig] == \
        [(c.name, c.value) for c in JaxNBodyConfig]
    assert NBodyConfig.parse("Shell") is NBodyConfig.SHELL
    with pytest.raises(ValueError):
        NBodyConfig.parse("disk")


@pytest.mark.parametrize("name", [c.name for c in JaxNBodyConfig])
def test_ic_generate_bit_equal(name):
    for dtype in (np.float32, np.float64):
        ours = ic.generate(NBodyConfig[name], 1000, 1.54, 8.0, seed=5, dtype=dtype)
        theirs = jax_ic.generate(JaxNBodyConfig[name], 1000, 1.54, 8.0, seed=5, dtype=dtype)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_galaxy_ics_bit_equal():
    for a, b in zip(ic.galaxy_collision(600, seed=3), jax_ic.galaxy_collision(600, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_params_and_tables_equal():
    assert [dataclasses.asdict(p) for p in params.DEMO_PARAMS] == \
        [dataclasses.asdict(p) for p in jax_params.DEMO_PARAMS]
    assert dataclasses.asdict(params.NBodyParams()) == \
        dataclasses.asdict(jax_params.NBodyParams())
    assert params.DEMO_TIME_S == jax_params.DEMO_TIME_S
    for n in (1, 1024, 1025, 4096, 16384, 32768, 32769, 10**6):
        assert params.tuned_scales(n) == jax_params.tuned_scales(n)
    for fp64 in (False, True):
        assert params.flops_per_interaction(fp64) == jax_params.flops_per_interaction(fp64)
        assert params.gflops(4096, 3.5, fp64) == jax_params.gflops(4096, 3.5, fp64)
    assert params.DEMO_PARAMS[2].print_values() == jax_params.DEMO_PARAMS[2].print_values()


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
def test_oracle_step_equals_nbody_tpu(integrator):
    pos, vel = jax_ic.generate(JaxNBodyConfig.RANDOM, 700, 1.54, 8.0, seed=2)
    pos[:, 3] = np.random.default_rng(1).uniform(0.5, 2.0, 700).astype(np.float32)
    ours = step_best(pos, vel, 0.001, 0.1, 0.5, integrator=integrator)
    theirs = jax_oracle.step_best(pos, vel, 0.001, 0.1, 0.5, integrator=integrator)
    # the same sources, flags and dispatch: the same bits
    assert native.native_available() == jax_oracle.native_available()
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_oracle_library_is_the_ports_own():
    lib = oracle_build.library_path()
    assert lib.parent == REPO / "build" / "nbody_tpu_torch"
    assert not lib.is_relative_to(pathlib.Path(nbody_tpu.__file__).parent)
    if native.native_available():
        assert lib.exists()


def test_tipsy_reader_equals_nbody_tpu(tmp_path, monkeypatch):
    pos, vel = jax_ic.generate(JaxNBodyConfig.SHELL, 300, 1.52, 2.0, seed=4)
    path = tmp_path / "g.tipsy"
    write_tipsy_file(path, pos, vel, n_dark=100)
    for numpy_path in (False, True):
        if numpy_path:
            monkeypatch.setenv("NBODY_TIPSY_NUMPY", "1")
        for a, b in zip(read_tipsy_file(path), jax_read_tipsy(path)):
            assert a.shape == (512, 4)
            np.testing.assert_array_equal(a, b)


def test_checkpoint_reader_reads_nbody_tpu_checkpoints(tmp_path):
    pos, vel = jax_ic.generate(JaxNBodyConfig.SHELL, 64, 1.52, 2.0, seed=4)
    p = jax_params.DEMO_PARAMS[3]
    save_checkpoint(tmp_path / "c.npz", pos, vel, p, step=5, config=JaxNBodyConfig.EXPAND)
    lp, lv, lparams, meta = load_checkpoint(tmp_path / "c.npz")
    np.testing.assert_array_equal(lp, pos)
    np.testing.assert_array_equal(lv, vel)
    assert isinstance(lparams, nbody_tpu_torch.NBodyParams)
    assert dataclasses.asdict(lparams) == dataclasses.asdict(p)
    assert meta["step"] == 5 and NBodyConfig(meta["config"]) is NBodyConfig.EXPAND
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(tmp_path)
