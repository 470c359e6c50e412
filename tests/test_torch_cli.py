"""nbody_tpu_torch.cli, and the port's independence from JAX."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig, ic
from nbody_tpu.io import write_tipsy_file

from nbody_tpu_torch.cli import build_parser, main

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_qatest_on_cpu_passes(capsys):
    assert main(["--qatest", "--numbodies", "512", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "512 bodies on cpu [torch kernel, fp32]" in out and "-> OK" in out


def test_compare_with_hostmem_and_block_size(capsys):
    assert main(["--compare", "--numbodies", "300", "--cpu", "--hostmem",
                 "--blockSize", "128", "--variant", "vpu"]) == 0
    assert "host memory" in capsys.readouterr().out


def test_benchmark_on_cpu_prints_reference_format(capsys):
    assert main(["--benchmark", "--numbodies", "256", "-i", "2", "--cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("256 bodies, total time for 2 iterations:")
    assert out[2].endswith("billion interactions per second")
    assert out[3].endswith("single-precision GFLOP/s at 20 flops per interaction")


def test_tipsy_input(tmp_path, capsys):
    pos, vel = ic.generate(NBodyConfig.SHELL, 200, 1.52, 2.0, seed=4)
    path = tmp_path / "galaxy.tipsy"
    write_tipsy_file(path, pos, vel)
    assert main(["--qatest", "--cpu", "--tipsy", str(path)]) == 0
    out = capsys.readouterr().out
    assert f"bodies from {path}" in out and "-> OK" in out


def test_no_mode_is_a_usage_error(capsys):
    assert main(["--cpu", "--numbodies", "64"]) == 2
    assert "--benchmark" in capsys.readouterr().err


def test_card_required_without_cpu_flag(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--qatest", "--numbodies", "64"]) == 3
    assert "is_available" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--fp64"], ["--devices", "2"], ["--kernel", "xla"],
                                  ["--render"], ["--integrator", "hermite"],
                                  ["--variant", "mxu"]])
def test_unported_flags_are_rejected(flag):
    with pytest.raises(SystemExit) as e:
        build_parser().parse_args(["--qatest", *flag])
    assert e.value.code == 2


def test_port_imports_no_jax(tmp_path):
    """A fresh interpreter imports the port and runs its CLI on the sym +
    leapfrog path and on a tipsy file without JAX and without any module
    of nbody_tpu: the port keeps its own copies."""
    code = (
        "import sys\n"
        "import nbody_tpu_torch, nbody_tpu_torch.compute, nbody_tpu_torch.cli, "
        "nbody_tpu_torch.models, nbody_tpu_torch.io, nbody_tpu_torch.oracle\n"
        "from nbody_tpu_torch import Compute, BodySystem, NBodyConfig, ic\n"
        "from nbody_tpu_torch.io import write_tipsy_file\n"
        "rc = nbody_tpu_torch.cli.main(['--qatest', '--numbodies', '128', '--cpu', "
        "'--variant', 'sym', '--integrator', 'leapfrog'])\n"
        "write_tipsy_file(sys.argv[1], *ic.generate(NBodyConfig.SHELL, 100, 1.52, 2.0))\n"
        "rc |= nbody_tpu_torch.cli.main(['--qatest', '--cpu', '--tipsy', sys.argv[1]])\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'nbody_tpu') "
        "or m.startswith(('jax.', 'jaxlib', 'nbody_tpu.')))\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "g.tipsy")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_module_entry_point():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch.cli", "--qatest", "--numbodies", "128", "--cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "-> OK" in proc.stdout
    assert np.isfinite(float(proc.stdout.split("max |dpos| = ")[1].split()[0]))
