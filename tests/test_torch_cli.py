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

from nbody_tpu_torch.cli import build_parser, drift_failed, main
from nbody_tpu_torch.ops import cuda_kernel

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
    """With no mode flag the demo loop runs, as nbody's does; what is a usage
    error there is a demo preset out of range (exit 2)."""
    assert main(["--cpu", "--numbodies", "64", "--frames", "2"]) == 0
    assert "64 bodies on cpu" in capsys.readouterr().out
    assert main(["--cpu", "--numbodies", "64", "--demo", "7"]) == 2
    assert "--demo 7 out of range (presets 0..6)" in capsys.readouterr().err


def test_card_required_without_cpu_flag(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--qatest", "--numbodies", "64"]) == 3
    assert "is_available" in capsys.readouterr().err


# --block-dt, --tile-j, --dt-max and --block-classes stand where the run-setup
# and demo slice brought --demo 1, --render, --energy and --config plummer
# (as --demo 1 stood for --fp64, and --adaptive-dt for --devices 2, before);
# --dt-max and --block-classes (adaptive and block timesteps, ROADMAP.md
# Queue 1 #7) took the places of --pm-assignment and --p3m-auto-refresh when
# the mesh solvers' options were ported
@pytest.mark.parametrize("flag", [["--block-dt"],
                                  ["--adaptive-dt"],
                                  ["--kernel", "xla"],
                                  ["--tile-j", "64"], ["--dt-max", "0.01"],
                                  ["--block-classes", "4"]])
def test_unported_flags_are_rejected(flag):
    with pytest.raises(SystemExit) as e:
        build_parser().parse_args(["--qatest", *flag])
    assert e.value.code == 2


@pytest.mark.parametrize("args, message", [
    (["--devices", "2"], "requested 2 devices but only 1 available"),
    (["--devices", "2", "--precision", "ds"], "requested 2 devices but only 1 available"),
    (["--devices", "0"], "--devices must be at least 1"),
    # --strategy sym and --mesh-rows were refused, naming #13, until that
    # item brought them; their ids keep it, and they now meet the world
    pytest.param(["--strategy", "sym", "--devices", "2"],
                 "requested 2 devices but only 1 available", id="args3-ROADMAP.md Queue 1 #13"),
    # ring_fused with --precision ds, refused in nbody_tpu's words; the id
    # names the ROADMAP item that brought ring_fused
    pytest.param(["--strategy", "ring_fused", "--devices", "2", "--precision", "ds"],
                 "(ring_fused and sym are fp32 mesh paths)",
                 id="args4-ROADMAP.md Queue 2 #20"),
    pytest.param(["--mesh-rows", "2", "--devices", "4"],
                 "requested 2x2 devices but only 1 available", id="args5-ROADMAP.md Queue 1 #13"),
])
def test_mesh_flags_outside_a_matching_world_exit_2(args, message, capsys):
    # one process, no torchrun: the world is this process alone
    assert main(["--qatest", "--numbodies", "64", "--cpu", *args]) == 2
    assert message in capsys.readouterr().err


def test_devices_1_builds_no_mesh(capsys):
    assert main(["--qatest", "--numbodies", "64", "--cpu", "--devices", "1",
                 "--strategy", "ring"]) == 0
    assert "mesh" not in capsys.readouterr().out


def test_hermite_qatest_on_cpu(capsys):
    assert main(["--integrator", "hermite", "--qatest", "--numbodies", "512", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "integrator hermite" in out and "max |djerk|" in out and "-> OK" in out


@pytest.mark.parametrize("variant", ["vpu", "sym"])
def test_drift_check_on_cpu_passes(capsys, variant):
    assert main(["--drift-check", "3", "--numbodies", "256", "--cpu", "--integrator", "hermite",
                 "--variant", variant]) == 0
    assert "energy drift over 3 steps" in capsys.readouterr().out


def test_drift_check_failure_exits_1(monkeypatch, capsys):
    from nbody_tpu_torch.compute import Compute

    def failing(self, steps):
        return {"steps": steps, "drift_device": 1e-2, "drift_oracle": 1e-6, "delta": 1e-2 - 1e-6}

    monkeypatch.setattr(Compute, "drift_check", failing)
    assert main(["--drift-check", "3", "--numbodies", "64", "--cpu"]) == 1
    assert "drift check FAILED" in capsys.readouterr().err


@pytest.mark.parametrize("delta, oracle, failed", [(4e-4, 1e-6, False), (6e-4, 1e-6, True),
                                                   (4e-3, 0.1, False), (6e-3, 0.1, True)])
def test_drift_gate_is_the_jax_clis(delta, oracle, failed):
    # nbody_tpu/cli.py:838-841: fail when delta > max(5e-4, 0.05 |oracle drift|)
    assert drift_failed({"delta": delta, "drift_oracle": oracle}) is failed


def test_drift_check_needs_a_step(capsys):
    """A drift check over 0 steps runs and exits 0, as nbody_tpu's does; a
    negative count is a usage error."""
    assert main(["--drift-check", "0", "--cpu", "--numbodies", "64"]) == 0
    assert "energy drift over 0 steps" in capsys.readouterr().out
    assert main(["--drift-check", "-1", "--cpu", "--numbodies", "64"]) == 2
    assert "--drift-check" in capsys.readouterr().err


@pytest.mark.parametrize("n", [0, -5])
def test_numbodies_below_one_exits_2(n, capsys):
    assert main(["--qatest", "--cpu", "--numbodies", str(n)]) == 2
    assert "--numbodies must be at least 1" in capsys.readouterr().err


@pytest.mark.parametrize("precision", ["fp32", "ds"])
def test_block_size_is_free_on_the_cpu(precision, capsys):
    """The CPU path has no thread blocks: --blockSize 100 runs there, as
    nbody_tpu's XLA path ignores it; the card's kernels still refuse it."""
    assert main(["--qatest", "--cpu", "--numbodies", "128", "--blockSize", "100",
                 "--precision", precision]) == 0
    assert "-> OK" in capsys.readouterr().out
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_kernel.check_block_size(100)


def test_port_imports_no_jax(tmp_path):
    """A fresh interpreter imports the port and runs its CLI on the sym +
    leapfrog path, the sym Hermite drift check, the ds path, a tipsy file,
    the demo loop (galaxy, frames, animation, energy, checkpoint, profile)
    and a resumed selftest, and a ds ring step on a one-rank gloo mesh,
    without JAX and without any
    module of nbody_tpu: the port keeps its own copies. It destroys the
    mesh's process group before it exits, as the CLI does: a gloo group
    alive at interpreter shutdown aborted such a process now and then
    (SIGABRT, "terminate called without an active exception")."""
    code = (
        "import sys\n"
        "import nbody_tpu_torch, nbody_tpu_torch.compute, nbody_tpu_torch.cli, "
        "nbody_tpu_torch.models, nbody_tpu_torch.io, nbody_tpu_torch.oracle, "
        "nbody_tpu_torch.models.ds_system, nbody_tpu_torch.ops.ds, nbody_tpu_torch.render, "
        "nbody_tpu_torch.ui, nbody_tpu_torch.ui.terminal_view, nbody_tpu_torch.io.apng, "
        "nbody_tpu_torch.io.avi, nbody_tpu_torch.utils.profiling, "
        "nbody_tpu_torch.oracle.build\n"
        "from nbody_tpu_torch import Compute, BodySystem, NBodyConfig, ic\n"
        "from nbody_tpu_torch.io import write_tipsy_file\n"
        "rc = nbody_tpu_torch.cli.main(['--qatest', '--numbodies', '128', '--cpu', "
        "'--variant', 'sym', '--integrator', 'leapfrog'])\n"
        "rc |= nbody_tpu_torch.cli.main(['--drift-check', '2', '--numbodies', '128', '--cpu', "
        "'--variant', 'sym', '--integrator', 'hermite'])\n"
        "rc |= nbody_tpu_torch.cli.main(['--precision', 'ds', '--qatest', '--numbodies', '128', "
        "'--cpu', '--integrator', 'leapfrog'])\n"
        "write_tipsy_file(sys.argv[1], *ic.generate(NBodyConfig.SHELL, 100, 1.52, 2.0))\n"
        "rc |= nbody_tpu_torch.cli.main(['--qatest', '--cpu', '--tipsy', sys.argv[1]])\n"
        "rc |= nbody_tpu_torch.cli.main(['--cpu', '--numbodies', '128', '--frames', '2', "
        "'--render', '--outdir', sys.argv[2], '--width', '32', '--height', '24', '--config', "
        "'galaxy', '--energy', '--animate', sys.argv[2] + '/a.avi', '--checkpoint-save', "
        "sys.argv[2] + '/c.npz', '--profile', sys.argv[2]])\n"
        "rc |= nbody_tpu_torch.cli.main(['--cpu', '--selftest', '--numbodies', '128', "
        "'--checkpoint-load', sys.argv[2] + '/c.npz', '--print-params', '--set', "
        "'time_step=0.01'])\n"
        "from nbody_tpu_torch.parallel import make_mesh\n"
        "from nbody_tpu_torch.models import DSBodySystem\n"
        "s = DSBodySystem(64, nbody_tpu_torch.DEMO_PARAMS[0], device='cpu', strategy='ring', "
        "mesh=make_mesh(1, device='cpu'))\n"
        "s.update()\n"
        "assert s.strategy == 'ring' and s.positions.shape == (64, 4)\n"
        "import torch.distributed\n"
        "torch.distributed.destroy_process_group()\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'nbody_tpu') "
        "or m.startswith(('jax.', 'jaxlib', 'nbody_tpu.')))\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "g.tipsy"),
                           str(tmp_path / "demo")],
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
