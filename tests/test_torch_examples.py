"""The port's examples (``examples/*_torch.py``) on the CPU at tiny sizes:
each runs through its ``main(argv)`` with ``--cpu`` (multichip_sim under
torchrun on two gloo ranks) and must exit 0 and print its result line.
None imports JAX or nbody_tpu. (examples/fit_softening_torch.py has its own
test in tests/test_torch_diff.py.)"""

import ast
import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("plummer_relaxation", "adaptive_collapse", "collapsing_cluster", "benchmark_sweep",
            "galaxy_collision_movie", "multichip_sim", "fit_softening")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_torch",
                                                  REPO / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_neither_jax_nor_nbody_tpu(name):
    tree = ast.parse((REPO / "examples" / f"{name}_torch.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "nbody_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "nbody_tpu"}, roots


@pytest.mark.parametrize("name, argv, says", [
    ("plummer_relaxation", ["--cpu"], "rate*N="),
    ("adaptive_collapse", ["--cpu", "--numbodies", "128", "--time", "0.2"], "adaptive eta=0.01"),
    ("collapsing_cluster", ["--cpu", "--numbodies", "256", "--steps", "40"],
     "engine=pallas"),
    ("collapsing_cluster", ["--cpu", "--numbodies", "256", "--steps", "40", "--manual",
                            "--short-range", "xla"], "engine=xla"),
    ("benchmark_sweep", ["--cpu", "128"], "p3m"),
])
def test_example_runs_on_the_cpu(capsys, name, argv, says):
    assert _load(name).main(argv) == 0
    out = capsys.readouterr().out
    assert says in out and "failed" not in out, out


def test_galaxy_collision_movie_writes_frames(tmp_path, capsys):
    outdir = tmp_path / "frames"
    assert _load("galaxy_collision_movie").main(
        [str(outdir), "--cpu", "--numbodies", "256", "--frames", "2", "--width", "96",
         "--height", "72"]) == 0
    assert "wrote 2 frames" in capsys.readouterr().out
    assert len(list(outdir.glob("*.png"))) == 2


def test_multichip_sim_under_torchrun(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         str(REPO / "examples" / "multichip_sim_torch.py"), "--cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    for line in ("2048 bodies over 2 cpu ranks x 10 steps: finite=True",
                 "2-D decomposition (2x1): finite=True", "sharded P3M + slab FFT"):
        assert out.count(line) == 1, out  # rank 0 alone prints
