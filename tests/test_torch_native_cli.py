"""The port's native oracle CLI (nbody_tpu_torch/oracle/nbody_cli.cpp), held
to nbody_tpu's built binary: the same source apart from comments, the same
--compare output and exit codes for a seed and each integrator, and the
same --benchmark line format."""

import os
import pathlib
import re
import shutil
import subprocess

import pytest

from nbody_tpu.oracle import build as jax_build

from nbody_tpu_torch.oracle import build

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def clis():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native CLI cannot be built here")
    ours = build.build_cli(verbose=False)
    theirs = jax_build.CLI if jax_build.CLI.exists() else jax_build.build_cli(verbose=False)
    return ours, theirs


def _run(cli, *args, env=None):
    return subprocess.run([str(cli), *args], capture_output=True, text=True, timeout=300,
                          env=env)


def _code(path: pathlib.Path) -> list:
    """The source's lines without // comments and blank lines."""
    lines = []
    for line in path.read_text().splitlines():
        code = re.sub(r"//.*$", "", line).rstrip()
        if code.strip():
            lines.append(code)
    return lines


def test_source_equals_nbody_tpu_apart_from_comments():
    assert _code(build.HERE / "nbody_cli.cpp") == _code(jax_build.CLI_SRC)


def test_binary_lives_in_the_ports_build_directory(clis):
    ours, _ = clis
    assert ours.parent == REPO / "build" / "nbody_tpu_torch"
    assert ours == build.cli_path() and os.access(ours, os.X_OK)
    # the hash names the sources and flags: the sanitized build is another file
    assert build.cli_path(sanitize=True) != ours


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
@pytest.mark.parametrize("seed", ["42", "7"])
def test_compare_output_equals_nbody_tpu(clis, integrator, seed):
    ours, theirs = clis
    args = ("--compare", "--numbodies", "384", "--seed", seed, "--integrator", integrator)
    a, b = _run(ours, *args), _run(theirs, *args)
    assert a.returncode == b.returncode == 0, a.stderr
    assert a.stdout == b.stdout
    assert "-> OK" in a.stdout


def _format(text: str) -> list:
    return [re.sub(r"\d+(\.\d+)?", "#", line) for line in text.splitlines()]


@pytest.mark.parametrize("flags", [(), ("--fp64",), ("--integrator", "hermite")])
def test_benchmark_format_equals_nbody_tpu(clis, flags):
    ours, theirs = clis
    args = ("--benchmark", "--numbodies", "256", "-i", "3", *flags)
    a, b = _run(ours, *args), _run(theirs, *args)
    assert a.returncode == b.returncode == 0, a.stderr
    assert _format(a.stdout) == _format(b.stdout)
    word = "double" if flags == ("--fp64",) else "single"
    assert f"{word}-precision GFLOP/s at" in a.stdout
    assert a.stdout.splitlines()[-3].startswith("256 bodies, total time for 3 iterations:")


@pytest.mark.parametrize("args", [("--bogus",), ("--compare", "--integrator", "rk4"),
                                  ("--benchmark", "--numbodies", "-5"), ("--seed",),
                                  ("--help",), ()])
def test_exit_codes_equal_nbody_tpu(clis, args):
    ours, theirs = clis
    a, b = _run(ours, *args), _run(theirs, *args)
    assert a.returncode == b.returncode
    assert a.stdout == b.stdout and a.stderr == b.stderr


def test_sanitized_build_runs_clean(clis):
    """The ASan + UBSan build of the CLI on the oracle passes a compare
    run, as nbody_tpu's sanitized build does (its test is marked slow;
    this one builds in seconds)."""
    cli = build.build_cli(verbose=False, sanitize=True)
    env = dict(os.environ, ASAN_OPTIONS="strict_string_checks=1:detect_stack_use_after_return=1:"
               "check_initialization_order=1:detect_leaks=1",
               UBSAN_OPTIONS="print_stacktrace=1")
    r = _run(cli, "--compare", "--numbodies", "512", "--integrator", "hermite", env=env)
    assert r.returncode == 0, r.stderr
    assert "-> OK" in r.stdout
