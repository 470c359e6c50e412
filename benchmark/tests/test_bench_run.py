"""Whole runs on the CPU at a small size (the look for a card skipped):
the result line's format, and ``correct`` false under each fault the cells
can have. The check's control, at a size a test run holds, fails the
cells' own limits where the program passes them."""

import math
import subprocess
import sys

import pytest
import torch

from benchmark import reference
from benchmark.harness import check, inputs, session, spec
from benchmark.tests.helpers import ROOT, run_cell

SINGLE = ["allpairs-euler-135k", "p3m-euler-1m", "allpairs-hermite-65k", "pm-cic-1m"]
MESH = "mesh4-auto-euler-1m"
SIZES = {"allpairs-euler-135k": 512, "p3m-euler-1m": 2048, "allpairs-hermite-65k": 512,
         "pm-cic-1m": 2048, MESH: 512}
CONTROL_SIZES = {"pm-cic-1m": 262144}


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace):
    code, line, err = run_cell("allpairs-hermite-65k", n=256, trace=trace)
    assert code == 0, err
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    cell = spec.cell("allpairs-hermite-65k")
    names = {m["name"]: m["unit"] for m in cell["per_layer" if trace else "end_to_end"]}
    assert set(line["metrics"]) <= set(names)
    for k, v in line["metrics"].items():
        assert v["unit"] == names[k] and isinstance(v["value"], float)
    if not trace:
        assert set(line["metrics"]) == set(names)
    else:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    # the compared numbers, each beside its limit, end standard error
    tail = err.strip().splitlines()[-2:]
    assert [t.split(":")[0] for t in tail] == ["check dpos_rel", "check start_exact"]
    assert set(line["checks"]) == {"dpos_rel", "start_exact"}


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", SINGLE[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("cell,fault", [(c, f) for c in SINGLE
                                        for f in ("unchanged", "half", "altered")]
                         + [(MESH, f) for f in ("unchanged", "exchange", "altered")])
def test_fault_is_not_correct(cell, fault):
    code, line, err = run_cell(cell, n=SIZES[cell], seconds=0.5, fault=fault)
    assert code == 0, err
    assert line["correct"] is False, line["checks"]


def _readings(cell_name, seed, n, control: bool, segments=(0, 8)):
    """The program's (or the control's) dpos_rel over `segments`."""
    cell = spec.cell(cell_name)
    wl, cfg = cell["workload"], cell["config"]
    rank = session.Rank(0, 1, "cpu", 0)
    compute, ic = session.build(cell, seed, rank, n=n)
    rec, kept, snaps = session.window(compute.system, ic, cell, math.inf, rank,
                                      list(segments), max_segments=max(segments) + 1)
    k = int(wl["steps_per_segment"])
    out = []
    for s in sorted(kept):
        cand = None
        if control:
            def cand(p, v):
                return reference.advance(p, v, k, config=cfg, integrator=wl["integrator"],
                                         precision="tf32")[0]
        gap, moved = check.segment_gap(kept[s], snaps[s], steps=k, config=cfg,
                                       integrator=wl["integrator"], candidate=cand)
        out.append(gap / moved)
    return max(out)


@pytest.mark.parametrize("cell", SINGLE)
def test_control_fails_where_the_program_passes(cell):
    # errors grow with N and with the collapse: 8192 bodies, segments 0 and
    # 8; PM's limit is set by the divergence of its first two-step segment
    # at 2^20, and its control's gap reaches it only at more bodies
    n = CONTROL_SIZES.get(cell, 8192)
    limit = spec.cell(cell)["workload"]["check"]["limits"]["dpos_rel"]
    assert _readings(cell, 21, n, control=False) <= limit
    assert _readings(cell, 21, n, control=True) > limit


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "allpairs-hermite-65k", "--seed", "3", "--seconds", "2", "--trace", "1"],
                       capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    import json

    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True


def test_inputs_are_the_seeds():
    a = inputs.shell(300, 1.54, 8.0, 2 ** 31 + 77)
    b = inputs.shell(300, 1.54, 8.0, 2 ** 31 + 77)
    c = inputs.shell(300, 1.54, 8.0, 2 ** 31 + 78)
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == c[0]).all()
