"""The port's demo loop, run setup and state I/O in its CLI, on --cpu,
against nbody_tpu's CLI: the --config states, --demo K parameters, --set /
--print-params text; --render, --animate, --autosave, --energy, --selftest,
--metrics, --version, --profile, --interactive and --live; checkpoint
resumes bit-exact in fp32, ds (the raw hi/lo planes) and fp64."""

import io
import json
import re

import jax
import numpy as np
import pytest
import torch

from nbody_tpu import cli as jax_cli

from nbody_tpu_torch import cli
from nbody_tpu_torch.compute import Compute
from nbody_tpu_torch.io import load_checkpoint, load_checkpoint_ds_planes
from nbody_tpu_torch.io.avi import read_avi

SMALL = ["--cpu", "--numbodies", "96", "--no-cycle", "--width", "48", "--height", "32"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _restore_jax_x64():
    """nbody_tpu's CLI turns JAX's x64 on for --fp64 and leaves it on, as a
    process of its own may; after each test it is set back, so that the
    JAX code of the test files that follow in this worker (the ring
    kernel's int32 indices) runs as it would alone."""
    x64 = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", x64)


# ---- run setup against nbody_tpu's CLI ----

@pytest.mark.parametrize("config", ["shell", "random", "expand", "plummer", "galaxy"])
def test_config_states_equal_nbody_tpu(tmp_path, config, capsys):
    """--config builds the same state and parameters as nbody_tpu's CLI
    (the plummer scale rule, the galaxy collision): zero frames, then the
    saved checkpoints compared bit for bit."""
    args = ["--cpu", "--numbodies", "200", "--frames", "0", "--config", config, "--seed", "5"]
    assert cli.main([*args, "--checkpoint-save", str(tmp_path / "ours.npz")]) == 0
    assert jax_cli.main([*args, "--checkpoint-save", str(tmp_path / "theirs.npz")]) == 0
    ours, theirs = load_checkpoint(tmp_path / "ours.npz"), load_checkpoint(tmp_path / "theirs.npz")
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert ours[2] == theirs[2]
    assert ours[3] == theirs[3]


@pytest.mark.parametrize("demo", range(7))
def test_demo_params_and_text_equal_nbody_tpu(tmp_path, demo, capsys):
    """--demo K with --set and --print-params: the panel's and the params'
    text, the state and the parameters are nbody_tpu's."""
    args = ["--cpu", "--numbodies", "128", "--frames", "0", "--demo", str(demo),
            "--print-params", "--set", "velocity_scale=3.5,softening_factor=0.25"]
    texts = []
    for main, name in ((cli.main, "ours"), (jax_cli.main, "theirs")):
        capsys.readouterr()
        assert main([*args, "--checkpoint-save", str(tmp_path / f"{name}.npz")]) == 0
        out = capsys.readouterr().out.splitlines()
        texts.append([line for line in out if not line.startswith(("nbody_tpu", "Checkpoint"))])
    assert texts[0] == texts[1] and len(texts[0]) == 6
    ours, theirs = load_checkpoint(tmp_path / "ours.npz"), load_checkpoint(tmp_path / "theirs.npz")
    for a, b in zip(ours[:2], theirs[:2]):
        np.testing.assert_array_equal(a, b)
    assert ours[2] == theirs[2] and ours[2].softening == 0.25


@pytest.mark.parametrize("args, message", [
    (["--set", "time_step"], "--set expects NAME=VALUE"),
    (["--set", "warp_factor=9"], "unknown parameter"),
    (["--camera", "1,2", "--render"], "--camera expects X,Y,Z"),
])
def test_setup_errors_exit_2(tmp_path, args, message, capsys):
    assert cli.main([*SMALL, "--frames", "1", "--outdir", str(tmp_path), *args]) == 2
    assert message in capsys.readouterr().err


# ---- the demo loop ----

def test_render_writes_frames_and_metadata(tmp_path, capsys):
    out = tmp_path / "frames"
    assert cli.main([*SMALL, "--frames", "3", "--render", "--outdir", str(out),
                     "--config", "random", "--demo", "2"]) == 0
    assert f"wrote 3 frames to {out}/" in capsys.readouterr().out
    pngs = sorted(p.name for p in out.glob("*.png"))
    assert pngs == ["frame_00000.png", "frame_00001.png", "frame_00002.png"]
    assert all(p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" for p in out.glob("*.png"))
    meta = json.loads((out / "metadata.json").read_text())
    theirs = tmp_path / "theirs"
    assert jax_cli.main([*SMALL, "--frames", "1", "--render", "--outdir", str(theirs),
                         "--config", "random", "--demo", "2"]) == 0
    jmeta = json.loads((theirs / "metadata.json").read_text())
    assert meta.keys() == jmeta.keys()
    assert meta["device"] == "cpu"
    assert {k: v for k, v in meta.items() if k != "device"} == \
        {k: v for k, v in jmeta.items() if k != "device"}


@pytest.mark.parametrize("ext", ["png", "avi"])
def test_animate_writes_one_file(tmp_path, ext, capsys):
    path = tmp_path / f"demo.{ext}"
    assert cli.main([*SMALL, "--frames", "3", "--animate", str(path), "--no-hud",
                     "--raster", "conv"]) == 0
    assert f"wrote 3-frame animation to {path}" in capsys.readouterr().out
    data = path.read_bytes()
    if ext == "png":
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"acTL" in data
        assert data.count(b"fcTL") == 3
    else:
        frames, fps = read_avi(path)
        assert fps == 30 and len(frames) == 3
        assert frames[0].shape == (32, 48, 3) and frames[-1].any()


def test_autosave_rewrites_the_checkpoint(tmp_path, capsys):
    path = tmp_path / "auto.npz"
    saves = []
    real = cli._save

    def spy(p, compute, **kw):
        saves.append(compute.steps_taken)
        real(p, compute, **kw)

    import unittest.mock

    with unittest.mock.patch.object(cli, "_save", spy):
        assert cli.main([*SMALL, "--frames", "5", "--autosave", "2",
                         "--checkpoint-save", str(path), "--steps-per-frame", "2"]) == 0
    assert saves == [4, 8, 10]  # frames 2 and 4, then the final save
    assert load_checkpoint(path)[3]["step"] == 10
    assert not list(tmp_path.glob("*.tmp*"))


@pytest.mark.parametrize("args, message", [
    (["--autosave", "0", "--checkpoint-save", "x.npz"], "positive frame interval"),
    (["--autosave", "2"], "--autosave needs --checkpoint-save"),
])
def test_autosave_usage_errors_exit_1(args, message, capsys):
    assert cli.main([*SMALL, "--frames", "1", *args]) == 1
    assert message in capsys.readouterr().err


def test_energy_reports_the_drift(capsys):
    assert cli.main([*SMALL, "--frames", "3", "--energy", "--integrator", "leapfrog"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"energy: E0=(\S+) E1=(\S+) relative drift=(\S+)", out)
    assert m and abs(float(m.group(3))) < 1e-2


@pytest.mark.parametrize("extra", [[], ["--fp64"], ["--integrator", "hermite"]])
def test_selftest_passes_as_nbody_tpus_does(extra, capsys):
    assert cli.main(["--cpu", "--numbodies", "128", "--selftest", *extra]) == 0
    ours = [line for line in capsys.readouterr().out.splitlines() if "selftest" in line]
    assert jax_cli.main(["--cpu", "--numbodies", "128", "--selftest", *extra]) == 0
    theirs = [line for line in capsys.readouterr().out.splitlines() if "selftest" in line]
    assert ours == theirs and ours[-1] == "selftest PASSED"


def test_selftest_failure_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(Compute, "compare_results", lambda self: False)
    assert cli.main(["--cpu", "--numbodies", "64", "--selftest"]) == 1
    assert "selftest FAILED: qa-compare" in capsys.readouterr().out


class _Clock:
    """time.monotonic advancing 0.6 s a call: the loop reports about every
    other frame."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.6
        return self.t


def test_demo_reports_and_metrics(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("time.monotonic", _Clock())
    path = tmp_path / "m.jsonl"
    assert cli.main([*SMALL, "--frames", "4", "--metrics", str(path)]) == 0
    reports = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[demo")]
    assert len(reports) == 2
    assert re.match(r"\[demo 0\] frame 2/4 \| [\d.]+ fps \| [\d.]+ G interactions/s \| "
                    r"[\d.]+ GFLOP/s \(fp32\)$", reports[0])
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["frame"] for r in records] == [2, 4]
    assert set(records[0]) == {"frame", "demo", "fps", "gflops",
                               "interactions_per_second_e9", "fp64"}
    # 2 frames in 1.2 s of the fake clock
    assert records[0]["fps"] == pytest.approx(2 / 1.2)


def test_benchmark_metrics_and_memory_line(tmp_path, capsys):
    path = tmp_path / "b.jsonl"
    assert cli.main(["--cpu", "--numbodies", "64", "--benchmark", "-i", "2",
                     "--metrics", str(path)]) == 0
    assert "device memory" not in capsys.readouterr().out  # none on the CPU
    assert jax_cli.main(["--cpu", "--numbodies", "64", "--benchmark", "-i", "2",
                         "--metrics", str(path)]) == 0
    ours, theirs = (json.loads(line) for line in path.read_text().splitlines())
    assert ours.keys() == theirs.keys()
    assert ours["num_bodies"] == 64 and ours["iterations"] == 2


def test_version_line(capsys):
    assert cli.main(["--version"]) == 0
    ours = capsys.readouterr().out.strip()
    assert jax_cli.main(["--version"]) == 0
    theirs = capsys.readouterr().out.strip()
    assert re.fullmatch(r"nbody_tpu_torch \S+ \(\S+\)", ours)
    assert ours.split(" ", 1)[1] == theirs.split(" ", 1)[1]


def test_profile_writes_a_chrome_trace(tmp_path, capsys):
    out = tmp_path / "trace"
    assert cli.main([*SMALL, "--frames", "2", "--profile", str(out)]) == 0
    assert f"profiler trace written to {out}" in capsys.readouterr().out
    traces = list(out.glob("trace_*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_interactive_keys_drive_the_loop(monkeypatch, capsys):
    """Scripted keys (a StringIO stdin, as tests/test_ui.py does): ']' moves
    to demo 1, 'p' cycles the display mode, Enter switches fp32 -> fp64 on
    the port's Compute, 'q' quits after the frame they came with."""
    seen = []
    real = Compute.update_simulation

    def spy(self, camera=None, steps=1):
        seen.append((self.active_demo, self.precision))
        real(self, camera, steps)

    monkeypatch.setattr(Compute, "update_simulation", spy)
    monkeypatch.setattr("sys.stdin", io.StringIO("]p\rq"))
    assert cli.main([*SMALL, "--frames", "5", "--interactive"]) == 0
    out = capsys.readouterr().out
    assert "interactive: space=pause q=quit" in out
    assert "display mode: sprites_alpha" in out and "precision: fp64" in out and "quit" in out
    assert seen == [(1, "fp64")]


def test_interactive_quit_after_frames(monkeypatch, capsys):
    keys = iter(["", "]", "\r", "q"])
    from nbody_tpu_torch.ui import Controls

    monkeypatch.setattr(Controls, "read_keys", staticmethod(lambda: next(keys)))
    seen = []
    real = Compute.update_simulation

    def spy(self, camera=None, steps=1):
        seen.append((self.active_demo, self.precision, self.system.dtype))
        real(self, camera, steps)

    monkeypatch.setattr(Compute, "update_simulation", spy)
    assert cli.main([*SMALL, "--frames", "9", "--interactive"]) == 0
    # 'q' ends the loop after the frame it came with
    assert seen == [(0, "fp32", torch.float32), (1, "fp32", torch.float32),
                    (1, "fp64", torch.float64), (1, "fp64", torch.float64)]


def test_live_view_with_a_fake_terminal(monkeypatch, capsys):
    """--live --interactive draws half-block frames into the alternate
    screen, routes the key handler's log ('o': the params) to the status
    line and restores the terminal."""
    monkeypatch.setenv("COLUMNS", "40")
    monkeypatch.setenv("LINES", "14")
    monkeypatch.setattr("sys.stdin", io.StringIO("o"))
    assert cli.main([*SMALL, "--frames", "2", "--live", "--interactive"]) == 0
    out = capsys.readouterr().out
    assert out.count("\x1b[?1049h") == 1 and out.endswith("\x1b[?1049l\x1b[?25h")
    assert out.count("▀") == 2 * 40 * 12
    i = out.rindex("{ 0.016")
    assert "\x1b[K" in out[i:i + 120]


# ---- modes the port refuses, and the card ----

@pytest.mark.parametrize("args", [["--hostmem"], ["--variant", "vpu"], ["--selftest"],
                                  ["--kernel", "p3m"]])
def test_ds_demo_refusals_exit_1_as_nbody_tpus(args, capsys):
    """In nbody_tpu's words, less its Pallas backend's name."""
    assert cli.main([*SMALL, "--precision", "ds", "--frames", "1", *args]) == 1
    ours = capsys.readouterr().err.strip()
    assert jax_cli.main([*SMALL, "--precision", "ds", "--frames", "1", *args]) == 1
    theirs = capsys.readouterr().err.strip().splitlines()[-1]
    assert ours == theirs.replace("pallas kernels", "kernels").replace("auto/pallas", "auto")


@pytest.mark.parametrize("mode", [[], ["--selftest"]])
def test_demo_on_a_mesh_is_not_ported(mode, capsys):
    """The demo loop and --selftest on a mesh are ported
    (tests/test_torch_demo_mesh.py, under torchrun); what is refused is a mesh
    of more ranks than the process group has: one process exits 2 naming
    torchrun."""
    assert cli.main([*SMALL, "--devices", "2", "--frames", "1", *mode]) == 2
    assert "start 2 with torchrun --nproc_per_node 2" in capsys.readouterr().err


def test_demo_needs_a_card_without_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--numbodies", "64", "--frames", "1"]) == 3
    assert "is_available" in capsys.readouterr().err


# ---- checkpoints through the CLI ----

@pytest.mark.parametrize("precision", ["fp32", "ds", "fp64"])
def test_resume_is_bit_exact(tmp_path, precision, capsys):
    """2 frames, a checkpoint, 2 more frames from it: the same bits as 4
    frames straight, and the step counter and parameters carried."""
    args = ["--cpu", "--numbodies", "128", "--no-cycle", "--precision", precision,
            "--config", "plummer", "--demo", "1"]
    a, b, c = (str(tmp_path / f"{n}.npz") for n in "abc")
    assert cli.main([*args, "--frames", "2", "--checkpoint-save", a]) == 0
    # the resumed run starts from the file's state and parameters: its own
    # --config and --demo are ignored, as in nbody_tpu
    assert cli.main(["--cpu", "--no-cycle", "--precision", precision, "--frames", "2",
                     "--checkpoint-load", a, "--checkpoint-save", b]) == 0
    assert "Resumed 128 bodies at step 2" in capsys.readouterr().out
    assert cli.main([*args, "--frames", "4", "--checkpoint-save", c]) == 0
    resumed, straight = load_checkpoint(b), load_checkpoint(c)
    dtype = np.float32 if precision == "fp32" else np.float64
    for x, y in zip(resumed[:2], straight[:2]):
        assert x.dtype == y.dtype == dtype
        np.testing.assert_array_equal(x, y)
    assert resumed[2] == straight[2]
    assert resumed[3]["step"] == straight[3]["step"] == 4
    planes = load_checkpoint_ds_planes(b), load_checkpoint_ds_planes(c)
    if precision == "ds":
        for x, y in zip(*planes):
            np.testing.assert_array_equal(x, y)
    else:
        assert planes == (None, None)


def test_ds_resume_reads_nbody_tpus_planes(tmp_path):
    """A ds checkpoint of nbody_tpu's CLI resumes in the port from its raw
    planes: zero frames and a save give the same planes back."""
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert jax_cli.main(["--cpu", "--numbodies", "64", "--precision", "ds", "--frames", "1",
                         "--no-cycle", "--checkpoint-save", a]) == 0
    assert cli.main(["--cpu", "--precision", "ds", "--frames", "0", "--checkpoint-load", a,
                     "--checkpoint-save", b]) == 0
    for x, y in zip(load_checkpoint_ds_planes(a), load_checkpoint_ds_planes(b)):
        np.testing.assert_array_equal(x, y)
    assert load_checkpoint(b)[3]["step"] == 1


@pytest.mark.parametrize("flag", ["--checkpoint-load", "--checkpoint-save"])
def test_checkpoint_directory_exits_2(tmp_path, flag, capsys):
    assert cli.main([*SMALL, "--frames", "1", flag, str(tmp_path)]) == 2
    assert "orbax" in capsys.readouterr().err


# ---- utils/profiling ----

def test_profiling_helpers_on_the_cpu(tmp_path):
    from nbody_tpu_torch.utils import profiling

    with profiling.trace(None) as d:
        assert d is None
    assert not list(tmp_path.iterdir())
    with profiling.trace(str(tmp_path / "t")) as d:
        with profiling.annotate("nbody.step"):
            torch.ones(8).sum()
    assert d == str(tmp_path / "t")
    (trace,) = (tmp_path / "t").glob("trace_*.json")
    assert "nbody.step" in trace.read_text()
    assert profiling.format_memory_line("cpu") is None
    assert profiling.device_memory_stats("cpu") == {}
