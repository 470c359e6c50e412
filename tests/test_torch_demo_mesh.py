"""The demo loop, --selftest and checkpoints on a mesh: ``nbody-torch --cpu
--devices 2`` under torchrun, two gloo ranks, against rendering the
gathered state and against the runs they continue.

Every run's ranks must exit 0 and only rank 0 prints. The checks are bit
for bit: the frames a mesh writes are rank 0's renders of the state
gathered from every rank, so the last PNG equals a render of the state the
run's checkpoint holds (the PNG encoding is deterministic: equal bytes,
equal frames); a resumed run of 2 + 2 frames equals 4 frames straight, as
on one device (tests/test_torch_demo.py). The fused ring runs its plain
ring on the CPU; sym its plain versions.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nbody_tpu_torch.io import load_checkpoint
from nbody_tpu_torch.render import Camera, FrameRenderer

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--cpu", "--devices", "2", "--numbodies", "256", "--width", "160", "--height",
         "120", "--no-cycle"]


def _torchrun(cwd, runs):
    """Start the runs together, each on two gloo ranks; their (returncode,
    stdout, stderr) in order."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "nbody_tpu_torch.cli", *SMALL, *args],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for args in runs]
    results = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        results.append((proc.returncode, out, err))
    return results


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory):
    """The mesh runs of this module, started together: --render under
    ring_fused (with --energy and --animate) and sym, --selftest, and a
    checkpoint run of 2 frames and one of 4."""
    tmp = tmp_path_factory.mktemp("demo_mesh")
    runs = {
        "ring_fused": ["--strategy", "ring_fused", "--frames", "3", "--render", "--no-hud",
                       "--outdir", str(tmp / "ring_fused"), "--energy", "--animate",
                       str(tmp / "a.avi"), "--checkpoint-save", str(tmp / "ring_fused.npz")],
        "sym": ["--strategy", "sym", "--frames", "3", "--render", "--no-hud", "--outdir",
                str(tmp / "sym"), "--checkpoint-save", str(tmp / "sym.npz")],
        "selftest": ["--selftest"],
        "two": ["--frames", "2", "--config", "plummer", "--demo", "1", "--checkpoint-save",
                str(tmp / "two.npz")],
        "four": ["--frames", "4", "--config", "plummer", "--demo", "1", "--checkpoint-save",
                 str(tmp / "four.npz")],
    }
    results = dict(zip(runs, _torchrun(tmp, runs.values())))
    # the resume needs the 2-frame checkpoint
    results["resumed"] = _torchrun(tmp, [["--frames", "2", "--checkpoint-load",
                                          str(tmp / "two.npz"), "--checkpoint-save",
                                          str(tmp / "resumed.npz")]])[0]
    return tmp, results


def _ok(result):
    rc, out, err = result
    assert rc == 0, err
    return out


@pytest.mark.parametrize("strategy", ["ring_fused", "sym"])
def test_mesh_demo_frames_are_the_gathered_states(demo_runs, strategy):
    tmp, results = demo_runs
    out = _ok(results[strategy])
    assert out.count("2-device mesh") == 1 and out.count("wrote 3 frames") == 1, out
    pngs = sorted((tmp / strategy).glob("frame_*.png"))
    assert len(pngs) == 3
    pos, _, params, meta = load_checkpoint(tmp / f"{strategy}.npz")
    assert meta["step"] == 3 and pos.shape == (256, 4)
    renderer = FrameRenderer(width=160, height=120, splat=16)
    frame = renderer.render(torch.tensor(pos), Camera(origin=params.camera_origin))
    renderer.write_png(frame, tmp / f"{strategy}_want.png")
    assert (tmp / f"{strategy}_want.png").read_bytes() == pngs[-1].read_bytes()
    if strategy == "ring_fused":
        assert out.count("relative drift=") == 1 and "3-frame animation" in out
        assert (tmp / "a.avi").stat().st_size > 0


def test_selftest_on_a_mesh(demo_runs):
    out = _ok(demo_runs[1]["selftest"])
    assert out.count("selftest PASSED") == 1 and out.count("[1/3] QA compare: PASS") == 1, out


def test_resume_on_a_mesh_is_bit_exact(demo_runs):
    tmp, results = demo_runs
    _ok(results["two"])
    _ok(results["four"])
    assert "Resumed 256 bodies at step 2" in _ok(results["resumed"])
    resumed, straight = load_checkpoint(tmp / "resumed.npz"), load_checkpoint(tmp / "four.npz")
    assert resumed[3]["step"] == straight[3]["step"] == 4
    assert resumed[2] == straight[2]
    for a, b in zip(resumed[:2], straight[:2]):
        np.testing.assert_array_equal(a, b)


def test_keys_reach_every_rank(tmp_path):
    """--interactive on a mesh: rank 0 reads the keys and broadcasts them at
    each frame's end, and every rank applies them in the next frame: "]"
    (the next demo, a reset), space (pause) and q leave every rank with the
    same steps, demo, parameters and state."""
    from test_torch_sharded_ranks import RankPool

    pool = RankPool(2, str(tmp_path / "store"))
    try:
        out = pool.run("demo_keys", ["", "]", " ", "", "q"], 10)
    finally:
        pool.close()
    for steps, paused, demo, params, positions in out:
        assert (steps, paused, demo) == (3, True, 1)
        assert params == out[0][3]
        np.testing.assert_array_equal(positions, out[0][4])
