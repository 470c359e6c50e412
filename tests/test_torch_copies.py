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


@pytest.mark.parametrize("grid", [8, 16])
def test_optimal_influence_table_equals_nbody_tpu(grid, monkeypatch, tmp_path):
    """The port's copy of the numpy influence table, bit for bit, with both
    disk caches off and both lru caches bypassed: each side computes."""
    from nbody_tpu.ops import pm as jax_pm

    from nbody_tpu_torch.ops import p3m, pm

    monkeypatch.setenv("NBODY_NO_COMPILE_CACHE", "1")
    ours = pm._optimal_influence_factor.__wrapped__(grid, p3m.SIGMA_CELLS, 2)
    theirs = jax_pm._optimal_influence_factor.__wrapped__(grid, p3m.SIGMA_CELLS, 2)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    # the port's disk cache is its own directory, and a cached table reads back
    monkeypatch.delenv("NBODY_NO_COMPILE_CACHE")
    monkeypatch.setenv("NBODY_COMPILE_CACHE_DIR", str(tmp_path))
    pm._optimal_influence_factor.__wrapped__(grid, p3m.SIGMA_CELLS, 2)
    cached = list(tmp_path.rglob("*.npy"))
    assert [c.relative_to(tmp_path).parts[:2] for c in cached] == [("nbody_tpu_torch", "influence")]
    np.testing.assert_array_equal(np.load(cached[0]), theirs)


def test_p3m_constants_equal_nbody_tpu():
    from nbody_tpu.ops import p3m as jax_p3m
    from nbody_tpu.ops import p3m_kernel as jax_p3m_kernel

    from nbody_tpu_torch.ops import p3m

    assert p3m._SLR_POLY == jax_p3m_kernel._SLR_POLY
    assert (p3m.SIGMA_CELLS, p3m.RCUT_SIGMAS) == (jax_p3m.SIGMA_CELLS, jax_p3m.RCUT_SIGMAS)
    for grid in (8, 16, 32, 64, 100, 128):
        assert p3m._cell_grid_size(grid) == jax_p3m._cell_grid_size(grid)
    # the ladder only: nbody_tpu's tuner has no cache here, so it resolves the same
    for cap in (8, 128, 192, 193, 440, 4096, 4097, 6816):
        assert p3m.p3m_kernel_blk(cap) == jax_p3m_kernel.p3m_kernel_blk(cap)


# ---- checkpoints: files cross between the packages, bit for bit ----

def _ckpt_state(dtype, seed=6):
    pos, vel = jax_ic.generate(JaxNBodyConfig.PLUMMER, 96, 1.0, 1.0, seed=seed, dtype=dtype)
    rng = np.random.default_rng(seed)
    # values a float32 cast would round
    return pos + rng.normal(scale=1e-9, size=pos.shape).astype(dtype), vel


def _ds_planes(seed=6):
    from nbody_tpu_torch.ops.ds import ds_from_f64

    pos, vel = _ckpt_state(np.float64, seed)
    planes = tuple(t.numpy() for t in (*ds_from_f64(pos), *ds_from_f64(vel)))
    # a lo plane below float64's resolution of hi + lo: only the raw planes
    # round-trip it
    planes[1][0, 0] = np.float32(1e-30)
    return pos, vel, planes


@pytest.mark.parametrize("kind", ["fp32", "fp64", "ds"])
@pytest.mark.parametrize("writer", ["nbody_tpu", "port"])
def test_checkpoints_cross_both_ways_bit_for_bit(tmp_path, kind, writer):
    from nbody_tpu.io import load_checkpoint as jax_load
    from nbody_tpu.io import load_checkpoint_ds_planes as jax_load_planes

    from nbody_tpu_torch.io import load_checkpoint_ds_planes
    from nbody_tpu_torch.io import save_checkpoint as port_save

    planes = None
    if kind == "ds":
        pos, vel, planes = _ds_planes()
    else:
        pos, vel = _ckpt_state(np.float64 if kind == "fp64" else np.float32)
    path = tmp_path / "c.npz"
    if writer == "port":
        save = port_save
        load, load_planes, params_type = jax_load, jax_load_planes, jax_params.NBodyParams
        p = params.DEMO_PARAMS[4]
        config = NBodyConfig.PLUMMER
    else:
        save = save_checkpoint
        load, load_planes, params_type = load_checkpoint, load_checkpoint_ds_planes, \
            params.NBodyParams
        p = jax_params.DEMO_PARAMS[4]
        config = JaxNBodyConfig.PLUMMER
    save(path, pos, vel, p, step=17, config=config, atomic=True, ds_planes=planes)
    assert not list(tmp_path.glob("*.tmp*"))  # the atomic write renamed its temp file
    lp, lv, lparams, meta = load(path)
    for got, want in ((lp, pos), (lv, vel)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert isinstance(lparams, params_type)
    assert dataclasses.asdict(lparams) == dataclasses.asdict(params.DEMO_PARAMS[4])
    assert meta["step"] == 17 and meta["config"] == "plummer"
    got_planes = load_planes(path)
    if planes is None:
        assert got_planes is None
    else:
        assert meta["ds"] is True
        for got, want in zip(got_planes, planes):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_checkpoint_directories_are_refused(tmp_path):
    """An orbax checkpoint is a directory and needs JAX: saving to, loading
    from or reading planes of a directory raises ValueError (CLI exit 2)."""
    from nbody_tpu_torch.io import load_checkpoint_ds_planes
    from nbody_tpu_torch.io import save_checkpoint as port_save

    pos, vel = _ckpt_state(np.float32)
    for call in (lambda: load_checkpoint(tmp_path), lambda: load_checkpoint_ds_planes(tmp_path),
                 lambda: port_save(tmp_path, pos, vel, params.DEMO_PARAMS[0])):
        with pytest.raises(ValueError, match="orbax"):
            call()


# ---- the copies of render/camera, ui/, io/png, io/apng, io/avi ----

def test_camera_and_perspective_equal_nbody_tpu():
    from nbody_tpu.render.camera import Camera as JaxCamera
    from nbody_tpu.render.camera import perspective as jax_perspective

    from nbody_tpu_torch.render.camera import Camera, perspective

    np.testing.assert_array_equal(perspective(60.0, 4 / 3, 0.1, 1000.0),
                                  jax_perspective(60.0, 4 / 3, 0.1, 1000.0))
    cams = Camera(origin=(1.0, -2.0, -50.0)), JaxCamera(origin=(1.0, -2.0, -50.0))
    for step in range(12):
        for c in cams:
            {0: lambda: c.zoom(10.0), 1: lambda: c.rotate(-25.0, 5.0),
             2: lambda: c.translate(25.0, -25.0), 3: lambda: c.reset((0.0, 0.0, -30.0))
             }.get(step % 5, lambda: None)()
        np.testing.assert_array_equal(cams[0].view_matrix(), cams[1].view_matrix())


def test_hud_equals_nbody_tpu():
    from types import SimpleNamespace

    from nbody_tpu.ui import hud as jax_hud

    from nbody_tpu_torch.ui import hud

    text = "".join(hud._GLYPHS) + "lower case ~?"
    assert hud._GLYPHS == jax_hud._GLYPHS
    for scale in (1, 2, 3):
        np.testing.assert_array_equal(hud.render_text_mask(text, scale),
                                      jax_hud.render_text_mask(text, scale))
    for precision in ("fp32", "fp64", "ds"):
        c = SimpleNamespace(precision=precision, fp64_enabled=precision == "fp64",
                            num_bodies=4096, fps=59.94, g_flops=1234.56,
                            interactions_per_second=61.7)
        for inter in (False, True):
            lines = hud.hud_lines(c, "NVIDIA H100 80GB HBM3", inter)
            assert lines == jax_hud.hud_lines(c, "NVIDIA H100 80GB HBM3", inter)
            a = np.zeros((40, 200, 3), np.uint8)
            b = a.copy()
            hud.draw_hud(a, lines)
            jax_hud.draw_hud(b, lines)
            assert a.any()
            np.testing.assert_array_equal(a, b)


def test_terminal_view_equals_nbody_tpu(monkeypatch):
    import io

    from nbody_tpu.ui import terminal_view as jax_tv

    from nbody_tpu_torch.ui import terminal_view as tv

    frame = np.random.default_rng(2).integers(0, 4, (7, 5, 3)).astype(np.uint8) * 60
    assert tv.frame_to_ansi(frame) == jax_tv.frame_to_ansi(frame)
    with pytest.raises(ValueError):
        tv.frame_to_ansi(frame.astype(np.float32))
    monkeypatch.setenv("COLUMNS", "90")
    monkeypatch.setenv("LINES", "33")
    assert tv.terminal_cell_size() == jax_tv.terminal_cell_size() == (90, 31)
    outs = []
    for mod in (tv, jax_tv):
        out = io.StringIO()
        with mod.TerminalViewer(stream=out) as v:
            v.show(frame, "status\nsecond")
            v.show(frame)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]


def test_params_panel_equals_nbody_tpu():
    from types import SimpleNamespace

    from nbody_tpu.ui.params_panel import AdjustableParam as JaxParam
    from nbody_tpu.ui.params_panel import ParamPanel as JaxPanel

    from nbody_tpu_torch.ui.params_panel import AdjustableParam, ParamPanel

    assert ParamPanel.REFERENCE_SLIDERS == JaxPanel.REFERENCE_SLIDERS
    panels = []
    for cls, ps in ((ParamPanel, params), (JaxPanel, jax_params)):
        writes = []
        c = SimpleNamespace(active_params=ps.DEMO_PARAMS[2],
                            update_params=lambda **kw: writes.append(kw))
        panel = cls.for_compute(c)
        panel.set("time_step", 5.0)          # clamped to the slider's max
        panel.select_next()
        panel.adjust_selected(+1)
        panel.select_previous()
        panel.select_previous()
        panel.adjust_selected(-1)
        with pytest.raises(KeyError):
            panel.set("warp_factor", 9.0)
        panels.append((panel.render_text(), writes))
    assert panels[0] == panels[1]
    for cls in (AdjustableParam, JaxParam):
        with pytest.raises(ValueError):
            cls("x", 0.5, 1.0, 0.0, 0.1)
    a, b = AdjustableParam("x", 0.5, 0.0, 2.0, 0.3), JaxParam("x", 0.5, 0.0, 2.0, 0.3)
    for p in (a, b):
        p.percentage = 0.7
        p.increment()
    assert (a.value, a.percentage) == (b.value, b.percentage)


def test_image_writers_equal_nbody_tpu(tmp_path):
    from nbody_tpu.io import apng as jax_apng
    from nbody_tpu.io import avi as jax_avi
    from nbody_tpu.io import png as jax_png

    from nbody_tpu_torch.io import apng, avi, png

    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (9, 13, 3)).astype(np.uint8) for _ in range(3)]
    for ours, theirs, name, args in (
            (png.write_png, jax_png.write_png, "f.png", (frames[0],)),
            (apng.write_apng, jax_apng.write_apng, "a.png", (frames,)),
            (avi.write_avi, jax_avi.write_avi, "v.avi", (frames,))):
        ours(*args, tmp_path / f"ours_{name}")
        theirs(*args, tmp_path / f"theirs_{name}")
        assert (tmp_path / f"ours_{name}").read_bytes() == \
            (tmp_path / f"theirs_{name}").read_bytes()
    back, fps = avi.read_avi(tmp_path / "ours_v.avi")
    assert fps == 30 and len(back) == 3
    for a, b in zip(back, frames):
        np.testing.assert_array_equal(a, b)
    for bad in ([], [frames[0].astype(np.float32)]):
        with pytest.raises(ValueError):
            apng.write_apng(bad, tmp_path / "bad.png")
        with pytest.raises(ValueError):
            avi.write_avi(bad, tmp_path / "bad.avi")


class _Recorder:
    """A stand-in Compute that records the calls the controls make."""

    def __init__(self, ps):
        self.calls = []
        self.active_params = ps.DEMO_PARAMS[1]
        self.fp64_enabled = False
        self.precision = "fp32"

    def __getattr__(self, name):
        return lambda *a, **k: self.calls.append(
            (name, tuple(getattr(x, "name", type(x).__name__) for x in a), tuple(k)))

    def switch_precision(self):
        self.calls.append(("switch_precision", (), ()))
        self.fp64_enabled = not self.fp64_enabled
        self.precision = "fp64" if self.fp64_enabled else "fp32"


def test_controls_key_map_equals_nbody_tpu():
    """Every key makes the same calls on the compute and camera, logs the
    same text and leaves the same display state, with the port's own
    DisplayMode."""
    from nbody_tpu.render import Camera as JaxCamera
    from nbody_tpu.ui.controls import Controls as JaxControls

    from nbody_tpu_torch.render import Camera
    from nbody_tpu_torch.render.rasterizer import DisplayMode
    from nbody_tpu_torch.ui.controls import Controls

    keys = " \r\n`jklhjg" + "`" + "pppppc[]do1234wsaeHJKL" + "xq\x1b"
    runs = []
    for ctl_cls, cam_cls, ps in ((Controls, Camera, params),
                                 (JaxControls, JaxCamera, jax_params)):
        compute = _Recorder(ps)
        cam = cam_cls(origin=(0.0, 0.0, -50.0))
        log = []
        ctl = ctl_cls(compute, cam, log=log.append)
        states = []
        for key in keys:
            going = ctl.handle(key)
            states.append((key, going, ctl.display_mode.value, ctl.display_enabled,
                           ctl.show_sliders, ctl.show_interactions,
                           tuple(np.round(cam.translation, 6)), tuple(cam.rotation)))
        runs.append((compute.calls, log, states))
        if ctl_cls is Controls:
            assert isinstance(ctl.display_mode, DisplayMode)
    assert runs[0] == runs[1]
