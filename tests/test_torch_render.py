"""The port's rasterizer (nbody_tpu_torch/render/rasterizer.py) against
nbody_tpu's XLA FrameRenderer: the same numpy-seeded positions and camera
give the same uint8 frames, in every display mode, by both methods and both
tints. The only difference allowed is the float32 sum order at a rounding
edge: |delta| <= 1 level per channel, and at least 99.9 % of the channel
values exactly equal."""

import numpy as np
import pytest
import torch

from nbody_tpu.render import Camera as JaxCamera
from nbody_tpu.render import DisplayMode as JaxMode
from nbody_tpu.render import FrameRenderer as JaxRenderer

from nbody_tpu_torch import NBodyConfig, ic
from nbody_tpu_torch.render import Camera, DisplayMode, FrameRenderer

MODES = [m.value for m in DisplayMode]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(n, seed=3):
    pos, _ = ic.generate(NBodyConfig.SHELL, n, 1.52, 2.0, seed=seed)
    # a few bodies behind the camera and off the frame's edges
    pos[:7, 2] = 40.0
    pos[7:12, 0] = 9.0
    return pos


def _cameras(origin=(0.0, -2.0, -12.0)):
    """The two packages' cameras, moved alike, a few frames into their lag."""
    cams = JaxCamera(origin=origin), Camera(origin=origin)
    for c in cams:
        c.rotate(30.0, 10.0)
        c.translate(5.0, -3.0)
        for _ in range(4):
            c.view_matrix()
    return cams


def assert_frames_close(ours, theirs):
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype == np.uint8
    d = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.999, (d == 0).mean()


@pytest.mark.parametrize("fp64", [False, True], ids=["fp32-tint", "fp64-tint"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", ["scatter", "conv"])
def test_frames_equal_nbody_tpu(method, mode, fp64):
    """N = 500, not a multiple of the chunk (96): the last chunk is short."""
    pos = _state(500)
    kw = dict(width=64, height=48, splat=8, chunk=96, method=method)
    jcam, cam = _cameras()
    theirs = JaxRenderer(**kw).render(pos, jcam, fp64=fp64, mode=JaxMode(mode),
                                      sprite_size=1.3, brightness=0.4)
    ours = FrameRenderer(**kw).render(pos, cam, fp64=fp64, mode=DisplayMode(mode),
                                      sprite_size=1.3, brightness=0.4)
    assert ours.sum() > 0
    assert_frames_close(ours, theirs)


@pytest.mark.parametrize("n, splat", [(300, 16), (400, 103)])
def test_auto_method_equals_nbody_tpu(n, splat):
    """method="auto" picks conv for the sprite modes from N*K^2 >= 2^22
    (nbody_tpu's rule), scatter below it; both packages pick alike."""
    pos = _state(n)
    kw = dict(width=48, height=32, splat=splat)
    r = FrameRenderer(**kw)
    assert r.uses_conv(n) == (n * splat * splat >= 1 << 22)
    assert not r.uses_conv(n, DisplayMode.SPRITES_ALPHA)
    assert not r.uses_conv(n, DisplayMode.POINTS)
    # the rule's edge at the demo's splat
    assert FrameRenderer(splat=16).uses_conv(16384)
    assert not FrameRenderer(splat=16).uses_conv(16383)
    jcam, cam = _cameras((0.0, 0.0, -30.0))
    assert_frames_close(r.render(pos, cam), JaxRenderer(**kw).render(pos, jcam))


@pytest.mark.parametrize("method", ["conv", "scatter", "auto"])
def test_splat_1_takes_the_scatter_path(method):
    """The conv ladder needs K >= 2: splat 1 renders by scatter, as in
    nbody_tpu, whatever the method."""
    pos = _state(256, seed=1)
    r = FrameRenderer(width=64, height=48, splat=1, method=method)
    assert not r.uses_conv(256)
    jcam, cam = _cameras((0.0, 0.0, -30.0))
    ours = r.render(pos, cam)
    assert ours.sum() > 0
    theirs = JaxRenderer(width=64, height=48, splat=1, method=method).render(pos, jcam)
    assert_frames_close(ours, theirs)


def test_no_bodies_and_bodies_behind_the_camera_give_black_frames():
    cam = Camera(origin=(0.0, 0.0, -30.0))
    for method in ("scatter", "conv"):
        r = FrameRenderer(width=32, height=24, method=method)
        assert r.render(np.zeros((0, 4), np.float32), cam).sum() == 0
        behind = _state(64)
        behind[:, 2] = 100.0
        assert r.render(behind, cam).sum() == 0


def test_a_tensor_renders_like_its_array():
    """A tensor is rendered on its own device, in float32, whatever its
    type; a float64 state gives the frame of its float32 cast."""
    pos = _state(200).astype(np.float64)
    r = FrameRenderer(width=40, height=30, splat=4)
    frames = [r.render(x, Camera(origin=(0.0, 0.0, -25.0)))
              for x in (pos, torch.from_numpy(pos), pos.astype(np.float32))]
    for f in frames[1:]:
        np.testing.assert_array_equal(f, frames[0])
    f = frames[0]
    assert f.flags.writeable  # the HUD stamps pixels in place


@pytest.mark.parametrize("was, warn_only", [(False, False), (True, False), (True, True)])
def test_deposits_restore_the_callers_determinism_setting(was, warn_only):
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(was, warn_only=warn_only)
    try:
        for method in ("scatter", "conv"):
            FrameRenderer(width=32, height=24, method=method).render(_state(100), None)
            assert torch.are_deterministic_algorithms_enabled() == was
            assert torch.is_deterministic_algorithms_warn_only_enabled() == warn_only
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="method"):
        FrameRenderer(width=32, height=24, method="nope")


def test_sprites_alpha_occludes():
    """SPRITES_ALPHA composites depth slabs back to front: a near red body
    hides a far blue one on the same line of sight, where the additive
    mode mixes them (tests/test_render.py's case on the port)."""
    cam = Camera(origin=(0.0, 0.0, 0.0))
    pos = np.zeros((3, 4), np.float32)
    pos[0, :3] = (0.0, 0.0, -50.0)   # blue, far
    pos[1, :3] = (500.0, 500.0, -50.0)
    pos[2, :3] = (0.0, 0.0, -5.0)    # red, near
    pos[:, 3] = 1.0
    r = FrameRenderer(width=64, height=64, splat=8)
    alpha = r.render(pos, cam, mode=DisplayMode.SPRITES_ALPHA, brightness=50.0)
    additive = r.render(pos, cam, mode=DisplayMode.SPRITES_COLOR, brightness=50.0)
    assert alpha[32, 32, 0] > 0
    assert int(alpha[32, 32, 2]) < int(additive[32, 32, 2])
