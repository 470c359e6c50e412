"""On-device point-splat rasterizer, in PyTorch.

The port of ``nbody_tpu/render/rasterizer.py``, which replaces the
reference's OpenGL point-sprite pipeline (its src/nbody/render_particles.cpp
— behavior, not code):

* perspective point size ``500 * sprite_size / (1 - z_eye)`` clamped to the
  splat patch (the reference vertex shader's gl_PointSize),
* the 32x32 procedural Hermite/Gaussian splat ``w(d) = 2d^3 - 3d^2 + 1``
  (createGaussianMap's evalHermite), evaluated analytically per fragment
  instead of baked into a texture,
* additive blending with depth-write off (GL_SRC_ALPHA, GL_ONE),
* per-body B/G/R cycle colors (initialise_colours: body i is blue/green/red
  for i%3 = 0/1/2), modulated ``(0.6 + 0.4*color)`` by the fragment shader,
  then tinted orange {1,.6,.3} for fp32 / green {.4,.8,.1} for fp64.

The original is XLA (a scatter-add and a grouped convolution), not a Pallas
kernel, so this port is PyTorch on the state's device: project -> build
(N, K, K) splat patches -> scatter-add into per-class planes -> tonemap to
uint8, and only the finished frame crosses to the host. Its two methods are
the original's: ``scatter`` (exact N*K^2 fragments, in chunks of bodies)
and ``conv`` (an O(N) deposit on a ladder of sizes, then one grouped
``conv2d``). Every deposit is ``index_add_`` in deterministic mode
(``utils.ordered``), so a frame has one set of bits on the card, run after
run; the convolution runs cuDNN without TF32 and in deterministic mode.
The projection and the colour sums are written as elementwise products
(no matmul), so no TF32 setting reaches them either.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from nbody_tpu_torch.io.png import write_png
from nbody_tpu_torch.render.camera import Camera, perspective
from nbody_tpu_torch.utils.ordered import index_add_ordered

FP32_TINT = (1.0, 0.6, 0.3)
FP64_TINT = (0.4, 0.8, 0.1)

# class c colours body i%3 == c: B, G, R
_ONEHOT = ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0))


class DisplayMode(enum.Enum):
    POINTS = "points"
    SPRITES = "sprites"
    SPRITES_COLOR = "sprites_color"
    # beyond the reference (additive-only): depth-ordered alpha compositing
    # for dense cores — see _raster's slab path
    SPRITES_ALPHA = "sprites_alpha"


def _affine(p3: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """p3 @ m[:3, :3].T + m[:3, 3] for (n, 3) points, as elementwise
    products summed over k in order."""
    r = m[:3, :3]
    return p3[:, 0:1] * r[:, 0] + p3[:, 1:2] * r[:, 1] + p3[:, 2:3] * r[:, 2] + m[:3, 3]


def _project(pos, mv, proj, width: int, height: int):
    """Eye coordinates, eye depth, visibility and screen position."""
    p3 = pos[:, :3].to(torch.float32)
    eye = _affine(p3, mv)
    clip = _affine(eye, proj)
    wc = -eye[:, 2]
    valid = wc > 0.1  # znear
    ndc = clip / torch.where(valid, wc, torch.ones_like(wc))[:, None]
    sx = (ndc[:, 0] + 1.0) * 0.5 * width
    sy = (1.0 - ndc[:, 1]) * 0.5 * height
    return eye, wc, valid, sx, sy


def _classes(n: int, color: bool, tint: torch.Tensor, device):
    """(number of colour classes, class of each body, rgb of each class)."""
    if color:
        onehot = torch.tensor(_ONEHOT, dtype=torch.float32, device=device)
        cls = (torch.arange(n, device=device) % 3).to(torch.int64)
        return 3, cls, (0.6 + 0.4 * onehot) * tint[None, :]
    return 1, torch.zeros(n, dtype=torch.int64, device=device), tint[None, :]


def _colour(planes: torch.Tensor, class_rgb: torch.Tensor) -> torch.Tensor:
    """einsum("...chw,ck->...hwk"): the classes' planes times their rgb,
    summed over the classes in order."""
    img = planes[..., 0, :, :, None] * class_rgb[0]
    for c in range(1, class_rgb.shape[0]):
        img = img + planes[..., c, :, :, None] * class_rgb[c]
    return img


def _to_uint8(img: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def _raster(pos, mv, proj, sprite_size, tint, brightness, *,
            width, height, splat, mode, chunk, buckets=16):
    n = pos.shape[0]
    k = splat
    dev = pos.device
    eye, wc, valid, sx, sy = _project(pos, mv, proj, width, height)

    # Scatter layout: the body colour cycle takes only three values, so
    # scalar weights are scattered with flat 1-D indices into per-class
    # planes (nbody_tpu's layout). "sprites_alpha" scatters into (depth
    # slab, class) planes and composites the slabs back to front after
    # the scatter; within a slab blending stays additive.
    nslab = buckets if mode == "sprites_alpha" else 1
    nclass, cls, class_rgb = _classes(n, mode in ("sprites_color", "sprites_alpha"), tint, dev)
    planes_len = nslab * nclass * height * width

    if mode == "sprites_alpha":
        # slab index from eye depth, normalized over the VISIBLE bodies so
        # the slab resolution adapts to the cluster's extent
        inf = torch.tensor(float("inf"), device=dev)
        wmin = torch.min(torch.where(valid, wc, inf))
        wmax = torch.max(torch.where(valid, wc, -inf))
        span = torch.clamp(wmax - wmin, min=1e-6)
        slab = torch.clamp(((wc - wmin) / span * nslab).to(torch.int64), 0, nslab - 1)
        cls = slab * nclass + cls  # scatter class becomes (slab, color)

    if mode == "points":
        size = torch.ones_like(wc)
    else:
        size = torch.clamp(500.0 * sprite_size / (1.0 - eye[:, 2]), 1.0, float(k))
    validf = valid.to(torch.float32)

    ox = torch.arange(k, dtype=torch.float32, device=dev) - (k // 2)
    acc = None
    # bodies in chunks, each into a buffer of its own, the buffers summed
    # in chunk order (nbody_tpu's lax.map and sum); its zero-padding of the
    # last chunk only adds zeros, so the last chunk is just shorter here
    for s in range(0, n, chunk):
        sx_c, sy_c = sx[s:s + chunk], sy[s:s + chunk]
        m = sx_c.shape[0]
        # integer pixel indices around the body; weights are evaluated at
        # PIXEL CENTERS (index + 0.5)
        px = torch.floor(sx_c)[:, None, None] + ox[None, :, None]  # (m, k, 1)
        py = torch.floor(sy_c)[:, None, None] + ox[None, None, :]  # (m, 1, k)
        dx = px + 0.5 - sx_c[:, None, None]
        dy = py + 0.5 - sy_c[:, None, None]
        valid_c = validf[s:s + chunk][:, None, None]
        if mode == "points":
            # exactly the containing pixel, full weight
            w = ((dx.abs() <= 0.5) & (dy.abs() <= 0.5)).to(torch.float32)
            w = w.expand(m, k, k) * valid_c
        else:
            r = size[s:s + chunk][:, None, None] * 0.5
            d = torch.sqrt(dx * dx + dy * dy) / r
            d = torch.clamp(d.expand(m, k, k), max=1.0)
            w = 2 * (d * d * d) - 3 * (d * d) + 1  # Hermite splat
            w = w * valid_c * brightness
        pxi = px.expand(m, k, k).to(torch.int64)
        pyi = py.expand(m, k, k).to(torch.int64)
        inb = (pxi >= 0) & (pxi < width) & (pyi >= 0) & (pyi < height)
        flat = cls[s:s + chunk][:, None, None] * (height * width) + pyi * width + pxi
        # out-of-frame pixels route to a sacrificial trailing slot
        flat = torch.where(inb, flat, planes_len)
        buf = torch.zeros(planes_len + 1, dtype=torch.float32, device=dev)
        index_add_ordered(buf, flat.reshape(-1), w.reshape(-1))
        acc = buf if acc is None else acc + buf
    if acc is None:  # no bodies
        acc = torch.zeros(planes_len + 1, dtype=torch.float32, device=dev)

    if mode == "sprites_alpha":
        planes = acc[:planes_len].reshape(nslab, nclass, height, width)
        wsum = planes[:, 0] + planes[:, 1] + planes[:, 2]           # (B, H, W)
        rgb = _colour(planes, class_rgb)                             # (B, H, W, 3)
        avg = rgb / torch.clamp(wsum, min=1e-12)[..., None]          # slab mean color
        alpha = 1.0 - torch.exp(-wsum)                               # soft saturation
        img = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
        for b in range(nslab - 1, -1, -1):                           # far -> near
            a = alpha[b][..., None]
            img = img * (1.0 - a) + avg[b] * a                       # "over" operator
    else:
        img = _colour(acc[:planes_len].reshape(nclass, height, width), class_rgb)
    return _to_uint8(img)


def _splat_kernels(k: int, rung_sizes: np.ndarray) -> np.ndarray:
    """Per-rung Hermite splat kernels at integer offsets, (nsz, ksup, ksup)
    float32, odd support so the kernel is centered (nbody_tpu's numpy)."""
    ksup = k + (k % 2 == 0)
    off = np.arange(ksup, dtype=np.float32) - (ksup // 2)
    dyy, dxx = np.meshgrid(off, off, indexing="ij")
    dist = np.sqrt(dxx * dxx + dyy * dyy)
    kerns = []
    for s in rung_sizes:
        d = np.minimum(dist / max(s * 0.5, 0.5), 1.0)
        kerns.append(2 * d**3 - 3 * d**2 + 1)
    return np.stack(kerns).astype(np.float32)


def _raster_conv(pos, mv, proj, sprite_size, tint, brightness, *,
                 width, height, splat, mode, sizes=6, cic=True):
    """Deposit + dense convolution (nbody_tpu's reformulation of the splat
    scatter): each body deposits its brightness bilinearly over the 2x2
    nearest pixels (``cic=True``) of the planes of the two size-ladder rungs
    around its clamped size, lerped between them; each (rung, class) plane
    convolves with that rung's Hermite kernel, and the rungs sum into the
    frame. Exact when a body sits on a pixel center and its size on a rung;
    POINTS needs no convolution and SPRITES_ALPHA keeps the exact path."""
    n = pos.shape[0]
    k = splat
    dev = pos.device
    eye, wc, valid, sx, sy = _project(pos, mv, proj, width, height)
    nclass, cls, class_rgb = _classes(n, mode == "sprites_color", tint, dev)
    size = torch.clamp(500.0 * sprite_size / (1.0 - eye[:, 2]), 1.0, float(k))

    # geometric size ladder 1..k; rung spacing constant in log(size)
    nsz = sizes
    log_ratio = np.log(float(k)) / (nsz - 1)
    rung_sizes = np.exp(np.arange(nsz) * log_ratio)  # 1 .. k
    f = torch.log(size) / log_ratio                   # fractional rung
    j0 = torch.clamp(torch.floor(f).to(torch.int64), 0, nsz - 2)
    fj = torch.clamp(f - j0.to(torch.float32), 0.0, 1.0)

    # deposits: (rung, class) planes with a 1px halo so CIC at the frame
    # edge stays in-bounds; the splat's halo comes from the conv padding
    hw, hh = width + 2, height + 2
    plane_len = nsz * nclass * hh * hw
    base = (j0 * nclass + cls) * (hh * hw)
    base_hi = (torch.clamp(j0 + 1, max=nsz - 1) * nclass + cls) * (hh * hw)

    px = sx - 0.5 + 1.0  # continuous position in halo pixel coords
    py = sy - 0.5 + 1.0
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    w_amp = torch.where(valid, brightness, torch.zeros_like(px))

    if cic:
        fx = px - x0.to(torch.float32)
        fy = py - y0.to(torch.float32)
        corners = [(x0, y0, (1 - fx) * (1 - fy)),
                   (x0 + 1, y0, fx * (1 - fy)),
                   (x0, y0 + 1, (1 - fx) * fy),
                   (x0 + 1, y0 + 1, fx * fy)]
    else:
        corners = [(torch.round(px).to(torch.int64), torch.round(py).to(torch.int64),
                    torch.ones_like(px))]

    flats, weights = [], []
    for xi, yi, cw in corners:
        ok = (xi >= 0) & (xi < hw) & (yi >= 0) & (yi < hh)
        cell = yi * hw + xi
        for b, rung_w in ((base, 1.0 - fj), (base_hi, fj)):
            # a deposit outside the halo goes to the sacrificial slot
            flats.append(torch.where(ok, b + cell, plane_len))
            weights.append(w_amp * cw * rung_w)
    planes = torch.zeros(plane_len + 1, dtype=torch.float32, device=dev)
    index_add_ordered(planes, torch.cat(flats), torch.cat(weights))
    # one grouped conv: a feature group per rung, the classes ride the batch
    planes = planes[:plane_len].reshape(nsz, nclass, hh, hw).transpose(0, 1).contiguous()
    kern = torch.from_numpy(_splat_kernels(k, rung_sizes)).to(dev)[:, None]
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        out = torch.nn.functional.conv2d(planes, kern, padding="same", groups=nsz)
    acc = out.sum(dim=1)[:, 1:1 + height, 1:1 + width]  # drop the halo
    return _to_uint8(_colour(acc, class_rgb))


class FrameRenderer:
    def __init__(self, width: int = 1024, height: int = 768, *,
                 splat: int = 16, fov_deg: float = 60.0,
                 znear: float = 0.1, zfar: float = 1000.0,
                 chunk: int = 65536, depth_buckets: int = 16,
                 method: str = "auto"):
        self.width = width
        self.height = height
        self.splat = splat
        self.chunk = chunk
        self.depth_buckets = depth_buckets  # SPRITES_ALPHA slab count
        # method: "scatter" (exact N*K^2 fragment scatter), "conv"
        # (deposit + dense convolution — see _raster_conv), or "auto"
        # (conv for the sprite modes once the fragment count is large)
        if method not in ("auto", "scatter", "conv"):
            raise ValueError(f"unknown raster method {method!r}")
        self.method = method
        self.proj = perspective(fov_deg, width / height, znear, zfar)

    def uses_conv(self, n: int, mode: DisplayMode = DisplayMode.SPRITES_COLOR) -> bool:
        """Whether a frame of n bodies in `mode` takes the conv path: the
        sprite modes with method "conv", or "auto" from N*K^2 >= 2^22;
        the conv ladder needs K >= 2 (nbody_tpu's rule)."""
        return (self.splat >= 2 and mode in (DisplayMode.SPRITES, DisplayMode.SPRITES_COLOR)
                and (self.method == "conv"
                     or (self.method == "auto" and n * self.splat * self.splat >= 1 << 22)))

    def render(
        self,
        pos,
        camera: Camera | None = None,
        *,
        fp64: bool = False,
        mode: DisplayMode = DisplayMode.SPRITES_COLOR,
        sprite_size: float = 1.0,
        brightness: float = 0.3,
    ) -> np.ndarray:
        """Rasterize positions (N, 4) — a tensor, rendered on its device, or
        an array, rendered on the CPU — into an (H, W, 3) uint8 frame.

        brightness scales each splat's additive contribution (the GL path's
        source-alpha analogue) so dense cores don't immediately saturate."""
        pos = torch.as_tensor(pos)
        dev = pos.device
        mv = camera.view_matrix() if camera is not None else np.eye(4, dtype=np.float32)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        args = (pos, f32(mv), f32(self.proj), f32(sprite_size),
                f32(FP64_TINT if fp64 else FP32_TINT), f32(brightness))
        kw = dict(width=self.width, height=self.height, splat=self.splat, mode=mode.value)
        if self.uses_conv(pos.shape[0], mode):
            frame = _raster_conv(*args, **kw)
        else:
            frame = _raster(*args, **kw, chunk=self.chunk, buckets=self.depth_buckets)
        # a writable host copy: the HUD overlay stamps pixels in place
        return frame.cpu().numpy()

    @staticmethod
    def write_png(frame: np.ndarray, path) -> None:
        write_png(frame, path)
