"""Initial-condition generators: RANDOM, SHELL, EXPAND.

Same geometry and scale rules as the reference's ``randomise_bodies``
(the reference's src/nbody/randomise_bodies.cpp:47-189), re-implemented as
vectorized, *seeded* NumPy sampling (the reference uses unseeded libc
``rand()``, which is only accidentally deterministic; we make the seed a
first-class argument instead — SURVEY.md §7 "Determinism parity").

Generation runs on the host: it is O(N) setup work, while every hot path is
O(N²) on device — uploading the result once via ``jax.device_put`` is the
TPU-idiomatic split.

Scale rules (per generator, matching the reference):
* RANDOM: scale = cluster_scale * max(1, N/1024); vscale = velocity_scale * scale;
  positions and velocities uniform in balls of radius scale / vscale.
* SHELL:  scale = cluster_scale; vscale = scale * velocity_scale;
  direction uniform on the unit sphere (rejection on the unit ball), each
  coordinate gets an *independent* radius in [2.5*scale, 4*scale] (a quirk of
  the reference: three separate rng() draws per body); velocity = cross(pos,
  axis) * vscale with axis = z-hat unless the direction is at the +z pole
  (then axis = normalize([dir_y, dir_x, 1])).
* EXPAND: scale = cluster_scale * N/1024, falling back to cluster_scale when
  that is < 1; vscale = scale * velocity_scale; velocity is radial: point *
  vscale.
* PLUMMER (beyond the reference): self-consistent isotropic equilibrium
  sphere, scale radius a = cluster_scale, total mass 1 (per-body mass 1/N —
  the reference trio uses unit masses; an equilibrium model needs a fixed
  total mass so its dynamical time is N-independent). velocity_scale is in
  units of the equilibrium speed: 1.0 = virial equilibrium (the natural
  value; the CLI defaults both scales to 1.0 for --config plummer), 0 = cold
  collapse, sqrt(2) = marginally unbound.

The reference trio has mass 1 for all bodies (pos[:, 3]); vel[:, 3] is 0.
Returns AoS float arrays pos (N, 4), vel (N, 4).
"""

from __future__ import annotations

import numpy as np

from nbody_tpu_torch.config import NBodyConfig


def _uniform_ball(rng: np.random.Generator, n: int, dtype) -> np.ndarray:
    """n points uniform in the closed unit ball, via vectorized rejection."""
    out = np.empty((n, 3), dtype=np.float64)
    filled = 0
    while filled < n:
        need = n - filled
        # acceptance rate of the unit ball in [-1,1]^3 is pi/6 ~ 0.52
        cand = rng.uniform(-1.0, 1.0, size=(int(need * 2.2) + 16, 3))
        ok = (cand * cand).sum(axis=1) <= 1.0
        acc = cand[ok][:need]
        out[filled : filled + len(acc)] = acc
        filled += len(acc)
    return out.astype(dtype)


def _unit_sphere(rng: np.random.Generator, n: int, dtype) -> np.ndarray:
    """n directions uniform on the unit sphere (normalized ball rejection,
    like the reference's normalize-then-accept-if-len<=1)."""
    pts = _uniform_ball(rng, n, np.float64)
    norm = np.linalg.norm(pts, axis=1, keepdims=True)
    # a zero-length draw has probability 0; guard like the reference's 1e-6
    norm = np.where(norm > 1e-6, norm, 1.0)
    return (pts / norm).astype(dtype)


def generate(
    config: NBodyConfig,
    num_bodies: int,
    cluster_scale: float,
    velocity_scale: float,
    *,
    seed: int = 42,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate (pos, vel) AoS arrays for the given configuration."""
    rng = np.random.default_rng(seed)
    n = int(num_bodies)
    pos = np.zeros((n, 4), dtype=dtype)
    vel = np.zeros((n, 4), dtype=dtype)
    pos[:, 3] = 1.0  # unit masses

    if config == NBodyConfig.RANDOM:
        scale = cluster_scale * max(1.0, n / 1024.0)
        vscale = velocity_scale * scale
        pos[:, :3] = _uniform_ball(rng, n, dtype) * dtype(scale)
        vel[:, :3] = _uniform_ball(rng, n, dtype) * dtype(vscale)

    elif config == NBodyConfig.SHELL:
        scale = cluster_scale
        vscale = scale * velocity_scale
        inner = 2.5 * scale
        outer = 4.0 * scale
        d = _unit_sphere(rng, n, np.float64)
        # independent radius per coordinate — reference quirk
        radii = inner + (outer - inner) * rng.uniform(0.0, 1.0, size=(n, 3))
        p = d * radii
        # rotation axis: z-hat, except at the +z pole
        axis = np.broadcast_to(np.array([0.0, 0.0, 1.0]), (n, 3)).copy()
        pole = (1.0 - d[:, 2]) < 1e-6
        if pole.any():
            a = np.stack(
                [d[pole, 1], d[pole, 0], np.ones(pole.sum())], axis=1
            )
            a /= np.linalg.norm(a, axis=1, keepdims=True)
            axis[pole] = a
        v = np.cross(p, axis) * vscale
        pos[:, :3] = p.astype(dtype)
        vel[:, :3] = v.astype(dtype)

    elif config == NBodyConfig.EXPAND:
        scale = cluster_scale * n / 1024.0
        if scale < 1.0:
            scale = cluster_scale
        vscale = scale * velocity_scale
        point = _uniform_ball(rng, n, dtype)
        pos[:, :3] = point * dtype(scale)
        vel[:, :3] = point * dtype(vscale)

    elif config == NBodyConfig.PLUMMER:
        p3, v3, m = _plummer(rng, n, a=cluster_scale, vscale=velocity_scale)
        pos[:, :3] = p3.astype(dtype)
        pos[:, 3] = m.astype(dtype)
        vel[:, :3] = v3.astype(dtype)

    else:  # pragma: no cover
        raise ValueError(f"unknown config {config}")

    return pos, vel


# Truncation radius of the Plummer sampler, in scale radii. 10a encloses
# 98.5% of the total mass; cutting the tail keeps fp32 coordinates and the
# demo camera sane (the untruncated r distribution has infinite variance).
_PLUMMER_RMAX = 10.0


def _plummer(
    rng: np.random.Generator, n: int, *, a: float, vscale: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Isotropic Plummer sphere in equilibrium (Aarseth, Henon & Wielen 1974).

    Density rho(r) ∝ (1 + r²/a²)^(-5/2); enclosed-mass fraction
    f(r) = (r/a)³ / (1 + (r/a)²)^(3/2), inverted analytically for radius
    sampling. Speeds are drawn from the self-consistent distribution
    function: q = v/v_esc with pdf ∝ q²(1-q²)^(7/2) (rejection sampling),
    v_esc(r) = sqrt(2 M) (r²+a²)^(-1/4) with G = 1, M = 1.

    Returns (pos3, vel3, mass) in float64; the sphere is recentred so the
    centre of mass sits at the origin with zero net momentum (otherwise the
    sampled COM random-walks at O(N^-1/2), polluting drift checks).
    """
    m_tot = 1.0
    x_max = _PLUMMER_RMAX
    f_max = x_max**3 / (1.0 + x_max * x_max) ** 1.5  # mass fraction inside

    u = rng.uniform(0.0, f_max, size=n)
    r = a / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    p3 = _unit_sphere(rng, n, np.float64) * r[:, None]

    # rejection-sample q = v / v_esc from g(q) = q²(1-q²)^(7/2);
    # max g = (2/9)(7/9)^(7/2) ≈ 0.0920, so envelope 0.1 accepts ~46%
    q = np.empty(n, dtype=np.float64)
    filled = 0
    while filled < n:
        need = n - filled
        cand = rng.uniform(0.0, 1.0, size=int(need * 2.4) + 16)
        y = rng.uniform(0.0, 0.1, size=cand.shape)
        acc = cand[y < cand * cand * (1.0 - cand * cand) ** 3.5][:need]
        q[filled : filled + len(acc)] = acc
        filled += len(acc)

    v_esc = np.sqrt(2.0 * m_tot) * (r * r + a * a) ** -0.25
    v3 = _unit_sphere(rng, n, np.float64) * (q * v_esc * vscale)[:, None]

    mass = np.full(n, m_tot / n)
    p3 -= p3.mean(axis=0)  # equal masses: COM = plain mean
    v3 -= v3.mean(axis=0)
    return p3, v3, mass


def galaxy_disk(
    rng: np.random.Generator,
    num_bodies: int,
    *,
    radius: float = 3.0,
    thickness: float = 0.15,
    bulge_fraction: float = 0.2,
    total_mass: float = 1.0,
    softening: float = 0.1,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """A rotationally supported disk galaxy: exponential-ish disk + central
    bulge, bodies on near-circular orbits of the enclosed mass.

    The reference's galaxy demos come from external Tipsy snapshots
    (the reference's src/nbody/tipsy.cpp); this synthesizes comparable
    initial conditions natively so the demo/config[4] path needs no data
    files. Masses sum to total_mass.
    """
    n = int(num_bodies)
    n_bulge = int(n * bulge_fraction)
    n_disk = n - n_bulge

    # disk: surface density ~ exp(-r / (radius/3))
    r = rng.exponential(scale=radius / 3.0, size=n_disk)
    r = np.clip(r, 0.05 * radius, radius)
    theta = rng.uniform(0, 2 * np.pi, size=n_disk)
    z = rng.normal(scale=thickness, size=n_disk)
    disk = np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)

    # bulge: small isotropic ball
    bulge = _uniform_ball(rng, n_bulge, np.float64) * (0.25 * radius)

    p3 = np.concatenate([disk, bulge], axis=0)
    mass = np.full(n, total_mass / n)

    # circular velocity from enclosed mass (softened)
    rr = np.linalg.norm(p3[:, :2], axis=1)
    order = np.argsort(np.linalg.norm(p3, axis=1))
    enclosed = np.empty(n)
    enclosed[order] = np.cumsum(mass[order])
    v_circ = np.sqrt(enclosed * rr * rr / (rr * rr + softening**2) ** 1.5 + 1e-12)
    # tangential direction in the disk plane
    tx, ty = -p3[:, 1], p3[:, 0]
    tn = np.sqrt(tx * tx + ty * ty) + 1e-12
    v3 = np.stack([tx / tn * v_circ, ty / tn * v_circ, np.zeros(n)], axis=1)

    pos = np.zeros((n, 4), dtype=dtype)
    vel = np.zeros((n, 4), dtype=dtype)
    pos[:, :3] = p3
    pos[:, 3] = mass
    vel[:, :3] = v3
    return pos, vel


def galaxy_collision(
    num_bodies: int,
    *,
    separation: float = 8.0,
    approach_speed: float = 0.15,
    seed: int = 42,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """Two disk galaxies on a collision course — the classic interactive demo.

    Returns AoS (N, 4) pos/vel; N is split between the two galaxies.
    """
    rng = np.random.default_rng(seed)
    n1 = num_bodies // 2
    n2 = num_bodies - n1
    g1_pos, g1_vel = galaxy_disk(rng, n1, dtype=dtype)
    g2_pos, g2_vel = galaxy_disk(rng, n2, radius=2.0, dtype=dtype)

    # tilt the second galaxy and offset both
    c, s = np.cos(0.6), np.sin(0.6)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)
    g2_pos[:, :3] = g2_pos[:, :3] @ rot.T
    g2_vel[:, :3] = g2_vel[:, :3] @ rot.T

    g1_pos[:, 0] -= separation / 2
    g2_pos[:, 0] += separation / 2
    g1_vel[:, 0] += approach_speed
    g2_vel[:, 0] -= approach_speed
    # slight transverse offset for an off-center (angular-momentum) encounter
    g1_pos[:, 1] -= 0.5
    g2_pos[:, 1] += 0.5

    pos = np.concatenate([g1_pos, g2_pos], axis=0).astype(dtype)
    vel = np.concatenate([g1_vel, g2_vel], axis=0).astype(dtype)
    return pos, vel
