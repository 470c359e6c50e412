"""Tipsy galaxy-file reader/writer (Bedorf-modified binary format).

Byte-compatible with the format the reference consumes
(the reference's src/nbody/tipsy.cpp:14-127 — struct layouts re-derived):

* header ``Dump``: double time; int nbodies, ndim, nsph, ndark, nstar —
  C struct alignment pads it to 32 bytes,
* then ``ndark`` DarkParticle records (mass, pos[3], vel[3], eps, phi:int —
  36 bytes) followed by ``nbodies - ndark`` StarParticle records (mass,
  pos[3], vel[3], metals, tform, eps, phi:int — 44 bytes). In the modified
  format, phi carries the particle id.

Packing matches the reference: pos.w = mass, vel.w = eps, and N is rounded
up to a multiple of 256 with zero-mass bodies.
"""

from __future__ import annotations

import numpy as np

PAD_MULTIPLE = 256

_DUMP_DTYPE = np.dtype(
    [
        ("time", "<f8"),
        ("nbodies", "<i4"),
        ("ndim", "<i4"),
        ("nsph", "<i4"),
        ("ndark", "<i4"),
        ("nstar", "<i4"),
        ("_pad", "<i4"),  # C alignment padding to 32 bytes
    ]
)

_DARK_DTYPE = np.dtype(
    [
        ("mass", "<f4"),
        ("pos", "<f4", (3,)),
        ("vel", "<f4", (3,)),
        ("eps", "<f4"),
        ("phi", "<i4"),
    ]
)

_STAR_DTYPE = np.dtype(
    [
        ("mass", "<f4"),
        ("pos", "<f4", (3,)),
        ("vel", "<f4", (3,)),
        ("metals", "<f4"),
        ("tform", "<f4"),
        ("eps", "<f4"),
        ("phi", "<i4"),
    ]
)

assert _DUMP_DTYPE.itemsize == 32
assert _DARK_DTYPE.itemsize == 36
assert _STAR_DTYPE.itemsize == 44


def read_tipsy_file(path, *, native: bool | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Read a tipsy file into AoS (N, 4) float64 pos [x,y,z,mass] and vel
    [vx,vy,vz,eps], N padded up to a multiple of 256 with zero-mass bodies.

    Uses the native C++ loader when built (like the reference's C++ reader);
    native=False forces the NumPy path (used to cross-check the two)."""
    if native is None:
        import os

        native = not os.environ.get("NBODY_TIPSY_NUMPY")
    if native:
        from nbody_tpu_torch.oracle.native import native_available, read_tipsy_native

        if native_available():
            return read_tipsy_native(path)
    return _read_tipsy_numpy(path)


def _read_tipsy_numpy(path) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        header = np.frombuffer(f.read(_DUMP_DTYPE.itemsize), dtype=_DUMP_DTYPE)[0]
        n_total = int(header["nbodies"])
        n_dark = int(header["ndark"])
        if n_total < 0 or n_dark < 0 or n_dark > n_total:
            raise ValueError(f"corrupt tipsy header: nbodies={n_total} ndark={n_dark}")
        dark = np.frombuffer(f.read(_DARK_DTYPE.itemsize * n_dark), dtype=_DARK_DTYPE)
        n_star = n_total - n_dark
        star = np.frombuffer(f.read(_STAR_DTYPE.itemsize * n_star), dtype=_STAR_DTYPE)
    if len(dark) != n_dark or len(star) != n_star:
        raise ValueError("truncated tipsy file")

    n_padded = ((n_total + PAD_MULTIPLE - 1) // PAD_MULTIPLE) * PAD_MULTIPLE
    pos = np.zeros((n_padded, 4), dtype=np.float64)
    vel = np.zeros((n_padded, 4), dtype=np.float64)
    for recs, start in ((dark, 0), (star, n_dark)):
        if len(recs) == 0:
            continue
        sl = slice(start, start + len(recs))
        pos[sl, :3] = recs["pos"]
        pos[sl, 3] = recs["mass"]
        vel[sl, :3] = recs["vel"]
        vel[sl, 3] = recs["eps"]
    return pos, vel


def read_tipsy_file_coordinates(path):
    """SoA variant (the reference's read_tipsy_file_coordinates,
    the reference's src/nbody/tipsy.cpp:129-197): returns a dict with
    x/y/z/vx/vy/vz/mass/eps float64 arrays (padded like the AoS reader)."""
    pos, vel = read_tipsy_file(path)
    return {
        "x": pos[:, 0].copy(), "y": pos[:, 1].copy(), "z": pos[:, 2].copy(),
        "vx": vel[:, 0].copy(), "vy": vel[:, 1].copy(), "vz": vel[:, 2].copy(),
        "mass": pos[:, 3].copy(), "eps": vel[:, 3].copy(),
    }


def write_tipsy_file(path, pos: np.ndarray, vel: np.ndarray, *, time: float = 0.0, n_dark: int | None = None) -> None:
    """Write state as a tipsy file (dark particles by default). Useful for
    tests and for exporting states consumable by the reference binary."""
    n = pos.shape[0]
    if n_dark is None:
        n_dark = n
    n_star = n - n_dark
    header = np.zeros(1, dtype=_DUMP_DTYPE)
    header["time"] = time
    header["nbodies"] = n
    header["ndim"] = 3
    header["ndark"] = n_dark
    header["nstar"] = n_star

    dark = np.zeros(n_dark, dtype=_DARK_DTYPE)
    dark["pos"] = pos[:n_dark, :3]
    dark["mass"] = pos[:n_dark, 3]
    dark["vel"] = vel[:n_dark, :3]
    dark["eps"] = vel[:n_dark, 3]
    dark["phi"] = np.arange(n_dark, dtype=np.int32)

    star = np.zeros(n_star, dtype=_STAR_DTYPE)
    if n_star:
        star["pos"] = pos[n_dark:, :3]
        star["mass"] = pos[n_dark:, 3]
        star["vel"] = vel[n_dark:, :3]
        star["eps"] = vel[n_dark:, 3]
        star["phi"] = np.arange(n_dark, n, dtype=np.int32)

    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(dark.tobytes())
        f.write(star.tobytes())
