"""Checkpoint save/load: positions + velocities + parameters to .npz.

The port's copy of ``nbody_tpu.io.checkpoint``'s npz format, with the same
names and behaviour: files written by either package load in the other, bit
for bit, float32, float64 and the raw double-single planes alike. The
orbax checkpoint directories of ``nbody_tpu`` need JAX, so the port refuses
a directory path, to save or to load.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from nbody_tpu_torch.config import NBodyConfig
from nbody_tpu_torch.params import NBodyParams

FORMAT_VERSION = 1


def _refuse_directory(path) -> None:
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: orbax checkpoint directories need JAX; "
                         "the port reads and writes npz checkpoint files")


def save_checkpoint(path, pos, vel, params: NBodyParams, *, step: int = 0,
                    config: NBodyConfig | None = None, extra: dict | None = None,
                    atomic: bool = False, ds_planes=None) -> None:
    """``atomic=True`` writes to a sibling temp file and ``os.replace``s it
    into place, so a crash mid-write (the case periodic autosave exists
    for) can never leave a truncated checkpoint under the real name.

    ``ds_planes`` = (pos_hi, pos_lo, vel_hi, vel_lo) float32 arrays of a
    double-single state: saved alongside the f64 views so a ds resume is
    BIT-exact. (The f64 view alone is not enough: a ds pair whose hi/lo
    exponent gap exceeds f64's 29 spare mantissa bits carries information
    below f64 resolution, so hi+lo would round.) Non-ds loaders read the
    plain pos/vel and work unchanged."""
    _refuse_directory(path)
    meta = {
        "version": FORMAT_VERSION,
        "params": dataclasses.asdict(params),
        "step": int(step),
        "config": config.value if config is not None else None,
        "extra": extra or {},
    }
    arrays = {
        "pos": np.asarray(pos),
        "vel": np.asarray(vel),
    }
    if ds_planes is not None:
        meta["ds"] = True
        for name, a in zip(("pos_hi", "pos_lo", "vel_hi", "vel_lo"), ds_planes):
            arrays[name] = np.asarray(a, np.float32)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    target = f"{path}.tmp{os.getpid()}" if atomic else path
    # write through an open handle: np.savez silently appends ".npz" to bare
    # paths, which would break save/load round trips under the same name
    with open(target, "wb") as f:
        np.savez(f, **arrays)
    if atomic:
        os.replace(target, path)


def load_checkpoint(path):
    """Returns (pos, vel, params, meta_dict) from an npz checkpoint."""
    _refuse_directory(path)
    with np.load(path) as data:
        pos = data["pos"]
        vel = data["vel"]
        meta = json.loads(bytes(data["meta"].tobytes()).decode())
    return pos, vel, _params_from_meta(meta), meta


def load_checkpoint_ds_planes(path):
    """(pos_hi, pos_lo, vel_hi, vel_lo) if `path` carries a double-single
    state (save_checkpoint ds_planes=...), else None — the bit-exact ds
    resume path."""
    _refuse_directory(path)
    with np.load(path) as data:
        if "pos_hi" not in data.files:
            return None
        return tuple(data[k] for k in ("pos_hi", "pos_lo", "vel_hi", "vel_lo"))


def _params_from_meta(meta: dict) -> NBodyParams:
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta.get('version')}")
    pdict = dict(meta["params"])
    pdict["camera_origin"] = tuple(pdict["camera_origin"])
    return NBodyParams(**pdict)
