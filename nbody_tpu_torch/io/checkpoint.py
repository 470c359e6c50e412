"""Checkpoint loading: the npz format of ``nbody_tpu.io.save_checkpoint``.

The port's copy of the reader, with the same names and behaviour for an npz
file. An orbax checkpoint directory needs JAX, so the port refuses it.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nbody_tpu_torch.params import NBodyParams

FORMAT_VERSION = 1


def load_checkpoint(path):
    """Returns (pos, vel, params, meta_dict) from an npz checkpoint."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is an orbax checkpoint directory, which needs "
                         "JAX; save an npz checkpoint instead")
    with np.load(path) as data:
        pos = data["pos"]
        vel = data["vel"]
        meta = json.loads(bytes(data["meta"].tobytes()).decode())
    return pos, vel, _params_from_meta(meta), meta


def _params_from_meta(meta: dict) -> NBodyParams:
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta.get('version')}")
    pdict = dict(meta["params"])
    pdict["camera_origin"] = tuple(pdict["camera_origin"])
    return NBodyParams(**pdict)
