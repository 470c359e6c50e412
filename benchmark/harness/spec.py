"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics; each part is a file of its own under ``benchmark/``:

  configs/<config>.json     the configuration as it is run
  workloads/<traffic>.json  the cell's traffic: bodies, integrator, steps a
                            segment, replays, strategy, the check's limits
  metrics/<metric>.py       read(rec) -> number or None, from the run's records
  rooflines/<config>.py     bound_s_per_step(workload, config, pos) -> seconds
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module benchmark/<kind>/<name>.py, loaded from its file."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> dict:
    """{"name", "chips", "workload", "config", "end_to_end", "per_layer"} of
    the cell `name`: its traffic and configuration files, and the metric
    entries of BENCHMARK.json that it reports."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = load_json(BENCH / "workloads" / f"{entry['traffic']}.json")
    config = load_json(BENCH / "configs" / f"{entry['config']}.json")
    if workload["config"] != entry["config"] or workload["chips"] != entry["chips"]:
        raise ValueError(f"workloads/{entry['traffic']}.json disagrees with BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name]) and m["moves"] in moved]
    return {"name": name, "chips": entry["chips"], "workload": workload, "config": config,
            "end_to_end": e2e, "per_layer": per_layer}
