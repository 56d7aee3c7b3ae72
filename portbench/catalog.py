"""Finding the benchmark's items by name, in files of their own.

- a configuration: ``configs/<name>.json``;
- a traffic mix: ``traffic/<name>.json``, which names the path that runs it;
- a cell: ``workloads/<name>.json`` (its configuration, traffic, chips,
  why, the control and the limits of its correctness check);
- a per-layer metric: ``metrics/<name>.py`` (``LAYER``, ``UNIT``,
  ``BETTER``, ``MOVES`` and ``read(ctx)``);
- a path driver: ``paths/<name>.py``, a ``Path(run)`` class whose
  construction is the set-up, with ``window(seconds)`` (the end-to-end
  metrics, ``attempted``, ``failed``), ``slice()`` (the traced work),
  ``layer_context(traced)`` (what the readers read), ``gather_max`` and
  ``gather_mean`` (across ranks), ``free()``, ``check()`` (the compared
  numbers, after ``free``) and ``detail`` (what ``check`` found worst).

``BENCHMARK.json`` at the root of the checkout lists what runs; nothing
here needs an edit when a file and an entry are added.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(kind: str, name: str, ext: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return os.path.join(HERE, kind, name + ext)


def read_json(kind: str, name: str) -> dict:
    with open(_path(kind, name, ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = _path(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, bench: dict = None) -> Dict:
    """Everything one cell runs with: its ``BENCHMARK.json`` entry, its
    file, its configuration and traffic, and the per-layer metrics that
    list it."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = read_json("workloads", name)
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json {key} {spec[key]!r} != "
                             f"BENCHMARK.json's {entry[key]!r}")
    return {"name": name, "spec": spec, "config": read_json("configs", entry["config"]),
            "traffic": read_json("traffic", entry["traffic"]), "chips": entry["chips"],
            "end_to_end": [m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
            "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [name])]}


def metric_readers(metrics: List[dict]) -> Dict[str, ModuleType]:
    """Each per-layer metric's reader, checked against its entry."""
    out = {}
    for m in metrics:
        mod = load_module("metrics", m["name"])
        for key, attr in (("layer", "LAYER"), ("unit", "UNIT"), ("better", "BETTER"),
                          ("moves", "MOVES")):
            if getattr(mod, attr) != m[key]:
                raise ValueError(f"metrics/{m['name']}.py {attr} {getattr(mod, attr)!r} != "
                                 f"BENCHMARK.json's {m[key]!r}")
        out[m["name"]] = mod
    return out
