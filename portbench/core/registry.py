"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Everything else is found from those names, so that a later cell,
mix or metric is added as files and entries alone:

* ``configs/<config>.json`` (the path in ``configs[].file``): the
  problem's sizes, its source, ``reduced`` and ``assumed``;
* ``mixes/<traffic>.json``: the calls' parameters, the ``entry`` that
  makes them and the ``reference`` that judges them;
* ``limits/<cell>.json``: the limit of each number the judge compares;
* ``problems/<problem>.py``, ``entries/<entry>.py``,
  ``reference/<reference>.py``: named by the configuration and the mix;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  metric of ``end_to_end`` and ``per_layer`` (``setup_s`` is the
  harness's own); a metric ``<quantity>.<part>``, one quantity split by
  cells, is read by ``<quantity>.py`` unless it has a file of its own.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
SPEC = ROOT / "BENCHMARK.json"

_LOADED: dict = {}


class Cell(NamedTuple):
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list   # the metric entries this cell reports, trace 0
    per_layer: list    # ... and with trace 1


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str, base: Path = BENCH_DIR):
    """The module ``<base>/<kind>/<name>.py``, loaded once per process
    under a name of its own (a file name may hold dots).  A name split by
    cells, ``<quantity>.<part>``, is read by ``<quantity>.py`` where it has
    no file of its own: one reader serves each part."""
    path = base / kind / f"{name}.py"
    if not path.is_file() and "." in name:
        path = base / kind / f"{name.split('.')[0]}.py"
    key = str(path)
    if key not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file for {name} in "
                                    f"{base / kind}")
        mod_name = "portbench_" + kind + "_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, spec_path: Path = SPEC,
              base: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of the benchmark file, with its files read."""
    spec = read_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path}; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(spec_path.parent / configs[w["config"]]["file"])
    mix = read_json(base / "mixes" / f"{w['traffic']}.json")
    limits = read_json(base / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    layer = [m for m in spec["per_layer"] if _reports(m, name)]
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config,
                mix, limits, e2e, layer)
