"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell
(``workloads``), its configuration (``configs``: a JSON file) and its
traffic mix; the metrics it reports follow from the metrics' own entries.
Everything else is found by name, so a new cell, configuration, traffic
mix or per-layer metric is a new file and an entry, and no edit:

* ``benchmark/traffic/<traffic>.json``: the mix's parameters;
* ``benchmark/inits/<distribution>.py``: an initial distribution that a
  configuration names in ``init.distribution`` (``states.make_bodies``);
* ``benchmark/metrics/<metric name>.py``: the per-layer metric's reader,
  a module with ``read(readings)``, which returns a number (or None
  where it finds nothing to read) and, where the module also has
  ``merge(values)``, what ``merge`` turns into the number from the
  values every rank of a mesh read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
# a name that ``BENCHMARK.json`` or a configuration gives a file
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path = ROOT  # the checkout whose benchmark/ holds the files

    @property
    def devices(self) -> int:
        return int(self.config.get("devices", 1))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT, spec: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and metrics."""
    spec = spec if spec is not None else benchmark_spec(root)
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(root / "benchmark" / "traffic"
                        / f"{w['traffic']}.json")
    e2e = [Metric(m["name"], m["unit"]) for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    # every per-layer entry lists its cells
    per_layer = [Metric(m["name"], m["unit"]) for m in spec["per_layer"]
                 if name in m["workloads"]]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                root)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by path (a metric's name has dots,
    so it is no importable module name)."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_module(metric: str, root: Path = ROOT):
    """The module ``benchmark/metrics/<metric>.py``."""
    return load_module(root / "benchmark" / "metrics" / f"{metric}.py",
                       f"benchmark_metric_{metric.replace('.', '_')}")


def init_module(distribution: str, root: Path = ROOT):
    """The module ``benchmark/inits/<distribution>.py``; an error that
    names the distribution where there is none."""
    path = root / "benchmark" / "inits" / f"{distribution}.py"
    if not (isinstance(distribution, str) and NAME.match(distribution)
            and path.is_file()):
        raise ValueError(f"unknown initial distribution {distribution!r}: "
                         f"no benchmark/inits/{distribution}.py")
    return load_module(path, "benchmark_init_"
                       + distribution.replace(".", "_"))


def read_metrics(cell: Cell, readings) -> dict:
    """{name: what its reader read} of the cell's per-layer metrics on
    one rank, leaving out those that found nothing to read."""
    out = {}
    for m in cell.per_layer:
        value = metric_module(m.name, cell.root).read(readings)
        if value is not None:
            out[m.name] = value
    return out


def merge_metrics(cell: Cell, ranks: List[dict]) -> Dict[str, dict]:
    """{name: {"value", "unit"}} from every rank's :func:`read_metrics`
    (rank order): the reader's ``merge`` over the ranks where it has one,
    else rank 0's value."""
    out = {}
    for m in cell.per_layer:
        merge = getattr(metric_module(m.name, cell.root), "merge", None)
        if merge is None:
            value = ranks[0].get(m.name)
        else:
            values = [r.get(m.name) for r in ranks]
            value = (None if any(v is None for v in values)
                     else merge(values))
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out
