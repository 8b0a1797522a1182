"""A cell's pieces, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, ``port_bench/traffic/<traffic>.json``.
The mix names the driver that runs it (``"driver"``: a module of
``port_bench/drivers``) and holds its parameters.  Each per-layer metric is
a reader ``port_bench/metrics/<name>.py`` with a function ``read(run)``.
A new cell, configuration, mix or metric is new files and new entries; no
file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ["ROOT", "Cell", "load_cell", "load_metric", "load_driver"]

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list   # ... and with --trace 1
    root: Path


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration
    and traffic files read.  A per-layer metric without a ``workloads`` key
    belongs to every cell that reports the end-to-end metric it moves."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "port_bench" / "traffic" / f"{entry['traffic']}.json").read_text())

    def mine(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name, int(entry["chips"]), entry["config"], entry["traffic"], config, traffic, e2e, per_layer, root)


def load_metric(name: str, root: Path = ROOT):
    """The reader module of per-layer metric ``name``."""
    path = Path(root) / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("port_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(kind: str):
    return importlib.import_module(f"port_bench.drivers.{kind}")
