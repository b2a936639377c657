"""Find a cell's pieces by name: its entry in `BENCHMARK.json`, the
configuration file, the traffic mix, the mix's driver and every metric's
reader.

Each piece is a file of its own, so a later change adds a cell, a mix or a
metric by adding files and an entry, never by editing one:

  gridbench/configs/<config>.json   one deployment
  gridbench/traffic/<mix>.json      one traffic mix; names its driver
  gridbench/drivers/<driver>.py     the code for one kind of traffic
  gridbench/metrics/<metric>.py     one reader per metric

A metric's reader is `metrics/<name>.py`; where that file is missing and
the name has a dotted form (`device.idle_pct.query`), the reader of its
stem (`metrics/device.idle_pct.py`) serves it and gets the form
(`query`) as its argument.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(path: Path = BENCHMARK_JSON) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def _json_file(sub: str, name: str) -> dict:
    if not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}")
    with open(BENCH_DIR / sub / f"{name}.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json_file("configs", name)


def traffic(name: str) -> dict:
    return _json_file("traffic", name)


def _module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(f"gridbench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """The module `drivers/<name>.py`."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad driver name {name!r}")
    return _module(BENCH_DIR / "drivers" / f"{name}.py",
                   "driver_" + name.replace(".", "_").replace("-", "_"))


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """A callable rec -> value or None for the named metric."""
    mdir = BENCH_DIR / "metrics"
    path, form = mdir / f"{metric}.py", None
    if not path.exists() and "." in metric:
        stem, form = metric.rsplit(".", 1)
        path = mdir / f"{stem}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r}")
    mod = _module(path, "metric_" + re.sub(r"[^A-Za-z0-9_]", "_", metric))
    return lambda rec: mod.read(rec, form)


def metrics_of(bench: dict, workload: str, traced: bool) -> List[dict]:
    """The metric entries the cell reports: with tracing off its end-to-end
    metrics, with tracing on its per-layer ones (an entry without a
    `workloads` key belongs to every cell)."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]

