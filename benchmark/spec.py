"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` of its ``configs`` entry;
- a traffic mix: ``benchmark/traffic/<traffic>.json``;
- a metric (end-to-end or per-layer): ``benchmark/metrics/<name>.py``, whose
  ``read(ctx)`` returns the number or None where the run has nothing to
  read;
- a cell's numbers compared by ``correct`` and their limits:
  ``benchmark/checks/<workload>.json``.

A cell, a mix or a metric added later brings its own files; none of these
needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list
    checks: dict

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=name, chips=w["chips"], config=load_json(root / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)],
                checks=load_json(HERE / "checks" / f"{name}.json"))


def reader(metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    name = "benchmark_metric_" + metric.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
