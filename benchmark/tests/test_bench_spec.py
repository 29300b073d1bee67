"""The benchmark's definition: ``BENCHMARK.json`` within its contract, every
file it names found by name, and no JAX anywhere the benchmark runs."""

import ast
import json
import pathlib
import re

import pytest

from benchmark import spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (ROOT / p).is_dir()


def test_entries_have_only_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_lines_use_only_the_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for key in {"configs": ("why", "source"), "workloads": ("why",),
                        "per_layer": ("layer",)}.get(group, ()):
                assert LINE.match(e[key]), (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    assert len(names) == len(set(names))


def test_metrics_cells_and_configs_are_consistent():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS and spec.applies(e2e[m["moves"]], cell)
    for cell in CELLS:
        reported = [n for n, m in e2e.items() if spec.applies(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(spec.applies(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cells_files_are_found_by_name(cell):
    c = spec.cell(cell)
    assert c.config["system"] in ("lio", "lvi") and c.traffic["system"] == c.config["system"]
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert c.checks["numbers"] and all("limit" in v for v in c.checks["numbers"].values())
    conf = next(x for x in BENCH["configs"] if x["name"] == c.config["name"])
    assert conf["file"].startswith(BENCH["paths"][0] + "/")
    assert conf["reduced"] == c.config["reduced"]
    assert LINE.match(c.traffic["why"])


def _imports(path: pathlib.Path) -> set:
    """Top-level names of every module a file imports (whole names)."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


HARNESS = sorted(p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_harness_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "lvislam_tpu"}


@pytest.mark.parametrize("path", [spec.HERE / "reference.py", spec.HERE / "roofline.py",
                                  *sorted((spec.HERE / "gen").glob("*.py"))],
                         ids=lambda p: p.name)
def test_reference_generator_and_yardstick_import_nothing_of_the_program(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "lvislam_tpu", "lvislam_tpu_torch"}


def test_reference_is_plain_numpy():
    assert _imports(spec.HERE / "reference.py") <= {"__future__", "numpy"}
