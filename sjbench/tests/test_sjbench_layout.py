"""The benchmark's files are found by name, ``BENCHMARK.json`` keeps to the
contract's shapes, and no module of the reference imports the JAX stack,
the JAX package or the program."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from sjbench import harness

BENCH = Path(harness.__file__).resolve().parent
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_sjbench_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["sjbench"] and SPEC["command"] == ["python3", "sjbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = ([c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "bound" in m:
            assert 0.01 <= m["bound"] <= 0.25
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_sjbench_cell_files_found_by_name(cell):
    c = harness.Cell(SPEC, cell)
    assert c.config["name"] == c.entry["config"]
    harness.load_module("kinds", c.traffic["kind"]).Driver
    reported = {m["name"] for m in c.metrics("end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.metrics("per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_sjbench_metric_reader_found_by_name(metric):
    assert callable(harness.load_module("metrics", metric).read)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_sjbench_config_file_names_its_source(config):
    with open(BENCH.parent / config["file"]) as f:
        data = json.load(f)
    assert data["source"] and data["reduced"] == config["reduced"]
    assert "assumed" in data and "guarantees" in data


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_sjbench_reference_imports_nothing_of_jax_or_the_program(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                                 "benchmarks"}


def test_sjbench_harness_reads_no_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, path


def test_sjbench_import_guard_compares_whole_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core", "jax._src", "torch"]) == ["jax", "repro"]
