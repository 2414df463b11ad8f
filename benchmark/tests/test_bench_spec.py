"""BENCHMARK.json against the benchmark's contract, and the check that no
module of JAX or of the JAX package is loaded."""

import json
import re
import sys

from benchmark.reference import forbidden_modules
from benchmark.run import metric_reader
from benchmark.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        traffic = json.loads((REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (REPO / "benchmark" / "kinds" / f"{traffic['kind']}.py").is_file()
        assert (REPO / "benchmark" / "limits" / f"{w['name']}.json").is_file()
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert metric_reader(m["name"], REPO) is not None
        for w in m.get("workloads", []):
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for cell in cells:
        got = {m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", [cell])}
        assert "setup_s" in got and len(got) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in spec["per_layer"])


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lara_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "lara_tpu.models", sys)
    assert forbidden_modules() == ["jax.numpy", "lara_tpu.models"]
