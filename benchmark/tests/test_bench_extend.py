"""A configuration, traffic mixes of the kinds there and of a new kind,
limits and per-layer metrics added as new files and new `BENCHMARK.json`
entries in a copy of the benchmark run at a tiny size on the CPU, every
existing file left as it was; and the result line's schema."""

import filecmp
import json
import re

import pytest

from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("bench"))


def test_existing_files_unchanged(checkout):
    src = tiny.REPO / "benchmark"
    for path in src.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts and "tests" not in path.parts:
            assert filecmp.cmp(path, checkout / "benchmark" / path.relative_to(src),
                               shallow=False), path


def _schema(line, trace):
    assert list(line)[-1] == "check"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    for name, m in line["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"]) and isinstance(m["value"], float)
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in line["device"]
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in line["check"].items():
        assert NAME.match(name) and set(c) == {"value", "limit"}
    json.dumps(line)


# on the CPU no operation runs on a device: the readers of device time find
# nothing and the line leaves them out (test_bench_readers.py reads them)
WANT = {("tiny.train", 0): {"setup_s", "train_scenes_per_s", "train_peak_mem_gb"},
        ("tiny.train", 1): {"mfu.train"},
        ("tiny.serve", 0): {"setup_s", "serve_scenes_per_s", "serve_p95_ms"},
        ("tiny.serve", 1): {"mfu.serve", "traced_steps.tiny"},
        ("tiny.coarse", 0): {"setup_s", "coarse_scenes_per_s"},
        ("tiny.coarse", 1): {"traced_steps.coarse"}}


@pytest.mark.parametrize("workload,trace", sorted(WANT))
def test_added_cell_runs(checkout, workload, trace):
    line = tiny.run(checkout, workload, trace=trace)
    _schema(line, trace)
    assert line["correct"], line["check"]
    assert set(line["metrics"]) == WANT[workload, trace]
