"""The control at a size a test run holds: the reference with the network's
products in float8 put in the program's place, on the tiny configuration,
fails a limit of the cell it stands for (the committed limits of
base.train and base.serve), as it does on the card at the cells' own
sizes (PERF.md)."""

import json

import pytest
import torch

from benchmark import control
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny.make_checkout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload,cell", [("tiny.train", "base.train"),
                                           ("tiny.serve", "base.serve")])
def test_fp8_control_fails_a_limit(root, workload, cell):
    limits = json.loads((tiny.REPO / "benchmark" / "limits" / f"{cell}.json").read_text())
    nums = control.control(workload, tiny.SEED, torch.device("cpu"), root=root)
    assert any(nums[k] > lim for k, lim in limits.items()), nums
