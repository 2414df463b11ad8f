"""The tiny cells driven with the program's step or forward broken
underneath (the harness's look for a chip skipped) come out not correct,
once for each fault a cell can have; sound runs of the same cells come out
correct. The faults: a training step that leaves its state unchanged;
half of each batch left out, the mean taken over the rest; a served
answer altered where it is produced (`benchmark/control.py:FAULTS`)."""

import pytest

from benchmark.control import FAULTS
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["tiny.train", "tiny.serve"])
def test_sound_run_is_correct(checkout, workload):
    line = tiny.run(checkout, workload)
    assert line["correct"], line["check"]


@pytest.mark.parametrize("workload,fault", [("tiny.train", "unchanged_state"),
                                            ("tiny.train", "half_batch"),
                                            ("tiny.serve", "altered_answer")])
def test_fault_is_not_correct(checkout, workload, fault):
    line = tiny.run(checkout, workload, wrap=FAULTS[fault])
    assert not line["correct"], line["check"]
