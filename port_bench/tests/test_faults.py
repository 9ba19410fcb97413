"""A run with the timed path broken underneath the benchmark comes out not
correct: for the sampler, an answer replaced where the kernel produces it;
for training, a step that leaves the state unchanged and a loss over half
of the batch. The same runs unbroken are correct."""

import pytest

from port_bench.calibrate import fault

from .conftest import run_small


@pytest.mark.parametrize("workload,broken", [
    ("flagship.serve", None), ("flagship.serve", "answer_altered"),
    ("pulse.serve", None), ("pulse.serve", "answer_altered"),
    ("flagship.sbc96", None), ("flagship.sbc96", "answer_altered"),
    ("flagship.train", None), ("flagship.train", "state_unchanged"), ("flagship.train", "half_batch"),
])
def test_fault_fails(workload, broken):
    if broken is None:
        assert run_small(workload)["correct"] is True
        return
    with fault(broken):
        res = run_small(workload)
    assert res["correct"] is False
