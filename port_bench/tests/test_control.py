"""The control, the reference in float32 with TF32 products in the port's
place, comes out not correct at the cells' limits (on the card: the CPU has
no TF32). The serving cells run two sessions, every cell a short window
(the fold's long enough to keep some of its calls)."""

import pytest

from port_bench import compare, drivers, run


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", ["flagship.serve", "pulse.serve", "flagship.sbc96", "flagship.train"])
def test_control_fails(cuda, workload):
    keep = {}
    _, _, mix = run.cell(workload)
    small = {**mix, "sessions": 2, "capture_rate": 0.05} if mix["kind"] == "session" else mix
    seconds = 8.0 if mix["kind"] == "sbc" else 3.0
    res = run.execute(workload, 2**31 + 99, seconds, False, "cuda", mix=small, keep=keep)
    assert res["correct"] is True
    ok, _ = compare.judge(drivers.load(mix["kind"]).control(keep["ctx"]), compare.load_limits(workload))
    assert not ok
