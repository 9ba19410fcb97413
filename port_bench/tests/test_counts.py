"""The frozen operation counts against a count by hand of the saved shapes."""

import pytest

from port_bench import counts, run

FLAGSHIP = str(run.ROOT / "artifacts/models/mnle_10m_shifted_logt_affine.npz")
PULSE = str(run.ROOT / "artifacts/models/mnle_1m_pulseabs.npz")


def test_flagship_row_counts():
    s = counts.shapes(FLAGSHIP)
    # cat 85-128-128-3, trunk 88-128-128-128, ten heads 128x71, affine 128x2
    fwd = 85 * 128 + 128 * 128 + 128 * 3 + 88 * 128 + 2 * 128 * 128 + 10 * 128 * 71 + 128 * 2
    assert counts.row_flops(s, False) == 2 * fwd
    assert counts.row_flops(s, True) == 2 * (2 * fwd - 3 * 128)  # the trunk's first layer: 85 of its 88 inputs
    assert counts.train_flops(s) == 2 * (3 * fwd - 85 * 128 - 88 * 128)
    assert (s.D, s.C, s.F) == (85, 3, 0)


def test_pulse_row_counts():
    s = counts.shapes(PULSE)
    fwd = 85 * 128 + 128 * 128 + 128 * 3 + 88 * 128 + 2 * 128 * 128 + 10 * 131 * 73 + 128 * 80
    assert counts.row_flops(s, False) == 2 * fwd
    assert (s.D, s.C, s.F) == (85, 3, 3)


def test_k3_bound_at_1200_rows():
    """K3's datasheet bound at 1,200 flagship rows, 0.01165 ms in the port's
    own kernel table, bound by FLOP."""
    s = counts.shapes(FLAGSHIP)
    seconds, by = counts.bound_seconds(1200 * counts.row_flops(s, True),
                                       counts.weight_bytes(s) + 1200 * counts.row_bytes(s, True))
    assert by == "flops"
    assert seconds * 1e3 == pytest.approx(0.01165, rel=2e-3)
