"""Fixtures of the benchmark's own tests. They run on the CPU at small sizes
(``python -m pytest port_bench/tests``); a test that needs the card takes the
``cuda`` fixture and is skipped without one."""

import pytest
import torch

from port_bench import run

# Small mixes of each request kind: the cells' own code paths at sizes a CPU
# test run holds.
SMALL = {
    "session": {"sessions": 2, "capture_rate": 0.5, "max_captures": 8,
                "run_config": {"WARMUP_STEPS": 2, "POSTERIOR_SAMPLES": 8, "MCMC_MAX_TREE_DEPTH": 2},
                "warmup_request": {"WARMUP_STEPS": 1, "POSTERIOR_SAMPLES": 4, "MCMC_MAX_TREE_DEPTH": 2}},
    "sbc": {"datasets": 1, "group_size": 1, "capture_rate": 0.5, "max_captures": 8,
            "run_config": {"WARMUP_STEPS": 1, "SBC_POST_SAMPLES": 8, "MCMC_MAX_TREE_DEPTH": 2, "SBC_REMEDIATE": False}},
    "train": {"pairs": 16_384},
}


def small_mix(workload: str) -> dict:
    _, _, mix = run.cell(workload)
    return {**mix, **SMALL[mix["kind"]]}


def run_small(workload: str, seconds: float = 3.0, trace: bool = False, seed: int = 2**31 + 7, keep=None) -> dict:
    torch.manual_seed(0)
    return run.execute(workload, seed, seconds, trace, "cpu", mix=small_mix(workload), keep=keep)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
