"""PyTorch port: K1's launch-shape rule, and the committed outputs of the
parent K1 (``tests/k1_fixture.py``) against the plain version on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py`` holds
it to the fixture bit for bit there); here the rule that picks its launch
shape is checked as the pure function it is, the refill's assignment of
trials to groups is emulated, and the fixture is held to the plain version
(``ops/ddm_scan.ddm_rt_choice_scan``) in distribution: the two draw their
noise from different streams.
"""

import heapq

import numpy as np
import pytest
import torch
from scipy import stats

import k1_fixture  # tests/k1_fixture.py
from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import (
    K1_GROUP_SIZES,
    K1_LANES_PER_SM,
    K1_THREADS,
    K1_TRIALS_PER_GROUP,
    ddm_rt_choice_cuda,
    k1_launch_shape,
)

P_MIN = 1e-3  # as tests/test_torch_cuda.py's K1 distribution tests
NS = sorted({1, 2, 31, 33, 50, 1000, 2112, 2113, 4096, 8192, 16896, 33000, 131072, 270336, 300000, 524288}
            | {int(1.7**i) for i in range(25)})
CARDS = {
    "h100": (132, {8: 12, 2: 16, 1: 16}),
    "h100_low_occupancy": (132, {8: 4, 2: 6, 1: 8}),
    "small": (8, {g: 2 for g in K1_GROUP_SIZES}),
    "no_room": (1, {g: 0 for g in K1_GROUP_SIZES}),
}


@pytest.mark.parametrize("spp", [200, 8, 4])
@pytest.mark.parametrize("card", sorted(CARDS))
def test_k1_launch_shape_rule(card, spp):
    """G is the largest group size whose lanes fit K1_TRIALS_PER_GROUP x
    K1_LANES_PER_SM an SM and whose iteration holds at most one chunk start;
    the grid has a group for every trial up to K1_LANES_PER_SM lanes an SM
    and the resident blocks, and at least one block."""
    sm, resident = CARDS[card]
    for n in NS:
        G, blocks = k1_launch_shape(n, spp, sm, resident)
        fits = [g for g in K1_GROUP_SIZES
                if 4 * g <= spp and g * n <= K1_TRIALS_PER_GROUP * sm * K1_LANES_PER_SM]
        assert G == max(fits, default=1), (n, G)
        assert K1_THREADS % G == 0 and blocks >= 1
        cap = sm * min(K1_LANES_PER_SM // K1_THREADS, max(resident[G], 1))
        assert blocks == min(-(-n * G // K1_THREADS), cap), (n, G, blocks)
        assert blocks * K1_THREADS // G >= min(n, cap * K1_THREADS // G)


def test_k1_launch_shape_at_the_main_path_sizes():
    """On the H100 (132 SMs, four blocks an SM: 67,584 lanes): eight lanes
    a trial at the main path's 4,096 and for a 50-trial session, two from
    33,793 (where eight no longer fit) to 131,072, and one at 524,288,
    where groups refill."""
    sm, resident = CARDS["h100"]
    assert k1_launch_shape(4096, 200, sm, resident) == (8, 256)
    assert k1_launch_shape(50, 200, sm, resident) == (8, 4)
    assert k1_launch_shape(33792, 200, sm, resident) == (8, 528)
    assert k1_launch_shape(33793, 200, sm, resident) == (2, 528)
    assert k1_launch_shape(50000, 200, sm, resident) == (2, 528)
    assert k1_launch_shape(131072, 200, sm, resident) == (2, 528)
    assert k1_launch_shape(524288, 200, sm, resident) == (1, 528)
    assert k1_launch_shape(131072, 200, sm, {g: 2 for g in K1_GROUP_SIZES}) == (2, 264)
    with pytest.raises(ValueError):
        k1_launch_shape(0, 200, sm, resident)


def _emulate_refill(n, groups, rng):
    """The kernel's assignment: group q starts with trial q; a group whose
    trial ends takes groups + (the counter, then one more). Trials end after
    random durations. Returns how often each trial was simulated."""
    seen = np.zeros(n, np.int64)
    counter = 0
    heap = []
    for q in range(min(groups, n)):
        seen[q] += 1
        heapq.heappush(heap, (rng.exponential(), q))
    while heap:
        now, q = heapq.heappop(heap)
        trial = groups + counter
        counter += 1
        if trial < n:
            seen[trial] += 1
            heapq.heappush(heap, (now + rng.exponential(), q))
    return seen


@pytest.mark.parametrize("n", [1, 33, 255, 256, 257, 4096, 20000])
def test_k1_refill_leaves_no_trial_unassigned(n):
    """With the grid the rule picks on a card that holds few lanes, every
    trial is simulated exactly once."""
    sm, resident = CARDS["small"]
    G, blocks = k1_launch_shape(n, 200, sm, resident)
    seen = _emulate_refill(n, blocks * K1_THREADS // G, np.random.default_rng(n))
    assert (seen == 1).all(), np.flatnonzero(seen != 1)[:10]


def test_k1_fixture_is_whole():
    """Every case, its shape, the values K1 can write, and the parent commit."""
    data = k1_fixture.load()
    assert len(data["parent_commit"]) == 40
    for name, case in k1_fixture.CASES.items():
        out = data[name]
        w = k1_fixture.WINDOWS[case["window"]]
        assert out.shape == (case["n"], 2) and out.dtype == np.float32, name
        assert set(np.unique(out[:, 1]).tolist()) <= {0.0, 1.0, 2.0}, name
        assert (out[:, 0] >= 1e-6).all() and (out[:, 0] <= w["t_max"]).all(), name
        theta, _ = k1_fixture.inputs(case["n"], case["window"], case["seed"])
        steps = (out[:, 0].astype(np.float64) - theta[:, 4]) / w["dt"]
        np.testing.assert_allclose(steps, np.rint(steps), atol=1e-2, err_msg=name)  # on the step grid
        assert (np.rint(steps) <= w["n_max"]).all(), name


@pytest.mark.parametrize("case", ["kw_n8192_c0", "kw_n8192_c2"])
def test_k1_fixture_agrees_with_the_plain_version_in_distribution(case):
    """The parent K1's outputs and the plain version's on the same inputs
    (other noise): chi-square on the choice counts, two-sample KS on RT per
    choice, each p > P_MIN."""
    c = k1_fixture.CASES[case]
    kernel = k1_fixture.load()[case]
    plain = k1_fixture.run(ddm_rt_choice_cuda, c, torch.device("cpu")).numpy()  # CPU tensors: the plain version
    counts = np.array([[np.sum(x[:, 1] == k) for k in range(3)] for x in (kernel, plain)])
    seen = counts.sum(0) > 0
    chi2_p = stats.chi2_contingency(counts[:, seen])[1]
    ks_p = [stats.ks_2samp(kernel[kernel[:, 1] == k, 0], plain[plain[:, 1] == k, 0]).pvalue
            for k in (0, 1) if counts[:, k].min() > 0]
    assert len(ks_p) == 2
    assert min([chi2_p] + ks_p) > P_MIN, (counts.tolist(), chi2_p, ks_p)
