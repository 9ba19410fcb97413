"""The traffic generator: the same seed gives the same inputs, any seed up to
64 bits is taken, and the trials are valid."""

import torch

from port_bench import generator


def test_same_seed_same_inputs():
    big = 2**40 + 3
    a = generator.sessions(big, 2, 30, "cpu")
    b = generator.sessions(big, 2, 30, "cpu")
    c = generator.sessions(big + 1, 2, 30, "cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[1], c[1])


def test_trials_are_valid():
    z, x = generator.training_pairs(5, 4096, "cpu")
    assert z.shape == (4096, 85) and x.shape == (4096, 2)
    assert set(x[:, 1].unique().tolist()) <= {0.0, 1.0, 2.0}
    assert bool((x[:, 0] > z[:, 4]).all()) and bool((x[:, 0] <= 8.0).all())
    censored = x[:, 1] == 2
    assert bool((x[censored, 0] > 8.0 - generator.DT).all())  # t_nd + the whole window
    assert bool(((z[:, 5:] == 1) | (z[:, 5:] == -1)).all())
