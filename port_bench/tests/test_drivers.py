"""Each traffic mix's kind has its driver file, and the training cell's
batch check finds rows that are not the benchmark's pairs."""

from pathlib import Path

import pytest
import torch

from port_bench import compare, drivers, generator, run

MIXES = sorted(p.stem for p in (run.HERE / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_every_kind_has_a_driver(mix):
    module = drivers.load(generator.load_mix(mix)["kind"])
    assert Path(module.__file__).parent == run.HERE / "drivers"
    assert callable(module.run) and callable(module.numbers) and callable(module.control)
    assert module.FAULTS


def test_foreign_rows():
    z, x = generator.training_pairs(3, 512, "cpu")
    perm = torch.randperm(512, generator=torch.Generator().manual_seed(0))
    batches = [(x[perm[i:i + 128]], z[perm[i:i + 128]]) for i in (0, 128, 256)]
    assert compare.foreign_rows(z, x, batches) == 0
    xb = batches[1][0].clone()
    xb[5, 0] += 1e-3  # a row that is no pair
    assert compare.foreign_rows(z, x, [batches[0], (xb, batches[1][1]), batches[2]]) == 1
    assert compare.foreign_rows(z, x, [batches[0], batches[0], batches[2]]) == 128  # a batch drawn twice
