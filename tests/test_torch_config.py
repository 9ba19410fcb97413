"""PyTorch port: configuration parity, seed helpers and the no-JAX import rule."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu import constants as jconst
from sbi_for_diffusion_models_tpu import run_config as jrc
from sbi_for_diffusion_models_tpu_torch import constants as tconst
from sbi_for_diffusion_models_tpu_torch import run_config as trc
from sbi_for_diffusion_models_tpu_torch.utils.rng import as_seed, child_seed, make_generator

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["RUN_CONFIG_PARAMS", "CALIBRATED_CONFIG"])
def test_run_config_matches_field_for_field(name):
    j, t = getattr(jrc, name), getattr(trc, name)
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    assert jf == tf
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert t.replace(NUM_CHAINS=7).NUM_CHAINS == 7 and t.NUM_CHAINS == j.NUM_CHAINS


def test_constants_match():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


def test_package_imports_no_jax():
    """Importing every module of the port leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sbi_for_diffusion_models_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib', 'flax')))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_child_seed_is_deterministic_and_order_sensitive():
    assert child_seed(3, 1, 2) == child_seed(3, 1, 2)
    assert child_seed(3, 1, 2) != child_seed(3, 2, 1)
    assert child_seed(3, 1) != child_seed(4, 1)
    assert 0 <= child_seed(2**62, 7) < 2**63
    assert as_seed(np.random.default_rng(0)) == as_seed(np.random.default_rng(0))
    a = torch.rand(4, generator=make_generator(child_seed(5, 0)))
    b = torch.rand(4, generator=make_generator(child_seed(5, 0)))
    assert torch.equal(a, b)
    with pytest.raises(TypeError):
        as_seed("seed")
