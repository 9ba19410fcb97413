"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sbi_for_diffusion_models_tpu"}


def _top_levels(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert not _top_levels(path) & {"sbi_for_diffusion_models_tpu_torch", "port_bench"}


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import sbi_for_diffusion_models_tpu_torch.mnle\nfrom jax.numpy import zeros\n")
    assert _top_levels(f) & FORBIDDEN == {"jax"}
