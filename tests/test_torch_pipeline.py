"""PyTorch port: the pipeline (``pipeline.main``, ``SMOKE_CONFIG``, the CLI).

``main`` end to end on the CPU at a tiny size (simulate -> train -> MCMC ->
SBC, every artifact and every ``metrics.jsonl`` stage), the CLI's configs
against the JAX package's, and ``main`` asking for the card by default.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu import pipeline as jpipeline
from sbi_for_diffusion_models_tpu import run_config as jrc
from sbi_for_diffusion_models_tpu_torch import pipeline as tpipeline


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many small tensor operations; with several threads
    each, the test workers running beside them make them many times slower.
    One thread is as fast alone and keeps its pace under load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_smoke_config_equals_the_jax_smoke_config_field_by_field():
    got, want = _fields(tpipeline.SMOKE_CONFIG), _fields(jpipeline.SMOKE_CONFIG)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    assert tpipeline.THETA_LABELS == jpipeline.THETA_LABELS


@pytest.mark.parametrize("argv,want", [
    (["--smoke"], jpipeline.SMOKE_CONFIG),
    ([], jrc.CALIBRATED_CONFIG),
    (["--preset", "calibrated"], jrc.CALIBRATED_CONFIG),
    (["--preset", "reference", "--seed", "7"], jrc.RUN_CONFIG_PARAMS),
    (["--smoke", "--preset", "reference"], jpipeline.SMOKE_CONFIG),
])
def test_cli_parses_to_the_jax_clis_configs(argv, want, monkeypatch):
    seen = []
    monkeypatch.setattr(tpipeline, "main", lambda cfg, *, seed: seen.append((cfg, seed)))
    tpipeline._cli(argv)
    (cfg, seed), = seen
    assert _fields(cfg) == _fields(want)
    assert seed == (7 if "--seed" in argv else 0)
    with pytest.raises(SystemExit):
        tpipeline._cli(["--preset", "other"])


def test_main_without_a_device_asks_for_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("OUTDIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.main(tpipeline.SMOKE_CONFIG)
    assert not (tmp_path / "out").exists()


def test_main_end_to_end_on_the_cpu(monkeypatch, tmp_path):
    """simulate -> train -> save -> MCMC -> SBC at a tiny size on the CPU:
    the JAX package's artifacts under its filenames in $OUTDIR, the model
    in $MODEL_DIR, the five stages in metrics.jsonl, and no kernel launch
    (CPU tensors take the plain versions)."""
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.ops._cuda import KERNELS

    out, models = tmp_path / "out", tmp_path / "models"
    monkeypatch.setenv("OUTDIR", str(out))
    monkeypatch.setenv("MODEL_DIR", str(models))
    cfg = tpipeline.SMOKE_CONFIG.replace(
        NUM_SIMULATIONS=300, TRAIN_BATCH_SIZE=100, TRAIN_MAX_EPOCHS=2, MNLE_HIDDEN_FEATURES=16,
        MNLE_NUM_TRANSFORMS=2, MNLE_NUM_BINS=5, NUM_TRIALS_OBS=5, NUM_CHAINS=2, WARMUP_STEPS=10,
        POSTERIOR_SAMPLES=20, MCMC_MAX_TREE_DEPTH=4, SBC_NUM_DATASETS=2, SBC_POST_SAMPLES=20,
    )
    before = {name: k.launches for name, k in KERNELS.items()}
    result = tpipeline.main(cfg, "cpu", seed=3)
    assert {name: k.launches for name, k in KERNELS.items()} == before

    samples = np.load(out / "posterior_samples_theta.npy")
    assert samples.shape == (20, 5) and np.isfinite(samples).all()
    np.testing.assert_array_equal(samples, result["posterior_samples"])
    for f in ("pairplot_theta.png", "sbc_thetas_true.npy", "sbc_ranks.npy", "sbc_samples.npy",
              "sbc_mixing_diagnostics.npz", "sbc_rank_histograms.png", "sbc_ecdf.png", "partial_summary.json",
              "sbc_ranks.partial.npy"):
        assert (out / f).exists(), f
    ranks = np.load(out / "sbc_ranks.npy")
    assert ranks.shape == (2, 5) and (ranks >= 0).all() and (ranks <= 20).all()
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert {r["stage"] for r in records} == {"simulate", "train", "mcmc", "sbc", "pipeline"}
    assert all(set(r) == {"ts", "stage", "name", "value"} and r["value"] > 0 for r in records)
    est = load_model(device="cpu")
    assert est.train_meta["num_train"] == 300 and est.cfg.hidden_features == 16
