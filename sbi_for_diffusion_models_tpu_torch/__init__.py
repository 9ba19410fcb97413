"""PyTorch + CUDA port of ``sbi_for_diffusion_models_tpu``.

Each module is the counterpart of the JAX package's module of the same path,
with the same public names; the JAX package is the reference it is tested
against. The TPU kernels become hand-written CUDA kernels under ``csrc/``,
each beside its plain PyTorch version:

* K1, the pulse-DDM simulator: ``ops/ddm_cuda.py`` (plain: ``ops/ddm_scan.py``),
  counterpart of ``ops/ddm_pallas.py``;
* K2/K3, the fused MNLE log-prob forward and backward: ``ops/mnle_cuda.py``,
  counterpart of ``ops/mnle_pallas.py``;
* K2p/K3p, the same pair for the pulse-grid RT representation (absolute
  anchor), in ``ops/mnle_cuda.py`` as well;
* K4, the issue-ceiling microkernel: ``ops/ceiling_cuda.py``, counterpart of
  the kernel in ``benchmarks/roofline.py``, timed by ``roofline.py``.

Entry points run on the CUDA card unless given another ``device``
(``utils/device.py``); without a card they raise. The package imports
``torch`` and never ``jax``. Submodules are imported where they are used;
importing the package itself loads nothing else: the names in ``__all__``
(the entry points of ``mnle``, ``analysis`` and ``pipeline``) are imported
from their modules when first asked for.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "train_mnle": "mnle",
    "save_model": "mnle",
    "load_model": "mnle",
    "build_mnle": "mnle",
    "run_inference_mcmc": "mnle",
    "run_sbc": "mnle",
    "pairplot": "analysis",
    "sbc_uniformity_stats": "analysis",
    "build_prior_theta": "pipeline",
    "main": "pipeline",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
