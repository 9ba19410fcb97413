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
  anchor), in ``ops/mnle_cuda.py`` as well.

Entry points run on the CUDA card unless given another ``device``
(``utils/device.py``); without a card they raise. The package imports
``torch`` and never ``jax``. Submodules are imported where they are used;
importing the package itself loads nothing else.
"""

__version__ = "0.1.0"
