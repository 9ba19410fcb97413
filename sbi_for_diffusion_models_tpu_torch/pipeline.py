"""Pipeline pieces (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/pipeline.py``. Only
``build_prior_theta`` is ported so far; ``main`` and the CLI follow once SBC
and ``analysis`` are ported (training is: ``mnle.train_mnle``).
"""

from __future__ import annotations

from .distributions import Beta, LogNormal, MultipleIndependent

__all__ = ["build_prior_theta", "THETA_LABELS"]

THETA_LABELS = ["a0", "lam", "v", "B", "tau"]


def build_prior_theta() -> MultipleIndependent:
    """Prior over theta = [a0, lam, v, B, tau]: Beta(2,2) a0; LogNormal(-1,1)
    lam; LogNormal(0,1) v; LogNormal(2.75,0.5) B; Beta(2,2) tau."""
    return MultipleIndependent(
        [
            Beta(2.0, 2.0),
            LogNormal(-1.0, 1.0),
            LogNormal(0.0, 1.0),
            LogNormal(2.75, 0.5),
            Beta(2.0, 2.0),
        ]
    )
