"""Host-side analysis utilities: pairplot and SBC diagnostics (PyTorch port).

Counterpart of ``sbi_for_diffusion_models_tpu/analysis.py``, copied rather
than imported (the port imports nothing of the JAX package): numpy, scipy
and matplotlib only. Where matplotlib does not import, the plot functions
print one line naming the missing package and the file not written, and
return None; the statistics need scipy alone.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["pairplot", "sbc_uniformity_stats", "sbc_ecdf_plot"]


def _pyplot(path, caller: str):
    """``matplotlib.pyplot`` on the Agg backend, or None (after one line
    saying that ``path`` is not written) when matplotlib does not import."""
    try:
        import matplotlib
    except ImportError:
        print(f"[{caller}] matplotlib is not installed: {path} not written")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def pairplot(
    samples,
    points=None,
    labels: Optional[Sequence[str]] = None,
    limits=None,
    figsize=(10, 10),
    save_path: str | Path | None = None,
):
    """Corner plot: marginal histograms on the diagonal, 2-D histograms below.

    ``points`` (e.g. theta_true) are overlaid as red markers/lines, matching
    the reference usage ``pairplot(samples, points=theta_true, ...)``.
    Returns (fig, axes), or None without matplotlib.
    """
    plt = _pyplot(save_path, "pairplot")
    if plt is None:
        return None

    samples = np.asarray(samples)
    d = samples.shape[1]
    if labels is None:
        labels = [f"theta_{i}" for i in range(d)]
    if points is not None:
        points = np.asarray(points).reshape(-1)

    fig, axes = plt.subplots(d, d, figsize=figsize)
    for i in range(d):
        for j in range(d):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(samples[:, i], bins=50, color="#4477aa", density=True)
                if points is not None:
                    ax.axvline(points[i], color="crimson", lw=1.5)
            else:
                ax.hist2d(samples[:, j], samples[:, i], bins=50, cmap="Blues")
                if points is not None:
                    ax.plot(points[j], points[i], "x", color="crimson", ms=8, mew=2)
            if i == d - 1:
                ax.set_xlabel(labels[j])
            if j == 0:
                ax.set_ylabel(labels[i])
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
        print(f"[pairplot] wrote {save_path}")
    return fig, axes


def sbc_uniformity_stats(ranks: np.ndarray, num_posterior_samples: int) -> dict:
    """Chi-square and KS uniformity statistics per parameter dimension.

    Under a calibrated posterior, ranks are uniform on {0..S}. Returns
    per-dim p-values; low p-values indicate miscalibration (with few SBC
    datasets the test is weak: a smoke alarm, not a certificate).
    """
    from scipy import stats as sps

    ranks = np.asarray(ranks, np.float64)
    n, d = ranks.shape
    out = {"ks_pvalues": [], "chi2_pvalues": []}
    n_bins = min(10, max(n // 2, 2))
    for i in range(d):
        u = (ranks[:, i] + 0.5) / (num_posterior_samples + 1)
        ks = sps.kstest(u, "uniform")
        hist, _ = np.histogram(ranks[:, i], bins=n_bins, range=(0, num_posterior_samples))
        chi2 = sps.chisquare(hist)
        out["ks_pvalues"].append(float(ks.pvalue))
        out["chi2_pvalues"].append(float(chi2.pvalue))
    return out


def _ecdf_band(n: int, alpha: float = 0.05, n_grid: int = 101, n_sim: int = 2000,
               seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Simultaneous (1 - alpha) confidence band for the ECDF-difference of n
    uniform draws, via Monte Carlo over the supremum statistic (the standard
    SBC ECDF-band construction; more powerful at the tails than pointwise
    binomial bands)."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(0.0, 1.0, n_grid)
    sups = np.empty(n_sim)
    for s in range(n_sim):
        u = np.sort(rng.uniform(size=n))
        ecdf = np.searchsorted(u, grid, side="right") / n
        sups[s] = np.abs(ecdf - grid).max()
    q = np.quantile(sups, 1.0 - alpha)
    return grid, grid - q, grid + q


def sbc_ecdf_plot(
    ranks: np.ndarray,
    num_posterior_samples: int,
    outpath: str | Path,
    param_names: Optional[Sequence[str]] = None,
    alpha: float = 0.05,
):
    """ECDF-difference plot with a simultaneous confidence band, the
    standard high-power SBC visual (rank histograms hide small systematic
    bias that this makes visible as a sustained band excursion).

    Plots ECDF(u) - u per parameter for u = (rank + 0.5) / (S + 1), with a
    Monte-Carlo simultaneous (1 - alpha) band under exact uniformity.
    Returns the path written, or None without matplotlib.
    """
    outpath = Path(outpath)
    plt = _pyplot(outpath, "sbc_ecdf_plot")
    if plt is None:
        return None

    ranks = np.asarray(ranks, np.float64)
    n, d = ranks.shape
    if param_names is None:
        param_names = [f"theta_{i}" for i in range(d)]
    grid, lo, hi = _ecdf_band(n, alpha=alpha)

    fig, axes = plt.subplots(1, d, figsize=(3 * d, 3), sharey=True)
    if d == 1:
        axes = [axes]
    for i, ax in enumerate(axes):
        u = np.sort((ranks[:, i] + 0.5) / (num_posterior_samples + 1))
        ecdf = np.searchsorted(u, grid, side="right") / n
        ax.fill_between(grid, lo - grid, hi - grid, color="#cccccc", alpha=0.7,
                        label=f"{int((1-alpha)*100)}% simultaneous band")
        ax.plot(grid, ecdf - grid, color="#4477aa", lw=1.5)
        ax.axhline(0.0, color="k", lw=0.5)
        ax.set_title(param_names[i])
        ax.set_xlabel("u")
        if i == 0:
            ax.set_ylabel("ECDF(u) - u")
    fig.tight_layout()
    fig.savefig(outpath, dpi=120)
    plt.close(fig)
    print(f"[sbc_ecdf_plot] wrote {outpath}")
    return outpath
