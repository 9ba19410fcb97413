"""MCMC convergence diagnostics: effective sample size and split-R-hat.

Counterpart of ``sbi_for_diffusion_models_tpu/inference/diagnostics.py``:
the same host-side numpy code (plain split-R-hat and autocorrelation ESS
with Geyer's initial positive sequence, Vehtari et al. 2021). Tensors are
accepted and moved to the host first.
"""

from __future__ import annotations

import numpy as np

__all__ = ["effective_sample_size", "split_r_hat", "summarize_chains"]


def _as_numpy(chains) -> np.ndarray:
    if hasattr(chains, "detach"):
        chains = chains.detach().cpu().numpy()
    return np.asarray(chains, np.float64)


def _autocov(x: np.ndarray) -> np.ndarray:
    """Autocovariance per lag via FFT. x: (draws,). Returns (draws,)."""
    n = x.shape[0]
    xc = x - x.mean()
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(xc, m)
    acov = np.fft.irfft(f * np.conj(f), m)[:n].real / n
    return acov


def effective_sample_size(chains: np.ndarray) -> np.ndarray:
    """ESS per dimension. chains: (num_chains, draws, dim). Returns (dim,).

    Combined-chain ESS with Geyer's initial positive sequence truncation.
    """
    chains = _as_numpy(chains)
    C, N, D = chains.shape
    ess = np.empty(D)
    for d in range(D):
        acov = np.stack([_autocov(chains[c, :, d]) for c in range(C)])
        mean_acov = acov.mean(0)
        within = mean_acov[0] * N / (N - 1.0)
        between = chains[:, :, d].mean(1).var(ddof=1) if C > 1 else 0.0
        var_plus = within * (N - 1.0) / N + between
        if var_plus <= 0:
            ess[d] = C * N
            continue
        rho = 1.0 - (within - mean_acov) / var_plus
        # Geyer initial positive sequence: Gamma_k = rho_{2k} + rho_{2k+1}
        # (starting at rho_0 + rho_1), truncated at the first negative pair,
        # with the initial monotone correction Gamma'_k = min(Gamma'_{k-1},
        # Gamma_k) (Vehtari et al. 2021); tau = -1 + 2 sum_k Gamma'_k.
        tau = -1.0
        prev_pair = np.inf
        t = 0
        while t + 1 < N:
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            pair = min(pair, prev_pair)
            prev_pair = pair
            tau += 2.0 * pair
            t += 2
        ess[d] = C * N / max(tau, 1e-12)
    return ess


def split_r_hat(chains: np.ndarray) -> np.ndarray:
    """Split-R-hat per dimension. chains: (num_chains, draws, dim)."""
    chains = _as_numpy(chains)
    C, N, D = chains.shape
    half = N // 2
    split = np.concatenate(
        [chains[:, :half, :], chains[:, half : 2 * half, :]], axis=0
    )  # (2C, half, D)
    m, n = split.shape[0], split.shape[1]
    chain_means = split.mean(1)  # (2C, D)
    B = n * chain_means.var(0, ddof=1)
    W = split.var(1, ddof=1).mean(0)
    var_plus = (n - 1.0) / n * W + B / n
    return np.sqrt(var_plus / np.maximum(W, 1e-300))


def summarize_chains(chains: np.ndarray, verbose: bool = True) -> dict:
    """Per-dimension ESS + R-hat summary for (num_chains, draws, dim)."""
    ess = effective_sample_size(chains)
    rhat = split_r_hat(chains)
    out = {"ess": ess, "r_hat": rhat}
    if verbose:
        print(
            "[diagnostics] ESS="
            + np.array2string(ess, precision=0)
            + " R-hat="
            + np.array2string(rhat, precision=3)
        )
    return out
