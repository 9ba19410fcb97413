"""MCMC inference engines: many-chain NUTS, slice sampling, posterior wrapper."""

from .mcmc import MCMCPosterior
from .nuts import find_reasonable_step_size, nuts_step, run_nuts
from .slice import run_slice

__all__ = [
    "MCMCPosterior",
    "run_nuts",
    "nuts_step",
    "find_reasonable_step_size",
    "run_slice",
]
