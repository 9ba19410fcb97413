"""Kernel K1: the pulse-DDM simulator as a hand-written CUDA kernel.

Counterpart of ``sbi_for_diffusion_models_tpu/ops/ddm_pallas.py``
(``ddm_rt_choice_pallas``); the kernel is ``csrc/ddm_rt_choice.cu``.
``ddm_rt_choice_cuda`` launches it for CUDA tensors. For CPU tensors it runs
the plain version, ``ops/ddm_scan.ddm_rt_choice_scan``, which has the same
semantics but another random stream (as the Pallas kernel's hardware PRNG
differs from the scan kernel's), so the two agree exactly only without
noise and in distribution otherwise.

The launch shape, G lanes a trial and the number of blocks, is a function
of N and the card (``k1_launch_shape``): its SM count and resident blocks
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` of the kernel that
runs). No argument chooses it, and every shape gives the
same bits: a trial's noise depends only on (seed, trial index, step).
``K1_LAST_LAUNCH`` holds the N, G and blocks of the last launch. Each call
with trials adds one to the recorder's ``launch.k1`` (``utils.metrics``),
whichever route it takes.

``mu_sensory`` is one float for every trial, or an (N,) tensor, one noise
scale a trial (the 7-parameter model's sigma_a): the wrapper then passes
K1 that (N,) array and sqrt(dt) rounded to float32, and K1's per-trial
instances form each trial's sigma * sqrt(dt) in one float32 rounding, as
the plain version's product; with a float those are not run and the
scalar instances are unchanged.

``trial_offset`` is the index of the launch's first trial in a larger batch
(a rank's block of a sharded run, ``parallel.mesh.sharded_simulate``): K1
takes trial j's noise at index trial_offset + j, so blocks launched with
their offsets give the bits of one launch over the whole batch. The plain
version draws the whole batch's noise (``n_total`` trials) and keeps its
block's columns.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Union

import numpy as np
import torch

from ..constants import DT_CHOICE, T_MAX
from ..utils import metrics
from ..utils.rng import as_seed
from ._cuda import CudaKernel, check_cuda_tensor, stream_handle
from .ddm_scan import ddm_rt_choice_scan

__all__ = ["ddm_rt_choice_cuda", "k1_launch_shape", "k1_noise_mismatches", "K1", "K1_GROUP_SIZES", "K1_LANES_PER_SM",
           "K1_LAST_LAUNCH", "K1_THREADS", "K1_TRIALS_PER_GROUP"]

K1 = CudaKernel(
    "ddm_rt_choice",
    "ddm_rt_choice.cu",
    "sdm_ddm_rt_choice",
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 3
    + [ctypes.c_float] * 5
    + [ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint],
    flags=("--fmad=false",),
)
K1_THREADS = 128  # threads a block: csrc/ddm_rt_choice.cu's K1_THREADS
K1_GROUP_SIZES = (8, 2, 1)  # the kernel's instances: lanes that share a trial
# Lanes a launch puts on an SM: four blocks, four warps on each scheduler; and the trials a group may run in turn
# before fewer lanes share a trial. On the H100 (PERF.md) eight lanes a trial beat four at the main path's
# 4,096, two beat four at 131,072, and fewer lanes than trials, refilled, beat a lane for every trial, since the
# last trials' tail then costs less.
K1_LANES_PER_SM = 512
K1_TRIALS_PER_GROUP = 4
K1_LAST_LAUNCH = {"n": 0, "G": 0, "blocks": 0}  # the last launch's N and shape, as ddm_rt_choice_cuda launched it


def k1_launch_shape(n: int, steps_per_pulse: int, sm_count: int,
                    resident_blocks: Mapping[int, int]) -> tuple[int, int]:
    """(G, blocks) for a launch of ``n`` trials on a card of ``sm_count``
    SMs that holds ``resident_blocks[G]`` blocks of K1_THREADS an SM for
    the kernel of G lanes a trial.

    G is the largest of K1_GROUP_SIZES with G x n within K1_TRIALS_PER_GROUP
    x sm_count x K1_LANES_PER_SM lanes and 4 G <= ``steps_per_pulse`` (an
    iteration of 4 G steps holds at most one chunk start); else 1. The grid
    holds a group for every trial, but no more than K1_LANES_PER_SM lanes an
    SM, nor more blocks than are resident at once: past that, groups take
    further trials from the kernel's counter as theirs end."""
    if n < 1 or sm_count < 1:
        raise ValueError(f"n={n} and sm_count={sm_count} must be positive")
    lanes = sm_count * K1_LANES_PER_SM
    G = next(g for g in K1_GROUP_SIZES
             if g == 1 or (4 * g <= steps_per_pulse and g * n <= K1_TRIALS_PER_GROUP * lanes))
    per_sm = min(K1_LANES_PER_SM // K1_THREADS, max(int(resident_blocks[G]), 1))
    return G, min(-(-n * G // K1_THREADS), sm_count * per_sm)


def k1_noise_mismatches(device) -> int:
    """How many of K1's square roots and sines/cosines differ in their bits
    from sqrtf's and sincosf's, over all 2^24 values each Box-Muller input
    can take (K1 evaluates them without the CUDA math library's branches to
    inputs it never has); 0 means K1's noise has the math library's bits."""
    device = torch.device(device)
    fn = K1.library.load().sdm_ddm_noise_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mismatches = torch.empty((1,), dtype=torch.int32, device=device)
    err = fn(mismatches.data_ptr(), stream_handle(device))
    if err != 0:
        raise RuntimeError(f"ddm_rt_choice: noise check failed to launch: cudaError {err}")
    return int(mismatches.item())


_RESIDENT: dict[tuple, dict[int, int]] = {}


def _card_capacity(device: torch.device, collapse: bool, per_trial: bool = False) -> tuple[int, dict[int, int]]:
    """(SM count, {G: resident blocks an SM}) of the kernels that run for
    ``collapse`` and a per-trial noise scale (``per_trial``), asked of the
    card once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, collapse, per_trial)
    if key not in _RESIDENT:
        fn = K1.library.load().sdm_ddm_rt_choice_resident_blocks
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        blocks = {}
        with torch.cuda.device(index):
            for g in K1_GROUP_SIZES:
                b = ctypes.c_int(0)
                err = fn(g, int(collapse), int(per_trial), ctypes.byref(b))
                if err != 0:
                    raise RuntimeError(f"ddm_rt_choice: occupancy query failed for G={g}: cudaError {err}")
                blocks[g] = b.value
        _RESIDENT[key] = blocks
    return torch.cuda.get_device_properties(index).multi_processor_count, _RESIDENT[key]


def ddm_rt_choice_cuda(
    theta: torch.Tensor,
    pulse_sides: torch.Tensor,
    seed: int = 0,
    *,
    mu_sensory: Union[float, torch.Tensor] = 1.0,
    collapse_rate: float = 0.0,
    dt: float = float(DT_CHOICE),
    t_max: float = float(T_MAX),
    steps_per_pulse: int = 200,
    n_max: Optional[int] = None,
    trial_offset: int = 0,
    n_total: Optional[int] = None,
) -> torch.Tensor:
    """theta (N, 5), pulse_sides (N, P >= n_max/steps_per_pulse), mu_sensory
    a float or (N,) -> (N, 2) float32 [rt, choice], choice in {0, 1, 2}.

    ``trial_offset``: the index of trial 0 in a batch of ``n_total`` trials
    (default: this launch's N) of which these are a block; only the noise
    depends on it (K1 reads the offset; the plain version, ``n_total``)."""
    if n_max is None:
        n_max = int(t_max / dt)
    if n_max % steps_per_pulse != 0:
        raise ValueError(f"n_max={n_max} must be divisible by steps_per_pulse={steps_per_pulse}")
    if isinstance(mu_sensory, torch.Tensor) and (mu_sensory.shape != (theta.shape[0],)
                                                 or mu_sensory.device != theta.device):
        raise ValueError(f"a per-trial mu_sensory must be ({theta.shape[0]},) on {theta.device}, got "
                         f"{tuple(mu_sensory.shape)} on {mu_sensory.device}")
    trial_offset = int(trial_offset)
    if trial_offset < 0 or trial_offset + theta.shape[0] > 2**32:
        raise ValueError(f"trial_offset={trial_offset} with {theta.shape[0]} trials leaves K1's 32-bit trial counter")
    if metrics.RECORDING and theta.shape[0] > 0:
        metrics.count("launch.k1")
    if not theta.is_cuda:
        return ddm_rt_choice_scan(
            theta, pulse_sides, seed, mu_sensory=mu_sensory, collapse_rate=collapse_rate,
            dt=dt, t_max=t_max, steps_per_pulse=steps_per_pulse,
            chunk_steps=steps_per_pulse, n_max=n_max, trial_offset=trial_offset, n_total=n_total,
        )
    if steps_per_pulse % 4 != 0:
        raise ValueError(
            f"steps_per_pulse={steps_per_pulse} must be a multiple of 4 (one Philox "
            "call feeds four steps)"
        )
    n_chunks = n_max // steps_per_pulse
    N = theta.shape[0]
    if pulse_sides.dim() != 2 or pulse_sides.shape[1] < n_chunks:
        raise ValueError(
            f"pulse_sides must be (N, P >= {n_chunks}), got {tuple(pulse_sides.shape)}"
        )
    if pulse_sides.device != theta.device:
        raise ValueError("theta and pulse_sides must be on one device")
    # The kernel reads trial-minor layouts: (5, N) and (P, N).
    theta_t = theta.t().contiguous()
    s_t = pulse_sides[:, :n_chunks].t().contiguous()
    check_cuda_tensor("theta^T", theta_t, (5, N))
    check_cuda_tensor("pulse_sides^T", s_t, (n_chunks, N))
    mu_rows = None
    if isinstance(mu_sensory, torch.Tensor):
        mu_rows = mu_sensory.to(torch.float32).contiguous()
        check_cuda_tensor("mu_sensory", mu_rows, (N,))
    out = torch.empty((N, 2), dtype=torch.float32, device=theta.device)
    if N == 0:
        return out
    next_trial = torch.empty((1,), dtype=torch.int32, device=theta.device)  # the refill counter, zeroed by K1
    sm_count, resident = _card_capacity(theta.device, float(np.float32(collapse_rate)) != 0.0, mu_rows is not None)
    G, blocks = k1_launch_shape(N, steps_per_pulse, sm_count, resident)
    sqrt_dt = np.sqrt(np.float32(dt))
    sig = float(sqrt_dt if mu_rows is not None else np.float32(mu_sensory) * sqrt_dt)
    K1(
        theta_t.data_ptr(), s_t.data_ptr(), None if mu_rows is None else mu_rows.data_ptr(), out.data_ptr(),
        next_trial.data_ptr(),
        N, n_max, steps_per_pulse,
        float(dt), float(t_max), float(t_max) - 1e-6, sig, float(collapse_rate),
        as_seed(seed), G, blocks, stream_handle(theta.device), trial_offset,
    )
    K1_LAST_LAUNCH.update(n=N, G=G, blocks=blocks)
    return out
