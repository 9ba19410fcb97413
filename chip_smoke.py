#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

Builds the port's CUDA kernels from ``sbi_for_diffusion_models_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's paths once each through their public entry points:

1. build K1 (pulse-DDM simulator), K2/K3 (fused MNLE log-prob forward and
   backward), K2p/K3p (the same for the pulse-grid RT representation) and
   K4 (the issue-ceiling microkernel) with nvcc for sm_90a, one nvcc per
   source, side by side;
2. K1 against its plain version at N = 131,072 prior draws and at the
   main path's 4,096 (each launched at its own shape): equal outputs
   without noise; with noise a two-sample KS test on RT per choice and a
   chi-square test on the choice counts (p > 1e-3); the same seed twice
   gives the same output; then against the parent K1's committed outputs
   (``tests/k1_fixture.py``) bit for bit on every case, from N = 1 to
   300,000 trials, where groups refill;
3. K2/K3 against their plain version on the committed flagship model
   (``artifacts/models/mnle_10m_shifted_logt_affine.npz``) at 1,200 rows
   (4 chains x 6 replicas x 50 trials) and 115,200 rows (96 such sessions,
   all of the calibrated preset's SBC datasets in one launch; the SBC fold
   launches 9,600, phase 10):
   each row's value to 1e-4 x max(1, |ref|) and its gradients to 1e-3 x
   max(1, the row's largest |ref|) against the plain version in float64,
   with an allowance on rows where float32 cannot resolve the function and
   a limit on the share of rows over their allowance (see ``phase_k2k3``);
   the value K3 writes beside its gradients is held the same way and must
   equal K2's bit for bit on every row;
4. K2p/K3p against their plain version on the committed pulse-grid model
   (``artifacts/models/mnle_1m_pulseabs.npz``, absolute anchor) at the same
   two sizes, held the same way (K2p's and K3p's values, bit-equal, dphi,
   dctx and dkf);
5. K4, both kinds, at chains of 64 and 1,024 steps against its plain version
   in float64 (``phase_k4``), then the roofline path: the entry point
   ``roofline.main`` times K4 at its full shape (2,097,152 elements, chains
   of 2^14 and 2^17) and gives the card's two achievable issue ceilings,
   which must not exceed 105 % of the datasheet's FMA rate, then K1's and
   K2's demand against them. K4, K1 and K2 must have launched. Then each
   is held at the shape that path gave it: K4 at 2,097,152 elements and both
   chain lengths against float64 and its plain version, K1 at 524,288 trials
   and K2/K3 at 65,536 rows on that path's model against theirs;
5b. the NUTS leaf kernel (``ops/nuts_cuda.LeafKernel``, ``nuts_leaf``)
   against the plain leaf (``inference/nuts._leaf_plain``) on the same
   inputs and uniforms at the serving cells' 24 chains and the SBC fold's
   2,304 (96 datasets x 4 chains x 6 rungs), D = 5, and at 24 chains of the
   hierarchical sampler's D = 330 (64 subjects): every leaf of subtrees
   of depth 0 to LEAF_DEPTH, on a Gaussian potential with a NaN, a -inf and
   a divergent log-density on a few chains; counts, booleans and the live
   flag exact, floats within LEAF_ULPS ulps. Then its device time a launch
   and the plain leaf's (``torch.profiler``), each side's host time a leaf,
   and its bound, over LEAF_TIMED leaves on which every chain stays live.
   Every path below that runs NUTS on the card (phases 6, 9 to 15 and 17
   to 19) must also have launched ``nuts_leaf``;
5c. the u-space density's kernel pair (``ops/density_cuda.UDensity``,
   ``density_pre`` and ``density_post``) against the plain composition
   (``potentials._tempered_vg_plain``) on the flagship's prior at the
   serving cells' 24 chains and the SBC fold's 2,304, D = 5: value,
   gradient and the theta the potential gets, bit for bit, with and without
   the gradient, on normal draws and u at infinities and NaN. Then each
   side's device time a call (``torch.profiler``), host time a call and
   device operations a call over DENSITY_TIMED calls around a potential
   that launches nothing, and the pair's bound. Every path that takes the
   closed-form density (phases 6 to 15 and 19: the flagship, pulse-grid,
   slice, training, SBC, CLI, resume, sharp, ensemble, embed and
   multi-device paths) must launch both; the hierarchical path (phase 17),
   which has a density of its own, neither;
6. the flagship path: simulate 131,072 training pairs, an observed 50-trial
   session, load the flagship model and sample its posterior with the
   calibrated sampler (PT6 NUTS, grid hop, t_nd slice; warmup and draws cut
   to SERVE_WARMUP and SERVE_DRAWS). K1, K2 and K3 must have launched during this phase, and
   K2 less than 5 % as often as K3 (a gradient call launches K3 alone; K2
   serves the value-only calls of the grid hop and the t_nd slice);
7. the pulse path: the same observed session, the pulse-grid model loaded
   and sampled by the same sampler, warmup SERVE_WARMUP and PULSE_DRAWS draws. K2p and K3p must have
   launched during this phase, K2p less than 5 % as often as K3p;
8. the slice path: the same observed session and the flagship model
   sampled by the slice sampler (``MCMC_METHOD="slice"``, no extra moves,
   no tempering, which is NUTS-only; 24 chains, so each density call has
   the 1,200 rows of the PT6 x 4 flagship path; warmup and draws cut to
   SLICE_WARMUP and SLICE_DRAWS). K2 must have
   launched and K3 must not (the slice sampler evaluates no gradient);
9. the training path, at the flagship's full width on the pairs of phase 6:
   ``train_mnle`` under ``CALIBRATED_CONFIG`` with the cond-affine head
   (only the epochs are cut, to TRAIN_EPOCHS), ``save_model`` into a
   temporary directory, ``load_model`` back (weights bit-equal, the same
   fingerprint), and ``run_inference_mcmc`` with the loaded model on the
   observed session (warmup and draws cut to TRAIN_SERVE_WARMUP and
   TRAIN_SERVE_DRAWS). The validation loss must be
   finite at every epoch and end at least TRAIN_MIN_DROP below the first
   epoch's; K2 and K3 must have launched, K2 less than 5 % as often as K3.
   Then K2/K3 on the trained model
   against their plain version at 1,200 and 115,200 rows, held as in
   phase 3, and one more epoch under ``torch.profiler`` for the card's busy
   share of an optimizer step. It trains with ``checkpoint_dir`` every
   TRAIN_CHECKPOINT_EVERY epochs: the newest checkpoint must be the last
   epoch's, and the same call again must run no epoch and return the saved
   weights bit for bit;
10. the SBC path: ``run_sbc`` on the flagship under ``CALIBRATED_CONFIG``
   with 8 datasets (one group of the fold: 9,600 rows a potential call),
   warmup SBC_WARMUP, SBC_DRAWS draws (10 a chain: the mixing gate is active), one
   remediation round of up to 8 datasets. K1 must have launched, K3 at
   9,600 rows on every call, K2 less than 5 % as often as K3; every
   artifact written (the plots where matplotlib imports), ranks in [0, SBC_DRAWS].
   Then K2/K3 on the rows of the fold's first gradient call against their
   plain version and float64 (as in phase 3, and timed there), and that
   call's values and gradients against one single-session
   ``log_lik_and_grad`` call per dataset (equal bits expected; the ulps
   that differ are printed); a window of 300 potential calls of a shorter
   ``run_sbc`` under ``torch.profiler`` gives the card's busy share of a call.
   The run's ``nuts_ckpt/run_id.txt`` and group 0's segment checkpoint,
   finished, must be in its ``outdir``;
11. the CLI's smoke path, ``pipeline._cli(["--smoke"])`` in this process
   (simulate -> train -> save -> MCMC -> SBC at ``SMOKE_CONFIG``), into a
   temporary ``OUTDIR`` and ``MODEL_DIR``: the posterior samples, the SBC
   artifacts and the five ``metrics.jsonl`` stages must exist, and K1 and
   K3 must have launched (every potential call of that config wants a
   gradient, so K2 launches only if NUTS falls back to slice). Then K2/K3 on
   the model ``--smoke`` trained (log rep, no censoring, no cond-affine
   head, 64 hidden, 4 transforms), held as in phase 3 on the rows of the
   path's first K3 call at each row count and at 1,200 rows of prior-draw
   sessions;
12. the resume path (run after the slice path): the flagship sampler of
   phase 6 (``run_inference_mcmc``, PT6 x 4 chains, 1,200 rows a K3 call)
   at warmup RESUME_WARMUP / RESUME_DRAWS draws a chain in segments of
   RESUME_SEGMENT transitions, trees capped at depth RESUME_TREE_DEPTH: a
   reference run; the same run with
   ``checkpoint_dir`` in a child process (``chip_smoke.py --resume-child
   DIR``), killed with SIGKILL once its checkpoint reaches segment
   RESUME_CUT_AT; then the same call here, which resumes from it with
   ``device_retries=1`` and one ``torch.AcceleratorError`` raised by the
   potential (not a real device loss) in the first segment it runs, which
   it replays from the host mirror. Draws, accept probabilities, tree
   sizes, divergences, step sizes and mass matrices must equal the
   reference run's bit for bit; K2 and K3 must have launched;
13. the tail-sharp path (after the CLI path): the committed
   ``mnle_10m_shifted_logt_sharp.npz`` (shifted-log RT, k = 1.5) samples the
   observed session under ``CALIBRATED_CONFIG`` at warmup NEW_WARMUP /
   NEW_DRAWS draws a chain, trees capped at NEW_TREE_DEPTH (K2 and K3
   launched; at this depth the value-only calls of the grid hop and the
   t_nd slice are a large share of the calls, as on the resume path); then K2/K3 on its rows at 1,200 and 9,600
   against float64 (as in phase 3), one closed-form ``log_lik_and_grad``
   against autograd of ``log_lik_fn``, ``sample`` (SAMPLE_CARD draws on the
   card against SAMPLE_CPU of the plain path on the CPU at the same 64
   conditions: chi-square on the choices, two-sample KS on the RTs, p >=
   P_MIN) and ``tail_sharp_inverse``'s round trip on the card's draws;
14. the ensemble path: ``load_ensemble`` of ENSEMBLE_FILES (three committed
   full-width models of one config) samples the observed session at the same
   cut; every potential call launches one kernel per member (K3 three times
   a gradient call, K2 three times a value-only call, counted against the
   calls); then the mixture's rows at 1,200 against the float64
   log-mean-exp of the members' float64 rows, the closed-form gradient
   against autograd, and ``sample`` against the CPU's plain path;
15. the embedding path: ``train_mnle`` under ``CALIBRATED_CONFIG`` with
   MNLE_EMBED_DIM = EMBED_DIM in "append" mode (context width 123) for
   EMBED_EPOCHS epochs on the pairs of phase 6, ``save_model`` /
   ``load_model`` bit for bit, the observed session sampled at the same cut,
   and one value-only call of a "replace"-mode network (context width 43)
   built by ``train_mnle`` from the same proposal; then K2/K3 at width 123
   against float64 at 1,200 and 9,600 rows, the replace-mode call against
   the plain path, and the closed-form gradient against autograd. The
   flagship and pulse-grid paths (phases 6 and 7) also hold their models'
   ``sample`` against the CPU's plain path (the pulse model: the slot head
   and the circular splines' inverse);
16. the variants path: ``ddm_choice_scan`` at the SNPE example's shape, as
   the example calls it (20,000 thetas x 8 trials at n_max 4,000, t_max 2
   s; one pass, then two resample passes, each timed with its share of -1),
   ``choice_model_simulator_torch`` on the same trials at its default grid
   the same two ways, and ``simulate_session_data_7p`` for one session of 1,200 trials (K1's
   per-trial noise-scale instances); K1 must have launched. Then K1's
   per-trial noise scale against the plain scan at 4,096 trials on a
   1,600-step window: bit for bit at sigma = 0, with noise by chi-square
   and KS (p > P_MIN), and at sigma_i all 1 equal to the scalar launch's
   bits; and at 131,072 trials (groups refill) with each trial's sigma
   drawn from SIGMA_LEVELS, each row equal to the scalar launch at its own
   level and the rows at 0 to the plain scan (the K1 fixture of phase 2
   holds the scalar instances);
17. the hierarchical path at the coverage configuration
   (``artifacts/hierarchical_coverage_pt_a.json``: ``mnle_1m_censor.npz``,
   4 datasets x 4 subjects x 20 trials, 4 chains x 6 rungs in one sampler
   launch): ``simulate_hierarchical_sessions`` and
   ``run_hierarchical_inference`` at warmup HIER_WARMUP / HIER_DRAWS draws
   a chain, trees capped at HIER_TREE_DEPTH; every K3 launch at the fold's
   7,680 rows. Then K2/K3 on the rows of its first K3 call against float64
   (as in phase 3, and timed there), and the fold's first value-and-gradient
   call against autograd through the plain row function;
18. the SNPE path at the example's shape: the BoxUniform prior, 20,000
   thetas, x the mean choice of 8 choice-only trials (K1), ``train_snpe``
   and ``train_snle`` (epochs capped at SNPE_EPOCHS), 2,000
   ``DirectPosterior`` draws all inside the prior's support, and a short
   ``make_posterior(x_o)`` NUTS run (4 chains, warmup SNPE_WARMUP,
   SNPE_CHAIN_DRAWS draws a chain, depth <= 6); it prints the training ms
   a step;
19. the multi-device path (``phase_multidevice``): the SBC fold of phase 10
   cut to warmup MD_WARMUP / MD_DRAWS draws, depth MD_TREE_DEPTH, and the
   hierarchical fold of phase 17, run unsharded; then (a) an NCCL world of
   one rank in this process (a ``FileStore`` in a temporary directory):
   ``dryrun_multichip(1)`` and the two folds through ``run_sbc(mesh=...)``
   and ``run_hierarchical_inference(mesh=...)``, whose draws must equal the
   unsharded calls' bit for bit, and K1's trial offset
   (``phase_k1_offset``: N_SIM trials in blocks, each launched from its
   offset, against one launch, 0 rows may differ; the fixture at offset
   0); (b) MD_RANKS ranks started with a deadline, one a card over NCCL on
   a host with MD_RANKS cards, else sharing the card over gloo: K1 at N_SIM
   trials in one block a rank (0 rows may differ from one launch), the SBC
   fold at 2,400 rows a rank and the hierarchical fold against the
   unsharded calls (printed: bit for bit, or the largest difference and the
   first transition that differs), and ``dryrun_multichip(MD_RANKS)`` with
   the 2 x 2 TP step. K1, K2 and K3 must have launched on the sharded
   paths; each rank's launches and ms a call are printed. One card shows
   NCCL's communicator and the sharded code paths, not scaling over
   several GPUs.

Each kernel's bound is the larger of its FP32 operations over 67 TFLOP/s
and its bytes (inputs read once, outputs written once) over 3.35 TB/s, the
H100 SXM's published rates, counted from this run's shapes (K1: from the
steps its trials executed; K4: its chained FMAs). No single PyTorch call
computes any of these kernels, so ``library_ms`` is null.

Run from the root of a checkout: ``python3 chip_smoke.py`` (one CUDA card,
``nvcc`` under /usr/local/cuda or on PATH). The last line of its output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with
their launches, errors, times and bounds at both sizes (K4: both chain
lengths; the NUTS leaf kernel at 24 and 2,304 chains, its device time a
leaf against the plain leaf's, with the worst ulps; the u-space density's
pair at the same two chain counts, its device time a call against the plain
composition's), K1 also with its launch shape, the four fused kernels' with their
tile height, K2's and K3's also at the SBC fold's 9,600 rows (``fold``), on
the CLI path's model (``pipeline``), on the tail-sharp model (``sharp``) and
on the embedded model at context width 123 (``embed``) and at the
hierarchical fold's 7,680 rows (``hierarchical``), K1 also with its
per-trial noise-scale launch (``per_trial_sigma``),
each kernel's launches on every path (``launches_by_path``; ``multidevice``
summed over the ranks), and each with
ptxas's registers, stack and spills (K1: of each of its twelve instances); a
spill fails the run. Any failed check
raises, and the script exits non-zero without that line. There is no CPU fallback: without
a CUDA card the script exits with status 2.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "sbi_for_diffusion_models_tpu_torch"
MODEL_FILE = "mnle_10m_shifted_logt_affine.npz"
PULSE_MODEL_FILE = "mnle_1m_pulseabs.npz"
MODEL_DIR = ROOT / "artifacts" / "models"  # the committed models
FP32_OPS_PER_S = 67e12  # H100 SXM, FP32 outside the tensor cores (an FMA counts 2)
MAX_CEILING_SHARE = 1.05  # a measured ceiling above this share of the datasheet's FMA rate is a fault
HBM_BYTES_PER_S = 3.35e12

N_SIM = 131_072  # K1 check size and the main path's training-set size
ROWS_MAIN = 1_200  # 4 chains x 6 replicas x 50 trials
ROWS_SBC = 115_200  # 96 sessions of the above: all of the calibrated preset's SBC datasets in one launch
ROWS_FOLD = 9_600  # one launch of the SBC fold: 8 datasets (run_sbc's group_size) x 4 chains x 6 replicas x 50 trials
P_MIN = 1e-3  # K1 distribution tests
TRAIN_EPOCHS = 10  # the training path's cut of TRAIN_MAX_EPOCHS (and of the patience)
TRAIN_MIN_DROP = 0.5  # nats the last validation loss must lie below the first epoch's
TRAIN_CHECKPOINT_EVERY = 5  # the training path's checkpoint interval, in epochs
K4_SHAPE = (64, 256, 128)  # the roofline path's K4 input: 2,097,152 float32 elements
SLICE_WARMUP, SLICE_DRAWS = 20, 240  # the slice path's cut (24 chains: 10 draws each)
# The serving and training paths' cut: the whole script took 767.1 s on the H100 at warmup 50 / draws 100 on a
# host at 3.6 ms a batched call, and 374.4 to 452.5 s at 30 / 60 on hosts at 2.2 to 2.7 ms. The SBC phase (121,844
# calls) and the CLI's smoke path take about 480 s more at 2.4 to 3.2 ms: 780.3 s in all with both serving paths at
# 20 / 40 and the training path's sampler at 20 / 20. With the resume phase at warmup 10 / 20 draws a chain (150.0 s)
# the whole took 990.7 s on a host at 3.260 ms an SBC call; with its draws and the pulse path's cut, 1105.4 s on a
# host at 3.581. So the resume phase's trees are capped at depth 6 (it tests exactness, not mixing), the SBC phase's
# warmup is 20 and the training path's sampler's 10: 635.6 s (PR 10). With the sharp, ensemble and embedding paths
# the whole took 1164.1 s on a host at 5.362 ms an SBC call (SBC 488.3 s, flagship 108.5 s, pulse 93.5 s; PR 11), so
# the new paths' draws went to 10 a chain, then the SBC phase to warmup 10 / 40 draws (10 a chain: the mixing gate
# stays active) and the two serving paths' warmup to 10: about 840 s predicted on that host. Draws are a multiple of
# the 4 chains (``_sample_posterior`` splits them back into chains).
SERVE_WARMUP, SERVE_DRAWS = 10, 40
PULSE_DRAWS = 20  # the pulse path's draws (its warmup is SERVE_WARMUP)
TRAIN_SERVE_WARMUP, TRAIN_SERVE_DRAWS = 10, 20
# The SBC phase's warmup went from 10 to 5 when the whole script took 919.8 s on an H100 host at 4.483 ms an SBC
# call (SBC 217.6 s; the remediation round's warmup is 2 x SBC_WARMUP): a cut of depth that keeps the mixing gate
# (10 draws a chain) and the remediation round.
SBC_WARMUP, SBC_DRAWS = 5, 40
RESUME_WARMUP, RESUME_DRAWS, RESUME_SEGMENT = 10, 20, 5  # 30 transitions, 6 segments; draws a chain
RESUME_TREE_DEPTH = 6  # the resume phase's cap on NUTS tree depth (CALIBRATED_CONFIG's is 10)
RESUME_CUT_AT = 3  # the cut child is killed once its checkpoint's next_segment reaches this
RESUME_FAULT_CALL = 10  # the resumed run's potential call that raises the injected device error
SHARP_MODEL_FILE = "mnle_10m_shifted_logt_sharp.npz"  # the committed tail-sharp model (k = 1.5)
ENSEMBLE_FILES = ("mnle_10m.npz", "mnle_calibration.npz", "mnle_large_budget.npz")  # three models of one config
EMBED_DIM, EMBED_EPOCHS = 32, 2  # the embedding path's MNLE_EMBED_DIM ("append": context 85 + 32 + 6 = 123) and epochs
# The sharp, ensemble and embedding paths' sampler: the resume phase's cut (warmup 10, 20 draws a chain, trees capped
# at depth 6), 5.554 s for 2,644 calls on the flagship (PR 10). Predicted before their first run: sharp 15-25 s,
# ensemble 20-35 s (three K3 launches and three sets of outer terms a call), embed 15-25 s (56 training steps at
# about 40 ms and the sampler); under 90 s in all. Past 850 s for the whole script, their draws go to 10 first (PR 11,
# above): 10 draws a chain.
NEW_WARMUP, NEW_DRAWS, NEW_TREE_DEPTH = 10, 10, 6
SAMPLE_CARD, SAMPLE_CPU = 131_072, 8_192  # ``sample`` draws on the card and on the CPU's plain path, at 64 conditions
# The variants, hierarchical and SNPE paths. The SNPE example's shape (examples/snpe_snle_choice_model.py): 20,000
# thetas from its BoxUniform prior, x the mean choice of 8 trials of the choice-only model at n_max 4,000 and t_max
# 2 s with two resample passes.
VARIANT_K1_N = 4_096  # K1's per-trial noise scale against the plain scan, on a 1,600-step window
SIGMA_LEVELS = (0.0, 0.5, 1.0, 2.0)  # each trial's sigma drawn from these: its rows have that scalar launch's bits
VARIANT_THETAS, VARIANT_REPS, VARIANT_7P_TRIALS = 20_000, 8, 1_200
CHOICE_GRID = {"t_max": 2.0, "n_max": 4_000, "steps_per_pulse": 200, "chunk_steps": 200}
SNPE_LO, SNPE_HI = (0.1, 0.05, 0.2, 2.0, 0.0), (0.9, 1.0, 3.0, 20.0, 0.5)
SNPE_THETAS, SNPE_DRAWS = 20_000, 2_000
SNPE_EPOCHS = 30  # the example's 60 epochs, cut for time (patience 12, as there)
SNPE_WARMUP, SNPE_CHAIN_DRAWS = 20, 20  # the SNLE posterior's NUTS run: 4 chains, trees capped at depth 6
# The hierarchical coverage configuration (artifacts/hierarchical_coverage_pt_a.json: warmup 250, 300 draws a
# chain, depth 8), cut for time.
HIER_WARMUP, HIER_DRAWS, HIER_TREE_DEPTH = 10, 10, 6
# The multi-device phase: a world of one rank under NCCL in this process, then MD_RANKS ranks, one a card over NCCL
# where the host has MD_RANKS cards, else sharing the card over gloo. Its SBC fold is the SBC phase's (8 datasets,
# 9,600 rows a K3 launch; 2,400 a rank) cut to warmup MD_WARMUP, MD_DRAWS draws (5 a chain: the mixing gate is off,
# so no remediation), trees capped at MD_TREE_DEPTH; its hierarchical fold is the hierarchical phase's. Predicted
# before its first run (PERF.md): 40-70 s, most of it starting the ranks, each of which loads the built kernels.
MD_RANKS = 4
MD_WARMUP, MD_DRAWS, MD_TREE_DEPTH = 5, 20, 6
MD_DEADLINE_S = 420.0  # the ranks' deadline; their collectives time out at the same limit
# The leaf kernel's check: the serving cells' chains (4 chains x 6 rungs) and the SBC fold's at the calibrated preset
# (96 datasets of them), D = 5, then the serving chains at the hierarchical sampler's D = 330 (64 subjects: PyTorch
# sums that D with four-wide loads); every leaf of subtrees up to CALIBRATED_CONFIG's MCMC_MAX_TREE_DEPTH.
LEAF_SHAPES = ((24, 5), (2_304, 5), (24, 330))
LEAF_DEPTH = 10
LEAF_ULPS = 4  # the kernel's floats against the plain leaf's, as tests/test_torch_cuda_nuts.py holds them
LEAF_TIMED = 1_024  # leaves timed a side: one cycle of a depth-10 subtree's checkpoint slots
# The NUTS paths: each must launch the leaf kernel besides its own kernels.
NUTS = ("nuts_leaf",)
# The u-space density's kernel pair: every path that takes the closed-form density launches both.
DENSITY = ("density_pre", "density_post")
DENSITY_CHAINS = (24, 2_304)  # the serving cells' chains, the SBC fold's at the calibrated preset
DENSITY_TIMED = 512  # calls timed a side


def _log(*args) -> None:
    print(*args, flush=True)


def _time_ms(fn, reps: int, device) -> float:
    """Mean milliseconds per call of ``fn`` after one warm-up call: CUDA
    events around ``reps`` calls on a card, the host clock on the CPU."""
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the operation and byte times."""
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound(theta, out, n_chunks: int, dt: float = 5e-4, t_max: float = 8.0) -> tuple[float, str, int]:
    """K1's bound from the steps its trials executed: a trial runs to its
    hit step, or to the end of its window if it timed out, and both equal
    (rt - t_nd) / dt. Per step ``csrc/ddm_rt_choice.cu`` does 43.5
    FMA-class operations (the update, compares and selects 13, a quarter of
    a Philox4x32-10 call 25, half a Box-Muller pair's plain operations 5.5)
    and 2 special functions, counted in ``roofline.py``; here all 45.5 go
    at the FP32 rate. Bytes: theta (5) and the stimulus's n_chunks columns
    in, (rt, choice) out, float32."""
    import torch

    tnd = theta[:, 4].clamp(0.0, t_max - 1e-6)
    steps = int(torch.round((out[:, 0] - tnd) / dt).clamp(min=0).sum())
    n = theta.shape[0]
    from sbi_for_diffusion_models_tpu_torch.roofline import K1_FMA_CLASS_OPS, K1_TRANSCENDENTAL_CLASS_OPS

    ms, by = _bound((K1_FMA_CLASS_OPS + K1_TRANSCENDENTAL_CLASS_OPS) * steps, 4 * n * (5 + n_chunks + 2))
    return ms, by, steps


def mnle_bound(w, n: int, backward: bool) -> tuple[float, str]:
    """K2/K3 (K2p/K3p) bound at n rows: 2 FLOP per multiply-add of the
    forward products (categorical MLP, trunk, slot head, head on [emb, kf])
    and, for the backward kernel, of its input-gradient products (the same
    matrices transposed; the first layers only to the D context columns; no
    weight gradients). The per-row softmaxes and splines are not counted.
    Bytes: the packed weights once, the row inputs, the cotangent and the
    outputs (the backward kernel's: the value and the gradients)."""
    from sbi_for_diffusion_models_tpu_torch.roofline import mnle_layer_shapes

    D = w.cat[0][0].shape[0]
    H = w.trunk[-1][0].shape[1]
    HF = w.head_w.shape[0]
    layers = mnle_layer_shapes(w)
    macs = sum(a * b for a, b in layers)
    if backward:
        first = {0, len(w.cat)}  # first layers of the two MLPs: gradients to the D context columns only
        macs += sum((D if i in first else a) * b for i, (a, b) in enumerate(layers))
    C, F = w.cat[-1][0].shape[1], HF - H
    row_in = (1 + C + D + F + (1 if w.pulse else 0)) * 4
    row_out = (2 + D + F) * 4 if backward else 4
    nbytes = 4 * sum(a.numel() for a in w.as_list()) + n * (row_in + row_out + (4 if backward else 0))
    return _bound(2.0 * macs * n, nbytes)


def phase_build() -> dict:
    """Build every kernel; returns what ptxas -v said of each entry function
    (mangled name -> registers, stack, spill stores and loads in bytes)."""
    from sbi_for_diffusion_models_tpu_torch.ops import (  # noqa: F401
        _cuda, ceiling_cuda, ddm_cuda, density_cuda, mnle_cuda, nuts_cuda)

    t0 = time.perf_counter()
    per_file = _cuda.build_all()
    _log(f"[build] {json.dumps(per_file)} total_s={time.perf_counter() - t0:.3f}")
    ptxas: dict = {}
    for lib in _cuda._LIBRARIES.values():
        entry = ""
        for line in lib.build_log.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                entry = line.split("'")[1] if "'" in line else line.split()[-1]
            elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line):
                ptxas.setdefault(entry, {}).update(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
            elif m := re.search(r"Used (\d+) registers", line):
                ptxas.setdefault(entry, {})["registers"] = int(m.group(1))
            else:
                continue
            _log(f"[build] {lib.source.name} {entry}: {line.strip()}")
    return ptxas


def _k1_against_plain(label: str, theta, s, n_max: int, spp: int) -> tuple:
    """K1 against its plain version on the trials (theta, s): equal outputs
    without noise, the same output for the same seed, and with noise the
    same distribution (chi-square on the choice counts, two-sample KS on RT
    per choice that both sides produced). Returns (kernel, plain,
    max_abs_err), the two as functions of (mu_sensory, seed, theta, s)."""
    import numpy as np
    import torch
    from scipy import stats

    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_rt_choice_scan

    n = theta.shape[0]
    kw = dict(steps_per_pulse=spp, n_max=n_max)

    def kernel(mu, sd, th=theta, st=s):
        return ddm_rt_choice_cuda(th, st, sd, mu_sensory=mu, **kw)

    def plain(mu, sd, th=theta, st=s):
        return ddm_rt_choice_scan(th, st, sd, mu_sensory=mu, chunk_steps=spp, **kw)

    a, b = kernel(0.0, 1), plain(0.0, 2)
    n_diff = int((a != b).any(1).sum())
    max_abs = float((a - b).abs().max())
    _log(f"[{label}] zero noise n={n}: rows differing={n_diff} max_abs_err={max_abs}")
    if n_diff:
        raise AssertionError(f"{label}: K1 differs from its plain version without noise on {n_diff} rows")

    a1, a2, b = kernel(1.0, 11), kernel(1.0, 11), plain(1.0, 12)
    if not torch.equal(a1, a2):
        raise AssertionError(f"{label}: K1 gives different outputs for the same seed")
    an, bn = a1.cpu().numpy(), b.cpu().numpy()
    counts = np.array([[np.sum(x[:, 1] == c) for c in range(3)] for x in (an, bn)])
    seen = counts.sum(0) > 0  # a choice neither side produced has no row in the table
    chi2_p = float(stats.chi2_contingency(counts[:, seen])[1]) if seen.sum() > 1 else 1.0
    ks_p = [float(stats.ks_2samp(an[an[:, 1] == c, 0], bn[bn[:, 1] == c, 0]).pvalue)
            for c in (0, 1) if counts[:, c].min() > 0]
    _log(f"[{label}] noise n={n}: choice counts kernel={counts[0].tolist()} plain={counts[1].tolist()} "
         f"chi2_p={chi2_p:.4g} ks_p(rt|choice)={[round(p, 4) for p in ks_p]} same_seed_equal=True")
    if min([chi2_p] + ks_p) <= P_MIN:
        raise AssertionError(f"{label}: K1 and its plain version differ in distribution (p <= {P_MIN})")
    return kernel, plain, max_abs


def _k1_fixture():
    """``tests/k1_fixture.py`` (the parent K1's outputs and the inputs they
    were made from), loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("k1_fixture", ROOT / "tests" / "k1_fixture.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_k1_fixture(device) -> dict:
    """K1 against the parent K1's committed outputs (``tests/k1_fixture.py``)
    on every case, bit for bit: N = 1, 31, 33, 4,096 and 8,192 at a 1,600-step
    window with and without a collapsing bound, the full 16,000-step window
    at 4,096, and 300,000 trials, where groups refill. K1's noise depends
    only on (seed, trial, step), so a K1 that keeps its stream, step and
    window gives these bits at every launch shape."""
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda

    fixture = _k1_fixture()
    want = fixture.load()
    differing = {}
    for name, case in fixture.CASES.items():
        got = fixture.run(ddm_rt_choice_cuda, case, device).cpu().numpy()
        differing[name] = int((got != want[name]).any(1).sum())
        _log(f"[K1 fixture] {name} n={case['n']}: rows differing from the parent K1 "
             f"({want['parent_commit'][:12]}) = {differing[name]}")
    bad = {k: v for k, v in differing.items() if v}
    if bad:
        raise AssertionError(f"K1 differs from the parent K1's outputs: {bad}")
    return differing


def phase_k1(device, n: int, seed: int = 7) -> dict:
    """K1 against its plain version at ``n`` prior draws, against the
    parent K1's committed outputs, then its times."""
    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import (
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
    )
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    n_max, spp = pulse_schedule()
    gen = make_generator(seed, device)
    theta = build_prior_theta().sample(gen, (n,))
    s = generate_pulse_matrix(gen, n, n_pulses_max_from_schedule(n_max, spp))
    kernel, plain, max_abs = _k1_against_plain("K1", theta, s, n_max, spp)
    # The main path's launch (TRAIN_BATCH_SIZE) runs another instance of the kernel than n's: hold it as well.
    max_abs = max(max_abs, _k1_against_plain("K1 n=4096", theta[:4096], s[:4096], n_max, spp)[2])
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import (
        K1_LAST_LAUNCH,
        K1_THREADS,
        _card_capacity,
        k1_noise_mismatches,
    )

    mismatches = k1_noise_mismatches(device)
    _log(f"[K1] square root and sine/cosine against sqrtf and sincosf on all 2^24 inputs each: "
         f"{mismatches} results differ in their bits")
    if mismatches:
        raise AssertionError(f"K1's noise differs from the math library's on {mismatches} inputs")
    phase_k1_fixture(device)

    # Times at the main path's batch (TRAIN_BATCH_SIZE = 4,096) and at n,
    # with the bound from the steps the timed call's trials executed and the
    # launch shape that call ran at.
    times, shapes = {}, {}
    sm, resident = _card_capacity(device, False)
    for m in (4096, n):
        k_ms = _time_ms(lambda: kernel(1.0, 3, theta[:m], s[:m]), 5, device)
        p_ms = _time_ms(lambda: plain(1.0, 4, theta[:m], s[:m]), 1, device)
        b_ms, b_by, steps = k1_bound(theta[:m], kernel(1.0, 3, theta[:m], s[:m]), n_max // spp)
        if K1_LAST_LAUNCH["n"] != m:
            raise AssertionError(f"K1's last launch was not the timed one at n={m}: {K1_LAST_LAUNCH}")
        G, blocks = K1_LAST_LAUNCH["G"], K1_LAST_LAUNCH["blocks"]
        shapes[str(m)] = {"G": G, "blocks": blocks, "resident_groups": blocks * K1_THREADS // G,
                          "resident_blocks_per_sm": resident[G], "sm_count": sm}
        _log(f"[K1] launch shape n={m}: {json.dumps(shapes[str(m)])}")
        times[m] = (k_ms, p_ms, b_ms, b_by, steps)
        _log(f"[K1] time n={m}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4g} ({b_by}) "
             f"executed_trial_steps={steps} ({steps / (m * n_max):.4f} of nominal) "
             f"executed_trial_steps_per_s(kernel)={steps / (k_ms * 1e-3):.4g}")
    return {"max_abs_err": max_abs, "ms": times[4096][0], "plain_ms": times[4096][1],
            "bound_ms": times[4096][2], "bound_by": times[4096][3], "steps": times[4096][4], "times": times,
            "launch_shape": shapes}


def _session_pairs(prior, device, n_sessions: int, seed: int = 11) -> list:
    """Per session, the (x, condition) rows the posterior potential builds:
    a prior draw theta_true, its simulated 50-trial session, and 24 thetas
    (theta_true and 23 prior draws) against every trial: (1,200, 2) and
    (1,200, 85)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_observed_session
    from sbi_for_diffusion_models_tpu_torch.utils.rng import child_seed, make_generator

    out = []
    for i in range(n_sessions):
        gen = make_generator(child_seed(seed, i), device)
        theta = prior.sample(gen, (24,))
        x, s = simulate_observed_session(theta[0], 50, seed=child_seed(seed, 1000 + i), device=device)
        cond = torch.cat([theta[:, None, :].expand(24, 50, 5), s[None].expand(24, 50, s.shape[1])], -1)
        out.append((x[None].expand(24, 50, 2).reshape(-1, 2), cond.reshape(-1, cond.shape[-1])))
    return out


def session_rows(est, prior, device, n_sessions: int, seed: int = 11):
    """Standardized rows as the posterior potential builds them: per session
    a prior draw theta_true, its simulated 50-trial session, and 24 thetas
    (theta_true and 23 prior draws) against every trial. Returns the
    kernels' row inputs: (t, onehot, ctx), or for the pulse rep (phi,
    onehot, ctx, kf, kv); ctx is the context the heads read (with the pulse
    embedding, ``make_context``'s)."""
    import torch

    parts = []
    for xr, cr in _session_pairs(prior, device, n_sessions, seed):
        if est.cfg.rt_rep == "pulse":
            phi, oh, c, kf, kv, _, _ = est.standardize_pulse(xr, cr)
            parts.append((phi, oh, est.net.make_context(c, cr), kf, kv))
        else:
            t, oh, c, _, _, _ = est.standardize(xr, cr)
            parts.append((t, oh, est.net.make_context(c, cr)))
    return tuple(torch.cat(col).contiguous() for col in zip(*parts))


def _check_against_reference(label, names, kern, plain, ref, spread, n) -> None:
    """Each output of the kernel against the float64 reference, row by row
    (``ops/rowcheck.row_check``: the value to 1e-4 and the gradients to
    1e-3, each times the row's own scale, on all but 0.1 % of the rows; the
    value also on its worst row); logs every output with its worst row,
    then raises if one failed."""
    from sbi_for_diffusion_models_tpu_torch.ops.rowcheck import MAX_OVER_SHARE, PERTURB, row_check

    failed = []
    for i, name in enumerate(names):
        c = row_check(kern[i], plain[i], ref[i], spread[i], value=name.startswith("value"))
        r = c.worst_row
        col = int((kern[i][r].double() - ref[i][r]).abs().reshape(-1).argmax())
        at = [float(x[r].reshape(-1)[col]) for x in (kern[i], plain[i], ref[i])]
        limit = f"{c.limit:.3f}" if c.limit is not None else "none"
        _log(f"[{label}] n={n} {name}: rows over their allowance kernel={c.share:.3e} "
             f"({int(c.over.sum())} rows) plain_f32={c.plain_share:.3e} (limit {MAX_OVER_SHARE:g}); "
             f"worst err/allowance kernel={c.worst:.3f} plain_f32={c.plain_worst:.3f} (limit {limit}) "
             f"at row {r} (kernel {at[0]:.7g} plain_f32 {at[1]:.7g} float64 {at[2]:.7g}); "
             f"tol={c.tol:g} x max(1, row max |ref|); steep rows at {PERTURB:.2g} input change: {c.steep}; "
             f"kernel rel err on the other rows={c.flat_err:.3e}")
        if not c.ok:
            failed.append(f"{name} ({c.share:.3e} of the rows over their allowance, worst {c.worst:.3f}, "
                          f"limit {limit}, finite {bool(kern[i].isfinite().all())})")
    if failed:
        raise AssertionError(f"{label} at {n} rows fails its float64 check: {'; '.join(failed)}")


def _phase_fused(device, model_file, fwd, bwd, sizes, model_dir=MODEL_DIR) -> dict:
    """A fused forward/backward pair against its plain versions on the
    model ``model_dir/model_file`` (default: the committed models), at each
    row count of ``sizes`` (``_hold_fused``)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    os.environ["MODEL_DIR"] = str(model_dir)
    est = load_model(model_file, device=device)
    w32 = mc.pack_mnle_weights(est)
    prior = build_prior_theta()
    out = {}
    for n in sizes:
        rows = tuple(a[:n].contiguous() for a in session_rows(est, prior, device, -(-n // ROWS_MAIN)))
        g = torch.randn(rows[0].shape, generator=torch.Generator(device).manual_seed(5), device=device)
        out[n] = _hold_fused(device, w32, fwd, bwd, rows, g)
    return out


def _hold_fused(device, w32, fwd, bwd, rows, g) -> dict:
    """A fused forward/backward pair against its plain versions on the
    kernels' row inputs ``rows`` with the cotangent ``g``, then their times.
    ``fwd``/``bwd`` are (label, kernel wrapper, plain version); the
    backward's wrapper returns the value and the gradients, its plain
    version the gradients. The backward kernel's value must equal the
    forward kernel's on every row, and each is held to float64 as the
    gradients are."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.ops.rowcheck import reference

    w64 = w32.astype(torch.float64)
    (f_label, f_kernel, f_plain), (b_label, b_kernel, b_plain) = fwd, bwd
    grad_names = ("dphi", "dctx", "dkf") if w32.pulse else ("dt", "dctx")
    n = rows[0].shape[0]
    kern = (f_kernel(*rows, w32), *b_kernel(*rows, w32, g))
    value = f_plain(*rows, w32)
    plain = (value, value, *b_plain(*rows, w32, g))
    n_equal = int((kern[1] == kern[0]).sum())
    _log(f"[{f_label}/{b_label}] n={n}: {b_label}'s value has {f_label}'s bits on {n_equal} of {n} rows")
    if n_equal != n:
        raise AssertionError(f"{b_label}'s value differs from {f_label}'s on {n - n_equal} of {n} rows")

    def run64(*a):
        v = f_plain(*a[:-1], w64)
        return (v, v, *b_plain(*a[:-1], w64, a[-1]))

    continuous = (2, 3) if w32.pulse else (2,)  # ctx (and kf); never the one-hot or the slot index
    ref, spread = reference(run64, rows, g, continuous)
    _check_against_reference(f"{f_label}/{b_label}", (f"value ({f_label})", f"value ({b_label})") + grad_names,
                             kern, plain, ref, spread, n)
    reps = 20 if n <= ROWS_FOLD else 5
    times = {
        f_label: (_time_ms(lambda: f_kernel(*rows, w32), reps, device),
                  _time_ms(lambda: f_plain(*rows, w32), reps, device), *mnle_bound(w32, n, False)),
        b_label: (_time_ms(lambda: b_kernel(*rows, w32, g), reps, device),
                  _time_ms(lambda: (f_plain(*rows, w32), b_plain(*rows, w32, g)), reps, device),
                  *mnle_bound(w32, n, True)),
    }
    for name, (k_ms, p_ms, b_ms, b_by) in times.items():
        _log(f"[{name}] time n={n}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4g} ({b_by}, "
             f"{b_ms / k_ms:.3f} of it) rows_per_s(kernel)={n / (k_ms * 1e-3):.4g}")
    return {
        f_label: {"max_abs_err": float((kern[0] - plain[0]).abs().max()), "times": times[f_label]},
        b_label: {"max_abs_err": max(float((k - pl).abs().max()) for k, pl in zip(kern[1:], plain[1:])),
                  "times": times[b_label]},
    }


def phase_k2k3(device, sizes=(ROWS_MAIN, ROWS_SBC), model_file=MODEL_FILE, model_dir=MODEL_DIR) -> dict:
    """K2/K3 against their plain version on the same rows; K3's value is
    K2's, bit for bit.

    The reference is the plain version run in float64 on the kernels'
    float32 inputs and weights. Each row is held to the stated tolerance
    times its own scale, max(1, its largest |ref|); where the exact function
    moves more than that under an input change of a few float32 ulps (steep
    densities, spline knots, ReLU kinks: the row's spread), no float32
    evaluation can be held to the fixed tolerance, and twice the spread is
    added. The kernel fails when more than 0.1 % of the rows exceed their
    allowance, or when the value's worst row exceeds it by more than
    min(10, max(1, 3 x the plain float32 version's worst row)); the plain
    version's share and worst row are printed beside. A gradient is not
    held on its worst row: a float32 evaluation that lands exactly on a
    knot or a clip bound takes the clip's half gradient there, and the
    float64 reference never lands on it (``ops/rowcheck.py``)."""
    return _phase_fused(device, model_file, *_k2k3_specs(), sizes, model_dir)


def phase_k2pk3p(device, sizes=(ROWS_MAIN, ROWS_SBC)) -> dict:
    """K2p/K3p against their plain version on the pulse-grid model, held as
    K2/K3 are (``phase_k2k3``) over the values and dphi, dctx and dkf."""
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc

    return _phase_fused(device, PULSE_MODEL_FILE,
                        ("K2p", mc.rows_logp_pulse, mc.rows_logp_pulse_plain),
                        ("K3p", mc.rows_logp_pulse_and_vjp, mc.rows_logp_pulse_vjp_plain), sizes)


def _ulps(x, y) -> int:
    """The largest distance in float32 ulps between x and y (0 where both
    are NaN, 2^31 where one is)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = (ordered(x) - ordered(y)).abs()
    nx, ny = torch.isnan(x), torch.isnan(y)
    d = torch.where(nx & ny, 0, torch.where(nx ^ ny, 2**31, d))
    return int(d.max()) if d.numel() else 0


def _leaf_start(device, C: int, D: int, S: int, seed: int, moving: bool = True):
    """A subtree's start for the leaf check: positions and momenta from
    N(0, 1) on a diagonal Gaussian with random mean and precision, step sizes
    that make some chains turn within a few leaves, every fifth chain
    inactive. With ``moving`` False the potential is flat (logp 0, g 0) and
    H0 the start's kinetic energy, so every chain moves in a straight line
    and stays live. Returns (state dict, vg, half_e, e_im, inv_mass, H0)."""
    import numpy as np
    import torch

    from sbi_for_diffusion_models_tpu_torch.inference import nuts as tn

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    mu, prec = f32(rng.normal(size=D)), f32(rng.uniform(0.3, 3.0, D))
    logp0, g0 = torch.zeros((C,), device=device), torch.zeros((C, D), device=device)

    def vg(x):
        return (-0.5 * ((x - mu) ** 2 * prec).sum(-1), -(x - mu) * prec) if moving else (logp0, g0)

    u, p = f32(rng.normal(size=(C, D))), f32(rng.normal(size=(C, D)))
    inv_mass = f32(rng.uniform(0.5, 2.0, (C, D)))
    eps = f32(rng.uniform(0.02, 0.6, C))
    direction = torch.where(f32(rng.uniform(size=C)) < 0.5, 1.0, -1.0)
    active = torch.from_numpy(np.arange(C) % 5 != 4).to(device) if moving else torch.ones(
        (C,), dtype=torch.bool, device=device)
    logp, g = vg(u)
    H0 = -logp + tn._kinetic(p, inv_mass)
    edge = torch.cat([u, p, g, logp[:, None]], dim=1)
    s = dict(edge=edge, prop=torch.cat([edge[:, :D], edge[:, 2 * D :]], dim=1),
             rho=torch.zeros((C, D), device=device), log_w=torch.full((C,), -math.inf, device=device),
             sum_accept=torch.zeros((C,), device=device),
             n_leaves=torch.zeros((C,), dtype=torch.int64, device=device),
             turning=torch.zeros((C,), dtype=torch.bool, device=device),
             diverging=torch.zeros((C,), dtype=torch.bool, device=device), live=active.clone(),
             r_ckpts=torch.zeros((C, S, D), device=device), rsum_ckpts=torch.zeros((C, S, D), device=device))
    return s, vg, (0.5 * eps * direction)[:, None], (eps * direction)[:, None] * inv_mass, inv_mass, H0


def leaf_bound(C: int, D: int, leaves) -> tuple[float, str]:
    """The leaf kernel's bound per launch, averaged over leaf indices
    ``leaves``, as ``csrc/nuts_leaf.cu`` does a leaf for each of C live
    chains. Operations: p_new's D FMAs (2 each), the kinetic energy's 3D,
    about 12 for the energy error, logaddexp and the take (each special
    function one), rho's D, the next half step's 2D FMAs, and at an odd
    leaf 8D for each checkpoint slot of its U-turn test. Bytes, float32
    unless said, each tensor read once and written once: read p_half,
    g_new, u_new, inv_mass, e_im, rho (D each), half_e, logp_new, H0,
    log_w, uni, sum_accept, the odd leaf's 2D a slot of checkpoints, the
    int64 count and three bools; write edge (3D + 1), prop (2D + 1), rho,
    p_half, u_next (D each), log_w, sum_accept, the even leaf's 2D of
    checkpoints, the count and the three bools."""
    from sbi_for_diffusion_models_tpu_torch.inference import nuts as tn

    ops = nbytes = 0.0
    for n in leaves:
        store, lo, hi = tn._leaf_slots(n)
        k = hi - lo + 1 if lo >= 0 else 0
        ops += C * (2 * D + 3 * D + 12 + D + 4 * D + 8 * D * k)
        read = 4 * (6 * D + 6 + 2 * D * k) + 8 + 3
        write = 4 * ((3 * D + 1) + (2 * D + 1) + 3 * D + 2 + (2 * D if store >= 0 else 0)) + 8 + 3
        nbytes += C * (read + write)
    return _bound(ops / len(leaves), nbytes / len(leaves))


def phase_leaf(device) -> dict:
    """The NUTS leaf kernel against the plain leaf at LEAF_SHAPES: every
    leaf of subtrees of depth 0 to LEAF_DEPTH on the same inputs, potential
    and uniforms (a NaN, a -inf and a divergent log-density on a few chains
    at leaves 1 to 3); the counts, booleans and live flag must be exact, the
    floats within LEAF_ULPS. Then each side over LEAF_TIMED leaves on which
    every chain stays live: the kernel's device time a launch and the plain
    leaf's device time a leaf (its half step, body and flag copy, as
    ``_build_subtree`` ran it; ``torch.profiler``), and each side's host
    time a leaf. Returns {(C, D): check and times}."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.inference import nuts as tn
    from sbi_for_diffusion_models_tpu_torch.ops import nuts_cuda
    from sbi_for_diffusion_models_tpu_torch.utils.metrics import device_intervals, warm_window
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    floats = ("edge", "prop", "rho", "log_w", "sum_accept", "r_ckpts", "rsum_ckpts")
    exact = ("n_leaves", "turning", "diverging", "live")
    bad = {1: math.nan, 2: -math.inf, 3: -5000.0}
    S = LEAF_DEPTH + 1
    out = {}

    def first_half_step(kernel, e, D, half_e, e_im):
        torch.addcmul(e[:, D : 2 * D], half_e, e[:, 2 * D : 3 * D], out=kernel.p_half)
        return torch.addcmul(e[:, :D], e_im, kernel.p_half)

    for C, D in LEAF_SHAPES:
        worst, leaves, diverged, launched = 0, 0, 0, nuts_cuda.LEAF.launches
        t0 = time.perf_counter()
        for depth in range(LEAF_DEPTH + 1):
            plain, vg, half_e, e_im, inv_mass, H0 = _leaf_start(device, C, D, S, seed=1000 * C + depth)
            fused = {k: v.clone() for k, v in plain.items()}
            flag = torch.zeros((2,), dtype=torch.bool, pin_memory=True)
            kernel = nuts_cuda.LeafKernel(fused, half_e, e_im, inv_mass, H0, flag)
            u_fused = first_half_step(kernel, fused["edge"], D, half_e, e_im)
            gen = make_generator(depth, device)
            chain = torch.arange(C, device=device)
            for n in range(1 << depth):
                e = plain["edge"]
                p_half = torch.addcmul(e[:, D : 2 * D], half_e, e[:, 2 * D : 3 * D])
                u_new = torch.addcmul(e[:, :D], e_im, p_half)
                logp_new, g_new = vg(u_new)
                if n in bad:
                    logp_new = torch.where(chain % 11 == 2 * n, torch.full_like(logp_new, bad[n]), logp_new)
                uni = torch.rand((C,), generator=gen, device=device)
                diff = {"u_new": _ulps(u_fused, u_new)}
                u_fused = kernel.leaf(u_fused, logp_new, g_new, uni, tn._leaf_slots(n), n % 2)
                plain = tn._leaf_plain(n, plain, u_new, p_half, logp_new, g_new, uni, half_e, inv_mass, H0)
                torch.cuda.synchronize()
                diff.update({k: _ulps(fused[k], plain[k]) for k in floats})
                off = {k: int((fused[k] != plain[k]).sum()) for k in exact}
                off["flag"] = int(bool(flag[n % 2]) != bool(plain["live"].any()))
                if any(off.values()) or max(diff.values()) > LEAF_ULPS:
                    raise AssertionError(f"leaf: C={C} D={D} depth={depth} leaf {n}: the kernel differs from the "
                                         f"plain leaf: ulps {diff}, chains {off}")
                worst = max(worst, *diff.values())
                leaves += 1
            diverged += int(plain["diverging"].sum())
        check_s = time.perf_counter() - t0
        if not diverged or nuts_cuda.LEAF.launches - launched != leaves:
            raise AssertionError(f"leaf: C={C}: {diverged} chains diverged, "
                                 f"{nuts_cuda.LEAF.launches - launched} launches for {leaves} leaves")
        _log(f"[leaf] C={C} D={D}: {leaves} leaves (every leaf of depths 0 to {LEAF_DEPTH}) against the plain leaf: "
             f"counts, booleans and the flag exact, floats worst {worst} ulps (limit {LEAF_ULPS}); "
             f"{diverged} chains diverged; check_s={check_s:.3f}")

        # Timing, every chain live on a flat potential: the kernel, then the plain leaf from the same start.
        timed = [n % (1 << LEAF_DEPTH) for n in range(LEAF_TIMED)]
        s, vg, half_e, e_im, inv_mass, H0 = _leaf_start(device, C, D, S, seed=C, moving=False)
        logp0, g0 = vg(None)
        uni = torch.rand((C,), generator=make_generator(1, device), device=device)
        plain = {k: v.clone() for k, v in s.items()}
        flag = torch.zeros((2,), dtype=torch.bool, pin_memory=True)
        kernel = nuts_cuda.LeafKernel(s, half_e, e_im, inv_mass, H0, flag)
        u = first_half_step(kernel, s["edge"], D, half_e, e_im)

        def kernel_leaves(u):
            for n in timed:
                u = kernel.leaf(u, logp0, g0, uni, tn._leaf_slots(n), n % 2)
            return u

        def plain_leaves(sp):
            for n in timed:
                e = sp["edge"]
                p_half = torch.addcmul(e[:, D : 2 * D], half_e, e[:, 2 * D : 3 * D])
                u_new = torch.addcmul(e[:, :D], e_im, p_half)
                sp = tn._leaf_plain(n, sp, u_new, p_half, logp0, g0, uni, half_e, inv_mass, H0)
                flag[n % 2].copy_(sp["live"].any(), non_blocking=True)
            return sp

        times = {}
        for side, fn, arg in (("kernel", kernel_leaves, u), ("plain", plain_leaves, plain)):
            arg = fn(arg)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            arg = fn(arg)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / LEAF_TIMED
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                warm_window()  # the profiler can miss the events at the ends of its window; spins, not counted
                arg = fn(arg)
                warm_window()
            everything = device_intervals(prof)
            ev = [e for e in everything if "spin" not in e[2]]
            # Should it miss one of the leaves' events all the same (one of 1,024 did on the H100), a side's device
            # time a leaf is over the leaves it saw (the kernel's launches; the plain side's leaves by its copies).
            marks = [e for e in ev if ("nuts_leaf_kernel" if side == "kernel" else "Memcpy") in e[2]]
            seen = len(marks)
            if not LEAF_TIMED - 4 <= seen <= LEAF_TIMED:
                spins = [e for e in everything if "spin" in e[2]]
                raise AssertionError(
                    f"leaf: the profiler saw {seen} of the {side} side's {LEAF_TIMED} leaves, {len(ev)} events and "
                    f"{len(spins)} spins; the leaves' first and last event at "
                    f"{[(e[0] - everything[0][0]) / 1e6 for e in (ev[0], ev[-1])] if ev else None} ms of a "
                    f"{(everything[-1][1] - everything[0][0]) / 1e6 if everything else 0:.3f} ms window: {ev[:4]}")
            times[side] = {"device_ms": sum(b - a for a, b, _ in ev) / 1e6 / seen, "host_ms": host_ms,
                           "device_ops_per_leaf": len(ev) / seen}
            if side == "plain":
                live = bool(arg["live"].all())
            else:
                live = bool(s["live"].all())
            if not live:
                raise AssertionError(f"leaf: C={C}: a chain stopped during the {side} side's timed leaves")
        bound_ms, bound_by = leaf_bound(C, D, timed)
        out[C, D] = r = {"D": D, "leaves_checked": leaves, "worst_ulps": worst, "ms": times["kernel"]["device_ms"],
                  "plain_ms": times["plain"]["device_ms"], "host_ms": times["kernel"]["host_ms"],
                  "plain_host_ms": times["plain"]["host_ms"],
                  "plain_ops_per_leaf": times["plain"]["device_ops_per_leaf"], "bound_ms": bound_ms,
                  "bound_by": bound_by}
        _log(f"[leaf] C={C} D={D} over {LEAF_TIMED} live leaves: kernel device_ms={r['ms']:.6f} "
             f"host_ms={r['host_ms']:.6f}; plain leaf device_ms={r['plain_ms']:.6f} "
             f"({r['plain_ops_per_leaf']:.2f} device operations) host_ms={r['plain_host_ms']:.6f}; "
             f"bound_ms={bound_ms:.3g} ({bound_by})")
    return out


def density_bound(C: int, D: int) -> tuple[float, str]:
    """The u-space density's bound a call for C chains of D dimensions.
    Bytes, float32, what the function itself reads and writes: u, ll, beta
    and g_ll in, theta, the value and the gradient out, 16 D + 12 bytes a
    chain. The pair's own round trip through its scratch between the two
    launches (dtheta, dlog_det, g_lp and lp + log_det, 24 D + 8 bytes a
    chain) is a cost of splitting the work around the potential, and is not
    counted. Operations, a special function one: about 40 a dimension
    (sigmoid, exp, two logsigmoids, the prior's column and its gradient,
    the sums, the chain rule)."""
    return _bound(C * 40.0 * D, C * (16.0 * D + 12.0))


def phase_density(device) -> dict:
    """The u-space density's kernel pair against the plain composition on
    the flagship's prior at DENSITY_CHAINS, D = 5 (value, gradient and the
    theta the potential gets, bit for bit, with and without the gradient,
    on normal draws at three scales and on u at +-inf and NaN), then each
    side over DENSITY_TIMED calls around a potential that launches nothing:
    device time a call (``torch.profiler``), host time a call and device
    operations a call. Returns {C: check and times}."""
    import torch

    from sbi_for_diffusion_models_tpu_torch import potentials as tp
    from sbi_for_diffusion_models_tpu_torch.distributions import mcmc_transform
    from sbi_for_diffusion_models_tpu_torch.inference.nuts import geometric_ladder
    from sbi_for_diffusion_models_tpu_torch.ops import density_cuda
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.utils.metrics import device_intervals, warm_window

    prior = build_prior_theta()
    bij = mcmc_transform(prior)
    D = bij.dim

    class Potential:
        """A likelihood that hands back the same (ll, g_ll) and launches nothing."""

        def __init__(self, C):
            gen = torch.Generator().manual_seed(C)
            self.local_theta = torch.zeros((1, 1), device=device)
            self.out = (torch.randn((C,), generator=gen).mul(50.0).to(device),
                        torch.randn((C, D), generator=gen).mul(5.0).to(device))
            self.seen = None

        def log_lik_and_grad(self, x, theta, need_grad=True, sessions=None):
            self.seen = theta
            return self.out[0], (self.out[1] if need_grad else None)

    def differing(a, b) -> int:
        same = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
        return int((~same).sum())

    def abs_err(a, b) -> float:
        """The largest |a - b| where both are finite (0.0 where none is)."""
        both = torch.isfinite(a) & torch.isfinite(b)
        return float((a[both].double() - b[both].double()).abs().max()) if bool(both.any()) else 0.0

    out = {}
    for C in DENSITY_CHAINS:
        lik = Potential(C)
        vg = tp.tempered_value_and_grad(prior, bij, lik)
        beta = torch.as_tensor(geometric_ladder(6, 0.04)).repeat(C // 6).to(device)
        gen = torch.Generator().manual_seed(17 + C)
        cases = [torch.randn((C, D), generator=gen).mul(scale).to(device) for scale in (0.3, 3.0, 30.0)]
        edge = cases[0].clone()
        edge[::7, 1], edge[1::7, 2], edge[2::7, 0], edge[3::7, 4] = math.inf, -math.inf, math.nan, 100.0
        cases.append(edge)
        checked, differing_values, max_abs_err = 0, 0, 0.0
        for u in cases:
            for need_grad in (True, False):
                value, grad = vg(u, None, beta, need_grad)
                theta = lik.seen
                p_value, p_grad = tp._tempered_vg_plain(prior, bij, lik, 1.0, u, None, beta, need_grad)
                pairs = {"theta": (theta, lik.seen), "value": (value, p_value)}
                if need_grad:
                    pairs["grad"] = (grad, p_grad)
                off = {k: differing(a, b) for k, (a, b) in pairs.items()}
                differing_values += sum(off.values())
                max_abs_err = max(max_abs_err, *(abs_err(a, b) for a, b in pairs.values()))
                if any(off.values()):
                    raise AssertionError(f"density: C={C} need_grad={need_grad}: the pair differs from the plain "
                                         f"composition: {off}, max_abs_err={max_abs_err}")
                checked += 1
        _log(f"[density] C={C} D={D}: {checked} calls against the plain composition (value, gradient, theta), "
             f"normal draws and +-inf, NaN: {differing_values} values differing in their bits, "
             f"max_abs_err={max_abs_err}")

        u = cases[0]
        times = {}
        for side in ("pair", "plain"):
            def fn(calls=DENSITY_TIMED, pair=side == "pair"):
                for _ in range(calls):
                    if pair:
                        vg(u, None, beta, True)
                    else:
                        tp._tempered_vg_plain(prior, bij, lik, 1.0, u, None, beta, True)
            fn()  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / DENSITY_TIMED
            launched = density_cuda.DENSITY_PRE.launches
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                warm_window()  # the profiler can miss the events at the ends of its window; spins, not counted
                fn()
                warm_window()
            ev = [e for e in device_intervals(prof) if "spin" not in e[2]]
            if side == "pair" and density_cuda.DENSITY_PRE.launches - launched != DENSITY_TIMED:
                raise AssertionError("density: the pair did not launch once a call")
            # The calls the profiler saw: the pair's by density_post, the plain composition's by its one sigmoid
            # (the bijector's; logsigmoid's kernel has another name).
            mark = "density_post_kernel" if side == "pair" else "sigmoid_kernel_cuda"
            seen = sum(1 for *_, name in ev if mark in name)
            if not DENSITY_TIMED - 4 <= seen <= DENSITY_TIMED:
                raise AssertionError(f"density: the profiler saw {seen} of the {side} side's {DENSITY_TIMED} calls: "
                                     f"{sorted({name[:80] for *_, name in ev})}")
            times[side] = {"device_ms": sum(b - a for a, b, _ in ev) / 1e6 / seen, "host_ms": host_ms,
                           "ops_per_call": len(ev) / seen}
        bound_ms, bound_by = density_bound(C, D)
        out[C] = r = {"D": D, "calls_checked": checked, "differing_values": differing_values,
                      "max_abs_err": max_abs_err, "ms": times["pair"]["device_ms"],
                      "plain_ms": times["plain"]["device_ms"], "host_ms": times["pair"]["host_ms"],
                      "plain_host_ms": times["plain"]["host_ms"], "ops_per_call": times["pair"]["ops_per_call"],
                      "plain_ops_per_call": times["plain"]["ops_per_call"], "bound_ms": bound_ms,
                      "bound_by": bound_by}
        _log(f"[density] C={C} D={D} over {DENSITY_TIMED} calls: pair device_ms={r['ms']:.6f} "
             f"({r['ops_per_call']:.2f} device operations) host_ms={r['host_ms']:.6f}; plain composition "
             f"device_ms={r['plain_ms']:.6f} ({r['plain_ops_per_call']:.2f} device operations) "
             f"host_ms={r['plain_host_ms']:.6f}; bound_ms={bound_ms:.3g} ({bound_by})")
    return out


def _sample_posterior(label, device, model_file, prior, x_o, pulses_o, warmup: int, draws: int,
                      model_dir=MODEL_DIR, est=None, max_depth=None) -> dict:
    """Load ``model_dir/model_file`` (or take the estimator ``est``) and
    sample the posterior of the session (x_o, pulses_o) with the calibrated
    sampler (warmup and draws cut, trees capped at ``max_depth`` where
    given), through the public entry points; checks the draws and prints the
    sampler's numbers."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.inference.diagnostics import effective_sample_size, split_r_hat
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model, run_inference_mcmc
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    walls = {}
    t0 = time.perf_counter()
    if est is None:
        os.environ["MODEL_DIR"] = str(model_dir)
        est = load_model(model_file, device=device)
    walls["load"] = time.perf_counter() - t0

    cfg = CALIBRATED_CONFIG.replace(WARMUP_STEPS=warmup, POSTERIOR_SAMPLES=draws)
    if max_depth is not None:
        cfg = cfg.replace(MCMC_MAX_TREE_DEPTH=max_depth)
    t0 = time.perf_counter()
    samples, info = run_inference_mcmc(cfg, prior, est, x_o, pulses_o, device=device, seed=0, return_info=True)
    torch.cuda.synchronize()
    walls["mcmc"] = time.perf_counter() - t0

    if tuple(samples.shape) != (draws, 5):
        raise AssertionError(f"{label}: posterior samples have shape {tuple(samples.shape)}, expected ({draws}, 5)")
    if not bool(torch.isfinite(samples).all()):
        raise AssertionError(f"{label}: non-finite posterior samples")
    if not bool(torch.isfinite(prior.log_prob(samples)).all()):
        raise AssertionError(f"{label}: posterior samples outside the prior's support")
    C, R = cfg.NUM_CHAINS, cfg.MCMC_PT_REPLICAS
    div = info["diverging"]
    cold_div = int(div.reshape(C, R, -1)[:, 0].sum())
    # Pooled draws interleave the cold chains: draw k of chain c is row k*C + c.
    chains = samples.reshape(-1, C, samples.shape[-1]).transpose(0, 1)
    diag = {"r_hat": split_r_hat(chains), "ess": effective_sample_size(chains)}
    steps = info["num_steps"].to(torch.float64)
    _log(f"[{label}] divergences(all rungs)={int(div.sum())} divergences(cold chains)={cold_div} "
         f"mean_tree_leaves={float(steps.mean()):.2f} swap_accept={info.get('swap_accept', float('nan')):.3f} "
         f"potential_calls={info['potential_calls']} ms_per_call={walls['mcmc'] * 1e3 / info['potential_calls']:.3f}")
    _log(f"[{label}] split_r_hat={[round(float(v), 4) for v in diag['r_hat']]} "
         f"ess={[round(float(v), 1) for v in diag['ess']]} "
         f"posterior_mean={[round(v, 4) for v in samples.mean(0).tolist()]}")
    return walls


def _observed_session(device):
    """The observed session both paths sample: theta_true from the prior
    (seed 3) and its 50-trial session (seed 123)."""
    from sbi_for_diffusion_models_tpu_torch.data_simulator import simulate_observed_session, summarize_trials
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    prior = build_prior_theta()
    theta_true = prior.sample(make_generator(3, device), (1,))[0]
    x_o, pulses_o = simulate_observed_session(theta_true, CALIBRATED_CONFIG.NUM_TRIALS_OBS, seed=123, device=device)
    _log(f"[session] theta_true={[round(v, 4) for v in theta_true.tolist()]}")
    summarize_trials("observed", x_o)
    return prior, x_o, pulses_o


def _forward_share(label, launches, fwd: str, bwd: str) -> None:
    """Fail unless the forward kernel ``fwd`` launched less than 5 % as
    often as the backward ``bwd`` on the path: a gradient call launches the
    backward kernel alone, which writes the value too."""
    share = launches[fwd] / launches[bwd]
    _log(f"[{label}] {fwd} launches / {bwd} launches = {launches[fwd]} / {launches[bwd]} = {share:.4f} (limit 0.05)")
    if not share < 0.05:
        raise AssertionError(f"{label}: {fwd} launched {launches[fwd]} times against {bwd}'s {launches[bwd]}")


def _launches_on(label, required, run) -> tuple:
    """Run ``run()`` with every kernel's count set to 0 just before and read
    just after; fail unless each kernel in ``required`` launched."""
    from sbi_for_diffusion_models_tpu_torch.ops._cuda import KERNELS

    for k in KERNELS.values():
        k.launches = 0
    result = run()
    launches = {name: k.launches for name, k in KERNELS.items()}
    _log(f"[{label}] launches={json.dumps(launches)}")
    missing = [name for name in required if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {label} path: {missing}")
    return result, launches


@contextlib.contextmanager
def _recording_k3():
    """Record, around K3's wrapper and without launching anything, the row
    count of every call and the inputs of the first call at each row count,
    ``{rows: ((t, onehot, ctx), weights, cotangent)}``: the kernel is held on
    the rows a path gave it after that path's counts are read."""
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc

    k3, seen, first = mc.rows_logp_and_vjp, [], {}

    def recording(t, oh, ctx, w, g):
        seen.append(t.shape[0])
        if t.shape[0] not in first:
            first[t.shape[0]] = ((t.clone(), oh.clone(), ctx.clone()), w, g.clone())
        return k3(t, oh, ctx, w, g)

    mc.rows_logp_and_vjp = recording
    try:
        yield seen, first
    finally:
        mc.rows_logp_and_vjp = k3


def _k2k3_specs():
    """K2's and K3's (label, kernel wrapper, plain version), as ``_hold_fused`` takes them."""
    from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc

    return ("K2", mc.rows_logp, mc.rows_logp_plain), ("K3", mc.rows_logp_and_vjp, mc.rows_logp_vjp_plain)


def phase_main(device, n_sim: int = N_SIM, warmup: int = SERVE_WARMUP, draws: int = SERVE_DRAWS) -> dict:
    """The flagship serving path through its public entry points: simulate
    a training set and the observed session (K1), load the flagship model
    and sample its posterior (K2/K3 at every gradient). The simulated pairs
    are returned for the training path. After the counts are read, the
    flagship's ``sample`` against the CPU's plain path (``hold_sample``)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.data_simulator import (
        simulate_training_set_with_conditions,
        summarize_trials,
    )
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import (
        n_pulses_max_from_schedule,
        pulse_schedule,
    )
    from sbi_for_diffusion_models_tpu_torch.proposals import ExtendedProposal, PulseSequenceProposal
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    def run():
        walls = {}
        t_all = time.perf_counter()
        t0 = time.perf_counter()
        P = n_pulses_max_from_schedule(*pulse_schedule())
        prior, x_o, pulses_o = _observed_session(device)
        proposal = ExtendedProposal(prior, PulseSequenceProposal(P, CALIBRATED_CONFIG.P_SUCCESS, device=device))
        z, x = simulate_training_set_with_conditions(CALIBRATED_CONFIG, proposal, num_simulations=n_sim,
                                                     device=device)
        torch.cuda.synchronize()
        walls["simulate"] = time.perf_counter() - t0
        summarize_trials("train", x)
        if tuple(x.shape) != (n_sim, 2) or tuple(z.shape) != (n_sim, 5 + P):
            raise AssertionError(f"training set shapes {tuple(z.shape)}, {tuple(x.shape)}")
        walls.update(_sample_posterior("main", device, MODEL_FILE, prior, x_o, pulses_o, warmup, draws))
        walls["total"] = time.perf_counter() - t_all
        _log(f"[main] walls_s={json.dumps({k: round(v, 3) for k, v in walls.items()})}")
        return walls, proposal, z, x

    (walls, proposal, z, x), launches = _launches_on(
        "main", ("ddm_rt_choice", "mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY), run)
    _forward_share("main", launches, "mnle_logprob_fwd", "mnle_logprob_bwd")
    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    sample = hold_sample("main", load_model(MODEL_FILE, device=device), load_model(MODEL_FILE, device="cpu"), device)
    return {"walls": walls, "launches": launches, "proposal": proposal, "z": z, "x": x, "sample_p": sample["p"]}


def phase_pulse(device, warmup: int = SERVE_WARMUP, draws: int = PULSE_DRAWS) -> dict:
    """The pulse-grid serving path: the same observed session, the
    committed pulse-grid model loaded and sampled by the same sampler
    (K2p/K3p at every gradient); then, after the counts are read, its
    ``sample`` against the CPU's plain path (``hold_sample``)."""
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model

    def run():
        t_all = time.perf_counter()
        prior, x_o, pulses_o = _observed_session(device)
        walls = _sample_posterior("pulse", device, PULSE_MODEL_FILE, prior, x_o, pulses_o, warmup, draws)
        walls["total"] = time.perf_counter() - t_all
        _log(f"[pulse] walls_s={json.dumps({k: round(v, 3) for k, v in walls.items()})}")
        return walls

    walls, launches = _launches_on("pulse", ("mnle_pulse_fwd", "mnle_pulse_bwd", *NUTS, *DENSITY), run)
    _forward_share("pulse", launches, "mnle_pulse_fwd", "mnle_pulse_bwd")
    # The slot head's draw and the circular splines' inverse.
    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    sample = hold_sample("pulse", load_model(PULSE_MODEL_FILE, device=device),
                         load_model(PULSE_MODEL_FILE, device="cpu"), device)
    return {"walls": walls, "launches": launches, "sample_p": sample["p"]}


def phase_slice(device, warmup: int = SLICE_WARMUP, draws: int = SLICE_DRAWS) -> dict:
    """The slice path: the observed session's posterior on the committed
    flagship through ``run_inference_mcmc`` with ``MCMC_METHOD="slice"``
    (``MCMCPosterior(method="slice")``: the batched slice sampler, one K2
    launch per density evaluation of all chains, no gradient). Parallel
    tempering is NUTS-only, so the PT6 x 4 chains of the calibrated sampler
    become 24 untempered chains: each K2 launch gets the same 1,200 rows
    (24 chains x 50 trials). The grid hop and the t_nd slice move are off,
    so K3 must not launch."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.mnle import load_model, run_inference_mcmc
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    def run():
        prior, x_o, pulses_o = _observed_session(device)
        os.environ["MODEL_DIR"] = str(MODEL_DIR)
        est = load_model(MODEL_FILE, device=device)
        chains = CALIBRATED_CONFIG.NUM_CHAINS * CALIBRATED_CONFIG.MCMC_PT_REPLICAS
        cfg = CALIBRATED_CONFIG.replace(MCMC_METHOD="slice", MCMC_PT_REPLICAS=1, NUM_CHAINS=chains,
                                        MCMC_GRID_HOP=False, MCMC_TAU_SLICE=False,
                                        WARMUP_STEPS=warmup, POSTERIOR_SAMPLES=draws)
        t0 = time.perf_counter()
        samples, info = run_inference_mcmc(cfg, prior, est, x_o, pulses_o, device=device, seed=0, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if tuple(samples.shape) != (draws, 5) or not bool(torch.isfinite(prior.log_prob(samples)).all()):
            raise AssertionError(f"slice: samples of shape {tuple(samples.shape)}, or outside the prior's support")
        calls = info["potential_calls"]
        _log(f"[slice] chains={chains} rows_per_call={chains * x_o.shape[0]} "
             f"wall_s={wall:.3f} potential_calls={calls} ms_per_call={wall * 1e3 / calls:.3f} "
             f"mean_accept={float(info['accept_prob'].mean()):.3f} "
             f"median_width={[round(v, 4) for v in info['width'].median(0).values.tolist()]} "
             f"posterior_mean={[round(v, 4) for v in samples.mean(0).tolist()]}")
        return wall, calls

    (wall, calls), launches = _launches_on("slice", ("mnle_logprob_fwd", *DENSITY), run)
    if launches["mnle_logprob_bwd"] != 0 or launches["mnle_logprob_fwd"] != calls:
        raise AssertionError(f"slice: {launches['mnle_logprob_fwd']} K2 and {launches['mnle_logprob_bwd']} K3 launches "
                             f"for {calls} density evaluations (expected one K2 each, no K3)")
    return {"wall": wall, "launches": launches}


@contextlib.contextmanager
def _run_nuts_with(**options):
    """Give every ``run_nuts`` call of ``MCMCPosterior.sample`` the segment
    options ``options``; ``fault_call``, where given, makes that call's
    closed-form potential raise one ``torch.AcceleratorError`` on its
    ``fault_call``-th call. Yields the list of faults raised."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.inference import mcmc

    real, faults = mcmc.run_nuts, []
    fault_call = options.pop("fault_call", None)

    def patched(*args, **kwargs):
        vg, calls = kwargs["value_and_grad_fn"], [0]

        def faulty(u, beta, need_grad=True):
            calls[0] += 1
            if calls[0] == fault_call:
                faults.append(calls[0])
                raise torch.AcceleratorError("injected device error (chip_smoke resume phase)")
            return vg(u, beta, need_grad)

        if fault_call is not None:
            kwargs["value_and_grad_fn"] = faulty
        return real(*args, **kwargs, **options)

    mcmc.run_nuts = patched
    try:
        yield faults
    finally:
        mcmc.run_nuts = real


def _resume_run(device, **options) -> dict:
    """The flagship serving path's sampler (``run_inference_mcmc`` under
    ``CALIBRATED_CONFIG``: PT6 x 4 chains, grid hop, t_nd slice, 1,200 rows a
    K3 call) on the observed session, cut to RESUME_WARMUP / RESUME_DRAWS in
    segments of RESUME_SEGMENT transitions, trees capped at depth
    RESUME_TREE_DEPTH, with the run_nuts ``options``.
    Returns the draws, the sampler's info, the wall and what run_nuts
    printed."""
    import io

    import torch

    from sbi_for_diffusion_models_tpu_torch.mnle import load_model, run_inference_mcmc
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    prior, x_o, pulses_o = _observed_session(device)
    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    est = load_model(MODEL_FILE, device=device)
    cfg = CALIBRATED_CONFIG.replace(WARMUP_STEPS=RESUME_WARMUP, MCMC_MAX_TREE_DEPTH=RESUME_TREE_DEPTH,
                                    POSTERIOR_SAMPLES=RESUME_DRAWS * CALIBRATED_CONFIG.NUM_CHAINS)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with _run_nuts_with(segment_length=RESUME_SEGMENT, **options) as faults, contextlib.redirect_stdout(printed):
        samples, info = run_inference_mcmc(cfg, prior, est, x_o, pulses_o, device=device, seed=0, return_info=True,
                                           verbose=False)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for line in printed.getvalue().splitlines():
        _log(f"[resume]   {line}")
    return {"samples": samples, "info": info, "wall": wall, "printed": printed.getvalue(), "faults": faults}


def resume_child(ckpt_dir: str) -> int:
    """The cut run, in a process of its own: the resume phase's run with
    ``checkpoint_dir``; the parent kills it with SIGKILL partway."""
    import torch

    _resume_run(torch.device("cuda", 0), checkpoint_dir=ckpt_dir, mirror_every=1)
    return 0


def phase_resume(device) -> dict:
    """The resume path, on the flagship serving path's sampler (K2 and K3):
    (1) a reference run without a checkpoint; (2) the same run with
    ``checkpoint_dir`` in a child process, killed with SIGKILL once its
    checkpoint's ``next_segment`` reaches RESUME_CUT_AT; (3) the same call
    here, which resumes from that checkpoint, with ``device_retries=1`` and
    one ``torch.AcceleratorError`` injected into the first segment it runs
    (not a real device loss: the potential raises it), which it replays from
    the mirror. The resumed run's draws, accept probabilities, tree sizes,
    divergences, step sizes and mass matrices must equal the reference run's
    bit for bit."""
    import numpy as np
    import torch

    n_segments = -(-(RESUME_WARMUP + RESUME_DRAWS) // RESUME_SEGMENT)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = Path(tmp) / "nuts"
        ckpt_file = ckpt_dir / "nuts_segments.npz"

        def next_segment():
            with np.load(ckpt_file) as blob:
                return int(blob["next_segment"])

        def run():
            ref = _resume_run(device, mirror_every=1)
            log_path = Path(tmp) / "child.log"
            t0 = time.perf_counter()
            with open(log_path, "w") as log:
                child = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--resume-child", str(ckpt_dir)],
                                         stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
                try:
                    while not (ckpt_file.exists() and next_segment() >= RESUME_CUT_AT):
                        if child.poll() is not None or time.perf_counter() - t0 > 600:
                            raise AssertionError(f"resume: the child ended (status {child.poll()}) or took over 600 s "
                                                 f"before segment {RESUME_CUT_AT}:\n{log_path.read_text()[-4000:]}")
                        time.sleep(0.05)
                    child.kill()
                finally:
                    if child.poll() is None:
                        child.kill()
                    child.wait()
            child_wall = time.perf_counter() - t0
            cut = next_segment()
            if not RESUME_CUT_AT <= cut < n_segments:
                raise AssertionError(f"resume: the child was killed at next_segment {cut}, not inside the run")
            res = _resume_run(device, checkpoint_dir=str(ckpt_dir), mirror_every=1, device_retries=1,
                              fault_call=RESUME_FAULT_CALL)
            return ref, res, cut, child_wall

        (ref, res, cut, child_wall), launches = _launches_on(
            "resume", ("mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY), run)
        final = next_segment()
    wanted = (f"[run_nuts] resumed at segment {cut}/{n_segments}",
              f"[run_nuts] device lost near segment {cut} (AcceleratorError); waiting for recovery, then replaying "
              f"from segment {cut} (attempt 1/1)")
    missing = [w for w in wanted if w not in res["printed"]]
    if missing or res["faults"] != [RESUME_FAULT_CALL] or final != n_segments:
        raise AssertionError(f"resume: printed {res['printed']!r}, faults {res['faults']}, final checkpoint at "
                             f"segment {final}/{n_segments}; missing {missing}")
    differ = [k for k in ("accept_prob", "num_steps", "diverging", "step_size", "inv_mass")
              if not torch.equal(ref["info"][k], res["info"][k])]
    if not torch.equal(ref["samples"], res["samples"]) or differ:
        raise AssertionError(f"resume: the resumed run differs from the reference run in "
                             f"{(['samples'] if not torch.equal(ref['samples'], res['samples']) else []) + differ}")
    calls = {"reference": ref["info"]["potential_calls"], "resumed": res["info"]["potential_calls"]}
    walls = {"reference": ref["wall"], "child_until_killed": child_wall, "resumed": res["wall"]}
    _log(f"[resume] segments={n_segments} x {RESUME_SEGMENT} transitions; child killed at next_segment={cut}; "
         f"resumed at segment {cut}, 1 segment replayed after the injected error; "
         f"walls_s={json.dumps({k: round(v, 3) for k, v in walls.items()})} potential_calls={json.dumps(calls)} "
         f"ms_per_call(reference)={ref['wall'] * 1e3 / calls['reference']:.3f}; "
         f"samples, accept_prob, num_steps, diverging, step_size, inv_mass bit-equal to the reference run")
    return {"launches": launches, "walls": walls, "calls": calls, "cut": cut, "segments": n_segments}


SBC_ARTIFACTS = ("sbc_thetas_true.npy", "sbc_ranks.npy", "sbc_samples.npy", "sbc_mixing_diagnostics.npz",
                 "sbc_ranks.partial.npy", "partial_summary.json")
SBC_PLOTS = ("sbc_rank_histograms.png", "sbc_ecdf.png")


def _matplotlib_imports() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def _check_sbc_outputs(label, outdir: Path, out: dict, datasets: int, post: int) -> None:
    """``run_sbc``'s return dict and files: every .npy/.npz/.json artifact
    (the plots too where matplotlib imports), ranks in [0, post], finite
    draws inside the prior's support, the files equal to the dict."""
    import numpy as np

    wanted = SBC_ARTIFACTS + (SBC_PLOTS if _matplotlib_imports() else ())
    missing = [f for f in wanted if not (outdir / f).exists()]
    if missing:
        raise AssertionError(f"{label}: artifacts not written: {missing}")
    ranks, samples = out["ranks"], np.stack(out["all_samples"])
    if ranks.shape != (datasets, 5) or not ((ranks >= 0) & (ranks <= post)).all():
        raise AssertionError(f"{label}: ranks of shape {ranks.shape} outside [0, {post}]: {ranks.tolist()}")
    if samples.shape != (datasets, post, 5) or not np.isfinite(samples).all():
        raise AssertionError(f"{label}: pooled draws of shape {samples.shape}, or not finite")
    if not ((samples[..., [0, 4]] > 0) & (samples[..., [0, 4]] < 1)).all() or not (samples[..., 1:4] > 0).all():
        raise AssertionError(f"{label}: pooled draws outside the prior's support")
    if not (np.array_equal(np.load(outdir / "sbc_ranks.npy"), ranks)
            and np.array_equal(np.load(outdir / "sbc_samples.npy"), samples.astype(np.float32))):
        raise AssertionError(f"{label}: the written ranks or draws differ from the returned ones")


def phase_sbc(device, datasets: int = 8, warmup: int = SBC_WARMUP, post: int = SBC_DRAWS) -> dict:
    """The SBC path through ``run_sbc`` on the committed flagship under
    ``CALIBRATED_CONFIG``: ``datasets`` datasets, one group of the fold (8
    datasets x 4 chains x 6 replicas x 50 trials = 9,600 rows a potential
    call), warmup and draws cut (SBC_DRAWS draws: 10 a chain, so the mixing
    gate is active), one remediation round of up to 8 datasets. K1 must have
    launched (the datasets' sessions), K3 at the fold's 9,600 rows and no
    other count, K2 less than 5 % as often as K3. Then, after the counts are
    read: K2/K3 against their plain version and float64 on the fold's rows
    of its first gradient call (``_hold_fused``), and the fold's values and
    gradients of that call against one single-session
    ``log_lik_and_grad`` call for each dataset's 24 rows. Between the two,
    the card's busy share of a call (``_sbc_device_time``)."""
    import numpy as np
    import torch

    from sbi_for_diffusion_models_tpu_torch.inference.nuts import run_nuts
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model, run_sbc
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.potentials import ConditionedMNLELogLikelihood
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    cfg = CALIBRATED_CONFIG.replace(SBC_NUM_DATASETS=datasets, WARMUP_STEPS=warmup, SBC_POST_SAMPLES=post,
                                    SBC_REMEDIATE_ROUNDS=1, SBC_REMEDIATE_MAX=8)
    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    est = load_model(MODEL_FILE, device=device)
    prior = build_prior_theta()
    fold_rows = min(8, datasets) * cfg.NUM_CHAINS * cfg.MCMC_PT_REPLICAS * cfg.NUM_TRIALS_OBS

    # Record, without launching anything, the first gradient call of the
    # fold: its likelihood inputs and outputs (and K3's rows, _recording_k3).
    first = {}
    lik_and_grad = ConditionedMNLELogLikelihood.log_lik_and_grad

    def lik_recording(self, x, theta, need_grad=True, sessions=None):
        out = lik_and_grad(self, x, theta, need_grad, sessions)
        if need_grad and sessions is not None and "theta" not in first:
            first.update(lik=self, x=x, theta=theta.clone(), sessions=sessions, ll=out[0].clone(),
                         grad=out[1].clone())
        return out

    with tempfile.TemporaryDirectory() as tmp:
        def run():
            t0 = time.perf_counter()
            out = run_sbc(cfg, prior, est, device, outdir=tmp, seed=0)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        ConditionedMNLELogLikelihood.log_lik_and_grad = lik_recording
        try:
            with _recording_k3() as (rows_seen, k3_first):
                (out, wall), launches = _launches_on("sbc", ("ddm_rt_choice", "mnle_logprob_bwd", *NUTS, *DENSITY),
                                                     run)
        finally:
            ConditionedMNLELogLikelihood.log_lik_and_grad = lik_and_grad
        _check_sbc_outputs("sbc", Path(tmp), out, datasets, post)
        # The sampler's segment checkpoints: the run id and group 0's finished checkpoint.
        ckpt = Path(tmp) / "nuts_ckpt"
        segments = -(-(warmup + -(-post // cfg.NUM_CHAINS)) // run_nuts.__kwdefaults__["segment_length"])
        with np.load(ckpt / "group_0" / "nuts_segments.npz") as blob:
            next_segment = int(blob["next_segment"])
        if not (ckpt / "run_id.txt").is_file() or next_segment != segments:
            raise AssertionError(f"sbc: nuts_ckpt/run_id.txt missing, or group 0's checkpoint at segment "
                                 f"{next_segment}, not {segments}")
        _log(f"[sbc] nuts_ckpt/run_id.txt={(ckpt / 'run_id.txt').read_text()}; group_0/nuts_segments.npz at "
             f"segment {next_segment}/{segments}; checkpoints: {sorted(p.name for p in ckpt.iterdir())}")
    _forward_share("sbc", launches, "mnle_logprob_fwd", "mnle_logprob_bwd")
    if set(rows_seen) != {fold_rows} or len(rows_seen) != launches["mnle_logprob_bwd"]:
        raise AssertionError(f"sbc: K3 launched at {sorted(set(rows_seen))} rows ({len(rows_seen)} calls), "
                             f"expected {fold_rows} at each of {launches['mnle_logprob_bwd']}")
    rem = out["remediation"] or {}
    calls = out["potential_calls"]
    _log(f"[sbc] datasets={datasets} rows_per_call={fold_rows} wall_s={wall:.3f} potential_calls={calls} "
         f"ms_per_call={wall * 1e3 / calls:.3f} flagged={rem.get('flagged', [])} "
         f"remediation_rounds={len(rem.get('rounds', []))} still_flagged={rem.get('still_flagged', [])} "
         f"flagged_final={out['flagged_final']}")
    _log(f"[sbc] rhat_max={[round(float(v), 3) for v in out['rhat_max']]} "
         f"min_ess={[round(float(v), 1) for v in out['min_ess']]} "
         f"divergences={out['divergences_per_dataset'].tolist()} swap_accept={out['swap_accept']}")
    _log(f"[sbc] ranks={out['ranks'].tolist()}")

    _sbc_device_time(cfg, prior, est, device, wall * 1e3 / calls)

    # K2/K3 on the fold's own rows, against their plain version and float64.
    rows, w32, g = k3_first[fold_rows]
    check = _hold_fused(device, w32, *_k2k3_specs(), rows, g)

    # The fold's first gradient call against one single-session call per dataset.
    x_g, theta, sessions = first["x"], first["theta"], first["sessions"]
    s_g = first["lik"].local_theta
    # Per-row outputs of a kernel do not depend on the other rows: expect
    # equal bits; a difference is counted in ulps of the row's scale (|ll|;
    # the row's largest |grad|) and may not reach the value and gradient
    # tolerances of the row check.
    eps = torch.finfo(torch.float32).eps
    differ, worst = {"ll": 0, "grad": 0}, {"ll": 0.0, "grad": 0.0}
    for d in range(x_g.shape[0]):
        idx = torch.nonzero(sessions == d).reshape(-1)
        single = ConditionedMNLELogLikelihood(est, s_g[d], logprob_kernel=cfg.MNLE_LOGPROB_KERNEL)
        ll_d, g_d = single.log_lik_and_grad(x_g[d], theta[idx])
        for name, fold_v, single_v, scale in (
            ("ll", first["ll"][idx], ll_d, ll_d.abs()),
            ("grad", first["grad"][idx], g_d, g_d.abs().amax(-1, keepdim=True)),
        ):
            differ[name] += int((fold_v != single_v).sum())
            worst[name] = max(worst[name], float(((fold_v - single_v).abs() / (eps * scale.clamp(min=1.0))).max()))
    n_vals = {"ll": theta.shape[0], "grad": theta.numel()}
    _log(f"[sbc] the fold's first gradient call against a single-session log_lik_and_grad per dataset "
         f"({x_g.shape[0]} datasets x {theta.shape[0] // x_g.shape[0]} rows): values differing "
         f"ll={differ['ll']}/{n_vals['ll']} grad={differ['grad']}/{n_vals['grad']}; largest difference in "
         f"float32 ulps of the row's scale: ll={worst['ll']:.3f} grad={worst['grad']:.3f}")
    if worst["ll"] * eps > 1e-4 or worst["grad"] * eps > 1e-3:
        raise AssertionError(f"sbc: the fold differs from the single-session calls by {worst} ulps")
    return {"launches": launches, "wall": wall, "calls": calls, "rows": fold_rows, "check": check,
            "differ": differ, "worst_ulps": worst}


def _sbc_device_time(cfg, prior, est, device, ms_per_call: float, skip: int = 200, calls: int = 300) -> None:
    """A window of ``calls`` consecutive potential calls of a shorter
    ``run_sbc`` (the same fold of 8 datasets; warmup 2, 8 draws, no
    remediation) under ``torch.profiler``, after ``skip`` calls: the card's
    time a call, the sampler's own device work between calls included, and
    its busy share of ``ms_per_call``, the ms a call of the run that was not
    profiled. Prints; checks nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from sbi_for_diffusion_models_tpu_torch.mnle import run_sbc
    from sbi_for_diffusion_models_tpu_torch.potentials import ConditionedMNLELogLikelihood
    from sbi_for_diffusion_models_tpu_torch.utils.metrics import device_time

    lik_and_grad = ConditionedMNLELogLikelihood.log_lik_and_grad
    start, seen, window = skip + 5, [0], {}

    def ready(p):
        window.update(calls=seen[0] - start, wall=time.perf_counter() - window["t0"], device=device_time(p))

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=skip, warmup=5, active=calls, repeat=1), on_trace_ready=ready)

    def stepping(self, *a, **k):
        seen[0] += 1
        prof.step()  # the window records from call ``start`` to call ``start + calls``
        if seen[0] == start:
            window["t0"] = time.perf_counter()
        return lik_and_grad(self, *a, **k)

    short = cfg.replace(WARMUP_STEPS=2, SBC_POST_SAMPLES=8, SBC_REMEDIATE_ROUNDS=0)
    ConditionedMNLELogLikelihood.log_lik_and_grad = stepping
    try:
        with tempfile.TemporaryDirectory() as tmp, prof:
            run_sbc(short, prior, est, device, outdir=tmp, seed=1)
    finally:
        ConditionedMNLELogLikelihood.log_lik_and_grad = lik_and_grad
    device_ms, kernels = window["device"]
    n = window["calls"]
    _log(f"[sbc] {n} potential calls under torch.profiler (after {start} of {seen[0]}): "
         f"device_ms_per_call={device_ms / n:.4f} device_events_per_call={kernels / n:.1f} "
         f"ms_per_call(profiled)={window['wall'] * 1e3 / n:.3f}; device busy share of the unprofiled call "
         f"({ms_per_call:.3f} ms) = {device_ms / n / ms_per_call:.4f}")


def phase_pipeline(device) -> dict:
    """The CLI's smoke path, ``pipeline._cli(["--smoke"])`` in this process
    (simulate -> train -> save -> MCMC -> SBC on the card), with ``OUTDIR``
    and ``MODEL_DIR`` in a temporary directory. Every artifact and all five
    ``metrics.jsonl`` stages must exist; K1 and K3 must have launched. K2
    is not required: under ``SMOKE_CONFIG`` (no tempering, no t_nd slice)
    every potential call wants a gradient, the grid hop's included, so K2
    launches only if NUTS falls back to the slice sampler. Then, after the
    counts are read, K2/K3 on the model ``--smoke`` trained (log rep, no
    censoring, no cond-affine head, 64 hidden, 4 transforms): on the rows of
    the path's first K3 call at each row count (the MCMC's and the SBC
    fold's), and at 1,200 rows of prior-draw sessions, held as in
    ``phase_k2k3``."""
    import numpy as np

    from sbi_for_diffusion_models_tpu_torch import pipeline

    cfg = pipeline.SMOKE_CONFIG
    with tempfile.TemporaryDirectory() as tmp:
        out_dir, model_dir = Path(tmp) / "out", Path(tmp) / "models"
        os.environ["OUTDIR"], os.environ["MODEL_DIR"] = str(out_dir), str(model_dir)
        t0 = time.perf_counter()
        with _recording_k3() as (rows_seen, k3_first):
            result, launches = _launches_on("pipeline", ("ddm_rt_choice", "mnle_logprob_bwd", *NUTS, *DENSITY),
                                            lambda: pipeline._cli(["--smoke"]))
        wall = time.perf_counter() - t0
        records = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
        stages = {r["stage"] for r in records}
        if stages != {"simulate", "train", "mcmc", "sbc", "pipeline"}:
            raise AssertionError(f"pipeline: metrics.jsonl has the stages {sorted(stages)}")
        wanted = ("posterior_samples_theta.npy",) + (("pairplot_theta.png",) if _matplotlib_imports() else ())
        missing = [f for f in wanted if not (out_dir / f).exists()]
        if missing or not (model_dir / "mnle_rt_choice_model.npz").exists():
            raise AssertionError(f"pipeline: not written: {missing} or the model")
        samples = np.load(out_dir / "posterior_samples_theta.npy")
        if samples.shape != (cfg.POSTERIOR_SAMPLES, 5) or not np.isfinite(samples).all():
            raise AssertionError(f"pipeline: posterior samples of shape {samples.shape}, or not finite")
        _check_sbc_outputs("pipeline", out_dir, result["sbc"], cfg.SBC_NUM_DATASETS, cfg.SBC_POST_SAMPLES)
        metrics = {f"{r['stage']}/{r['name']}": round(r["value"], 3) for r in records}
        _log(f"[pipeline] --smoke wall_s={wall:.3f} metrics={json.dumps(metrics)} "
             f"sbc_potential_calls={result['sbc']['potential_calls']} "
             f"train_epochs={result['density_estimator'].train_meta['epochs_run']} "
             f"K3 calls by rows={json.dumps({n: rows_seen.count(n) for n in sorted(k3_first)})}")

        mc_ = result["density_estimator"].cfg
        width = (mc_.rt_rep, mc_.censor_rt, mc_.cond_affine, mc_.hidden_features, mc_.num_transforms)
        if width != ("log", False, False, cfg.MNLE_HIDDEN_FEATURES, cfg.MNLE_NUM_TRANSFORMS):
            raise AssertionError(f"pipeline: the trained model is not SMOKE_CONFIG's: {width}")
        checks = []
        for n in sorted(k3_first):
            rows, w32, g = k3_first[n]
            checks.append(("path", n, rows_seen.count(n), _hold_fused(device, w32, *_k2k3_specs(), rows, g)))
        at = phase_k2k3(device, sizes=(ROWS_MAIN,), model_file="mnle_rt_choice_model.npz", model_dir=model_dir)
        checks.append(("prior_sessions", ROWS_MAIN, 0, at[ROWS_MAIN]))
    return {"launches": launches, "wall": wall, "checks": checks}


def phase_k4(device) -> dict:
    """K4, both kinds, against its plain version in float64 at chains of 64
    and 1,024 steps on 32,768 values in [0.25, 1).

    fma: the kernel rounds once a step (an FMA), so it is held within
    ``fma_tolerance`` at one rounding a step, K x 2^-24 x the value, which
    every value's own movement over the chain exceeds (a chain not run
    fails); the plain float32 version rounds twice and is printed beside.
    It is also held within FUSED_ULPS ulps (of 2^-24: the values lie below
    1) of the plain chain rounded once a step (``fused=True``), from which a
    chain one turn short or long is about 21 ulps away.
    transcendental: the chain contracts towards a fixed point, so only the
    last turn's exp, log, sqrt and sin count: 8 float32 ulps (8 x 2^-23)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.ops.ceiling_cuda import (
        FUSED_ULPS,
        KINDS,
        ceiling_chain,
        ceiling_plain,
        fma_tolerance,
    )

    gen = torch.Generator(device).manual_seed(13)
    x = torch.rand((4, 64, 128), generator=gen, device=device) * 0.75 + 0.25
    max_abs = 0.0
    for kind in KINDS:
        for K in (64, 1024):
            got = ceiling_chain(x, K, kind)
            torch.cuda.synchronize()
            exact = ceiling_plain(x.double(), K, kind)
            plain = ceiling_plain(x, K, kind)
            if kind == "fma":
                tol = fma_tolerance(K, exact.abs())
                if not bool(((exact - x).abs() > tol).all()):
                    raise AssertionError(f"K4 fma K={K}: the tolerance exceeds the chain's own movement")
            else:
                tol = torch.full_like(exact, 8 * 2.0**-23)
            err = (got.double() - exact).abs()
            plain_err = (plain.double() - exact).abs()
            vs_plain = float((got - plain).abs().max())
            max_abs = max(max_abs, vs_plain)
            _log(f"[K4] {kind} K={K} n={x.numel()}: max |kernel - float64|={float(err.max()):.3e} "
                 f"(tolerance {float(tol.min()):.3e} to {float(tol.max()):.3e}, worst err/tolerance "
                 f"{float((err / tol).max()):.3f}); plain_f32 vs float64={float(plain_err.max()):.3e}; "
                 f"kernel vs plain_f32={vs_plain:.3e}")
            if not bool((err <= tol).all()) or not bool(got.isfinite().all()):
                raise AssertionError(f"K4 {kind} at K={K} differs from its float64 evaluation by "
                                     f"{float((err / tol).max()):.3f} x its tolerance")
            if kind == "fma":
                ulps = float(((got - ceiling_plain(x, K, kind, fused=True)).abs() / 2.0**-24).max())
                _log(f"[K4] fma K={K}: kernel vs the plain chain rounded once a step: {ulps:.1f} ulps of 2^-24 "
                     f"(limit {FUSED_ULPS})")
                if not ulps <= FUSED_ULPS:
                    raise AssertionError(f"K4 fma at K={K} is {ulps:.1f} ulps from the chain rounded once a step")
    return {"max_abs_err": max_abs}


def _k4_at_the_roofline_shape(device, report: dict) -> dict:
    """K4 at the shape and chain lengths the roofline path launches it with:
    (64, 256, 128) elements of 0.5, both kinds, chains of K_lo and K_hi.
    Every element runs the same chain, so the float64 evaluation of one
    element is the reference of all: the fma kind is held within
    ``fma_tolerance`` at one rounding a step, which the chain's own movement
    must exceed, and within FUSED_ULPS ulps of the plain chain rounded once a
    step (a single turn short or long fails); the transcendental kind, whose
    chain settles on a fixed point, within 8 float32 ulps. The plain float32 version runs once at the full shape for
    each kind (fma at K_hi, where it is timed; transcendental at K_lo) and
    the kernel is held to it within both sides' roundings."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.ops.ceiling_cuda import (
        FUSED_ULPS,
        KINDS,
        ceiling_chain,
        ceiling_plain,
        fma_tolerance,
    )

    x = torch.full(K4_SHAPE, 0.5, dtype=torch.float32, device=device)
    one = torch.full((1,), 0.5, dtype=torch.float64)
    max_abs, plain_ms = 0.0, None
    for kind in KINDS:
        r = report[f"issue_{kind}"]
        if r["elements"] != x.numel():
            raise AssertionError(f"roofline: K4 ran on {r['elements']} elements, the check on {x.numel()}")
        K_plain = r["K_hi"] if kind == "fma" else r["K_lo"]
        for K in (r["K_lo"], r["K_hi"]):
            got = ceiling_chain(x, K, kind)
            exact = float(ceiling_plain(one, K, kind))
            ulps = 8 * 2.0**-23
            tol = fma_tolerance(K, abs(exact)) if kind == "fma" else ulps
            if kind == "fma" and not abs(exact - 0.5) > tol:
                raise AssertionError(f"K4 fma K={K}: the tolerance exceeds the chain's own movement")
            err = float((got.double() - exact).abs().max())
            line = (f"[K4] {kind} K={K} n={x.numel()}: float64={exact:.9g} max |kernel - float64|={err:.3e} "
                    f"(tolerance {tol:.3e}, err/tolerance {err / tol:.3f})")
            ok = bool(got.isfinite().all()) and err <= tol
            if kind == "fma":
                fused = float(ceiling_plain(one.float(), K, kind, fused=True))
                ulps = float((got.double() - fused).abs().max()) / 2.0**-24
                line += f"; vs the plain chain rounded once a step: {ulps:.1f} ulps of 2^-24 (limit {FUSED_ULPS})"
                ok = ok and ulps <= FUSED_ULPS
            if K == K_plain:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                plain = ceiling_plain(x, K, kind)
                end.record()
                torch.cuda.synchronize()
                vs_plain = float((got - plain).abs().max())
                # The kernel rounds once a step and the plain version twice: three roundings between them.
                plain_tol = fma_tolerance(K, abs(exact), roundings=3) if kind == "fma" else 2 * ulps
                max_abs = max(max_abs, vs_plain)
                ok = ok and vs_plain <= plain_tol
                line += (f"; plain_f32 vs float64={float((plain.double() - exact).abs().max()):.3e}; "
                         f"kernel vs plain_f32={vs_plain:.3e} (tolerance {plain_tol:.3e})")
                if kind == "fma":
                    plain_ms = start.elapsed_time(end)
            _log(line)
            if not ok:
                raise AssertionError(f"K4 {kind} at K={K} and {x.numel()} elements differs from its float64 "
                                     f"evaluation or its plain version: {line}")
    return {"max_abs_err": max_abs, "plain_ms": plain_ms}


def phase_roofline(device) -> dict:
    """The roofline path through its entry point (``roofline.main``): K4 at
    its full shape and both chain lengths, the two ceilings, then K1 at
    524,288 trials and K2 at 65,536 rows against them. A ceiling above
    MAX_CEILING_SHARE of the datasheet's FMA rate means the chain was folded
    or the timing is wrong. After the counts are read, each kernel of the
    path is held against its plain version at the shape the path gave it:
    K4 (``_k4_at_the_roofline_shape``), K1 on the path's trials, and K2/K3
    at the path's row count on the path's model."""
    from sbi_for_diffusion_models_tpu_torch import roofline
    from sbi_for_diffusion_models_tpu_torch.ops.ceiling_cuda import KINDS

    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "roofline_h100.json"
        report, launches = _launches_on("roofline", ("issue_ceiling", "ddm_rt_choice", "mnle_logprob_fwd"),
                                        lambda: roofline.main(["--out", str(out)]))
        if json.loads(out.read_text()) != report:
            raise AssertionError("roofline: the written report differs from the returned one")
    for kind in KINDS:
        r = report[f"issue_{kind}"]
        if not (0.0 < r["share_of_datasheet_fma"] <= MAX_CEILING_SHARE):
            raise AssertionError(f"roofline: the {kind} ceiling is {r['share_of_datasheet_fma']:.3f} of the "
                                 f"datasheet's FMA rate (limit {MAX_CEILING_SHARE})")
    k4 = _k4_at_the_roofline_shape(device, report)
    _k1_against_plain("K1 roofline", *roofline.simulator_inputs(report["sim_batch"], device))
    phase_k2k3(device, sizes=(report["mnle_rows"],), model_file=report["mnle_model"])
    fma = report["issue_fma"]
    bound_ms, bound_by = _bound(2.0 * fma["elements"] * fma["K_hi"], 8 * fma["elements"])
    _log(f"[K4] time fma K={fma['K_hi']} n={fma['elements']}: kernel_ms={fma['seconds_hi'] * 1e3:.4f} "
         f"plain_ms={k4['plain_ms']:.4f} bound_ms={bound_ms:.4g} ({bound_by}, "
         f"{bound_ms / (fma['seconds_hi'] * 1e3):.3f} of it)")
    return {"report": report, "launches": launches, "ms": fma["seconds_hi"] * 1e3, "plain_ms": k4["plain_ms"],
            "max_abs_err": k4["max_abs_err"], "bound_ms": bound_ms, "bound_by": bound_by}


def _train_epoch_device_time(cfg, proposal, z, x, step_ms: float) -> None:
    """One epoch of ``train_mnle`` (its optimizer steps and one validation
    pass) under ``torch.profiler``: the card's time and device events per
    optimizer step, and the card's busy share of ``step_ms``, the ms per
    step of the run that was not profiled. Prints; checks nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import sbi_for_diffusion_models_tpu_torch as port
    from sbi_for_diffusion_models_tpu_torch.utils.metrics import device_time

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        meta = port.train_mnle(cfg.replace(TRAIN_MAX_EPOCHS=1), proposal, z, x, seed=0, verbose=False).train_meta
        torch.cuda.synchronize()
    total_ms, kernels = device_time(prof)
    steps = meta["steps_per_epoch"]
    device_ms = total_ms / steps
    _log(f"[train] one epoch under torch.profiler ({steps} steps and a validation pass): "
         f"device_ms_per_step={device_ms:.3f} device_events_per_step={kernels / steps:.0f} "
         f"ms_per_step(profiled)={meta['step_ms']:.3f}; device busy share of the unprofiled step "
         f"({step_ms:.3f} ms) = {device_ms / step_ms:.3f}")


def phase_train(device, proposal, z, x, warmup: int = TRAIN_SERVE_WARMUP, draws: int = TRAIN_SERVE_DRAWS) -> dict:
    """The training path at the flagship's full width: ``train_mnle`` on the
    simulated pairs, ``save_model``, ``load_model``, ``run_inference_mcmc``
    with the loaded model, through the public entry points; then K2/K3 on
    the trained model against their plain version at 1,200 rows (one
    leapfrog; 0.1 % of them is a single row) and at 115,200."""
    import numpy as np
    import torch

    import sbi_for_diffusion_models_tpu_torch as port
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG
    from sbi_for_diffusion_models_tpu_torch.utils.checkpoint import latest_step, restore_train_state

    cfg = CALIBRATED_CONFIG.replace(MNLE_COND_AFFINE=True, TRAIN_MAX_EPOCHS=TRAIN_EPOCHS,
                                    TRAIN_STOP_AFTER_EPOCHS=TRAIN_EPOCHS)
    model_file = "mnle_chip_smoke.npz"

    with tempfile.TemporaryDirectory() as model_dir:
        ckpt_dir = Path(model_dir) / "train_ckpt"

        def run():
            walls = {}
            t_all = time.perf_counter()
            t0 = time.perf_counter()
            est = port.train_mnle(cfg, proposal, z, x, seed=0, checkpoint_dir=str(ckpt_dir),
                                  checkpoint_every=TRAIN_CHECKPOINT_EVERY)
            torch.cuda.synchronize()
            walls["train"] = time.perf_counter() - t0
            meta = est.train_meta
            mc_ = est.cfg
            width = (mc_.rt_rep, mc_.censor_rt, mc_.cond_affine, mc_.log_condition_dims, mc_.hidden_features,
                     mc_.num_transforms, mc_.num_bins, mc_.condition_dim)
            if width != ("shifted_log", True, True, (1, 2, 3), 128, 10, 24, 85):
                raise AssertionError(f"train: not the flagship's width: {width}")
            steps = meta["epochs_run"] * meta["steps_per_epoch"]
            _log(f"[train] n={meta['num_train']} epochs={meta['epochs_run']} steps_per_epoch={meta['steps_per_epoch']} "
                 f"ms_per_optimizer_step={meta['step_ms']:.3f} ({steps} steps) train_wall_s={walls['train']:.3f}")
            _log(f"[train] train_losses={[round(v, 4) for v in meta['train_losses']]}")
            _log(f"[train] val_losses={[round(v, 4) for v in meta['val_losses']]} best={meta['best_val_loss']:.4f}")
            vl = meta["val_losses"]
            if meta["epochs_run"] != TRAIN_EPOCHS or not bool(np.isfinite(vl).all()):
                raise AssertionError(f"train: {meta['epochs_run']} epochs, validation losses {vl}")
            if not vl[-1] < vl[0] - TRAIN_MIN_DROP:
                raise AssertionError(f"train: the validation loss went from {vl[0]:.4f} to {vl[-1]:.4f}, "
                                     f"less than the {TRAIN_MIN_DROP} it must fall")

            # The checkpoints: the last epoch's is the newest, and the same call again resumes after it, runs
            # no epoch and returns its weights.
            t0 = time.perf_counter()
            last = latest_step(ckpt_dir)
            saved = restore_train_state(ckpt_dir)["params"]
            again = port.train_mnle(cfg, proposal, z, x, seed=0, checkpoint_dir=str(ckpt_dir),
                                    checkpoint_every=TRAIN_CHECKPOINT_EVERY, verbose=False)
            walls["resume"] = time.perf_counter() - t0
            state = again.net.state_dict()
            if last != TRAIN_EPOCHS - 1 or again.train_meta["epochs_run"] != 0 or not all(
                    torch.equal(v.to(device), state[k]) for k, v in saved.items()):
                raise AssertionError(f"train: newest checkpoint at epoch {last}, the resumed call ran "
                                     f"{again.train_meta['epochs_run']} epochs, or its weights are not the saved ones")
            _log(f"[train] checkpoints at epochs {sorted(int(p.name) for p in ckpt_dir.iterdir() if p.name.isdigit())}"
                 f"; the same call again resumed after epoch {last}, ran no epoch and returned the saved weights "
                 f"bit for bit ({walls['resume']:.3f} s)")

            os.environ["MODEL_DIR"] = model_dir
            t0 = time.perf_counter()
            path = port.save_model(est, cfg, model_file)
            loaded = port.load_model(model_file, device=device)
            walls["save_load"] = time.perf_counter() - t0
            if not all(torch.equal(a, b) for a, b in zip(est.net.parameters(), loaded.net.parameters())):
                raise AssertionError("train: the loaded weights differ from the saved ones")
            if any(p.requires_grad for p in loaded.net.parameters()):
                raise AssertionError("train: the loaded weights require gradients")
            with np.load(path) as data:
                fingerprint = json.loads(str(data["__meta__"]))["param_fingerprint"]
            port.save_model(loaded, cfg, "again.npz")
            with np.load(Path(model_dir) / "again.npz") as data:
                again = json.loads(str(data["__meta__"]))["param_fingerprint"]
            if fingerprint != again:
                raise AssertionError(f"train: fingerprint {fingerprint} became {again} after a reload")
            _log(f"[train] saved {path.name} ({path.stat().st_size} bytes) fingerprint={fingerprint}; reloaded bit-equal")

            prior, x_o, pulses_o = _observed_session(device)
            walls.update(_sample_posterior("train", device, model_file, prior, x_o, pulses_o, warmup, draws,
                                           model_dir=model_dir))
            walls["total"] = time.perf_counter() - t_all
            _log(f"[train] walls_s={json.dumps({k: round(v, 3) for k, v in walls.items()})}")
            return walls, meta

        (walls, meta), launches = _launches_on("train", ("mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY),
                                               run)
        _forward_share("train", launches, "mnle_logprob_fwd", "mnle_logprob_bwd")
        # After the counts are read: comparison launches do not count.
        check = phase_k2k3(device, model_file=model_file, model_dir=model_dir)
    _train_epoch_device_time(cfg, proposal, z, x, meta["step_ms"])
    return {"walls": walls, "launches": launches, "train_meta": meta, "check": check}

def _sample_conditions(device, n_cond: int = 64, seed: int = 17):
    """``n_cond`` conditions (a prior draw of theta and a +-1 stimulus each)
    on the card, for the sampling checks."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import generate_pulse_matrix
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    gen = make_generator(seed, device)
    return torch.cat([build_prior_theta().sample(gen, (n_cond,)), generate_pulse_matrix(gen, n_cond, 80)], -1)


def draws_p_values(a, b, censored) -> dict:
    """Two samples of (rt, choice) draws: the chi-square test's p on the
    choice counts, and a two-sample KS test's on the RTs of each choice
    (not the censored one, a constant) that both have over 20 draws of."""
    import numpy as np
    from scipy import stats

    counts = np.array([[np.sum(d[:, 1] == c) for c in range(3)] for d in (a, b)])
    seen = counts.sum(0) > 0
    p = {"choice": float(stats.chi2_contingency(counts[:, seen])[1]) if seen.sum() > 1 else 1.0}
    for c in range(3):
        if c != censored and counts[:, c].min() > 20:
            p[f"rt|{c}"] = float(stats.ks_2samp(a[a[:, 1] == c, 0], b[b[:, 1] == c, 0]).pvalue)
    return p


def hold_sample(label, est, est_cpu, device) -> dict:
    """``sample`` on the card (SAMPLE_CARD draws) against the port's plain
    path on the CPU (SAMPLE_CPU draws of ``est_cpu``, the same model loaded
    there) at the same 64 conditions, by ``draws_p_values`` (each p >=
    P_MIN); every draw finite, censored draws at T_MAX, and the card's
    draws' log-probs finite. Returns the card's draws, their conditions, the
    p-values and the card's ms for the draw."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.constants import T_MAX

    cond = _sample_conditions(device)
    card_cond = cond.repeat(SAMPLE_CARD // cond.shape[0], 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draws = est.sample(5, card_cond)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    cpu = est_cpu.sample(6, cond.cpu().repeat(SAMPLE_CPU // cond.shape[0], 1))
    cfg = est.cfg
    censored = cfg.censored_category if cfg.censor_rt else None
    p = draws_p_values(draws.cpu().numpy(), cpu.numpy(), censored)
    finite = bool(torch.isfinite(draws).all()) and bool(torch.isfinite(est.log_prob(draws, card_cond)).all())
    at_t_max = censored is None or bool((draws[draws[:, 1] == censored, 0] == T_MAX).all())
    shares = [round(float((draws[:, 1] == c).double().mean()), 4) for c in range(3)]
    _log(f"[{label}] sample: {SAMPLE_CARD} draws on the card in {ms:.3f} ms against {SAMPLE_CPU} of the plain path "
         f"on the CPU at 64 conditions: p={json.dumps({k: round(v, 4) for k, v in p.items()})} (limit {P_MIN}); "
         f"choice shares (card)={shares}; finite draws and log-probs={finite}; censored at T_MAX={at_t_max}")
    if min(p.values()) < P_MIN or not finite or not at_t_max:
        raise AssertionError(f"{label}: the card's draws differ from the plain path's, or are not finite: {p}")
    return {"draws": draws, "cond": card_cond, "p": p, "ms": ms}


def _closed_form_against_autograd(label, est, x_o, pulses_o, prior, device) -> dict:
    """One ``log_lik_and_grad`` call (K3 per member) at 24 prior thetas on
    the observed session against autograd of ``log_lik_fn`` through the
    fused ``autograd.Function`` (K2 forward, K3 backward): the value to
    1e-4 and each row's gradient to 1e-3 x max(1, its largest |ref|)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.potentials import ConditionedMNLELogLikelihood
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    theta = prior.sample(make_generator(19, device), (24,))
    lik = ConditionedMNLELogLikelihood(est, pulses_o, logprob_kernel="pallas")
    ll, g = lik.log_lik_and_grad(x_o, theta)
    th = theta.clone().requires_grad_(True)
    ll_auto = lik.log_lik_fn(est.params, x_o, th)
    (g_auto,) = torch.autograd.grad(ll_auto.sum(), th)
    ll_auto = ll_auto.detach()
    err_v = float(((ll - ll_auto).abs() / ll_auto.abs().clamp(min=1.0)).max())
    err_g = float(((g - g_auto).abs().amax(1) / g_auto.abs().amax(1).clamp(min=1.0)).max())
    _log(f"[{label}] closed-form log_lik_and_grad against autograd of log_lik_fn at 24 thetas: value rel err="
         f"{err_v:.3e} (limit 1e-4), gradient rel err per row={err_g:.3e} (limit 1e-3)")
    if not (err_v <= 1e-4 and err_g <= 1e-3 and bool(torch.isfinite(g).all())):
        raise AssertionError(f"{label}: the closed-form gradient differs from autograd ({err_v}, {err_g})")
    return {"value_rel_err": err_v, "grad_rel_err": err_g}


def _counting_likelihood_calls():
    """Wraps ``ConditionedMNLELogLikelihood``'s ``log_lik_and_grad`` to count
    its gradient and value-only calls, and ``log_lik_fn`` (the value of the
    sampler's start and of the potential's own calls, through the fused
    ``autograd.Function``'s forward) to count its calls; returns (counts,
    restore)."""
    from sbi_for_diffusion_models_tpu_torch.potentials import ConditionedMNLELogLikelihood

    real, real_fn = ConditionedMNLELogLikelihood.log_lik_and_grad, ConditionedMNLELogLikelihood.log_lik_fn
    counts = {"grad": 0, "value": 0, "log_lik_fn": 0}

    def counted(self, x, theta, need_grad=True, sessions=None):
        counts["grad" if need_grad else "value"] += 1
        return real(self, x, theta, need_grad, sessions)

    def counted_fn(self, *args, **kwargs):
        counts["log_lik_fn"] += 1
        return real_fn(self, *args, **kwargs)

    ConditionedMNLELogLikelihood.log_lik_and_grad = counted
    ConditionedMNLELogLikelihood.log_lik_fn = counted_fn

    def restore():
        ConditionedMNLELogLikelihood.log_lik_and_grad = real
        ConditionedMNLELogLikelihood.log_lik_fn = real_fn

    return counts, restore


def _fused_rows(check: dict, D: int) -> dict:
    """The K2 and K3 entries of a row check (``phase_k2k3``'s result) for
    the ``kernels`` line: per row count, the context width D, the error and
    the times."""
    timed = ("ms", "plain_ms", "bound_ms", "bound_by")
    return {k: [{"n": n, "D": D, "max_abs_err": c[k]["max_abs_err"], **dict(zip(timed, c[k]["times"]))}
                for n, c in sorted(check.items())] for k in ("K2", "K3")}


def phase_sharp(device) -> dict:
    """The tail-sharp path on the committed ``SHARP_MODEL_FILE`` (shifted-log
    RT, k = 1.5): the observed session's posterior by the calibrated
    sampler (PT6 x 4 chains, grid hop, t_nd slice) at NEW_WARMUP / NEW_DRAWS
    draws a chain, trees capped at NEW_TREE_DEPTH (K2 and K3 launched; at
    this depth the value-only calls are a large share, as on the resume
    path). Then, after the counts are read: K2/K3 on the model's
    rows at 1,200 and 9,600 against float64 (``phase_k2k3``), the
    closed-form gradient against autograd, ``sample`` on the card against
    the CPU's plain path, and ``tail_sharp_inverse``'s round trip on the
    card's draws."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import tail_sharp_inverse, tail_sharp_transform

    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    est = load_model(SHARP_MODEL_FILE, device=device)

    def run():
        prior, x_o, pulses_o = _observed_session(device)
        walls = _sample_posterior("sharp", device, None, prior, x_o, pulses_o, NEW_WARMUP,
                                  NEW_DRAWS * 4, est=est, max_depth=NEW_TREE_DEPTH)
        return walls, prior, x_o, pulses_o

    (walls, prior, x_o, pulses_o), launches = _launches_on(
        "sharp", ("mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY), run)
    rows = phase_k2k3(device, sizes=(ROWS_MAIN, ROWS_FOLD), model_file=SHARP_MODEL_FILE)
    grad = _closed_form_against_autograd("sharp", est, x_o, pulses_o, prior, device)
    sample = hold_sample("sharp", est, load_model(SHARP_MODEL_FILE, device="cpu"), device)

    # The Newton inverse on the card's draws: t (the standardized
    # coordinate of each draw) against tail_sharp_inverse(tail_sharp_transform(t)).
    cfg = est.cfg
    draws, cond = sample["draws"], sample["cond"]
    live = draws[:, 1] != cfg.censored_category
    t = (torch.log(draws[live, 0] - cond[live, cfg.tnd_index]) - est.x_mean) / est.x_std
    back = tail_sharp_inverse(cfg, tail_sharp_transform(cfg, t)[0])
    err = float(((back - t).abs() / t.abs().clamp(min=1.0)).max())
    _log(f"[sharp] tail_sharp_inverse round trip on the card's {int(live.sum())} draws that are not censored: "
         f"max |t - inverse(phi(t))| / max(1, |t|) = {err:.3e} (limit 1e-4); t in [{float(t.min()):.3f}, "
         f"{float(t.max()):.3f}], c = {cfg.tail_sharp_c:.4f}")
    if not err <= 1e-4:
        raise AssertionError(f"sharp: tail_sharp_inverse round trip off by {err}")
    return {"walls": walls, "launches": launches, "rows": _fused_rows(rows, 85), "grad": grad,
            "sample_p": sample["p"], "inverse_err": err}


def _float64_copy(est):
    """The estimator with its network and stats in float64 (a copy)."""
    import copy

    import torch

    out = copy.deepcopy(est)
    out.net.double()
    for name in ("cond_mean", "cond_std", "x_mean", "x_std"):
        setattr(out, name, getattr(out, name).to(torch.float64))
    return out


def _hold_mixture(ens, prior, device) -> dict:
    """The ensemble's rows through its members' fused paths (one K2 each)
    at 1,200 rows of one session, against the float64 log-mean-exp of the
    members' float64 rows, each row to 1e-4 x max(1, |ref|) plus twice its
    spread where steep (``ops/rowcheck``), with the members' plain float32
    rows mixed beside. The committed members are log-rep models without
    censoring, trained with the censored trials pinned at 8 s: on the
    session's censored rows their float32 evaluation, the plain version's
    as well, can be off float64 by far more than their input spread. So
    the kernel's rows may exceed their allowance on as large a share as
    the plain float32 version's do, and on 0.1 % otherwise; the worst row
    as ``row_check`` limits it. Then times."""
    import math

    import torch

    from sbi_for_diffusion_models_tpu_torch.ops.rowcheck import MAX_OVER_SHARE, reference, row_check

    (xr, cr), = _session_pairs(prior, device, 1)
    fused, plain = ens.dispatch_log_prob("pallas"), ens.dispatch_log_prob("xla")
    with torch.no_grad():
        kern, plain_v = fused(xr, cr), plain(xr, cr)
        members64 = [_float64_copy(m) for m in ens.members]
        choice = xr[:, 1].double()

        def run(rt, cond, g):
            x = torch.stack([rt, choice], -1)
            lps = torch.stack([m.log_prob_fn(m.net, x, cond) for m in members64])
            return (torch.logsumexp(lps, 0) - math.log(len(members64)),)

        ref, spread = reference(run, (xr[:, 0], cr), torch.zeros_like(xr[:, 0]), (1,))
        c = row_check(kern, plain_v, ref[0], spread[0], value=True)
        limit = max(MAX_OVER_SHARE, c.plain_share)
        r = c.worst_row
        _log(f"[ensemble] mixture n={xr.shape[0]}: rows over their allowance kernel={c.share:.3e} "
             f"({int(c.over.sum())} rows: {torch.nonzero(c.over).reshape(-1).tolist()[:8]}) plain_f32="
             f"{c.plain_share:.3e} (limit {limit:.3e}); worst err/allowance kernel={c.worst:.3f} plain_f32="
             f"{c.plain_worst:.3f} (limit {c.limit:.3f}) at row {r} (x {xr[r].tolist()}: kernel {float(kern[r]):.7g} "
             f"plain_f32 {float(plain_v[r]):.7g} float64 {float(ref[0][r]):.7g}); steep rows: {c.steep}; kernel rel "
             f"err on the other rows={c.flat_err:.3e}")
        if not (bool(torch.isfinite(kern).all()) and c.share <= limit and c.worst <= c.limit):
            raise AssertionError(f"ensemble: the mixture's rows fail their float64 check ({c.share:.3e} over, "
                                 f"worst {c.worst:.3f})")
        k_ms = _time_ms(lambda: fused(xr, cr), 20, device)
        p_ms = _time_ms(lambda: plain(xr, cr), 20, device)
    _log(f"[ensemble] mixture rows n={xr.shape[0]}: fused (3 K2 and the outer terms) {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return {"max_abs_err": float((kern - plain_v).abs().max()), "ms": k_ms, "plain_ms": p_ms}


def phase_ensemble(device) -> dict:
    """The ensemble path: ``load_ensemble`` of ENSEMBLE_FILES (three
    committed full-width log-rep models of one config) and the observed
    session's posterior by the calibrated sampler at the sharp path's cut.
    Each potential call launches one kernel per member: K3 three times a
    gradient call, K2 three times a value-only call or a ``log_lik_fn``
    call (checked against the calls counted). Then, after the counts are read: the mixture's rows
    against float64 (``_hold_mixture``), the closed-form gradient against
    autograd, and ``sample`` against the CPU's plain path."""
    from sbi_for_diffusion_models_tpu_torch.mnle import load_ensemble

    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    ens = load_ensemble(",".join(ENSEMBLE_FILES), device=device)
    K = len(ens)

    def run():
        prior, x_o, pulses_o = _observed_session(device)
        counts, restore = _counting_likelihood_calls()
        try:
            walls = _sample_posterior("ensemble", device, None, prior, x_o, pulses_o, NEW_WARMUP, NEW_DRAWS * 4,
                                      est=ens, max_depth=NEW_TREE_DEPTH)
        finally:
            restore()
        return walls, counts, prior, x_o, pulses_o

    (walls, counts, prior, x_o, pulses_o), launches = _launches_on(
        "ensemble", ("mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY), run)
    _log(f"[ensemble] {K} members; log_lik_and_grad calls: {counts['grad']} with the gradient, {counts['value']} "
         f"value-only; log_lik_fn calls: {counts['log_lik_fn']}; K3 launches={launches['mnle_logprob_bwd']} K2 "
         f"launches={launches['mnle_logprob_fwd']} ({K} a call)")
    value_calls = counts["value"] + counts["log_lik_fn"]
    if launches["mnle_logprob_bwd"] != K * counts["grad"] or launches["mnle_logprob_fwd"] != K * value_calls:
        raise AssertionError(f"ensemble: not {K} launches a call: {launches}, calls {counts}")
    mixture = _hold_mixture(ens, prior, device)
    grad = _closed_form_against_autograd("ensemble", ens, x_o, pulses_o, prior, device)
    sample = hold_sample("ensemble", ens, load_ensemble(list(ENSEMBLE_FILES), device="cpu"), device)
    return {"walls": walls, "launches": launches, "calls": counts, "mixture": mixture, "grad": grad,
            "sample_p": sample["p"]}


def phase_embed(device, proposal, z, x) -> dict:
    """The pulse-embedding path: ``train_mnle`` under ``CALIBRATED_CONFIG``
    with MNLE_EMBED_DIM = EMBED_DIM in "append" mode (context width 85 + 32
    + 6 = 123) for EMBED_EPOCHS epochs on the main path's 131,072 pairs,
    ``save_model`` / ``load_model`` bit for bit, the observed session's
    posterior at the sharp path's cut, and one value-only call of a
    "replace"-mode network (context width 43) that ``train_mnle`` builds
    from the same proposal without training (K2 once). Then, after the
    counts are read: K2/K3 at width 123 against float64 at 1,200 and 9,600
    rows (``phase_k2k3``), the replace-mode call against the plain path,
    and the closed-form gradient against autograd."""
    import torch

    import sbi_for_diffusion_models_tpu_torch as port
    from sbi_for_diffusion_models_tpu_torch.potentials import ConditionedMNLELogLikelihood
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    cfg = CALIBRATED_CONFIG.replace(MNLE_EMBED_DIM=EMBED_DIM, MNLE_EMBED_MODE="append", TRAIN_MAX_EPOCHS=EMBED_EPOCHS,
                                    TRAIN_STOP_AFTER_EPOCHS=EMBED_EPOCHS)
    model_file = "mnle_chip_embed.npz"
    with tempfile.TemporaryDirectory() as model_dir:
        def run():
            t0 = time.perf_counter()
            est = port.train_mnle(cfg, proposal, z, x, seed=0, verbose=False)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            mc_, meta = est.cfg, est.train_meta
            if (mc_.pulse_dim, mc_.embed_dim, mc_.embed_mode, mc_.context_dim) != (80, EMBED_DIM, "append", 123):
                raise AssertionError(f"embed: not the append-mode embedding of width 123: {mc_}")
            if meta["epochs_run"] != EMBED_EPOCHS or not all(map(math.isfinite, meta["val_losses"])):
                raise AssertionError(f"embed: {meta['epochs_run']} epochs, validation losses {meta['val_losses']}")
            _log(f"[embed] trained {meta['epochs_run']} epochs x {meta['steps_per_epoch']} steps in {train_s:.3f} s "
                 f"(ms_per_optimizer_step={meta['step_ms']:.3f}) val_losses={[round(v, 4) for v in meta['val_losses']]}")
            os.environ["MODEL_DIR"] = model_dir
            port.save_model(est, cfg, model_file)
            loaded = port.load_model(model_file, device=device)
            same = all(torch.equal(a, b) for a, b in zip(est.net.state_dict().values(),
                                                          loaded.net.state_dict().values()))
            if not same or loaded.cfg != est.cfg:
                raise AssertionError("embed: the loaded weights or config differ from the saved ones")
            _log("[embed] save_model -> load_model: config and weights bit-equal")
            prior, x_o, pulses_o = _observed_session(device)
            walls = _sample_posterior("embed", device, None, prior, x_o, pulses_o, NEW_WARMUP, NEW_DRAWS * 4,
                                      est=loaded, max_depth=NEW_TREE_DEPTH)
            walls["train"] = train_s
            replace = port.train_mnle(cfg.replace(MNLE_EMBED_MODE="replace", TRAIN_MAX_EPOCHS=0), proposal, z, x,
                                      seed=1, verbose=False)
            theta = prior.sample(make_generator(23, device), (24,))
            lik = ConditionedMNLELogLikelihood(replace, pulses_o, logprob_kernel="pallas")
            value = lik.log_lik_and_grad(x_o, theta, need_grad=False)[0]
            return walls, loaded, replace, prior, x_o, pulses_o, theta, value

        (walls, est, replace, prior, x_o, pulses_o, theta, value), launches = _launches_on(
            "embed", ("mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY), run)
        rows = phase_k2k3(device, sizes=(ROWS_MAIN, ROWS_FOLD), model_file=model_file, model_dir=model_dir)
    D = replace.net.cat_net.layers[0].in_features
    plain = ConditionedMNLELogLikelihood(replace, pulses_o, logprob_kernel="xla").log_lik_fn(replace.params, x_o, theta)
    err = float(((value - plain).abs() / plain.abs().clamp(min=1.0)).max())
    _log(f"[embed] replace mode (context width {D}): one value-only call (K2 at {theta.shape[0] * x_o.shape[0]} rows) "
         f"against the plain path: rel err={err:.3e} (limit 1e-4)")
    if D != 43 or not err <= 1e-4:
        raise AssertionError(f"embed: the replace-mode call (D={D}) differs from the plain path by {err}")
    grad = _closed_form_against_autograd("embed", est, x_o, pulses_o, prior, device)
    return {"walls": walls, "launches": launches, "rows": _fused_rows(rows, 123), "grad": grad,
            "replace_rel_err": err}


def _k1_sigma_by_trial(device, kernel, plain, n: int) -> dict:
    """Each trial's own sigma: sigma_i drawn from SIGMA_LEVELS at random per
    trial, ``n`` trials (more than the launch's groups hold, so groups
    refill); ``kernel(mu, seed)`` and ``plain(mu, seed)`` simulate them. The rows at each level must have the scalar launch's bits at
    that level with the same seed (a trial's noise depends only on the
    seed, the trial and the step), and the rows at 0 the noise-free plain
    scan's. A trial that took another trial's sigma, or kept its group's
    previous one, differs from its own level's launch wherever the two
    levels give other outputs (``distinguishable``: the share of rows whose
    scalar launches at their own and the next level differ)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import K1_LAST_LAUNCH, K1_THREADS
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    levels = torch.tensor(SIGMA_LEVELS, device=device)
    level = torch.randint(0, len(SIGMA_LEVELS), (n,), generator=make_generator(37, device), device=device)
    got = kernel(levels[level], 9)
    groups = K1_LAST_LAUNCH["blocks"] * K1_THREADS // K1_LAST_LAUNCH["G"]
    scalar = [kernel(float(v), 9) for v in SIGMA_LEVELS]
    differing = {str(v): int((got[level == k] != scalar[k][level == k]).any(1).sum())
                 for k, v in enumerate(SIGMA_LEVELS)}
    zero = level == SIGMA_LEVELS.index(0.0)
    zero_plain = int((got[zero] != plain(0.0, 2)[zero]).any(1).sum())
    other = torch.stack(scalar)[(level + 1) % len(SIGMA_LEVELS), torch.arange(n, device=device)]
    own = torch.stack(scalar)[level, torch.arange(n, device=device)]
    distinguishable = float((own != other).any(1).double().mean())
    _log(f"[variants K1 per-trial sigma] sigma_i from {SIGMA_LEVELS} per trial, n={n} on {groups} groups "
         f"(G={K1_LAST_LAUNCH['G']}): rows differing from the scalar launch at their level={differing}, "
         f"sigma_i=0 rows differing from the plain scan={zero_plain}; distinguishable={distinguishable:.4f}")
    if groups >= n:
        raise AssertionError(f"variants: {n} trials on {groups} groups: no group refilled; raise n")
    if any(differing.values()) or zero_plain:
        raise AssertionError(f"variants: K1's per-trial sigma is not each trial's own: {differing}, {zero_plain}")
    if not distinguishable > 0.02:
        raise AssertionError(f"variants: the levels give the same rows ({distinguishable}): the check sees nothing")
    return {"n": n, "groups": groups, "rows_differing": differing, "zero_rows_differing_from_plain": zero_plain,
            "distinguishable": distinguishable}


def phase_k1_sigma(device, n: int = VARIANT_K1_N, n_max: int = 1_600, spp: int = 200, seed: int = 29) -> dict:
    """K1's per-trial noise-scale instances against the plain scan repaired
    for an (N,) ``mu_sensory``, at ``n`` prior draws on an ``n_max``-step
    window: with sigma = 0 for every trial bit for bit (and equal to the
    scalar launch at 0); with sigma_i drawn from [0.5, 1.5] the same
    distribution (chi-square on the choices, KS on RT per choice, p >
    P_MIN); with sigma_i all equal to 1 the scalar launch's bits; and at
    N_SIM trials, each trial's sigma its own (``_k1_sigma_by_trial``).
    Then the per-trial launch's time beside the scalar one's at ``n``."""
    import numpy as np
    import torch
    from scipy import stats

    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import generate_pulse_matrix
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_rt_choice_scan
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    gen = make_generator(seed, device)
    theta_all = build_prior_theta().sample(gen, (N_SIM,))
    s_all = generate_pulse_matrix(gen, N_SIM, n_max // spp)
    theta, s = theta_all[:n], s_all[:n]
    sigma = 0.5 + torch.rand((n,), generator=gen, device=device)
    kw = dict(steps_per_pulse=spp, n_max=n_max)

    def kernel(mu, sd):
        return ddm_rt_choice_cuda(theta, s, sd, mu_sensory=mu, **kw)

    def plain(mu, sd):
        return ddm_rt_choice_scan(theta, s, sd, mu_sensory=mu, chunk_steps=spp, **kw)

    zero = torch.zeros((n,), device=device)
    a, b, c = kernel(zero, 1), plain(zero, 2), kernel(0.0, 3)
    zero_diff = int((a != b).any(1).sum())
    zero_scalar_diff = int((a != c).any(1).sum())
    ones = torch.ones((n,), device=device)
    uniform_diff = int((kernel(ones, 5) != kernel(1.0, 5)).any(1).sum())
    an, bn = kernel(sigma, 11).cpu().numpy(), plain(sigma, 12).cpu().numpy()
    counts = np.array([[np.sum(x[:, 1] == k) for k in range(3)] for x in (an, bn)])
    seen = counts.sum(0) > 0
    chi2_p = float(stats.chi2_contingency(counts[:, seen])[1]) if seen.sum() > 1 else 1.0
    ks_p = [float(stats.ks_2samp(an[an[:, 1] == k, 0], bn[bn[:, 1] == k, 0]).pvalue)
            for k in (0, 1) if counts[:, k].min() > 0]
    _log(f"[variants K1 per-trial sigma] n={n} window={n_max}: sigma=0 rows differing from the plain scan="
         f"{zero_diff}, from the scalar launch at 0={zero_scalar_diff}; sigma_i=1 rows differing from the scalar "
         f"launch at 1={uniform_diff}; sigma_i in [0.5, 1.5]: choice counts kernel={counts[0].tolist()} "
         f"plain={counts[1].tolist()} chi2_p={chi2_p:.4g} ks_p(rt|choice)={[round(p, 4) for p in ks_p]}")
    if zero_diff or zero_scalar_diff or uniform_diff:
        raise AssertionError(f"variants: K1's per-trial sigma differs without noise ({zero_diff}, "
                             f"{zero_scalar_diff}) or at uniform sigma ({uniform_diff})")
    if min([chi2_p] + ks_p) <= P_MIN:
        raise AssertionError(f"variants: K1's per-trial sigma and the plain scan differ in distribution")
    by_trial = _k1_sigma_by_trial(
        device,
        lambda mu, sd: ddm_rt_choice_cuda(theta_all, s_all, sd, mu_sensory=mu, **kw),
        lambda mu, sd: ddm_rt_choice_scan(theta_all, s_all, sd, mu_sensory=mu, chunk_steps=spp, **kw), N_SIM)
    # The per-trial instance against the scalar one on the same work (sigma_i = 1: the same bits), in turns
    # (scalar, per-trial, per-trial, scalar, twice; the median of each side); then the per-trial launch at the
    # varied sigma_i.
    order = "sppsspps"
    turns = [_time_ms(lambda: kernel(1.0 if side == "s" else ones, 3), 50, device) for side in order]
    scalar_ms = float(np.median([t for t, side in zip(turns, order) if side == "s"]))
    k_ms = float(np.median([t for t, side in zip(turns, order) if side == "p"]))
    varied_ms = _time_ms(lambda: kernel(sigma, 3), 50, device)
    p_ms = _time_ms(lambda: plain(ones, 4), 1, device)
    b_ms, b_by, steps = k1_bound(theta, kernel(ones, 3), n_max // spp)
    _log(f"[variants K1 per-trial sigma] time n={n} window={n_max} at sigma_i = 1 in turns ({order}: s scalar, "
         f"p per-trial) {[round(t, 4) for t in turns]}: medians kernel_ms={k_ms:.4f} scalar_ms={scalar_ms:.4f} "
         f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4g} ({b_by}) executed_trial_steps={steps}; at sigma_i in "
         f"[0.5, 1.5]: kernel_ms={varied_ms:.4f}")
    return {"n": n, "n_max": n_max, "max_abs_err": float((a - b).abs().max()), "ms": k_ms,
            "scalar_ms": scalar_ms, "varied_sigma_ms": varied_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "steps": steps, "chi2_p": chi2_p, "ks_p": ks_p, "zero_sigma_rows_differing": zero_diff,
            "by_trial": by_trial}


def phase_variants(device) -> dict:
    """The choice-only and 7-parameter simulators: ``ddm_choice_scan`` at the
    SNPE example's shape, as the example calls it (VARIANT_THETAS thetas x
    VARIANT_REPS trials at n_max 4,000, t_max 2 s; one pass, then with two
    resample passes, each timed, with its share of -1), the entry point
    ``choice_model_simulator_torch`` on the same trials at its own (the JAX
    function's) grid, the same two ways, and
    ``simulate_session_data_7p`` for one session of VARIANT_7P_TRIALS trials
    (K1's per-trial noise-scale instances). K1 must have launched. Then,
    after the counts are read, K1's per-trial noise scale against the plain
    scan (``phase_k1_sigma``)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.distributions import BoxUniform
    from sbi_for_diffusion_models_tpu_torch.models import choice_model_simulator_torch
    from sbi_for_diffusion_models_tpu_torch.models.pulse_ddm_7p import simulate_session_data_7p
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_choice_scan
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = fn()
        torch.cuda.synchronize()
        return x, (time.perf_counter() - t0) * 1e3

    def run():
        prior = BoxUniform(SNPE_LO, SNPE_HI)
        theta = prior.sample(make_generator(0, device), (VARIANT_THETAS,)).repeat_interleave(VARIANT_REPS, 0)
        out = {}
        ddm_choice_scan(theta[:VARIANT_REPS], 0, **CHOICE_GRID)  # warm-up: the launch shape's query
        for label, passes in (("one_pass", 0), ("resampled", 2)):
            x, ms = timed(lambda: ddm_choice_scan(theta, 1, max_resamples=passes, **CHOICE_GRID))
            if tuple(x.shape) != (theta.shape[0],) or not set(x.unique().tolist()) <= {-1, 0, 1}:
                raise AssertionError(f"variants: choice scan gave {tuple(x.shape)}, {x.unique().tolist()}")
            out[label] = {"ms": ms, "invalid_share": float((x < 0).double().mean())}
        for label, resample in (("entry_point_one_pass", False), ("entry_point_resampled", True)):
            x, ms = timed(lambda: choice_model_simulator_torch(theta, 1, resample_invalid=resample, max_resamples=2))
            if tuple(x.shape) != (theta.shape[0], 1) or x.dtype != torch.float32 or \
                    not set(x.unique().tolist()) <= {-1.0, 0.0, 1.0}:
                raise AssertionError(f"variants: choice simulator gave {tuple(x.shape)} {x.dtype}, "
                                     f"{x.unique().tolist()}")
            out[label] = {"ms": ms, "invalid_share": float((x < 0).double().mean())}
        _log(f"[variants] ddm_choice_scan {theta.shape[0]} trials ({VARIANT_THETAS} thetas x {VARIANT_REPS}) at "
             f"{json.dumps(CHOICE_GRID)}, then choice_model_simulator_torch on them at its default grid (8 s), each "
             f"with no and with two resample passes: {json.dumps(out)}")
        for first in ("one_pass", "entry_point_one_pass"):
            if not out[first.replace("one_pass", "resampled")]["invalid_share"] <= out[first]["invalid_share"]:
                raise AssertionError(f"variants: the resample passes left more invalid trials: {out}")
        theta7 = torch.tensor([0.5, 0.3, 1.5, 8.0, 1.0, 0.1, 0.5], device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x7 = simulate_session_data_7p(theta7, VARIANT_7P_TRIALS, 2)
        torch.cuda.synchronize()
        out["session_7p"] = {"ms": (time.perf_counter() - t0) * 1e3,
                             "choice_shares": [round(float((x7[:, 1] == k).double().mean()), 4) for k in range(3)]}
        if tuple(x7.shape) != (VARIANT_7P_TRIALS, 2) or not bool(torch.isfinite(x7).all()):
            raise AssertionError(f"variants: 7-parameter session {tuple(x7.shape)}, finite "
                                 f"{bool(torch.isfinite(x7).all())}")
        _log(f"[variants] simulate_session_data_7p {VARIANT_7P_TRIALS} trials: {json.dumps(out['session_7p'])}")
        return out

    out, launches = _launches_on("variants", ("ddm_rt_choice",), run)
    return {"launches": launches, "choice": out, "k1_sigma": phase_k1_sigma(device)}


def _hierarchical_setup(device):
    """The coverage configuration's data (``artifacts/hierarchical_coverage_pt_a.json``):
    its model file loaded, the hyperprior moment-matched, and HIER_B datasets
    of its subjects x trials drawn from the exact hyperprior (hyper_shrink 1)
    and simulated on K1."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.models.hierarchical import (
        HierarchicalModel,
        simulate_hierarchical_sessions,
    )
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    conf = json.loads((ROOT / "artifacts" / "hierarchical_coverage_pt_a.json").read_text())
    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    est = load_model(conf["model_file"], device=device)
    prior = build_prior_theta()
    model = HierarchicalModel.from_prior(prior, device=device)
    sims = [simulate_hierarchical_sessions(prior, conf["subjects"], conf["trials"], model=model,
                                           seed=conf["seed"] + 1000 + r, hyper_shrink=1.0)
            for r in range(conf["reps"])]
    xs, ps = torch.stack([s[1] for s in sims]), torch.stack([s[2] for s in sims])
    return conf, est, prior, model, xs, ps


HIER_SEED = 2000


def _run_hierarchical(device, mesh=None) -> tuple:
    """``run_hierarchical_inference`` at the coverage configuration
    (``_hierarchical_setup``), warmup HIER_WARMUP, HIER_DRAWS draws a chain,
    trees capped at HIER_TREE_DEPTH, on ``mesh`` or unsharded; returns the
    setup, the output and the sampler's seconds."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.models.hierarchical import run_hierarchical_inference

    conf, est, prior, model, xs, ps = _hierarchical_setup(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_hierarchical_inference(est, prior, xs, ps, model=model, num_chains=conf["chains"],
                                     num_warmup=HIER_WARMUP, num_samples=HIER_DRAWS,
                                     max_tree_depth=HIER_TREE_DEPTH, pt_replicas=conf["pt_replicas"],
                                     pt_beta_min=conf["pt_beta_min"], segment_length=8, seed=HIER_SEED, mesh=mesh,
                                     verbose=mesh is None)
    torch.cuda.synchronize()
    return (conf, est, prior, model, xs, ps), out, time.perf_counter() - t0


def phase_hierarchical(device) -> dict:
    """The hierarchical path at the repo's coverage configuration
    (``artifacts/hierarchical_coverage_pt_a.json``: ``mnle_1m_censor.npz``,
    4 datasets x 4 subjects x 20 trials, 4 chains x 6 rungs, all datasets in
    one sampler launch): ``simulate_hierarchical_sessions`` (K1) and
    ``run_hierarchical_inference``, depth cut to warmup HIER_WARMUP,
    HIER_DRAWS draws a chain, trees capped at HIER_TREE_DEPTH. Every K3
    launch must hold the fold's B*C*R*S*T = 7,680 rows. Then, after the
    counts are read: K2/K3 on the rows of the first K3 call against their
    plain version and float64 (``_hold_fused``), and the fold's first
    value-and-gradient call (closed form around one K3 launch) against
    autograd through the plain row function (``logprob_kernel="xla"``):
    each row's value to 1e-4 and its gradient to 1e-3 x max(1, its largest
    |ref|)."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.distributions import mcmc_transform
    from sbi_for_diffusion_models_tpu_torch.inference.nuts import geometric_ladder
    from sbi_for_diffusion_models_tpu_torch.models.hierarchical import _hierarchical_density
    from sbi_for_diffusion_models_tpu_torch.utils.rng import child_seed, make_generator

    seed = HIER_SEED
    with _recording_k3() as (rows_seen, k3_first):
        ((conf, est, prior, model, xs, ps), out, wall), launches = _launches_on(
            "hierarchical", ("ddm_rt_choice", "mnle_logprob_bwd", *NUTS), lambda: _run_hierarchical(device))
    if any(launches[k] for k in DENSITY):
        raise AssertionError(f"hierarchical: the u-space density's pair launched on a path with a density of its "
                             f"own: {[launches[k] for k in DENSITY]}")
    B, S, T = xs.shape[:3]
    C, R = conf["chains"], conf["pt_replicas"]
    rows = B * C * R * S * T
    calls = out["info"]["potential_calls"]
    theta = out["theta_subjects"]
    _log(f"[hierarchical] B={B} S={S} T={T} chains={C} rungs={R}: rows_per_K3={rows} wall_s={wall:.3f} "
         f"potential_calls={calls} ms_per_call={wall * 1e3 / calls:.3f} K3_launches={launches['mnle_logprob_bwd']} "
         f"K2_launches={launches['mnle_logprob_fwd']} swap_accept={out['swap_accept']:.3f} "
         f"mean_accept={float(out['info']['accept_prob'].mean()):.3f} "
         f"divergences={int(out['info']['diverging'].sum())}")
    if set(rows_seen) != {rows} or len(rows_seen) != launches["mnle_logprob_bwd"]:
        raise AssertionError(f"hierarchical: K3 launched at {sorted(set(rows_seen))} rows, expected {rows}")
    if theta.shape != (B, C * HIER_DRAWS, S, 5) or out["raw"].shape[:3] != (B, C, HIER_DRAWS):
        raise AssertionError(f"hierarchical: output shapes {theta.shape}, {out['raw'].shape}")
    if not bool(torch.isfinite(prior.log_prob(torch.from_numpy(theta.reshape(-1, 5)))).all()):
        raise AssertionError("hierarchical: subject draws outside the prior's support")
    k3_rows, w32, g = k3_first[rows]
    check = _hold_fused(device, w32, *_k2k3_specs(), k3_rows, g)

    # The fold's first call: the sampler's starting rows, as run_hierarchical_inference makes them.
    bij = mcmc_transform(prior)
    D, dim = model.theta_dim, model.dim(S)
    center = torch.cat([model.mu_loc, model.log_tau_loc, torch.zeros(S * D, device=device)])
    scale = torch.cat([model.mu_scale, model.log_tau_scale, torch.ones(S * D, device=device)])
    q = center + 0.1 * scale * torch.randn((B * C * R, dim), generator=make_generator(child_seed(seed, 0), device),
                                           device=device)
    data = (torch.arange(B, device=device).repeat_interleave(C * R),
            torch.as_tensor(geometric_ladder(R, conf["pt_beta_min"]), device=device).repeat(B * C))
    _, _, vg = _hierarchical_density(model, bij, est, xs, ps)
    value, grad = vg(q, data)
    logp_plain, _, none = _hierarchical_density(model, bij, est, xs, ps, logprob_kernel="xla")
    q_ = q.clone().requires_grad_(True)
    v_auto = logp_plain(q_, data)
    (g_auto,) = torch.autograd.grad(v_auto.sum(), q_)
    v_auto = v_auto.detach()
    err_v = float(((value - v_auto).abs() / v_auto.abs().clamp(min=1.0)).max())
    err_g = float(((grad - g_auto).abs().amax(1) / g_auto.abs().amax(1).clamp(min=1.0)).max())
    _log(f"[hierarchical] the fold's first value-and-gradient call ({B * C * R} rows x {S} subjects, closed form "
         f"around one K3 launch) against autograd through the plain row function: value rel err={err_v:.3e} "
         f"(limit 1e-4), gradient rel err per row={err_g:.3e} (limit 1e-3)")
    if none is not None or not (err_v <= 1e-4 and err_g <= 1e-3 and bool(torch.isfinite(grad).all())):
        raise AssertionError(f"hierarchical: the fold's closed form differs from autograd ({err_v}, {err_g})")
    return {"launches": launches, "wall": wall, "calls": calls, "rows": rows, "check": check,
            "value_rel_err": err_v, "grad_rel_err": err_g}


def phase_k1_offset(device, n: int = N_SIM, blocks: int = MD_RANKS, seed: int = 41) -> dict:
    """K1's trial offset, in this process: ``n`` prior draws with noise
    launched as ``blocks`` equal blocks (as the ranks of a sharded run
    launch them) and as a ragged split, each block with its trial offset,
    against one launch over all of them: 0 rows may differ. Then the K1
    fixture's refilling case with an explicit offset of 0: the parent's
    bits."""
    import functools

    import numpy as np
    import torch

    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import (
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
    )
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    n_max, spp = pulse_schedule()
    gen = make_generator(seed, device)
    theta = build_prior_theta().sample(gen, (n,))
    s = generate_pulse_matrix(gen, n, n_pulses_max_from_schedule(n_max, spp))
    whole = ddm_rt_choice_cuda(theta, s, seed, n_max=n_max, steps_per_pulse=spp)
    differing = {}
    for name, cuts in (("equal", [n * k // blocks for k in range(blocks + 1)]), ("ragged", [0, 1, 1000, 77_777, n])):
        got = torch.cat([ddm_rt_choice_cuda(theta[lo:hi].contiguous(), s[lo:hi].contiguous(), seed, n_max=n_max,
                                            steps_per_pulse=spp, trial_offset=lo, n_total=n)
                         for lo, hi in zip(cuts[:-1], cuts[1:])])
        differing[name] = int((got != whole).any(1).sum())
        _log(f"[K1 offset] n={n} in blocks {cuts}, each from its trial offset: rows differing from one launch = "
             f"{differing[name]}")
    fixture = _k1_fixture()
    case = "kw_n300000_c0"
    got = fixture.run(functools.partial(ddm_rt_choice_cuda, trial_offset=0), fixture.CASES[case], device)
    differing["fixture_offset_0"] = int((got.cpu().numpy() != fixture.load()[case]).any(1).sum())
    _log(f"[K1 offset] the fixture's {case} at trial_offset=0: rows differing from the parent K1 = "
         f"{differing['fixture_offset_0']}")
    if any(differing.values()):
        raise AssertionError(f"K1's trial offset: rows differ {differing}")
    return differing


def _md_sbc(device, mesh, outdir) -> tuple:
    """The multi-device phase's SBC fold (``run_sbc`` on the flagship under
    ``CALIBRATED_CONFIG``: 8 datasets, warmup MD_WARMUP, MD_DRAWS draws,
    trees capped at MD_TREE_DEPTH), on ``mesh`` or unsharded; returns
    (pooled draws (8, MD_DRAWS, 5), potential calls, seconds)."""
    import numpy as np
    import torch

    from sbi_for_diffusion_models_tpu_torch.mnle import load_model, run_sbc
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.run_config import CALIBRATED_CONFIG

    cfg = CALIBRATED_CONFIG.replace(SBC_NUM_DATASETS=8, WARMUP_STEPS=MD_WARMUP, SBC_POST_SAMPLES=MD_DRAWS,
                                    MCMC_MAX_TREE_DEPTH=MD_TREE_DEPTH)
    os.environ["MODEL_DIR"] = str(MODEL_DIR)
    est = load_model(MODEL_FILE, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_sbc(cfg, build_prior_theta(), est, device, outdir=outdir, seed=13, verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    return np.stack(out["all_samples"]), out["potential_calls"], time.perf_counter() - t0


def _md_inputs(device) -> tuple:
    """(theta, stimulus, n_max, steps_per_pulse): the multi-device paths'
    K1 batch, N_SIM prior draws made from seed 41 on ``device``."""
    from sbi_for_diffusion_models_tpu_torch.models.rt_choice_model import (
        generate_pulse_matrix,
        n_pulses_max_from_schedule,
        pulse_schedule,
    )
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    n_max, spp = pulse_schedule()
    gen = make_generator(41, device)
    theta = build_prior_theta().sample(gen, (N_SIM,))
    return theta, generate_pulse_matrix(gen, N_SIM, n_pulses_max_from_schedule(n_max, spp)), n_max, spp


def md_rank(outdir: str) -> dict:
    """One rank of a multi-device world (gloo ranks sharing the card, or
    NCCL ranks one a card): K1 at N_SIM trials in the ranks' blocks
    (``sharded_simulate``), the SBC fold of ``_md_sbc`` and the hierarchical
    fold of ``_run_hierarchical`` split over the ranks, and
    ``dryrun_multichip``; returns the rank's launches and times, and rank 0
    the gathered outputs."""
    import torch
    import torch.distributed as dist

    from sbi_for_diffusion_models_tpu_torch.graft_entry import dryrun_multichip
    from sbi_for_diffusion_models_tpu_torch.ops import ceiling_cuda, mnle_cuda, nuts_cuda  # noqa: F401 (every count)
    from sbi_for_diffusion_models_tpu_torch.ops._cuda import KERNELS
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda
    from sbi_for_diffusion_models_tpu_torch.parallel.mesh import default_mesh, sharded_simulate

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device())  # NCCL's ranks: each its own card
    r, world = dist.get_rank(), dist.get_world_size()
    t_start = time.perf_counter()
    for k in KERNELS.values():
        k.launches = 0
    theta, s, n_max, spp = _md_inputs(device)
    mesh = default_mesh(world, "data")
    t0 = time.perf_counter()
    x = sharded_simulate(ddm_rt_choice_cuda, theta, s, 41, mesh=mesh, n_max=n_max, steps_per_pulse=spp)
    torch.cuda.synchronize()
    k1_s = time.perf_counter() - t0
    chains = default_mesh(world, "chains")
    draws, calls, wall = _md_sbc(device, chains, outdir)
    _, hier, hier_s = _run_hierarchical(device, chains)
    dry = dryrun_multichip(world, device=device)
    launches = {name: k.launches for name, k in KERNELS.items()}
    out = {"rank": r, "card": torch.cuda.get_device_name(device), "launches": launches, "k1_s": k1_s, "sbc_s": wall,
           "calls": calls, "ms_per_call": wall * 1e3 / calls, "hier_s": hier_s,
           "hier_calls": hier["info"]["potential_calls"], "dryrun": dry, "seconds": time.perf_counter() - t_start}
    if r == 0:
        out.update(k1=x.cpu().numpy(), draws=draws, hier=hier["raw"])
    return out


def phase_multidevice(device) -> dict:
    """Multi-device (``parallel/``) on the cards this host has.

    (a) A world of one rank under NCCL in this process (a ``FileStore`` in a
    temporary directory, no port): ``dryrun_multichip(1)``, the SBC fold of
    ``_md_sbc`` through ``run_sbc(mesh=...)`` and the hierarchical fold
    through ``run_hierarchical_inference(mesh=...)``, whose draws must equal
    the unsharded calls' bit for bit, and ``phase_k1_offset``. (b) MD_RANKS
    ranks started with a deadline (``launch_local``): over NCCL, one rank a
    card, where the host has MD_RANKS cards, else sharing the card over
    gloo (NCCL refuses two ranks on one card). Each rank runs K1 at N_SIM
    trials with noise in its block, 0 rows of which may differ from one
    unsharded launch; the same SBC fold, 2,400 rows a rank, and the same
    hierarchical fold, a quarter of its replica groups a rank, each compared
    with the unsharded run (bit for bit, or the largest difference and the
    first transition that differs, printed); and
    ``dryrun_multichip(MD_RANKS)``, the 2 x 2 TP step included. K1, K2 and
    K3 must have launched on the sharded paths (the unsharded reference runs
    are not counted); the launches are summed over the ranks. One card shows
    NCCL's communicator and the sharded code paths, not scaling over
    several GPUs."""
    import torch
    import torch.distributed as dist

    from sbi_for_diffusion_models_tpu_torch.graft_entry import dryrun_multichip
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda
    from sbi_for_diffusion_models_tpu_torch.parallel.mesh import default_mesh
    from sbi_for_diffusion_models_tpu_torch.parallel.multihost import init_group

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref, ref_calls, ref_wall = _md_sbc(device, None, os.path.join(tmp, "ref"))
        _log(f"[multidevice] unsharded SBC fold: 8 datasets x 4 chains x 6 rungs, warmup {MD_WARMUP}, "
             f"{MD_DRAWS // 4} draws a chain, depth <= {MD_TREE_DEPTH}: potential_calls={ref_calls} "
             f"wall_s={ref_wall:.3f} ms_per_call={ref_wall * 1e3 / ref_calls:.3f}")
        _, hier_out, hier_wall = _run_hierarchical(device)
        hier_ref, hier_calls = hier_out["raw"], hier_out["info"]["potential_calls"]
        _log(f"[multidevice] unsharded hierarchical fold (the coverage configuration, warmup {HIER_WARMUP}, "
             f"{HIER_DRAWS} draws a chain, depth <= {HIER_TREE_DEPTH}): potential_calls={hier_calls} "
             f"wall_s={hier_wall:.3f}")

        # (a) A world of one under NCCL.
        t0 = time.perf_counter()
        init_group(1, 0, store=dist.FileStore(os.path.join(tmp, "store"), 1), device=device)
        _log(f"[multidevice] NCCL world of one: backend={dist.get_backend()} rank={dist.get_rank()} "
             f"world={dist.get_world_size()} init_s={time.perf_counter() - t0:.3f}")

        def run_a():
            dry = dryrun_multichip(1)
            mesh = default_mesh(1, "chains")
            return dry, _md_sbc(device, mesh, os.path.join(tmp, "one")), _run_hierarchical(device, mesh)

        try:
            (dry1, (one, one_calls, one_wall), (_, hier_one, hier_one_wall)), launches_a = _launches_on(
                "multidevice (a)", (), run_a)
            offset = phase_k1_offset(device)
        finally:
            dist.destroy_process_group()
        one_differ = int((one != ref).sum())
        hier_one_differ = int((hier_one["raw"] != hier_ref).sum())
        _log(f"[multidevice] (a) run_sbc(mesh=<NCCL world of one>) against the unsharded call: values differing "
             f"{one_differ}/{ref.size}; potential_calls={one_calls} wall_s={one_wall:.3f} "
             f"ms_per_call={one_wall * 1e3 / one_calls:.3f}; run_hierarchical_inference(mesh=<NCCL world of one>) "
             f"against the unsharded call: values differing {hier_one_differ}/{hier_ref.size}, potential_calls="
             f"{hier_one['info']['potential_calls']} wall_s={hier_one_wall:.3f}; dryrun_multichip(1)={dry1}")
        if one_differ or one_calls != ref_calls or hier_one_differ:
            raise AssertionError(f"multidevice: the NCCL world of one gave other draws (SBC {one_differ} values, "
                                 f"hierarchical {hier_one_differ}) or calls ({one_calls} against {ref_calls})")

        # (b) MD_RANKS ranks: one a card over NCCL where there are enough cards, else sharing the card over gloo.
        backend = "nccl" if torch.cuda.device_count() >= MD_RANKS else "gloo"
        theta, s, n_max, spp = _md_inputs(device)
        whole = ddm_rt_choice_cuda(theta, s, 41, n_max=n_max, steps_per_pulse=spp).cpu().numpy()
        ranks, checked = _md_ranks("(b)", MD_RANKS, backend, (ref, hier_ref), whole, os.path.join(tmp, "ranks"))
    launches = {k: launches_a[k] + sum(res["launches"][k] for res in ranks) for k in launches_a}
    _log(f"[multidevice] launches, (a) and every rank of (b): {json.dumps(launches)}; the ranks started and "
         f"finished in {checked['spawn_s']:.3f} s; phase {time.perf_counter() - t_phase:.1f} s")
    missing = [k for k in ("ddm_rt_choice", "mnle_logprob_fwd", "mnle_logprob_bwd", *NUTS, *DENSITY)
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the multidevice path: {missing}")
    return {"launches": launches, "k1_offset": offset, "sbc_one_differing": one_differ,
            "hierarchical_one_differing": hier_one_differ, **checked, "seconds": time.perf_counter() - t_phase}


def _held_to(label: str, what: str, got, ref, per_chain: int, chain_of) -> int:
    """Prints whether the sharded run's draws ``got`` equal the unsharded
    ``ref`` (else how many values differ, the largest difference and the
    first draw that differs: ``chain_of`` maps an index of ``got`` to
    (chain, draw)); returns the number of values that differ."""
    import numpy as np

    bad = np.argwhere(got != ref)
    if bad.size == 0:
        _log(f"[multidevice] {label} {what} against the unsharded call: bit for bit ({got.size} values)")
    else:
        first = min(chain_of(tuple(b))[1] for b in bad)
        _log(f"[multidevice] {label} {what} against the unsharded call: {len(bad)}/{got.size} values differ, "
             f"largest difference {float(np.abs(got - ref).max()):.6g}, first differing transition: draw {first} of "
             f"{per_chain} (after the warmup)")
    if not np.isfinite(got).all():
        raise AssertionError(f"multidevice: non-finite draws in {what}")
    return int(len(bad))


def _md_ranks(label: str, n: int, backend: str, refs, whole, outdir: str) -> tuple:
    """``md_rank`` on ``n`` new ranks (``launch_local``, with a deadline):
    gloo ranks share the card, NCCL ranks take one card each. Fails unless
    K1's blocks give ``whole`` (one launch) bit for bit; prints whether the
    SBC fold's and the hierarchical fold's draws equal the unsharded
    ``refs`` (else the largest difference and the first transition that
    differs) and each rank's launches and ms a call. Returns (the ranks'
    results, the checks)."""
    from sbi_for_diffusion_models_tpu_torch.parallel.multihost import launch_local

    t0 = time.perf_counter()
    ranks = launch_local(md_rank, n, (outdir,), device="cuda", backend=backend, timeout_s=MD_DEADLINE_S)
    spawn_s = time.perf_counter() - t0
    for res in ranks:
        _log(f"[multidevice] {label} rank {res['rank']}/{n} ({backend}, {res['card']}): "
             f"launches={json.dumps(res['launches'])} k1_s={res['k1_s']:.4f} sbc_s={res['sbc_s']:.3f} "
             f"potential_calls={res['calls']} ms_per_call={res['ms_per_call']:.3f} hier_s={res['hier_s']:.3f} "
             f"hier_calls={res['hier_calls']} rank_s={res['seconds']:.3f} dryrun={res['dryrun']}")
    k1_differ = int((ranks[0]["k1"] != whole).any(1).sum())
    _log(f"[multidevice] {label} K1 at {N_SIM} trials with noise in {n} blocks, one a rank, each from its trial "
         f"offset: rows differing from one unsharded launch = {k1_differ}")
    if k1_differ:
        raise AssertionError(f"multidevice: the ranks' K1 blocks differ from one launch on {k1_differ} rows")
    sbc_ref, hier_ref = refs
    # The pooled SBC draws: row k * 4 + c is draw k of chain c. The hierarchical draws: (dataset, chain, draw, dim).
    sbc_bad = _held_to(label, f"SBC fold on {n} ranks ({9_600 // n:,} rows a rank)", ranks[0]["draws"], sbc_ref,
                       MD_DRAWS // 4, lambda b: (b[1] % 4, b[1] // 4))
    hier_bad = _held_to(label, f"hierarchical fold on {n} ranks", ranks[0]["hier"], hier_ref, HIER_DRAWS,
                        lambda b: (b[1], b[2]))
    if len({(res["calls"], res["hier_calls"]) for res in ranks}) != 1:
        raise AssertionError("multidevice: the ranks made different numbers of calls")
    return ranks, {"k1_blocks_differing": k1_differ, "sbc_ranks_differing": sbc_bad,
                   "hierarchical_ranks_differing": hier_bad, "backend": backend, "spawn_s": spawn_s,
                   "ms_per_call_by_rank": [res["ms_per_call"] for res in ranks]}


def phase_snpe(device) -> dict:
    """SNPE and SNLE at the example's shape (``examples/snpe_snle_choice_model.py``):
    the BoxUniform prior, SNPE_THETAS thetas, x the mean choice over
    VARIANT_REPS trials of the choice-only simulator (K1) at n_max 4,000,
    t_max 2 s, two resample passes; ``train_snpe`` and ``train_snle`` with
    their epochs capped at SNPE_EPOCHS; ``DirectPosterior.sample`` of
    SNPE_DRAWS draws, every one inside the prior's support; and a short
    ``make_posterior(x_o)`` NUTS run (4 chains, warmup SNPE_WARMUP,
    SNPE_CHAIN_DRAWS draws a chain, trees capped at depth 6). K1 must have
    launched."""
    import torch

    from sbi_for_diffusion_models_tpu_torch.distributions import BoxUniform
    from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_choice_scan
    from sbi_for_diffusion_models_tpu_torch.run_config import RUN_CONFIG_PARAMS
    from sbi_for_diffusion_models_tpu_torch.snpe import train_snle, train_snpe
    from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

    cfg = RUN_CONFIG_PARAMS.replace(TRAIN_MAX_EPOCHS=SNPE_EPOCHS, TRAIN_STOP_AFTER_EPOCHS=12, TRAIN_BATCH_SIZE=1024,
                                    NUM_CHAINS=4, WARMUP_STEPS=SNPE_WARMUP, MCMC_MAX_TREE_DEPTH=6)

    def run():
        walls = {}
        prior = BoxUniform(SNPE_LO, SNPE_HI)
        t0 = time.perf_counter()
        theta = prior.sample(make_generator(0, device), (SNPE_THETAS,))
        choices = ddm_choice_scan(theta.repeat_interleave(VARIANT_REPS, 0), 1, max_resamples=2, **CHOICE_GRID)
        x = choices.reshape(SNPE_THETAS, VARIANT_REPS).to(torch.float32).mean(1, keepdim=True)
        theta_true = torch.tensor([0.5, 0.3, 1.5, 8.0, 0.1], device=device)
        x_o = ddm_choice_scan(theta_true.repeat(VARIANT_REPS, 1), 2, max_resamples=2,
                              **CHOICE_GRID).to(torch.float32).reshape(1, VARIANT_REPS).mean(1, keepdim=True)
        torch.cuda.synchronize()
        walls["simulate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        post = train_snpe(cfg, prior, theta, x, seed=3)
        walls["train_snpe"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        draws = post.sample((SNPE_DRAWS,), x_o[0], seed=4)
        torch.cuda.synchronize()
        walls["sample_snpe"] = time.perf_counter() - t0
        inside = bool(torch.isfinite(prior.log_prob(draws)).all())
        t0 = time.perf_counter()
        flow, make_posterior = train_snle(cfg, prior, theta, x, seed=5)
        walls["train_snle"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        nle = make_posterior(x_o).sample((4 * SNPE_CHAIN_DRAWS,), seed=6)
        torch.cuda.synchronize()
        walls["mcmc_snle"] = time.perf_counter() - t0
        metas = {"snpe": post.flow.train_meta, "snle": flow.train_meta}
        _log(f"[snpe] x_o={float(x_o[0, 0]):.4f} walls_s={json.dumps({k: round(v, 3) for k, v in walls.items()})}")
        for name, m in metas.items():
            _log(f"[snpe] {name}: epochs={m['epochs']} steps_per_epoch={m['steps_per_epoch']} "
                 f"train_ms_per_step={m['step_ms']:.3f} val_losses(first, best, last)="
                 f"{[round(m['val_losses'][0], 4), round(m['best_val_loss'], 4), round(m['val_losses'][-1], 4)]}")
        _log(f"[snpe] SNPE posterior mean={[round(v, 4) for v in draws.mean(0).tolist()]} draws inside the prior's "
             f"support={inside}; SNLE posterior mean={[round(v, 4) for v in nle.mean(0).tolist()]}")
        if tuple(draws.shape) != (SNPE_DRAWS, 5) or not inside:
            raise AssertionError(f"snpe: {tuple(draws.shape)} draws, all inside the prior's support: {inside}")
        if tuple(nle.shape) != (4 * SNPE_CHAIN_DRAWS, 5) or not bool(torch.isfinite(prior.log_prob(nle)).all()):
            raise AssertionError(f"snpe: the SNLE posterior's draws {tuple(nle.shape)} are not all in the support")
        for name, m in metas.items():
            if not m["best_val_loss"] < m["val_losses"][0]:
                raise AssertionError(f"snpe: {name}'s validation loss never fell below its first epoch's: {m}")
        return {"walls": walls, "step_ms": {k: m["step_ms"] for k, m in metas.items()}}

    out, launches = _launches_on("snpe", ("ddm_rt_choice", *NUTS), run)
    return {"launches": launches, **out}


def measured_bounds(kernels: list, report: dict) -> None:
    """Add ``measured_bound_ms`` to every kernel of the line, and to its
    entry at the other size (``large``; K4's ``short_chain``): its
    operations over the issue rates K4 measured in this run
    (``roofline.main``'s report) instead of the datasheet's. The fused
    kernels' FLOP are FMAs, two each, at the fma ceiling; K1's executed steps
    take their FMA-class operations at the fma ceiling and their special
    functions at the transcendental-mix ceiling, as ``roofline.py`` states its
    demand."""
    from sbi_for_diffusion_models_tpu_torch.roofline import K1_FMA_CLASS_OPS, K1_TRANSCENDENTAL_CLASS_OPS

    fma, tra = report["issue_fma"]["ops_per_s"], report["issue_transcendental"]["ops_per_s"]
    for k in kernels:
        for at in (k, k.get("large"), k.get("fold"), k.get("short_chain"), k.get("per_trial_sigma"),
                   k.get("hierarchical"), *k.get("pipeline", ()), *k.get("sharp", ()), *k.get("embed", ())):
            if at is None:
                continue
            if k["name"] == "ddm_rt_choice":
                at["measured_bound_ms"] = at["steps"] * (K1_FMA_CLASS_OPS / fma + K1_TRANSCENDENTAL_CLASS_OPS / tra) * 1e3
            elif at["bound_by"] == "operations":
                at["measured_bound_ms"] = at["bound_ms"] * (FP32_OPS_PER_S / 2.0) / fma
            else:  # bytes: no issue rate enters
                at["measured_bound_ms"] = at["bound_ms"]
            _log(f"[ceilings] {k['name']}{'' if at is k else ' ' + str(at.get('n', at.get('K')))}: "
                 f"kernel_ms={at['ms']:.4f} datasheet_bound_ms={at['bound_ms']:.4g} "
                 f"({at['bound_ms'] / at['ms']:.4f} of the kernel's time) "
                 f"measured_bound_ms={at['measured_bound_ms']:.4g} ({at['measured_bound_ms'] / at['ms']:.4f})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/csrc not found next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--resume-child"]:
        return resume_child(sys.argv[2])
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _log(f"[device] torch={torch.__version__} cuda={torch.version.cuda} device={name} ({smi})")

    t_start = time.perf_counter()
    ptxas = phase_build()
    k1 = phase_k1(device, N_SIM)
    k23 = phase_k2k3(device)
    k23p = phase_k2pk3p(device)
    k4 = phase_k4(device)
    roof = phase_roofline(device)
    leaf = phase_leaf(device)
    density = phase_density(device)
    main_path = phase_main(device)
    pulse_path = phase_pulse(device)
    slice_path = phase_slice(device)
    resume = phase_resume(device)
    train_path = phase_train(device, main_path["proposal"], main_path["z"], main_path["x"])
    sbc = phase_sbc(device)
    pipe = phase_pipeline(device)
    sharp = phase_sharp(device)
    ens = phase_ensemble(device)
    emb = phase_embed(device, main_path["proposal"], main_path["z"], main_path["x"])
    variants = phase_variants(device)
    hier = phase_hierarchical(device)
    snpe = phase_snpe(device)
    multi = phase_multidevice(device)
    _log(f"[time] whole script after start-up: {time.perf_counter() - t_start:.1f} s")

    src = f"{PKG}/csrc"
    jax_ops = "sbi_for_diffusion_models_tpu/ops"
    fused = {**k23[ROWS_MAIN], **k23p[ROWS_MAIN]}
    fused_large = {**k23[ROWS_SBC], **k23p[ROWS_SBC]}
    k1_large = k1["times"][N_SIM]
    kernels = [{
        "name": "ddm_rt_choice", "route": "cuda", "source": f"{src}/ddm_rt_choice.cu",
        "replaces": f"{jax_ops}/ddm_pallas.py:60", "launches": main_path["launches"]["ddm_rt_choice"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None, "steps": k1["steps"],
        "launch_shape": k1["launch_shape"],
        "large": {"n": N_SIM, "ms": k1_large[0], "plain_ms": k1_large[1], "bound_ms": k1_large[2],
                  "bound_by": k1_large[3], "steps": k1_large[4]},
        # The per-trial noise-scale instances (the 7-parameter model's sigma_a) on a 1,600-step window.
        "per_trial_sigma": {k: v for k, v in variants["k1_sigma"].items() if k not in ("chi2_p", "ks_p")},
    }]
    for kname, label, f, rep, path in (
        ("mnle_logprob_fwd", "K2", "mnle_logprob.cu", "mnle_pallas.py:269", main_path),
        ("mnle_logprob_bwd", "K3", "mnle_logprob.cu", "mnle_pallas.py:275", main_path),
        ("mnle_pulse_fwd", "K2p", "mnle_pulse.cu", "mnle_pallas.py:333", pulse_path),
        ("mnle_pulse_bwd", "K3p", "mnle_pulse.cu", "mnle_pallas.py:361", pulse_path),
    ):
        ms, plain_ms, bound_ms, bound_by = fused[label]["times"]
        timed = ("ms", "plain_ms", "bound_ms", "bound_by")
        large = dict(zip(timed, fused_large[label]["times"]))
        kernels.append({
            "name": kname, "route": "cuda", "source": f"{src}/{f}", "replaces": f"{jax_ops}/{rep}",
            "launches": path["launches"][kname], "max_abs_err": fused[label]["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "large": {"n": ROWS_SBC, **large},
        })
        if label in sbc["check"]:  # the SBC fold's launch shape, on its own rows
            kernels[-1]["fold"] = {"n": sbc["rows"], "launches": sbc["launches"][kname],
                                   "max_abs_err": sbc["check"][label]["max_abs_err"],
                                   **dict(zip(timed, sbc["check"][label]["times"]))}
            # The model --smoke trained: the CLI path's rows (K3's launches at each count) and prior sessions.
            kernels[-1]["pipeline"] = [
                {"n": n, "rows": kind, **({"launches": k3_calls} if label == "K3" else {}),
                 "max_abs_err": c[label]["max_abs_err"], **dict(zip(timed, c[label]["times"]))}
                for kind, n, k3_calls, c in pipe["checks"]]
            # The tail-sharp model's rows, and the embedded model's at context width 123.
            kernels[-1]["sharp"], kernels[-1]["embed"] = sharp["rows"][label], emb["rows"][label]
            # The hierarchical fold's rows (B x C x R x S x T), on the coverage configuration's model.
            kernels[-1]["hierarchical"] = {"n": hier["rows"], "launches": hier["launches"][kname],
                                           "max_abs_err": hier["check"][label]["max_abs_err"],
                                           **dict(zip(timed, hier["check"][label]["times"]))}
    # The fused kernels' tile height, as the source they were built from defines it, and ptxas's report of each
    # build (K1: of each instance, G lanes a trial with or without the collapsing bound); a spill fails the run.
    tile_rows = int(re.search(r"#define TILE_ROWS (\d+)", (ROOT / src / "mnle_tile.cuh").read_text())[1])
    for k in kernels:
        found = {e: v for e, v in ptxas.items() if f"{k['name']}_kernel" in e}
        if k["name"] == "ddm_rt_choice":
            k["ptxas"] = {}
            for e, v in found.items():
                m = re.search(r"ddm_rt_choice_kernelILi(\d+)ELb([01])ELb([01])E", e)
                k["ptxas"][f"G{m[1]}" + ("_collapse" if m[2] == "1" else "") + ("_sig_rows" if m[3] == "1" else "")
                           if m else e] = v
        elif k["name"].startswith("mnle_"):
            if len(found) != 1:
                raise AssertionError(f"ptxas reported {len(found)} builds of {k['name']}, expected one: {sorted(ptxas)}")
            k["rows_per_block"], k["ptxas"] = tile_rows, next(iter(found.values()))
        else:
            continue
        for v in found.values():
            if v.get("spill_stores", 0) or v.get("spill_loads", 0):
                raise AssertionError(f"{k['name']} spills registers: {found}")
    if len(kernels[0]["ptxas"]) != 12:
        raise AssertionError(f"ptxas reported {len(kernels[0]['ptxas'])} K1 instances, expected 12: {sorted(ptxas)}")
    fma = roof["report"]["issue_fma"]
    kernels.append({
        "name": "issue_ceiling", "route": "cuda", "source": f"{src}/issue_ceiling.cu",
        "replaces": "benchmarks/roofline.py:105", "launches": roof["launches"]["issue_ceiling"],
        "max_abs_err": max(k4["max_abs_err"], roof["max_abs_err"]), "ms": roof["ms"], "plain_ms": roof["plain_ms"],
        "bound_ms": roof["bound_ms"], "bound_by": roof["bound_by"], "library_ms": None,
        "kinds": {kind: roof["report"][f"issue_{kind}"] for kind in ("fma", "transcendental")},
        "short_chain": {"K": fma["K_lo"], "ms": fma["seconds_lo"] * 1e3,
                        **dict(zip(("bound_ms", "bound_by"), _bound(2.0 * fma["elements"] * fma["K_lo"],
                                                                    8 * fma["elements"])))},
    })
    # The NUTS leaf kernel: port-only (the JAX package builds its trees inside one XLA while_loop), at the serving
    # cells' chains, the SBC fold's at the calibrated preset (``large``) and the serving chains at the hierarchical
    # sampler's D (``wide``); ms and plain_ms are device time a leaf.
    serve, fold, wide = (leaf[shape] for shape in LEAF_SHAPES)
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "host_ms", "plain_host_ms", "plain_ops_per_leaf", "worst_ulps")
    kernels.append({
        "name": "nuts_leaf", "route": "cuda", "source": f"{src}/nuts_leaf.cu", "replaces": None,
        "launches": main_path["launches"]["nuts_leaf"], "max_ulps": max(r["worst_ulps"] for r in leaf.values()),
        "n": LEAF_SHAPES[0][0], **{k: serve[k] for k in timed}, "library_ms": None,
        "large": {"n": LEAF_SHAPES[1][0], **{k: fold[k] for k in timed}},
        "wide": {"n": LEAF_SHAPES[2][0], "D": LEAF_SHAPES[2][1], **{k: wide[k] for k in timed}},
    })
    found = {e: v for e, v in ptxas.items() if "nuts_leaf_kernel" in e}
    if len(found) != 1:
        raise AssertionError(f"ptxas reported {len(found)} builds of nuts_leaf_kernel, expected one: {sorted(ptxas)}")
    kernels[-1]["ptxas"] = next(iter(found.values()))
    if kernels[-1]["ptxas"].get("spill_stores", 0) or kernels[-1]["ptxas"].get("spill_loads", 0):
        raise AssertionError(f"nuts_leaf spills registers: {found}")
    # The u-space density's kernel pair: port-only (XLA fuses the density into the JAX sampler's program), at the
    # serving cells' chains and the SBC fold's (``large``); ms and plain_ms are device time a call, each side
    # around a potential that launches nothing. Its launches are density_pre's (density_post's are the same).
    serve, fold = (density[C] for C in DENSITY_CHAINS)
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "host_ms", "plain_host_ms", "ops_per_call",
             "plain_ops_per_call")
    kernels.append({
        "name": "density_pre", "route": "cuda", "source": f"{src}/udensity.cu", "replaces": None,
        "pair": list(DENSITY), "launches": main_path["launches"]["density_pre"],
        "max_abs_err": max(r["max_abs_err"] for r in density.values()),
        "differing_values": sum(r["differing_values"] for r in density.values()),
        "n": DENSITY_CHAINS[0], **{k: serve[k] for k in timed}, "library_ms": None,
        "large": {"n": DENSITY_CHAINS[1], **{k: fold[k] for k in timed}},
    })
    kernels[-1]["ptxas"] = {}
    for entry in ("density_pre_kernel", "density_post_kernel"):
        found = {e: v for e, v in ptxas.items() if entry in e}
        if len(found) != 1:
            raise AssertionError(f"ptxas reported {len(found)} builds of {entry}, expected one: {sorted(ptxas)}")
        kernels[-1]["ptxas"][entry] = v = next(iter(found.values()))
        if v.get("spill_stores", 0) or v.get("spill_loads", 0):
            raise AssertionError(f"{entry} spills registers: {found}")
    for k in kernels:
        k["launches_by_path"] = {name: p["launches"][k["name"]] for name, p in (
            ("main", main_path), ("pulse", pulse_path), ("roofline", roof), ("slice", slice_path),
            ("resume", resume), ("train", train_path), ("sbc", sbc), ("pipeline", pipe), ("sharp", sharp),
            ("ensemble", ens), ("embed", emb), ("variants", variants), ("hierarchical", hier), ("snpe", snpe),
            ("multidevice", multi))}
    measured_bounds(kernels, roof["report"])
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
