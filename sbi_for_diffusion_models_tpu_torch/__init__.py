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
(the JAX package's public names whose modules are ported, and the entry
points of ``mnle``, ``analysis`` and ``pipeline``) are imported from their
modules when first asked for. Every public name of the JAX package's root
has its counterpart here. Multi-device (``parallel``: sharded simulation,
data- and tensor-parallel training, chain sharding, ``run_sbc(mesh=)`` and
``run_hierarchical_inference(mesh=)``) runs one process a device under
``torch.distributed`` (NCCL on the card); ``graft_entry.py`` holds the
counterpart of the JAX package's ``__graft_entry__.py``.
"""

__version__ = "0.1.0"

_MODULES = {
    "run_config": ("RunConfig", "RUN_CONFIG_PARAMS"),
    "distributions": ("Beta", "BoxUniform", "LogNormal", "MultipleIndependent", "Normal", "Uniform",
                      "mcmc_transform"),
    "proposals": ("ExtendedProposal", "PulseSequenceProposal"),
    "models": ("ChoiceModelParams", "RTChoiceModelParams", "choice_model_simulator", "choice_model_simulator_torch",
               "generate_pulse_sides", "generate_pulse_matrix", "generate_pulse_matrix_numpy",
               "n_pulses_max_from_schedule", "pack_x_rt_choice", "pulse_schedule", "rt_choice_model_simulator",
               "rt_choice_model_simulator_torch", "simulate_session_data_rt_choice"),
    "data_simulator": ("sim_wrapper", "simulate_observed_session", "simulate_training_set_with_conditions",
                       "summarize_trials"),
    "nets": ("MNLE", "MNLEConfig"),
    "potentials": ("ConditionedMNLELogLikelihood", "ThetaOnlyPosteriorPotential"),
    "inference": ("MCMCPosterior", "run_nuts", "run_slice"),
    "mnle": ("train_mnle", "save_model", "load_model", "build_mnle", "run_inference_mcmc", "run_sbc",
             "MNLEEnsemble", "load_ensemble"),
    "analysis": ("pairplot", "sbc_uniformity_stats"),
    "pipeline": ("build_prior_theta", "main"),
    "datasets": ("make_x_from_rat_df", "split_by_subject"),
    "snpe": ("DirectPosterior", "train_snle", "train_snpe"),
    "models.hierarchical": ("HierarchicalModel", "run_hierarchical_inference", "simulate_hierarchical_sessions"),
    "models.pulse_ddm_7p": ("rt_choice_model_simulator_7p", "simulate_session_data_7p"),
}
_EXPORTS = {name: module for module, names in _MODULES.items() for name in names}
__all__ = ["constants"] + list(_EXPORTS)


def __getattr__(name):
    import importlib

    if name == "constants":
        return importlib.import_module(".constants", __name__)
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
