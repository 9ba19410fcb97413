"""Mesh scale-out over ``torch.distributed``: sharded simulation,
data-parallel and tensor-parallel training, chain sharding.

Counterpart of ``sbi_for_diffusion_models_tpu/parallel``, with its public
names (``__all__``); the modules are imported when a name is first asked
for. ``comm`` holds the collectives, and ``multihost.launch_local`` starts
local ranks."""

_EXPORTS = {
    "default_mesh": "mesh",
    "make_dp_train_step": "mesh",
    "pad_to_multiple": "mesh",
    "replicate": "mesh",
    "shard_leading": "mesh",
    "sharded_run_nuts": "mesh",
    "sharded_simulate": "mesh",
    "global_mesh": "multihost",
    "initialize_multihost": "multihost",
    "is_multihost": "multihost",
    "process_info": "multihost",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    import importlib

    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
