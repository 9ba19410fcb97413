"""Process groups: joining a multi-process run, and starting local ranks.

Counterpart of ``sbi_for_diffusion_models_tpu/parallel/multihost.py``. JAX
joins every host's process into one runtime whose ``jax.devices()`` spans the
pod, and one program runs over all of them. PyTorch runs one process a device
(a rank) under ``torch.distributed``; ``initialize_multihost`` joins this
process to such a group, from JAX's arguments or from the environment a
launcher such as ``torchrun --nproc-per-node N`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), and is a no-op
without either, as JAX's is. The backend is NCCL on the card; gloo when the
caller names the CPU, or names gloo to let several ranks share one card.
Every group is made with a collective timeout (``comm.DEFAULT_TIMEOUT_S``),
so a rank that dies or never arrives fails the others instead of hanging
them.

``launch_local`` starts N ranks of one function on this host, each a fresh
process that joins a group through a ``FileStore`` in a temporary directory
(no port), with a deadline for the whole run: the CPU tests and the
multi-device phase of ``chip_smoke.py`` run their sharded paths through it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .comm import DEFAULT_TIMEOUT_S, rank, world_size

__all__ = ["initialize_multihost", "global_mesh", "is_multihost", "process_info", "launch_local"]


def _backend(device: torch.device, backend: Optional[str]) -> str:
    if backend is not None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("NCCL runs on the card: pass a CUDA device or backend='gloo'")
        return backend
    return "nccl" if device.type == "cuda" else "gloo"


def init_group(world: int, rank_: int, *, init_method: Optional[str] = None, store=None, device=None,
               backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Make this process rank ``rank_`` of a default group of ``world`` ranks
    (through ``init_method``, a URL, or ``store``), on ``device`` (default:
    the card) with ``backend`` (default: NCCL on the card, gloo on the CPU).
    Under NCCL the rank's card is ``device`` and the communicator is made
    here, so a failure to make it raises here."""
    device = resolve_device(device)
    backend = _backend(device, backend)
    kwargs = {}
    if backend == "nccl":
        index = device.index if device.index is not None else torch.cuda.current_device()
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend, init_method=init_method, store=store, world_size=int(world), rank=int(rank_),
                            timeout=datetime.timedelta(seconds=float(timeout_s)), **kwargs)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    *,
    device=None,
    backend: Optional[str] = None,
) -> dict:
    """Join (or skip joining) a multi-process run; returns ``process_info()``.

    ``coordinator_address`` ("host:port" of rank 0's store), ``num_processes``
    and ``process_id`` default to torchrun's ``MASTER_ADDR``:``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``; the rank's card is ``local_device_ids[0]``,
    else ``LOCAL_RANK``, else 0. Without a coordinator (neither argument
    nor environment) this is a no-op, and so it is once this process is in
    a group: safe to call at every entry point. ``device="cpu"`` joins over
    gloo; ``backend="gloo"`` with the card lets several ranks share it."""
    if dist.is_initialized():
        return process_info()
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        return process_info()
    num_processes = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    process_id = int(process_id if process_id is not None else os.environ["RANK"])
    if device is None or torch.device(device).type == "cuda":
        local = local_device_ids[0] if local_device_ids else int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", int(local))
    init_group(num_processes, process_id, init_method=f"tcp://{coordinator_address}", device=device,
               backend=backend)
    return process_info()


def is_multihost() -> bool:
    """Whether this process is one of several ranks."""
    return world_size() > 1


def process_info() -> dict:
    """JAX's four keys in the port's sense, one device a process: this
    rank, the number of ranks, 1 device here, and as many in all as ranks."""
    n = world_size()
    return {"process_index": rank(), "process_count": n, "local_device_count": 1, "global_device_count": n}


def global_mesh(axis_name: str = "data"):
    """1-D mesh over every rank of the run (``mesh.default_mesh`` over the
    whole group; a world of one on the card outside a group)."""
    from .mesh import default_mesh

    return default_mesh(axis_name=axis_name)


def _rank_main(fn, rank_: int, world: int, store_path: str, device, backend: str, timeout_s: float, results,
               args) -> None:
    """A rank of ``launch_local``: join the group, run ``fn(*args)``, report."""
    torch.set_num_threads(1)
    if backend == "nccl":  # one card a rank
        device = torch.device("cuda", rank_ % torch.cuda.device_count())
    try:
        init_group(world, rank_, store=dist.FileStore(store_path, world), device=device, backend=backend,
                   timeout_s=timeout_s)
        try:
            results.put((rank_, None, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank_, traceback.format_exc(), None))
        raise


def launch_local(fn: Callable, world: int, args: Sequence = (), *, device="cpu", backend: Optional[str] = None,
                 timeout_s: float = 300.0) -> list:
    """Run ``fn(*args)`` on ``world`` new local processes, rank r of a
    default group of ``world`` on ``device`` (the CPU over gloo by default;
    a card with ``backend="gloo"`` for ranks that share it; under NCCL rank
    r takes card r modulo the cards, one card a rank). Returns each
    rank's result, in rank order. ``fn`` and ``args`` are pickled (a
    function of an importable module); each rank runs on one intra-op
    thread. Raises with its traceback as soon as a rank fails, and kills
    every rank if they have not all finished within ``timeout_s`` (the
    collectives time out at the same limit)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "store")
        backend = _backend(torch.device(device), backend)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, store_path, device, backend, timeout_s, results, tuple(args)))
                 for r in range(world)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while len(out) < world:  # drain the reports before joining the ranks
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"launch_local: {world - len(out)} of {world} ranks not done in {timeout_s} s")
                try:
                    r, err, value = results.get(timeout=min(remaining, 5.0))
                except queue_mod.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs) and results.empty():
                        raise RuntimeError(f"launch_local: a rank exited without a report (exit codes "
                                           f"{[p.exitcode for p in procs]})") from None
                    continue
                if err is not None:
                    raise RuntimeError(f"launch_local: rank {r} of {world} failed:\n{err}")
                out[r] = value
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            results.close()
    return [out[r] for r in range(world)]
