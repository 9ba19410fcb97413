"""Entry points: the flagship forward step, and the multi-device dry run.

Counterpart of the repository root's ``__graft_entry__.py`` (the JAX
package's). ``entry()`` returns the port's forward step on the flagship
compute path, the pulse-DDM simulator (K1) feeding the MNLE log-likelihood
(K2 on the card), with example arguments.

``dryrun_multichip(n)`` runs the framework's sharded paths once each over n
ranks, at tiny shapes, with JAX's stages: the multi-host no-op, sharded
simulation (checked against one unsharded call, bit for bit), a
data-parallel MNLE step, a dp x tp step on a (n/2, 2) mesh when n >= 4 and
even, chain-sharded NUTS, and replica-exchange NUTS with the replica groups
sharded. Call it on every rank of a group of n ranks (``torchrun
--nproc-per-node n``, ``parallel.multihost.launch_local``); outside a group,
n = 1 starts a world of one and n > 1 starts n local ranks, on the card
unless the caller names the CPU: over NCCL, one rank a card, when there are
n cards, else over gloo with the ranks sharing the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(fn, example_args): ``fn(theta, pulse_sides, seed)`` simulates a
    trial batch of 1,024 (K1) and returns the MNLE per-trial log-likelihood
    of the simulated (rt, choice) under an untrained flagship-width network,
    on ``device`` (default: the card)."""
    from .nets.mnle_net import MNLEConfig, build_mnle
    from .ops.ddm_cuda import ddm_rt_choice_cuda
    from .utils.device import resolve_device
    from .utils.rng import make_generator

    device = resolve_device(device)
    N, P = 1024, 80
    est = build_mnle(0, MNLEConfig(condition_dim=5 + P), device=device)
    log_prob = est.dispatch_log_prob("auto")

    def forward(theta, pulse_sides, seed):
        x = ddm_rt_choice_cuda(theta, pulse_sides, seed)
        with torch.no_grad():
            return log_prob(x, torch.cat([theta, pulse_sides], dim=-1))

    theta = torch.tensor([[0.5, 0.5, 1.0, 10.0, 0.1]], device=device).repeat(N, 1)
    pulses = torch.where(torch.rand((N, P), generator=make_generator(1, device), device=device) < 0.75, 1.0, -1.0)
    return forward, (theta, pulses, 2)


def dryrun_multichip(n_devices: int, *, device=None) -> dict:
    """The sharded training step, chain sharding and replica exchange over
    ``n_devices`` ranks, one step or a few transitions each at tiny shapes;
    returns {"loss", "loss_tp" (None below 4 ranks), "swap_accept"} (rank
    0's, when it starts local ranks). ``device``: this rank's device, or
    the local ranks' (default: the card; ``"cpu"`` runs every rank on the
    CPU over gloo)."""
    from .utils.device import resolve_device

    device = resolve_device(device)
    if not dist.is_initialized() and n_devices > 1:
        from .parallel.multihost import launch_local

        # NCCL takes one rank a card: with fewer cards than ranks they share the card over gloo.
        nccl = device.type == "cuda" and torch.cuda.device_count() >= n_devices
        return launch_local(_dryrun_rank, n_devices, (int(n_devices), device), device=device,
                            backend="nccl" if nccl else "gloo")[0]
    return _dryrun(int(n_devices), device)


def _dryrun_rank(n: int, device: torch.device) -> dict:
    """A local rank of ``dryrun_multichip``: NCCL's ranks run on the card
    their group was made on."""
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    return _dryrun(n, device)


def _dryrun(n: int, device: torch.device) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from .inference.nuts import ReplicaExchange, geometric_ladder
    from .mnle import TrainState
    from .nets.mnle_net import MNLEConfig, build_mnle
    from .ops.ddm_cuda import ddm_rt_choice_cuda
    from .parallel.mesh import (_mesh_device_type, default_mesh, make_dp_train_step, replicate, shard_leading,
                                sharded_run_nuts, sharded_simulate)
    from .parallel.multihost import global_mesh, initialize_multihost, process_info
    from .parallel.tp import make_tp_train_step, mnle_tp_specs
    from .utils.rng import make_generator

    # Stage 0: the multi-host wiring: a no-op inside a group (and without a
    # launcher's environment), and the global mesh spans every rank.
    mesh = default_mesh(n, "data", device=device)
    info = initialize_multihost()
    assert info == process_info() and info["process_count"] == n, (info, n)
    assert global_mesh().size() == n

    # Stage 1: sharded simulation (short trials: 40 steps, 2 chunks of 20),
    # each rank's block from its trial offset; equal to one unsharded call.
    N, n_max, spp, P = 8 * n, 40, 20, 4
    theta = torch.tensor([[0.5, 0.5, 1.0, 3.0, 0.1]], device=device).repeat(N, 1)
    pulses = torch.where(torch.rand((N, P), generator=make_generator(0, device), device=device) < 0.75, 1.0, -1.0)
    sim = dict(n_max=n_max, steps_per_pulse=spp, t_max=8.0)
    x = sharded_simulate(ddm_rt_choice_cuda, theta, pulses, 1, mesh=mesh, **sim)
    if not torch.equal(x, ddm_rt_choice_cuda(theta, pulses, 1, **sim)):
        raise AssertionError("dryrun_multichip: the sharded simulation differs from the unsharded one")

    # Stage 2: data-parallel MNLE step (batch split, weights replicated,
    # gradient all-reduced).
    mcfg = MNLEConfig(condition_dim=5 + P, hidden_features=32, num_transforms=2, num_bins=8)
    z = torch.cat([theta, pulses], dim=-1)
    est = build_mnle(2, mcfg, device=device)
    replicate(est.net, mesh)
    step = make_dp_train_step(est, TrainState(est.net.parameters(), 1e-3, 100), mesh)
    loss = float(step(shard_leading(x, mesh), shard_leading(z, mesh), 0))

    # Stage 2b: dp x tp step on a (data, model) mesh, the MNLE's layers
    # column- or row-parallel by JAX's rule.
    loss_tp = None
    if n >= 4 and n % 2 == 0:
        mesh2 = init_device_mesh(_mesh_device_type(), (n // 2, 2), mesh_dim_names=("data", "model"))
        est2 = build_mnle(2, mcfg, device=device)
        tp_step = make_tp_train_step(est2, mesh2, mnle_tp_specs(est2, mesh2), learning_rate=1e-3, decay_steps=100)
        loss_tp = float(tp_step(shard_leading(x, mesh2), shard_leading(z, mesh2), 0))

    # Stage 3: chain-sharded NUTS.
    mesh_chains = default_mesh(n, "chains", device=device)

    def logp(u):
        return -0.5 * (u ** 2).sum(-1)

    init_u = torch.randn((n, 3), generator=make_generator(3, device), device=device)
    samples, _ = sharded_run_nuts(4, logp, init_u, mesh=mesh_chains, num_warmup=5, num_samples=5, max_depth=4)
    assert samples.shape == (n, 5, 3)

    # Stage 4: replica-exchange NUTS with the replica groups sharded (the DEO
    # sweep's acceptance pooled over every rank).
    R = 2
    betas = torch.as_tensor(geometric_ladder(R, 0.3), device=device).repeat(n)

    def ll_pt(u, beta):
        return -0.5 * ((u - 1.0) ** 2).sum(-1)

    def logp_pt(u, beta):
        return -0.5 * (u ** 2).sum(-1) + beta * ll_pt(u, beta)

    init_pt = torch.randn((n * R, 3), generator=make_generator(5, device), device=device)
    samples_pt, info_pt = sharded_run_nuts(
        6, logp_pt, init_pt, mesh=mesh_chains, num_warmup=5, num_samples=5, max_depth=4, data=betas,
        exchange=ReplicaExchange(n_replicas=R, betas=betas, ll_fn=ll_pt, swap_every=1),
    )
    if not bool(torch.isfinite(samples_pt).all()):
        raise AssertionError("dryrun_multichip: non-finite replica-exchange draws")
    if dist.get_rank() == 0:
        print(f"[dryrun_multichip] ok: {n} ranks, sim+train+mcmc+pt loss={loss:.4f}"
              + (f" loss_tp={loss_tp:.4f}" if loss_tp is not None else "")
              + f" swap_accept={info_pt['swap_accept']}", flush=True)
    return {"loss": loss, "loss_tp": loss_tp, "swap_accept": info_pt["swap_accept"]}
