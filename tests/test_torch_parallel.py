"""PyTorch port: multi-device (``parallel/``, ``run_sbc(mesh=)``,
``run_hierarchical_inference(mesh=)``, ``graft_entry.dryrun_multichip``) on
the CPU, with 2 and 4 gloo ranks started by ``parallel.multihost.launch_local``.

The JAX package shards one program over a mesh, so its sharded runs compute
the unsharded run's numbers. The port runs one process a rank and must give
the same: each world runs every sharded path once on its ranks (one spawn a
world size, ``_world``), rank 0 runs the unsharded counterpart in the same
process, and the tests below read the results. JAX is imported inside the
tests that compare with it, never at the top: the ranks import this module.

The ranks and the unsharded runs use ATen's scalar CPU kernels
(``ATEN_CPU_CAPABILITY=default``). With its SIMD kernels, an element of an
elementwise transcendental (log, exp) is rounded by the SIMD routine in the
body of a tensor and by libm in its tail (its length modulo the vector
width), so one chain's log-density could differ in the last bit between a
batch of 18 chains and a rank's 9; NUTS then takes another branch. The
scalar kernels round every element alike, so the sharded runs are held to
the unsharded ones bit for bit. (On the card every element takes one code
path; ``tests/test_torch_cuda_paths.py`` holds the card's sharded runs.)
"""

import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sbi_for_diffusion_models_tpu_torch import mnle as tmnle
from sbi_for_diffusion_models_tpu_torch.graft_entry import dryrun_multichip
from sbi_for_diffusion_models_tpu_torch.inference.nuts import ReplicaExchange, geometric_ladder, run_nuts
from sbi_for_diffusion_models_tpu_torch.mnle import TrainState, train_step
from sbi_for_diffusion_models_tpu_torch.models import hierarchical as th
from sbi_for_diffusion_models_tpu_torch.nets.mnle_net import MNLEConfig, build_mnle, mnle_to_flax_params
from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda
from sbi_for_diffusion_models_tpu_torch.ops.ddm_scan import ddm_rt_choice_scan
from sbi_for_diffusion_models_tpu_torch.parallel import mesh as pmesh
from sbi_for_diffusion_models_tpu_torch.parallel import multihost, tp
from sbi_for_diffusion_models_tpu_torch.parallel.comm import barrier
from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta
from sbi_for_diffusion_models_tpu_torch.run_config import RUN_CONFIG_PARAMS
from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

SIM_KW = dict(n_max=80, steps_per_pulse=20, chunk_steps=20, t_max=8.0)
TINY = MNLEConfig(condition_dim=9, hidden_features=16, num_transforms=2, num_bins=5)
SBC_TINY = MNLEConfig(hidden_features=16, num_transforms=2, num_bins=5)
DP_STEPS, LR = 12, 1e-2
# The TP step against the single-process step: its row-parallel layers sum their halves' partial products before
# the all-reduce adds them, and the clip sums the shards' squared norms over the model axis, so the gradients
# differ from the single process's in the last bits (float32 sums reassociated); Adam's first steps move each
# weight by about LR whatever the gradient's size. After 3 steps every weight must be within 1e-4 x LR x 3 + 1e-6
# of the single process's, and the losses within 1e-5 relative.
TP_STEPS = 3
TP_ATOL = 1e-4 * LR * TP_STEPS + 1e-6


def _inputs(n):
    theta = torch.tensor([[0.5, 0.5, 1.0, 2.0, 0.1]]).repeat(n, 1)
    pulses = torch.where(torch.from_numpy(np.random.default_rng(0).uniform(size=(n, 4))) < 0.75, 1.0, -1.0)
    return theta, pulses.to(torch.float32)


def _flat(net) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in net.parameters()]).numpy()


def _tiny_est(seed=0):
    return build_mnle(seed, TINY, device="cpu")


def _train_pairs(n=66):
    theta, pulses = _inputs(n)
    return ddm_rt_choice_scan(theta, pulses, 2, **SIM_KW), torch.cat([theta, pulses], -1)


def _sbc_setup(R: int, datasets: int, method: str = "nuts"):
    est = build_mnle(0, SBC_TINY, device="cpu")
    cfg = RUN_CONFIG_PARAMS.replace(NUM_TRIALS_OBS=5, NUM_CHAINS=2, WARMUP_STEPS=6, SBC_NUM_DATASETS=datasets,
                                    SBC_POST_SAMPLES=10, MCMC_MAX_TREE_DEPTH=4, MCMC_PT_REPLICAS=R,
                                    MCMC_PT_BETA_MIN=0.3, MCMC_METHOD=method)
    return build_prior_theta(), est, cfg


def _sbc(R, datasets, outdir, mesh, method="nuts"):
    prior, est, cfg = _sbc_setup(R, datasets, method)
    out = tmnle.run_sbc(cfg, prior, est, "cpu", outdir=outdir, seed=0, verbose=False, group_size=datasets,
                        mesh=mesh)
    return {k: out[k] for k in ("ranks", "rhat_max", "swap_accept", "potential_calls")} | {
        "samples": np.stack(out["all_samples"])}


def _hierarchical(mesh):
    prior = build_prior_theta()
    est = build_mnle(0, MNLEConfig(condition_dim=85, hidden_features=16, num_transforms=2, num_bins=5),
                     device="cpu")
    sims = [th.simulate_hierarchical_sessions(prior, 2, 4, seed=s, device="cpu") for s in (1, 2, 3)]
    out = th.run_hierarchical_inference(est, prior, torch.stack([s[1] for s in sims]),
                                        torch.stack([s[2] for s in sims]), num_chains=2, num_warmup=5,
                                        num_samples=5, max_tree_depth=3, pt_replicas=2, seed=3, verbose=False,
                                        mesh=mesh)
    return {"raw": out["raw"], "theta_subjects": out["theta_subjects"], "swap_accept": out["swap_accept"]}


def _nuts(mesh, R, checkpoint_dir=None):
    """Plain (R = 1) or replica-exchange NUTS on a Gaussian: 5 chains (R = 1)
    or 3 groups of R (so a world of 2 or 4 pads)."""
    C = 5 if R == 1 else 3 * R

    def logp(u, beta=None):
        return -0.5 * ((u - 2.0) ** 2).sum(-1) if R == 1 else -0.5 * (u ** 2).sum(-1) + beta * ll(u, beta)

    def ll(u, beta):
        return -0.5 * ((u - 1.0) ** 2).sum(-1)

    kw = dict(num_warmup=10, num_samples=10, max_depth=5, checkpoint_dir=checkpoint_dir, segment_length=5)
    if R > 1:
        betas = torch.as_tensor(geometric_ladder(R, 0.3)).repeat(C // R)
        kw.update(data=betas, exchange=ReplicaExchange(n_replicas=R, betas=betas, ll_fn=ll, swap_every=1))
    init = torch.randn((C, 3), generator=make_generator(3))
    if mesh is None:
        s, info = run_nuts(4, logp, init, **kw)
    else:
        s, info = pmesh.sharded_run_nuts(4, logp, init, mesh=mesh, **kw)
    return {"samples": s.numpy(), "step_size": info["step_size"].numpy(), "accept_prob": info["accept_prob"].numpy(),
            "swap_accept": info.get("swap_accept"), "potential_calls": info["potential_calls"]}


def _world(world: int, outdir: str) -> dict:
    """Every sharded path on this rank of a world of ``world``, and (under
    the key ``ref``) the unsharded counterparts: the cheap ones on every
    rank, each of the sampler runs on one rank (``_refs`` gathers them)."""
    r = dist.get_rank()
    res, ref = {}, {}
    data_mesh = pmesh.default_mesh(world, "data")
    chains = pmesh.default_mesh(world, "chains")

    # Trials: the plain scan and the K1 wrapper (its CPU route), at 64 and a ragged 13.
    for n in (64, 13):
        theta, pulses = _inputs(n)
        for name, fn in (("scan", ddm_rt_choice_scan), ("k1", ddm_rt_choice_cuda)):
            kw = SIM_KW if fn is ddm_rt_choice_scan else {k: v for k, v in SIM_KW.items() if k != "chunk_steps"}
            res[f"sim_{name}_{n}"] = pmesh.sharded_simulate(fn, theta, pulses, 7, mesh=data_mesh, **kw).numpy()
            ref[f"sim_{name}_{n}"] = fn(theta, pulses, 7, **kw).numpy()

    # Data-parallel training on each rank's block of 66 pairs (ragged at 4 ranks: 17, 17, 16, 16).
    x, z = _train_pairs()
    est = _tiny_est()
    pmesh.replicate(est.net, data_mesh)
    step = pmesh.make_dp_train_step(est, TrainState(est.net.parameters(), LR, 100), data_mesh)
    xb, zb = pmesh.shard_leading(x, data_mesh), pmesh.shard_leading(z, data_mesh)
    res["dp_losses"] = [float(step(xb, zb, i)) for i in range(DP_STEPS)]
    res["dp_params"] = _flat(est.net)
    full = _tiny_est()
    full_state = TrainState(full.net.parameters(), LR, 100)
    ref["dp_losses"] = [float(train_step(full, full_state, x, z, i)) for i in range(DP_STEPS)]
    ref["dp_params"] = _flat(full.net)

    # dp x tp on a (world/2, 2) mesh.
    if world == 4:
        from torch.distributed.device_mesh import init_device_mesh

        mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        est2 = _tiny_est()
        specs = tp.mnle_tp_specs(est2, mesh2)
        tp_step = tp.make_tp_train_step(est2, mesh2, specs, learning_rate=LR, decay_steps=100)
        xb2, zb2 = pmesh.shard_leading(x, mesh2, "data"), pmesh.shard_leading(z, mesh2, "data")
        res["tp_specs"] = specs
        res["tp_losses"] = [float(tp_step(xb2, zb2, i)) for i in range(TP_STEPS)]
        res["tp_params"] = _flat(tp_step.full_net())
        ref_est = _tiny_est()
        ref_state = TrainState(ref_est.net.parameters(), LR, 100)
        ref["tp_losses"] = [float(train_step(ref_est, ref_state, x, z, i)) for i in range(TP_STEPS)]
        ref["tp_params"] = _flat(ref_est.net)

    # Chains: NUTS plain and with replica exchange, the SBC fold, the hierarchical fold.
    res["nuts_plain"], res["nuts_pt"] = _nuts(chains, 1), _nuts(chains, 3)
    # Resume: each rank's segments in its own directory; a finished run replays; ranks that stop at different
    # segments (rank 1's checkpoint removed) start afresh, all of them.
    ck = os.path.join(outdir, "nuts_ck")
    res["nuts_ck_first"], res["nuts_ck_again"] = _nuts(chains, 1, ck), _nuts(chains, 1, ck)
    barrier()
    if r == 1:
        os.remove(os.path.join(ck, "rank_1", "nuts_segments.npz"))
    barrier()
    res["nuts_ck_fresh"] = _nuts(chains, 1, ck)
    res["sbc_plain"] = _sbc(1, 3, os.path.join(outdir, "plain"), chains)
    res["sbc_pt"] = _sbc(3, 3 if world == 4 else 2, os.path.join(outdir, "pt"), chains)
    res["sbc_slice"] = _sbc(1, 3, os.path.join(outdir, "slice"), chains, "slice")
    res["hierarchical"] = _hierarchical(chains)
    unsharded = [("sbc_pt", lambda d: _sbc(3, 3 if world == 4 else 2, d, None)),
                 ("sbc_plain", lambda d: _sbc(1, 3, d, None)), ("hierarchical", lambda d: _hierarchical(None)),
                 ("sbc_slice", lambda d: _sbc(1, 3, d, None, "slice")),
                 ("nuts_pt", lambda d: _nuts(None, 3)), ("nuts_plain", lambda d: _nuts(None, 1))]
    for key, run in unsharded[r::world]:
        with tempfile.TemporaryDirectory() as d:
            ref[key] = run(d)
    if r == 0:
        res["files"] = sorted(os.listdir(os.path.join(outdir, "pt")))
        res["ckpt"] = sorted(os.listdir(os.path.join(outdir, "pt", "nuts_ckpt", "group_0")))
    res["ref"] = ref
    return res


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``get(n)``: every rank's results of one spawn of ``_world`` on n
    ranks, made at the first call for n."""
    cache = {}

    def get(n: int) -> list:
        if n not in cache:
            outdir = tmp_path_factory.mktemp(f"world{n}")
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("ATEN_CPU_CAPABILITY", "default")
                cache[n] = multihost.launch_local(_world, n, (n, str(outdir)), timeout_s=400.0)
        return cache[n]

    return get


@pytest.fixture(params=[2, 4])
def world(request, spawned):
    """(world size, every rank's results), at 2 and 4 ranks."""
    return request.param, spawned(request.param)


@pytest.fixture
def world4(spawned):
    """Every rank's results at 4 ranks (a (2, 2) mesh for the TP paths)."""
    return spawned(4)


def _refs(results: list) -> dict:
    """The unsharded results, gathered from the ranks that made them."""
    return {k: v for res in results for k, v in res["ref"].items()}


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pad_to_multiple_matches_jax():
    from sbi_for_diffusion_models_tpu.parallel.mesh import pad_to_multiple as jpad

    a = np.arange(10, dtype=np.float32).reshape(5, 2)
    for m, axis in ((4, 0), (5, 0), (3, 1), (1, 0)):
        jp, jn = jpad(a, m, axis=axis)
        tp_, tn = pmesh.pad_to_multiple(torch.from_numpy(a), m, axis=axis)
        assert tn == jn
        _equal(tp_, jp)
    t = torch.from_numpy(a)
    assert pmesh.pad_to_multiple(t, 5)[0] is t


def test_padded_rows_are_whole_replica_groups():
    """The rows a sharded PT run pads (18 rows, 6 groups of 3, over 4 ranks:
    to 8 groups, a multiple of the ranks, 24 rows) are whole groups from the
    front, and every rank's block holds whole groups; without groups the pad
    repeats the last row, as ``pad_to_multiple`` does."""
    blocks = [pmesh._sharded_rows(18, 4, r, 3, "cpu") for r in range(4)]
    rows = torch.cat([b[0] for b in blocks])
    real = torch.cat([b[1] for b in blocks])
    assert all(b[0].shape[0] == 6 for b in blocks)
    _equal(rows, list(range(18)) + list(range(6)))
    _equal(real, [True] * 18 + [False] * 6)
    _equal(torch.cat([pmesh._sharded_rows(6, 4, r, 1, "cpu")[0] for r in range(4)]), [0, 1, 2, 3, 4, 5, 5, 5])


def test_process_info_and_initialize_without_env(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    info = multihost.initialize_multihost()
    assert not dist.is_initialized() and not multihost.is_multihost()
    assert info == multihost.process_info() == {"process_index": 0, "process_count": 1, "local_device_count": 1,
                                                "global_device_count": 1}


@pytest.mark.parametrize("n", [64, 13])
@pytest.mark.parametrize("fn", ["scan", "k1"])
def test_sharded_simulate_matches_unsharded(world, n, fn):
    """Each rank's block from its trial offset (padded to a multiple of the
    ranks at N = 13): the unsharded call's output bit for bit, on every rank."""
    _, results = world
    for res in results:
        _equal(res[f"sim_{fn}_{n}"], _refs(results)[f"sim_{fn}_{n}"])


def test_dp_step_matches_train_step_on_the_full_batch(world):
    """The DP step's parameters are bit-equal on every rank and follow
    ``train_step`` on the whole batch: the rows' mean gradient, reassociated
    (each rank's mean weighted by its share), so within 1e-5 after 12 Adam
    steps at 1e-2; the loss improves."""
    _, results = world
    ref = _refs(results)
    for res in results[1:]:
        _equal(res["dp_params"], results[0]["dp_params"])
    np.testing.assert_allclose(results[0]["dp_params"], ref["dp_params"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(results[0]["dp_losses"], ref["dp_losses"], rtol=1e-5)
    assert results[0]["dp_losses"][-1] < results[0]["dp_losses"][0]


def test_mnle_tp_specs_match_jax_on_every_leaf(world4):
    """The same flax tree, the same rule: JAX's PartitionSpec of each leaf
    (on a (4, 2) mesh of the 8 CPU devices) against the port's tuple (on its
    (2, 2) mesh of ranks; the rule reads only the model axis's size)."""
    results = world4
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from sbi_for_diffusion_models_tpu.parallel.tp import mnle_tp_specs as j_specs

    params = mnle_to_flax_params(_tiny_est())
    jmesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    jspecs = j_specs(params, jmesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: isinstance(x, P))
    port = results[0]["tp_specs"]
    assert len(flat) == sum(len(layer) for layer in _layers(port))
    for path, spec in flat:
        node = port
        for k in path:
            node = node[k.key]
        assert node == tuple(spec), (jax.tree_util.keystr(path), node, spec)
    assert any(s != () for layer in _layers(port) for s in layer.values())


def _layers(tree):
    """The leaf dicts ({"bias": spec, "kernel": spec}) of a spec tree."""
    if "kernel" in tree:
        return [tree]
    return [leaf for v in tree.values() for leaf in _layers(v)]


def test_tp_step_matches_the_single_process_step(world4):
    """The 2 x 2 step's gathered weights are bit-equal on every rank and
    within TP_ATOL of ``train_step``'s on the whole batch (see TP_ATOL)."""
    results = world4
    ref = _refs(results)
    for res in results[1:]:
        _equal(res["tp_params"], results[0]["tp_params"])
    np.testing.assert_allclose(results[0]["tp_losses"], ref["tp_losses"], rtol=1e-5)
    np.testing.assert_allclose(results[0]["tp_params"], ref["tp_params"], rtol=0, atol=TP_ATOL)


@pytest.mark.parametrize("kind", ["nuts_plain", "nuts_pt"])
def test_sharded_run_nuts_matches_unsharded(world, kind):
    """Draws, accept probabilities, step sizes and the swap acceptance of the
    unsharded run, bit for bit, on every rank (5 chains, or 3 groups of 3
    replicas: padded at both world sizes)."""
    _, results = world
    ref = _refs(results)[kind]
    for res in results:
        for key in ("samples", "step_size", "accept_prob"):
            _equal(res[kind][key], ref[key])
        assert res[kind]["swap_accept"] == ref["swap_accept"]


def test_sharded_run_nuts_resumes_from_each_ranks_checkpoint(world):
    """With ``checkpoint_dir`` each rank keeps its segments in ``rank_{r}``:
    the same call again replays the finished run without a potential call;
    when the ranks' checkpoints stop at different segments (one removed)
    every rank starts afresh, to the same draws."""
    _, results = world
    ref = _refs(results)["nuts_plain"]
    for res in results:
        for key in ("nuts_ck_first", "nuts_ck_again", "nuts_ck_fresh"):
            _equal(res[key]["samples"], ref["samples"])
        assert res["nuts_ck_again"]["potential_calls"] == 0
        assert res["nuts_ck_fresh"]["potential_calls"] == res["nuts_ck_first"]["potential_calls"] > 0


@pytest.mark.parametrize("kind", ["sbc_plain", "sbc_pt", "sbc_slice"])
def test_run_sbc_on_a_mesh_matches_unsharded(world, kind):
    """``run_sbc(mesh=)``: the fold's rows split over the ranks (padded by
    whole replica groups with PT: 18 rows of groups of 3 to 24 at 4 ranks;
    plain NUTS and the slice sampler: 6 rows to 8), every rank with the
    unsharded draws, ranks, R-hats and swap acceptance; rank 0 writes the
    files, each rank its NUTS segments."""
    n, results = world
    ref = _refs(results)[kind]
    for res in results:
        for key in ("samples", "ranks", "rhat_max"):
            _equal(res[kind][key], ref[key])
        assert res[kind]["swap_accept"] == ref["swap_accept"]
        assert res[kind]["potential_calls"] == ref["potential_calls"]
    assert {"sbc_ranks.npy", "sbc_samples.npy", "sbc_mixing_diagnostics.npz"} <= set(results[0]["files"])
    assert results[0]["ckpt"] == [f"rank_{r}" for r in range(n)]


def test_run_hierarchical_inference_on_a_mesh_matches_unsharded(world):
    _, results = world
    ref = _refs(results)["hierarchical"]
    for res in results:
        for key in ("raw", "theta_subjects"):
            _equal(res["hierarchical"][key], ref[key])
        assert res["hierarchical"]["swap_accept"] == ref["swap_accept"]


def test_entry_simulates_into_the_mnle_log_likelihood():
    """``entry()``'s step on the CPU: K1's plain version feeding the MNLE's
    per-trial log-likelihood, finite, the same for the same seed."""
    from sbi_for_diffusion_models_tpu_torch.graft_entry import entry

    fn, (theta, pulses, seed) = entry(device="cpu")
    out = fn(theta, pulses, seed)
    assert out.shape == (1024,) and bool(torch.isfinite(out).all())
    assert torch.equal(out, fn(theta, pulses, seed))


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    """Without ``device``, ``dryrun_multichip`` runs its ranks on the card:
    with no card it raises before starting any, as every entry point does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4)
    assert not dist.is_initialized()


def test_dryrun_multichip():
    """``dryrun_multichip(4, device="cpu")`` outside a group starts 4 local
    ranks on the CPU over gloo and runs every stage there, the 2 x 2 TP step
    included (its sharded simulation is checked against the unsharded call
    inside)."""
    out = dryrun_multichip(4, device="cpu")
    assert np.isfinite(out["loss"]) and np.isfinite(out["loss_tp"])
    assert 0.0 <= out["swap_accept"] <= 1.0
