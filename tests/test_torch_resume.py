"""PyTorch port: ``run_nuts``'s segments, host mirror, checkpoint/resume and
device-loss replay, on the CPU. The JAX tests of the same features
(``tests/test_mcmc.py``) hold the JAX ``run_nuts``; these hold the port's to
the same contract, bit for bit against an uninterrupted run, and hold its
checkpoint's keys and shapes to the JAX function's file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbi_for_diffusion_models_tpu.inference import nuts as jn
from sbi_for_diffusion_models_tpu_torch.inference import mcmc as tm
from sbi_for_diffusion_models_tpu_torch.inference import nuts as tn
from sbi_for_diffusion_models_tpu_torch.utils.rng import make_generator

MEAN = torch.tensor([1.0, -2.0])
PREC = torch.linalg.inv(torch.tensor([[1.0, 0.8], [0.8, 1.5]]))
RUN_INFO = ("accept_prob", "num_steps", "diverging", "step_size", "inv_mass")


def _gauss_logp(u):
    d = u - MEAN
    return -0.5 * ((d @ PREC) * d).sum(-1)


def _init(seed, n=2):
    return torch.randn((n, 2), generator=make_generator(seed))


def _assert_same_run(a, b):
    (sa, ia), (sb, ib) = a, b
    assert torch.equal(sa, sb)
    for k in RUN_INFO:
        assert torch.equal(ia[k], ib[k]), k
    assert ia.get("swap_accept") == ib.get("swap_accept")


class _Cut(Exception):
    """Stands for the process being killed."""


def test_stale_checkpoint_is_ignored_and_a_finished_one_replays(tmp_path, capsys):
    """A checkpoint from a run with the same (chains, D) but another seed is
    ignored with the JAX message; the same arguments again replay the finished
    checkpoint to the same samples without one potential call."""
    ck = str(tmp_path / "nuts")
    kw = dict(num_warmup=20, num_samples=30, segment_length=15, max_depth=4, checkpoint_dir=ck)
    first = tn.run_nuts(21, _gauss_logp, _init(20), **kw)
    calls = [0]

    def counted(u):
        calls[0] += 1
        return _gauss_logp(u)

    again = tn.run_nuts(21, counted, _init(20), **kw)
    _assert_same_run(first, again)
    assert calls[0] == 0 and again[1]["potential_calls"] == 0
    assert "[run_nuts] resumed at segment 4/4" in capsys.readouterr().out
    other, _ = tn.run_nuts(99, _gauss_logp, _init(20), **kw)
    out = capsys.readouterr().out
    assert f"[run_nuts] ignoring stale checkpoint {ck}/nuts_segments.npz (run fingerprint mismatch" in out
    assert not torch.equal(first[0], other)
    # Another chain count: the chains/dim reason.
    tn.run_nuts(99, _gauss_logp, _init(20, 4), **kw)
    assert "(chains/dim 2x2 != 4x2)" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "nuts").iterdir()) == ["nuts_segments.npz"]  # no temporary left


def test_mirror_every_does_not_change_the_draws():
    kw = dict(num_warmup=20, num_samples=25, segment_length=5, max_depth=4)
    _assert_same_run(tn.run_nuts(31, _gauss_logp, _init(30), mirror_every=1, **kw),
                     tn.run_nuts(31, _gauss_logp, _init(30), mirror_every=5, **kw))


def test_injected_device_loss_replays_from_the_mirror(monkeypatch, capsys):
    """An ``AcceleratorError`` from the mirror's host copy (as the JAX test
    fails ``jax.device_get``) rewinds to the last mirror and replays the
    segments since: the same draws as a clean run."""
    kw = dict(num_warmup=15, num_samples=30, segment_length=5, mirror_every=2, max_depth=4)
    clean = tn.run_nuts(41, _gauss_logp, _init(40), **kw)
    real, seen = tn._to_host, [0]

    def flaky(tensors):
        seen[0] += 1
        if seen[0] == 3:  # the initial state's copy, the first mirror, then this
            raise torch.AcceleratorError("injected device loss")
        return real(tensors)

    monkeypatch.setattr(tn, "_to_host", flaky)
    monkeypatch.setattr(tn, "_PROBE_POLL_S", 0.0)
    faulted = tn.run_nuts(41, _gauss_logp, _init(40), **kw)
    assert seen[0] > 3
    assert "[run_nuts] device lost near segment 3 (AcceleratorError); waiting for recovery, then replaying " \
           "from segment 2 (attempt 1/2)" in capsys.readouterr().out
    _assert_same_run(clean, faulted)
    assert faulted[1]["potential_calls"] > clean[1]["potential_calls"]  # the replayed segments count


def _pt_problem(C=3, R=2):
    betas = torch.as_tensor(tn.geometric_ladder(R, 0.3)).repeat(C)
    ex = tn.ReplicaExchange(n_replicas=R, betas=betas, ll_fn=lambda u, b: _gauss_logp(u))
    return dict(logp_fn=lambda u, b: b * _gauss_logp(u), init_u=_init(50, C * R) * 2.0, data=betas, exchange=ex,
                mode_hop=tm.make_dim_slice(0, width=0.5))


def test_a_cut_run_resumes_to_the_uninterrupted_run_with_tempering_and_a_move(tmp_path, capsys):
    kw = dict(num_warmup=12, num_samples=18, segment_length=4, max_depth=4)
    full = tn.run_nuts(51, **_pt_problem(), **kw)
    calls = [0]
    prob = _pt_problem()
    logp = prob.pop("logp_fn")

    def cut_midway(u, b):
        calls[0] += 1
        if calls[0] > full[1]["potential_calls"] // 2:
            raise _Cut
        return logp(u, b)

    ck = tmp_path / "ck"
    with pytest.raises(_Cut):
        tn.run_nuts(51, cut_midway, checkpoint_dir=str(ck), **prob, **kw)
    with np.load(ck / "nuts_segments.npz") as blob:
        done = int(blob["next_segment"])
    assert 0 < done < 8
    resumed = tn.run_nuts(51, **_pt_problem(), checkpoint_dir=str(ck), **kw)
    assert f"[run_nuts] resumed at segment {done}/8" in capsys.readouterr().out
    _assert_same_run(full, resumed)
    assert 0 < resumed[1]["potential_calls"] < full[1]["potential_calls"]


def test_a_plain_runtime_error_is_not_replayed(monkeypatch):
    monkeypatch.setattr(tn, "_wait_for_device", lambda dev: pytest.fail("probed after a plain RuntimeError"))
    calls = [0]

    def broken(u):
        calls[0] += 1
        if calls[0] == 40:
            raise RuntimeError("shape bug")
        return _gauss_logp(u)

    with pytest.raises(RuntimeError, match="shape bug"):
        tn.run_nuts(1, broken, _init(1), num_warmup=10, num_samples=10, segment_length=5, max_depth=4)
    assert calls[0] == 40


@pytest.mark.parametrize("case", ["probe_never_answers", "retries_spent"])
def test_device_loss_reraises_when_it_cannot_recover(case, monkeypatch):
    monkeypatch.setattr(tn, "_PROBE_POLL_S", 0.01)
    if case == "probe_never_answers":
        monkeypatch.setattr(tn, "_PROBE_MAX_WAIT_S", 0.05)
        monkeypatch.setattr(tn, "_probe", lambda dev: False)
    calls = [0]

    def lost(u):
        calls[0] += 1
        if calls[0] >= 40:
            raise torch.AcceleratorError("device lost")
        return _gauss_logp(u)

    with pytest.raises(torch.AcceleratorError, match="device lost"):
        tn.run_nuts(1, lost, _init(1), num_warmup=10, num_samples=10, segment_length=5, max_depth=4,
                    device_retries=2)
    # One failed call, then one a replay until the retries are spent.
    assert calls[0] == (40 if case == "probe_never_answers" else 42)


@pytest.mark.parametrize("tempered", [False, True])
def test_checkpoint_keys_and_shapes_are_the_jax_runs(tempered, tmp_path):
    """The same C, D, L, W, S (W + S a multiple of L) through both packages'
    ``run_nuts``: the same keys in ``nuts_segments.npz``, each of the same
    shape."""
    C, R, D = 4, 2, 2
    kw = dict(num_warmup=6, num_samples=6, segment_length=4, max_depth=3)
    init = np.random.default_rng(0).normal(size=(C, D)).astype(np.float32)

    def jlp(u):
        return -0.5 * jnp.sum(u * u)

    jkw, tkw = {}, {}
    if tempered:
        jbetas = jnp.asarray(np.tile(jn.geometric_ladder(R, 0.5), C // R))
        jkw = dict(data=jbetas, exchange=jn.ReplicaExchange(n_replicas=R, betas=jbetas, ll_fn=lambda u, b: jlp(u)))
        tbetas = torch.as_tensor(tn.geometric_ladder(R, 0.5)).repeat(C // R)
        tkw = dict(data=tbetas, exchange=tn.ReplicaExchange(n_replicas=R, betas=tbetas,
                                                            ll_fn=lambda u, b: -0.5 * (u * u).sum(-1)))
    jn.run_nuts(jax.random.key(0), (lambda u, b: b * jlp(u)) if tempered else jlp, jnp.asarray(init),
                checkpoint_dir=str(tmp_path / "jax"), **kw, **jkw)
    tn.run_nuts(0, (lambda u, b: -0.5 * b * (u * u).sum(-1)) if tempered else (lambda u: -0.5 * (u * u).sum(-1)),
                torch.from_numpy(init), checkpoint_dir=str(tmp_path / "torch"), **kw, **tkw)
    with np.load(tmp_path / "jax" / "nuts_segments.npz") as j, np.load(tmp_path / "torch" / "nuts_segments.npz") as t:
        assert set(t.files) == set(j.files)
        assert ("swap_accept" in t.files) == tempered
        assert {k: t[k].shape for k in t.files} == {k: j[k].shape for k in j.files}
        assert int(t["next_segment"]) == int(j["next_segment"]) == 3


def test_inference_package_exports_the_jax_names():
    import sbi_for_diffusion_models_tpu.inference as jinf
    import sbi_for_diffusion_models_tpu_torch.inference as tinf

    assert tinf.__all__ == jinf.__all__
    assert tinf.run_nuts is tn.run_nuts and tinf.MCMCPosterior is tm.MCMCPosterior
