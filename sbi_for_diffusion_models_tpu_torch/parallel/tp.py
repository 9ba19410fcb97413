"""Tensor-parallel sharding of the MNLE estimator's layers.

Counterpart of ``sbi_for_diffusion_models_tpu/parallel/tp.py``.
``mnle_tp_specs`` applies the JAX package's rule to the same flax tree
(``nets.mnle_net.mnle_to_flax_params``) and names each leaf's sharding as
JAX's ``PartitionSpec`` does, as a tuple over the flax kernel's (d_in, d_out):
``(None, "model")`` column-parallel, ``("model", None)`` row-parallel,
``("model",)`` a sharded bias, ``()`` replicated.

XLA's partitioner inserts the collectives for JAX. Here
``make_tp_train_step`` writes them out, Megatron's way. A ``nn.Linear``
weight is (out, in), the transpose of the flax kernel, so a column-parallel
layer keeps rows of the weight (and of the bias) and a row-parallel one
columns. The rule does not make column and row layers alternate, so each
sharded layer gives the whole activation on its own: a column layer gathers
its outputs over the ``model`` axis, a row layer all-reduces its partial
sums. Every rank of a ``model`` group then holds the same activations and the
same loss, so the collectives' backward passes are the conjugate ones
(gather forward, own slice backward; all-reduce forward, identity backward;
and the layer input's gradient all-reduced or gathered).
"""

from __future__ import annotations

import copy
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..mnle import TrainState
from .comm import all_gather_rows, all_reduce
from .mesh import _axis

__all__ = ["mnle_tp_specs", "make_tp_train_step"]


def _keystr(path) -> str:
    return "".join(f"['{k}']" for k in path)


def mnle_tp_specs(params: Any, mesh, model_axis: str = "model") -> dict:
    """The sharding of every leaf of an MNLE's flax tree (``params``, or an
    ``MNLE`` whose tree ``mnle_to_flax_params`` gives) on a mesh with a
    ``model`` axis of n ranks, by JAX's rule: a kernel (d_in, d_out) is
    column-parallel when d_out divides by n and is at least 2n, else
    row-parallel when d_in does, else replicated; a bias is sharded when its
    length divides by n and is at least 2n (exactly when its kernel is
    column-parallel). Returns the tree with each leaf's spec tuple."""
    from ..nets.mnle_net import MNLE, mnle_to_flax_params

    if isinstance(params, MNLE):
        params = mnle_to_flax_params(params)
    _, n, _ = _axis(mesh, model_axis)

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 2:
            d_in, d_out = shape
            if d_out % n == 0 and d_out >= 2 * n:
                return (None, model_axis)
            if d_in % n == 0 and d_in >= 2 * n:
                return (model_axis, None)
            return ()
        if len(shape) == 1 and "bias" in _keystr(path):
            return (model_axis,) if shape[0] % n == 0 and shape[0] >= 2 * n else ()
        return ()

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return spec_for(path, tree)

    return walk(params, ())


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the sum over the model group of the
    input's partial gradients (each rank holds its own columns' share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), "sum", ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    """Each rank's slice of the last dim, concatenated in rank order;
    backward, this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, y, group, r):
        ctx.r, ctx.k = r, y.shape[-1]
        return all_gather_rows(y.movedim(-1, 0).contiguous(), group).movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.r * ctx.k: (ctx.r + 1) * ctx.k], None, None


class _ScatterToModel(torch.autograd.Function):
    """This rank's slice of the last dim; backward, every rank's slice of the
    gradient concatenated."""

    @staticmethod
    def forward(ctx, x, group, r, k):
        ctx.group = group
        return x[..., r * k: (r + 1) * k]

    @staticmethod
    def backward(ctx, g):
        return all_gather_rows(g.movedim(-1, 0).contiguous(), ctx.group).movedim(0, -1), None, None, None


class _ReduceFromModel(torch.autograd.Function):
    """The sum of the ranks' partial outputs; backward, the identity (every
    rank holds the same gradient)."""

    @staticmethod
    def forward(ctx, y, group):
        return all_reduce(y.contiguous(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ColumnParallel(nn.Module):
    """A ``nn.Linear`` whose output features are split over the model group:
    this rank keeps rows [r k, (r + 1) k) of the weight and the bias."""

    def __init__(self, linear: nn.Linear, group, n: int, r: int):
        super().__init__()
        k = linear.out_features // n
        self.group, self.r = group, r
        self.weight = nn.Parameter(linear.weight.detach()[r * k: (r + 1) * k].clone())
        self.bias = nn.Parameter(linear.bias.detach()[r * k: (r + 1) * k].clone())

    def forward(self, x):
        return _GatherFromModel.apply(F.linear(_CopyToModel.apply(x, self.group), self.weight, self.bias),
                                      self.group, self.r)

    def full(self) -> tuple:
        return (all_gather_rows(self.weight.detach(), self.group),
                all_gather_rows(self.bias.detach(), self.group))


class _RowParallel(nn.Module):
    """A ``nn.Linear`` whose input features are split over the model group:
    this rank keeps columns [r k, (r + 1) k) of the weight; the bias is
    replicated and added after the partial sums are reduced."""

    def __init__(self, linear: nn.Linear, group, n: int, r: int):
        super().__init__()
        self.k = linear.in_features // n
        self.group, self.r = group, r
        self.weight = nn.Parameter(linear.weight.detach()[:, r * self.k: (r + 1) * self.k].clone())
        self.bias = nn.Parameter(linear.bias.detach().clone())

    def forward(self, x):
        part = F.linear(_ScatterToModel.apply(x, self.group, self.r, self.k), self.weight)
        return _ReduceFromModel.apply(part, self.group) + self.bias

    def full(self) -> tuple:
        return all_gather_rows(self.weight.detach().t().contiguous(), self.group).t(), self.bias.detach()


class _TPTrainState(TrainState):
    """``TrainState`` over this rank's shards: the global-norm clip sums the
    squared norms of the sharded parameters' gradients over the model group
    and counts the replicated ones once."""

    def __init__(self, params, learning_rate: float, decay_steps: int, *, max_norm: float, sharded: set, group):
        super().__init__(params, learning_rate, decay_steps, max_norm=max_norm)
        self.sharded, self.group = sharded, group  # ids of the sharded parameters; the model group

    def clip_gradients_(self) -> None:
        zero = torch.zeros((), device=self.params[0].device)
        grads = [(id(p) in self.sharded, p.grad) for p in self.params if p.grad is not None]
        sq_sharded = sum((g.pow(2).sum() for s, g in grads if s), zero)
        sq_rep = sum((g.pow(2).sum() for s, g in grads if not s), zero)
        norm = torch.sqrt(all_reduce(sq_sharded.reshape(1), "sum", self.group)[0] + sq_rep)
        below = norm < self.max_norm
        divisor = torch.where(below, torch.ones_like(norm), norm)
        factor = torch.where(below, torch.ones_like(norm), torch.full_like(norm, self.max_norm))
        for _, g in grads:
            g.div_(divisor).mul_(factor)


class TPTrainStep:
    """dp x tp training of an MNLE on a (data, model) mesh: see
    ``make_tp_train_step``. ``estimator`` is the sharded estimator on this
    rank; ``full_net()`` gathers its weights into a whole ``MNLENet``."""

    def __init__(self, estimator, mesh, param_specs: dict, *, learning_rate: float, decay_steps: int,
                 max_norm: float = 5.0, data_axis: str = "data", model_axis: str = "model"):
        from ..nets.mnle_net import MNLE, _named_linears

        self.data_group, _, _ = _axis(mesh, data_axis)
        self.model_group, n, r = _axis(mesh, model_axis)
        self._template = estimator.net
        net = copy.deepcopy(estimator.net)
        names = {id(m): name for name, m in net.named_modules()}
        self._layers = []
        for path, linear in _named_linears(net):
            kernel_spec = _lookup(param_specs, path)["kernel"]
            if kernel_spec == (None, model_axis):
                layer = _ColumnParallel(linear, self.model_group, n, r)
            elif kernel_spec == (model_axis, None):
                layer = _RowParallel(linear, self.model_group, n, r)
            else:
                continue
            parent, _, child = names[id(linear)].rpartition(".")
            setattr(net.get_submodule(parent), child, layer)
            self._layers.append((path, layer))
        net.requires_grad_(True)
        self.estimator = MNLE(estimator.cfg, net, estimator.cond_mean, estimator.cond_std, estimator.x_mean,
                              estimator.x_std)
        sharded = {id(layer.weight) for _, layer in self._layers}
        sharded |= {id(layer.bias) for _, layer in self._layers if isinstance(layer, _ColumnParallel)}
        self.state = _TPTrainState(net.parameters(), learning_rate, decay_steps, max_norm=max_norm,
                                   sharded=sharded, group=self.model_group)

    def __call__(self, xb: torch.Tensor, zb: torch.Tensor, step: int) -> torch.Tensor:
        """One step on this rank's block of the batch: the loss -mean(log p)
        over every data rank's rows (the same on every model rank), the
        gradient weighted and all-reduced over the data axis as in
        ``make_dp_train_step``, the global-norm clip over the whole model, and
        Adam on each rank's shards. Returns the loss before the update."""
        n_local = torch.tensor([float(xb.shape[0])], device=xb.device)
        share = n_local / all_reduce(n_local, "sum", self.data_group)
        self.state.adam.zero_grad(set_to_none=True)
        loss = -self.estimator.log_prob_fn(self.estimator.net, xb, zb).mean()
        (loss * share[0]).backward()
        for p in self.state.params:
            if p.grad is not None:
                p.grad.copy_(all_reduce(p.grad, "sum", self.data_group))
        self.state.apply(step)
        return all_reduce((loss.detach() * share).reshape(1), "sum", self.data_group)[0]

    def full_net(self):
        """A copy of the unsharded network with this step's current weights
        (the shards gathered over the model axis), on every rank."""
        from ..nets.mnle_net import _named_linears

        net = copy.deepcopy(self._template)
        full = {path: layer.full() for path, layer in self._layers}
        own = dict(_named_linears(self.estimator.net))
        with torch.no_grad():
            for path, linear in _named_linears(net):
                w, b = full[path] if path in full else (own[path].weight, own[path].bias)
                linear.weight.copy_(w)
                linear.bias.copy_(b)
        return net


def _lookup(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def make_tp_train_step(estimator, mesh, param_specs: dict, *, learning_rate: float, decay_steps: int,
                       max_norm: float = 5.0, data_axis: str = "data", model_axis: str = "model") -> TPTrainStep:
    """dp x tp training step: the batch split over ``data``, the layers
    over ``model`` per ``param_specs`` (``mnle_tp_specs``), with
    ``mnle.TrainState``'s clip, cosine schedule and Adam. Every rank starts
    from the same ``estimator`` (``mesh.replicate`` it first) and keeps its
    shards. Returns a ``TPTrainStep``: ``step(xb, zb, step) -> loss`` on
    this rank's rows, ``step.estimator`` and ``step.full_net()``."""
    return TPTrainStep(estimator, mesh, param_specs, learning_rate=learning_rate, decay_steps=decay_steps,
                       max_norm=max_norm, data_axis=data_axis, model_axis=model_axis)
