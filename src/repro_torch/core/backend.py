"""Communication backends and the schedule-driven gradient loop, the
PyTorch counterpart of ``repro.core.backend`` for the ranks of a
``RankGroup`` held by one controller.

A backend moves parameters and gradients between the ranks' shards and
their full tensors:

  ``collective``  the FSDP baseline: a fused all-gather (concatenation)
                  and reduce-scatter (sum in rank order), plain PyTorch.
  ``odc``         the paper's p2p rings: ``kernels.odc_gather`` and
                  ``kernels.odc_scatter`` -- the hand-written CUDA kernels
                  on the card, the plain rings of ``core.odc`` on the CPU.
                  A ``DeviceProfile``'s ring order is honoured.

``hier``, ``pipe``, ``pipe-int8``, ``cp`` and ``odc-overlap`` (and the
``overlap`` and ``1f1b`` schedules) are not yet ported and raise.

``param_gather`` is the differentiable gather: a ``torch.autograd.Function``
over every rank's shard whose backward is the backend's scatter-accumulate
over every rank's cotangent, so differentiating a parameter gather emits
the gradient scatter-accumulate (``CommBackend.param_gather``).

``build_schedule_grad`` places the gathers and scatters:

  ``'layer'``      FSDP: each layer's leaves are gathered inside the layer
                   (again in the recompute), and scattered in its backward,
                   once per microbatch; microbatch j of every rank runs in
                   one autograd graph, ranks with fewer microbatches padded
                   with empty ones as the JAX engine pads them.
  ``'minibatch'``  ODC: every leaf is gathered once per minibatch, each rank
                   runs its own microbatches and accumulates the full-size
                   gradients locally, and one scatter-accumulate per leaf
                   runs at the minibatch's end.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from repro_torch.core import fsdp, odc
from repro_torch.kernels import odc_gather as kgather
from repro_torch.kernels import odc_scatter as kscatter

SCHEDULES = ("layer", "minibatch", "overlap", "1f1b")
_PORTED_SCHEDULES = ("layer", "minibatch")


class CommBackend:
    """One communication strategy over the ranks' per-rank lists."""

    name = "?"

    def gather(self, shards, order=None) -> List[torch.Tensor]:
        """Per-rank (c, ...) shards -> per-rank (n*c, ...) full tensors."""
        raise NotImplementedError

    def scatter_accumulate(self, ys, order=None) -> List[torch.Tensor]:
        """Per-rank (n*c, ...) contributions -> per-rank (c, ...) sums."""
        raise NotImplementedError

    def gather_dim(self, shards, dim: int, order=None):
        """``gather`` along ``dim``; the full tensors come back contiguous,
        so every schedule and backend computes with one layout."""
        if dim == 0:
            return self.gather([s.contiguous() for s in shards], order)
        moved = [s.movedim(dim, 0).contiguous() for s in shards]
        return [f.movedim(0, dim).contiguous()
                for f in self.gather(moved, order)]

    def scatter_dim(self, ys, dim: int, order=None):
        """``scatter_accumulate`` along ``dim``."""
        if dim == 0:
            return self.scatter_accumulate([y.contiguous() for y in ys],
                                           order)
        moved = [y.movedim(dim, 0).contiguous() for y in ys]
        return [s.movedim(0, dim)
                for s in self.scatter_accumulate(moved, order)]

    def param_gather(self, shards, dim: int, order=None):
        """Differentiable gather of one leaf over every rank: forward is
        ``gather_dim``, backward ``scatter_dim`` of the cotangents."""
        return list(_ParamGather.apply(self, dim, order, *shards))

    def __repr__(self):
        return f"<CommBackend {self.name!r}>"


class _ParamGather(torch.autograd.Function):
    """Forward: gather one leaf over every rank; backward: the matching
    scatter-accumulate of every rank's cotangent (a rank whose full
    tensor got no gradient contributes zeros: autograd materializes
    them)."""

    @staticmethod
    def forward(ctx, backend, dim, order, *shards):
        ctx.backend, ctx.dim, ctx.order = backend, dim, order
        return tuple(backend.gather_dim(shards, dim, order))

    @staticmethod
    def backward(ctx, *cts):
        grads = ctx.backend.scatter_dim(cts, ctx.dim, ctx.order)
        return (None, None, None, *grads)


class CollectiveBackend(CommBackend):
    """Fused all-gather / reduce-scatter: the FSDP baseline (no ring, so
    a ring order is ignored)."""

    name = "collective"

    def gather(self, shards, order=None):
        return odc.collective_gather(shards)

    def scatter_accumulate(self, ys, order=None):
        return odc.collective_scatter(ys)


class ODCBackend(CommBackend):
    """p2p ring gather / scatter-accumulate (paper §3): the hand-written
    ring kernels on CUDA tensors, the plain rings on CPU tensors."""

    name = "odc"

    def gather(self, shards, order=None):
        return kgather.odc_gather(shards, order)

    def scatter_accumulate(self, ys, order=None):
        return kscatter.odc_scatter_accumulate(ys, order)


COLLECTIVE = CollectiveBackend()
ODC = ODCBackend()
_REGISTRY = {"collective": COLLECTIVE, "odc": ODC}
#: registry names of the JAX package that this port does not have yet
NOT_PORTED = ("odc-overlap", "overlap", "hier", "pipe", "pipe-int8", "cp",
              "cp-ring")


def backend_names():
    return tuple(sorted(_REGISTRY))


def get_backend(name) -> CommBackend:
    if isinstance(name, CommBackend):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"comm backend {name!r} is not yet ported to repro_torch "
            f"(ROADMAP §0); ported: {backend_names()}")
    raise ValueError(f"unknown comm backend {name!r}; ported: "
                     f"{backend_names()}, not yet ported: {NOT_PORTED}")


def resolve(comm, schedule: str):
    """(backend, schedule) for an engine config."""
    backend = get_backend(comm)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; one of {SCHEDULES}")
    if schedule not in _PORTED_SCHEDULES:
        raise NotImplementedError(
            f"schedule {schedule!r} is not yet ported to repro_torch "
            f"(ROADMAP §0); ported: {_PORTED_SCHEDULES}")
    return backend, schedule


# ===========================================================================
# the schedule-driven gradient loop over all ranks
# ===========================================================================
def _gather_trees(backend, trees, dims, order, differentiable):
    """Per-rank trees -> per-rank trees with every sharded leaf gathered
    (one call over all ranks per leaf)."""
    out = [dict() for _ in trees]
    for path in fsdp.tree_paths(dims):
        d = fsdp.get(dims, path)
        leaves = [fsdp.get(t, path) for t in trees]
        if d is None:
            full = leaves
        elif differentiable:
            full = backend.param_gather(leaves, d, order)
        else:
            full = backend.gather_dim(leaves, d, order)
        for o, f in zip(out, full):
            fsdp.put(o, path, f)
    return out


def trainable(tree):
    """(compute tree, gradient tree) over a tree of tensors: each leaf
    becomes a leaf tensor that requires grad, and each stacked leaf under
    ``layers`` becomes a list of per-layer leaf tensors (views), so that a
    layer's gradient lands in its slice without a full-size temporary.
    Every ``.grad`` is preset to a view of a zeroed buffer, which autograd
    then accumulates into in place; the gradient tree holds the buffers."""
    def leaf(x):
        t = x.detach().requires_grad_(True)
        g = torch.zeros_like(x)
        t.grad = g
        return t, g

    def stacked(x):
        g = torch.zeros_like(x)
        views = []
        for i in range(x.shape[0]):
            t = x[i].detach().requires_grad_(True)
            t.grad = g[i]
            views.append(t)
        return views, g

    compute, grads = {}, {}
    for path in fsdp.tree_paths(tree):
        x = fsdp.get(tree, path)
        t, g = stacked(x) if path[0] == fsdp.STACK_KEY else leaf(x)
        fsdp.put(compute, path, t)
        fsdp.put(grads, path, g)
    return compute, grads


def build_schedule_grad(schedule: str, *, loss_ranks: Callable, backend,
                        dims, order=None):
    """The gradient loop of one minibatch over all ranks.

      loss_ranks(params_list, batches, pxform) -> [(nll_sum, tokens)]
                  one lockstep forward of the ranks' batches
      dims        tree of each leaf's sharded dim (``fsdp.leaf_dims``)
      order       the rings' order (None = natural)

    Returns grad_core(shards, microbatches, counts) -> (lsums, toks,
    grads): per rank, the nll sum and token count over its microbatches
    and its (un-normalized) gradient shards.  ``microbatches[r]`` is rank
    r's list of M padded microbatches; ``counts[r]`` how many of them are
    real (the rest are empty padding).
    """
    if schedule not in _PORTED_SCHEDULES:
        raise NotImplementedError(f"schedule {schedule!r} is not yet ported")
    top_dims = {k: v for k, v in dims.items() if k != fsdp.STACK_KEY}
    lay_dims = fsdp.layer_dims(dims)

    def zero(t):
        return torch.zeros((), dtype=torch.float32, device=t.device)

    if schedule == "minibatch":
        def grad_core(shards, microbatches, counts):
            n = len(shards)
            full = _gather_trees(backend, shards, dims, order, False)
            lsums = [zero(fsdp.get(s, ("final_norm",))) for s in shards]
            toks = list(lsums)
            grads_full = []
            for r in range(n):
                compute, g = trainable(full[r])
                for mb in microbatches[r][:counts[r]]:
                    l, t = loss_ranks([compute], [mb], None)[0]
                    l.backward()
                    lsums[r] = lsums[r] + l.detach()
                    toks[r] = toks[r] + t
                del compute
                full[r] = None  # the gathered leaves are not needed now
                grads_full.append(g)
            # one scatter-accumulate per leaf, over every rank at once
            grads = [dict() for _ in range(n)]
            for path in fsdp.tree_paths(dims):
                d = fsdp.get(dims, path)
                ys = [fsdp.get(g, path) for g in grads_full]
                if d is None:
                    out = _sum_over_ranks(ys)
                else:
                    out = backend.scatter_dim(ys, d, order)
                for g, o in zip(grads, out):
                    fsdp.put(g, path, o)
                for g in grads_full:
                    fsdp.put(g, path, None)
            return lsums, toks, grads

        return grad_core

    def pxform(trees):
        """Gather every sharded leaf of these per-rank subtrees (the
        top-level leaves, or one layer's slice) through ``param_gather``."""
        d = lay_dims if set(trees[0]) == set(lay_dims) else top_dims
        return _gather_trees(backend, trees, d, order, True)

    def grad_core(shards, microbatches, counts):
        n = len(shards)
        M = len(microbatches[0])
        pairs = [trainable(s) for s in shards]
        compute = [c for c, _ in pairs]
        lsums = [zero(fsdp.get(s, ("final_norm",))) for s in shards]
        toks = list(lsums)
        for j in range(M):
            outs = loss_ranks(compute, [microbatches[r][j] for r in range(n)],
                              pxform)
            total = outs[0][0]
            for l, _ in outs[1:]:
                total = total + l
            total.backward()
            for r, (l, t) in enumerate(outs):
                lsums[r] = lsums[r] + l.detach()
                toks[r] = toks[r] + t
        grads = [g for _, g in pairs]
        # a replicated leaf's gradient is summed over the ranks
        for path in fsdp.tree_paths(dims):
            if fsdp.get(dims, path) is None:
                out = _sum_over_ranks([fsdp.get(g, path) for g in grads])
                for g, o in zip(grads, out):
                    fsdp.put(g, path, o)
        return lsums, toks, grads

    return grad_core


def _sum_over_ranks(ys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """psum over the ranks, in rank order, on every rank's device."""
    out = []
    for y in ys:
        acc = ys[0].to(y.device)
        for other in ys[1:]:
            acc = acc + other.to(y.device)
        out.append(acc)
    return out
