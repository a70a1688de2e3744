"""DTensor helpers of a step placed on a ``DeviceMesh``.

A step whose inputs :func:`~.steps.place` put on a mesh meets DTensors in
the model, the loss and the optimizer.  This module holds what those
layers share, none of it a kernel:

* tests and conversions: :func:`is_dtensor`, :func:`mesh_of`,
  :func:`like` (a plain table met as replicated), :func:`local`,
  :func:`span` (a shard's offset and size), :func:`copies`;
* collectives over mesh dims: :func:`all_reduce_over`, :func:`sum_over`,
  :func:`grad_sum_over`;
* placements of one tensor from another's: :func:`as_dtensor`,
  :func:`redistribute_to`, :func:`map_placements`, :func:`axes_on`,
  :func:`grad_placements`, :func:`local_shard` (its gradient in the
  shard's layout, :func:`layout_grad`, :func:`in_layout`),
  :func:`from_shard`, :func:`unit_dims_whole`;
* the model's own ops on shards: :func:`zeros_rows_like` (the conv's left
  context), :func:`lookup_on_shards` (the embedding), :func:`write_token`
  (the decode cache).

The kernels' ops on shards (flash attention, the SSD scan, decode
attention) are in :mod:`repro_torch.kernels.shards`, built on these.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

__all__ = [
    "is_dtensor",
    "mesh_of",
    "like",
    "local",
    "span",
    "copies",
    "all_reduce_over",
    "sum_over",
    "grad_sum_over",
    "as_dtensor",
    "redistribute_to",
    "map_placements",
    "axes_on",
    "grad_placements",
    "in_layout",
    "layout_grad",
    "local_shard",
    "from_shard",
    "unit_dims_whole",
    "zeros_rows_like",
    "lookup_on_shards",
    "write_token",
]


def is_dtensor(*ts) -> bool:
    """Whether any of ``ts`` is a ``DTensor``."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in ts)


def mesh_of(*ts):
    """The device mesh of the first ``DTensor`` among ``ts``."""
    from torch.distributed.tensor import DTensor

    return next(t.device_mesh for t in ts if isinstance(t, DTensor))


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, run = [], 1
    for n in reversed(tuple(shape)):
        stride.append(run)
        run *= max(int(n), 1)
    return tuple(reversed(stride))


def _replicated(t: torch.Tensor, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a plain tensor made on every rank alike (a table, a mask, a
    range), as a replicated DTensor on ``ref``'s mesh where ``ref`` is a
    DTensor; else ``t`` itself."""
    if is_dtensor(ref) and not is_dtensor(t):
        return _replicated(t, ref.device_mesh)
    return t


def local(t):
    """A DTensor's local shard (the tensor itself, no copy, outside autograd),
    or ``t``."""
    return t.to_local() if is_dtensor(t) else t


def span(t, dim: int) -> Tuple[int, int]:
    """``(global offset, local size)`` of a DTensor's shard along ``dim``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return offset[dim], shape[dim]


def copies(t) -> int:
    """How many ranks hold each element of a DTensor: the product of the
    mesh dims it is replicated over."""
    from torch.distributed.tensor import Replicate

    return math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements) if isinstance(p, Replicate))


# ------------------------------------------------------------------ collectives
def all_reduce_over(t: torch.Tensor, mesh, axes: Sequence[int], op=None) -> torch.Tensor:
    """All-reduce ``t`` in place over the mesh dims ``axes`` (one collective
    where they span a mesh that is the whole world, else one a dim); returns
    it."""
    import torch.distributed as dist

    op = dist.ReduceOp.SUM if op is None else op
    axes = list(axes)
    if not axes:
        return t
    if len(axes) == mesh.ndim and mesh.size() == dist.get_world_size():
        dist.all_reduce(t, op=op)
        return t
    for i in axes:
        dist.all_reduce(t, op=op, group=mesh.get_group(i))
    return t


class _SumOver(torch.autograd.Function):
    """A sum over mesh dims whose result every rank then uses alike: the
    all-reduce forward, the gradient passed through as it is (each rank's
    part enters the sum once)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return all_reduce_over(t.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def sum_over(t: torch.Tensor, mesh, axes: Sequence[int]) -> torch.Tensor:
    """``t`` summed over the mesh dims ``axes``, with a gradient (identity:
    the sum is replicated over those dims)."""
    return _SumOver.apply(t, mesh, tuple(axes)) if axes else t


class _GradSumOver(torch.autograd.Function):
    """The other half of :class:`_SumOver`: the identity forward, the
    gradient all-reduced over the mesh dims (each rank's gradient holds the
    part of the work it did on a replicated input)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_over(grad.clone(), ctx.mesh, ctx.axes), None, None


def grad_sum_over(t: torch.Tensor, mesh, axes: Sequence[int]) -> torch.Tensor:
    """``t`` itself, its gradient summed over the mesh dims ``axes``: the
    input of work split over those dims (each rank's experts) that every
    rank holds whole."""
    return _GradSumOver.apply(t, mesh, tuple(axes)) if axes and torch.is_grad_enabled() and t.requires_grad else t


# ------------------------------------------------------------------ placements
def as_dtensor(t, mesh):
    """``t``, a plain tensor taken as replicated on ``mesh``."""
    return t if is_dtensor(t) else _replicated(t, mesh)


def redistribute_to(t, placements):
    """``t`` (a DTensor) redistributed to ``placements`` where it differs."""
    return t if tuple(t.placements) == tuple(placements) else t.redistribute(t.device_mesh, placements)


def map_placements(lead, mapping: dict):
    """Placements for another tensor, from the lead's placements
    ``lead``: ``mapping[d]`` is the other tensor's dim for the lead's
    ``Shard(d)`` (``None``: replicated there)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for p in lead:
        d = mapping.get(p.dim) if isinstance(p, Shard) else None
        out.append(Shard(d) if d is not None else Replicate())
    return out


def axes_on(placements, dim: int) -> List[int]:
    """The mesh dims that shard tensor dim ``dim``."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(placements) if isinstance(p, Shard) and p.dim == dim]


def grad_placements(lead, want):
    """The placements of the gradient of a shard at ``want`` used beside
    the lead's shard: ``Partial`` over each mesh dim that shards the lead
    but replicates this input (each rank's gradient holds only its rows' or
    its heads' part), ``want`` elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return [Partial() if isinstance(lp, Shard) and isinstance(p, Replicate) else p
            for lp, p in zip(lead.placements, want)]


def in_layout(grad, shape, stride):
    """``grad`` in the strides ``stride`` (of a tensor of ``shape``): itself
    where it has them, else a copy."""
    if grad is None or grad.stride() == tuple(stride):
        return grad
    return torch.empty_strided(shape, stride, dtype=grad.dtype, device=grad.device).copy_(grad)


class _LayoutGrad(torch.autograd.Function):
    """Identity whose gradient comes back in the input's strides."""

    @staticmethod
    def forward(ctx, t):
        ctx.layout = (t.shape, t.stride())
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return in_layout(grad, *ctx.layout)


def layout_grad(t: torch.Tensor) -> torch.Tensor:
    """``t``, its gradient handed back in ``t``'s own strides (copied where
    it comes in others).  A DTensor's ``to_local`` states the forward's
    strides for the gradient it passes on, and DTensor's pointwise backward
    ops state contiguous ones whatever their input's layout, so a gradient
    of another layout would reach a view that cannot take it.  The SSD
    scan's gradients come back in their inputs' layouts on every path
    (``SSDScan``'s backward on the card, this on the CPU's chunked form),
    so plain and sharded steps sum them in one order."""
    return _LayoutGrad.apply(t) if t.requires_grad and torch.is_grad_enabled() else t


def local_shard(t, grad_placements=None) -> torch.Tensor:
    """A DTensor's shard, its gradient (at ``grad_placements``) handed back
    in the shard's layout."""
    return layout_grad(t.to_local(grad_placements=grad_placements))


def from_shard(t: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` over the shards ``t``, contiguous (the
    kernels' outputs are; a plain version's view is copied so that a view
    of the DTensor stays one of its shard)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t.contiguous(), mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def unit_dims_whole(t):
    """``t`` with each ``Shard`` of a size-1 dim over a one-rank mesh dim
    stated as ``Replicate``: the same local tensor, no collective, the
    gradient handed back at ``t``'s placements.  DTensor's view rules treat
    a size-1 dim as a singleton and refuse to reshape it while it is
    sharded (MQA's one kv head, which the plan shards over a ``model`` dim
    of one rank); a plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    want = [Replicate() if isinstance(p, Shard) and t.shape[p.dim] == 1 and mesh.size(i) == 1 else p
            for i, p in enumerate(t.placements)]
    if want == list(t.placements):
        return t
    return DTensor.from_local(t.to_local(), mesh, want, run_check=False, shape=t.shape, stride=t.stride())


# ------------------------------------------------------------------ the model's ops
def zeros_rows_like(u: torch.Tensor, rows: int, dim: int = 1) -> torch.Tensor:
    """Zeros of ``u``'s shape with ``rows`` along ``dim`` (which ``u`` must
    not be sharded over), at ``u``'s placements when it is a DTensor: no
    rank holds more than its shard."""
    shape = list(u.shape)
    shape[dim] = rows
    if not is_dtensor(u):
        return u.new_zeros(shape)
    if axes_on(u.placements, dim):
        raise ValueError(f"zeros_rows_like: dim {dim} of the input is sharded ({u.placements})")
    loc = list(u.to_local().shape)
    loc[dim] = rows
    z = u.to_local().new_zeros(loc)
    return from_shard(z, u.device_mesh, u.placements, shape)


def lookup_on_shards(table, ids):
    """``table[ids]`` of a DTensor ``table`` ``(V, d)`` on each rank's shard:
    the table gathered over every mesh dim but those that split its
    vocabulary (FSDP's gather of ``d``), the ids over the rest of their
    placements; each rank looks up the ids its block of the vocabulary
    holds (zero for the others) and the rows are summed over the vocabulary
    dims.  The lookup is plain indexing on the shard, so its gradient is the
    plain one's (summed back over the ranks by DTensor)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = mesh_of(table, ids)
    table = as_dtensor(table, mesh)
    want = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in table.placements]
    table = redistribute_to(table, want)
    vocab_axes = axes_on(want, 0)
    ids = as_dtensor(ids, mesh)
    id_place = [Replicate() if i in vocab_axes or not isinstance(p, Shard) else p
                for i, p in enumerate(ids.placements)]
    ids = redistribute_to(ids, id_place)
    part = local_shard(table, grad_placements(ids, want))
    at = ids.to_local()
    if vocab_axes:
        off, n = span(table, 0)
        at = at - off
        mine = (at >= 0) & (at < n)
        rows = part[at.clamp(0, n - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    else:
        rows = part[at]
    out = from_shard(rows, mesh, [Partial() if i in vocab_axes else p for i, p in enumerate(id_place)],
                     (*ids.shape, table.shape[1]))
    return redistribute_to(out, [Replicate() if i in vocab_axes else p for i, p in enumerate(id_place)])


def write_token(cache, new, pos) -> None:
    """Write ``new`` ``(B, ...)`` at row ``pos`` ``(B,)`` of each sequence of
    ``cache`` ``(B, S, ...)``, a DTensor, in place on each rank's shard:
    ``new`` and ``pos`` brought to the cache's batch (and head) placements,
    the rows local to the rank's batch block, and where the cache is split
    over its sequence only the rank holding a row writes it (the others
    write back what they hold, so the step makes no host sync)."""
    mesh = cache.device_mesh
    cp = cache.placements
    new = redistribute_to(as_dtensor(new, mesh),
                          map_placements(cp, {0: 0, **{d: d - 1 for d in range(2, cache.ndim)}})).to_local()
    pos = redistribute_to(as_dtensor(pos, mesh), map_placements(cp, {0: 0})).to_local()
    store = cache.to_local()
    rows = torch.arange(store.shape[0], device=store.device)
    new = new.to(store.dtype)
    if not axes_on(cp, 1):
        store[rows, pos] = new
        return
    s0, n = span(cache, 1)
    at = pos.long() - s0
    mine = (at >= 0) & (at < n)
    at = at.clamp(0, n - 1)
    keep = store[rows, at]
    store[rows, at] = torch.where(mine.view(-1, *([1] * (new.ndim - 1))), new, keep)
