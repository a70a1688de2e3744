"""GPipe-style pipeline parallelism over a stage-split layer stack, on
``torch.distributed`` (the reference's ``train/pipeline.py``).

The layer stack (leading dim = n_layers) is split into S contiguous stages
along a mesh axis, one stage a rank; microbatches flow through the classic
GPipe schedule — T = M + S − 1 ticks, stage s working on microbatch
(t − s), activations handed to the next stage each tick (the reference's
``ppermute``: :class:`_PPermute`, ``batch_isend_irecv`` on the stage axis's
process group, whose backward sends the gradient the other way).  Every
tick computes on every stage (idle ticks process a zero microbatch), as in
the reference; only the last stage emits outputs, and a sum over the axis
(``all_reduce``) replicates them.  A one-stage axis sends nothing.

``pipeline_forward`` is generic: ``layer_fn(layer_params, x)`` applies ONE
layer; everything model-specific stays outside.  Each rank runs the same
program (SPMD), so every rank must call it with the same shapes, and a
loss taken from the replicated output is taken on every rank.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

__all__ = ["pipeline_forward", "split_stages"]


def split_stages(stacked_params, n_stages: int):
    """Reshape a (n_layers, ...) stack into (n_stages, layers_per_stage, ...)."""

    def one(p):
        L = p.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} stages")
        return p.reshape((n_stages, L // n_stages) + tuple(p.shape[1:]))

    return tree_map(one, stacked_params)


class _PPermute(torch.autograd.Function):
    """Send ``x`` to the next stage and take the previous stage's (cyclic,
    the reference's ``fwd = [(i, (i + 1) % S)]``); the backward sends the
    gradient to the previous stage and takes the next stage's."""

    @staticmethod
    def forward(ctx, x, group, stage: int, n_stages: int):
        ctx.group, ctx.stage, ctx.n_stages = group, stage, n_stages
        return _shift(x, group, stage, n_stages, +1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, ctx.stage, ctx.n_stages, -1), None, None, None


def _shift(x: torch.Tensor, group, stage: int, n_stages: int, step: int) -> torch.Tensor:
    """Send ``x`` to stage ``stage + step`` and return what stage ``stage -
    step`` sent (indices mod ``n_stages``), on ``group``."""
    dst = dist.get_global_rank(group, (stage + step) % n_stages)
    src = dist.get_global_rank(group, (stage - step) % n_stages)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group), dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _AxisSum(torch.autograd.Function):
    """``all_reduce`` (sum) over the stage axis.  The output is replicated
    and each rank holds the same cotangent of it, so the backward passes it
    through unchanged, as the reference's ``psum`` over a replicated output
    does (a sum of those cotangents would scale the gradient by S)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_forward(
    stage_params,  # tree (nested dicts) of tensors, leading dims (n_stages, layers_per_stage, ...)
    microbatches: torch.Tensor,  # (M, mb, ...) input microbatches
    layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],  # one *layer* application
    mesh,  # DeviceMesh
    axis: str = "stage",
) -> torch.Tensor:
    """Run the stack as an S-stage GPipe pipeline over ``mesh``'s ``axis``;
    returns (M, mb, ...), the same on every rank.  The rank at coordinate
    ``s`` of ``axis`` applies ``stage_params``' row ``s``."""
    group = mesh.get_group(axis)
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    sid = mesh.get_local_rank(axis)
    M = microbatches.shape[0]
    first = torch.tensor(sid == 0, device=microbatches.device)
    last = torch.tensor(sid == S - 1, device=microbatches.device)
    params_stage = tree_map(lambda p: p[sid], stage_params)
    n_layers = tree_leaves(params_stage)[0].shape[0]

    def stage_fn(x):
        """Apply this stage's layers_per_stage layers in turn."""
        for i in range(n_layers):
            x = layer_fn(tree_map(lambda p: p[i], params_stage), x)
        return x

    zero = torch.zeros_like(microbatches[0])
    carry = zero  # activation arriving from the left
    outputs = []
    for t in range(M + S - 1):  # static schedule
        inject = microbatches[t] if t < M else zero
        cur = torch.where(first, inject, carry)
        y = stage_fn(cur)
        # the final stage emits microbatch t-(S-1) at tick t
        if 0 <= t - (S - 1) < M:
            outputs.append(torch.where(last, y, torch.zeros_like(y)))
        if S > 1 and t < M + S - 2:  # one stage sends nothing; the last tick's hand-off is never read
            carry = _PPermute.apply(y, group, sid, S)
    # outputs live on the last stage only; replicate via the axis sum
    return _AxisSum.apply(torch.stack(outputs), group)
