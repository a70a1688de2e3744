"""AdamW with decoupled weight decay, as functions on tensor dicts.

The math is the reference's (``optim/adamw.py:48-78``), not
``torch.optim.AdamW``'s: weight decay on **every** leaf, bias correction
from the incremented step, the update computed in fp32 and stored back in
each leaf's dtype, moments in ``ModelConfig.opt_state_dtype``; gradients
in another dtype than fp32 (a bf16 accumulator's) are read in fp32 op by op,
never copied to fp32 whole.  Trees are
flat ``{name: tensor}`` dicts (``dict(model.named_parameters())``).  Unlike
the reference's pure update, :func:`adamw_update` writes the parameters and
moments **in place**, so a step holds no second copy of either; the
elementwise work runs as ``torch._foreach_*`` ops over slices of the tree:
groups of leaves, a large leaf cut into runs of its elements, each slice at
most :data:`CHUNK_ELEMS` elements, so the fp32 temporaries (``denom``, ``delta``
and the fp32 copies of leaves kept in another dtype) stay bounded whatever
the model's size.  The update is elementwise, so slicing changes no bit.

DTensor leaves (a step on a mesh, gradients at their parameters'
placements) are updated on each rank's local shards; only
:func:`global_norm` talks to the other ranks, with one all-reduce of the
shards' squared norms, each divided by the ranks that hold a copy of it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from ..launch.dtensors import all_reduce_over, copies, is_dtensor, like, local

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "clip_by_global_norm", "CHUNK_ELEMS"]

Tree = Dict[str, torch.Tensor]

#: elements a slice of the update holds: at bf16 leaves ~20 bytes of fp32
#: temporaries an element (p, m and v in fp32, denom, delta), so ~1.3 GB a slice
#: (chip_smoke.py's dense_train_full_width reads the update's peak)
CHUNK_ELEMS = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Tree, moment_dtype: torch.dtype = torch.float32) -> Dict[str, object]:
    """``{"m", "v"}`` zeroed like ``params`` in ``moment_dtype``, and ``"step"`` 0
    (an int64 scalar tensor on the CPU)."""
    zeros = {n: torch.zeros(p.shape, dtype=moment_dtype, device=p.device) for n, p in params.items()}
    return {
        "m": zeros,
        "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
        "step": torch.zeros((), dtype=torch.int64),
    }


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a leaf in another
    dtype is read in fp32 without an fp32 copy of it).  Of DTensor leaves:
    each leaf's norm from its shards' squared norms, all-reduced once over
    the mesh, each shard's divided by the ranks that hold a copy of it (on
    one rank ``sqrt(n·n)``, which is ``n`` exactly)."""
    leaves = list(tree.values())
    parts = [local(t) for t in leaves]
    if all(t.dtype == torch.float32 for t in parts):
        norms = torch._foreach_norm(parts)
    else:
        norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in parts]
    if is_dtensor(*leaves):
        mesh = leaves[0].device_mesh
        held = torch.tensor([copies(t) for t in leaves], dtype=torch.float32, device=norms[0].device)
        square = all_reduce_over(torch.stack(norms).square() / held, mesh, range(mesh.ndim))
        return torch.linalg.vector_norm(square.sqrt())
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """Scale ``tree`` (gradients) **in place** by ``min(1, max_norm /
    norm)``; returns it and its norm before clipping.  A leaf kept in
    another dtype than fp32 (a bf16 accumulator) is scaled in fp32 and
    stored back in its dtype, as the reference does."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    parts = [local(t) for t in tree.values()]
    fp32 = [t for t in parts if t.dtype == torch.float32]
    if fp32:
        torch._foreach_mul_(fp32, scale)
    for t in parts:
        if t.dtype != torch.float32:
            t.copy_(t.float() * scale)
    return tree, norm


def _slices(leaves: List[Tuple[torch.Tensor, ...]], chunk_elems: int) -> List[List[Tuple[torch.Tensor, ...]]]:
    """Groups of at most ``chunk_elems`` elements of ``(g, p, m, v)`` rows,
    in the tree's order: small leaves share a group; a contiguous leaf
    larger than the budget is cut into flat views of ``chunk_elems``
    elements (a non-contiguous one stays whole: a view of it cannot be
    flattened in place)."""
    groups: List[List[Tuple[torch.Tensor, ...]]] = [[]]
    size = 0
    for row in leaves:
        n = row[0].numel()
        if n > chunk_elems and all(t.is_contiguous() for t in row):
            flat = [t.view(-1) for t in row]
            pieces = [tuple(f[i : i + chunk_elems] for f in flat) for i in range(0, n, chunk_elems)]
        else:
            pieces = [row]
        for piece in pieces:
            n = piece[0].numel()
            if groups[-1] and size + n > chunk_elems:
                groups.append([])
                size = 0
            groups[-1].append(piece)
            size += n
    return groups


@torch.no_grad()
def adamw_update(
    grads: Tree, opt_state: Dict[str, object], params: Tree, lr: float, cfg: AdamWConfig = AdamWConfig(),
) -> Dict[str, object]:
    """One AdamW step, **in place** on ``params`` and the moments, slice by
    slice (:func:`_slices`; DTensor leaves on their local shards); returns
    ``opt_state`` with ``step`` incremented."""
    step = local(opt_state["step"]) + 1
    stepf = step.to(torch.float32)
    c1 = float(1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf)
    c2 = float(1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf)
    rows = [tuple(local(t) for t in (grads[n], params[n], opt_state["m"][n], opt_state["v"][n])) for n in params]
    for group in _slices(rows, CHUNK_ELEMS):
        g, p_store, m_store, v_store = (list(col) for col in zip(*group))
        # a bf16 gradient (a bf16 accumulator's) promotes to fp32 op by op: no fp32 copy
        p32 = [t.float() for t in p_store]  # the tensor itself when it is fp32
        m32 = [t.float() for t in m_store]
        v32 = [t.float() for t in v_store]

        torch._foreach_mul_(m32, cfg.b1)
        torch._foreach_add_(m32, g, alpha=1.0 - cfg.b1)
        torch._foreach_mul_(v32, cfg.b2)
        torch._foreach_addcmul_(v32, g, g, value=1.0 - cfg.b2)
        denom = torch._foreach_div(v32, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        delta = torch._foreach_div(m32, c1)
        torch._foreach_div_(delta, denom)  # mhat / (sqrt(vhat) + eps)
        torch._foreach_add_(delta, p32, alpha=cfg.weight_decay)
        torch._foreach_add_(p32, delta, alpha=-float(lr))

        for store, new in zip(p_store + m_store + v_store, p32 + m32 + v32):
            if new is not store:  # a leaf kept in another dtype than fp32
                store.copy_(new)
    return {**opt_state, "step": like(step, opt_state["step"])}
