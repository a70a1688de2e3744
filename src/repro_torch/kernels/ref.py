"""Plain PyTorch versions of the port's kernels (the correctness oracles).

These are naive on purpose (full score matrices, sequential recurrences,
fp32 throughout): the CPU path of every wrapper, and what ``chip_smoke.py``
holds each kernel against on the card.  The SSD forms compute in fp32, or
in fp64 when given fp64 inputs (for ``torch.autograd.gradcheck``).  The
simulator's landing ops keep uint64 counts in int64 storage (the same bits;
torch's uint64 support is partial) and add with wraparound mod 2^64.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "attention_ref", "ssd_ref", "ssd_chunked_ref", "segment_scatter_ref", "scatter_add_ref", "running_sum_ref",
]


def attention_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    prefix_len: int = 0,  # prefix-LM: bidirectional over the first N positions
    kv_len: Optional[torch.Tensor] = None,  # (B,) per-batch valid cache length
) -> torch.Tensor:
    """Full-softmax GQA attention with fp32 accumulation.

    Query head ``h`` reads kv head ``h // group``.  With ``causal`` the last
    query aligns with the last key.  A row with no visible key gives zeros,
    as the flash kernels do (the softmax of an all-masked row is undefined).
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv != 0:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    qf = q.float().reshape(B, Sq, Hkv, G, D)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale

    mask = torch.ones((B, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)  # align last q with last k
        ki = torch.arange(Sk, device=q.device)[None, :]
        cmask = qi >= ki
        if prefix_len > 0:
            cmask = cmask | (ki < prefix_len)
        mask = mask & cmask[None]
    if kv_len is not None:
        valid = torch.arange(Sk, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
        mask = mask & valid[:, None, :]
    neg = torch.finfo(torch.float32).min
    s = s.masked_fill(~mask[:, None, None], neg)

    p = torch.softmax(s, dim=-1)
    p = p * mask.any(dim=-1)[:, None, None, :, None]  # all-masked rows → 0
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return o.reshape(B, Sq, Hq, -1).to(q.dtype)


def _ssd_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ssd_ref(
    x: torch.Tensor,  # (B, S, H, P)   per-head inputs
    dt: torch.Tensor,  # (B, S, H)      positive step sizes
    A: torch.Tensor,  # (H,)           negative decay rates
    Bm: torch.Tensor,  # (B, S, G, N)   input matrices (G groups)
    Cm: torch.Tensor,  # (B, S, G, N)   output matrices
    D: Optional[torch.Tensor] = None,  # (H,) skip gain
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) initial state
    return_state: bool = False,
):
    """Sequential Mamba-2 SSD recurrence (the exact semantics):

        h_t = exp(A·dt_t) · h_{t-1} + dt_t · (x_t ⊗ B_t)
        y_t = (h_t · C_t) + D · x_t

    Head ``h`` reads group ``h // (H/G)`` of B and C.  Returns y in x's
    dtype and, with ``return_state``, the final state in the compute dtype."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f = _ssd_dtype(x)
    xf, dtf, Af = x.to(f), dt.to(f), A.to(f)
    Bf = Bm.to(f).repeat_interleave(rep, dim=2)  # (B,S,H,N)
    Cf = Cm.to(f).repeat_interleave(rep, dim=2)
    h = h0.to(f) if h0 is not None else torch.zeros((Bsz, H, P, N), dtype=f, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(Af * dtf[:, t])  # (B,H)
        upd = dtf[:, t, :, None, None] * (xf[:, t, :, :, None] * Bf[:, t, :, None, :])
        h = h * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bsz, 0, H, P))
    if D is not None:
        y = y + D.to(f)[None, None, :, None] * xf
    y = y.to(x.dtype)
    return (y, h) if return_state else y


def ssd_chunked_ref(
    x, dt, A, Bm, Cm, D=None, h0=None, chunk: int = 64, return_state: bool = False
):
    """Chunked (parallel-form) SSD: the same math as :func:`ssd_ref`,
    organised as the Mamba-2 block decomposition over chunks of ``chunk``
    rows (which must divide S).  Differentiable: the masked ``s > t``
    entries are set to -inf **before** ``exp``, so they neither overflow nor
    carry a NaN gradient through the dead branch."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    if chunk <= 0 or S % chunk != 0:
        raise ValueError(f"chunk {chunk} does not divide seq len {S}")
    nC = S // chunk
    f = _ssd_dtype(x)

    xf = x.to(f).reshape(Bsz, nC, chunk, H, P)
    dtf = dt.to(f).reshape(Bsz, nC, chunk, H)
    Af = A.to(f)
    Bf = Bm.to(f).repeat_interleave(rep, dim=2).reshape(Bsz, nC, chunk, H, N)
    Cf = Cm.to(f).repeat_interleave(rep, dim=2).reshape(Bsz, nC, chunk, H, N)

    cum = torch.cumsum(Af * dtf, dim=2)  # (B,nC,L,H): s_t = sum_{u<=t} a_u

    # intra-chunk: M[t,s] = (C_t·B_s) · exp(s_t − s_s) · dt_s   for s <= t
    CB = torch.einsum("bclhn,bcmhn->bchlm", Cf, Bf)  # (B,nC,H,L,L)
    diff = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).movedim(-1, 2)  # (B,nC,H,L,L)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    diff = diff.masked_fill(~tri, float("-inf"))
    M = CB.masked_fill(~tri, 0.0) * torch.exp(diff)
    M = M * dtf.movedim(-1, 2)[:, :, :, None, :]  # × dt_s
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", M, xf)

    # chunk summaries: the state contribution of each chunk
    seg = torch.exp(cum[:, :, -1:, :] - cum)  # exp(s_L − s_s)
    states = torch.einsum("bclhn,bclhp->bchpn", Bf * (seg * dtf)[..., None], xf)

    # inter-chunk recurrence over the chunk summaries
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nC,H)
    h = h0.to(f) if h0 is not None else torch.zeros((Bsz, H, P, N), dtype=f, device=x.device)
    h_prevs = []
    for c in range(nC):
        h_prevs.append(h)  # the state entering chunk c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)  # (B,nC,H,P,N)

    # inter-chunk output: y_t += C_t · (exp(s_t) · h_prev)
    y_inter = torch.einsum("bclhn,bchpn->bclhp", Cf * torch.exp(cum)[..., None], h_prev)

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    if D is not None:
        y = y + D.to(f)[None, None, :, None] * x.to(f)
    y = y.to(x.dtype)
    return (y, h) if return_state else y


def scatter_add_ref(dense: torch.Tensor, lin: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """``dense[lin[i]] += cnt[i]`` in place, duplicates summed, on a 1-D
    int64 ``dense`` (uint64 counts as int64).  An index outside ``dense`` is
    skipped; returns their number as a ``(1,)`` int64 tensor, as the kernel
    does, so that the caller can raise."""
    ok = (lin >= 0) & (lin < dense.numel())
    dense.index_put_((lin[ok],), cnt[ok], accumulate=True)
    return (~ok).sum().reshape(1)


def segment_scatter_ref(
    seg: torch.Tensor, lin: torch.Tensor, cnt: torch.Tensor, n_segs: int, row_size: int
):
    """The segment scatter: a zeroed ``(n_segs, row_size)`` int64 table with
    ``cnt[i]`` added at flat index ``seg[i] * row_size + lin[i]`` for every
    event with ``seg[i] < n_segs``; the rest are dropped.  Returns the table
    and the ``(1,)`` count of kept events whose flat index lies outside it."""
    keep = seg < n_segs
    table = torch.zeros(n_segs * row_size, dtype=torch.int64, device=seg.device)
    bad = scatter_add_ref(table, seg[keep] * row_size + lin[keep], cnt[keep])
    return table.reshape(n_segs, row_size), bad


def running_sum_ref(values: torch.Tensor) -> torch.Tensor:
    """Prefix sum along axis 0 as a strict left fold, one row at a time:
    ``out[r] = out[r - 1] + values[r]``, so float64 rounds as
    ``np.add.accumulate`` does (``torch.cumsum`` may reassociate)."""
    out = torch.empty_like(values)
    if values.shape[0] == 0:
        return out
    acc = values[0].clone()
    out[0] = acc
    for r in range(1, values.shape[0]):
        acc = acc + values[r]
        out[r] = acc
    return out
