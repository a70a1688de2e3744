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
    "attention_ref", "attention_lse_ref", "flash_backward_ref", "flash_blocked_ref", "ssd_ref", "ssd_chunked_ref",
    "ssd_tiled_ref", "segment_scatter_ref", "segment_scatter_warp_ref", "scatter_add_ref", "running_sum_ref",
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


def flash_blocked_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    prefix_len: int = 0,
    q_block: int = 256,
    kv_block: int = 1024,
    n_causal_chunks: int = 8,
    p_bf16_terms: int = 0,
) -> torch.Tensor:
    """Blocked online-softmax attention, the reference's ``_xla_flash``
    (``repro/kernels/ops.py:38``) in torch: the same blocks, masks and
    fp32 running max, denominator and accumulator as a flash kernel.

    Causal attention runs at most ``n_causal_chunks`` query chunks, each over
    the kv blocks up to its diagonal; every kv block takes the padded-tail,
    causal and prefix-LM masks.  ``p_bf16_terms`` models the bf16
    tensor-core kernel's rounding of the probabilities before the second
    product: 0 keeps them fp32 (the reference), 1 rounds P to bf16, 2
    carries P as ``hi + lo`` with ``hi = bf16(P)`` and ``lo = bf16(P - hi)``,
    as the kernel does; the denominator sums them unrounded, as the kernel
    does."""
    if p_bf16_terms not in (0, 1, 2):
        raise ValueError(f"p_bf16_terms is 0, 1 or 2, got {p_bf16_terms}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    Dv = v.shape[-1]  # MLA: the value width may differ from the key width
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    kf, vf = k.float(), v.float()
    neg = torch.finfo(torch.float32).min

    def chunk_attn(q0: int, qc: torch.Tensor, k_end: int) -> torch.Tensor:
        nb = max(1, -(-k_end // kv_block))
        pad = max(0, nb * kv_block - Sk)
        kb = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad))[:, : nb * kv_block]
        vb = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))[:, : nb * kv_block]
        rows = q0 + torch.arange(qc.shape[1], device=q.device) + (Sk - Sq)
        m = torch.full(qc.shape[:-1], neg, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape[:-1] + (Dv,), dtype=torch.float32, device=q.device)
        for ki in range(nb):
            kblk = kb[:, ki * kv_block : (ki + 1) * kv_block]
            vblk = vb[:, ki * kv_block : (ki + 1) * kv_block]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qc, kblk) * scale
            cols = ki * kv_block + torch.arange(kv_block, device=q.device)
            mask = cols[None, :] < k_end  # padded kv tail
            if causal:
                cmask = rows[:, None] >= cols[None, :]
                if prefix_len > 0:
                    cmask = cmask | (cols[None, :] < prefix_len)
                mask = mask & cmask
            s = s.masked_fill(~mask[None, :, None, None, :], neg)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = p
            if p_bf16_terms:
                pv = p.to(torch.bfloat16).float()
                if p_bf16_terms == 2:
                    pv = pv + (p - pv).to(torch.bfloat16).float()
            acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", pv, vblk)
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        return acc / l[..., None]

    if not causal:
        o = chunk_attn(0, qf, Sk)
        return o.reshape(B, Sq, Hq, Dv).to(q.dtype)
    n_chunks = min(n_causal_chunks, max(1, -(-Sq // q_block)))
    qc_size = -(-Sq // n_chunks)
    outs = []
    for i in range(n_chunks):
        q0, q1 = i * qc_size, min((i + 1) * qc_size, Sq)
        if q0 >= q1:
            break
        k_end = min(Sk, q1 + (Sk - Sq))
        outs.append(chunk_attn(q0, qf[:, q0:q1], max(1, k_end)))
    o = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return o.reshape(B, Sq, Hq, Dv).to(q.dtype)


def _scores(q, k, causal, scale, prefix_len=0):
    """fp32 scores ``(B, Hkv, G, Sq, Sk)`` (already scaled) and the visible
    mask ``(Sq, Sk)``; with ``causal`` the last query aligns with the last
    key, and every query also sees the first ``prefix_len`` keys (prefix-LM,
    as :func:`attention_ref`)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv != 0:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ki = torch.arange(Sk, device=q.device)[None, :]
        mask = (torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)) >= ki
        if prefix_len > 0:
            mask = mask | (ki < prefix_len)
    return s, mask


def attention_lse_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Per-row logsumexp of the scaled, masked scores, ``(B, Hq, Sq)`` fp32:
    what the flash kernels write beside their output for the backward.  A
    row that sees no key gets ``+inf``, which the backward reads as "no
    mass": ``exp(s - inf)`` is 0 for every score.  ``v`` is not read; it is
    taken so that the call matches :func:`attention_ref`'s."""
    B, Sq, Hq, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    s, mask = _scores(q, k, causal, scale, prefix_len)
    lse = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)  # -inf where no key
    lse = torch.where(mask.any(-1), lse, torch.inf)
    return lse.reshape(B, Hq, Sq)


def flash_backward_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    o: torch.Tensor,  # (B, Sq, Hq, Dv)  the forward's output
    lse: torch.Tensor,  # (B, Hq, Sq)    the forward's logsumexp
    do: torch.Tensor,  # (B, Sq, Hq, Dv) the output's gradient
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    prefix_len: int = 0,
    p_bf16_terms: int = 0,
    ds_bf16_terms: int = 0,
):
    """The FlashAttention-2 backward in plain torch, ``(dq, dk, dv)`` in the
    inputs' dtypes; everything in between is fp32:

    ``Dᵢ = rowsum(dO ∘ O)``; P recomputed from the saved logsumexp,
    ``P = exp(S·scale − lse)`` on visible entries and 0 elsewhere;
    ``dV = Pᵀ dO``, ``dP = dO Vᵀ``, ``dS = P ∘ (dP − Dᵢ)``,
    ``dQ = dS K · scale``, ``dK = dSᵀ Q · scale``; dK and dV summed over
    each GQA group; the visible entries are :func:`attention_ref`'s (with
    ``causal``, the diagonal and the first ``prefix_len`` keys).  A row
    whose lse is ``+inf`` (no visible key) has ``P = 0`` and gives no
    gradient.  This is what the backward kernels
    compute; the JAX package differentiates its blocked form instead.

    ``p_bf16_terms`` and ``ds_bf16_terms`` model the bf16 tensor-core
    kernel's rounding of P before ``dV = Pᵀ dO`` and of dS before
    ``dQ = dS K`` and ``dK = dSᵀ Q``: 0 keeps them fp32 (the SIMT kernel), 1
    rounds to bf16, 2 carries ``hi + lo`` with ``hi = bf16(x)`` and ``lo =
    bf16(x - hi)``; dS itself is formed from the unrounded P, as the
    kernel forms it."""
    for name, terms in (("p_bf16_terms", p_bf16_terms), ("ds_bf16_terms", ds_bf16_terms)):
        if terms not in (0, 1, 2):
            raise ValueError(f"{name} is 0, 1 or 2, got {terms}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    s, mask = _scores(q, k, causal, scale, prefix_len)
    p = torch.where(mask, torch.exp(s - lse.float().reshape(B, Hkv, G, Sq, 1)), 0.0)
    dof = do.float().reshape(B, Sq, Hkv, G, Dv)
    delta = (dof * o.float().reshape(B, Sq, Hkv, G, Dv)).sum(-1).permute(0, 2, 3, 1)  # (B, Hkv, G, Sq)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", _bf16_terms(p, p_bf16_terms), dof)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float()) - delta[..., None])
    ds = _bf16_terms(ds, ds_bf16_terms)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(B, Sq, Hq, D) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().reshape(B, Sq, Hkv, G, D)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _bf16_terms(v: torch.Tensor, terms: int) -> torch.Tensor:
    """``v`` as the tensor cores see it: 0 keeps it (fp32), 1 rounds it to
    bf16, 2 carries it as ``hi + lo`` with ``hi = bf16(v)`` and ``lo =
    bf16(v - hi)``."""
    if terms == 0:
        return v
    hi = v.to(torch.bfloat16).float()
    return hi if terms == 1 else hi + (v - hi).to(torch.bfloat16).float()


def ssd_tiled_ref(
    x, dt, A, Bm, Cm, D=None, h0=None, *, tile: int = 64, tiles_per_chunk: int = 1,
    m_terms: int = 0, h_terms: int = 0, xw_terms: int = 0, cum64: bool = False,
):
    """The bf16 tensor-core SSD kernel's three phases in plain torch, fp32.

    The sequence is cut into tiles of ``tile`` rows (the last one padded
    with dt = 0, which leaves it inert) and the tiles into chunks of
    ``tiles_per_chunk``.  (1) Per tile: ``cum`` = inclusive prefix of A·dt,
    ``C Bᵀ`` per (batch, group), and per chunk its own state, tile by tile
    from 0: ``h = exp(cum_L)·h + Xwᵀ B`` with ``Xw = x ⊙ exp(cum_L − cum)·dt``.
    (2) Across chunks in order: the entering state ``h_in[c]``, from ``h0``,
    and the final state.  (3) Per tile, from the entering state and the
    state update inside the chunk: ``y = M X + exp(cum_t)·(C hᵀ)`` with
    ``M = tril(C Bᵀ) ⊙ exp(cum_t − cum_s) ⊙ dt_s + diag(D)`` (the skip term on
    M's diagonal, as the kernel does).

    ``m_terms``, ``h_terms`` and ``xw_terms`` round M, the state entering
    each tile's ``C hᵀ`` and ``Xw`` to bf16 before their products as the
    kernel does (:func:`_bf16_terms`: 0 none, 1 one term, 2 hi + lo); C, B
    and x enter as given.  With ``cum64`` the prefix ``cum``
    is summed in fp64 and the decays' arguments (``cum_t − cum_s``,
    ``cum_L − cum_s``, ``cum_t``, ``cum_L``) are taken from it in fp64, then
    rounded to fp32 for the exponent, as the bf16 kernel does: two fp32
    prefixes, which reach thousands inside a tile as trained gates make
    them, differ with an error of their spacing (up to ~1e-3), which
    outputs where large terms cancel do not survive.  Any head dim P: at P
    = 128 the kernel gives each
    of a block's two warpgroups 64 of the state's rows and of y's columns,
    which changes no sum and no rounding point, so this model covers both
    head dims it takes.  Returns y in x's dtype and the final state."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L, Q = tile, tiles_per_chunk
    nT = -(-S // L)
    pad = nT * L - S
    f = torch.float32
    xf = torch.nn.functional.pad(x.to(f), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nT, L, H, P)
    dtf = torch.nn.functional.pad(dt.to(f), (0, 0, 0, pad)).reshape(Bsz, nT, L, H)
    Bf = torch.nn.functional.pad(Bm.to(f), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nT, L, G, N)
    Cf = torch.nn.functional.pad(Cm.to(f), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nT, L, G, N)
    Bh, Ch = Bf.repeat_interleave(rep, dim=3), Cf.repeat_interleave(rep, dim=3)  # (B, nT, L, H, N)

    if cum64:
        cum64_ = torch.cumsum(A.double() * dtf.double(), dim=2)
        cum = cum64_.to(f)
        seg = lambda a, b: (a - b).to(f)  # noqa: E731  the fp64 difference, rounded once
    else:
        cum64_ = cum = torch.cumsum(A.to(f) * dtf, dim=2)  # (B, nT, L, H)
        seg = lambda a, b: a - b  # noqa: E731
    cum_L = cum[:, :, -1]  # (B, nT, H)
    w = torch.exp(seg(cum64_[:, :, -1:], cum64_)) * dtf
    xw = _bf16_terms(xf * w[..., None], xw_terms)
    local = torch.einsum("btlhp,btlhn->bthpn", xw, Bh)  # each tile's own state

    # (1) each chunk's own state, tile by tile from 0; (2) the pass across chunks
    nC = -(-nT // Q)
    h = h0.to(f) if h0 is not None else x.new_zeros((Bsz, H, P, N), dtype=f)
    h_tile = []  # the state entering each tile
    for c in range(nC):
        own = torch.zeros_like(h)
        for q in range(c * Q, min((c + 1) * Q, nT)):
            own = own * torch.exp(cum_L[:, q])[..., None, None] + local[:, q]
        enter = h
        h = h * torch.exp(cum_L[:, c * Q : (c + 1) * Q].sum(1))[..., None, None] + own
        # (3) inside the chunk, the state moves on tile by tile from its entering state
        for q in range(c * Q, min((c + 1) * Q, nT)):
            h_tile.append(enter)
            enter = enter * torch.exp(cum_L[:, q])[..., None, None] + local[:, q]
    h_in = _bf16_terms(torch.stack(h_tile, dim=1), h_terms) if nT else xf.new_zeros((Bsz, 0, H, P, N))

    CB = torch.einsum("btlgn,btsgn->btgls", Cf, Bf).repeat_interleave(rep, dim=2)  # (B, nT, H, L, L)
    diff = seg(cum64_[:, :, :, None, :], cum64_[:, :, None, :, :]).movedim(-1, 2)  # (B, nT, H, L, L): cum_t − cum_s
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    M = CB.masked_fill(~tri, 0.0) * torch.exp(diff.masked_fill(~tri, float("-inf")))
    M = M * dtf.movedim(-1, 2)[:, :, :, None, :]
    if D is not None:
        M = M + torch.diag_embed(D.to(f)[None, None, :, None].expand(Bsz, nT, H, L))
    M = _bf16_terms(M, m_terms)
    y = torch.einsum("bthls,btshp->btlhp", M, xf)
    y = y + torch.exp(cum)[..., None] * torch.einsum("btlhn,bthpn->btlhp", Ch, h_in)
    y = y.reshape(Bsz, nT * L, H, P)[:, :S].to(x.dtype)
    return y, h


def segment_scatter_warp_ref(
    seg: torch.Tensor, lin: torch.Tensor, cnt: torch.Tensor, n_segs: int, row_size: int, seg_col: bool = True
):
    """The segment kernel's warp-aggregated landing, step for step.

    A warp takes a window of 64 consecutive events, lane ``l`` holding
    events ``2l`` and ``2l + 1``.  A dropped (``seg >= n_segs``), missing
    (past the end) or out-of-table event carries key -1 and lands nothing
    (the out-of-table ones are counted).  A lane whose two events share a
    key adds the second's count into the first.  Then, once for the lanes'
    first events and once for their second, the lanes of equal key sum
    their counts (uint64 as int64, wrapping) and the lowest of them lands
    the sum.  ``seg_col=False`` is the accumulate entry (``seg`` ignored,
    the key is ``lin``).  Returns the table, the ``(1,)`` count of kept
    events outside it, and the number of landings (the kernel's atomics)."""
    n, size = lin.numel(), n_segs * row_size
    key = (seg * row_size + lin) if seg_col else lin.clone()
    kept = (seg < n_segs) if seg_col else torch.ones(n, dtype=torch.bool, device=lin.device)
    bad = kept & ((key < 0) | (key >= size))
    key = torch.where(kept & ~bad, key, torch.full_like(key, -1))
    pad = -n % 64
    key = torch.nn.functional.pad(key, (0, pad), value=-1).reshape(-1, 32, 2)  # (window, lane, event)
    c = torch.nn.functional.pad(cnt, (0, pad)).reshape(-1, 32, 2).clone()
    pair = (key[..., 0] >= 0) & (key[..., 0] == key[..., 1])
    c[..., 0] += torch.where(pair, c[..., 1], torch.zeros_like(c[..., 1]))
    key[..., 1] = torch.where(pair, torch.full_like(key[..., 1], -1), key[..., 1])
    table = torch.zeros(size, dtype=torch.int64, device=lin.device)
    landings = 0
    for j in (0, 1):
        k, v = key[..., j], c[..., j]  # (window, lane)
        peers = k[:, :, None] == k[:, None, :]  # (window, lane, other lane)
        leader = peers.int().argmax(dim=2) == torch.arange(32, device=lin.device)  # lowest lane of its key
        total = (peers * v[:, None, :]).sum(dim=2)
        lands = leader & (k >= 0)
        table.index_put_((k[lands],), total[lands], accumulate=True)
        landings += int(lands.sum())
    return table.reshape(n_segs, row_size), bad.sum().reshape(1), landings


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
