"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

They are the ground truth the CUDA kernels are held to on the card, and
what a kernel wrapper runs when its tensor lies on the CPU.  Each follows
its JAX oracle step for step, including the order of the casts.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

#: Expert activations.  ``jax.nn.gelu`` defaults to the tanh approximation,
#: so every gelu in the port is ``approximate="tanh"``.
ACT = {"silu": F.silu, "gelu": functools.partial(F.gelu, approximate="tanh")}


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q, k, v: (B, L, H, hd) (K/V already head-repeated).  f32 scores
    masked with ``-inf``, f32 softmax; returns (B, Lq, H, hd) in q's
    dtype."""
    B, Lq, H, hd = q.shape
    Lk = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qp = torch.arange(Lq, device=q.device)[:, None]
    kp = torch.arange(Lk, device=q.device)[None, :]
    ok = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= qp - kp < window
    s = torch.where(ok[None, None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def expert_ffn_ref(x, w1, w3, w2, *, act="silu"):
    """Grouped expert FFN. x: (E, T, M); w1/w3: (E, M, F); w2: (E, F, M).
    Mixed dtypes promote as in ``jnp.einsum``."""
    dt = torch.promote_types(x.dtype, w1.dtype)
    x = x.to(dt)
    h = torch.einsum("etm,emf->etf", x, w1.to(dt))
    if w3 is not None:
        h = ACT[act](h) * torch.einsum("etm,emf->etf", x, w3.to(dt))
    else:
        h = ACT[act](h)
    return torch.einsum("etf,efm->etm", h, w2.to(dt))


def expert_ffn_ragged_ref(xb, counts, w1, w3, w2, *, act="silu"):
    """Ragged grouped FFN over a (E, G, c, M) pool with (E, G) routed-row
    counts: the FFN in f32, rows at index >= counts[e, g] multiplied by 0
    (exact zeros for finite values), cast back to ``xb.dtype``."""
    E, G, c, M = xb.shape
    h = expert_ffn_ref(xb.reshape(E, G * c, M).float(), w1, w3, w2, act=act)
    mask = torch.arange(c, device=xb.device)[None, None, :] \
        < counts[:, :, None]
    h = h.reshape(E, G, c, M) * mask[..., None].to(h.dtype)
    return h.to(xb.dtype)


def scatter_rows_in_order(src, idx, n_rows):
    """``out[idx[i]] += src[i]`` for i in ascending order, from zeros,
    rounded to ``src.dtype`` after each addition: the order of JAX's
    ``zeros.at[idx].add(src)``.  src: (N, M); idx: (N,) int32 or int64 in
    [0, n_rows] (``n_rows`` = dropped).  Returns (n_rows, M).

    The passes are planned on the host from one read of ``idx``.  Where
    no kept row is named twice, one ``index_add_`` (each row receives at
    most one term, so any order gives the same bits); else one
    ``index_add_`` per occurrence rank (an entry's position among the
    entries naming its row, in entry order): within a pass no kept row
    repeats, so each addition rounds once, and the passes run in entry
    order.  Dropped entries land in one discarded row, or in no pass."""
    N, M = src.shape
    out = torch.zeros((n_rows + 1, M), dtype=src.dtype, device=src.device)
    ids = idx.cpu().numpy().astype(np.int64)
    n_pass = int(np.bincount(ids, minlength=n_rows + 1)[:n_rows].max(
        initial=0))
    if n_pass <= 1:
        return out.index_add_(0, idx, src)[:-1]
    order = np.argsort(ids, kind="stable")
    srt = ids[order]
    rank = np.empty_like(ids)
    rank[order] = np.arange(N) - np.searchsorted(srt, srt)
    for r in range(n_pass):
        sel = np.nonzero(rank == r)[0]
        out.index_add_(0, torch.from_numpy(ids[sel]).to(src.device),
                       src[torch.from_numpy(sel).to(src.device)])
    return out[:-1]


def moe_dispatch_ref(x, flat_idx, n_slots):
    """Scatter tokens into the flat capacity buffer.
    x: (S, M); flat_idx: (S, k) int in [0, n_slots] (n_slots = drop).
    Returns (n_slots, M).  A slot several choices name holds their sum in
    token-then-choice order, rounded to x's dtype after each addition
    (JAX's ``.at[].add``)."""
    S, M = x.shape
    k = flat_idx.shape[1]
    src = x[:, None, :].expand(S, k, M).reshape(S * k, M)
    return scatter_rows_in_order(src, flat_idx.reshape(-1), n_slots)


def moe_combine_ref(buf, flat_idx, weights):
    """Gather expert outputs back to tokens. buf: (n_slots, M);
    flat_idx: (S, k); weights: (S, k). Returns (S, M)."""
    n_slots, M = buf.shape
    idx = flat_idx.long().clamp(max=n_slots - 1)
    vals = buf[idx.reshape(-1)].reshape(*flat_idx.shape, M)
    w = torch.where(flat_idx < n_slots, weights,
                    torch.zeros((), dtype=weights.dtype,
                                device=weights.device))
    return torch.einsum("sk,skm->sm", w.to(buf.dtype), vals)


def expert_ffn_grouped_ref(x, flat_idx, weights, w1, w3, w2, *, cap,
                           act="silu", wire="f32"):
    """Single-device fused op: dispatch gather -> (wire round trip) ->
    expert FFN in f32 -> (wire round trip) -> combine scatter + weight dot.
    x: (S, M); flat_idx/weights: (S, k); returns (S, M) in x.dtype."""
    E = w1.shape[0]

    def rt(v):   # fused wire round-trip at a pool boundary
        return v.to(torch.bfloat16).to(v.dtype) if wire == "bf16" else v

    buf = rt(moe_dispatch_ref(x, flat_idx, E * cap))
    h = expert_ffn_ref(buf.reshape(E, cap, -1).float(), w1, w3, w2, act=act)
    h = rt(h.reshape(E * cap, -1))
    return moe_combine_ref(h, flat_idx, weights).to(x.dtype)


def rmsnorm_ref(x, scale, eps=1e-5):
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)
