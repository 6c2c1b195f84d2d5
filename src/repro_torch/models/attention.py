"""Attention (counterpart of ``repro/models/attention.py``): the training
forward ``apply_attn``, the serving engine's ``paged_chunk_attn``, and the
KV-cache serve path's ``prefill_attn`` and ``decode_attn``.

``apply_attn`` takes the ``flash_attention`` op (the CUDA kernel for a
tensor on the card, its plain version on the CPU) for self-attention over
contiguous-from-zero positions without chunking, exactly where the JAX
package takes its Pallas kernel; otherwise the full ``sdpa_full`` or, above
``flash_threshold``, the KV-block scan ``sdpa_flash_scan`` with its
recompute backward.  Those two mask with the finite ``-1e30``
(``_mask_bias``), as JAX does.

On a mesh whose MP group has more than one rank ``apply_attn`` runs this
rank's heads (``attn_specs``, JAX's rule: ``wq``/``bq`` and ``wo`` by
query head, ``wk``/``wv`` by kv head where the kv heads divide over MP,
else replicated, each rank then reading the one kv head its query heads
share) and returns its row-parallel part of the output, which the block
sums over MP.  A query head split across ranks (JAX allows it where
``H * hd`` but not ``H`` divides over MP) is refused, except in the
gathered-heads layout (``gathered=True``, :func:`attn_layout`; hymba's 25
query heads over 5 kv heads, whisper's 6 over MP 4 or 16): this rank's
columns of ``q`` are gathered over MP, every rank runs every head over
K/V it computes from the replicated kv projection, and feeds its columns
of the output to its rows of ``wo``.  JAX's specs stay as they are; the
attention core runs on every MP rank.

``paged_chunk_attn`` is plain array code in JAX too, no Pallas kernel.  The
port keeps its layout, op order and mask constants: ``-inf`` score masking
and VALUE-zeroed invalid K/V writes, without which an idle row's NaN would
reach the null page.  On a mesh it runs this rank's heads as
``apply_attn`` does, over an arena that holds this rank's kv heads only.

``prefill_attn`` fills a per-row KV cache with the prompt's K/V and takes
the ``flash_attention`` op for the prompt's attention (its one serving
launch; chunked layers take the plain path, as in JAX); ``decode_attn``
is plain code with JAX's ``-inf`` masks, as JAX's is.  Both write the
cache in place.  Cross attention (``apply_attn(kv_x=)``, and
``decode_attn(kv_cache_static=)`` over a precomputed context) is plain
code too, as JAX's kernel path excludes it: no rope, no mask.  On a mesh
both run this rank's heads, or every head in the gathered layout, over
the context's kv heads this rank holds (:func:`context_kv`).  Where
``train.loop.cache_specs`` splits the cache's W over a group of ranks
(JAX's context-parallel decode, a GSPMD sharding hint there), the port
writes the exchange out: the queries and the new token's K/V are
gathered, each rank scores its own slots, and the softmax is combined
across the group; the cache never moves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels.registry import get_op
from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.parallel import comm
from repro_torch.parallel.mesh import axis_size
from repro_torch.parallel.sharding import P


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 1e4
    use_rope: bool = True
    causal: bool = True
    window: int | None = None     # sliding window (tokens), None = full
    chunk: int | None = None      # llama4-style chunked local attention
    qkv_bias: bool = False
    softmax_scale: float | None = None
    flash_block: int = 512        # KV block for the scan path
    flash_threshold: int = 2048   # use the scan path above this length

    @property
    def scale(self):
        return self.softmax_scale or 1.0 / math.sqrt(self.head_dim)


def init_attn(generator, cfg: AttnConfig, dtype=torch.float32):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": dense_init(generator, (D, H * hd), dtype=dtype),
         "wk": dense_init(generator, (D, K * hd), dtype=dtype),
         "wv": dense_init(generator, (D, K * hd), dtype=dtype),
         "wo": dense_init(generator, (H * hd, D), fan_in=H * hd,
                          dtype=dtype)}
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((K * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((K * hd,), dtype=dtype, device=dev)
    return p


def attn_specs(mesh, mp_axes, cfg: AttnConfig):
    """The JAX function, copied."""
    n_mp = axis_size(mesh, mp_axes) if mp_axes else 1
    q_ax = tuple(mp_axes) if mp_axes and (
        cfg.n_heads * cfg.head_dim) % n_mp == 0 else None
    kv_ax = tuple(mp_axes) if mp_axes and cfg.n_kv_heads % n_mp == 0 else None
    kv_sp = tuple(mp_axes) if kv_ax else None
    p = {"wq": P(None, q_ax), "wk": P(None, kv_sp), "wv": P(None, kv_sp),
         "wo": P(q_ax, None)}
    if cfg.qkv_bias:
        p["bq"] = P(q_ax)
        p["bk"] = P(kv_sp)
        p["bv"] = P(kv_sp)
    return p


def mp_heads(cfg: AttnConfig, n_mp: int, index: int = 0):
    """``(query heads, kv heads, kv0)`` of MP rank ``index`` of ``n_mp``:
    ``kv0`` is None where the kv projection is sharded (this rank's block
    holds its kv heads), else the one kv head of the replicated projection
    that this rank's query heads share.  Raises where the query heads do
    not divide over MP, or where a rank's query heads would straddle two
    kv groups of a replicated projection."""
    H, K = cfg.n_heads, cfg.n_kv_heads
    if H % n_mp:
        raise ValueError(f"{H} query heads do not divide over {n_mp} MP "
                         f"ranks (JAX would split a head of {cfg.head_dim} "
                         f"across ranks; the port keeps heads whole)")
    h_local = H // n_mp
    if K % n_mp == 0:
        return h_local, K // n_mp, None
    group = H // K
    if group % h_local:
        raise ValueError(f"{h_local} query heads a rank straddle GQA groups "
                         f"of {group} over {K} replicated kv heads")
    return h_local, 1, index * h_local // group


def attn_layout(cfg: AttnConfig, n_mp: int) -> str:
    """How the attention of a kind that takes the gathered-heads layout
    (hymba's, and the cross-attention kinds' self- and cross attention)
    runs over ``n_mp`` MP ranks under JAX's ``attn_specs``: ``"whole"``
    where ``wq``/``wo`` are replicated (one rank, or ``H * hd`` does not
    divide), ``"heads"`` where :func:`mp_heads` keeps whole heads a rank,
    else ``"gathered"``."""
    if n_mp <= 1 or (cfg.n_heads * cfg.head_dim) % n_mp:
        return "whole"
    try:
        mp_heads(cfg, n_mp)
    except ValueError:
        return "gathered"
    return "heads"


def _gathered_q(p, cfg: AttnConfig, x, tp):
    """Every query head (B, L, H, hd): this rank's columns of ``wq`` (and
    ``bq``), all-gathered over MP along the features (reduce-scattered
    back)."""
    from repro_torch.parallel.tensor import gather_features
    B, L, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return gather_features(q, tp.grp).reshape(B, L, cfg.n_heads,
                                              cfg.head_dim)


def _own_columns(out, tp):
    """This rank's columns of every head's (..., H * hd) output: the rows
    of ``wo`` it holds."""
    cols = out.shape[-1] // tp.n
    return out.narrow(-1, tp.index * cols, cols)


def _rank_heads(p, cfg: AttnConfig, tp):
    """``(H, K, kv)``: the query and kv heads this rank runs, and the k/v
    projections (``wk``, ``wv`` and their biases) that give its kv heads:
    all of them off a mesh, this rank's block where they are sharded over
    MP, or the one kv head of a replicated projection that its query
    heads share (``mp_heads``)."""
    kv = {n: p[n] for n in ("wk", "wv", "bk", "bv") if n in p}
    if tp is None:
        return cfg.n_heads, cfg.n_kv_heads, kv
    H, K, kv0 = mp_heads(cfg, tp.n, tp.index)
    if kv0 is not None:          # this rank's kv head of the replicated ones
        hd = cfg.head_dim
        kv = {n: w.narrow(-1, kv0 * hd, hd) for n, w in kv.items()}
    return H, K, kv


def _project_kv(kv, cfg: AttnConfig, src, K):
    """k, v (B, Lk, K, hd) from ``src`` through the projections ``kv``."""
    B, Lk, _ = src.shape
    hd = cfg.head_dim
    k = (src @ kv["wk"]).reshape(B, Lk, K, hd)
    v = (src @ kv["wv"]).reshape(B, Lk, K, hd)
    if cfg.qkv_bias:
        k = k + kv["bk"].reshape(K, hd)
        v = v + kv["bv"].reshape(K, hd)
    return k, v


def _project(p, kv, cfg: AttnConfig, x, src, H, K):
    """q (B, L, H, hd) from ``x``; k, v (B, Lk, K, hd) from ``src``."""
    B, L, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, L, H, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(H, hd)
    return (q, *_project_kv(kv, cfg, src, K))


# --- training / prefill forward ----------------------------------------------

def _mask_bias(cfg: AttnConfig, q_pos, k_pos):
    """Additive f32 mask from query/key absolute positions.  The constant is
    the finite ``-1e30``: fully masked KV blocks stay NaN-free in the online
    softmax and give exactly-zero probabilities in the recompute backward."""
    d = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones_like(d, dtype=torch.bool)
    if cfg.causal:
        ok &= d >= 0
    if cfg.window is not None:
        ok &= d < cfg.window
    if cfg.chunk is not None:
        ok &= (q_pos[:, None] // cfg.chunk) == (k_pos[None, :] // cfg.chunk)
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def _repeat_kv(k, n_rep):
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


def sdpa_full(q, k, v, bias, scale):
    """q: (B,Lq,H,hd)  k,v: (B,Lk,H,hd)  bias: (Lq,Lk) or (B,1,Lq,Lk)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = s + (bias if bias.dim() == 4 else bias[None, None])
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _flash_fwd_scan(q, k, v, cfg: AttnConfig, q_pos, k_pos, blk):
    B, Lq, H, hd = q.shape
    qf = q.float() * cfg.scale
    m = torch.full((B, H, Lq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Lq, hd), dtype=torch.float32, device=q.device)
    for i in range(k.shape[1] // blk):
        sl = slice(i * blk, (i + 1) * blk)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k[:, sl].float())
        s = s + _mask_bias(cfg, q_pos, k_pos[sl])[None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v[:, sl].float())
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    return out, m + torch.log(l)                          # lse: (B, H, Lq)


def _flash_bwd_scan(q, k, v, out, lse, dout, cfg: AttnConfig, q_pos, k_pos,
                    blk):
    qf = q.float() * cfg.scale
    do = dout.float().transpose(1, 2)                     # (B, H, Lq, hd)
    of = out.float().transpose(1, 2)
    D = torch.sum(do * of, dim=-1)                        # (B, H, Lq)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for i in range(k.shape[1] // blk):
        sl = slice(i * blk, (i + 1) * blk)
        ks, vs = k[:, sl].float(), v[:, sl].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, ks)
        s = s + _mask_bias(cfg, q_pos, k_pos[sl])[None, None]
        p = torch.exp(s - lse[..., None])                 # (B, H, Lq, blk)
        dvs.append(torch.einsum("bhqk,bhqd->bkhd", p, do))
        dp = torch.einsum("bhqd,bkhd->bhqk", do, vs)
        ds = p * (dp - D[..., None])
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, ks) * cfg.scale
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _FlashScan(torch.autograd.Function):
    """The scan's flash backward: saves only (q, k, v, out, lse) and
    rebuilds each block's probabilities, O(L * block) memory both ways."""

    @staticmethod
    def forward(ctx, q, k, v, cfg, q_pos, k_pos, blk):
        out, lse = _flash_fwd_scan(q, k, v, cfg, q_pos, k_pos, blk)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos)
        ctx.cfg, ctx.blk = cfg, blk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_scan(q, k, v, out, lse, dout, ctx.cfg,
                                     q_pos, k_pos, ctx.blk)
        return dq, dk, dv, None, None, None, None


def sdpa_flash_scan(q, k, v, cfg: AttnConfig, q_pos, k_pos):
    """Online-softmax attention over KV blocks of ``cfg.flash_block``
    (halved until it divides Lk).  q: (B,Lq,H,hd); k, v: (B,Lk,H,hd)."""
    blk = min(cfg.flash_block, k.shape[1])
    while k.shape[1] % blk:
        blk //= 2
    return _FlashScan.apply(q, k, v, cfg, q_pos, k_pos, blk)


def apply_attn(p, cfg: AttnConfig, x, *, positions=None, kv_x=None,
               kv_positions=None, kernel=None, tp=None, gathered=False):
    """Training/prefill forward.  x: (B, L, D); ``kv_x`` != None is cross
    attention.  Returns (B, L, D).  With ``tp`` (a ``TensorParallel``)
    ``p`` holds this rank's shards, ``x`` is replicated over MP and the
    result is this rank's row-parallel part of the output (the caller sums
    it over MP): this rank's heads, or with ``gathered`` every head and
    this rank's columns of their output (the module docstring)."""
    B, L, D = x.shape
    hd = cfg.head_dim
    src = kv_x if kv_x is not None else x
    Lk = src.shape[1]
    if gathered:
        H, K = cfg.n_heads, cfg.n_kv_heads
        q = _gathered_q(p, cfg, x, tp)
        k, v = _project_kv(p, cfg, src, K)
    else:
        H, K, kv = _rank_heads(p, cfg, tp)
        q, k, v = _project(p, kv, cfg, x, src, H, K)
    # the kernel derives positions from tile indices: it covers only the
    # default contiguous-from-zero layout (recorded before the aranges)
    contiguous_pos = positions is None and kv_positions is None
    if positions is None:
        positions = torch.arange(L, device=x.device)
    if kv_positions is None:
        kv_positions = torch.arange(Lk, device=x.device)
    if cfg.use_rope and kv_x is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    if cfg.chunk is None and kv_x is None and contiguous_pos:
        # K/V stay in their native GQA layout: the kernel maps each query
        # head to its kv head, no repeat is written
        op = get_op("flash_attention", cfg=kernel, causal=cfg.causal,
                    window=cfg.window, scale=cfg.scale)
        out = op(q.contiguous(), k.contiguous(), v.contiguous())
    else:
        k = _repeat_kv(k, H // K)
        v = _repeat_kv(v, H // K)
        if max(L, Lk) > cfg.flash_threshold:
            out = sdpa_flash_scan(q, k, v, cfg, positions, kv_positions)
        else:
            bias = _mask_bias(cfg, positions, kv_positions) if (
                cfg.causal or cfg.window or cfg.chunk) else torch.zeros(
                    (L, Lk), dtype=torch.float32, device=x.device)
            out = sdpa_full(q, k, v, bias, cfg.scale)
    out = out.reshape(B, L, H * hd)
    return (_own_columns(out, tp) if gathered else out) @ p["wo"]


def cache_len(cfg: AttnConfig, max_len: int) -> int:
    """W, a cache's slots: ``max_len``, or a sliding window's ring."""
    return min(cfg.window if cfg.window is not None else max_len, max_len)


def init_cache(cfg: AttnConfig, batch, max_len, dtype=torch.float32,
               device="cuda", *, kv_heads=None, w_shards: int = 1):
    """``{"k", "v": (batch, W / w_shards, kv_heads, hd), "pos": (batch,
    W)}`` (``pos`` -1 = empty), W = :func:`cache_len`: ``kv_heads``
    (default all) and ``w_shards`` cut K/V to one rank's block of a cache
    sharded by kv head or along W; ``pos`` stays whole along W, as
    ``cache_specs`` leaves it."""
    W = cache_len(cfg, max_len)
    K = cfg.n_kv_heads if kv_heads is None else kv_heads
    shape = (batch, W // w_shards, K, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, W), -1, dtype=torch.int32,
                              device=device)}


def _cache_kv(p, cfg: AttnConfig, x, k, v, tp, positions):
    """Every kv head's k, v (B, L, K, hd), rope-rotated, where ``k``, ``v``
    are this rank's (:func:`_rank_heads`) and the kv projection is not
    sharded over MP: as they are off a mesh, else all of them computed
    here from the replicated projection."""
    if tp is None:
        return k, v
    kv = {n: p[n] for n in ("wk", "wv", "bk", "bv") if n in p}
    k, v = _project_kv(kv, cfg, x, cfg.n_kv_heads)
    if cfg.use_rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _fill_sharded(p, cfg: AttnConfig, x, k, v, cache, tp, wgrp, positions):
    """Prefill's K/V write into a cache whose W is split over ``wgrp``,
    rank ``i`` of it holding slots ``[i * Wl, (i + 1) * Wl)`` of every kv
    head.  ``wgrp`` runs over (batch axes..., MP...) in that order (or MP
    alone), so the ranks of one MP group hold ``n_mp`` consecutive slices.
    Where the kv heads are sharded over MP each of those ranks holds its
    kv heads for all L positions: one AlltoAll over MP (W split, heads
    joined in MP order) turns the group's span into each rank's slice of
    every head.  Elsewhere every rank has every head and keeps its slice.
    Only positions below L are written, as JAX's update of ``0 .. L-1``."""
    B, L = x.shape[:2]
    Wl = cache["k"].shape[1]
    n_mp = tp.n if tp is not None and cfg.n_kv_heads % tp.n == 0 else 1
    if n_mp == 1:
        k, v = _cache_kv(p, cfg, x, k, v, tp, positions)
    span = n_mp * Wl
    lo = wgrp.index // n_mp * span
    n = max(0, min(L - lo, span))
    out = []
    for t in (k, v):
        buf = t.new_zeros((B, span, *t.shape[2:]))
        buf[:, :n] = t[:, lo:lo + n]
        out.append(comm.all_to_all(buf, tp.grp, 1, 2) if n_mp > 1 else buf)
    n = max(0, min(L - wgrp.index * Wl, Wl))
    cache["k"][:, :n] = out[0][:, :n].to(cache["k"].dtype)
    cache["v"][:, :n] = out[1][:, :n].to(cache["v"].dtype)


def prefill_attn(p, cfg: AttnConfig, x, cache, lengths, *, kernel=None,
                 tp=None, wgrp=None):
    """Batched one-shot prefill: the causal attention over the (B, L, D)
    right-padded prompts ``x`` (``lengths`` (B,) valid tokens each), and
    their rope-rotated K/V written IN PLACE into ``cache`` at positions
    ``0 .. L-1``, ``pos`` marking only slots below each row's length
    valid (JAX returns a new cache: the same values).  Needs W >= L.
    Outside chunked layers the attention is the ``flash_attention`` op
    (K/V in their GQA layout); a chunked layer takes the plain path, as
    in JAX.  Returns (B, L, D).

    With ``tp`` it runs this rank's heads, returns its row-parallel part
    (the caller sums it over MP), and the cache holds this rank's kv heads
    of all W; with ``wgrp`` (W split over it, ``train.loop.cache_specs``'
    ``seq_shard``) every kv head of this rank's W slice
    (:func:`_fill_sharded`)."""
    B, L, D = x.shape
    hd = cfg.head_dim
    W = cache["pos"].shape[1]
    if W < L:
        raise ValueError(f"prefill_attn needs cache W={W} >= prompt L={L}")
    H, K, kv = _rank_heads(p, cfg, tp)
    q, k, v = _project(p, kv, cfg, x, x, H, K)
    positions = torch.arange(L, device=x.device)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if wgrp is None or wgrp.size == 1:
        cache["k"][:, :L] = k.to(cache["k"].dtype)
        cache["v"][:, :L] = v.to(cache["v"].dtype)
    else:
        _fill_sharded(p, cfg, x, k, v, cache, tp, wgrp, positions)
    widx = torch.arange(W, device=x.device)
    valid = (widx[None, :] < lengths[:, None]) & (widx < L)[None]
    cache["pos"].copy_(torch.where(valid, widx[None, :], -1))
    if cfg.chunk is None:
        op = get_op("flash_attention", cfg=kernel, causal=cfg.causal,
                    window=cfg.window, scale=cfg.scale)
        out = op(q.contiguous(), k.contiguous(), v.contiguous())
    else:
        kk = _repeat_kv(k, H // K)
        vv = _repeat_kv(v, H // K)
        if L > cfg.flash_threshold:
            out = sdpa_flash_scan(q, kk, vv, cfg, positions, positions)
        else:
            out = sdpa_full(q, kk, vv, _mask_bias(cfg, positions, positions),
                            cfg.scale)
    return out.reshape(B, L, H * hd) @ p["wo"]


def _valid(cfg: AttnConfig, pos, at):
    """Whether a query at absolute position ``at`` attends the slot holding
    position ``pos`` (broadcast against each other): written, not in its
    future, inside its window and its chunk."""
    valid = (pos >= 0) & (pos <= at)
    if cfg.window is not None:
        valid &= pos > at - cfg.window
    if cfg.chunk is not None:
        valid &= (pos // cfg.chunk) == (at // cfg.chunk)
    return valid


def _grouped(q, K):
    """(B, 1, H, hd) queries as (B, K, H / K, hd): query head ``h`` reads
    kv head ``h // (H / K)``, as ``_repeat_kv`` pairs them, with no
    repeat of the cache."""
    B, _, H, hd = q.shape
    return q.reshape(B, K, H // K, hd)


def context_kv(p, cfg: AttnConfig, ctx, tp=None):
    """A cross layer's static context K/V (``Model.ctx_kv``): k, v (B,
    Lctx, K, hd) of ``ctx`` through the kv projection, JAX's ``ctx_kv``.
    With ``tp`` this rank's kv heads (:func:`_rank_heads`: its block of a
    sharded projection, or the one kv head its query heads share); None
    gives every head (one rank, or the gathered and whole layouts)."""
    _, K, kv = _rank_heads(p, cfg, tp)
    return _project_kv(kv, cfg, ctx, K)


def _decode_static(p, cfg: AttnConfig, x, kv, tp=None, gathered=False):
    """JAX's static-K/V branch of ``decode_attn``: one query token against
    a precomputed context ``kv`` (``{"k", "v": (B, Lctx, K, hd)}``,
    ``Model.ctx_kv``), repeated by H / K, an f32 softmax over every
    context slot.  Returns (B, 1, D).  With ``tp`` this rank's query
    heads over the kv heads ``kv`` holds (:func:`context_kv`), its
    row-parallel part returned; with ``gathered`` every head over every
    kv head, this rank's columns of the output meeting its rows of
    ``wo``."""
    B = x.shape[0]
    hd = cfg.head_dim
    if gathered:
        H = cfg.n_heads
        q = _gathered_q(p, cfg, x, tp)
    else:
        H = _rank_heads(p, cfg, tp)[0]
        q = (x @ p["wq"]).reshape(B, 1, H, hd)
        if cfg.qkv_bias:
            q = q + p["bq"].reshape(H, hd)
    K = kv["k"].shape[2]
    k = _repeat_kv(kv["k"], H // K)
    v = _repeat_kv(kv["v"], H // K)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * cfg.scale
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(B, 1, H * hd)
    return (_own_columns(out, tp) if gathered else out) @ p["wo"]


def decode_attn(p, cfg: AttnConfig, x, cache, step, *, tp=None, wgrp=None,
                kv_cache_static=None, gathered=False):
    """One-token decode.  With ``kv_cache_static`` it is cross attention
    over a precomputed context (:func:`_decode_static`, ``tp`` and
    ``gathered`` as below; ``cache`` and ``step`` unused, nothing
    written).  Otherwise self-attention: x:
    (B, 1, D); ``step`` the
    absolute position, a scalar (every row at one position) or a (B,)
    tensor (each row at its own).  The token's K/V land IN PLACE at slot
    ``step % W`` (a sliding window's cache is a ring), then the query
    attends every valid slot (``-inf`` masks, as in JAX).  JAX's three
    cache writes (one-hot for a vector step, masked, dynamic update) store
    the same values, so ``cache_masked_update`` has no effect here.
    Returns (B, 1, D).

    With ``tp`` this rank's heads over its kv heads' cache, its
    row-parallel part returned (the caller sums it over MP).  With
    ``wgrp`` (the cache's W split over it): the MP group's queries and
    the token's K/V all-gathered (query-sized), the rank that owns the
    slot writes it, each rank scores every head over its own slots, and
    the softmax is combined over ``wgrp`` (the max, then the sums and the
    weighted values): K and V never leave their rank.  With ``gathered``
    (the gathered-heads layout) the query is gathered over MP, the cache
    holds every kv head, every head is attended on every rank, and this
    rank's columns of the output meet its rows of ``wo``."""
    if kv_cache_static is not None:
        return _decode_static(p, cfg, x, kv_cache_static, tp, gathered)
    B = x.shape[0]
    hd = cfg.head_dim
    if gathered:
        H, K = cfg.n_heads, cfg.n_kv_heads
        q = _gathered_q(p, cfg, x, tp)
        k, v = _project_kv(p, cfg, x, K)
        rank_tp, tp = tp, None        # from here on, as on one rank
    else:
        H, K, kv = _rank_heads(p, cfg, tp)
        q, k, v = _project(p, kv, cfg, x, x, H, K)
    steps = torch.as_tensor(step, device=x.device).long()
    steps = steps.expand(B) if steps.dim() == 0 else steps
    if cfg.use_rope:
        q = apply_rope(q, steps[:, None], cfg.rope_theta)
        k = apply_rope(k, steps[:, None], cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    W = cache["pos"].shape[1]
    slot = steps % W
    cache["pos"][rows, slot] = steps.to(torch.int32)
    if wgrp is not None and wgrp.size > 1:
        out = _decode_sharded(p, cfg, x, q, k, v, cache, steps, slot, tp,
                              wgrp)
    else:
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        s = torch.einsum("bkgd,bwkd->bkgw", _grouped(q, K),
                         cache["k"]).float() * cfg.scale
        valid = _valid(cfg, cache["pos"], steps[:, None])
        s = torch.where(valid[:, None, None], s, -torch.inf)
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        out = torch.einsum("bkgw,bwkd->bkgd", pr, cache["v"])
    out = out.reshape(B, 1, H * hd)
    return (_own_columns(out, rank_tp) if gathered else out) @ p["wo"]


def _decode_sharded(p, cfg: AttnConfig, x, q, k, v, cache, steps, slot, tp,
                    wgrp):
    """:func:`decode_attn` over a cache whose W is split over ``wgrp``:
    returns this rank's heads' attention output (B, H_local * hd)."""
    B = x.shape[0]
    hd, K = cfg.head_dim, cfg.n_kv_heads
    if tp is not None and K % tp.n == 0:
        # one AllGather over MP of this rank's query, key and value heads
        h, kl = q.shape[2], k.shape[2]
        g = comm.all_gather(torch.cat([q, k, v], dim=2).contiguous(),
                            tp.grp, 2, tiled=False)   # (B, 1, n, h+2kl, hd)
        qa, ka, va = (t.reshape(B, 1, -1, hd) for t in
                      g.split([h, kl, kl], dim=3))
    else:
        qa = comm.all_gather(q.contiguous(), tp.grp, 2) \
            if tp is not None else q
        ka, va = _cache_kv(p, cfg, x, k, v, tp, steps[:, None])
    rows = torch.arange(B, device=x.device)
    Wl = cache["k"].shape[1]
    off = wgrp.index * Wl
    own = ((slot >= off) & (slot < off + Wl))[:, None, None]
    li = torch.clamp(slot - off, 0, Wl - 1)
    for name, t in (("k", ka), ("v", va)):
        c = cache[name]
        c[rows, li] = torch.where(own, t[:, 0].to(c.dtype), c[rows, li])
    s = torch.einsum("bkgd,bwkd->bkgw", _grouped(qa, K),
                     cache["k"]).float() * cfg.scale
    valid = _valid(cfg, cache["pos"][:, off:off + Wl], steps[:, None])
    s = torch.where(valid[:, None, None], s, -torch.inf)
    # the global max first: a shard whose slots are all masked then adds
    # exact zeros (the token's own slot is valid, so the max is finite)
    m = comm.pmax(s.amax(dim=-1), wgrp)
    e = torch.exp(s - m[..., None])
    o = torch.einsum("bkgw,bwkd->bkgd", e, cache["v"].float())
    tot = comm.psum(torch.cat([e.sum(dim=-1)[..., None], o], dim=-1), wgrp)
    out = (tot[..., 1:] / tot[..., :1]).to(x.dtype).reshape(B, -1, hd)
    if tp is not None:
        h = out.shape[1] // tp.n
        out = out[:, tp.index * h:(tp.index + 1) * h]
    return out.reshape(B, -1)


def paged_chunk_attn(p, cfg: AttnConfig, x, arena, table, starts, lens,
                     tp=None):
    """One paged-attention primitive for decode, one-shot and chunked
    prefill.  ``x`` (B, C, D): row b holds ``lens[b]`` valid tokens at
    absolute positions ``starts[b] ..``.  ``arena`` is this layer's paged
    cache ``{"k","v": (N, bs, Kh, hd), "pos": (N, bs)}`` (page 0 = the null
    page) and ``table`` the (B, nb) int32 page tables.

    The chunk's rope-rotated K/V are written into ``arena`` IN PLACE (the
    JAX version returns a new arena; torch updates the engine's one arena
    and saves the copy), then every query attends its row's whole gathered
    ``(nb * bs)`` context, position p at index p.  Returns (B, C, D).

    With ``tp`` (a ``TensorParallel``) ``p`` holds this rank's shards and
    the arena this rank's kv heads (``mp_heads``: a replicated kv
    projection is narrowed to the one kv head this rank's query heads
    share, as in ``apply_attn``); the result is this rank's row-parallel
    part of the output, which the caller sums over MP.
    """
    B, C, D = x.shape
    hd = cfg.head_dim
    H, K, kv = _rank_heads(p, cfg, tp)
    N, bs = arena["pos"].shape
    nb = table.shape[1]
    q, k, v = _project(p, kv, cfg, x, x, H, K)
    offs = torch.arange(C, device=x.device)
    qpos = starts[:, None] + offs[None, :]                # (B, C) absolute
    valid_q = offs[None, :] < lens[:, None]
    if cfg.use_rope:
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, qpos, cfg.rope_theta)

    # scatter the chunk into the arena: invalid rows/pages land in the null
    # page with pos -1 and ZERO values (an idle row's hidden state is NaN,
    # and a NaN in the null page would reach live rows through 0 * NaN)
    blk_idx = torch.clamp(qpos // bs, 0, nb - 1)
    phys = torch.gather(table, 1, blk_idx)                # (B, C)
    ok = valid_q & (phys > 0) & (qpos < nb * bs)
    flat = torch.where(ok, phys * bs + qpos % bs, 0).reshape(-1).long()
    pos_w = torch.where(ok, qpos, -1).to(torch.int32).reshape(-1)
    okk = ok.reshape(-1)[:, None, None]
    zero = torch.zeros((), dtype=k.dtype, device=x.device)
    k_w = torch.where(okk, k.reshape(-1, K, hd), zero)
    v_w = torch.where(okk, v.reshape(-1, K, hd), zero)
    arena["k"].view(N * bs, K, hd)[flat] = k_w.to(arena["k"].dtype)
    arena["v"].view(N * bs, K, hd)[flat] = v_w.to(arena["v"].dtype)
    arena["pos"].view(N * bs)[flat] = pos_w

    # gather each row's full context: gathered index IS the position
    tl = table.long()
    gk = arena["k"][tl].reshape(B, nb * bs, K, hd)
    gv = arena["v"][tl].reshape(B, nb * bs, K, hd)
    gpos = arena["pos"][tl].reshape(B, nb * bs)
    kk = torch.repeat_interleave(gk, H // K, dim=2)
    vv = torch.repeat_interleave(gv, H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * cfg.scale
    valid = _valid(cfg, gpos[:, None, :], qpos[:, :, None])   # (B, C, W)
    s = torch.where(valid[:, None], s, -torch.inf)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", pr, vv)
    return out.reshape(B, C, H * hd) @ p["wo"]
