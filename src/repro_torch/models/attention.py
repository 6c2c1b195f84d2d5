"""Attention (counterpart of ``repro/models/attention.py``): the training
forward ``apply_attn`` and the serving engine's ``paged_chunk_attn``.

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
``H * hd`` but not ``H`` divides over MP) is refused.

``paged_chunk_attn`` is plain array code in JAX too, no Pallas kernel.  The
port keeps its layout, op order and mask constants: ``-inf`` score masking
and VALUE-zeroed invalid K/V writes, without which an idle row's NaN would
reach the null page.  On a mesh it runs this rank's heads as
``apply_attn`` does, over an arena that holds this rank's kv heads only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels.registry import get_op
from repro_torch.models.layers import apply_rope, dense_init
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
               kv_positions=None, kernel=None, tp=None):
    """Training/prefill forward.  x: (B, L, D); ``kv_x`` != None is cross
    attention.  Returns (B, L, D).  With ``tp`` (a ``TensorParallel``)
    ``p`` holds this rank's shards, ``x`` is replicated over MP and the
    result is this rank's row-parallel part of the output (the caller sums
    it over MP)."""
    B, L, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv = {n: p[n] for n in ("wk", "wv", "bk", "bv") if n in p}
    if tp is not None:
        H, K, kv0 = mp_heads(cfg, tp.n, tp.index)
        if kv0 is not None:      # this rank's kv head of the replicated ones
            kv = {n: w.narrow(-1, kv0 * hd, hd) for n, w in kv.items()}
    src = kv_x if kv_x is not None else x
    Lk = src.shape[1]
    q = (x @ p["wq"]).reshape(B, L, H, hd)
    k = (src @ kv["wk"]).reshape(B, Lk, K, hd)
    v = (src @ kv["wv"]).reshape(B, Lk, K, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(H, hd)
        k = k + kv["bk"].reshape(K, hd)
        v = v + kv["bv"].reshape(K, hd)
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
    return out.reshape(B, L, H * hd) @ p["wo"]


def init_cache(cfg: AttnConfig, batch, max_len, dtype=torch.float32,
               device="cuda"):
    W = cfg.window if cfg.window is not None else max_len
    W = min(W, max_len)
    shape = (batch, W, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, W), -1, dtype=torch.int32,
                              device=device)}


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
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv = {n: p[n] for n in ("wk", "wv", "bk", "bv") if n in p}
    if tp is not None:
        H, K, kv0 = mp_heads(cfg, tp.n, tp.index)
        if kv0 is not None:      # this rank's kv head of the replicated ones
            kv = {n: w.narrow(-1, kv0 * hd, hd) for n, w in kv.items()}
    N, bs = arena["pos"].shape
    nb = table.shape[1]
    q = (x @ p["wq"]).reshape(B, C, H, hd)
    k = (x @ kv["wk"]).reshape(B, C, K, hd)
    v = (x @ kv["wv"]).reshape(B, C, K, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(H, hd)
        k = k + kv["bk"].reshape(K, hd)
        v = v + kv["bv"].reshape(K, hd)
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
    gp = gpos[:, None, :]                                 # (B, 1, W)
    qp = qpos[:, :, None]                                 # (B, C, 1)
    valid = (gp >= 0) & (gp <= qp)                        # (B, C, W)
    if cfg.window is not None:
        valid &= gp > qp - cfg.window
    if cfg.chunk is not None:
        valid &= (gp // cfg.chunk) == (qp // cfg.chunk)
    s = torch.where(valid[:, None], s, -torch.inf)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", pr, vv)
    return out.reshape(B, C, H * hd) @ p["wo"]
