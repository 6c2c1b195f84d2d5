"""Attention for the serving path (counterpart of the paged parts of
``repro/models/attention.py``).

The JAX serving engine's attention is ``paged_chunk_attn``: plain array
code, no Pallas kernel (the flash kernel serves training and slab prefill
only, which come with a later slice).  The port keeps its layout, op order
and mask constants: ``-inf`` score masking and VALUE-zeroed invalid K/V
writes, without which an idle row's NaN would reach the null page.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.layers import apply_rope, dense_init


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


def init_cache(cfg: AttnConfig, batch, max_len, dtype=torch.float32,
               device="cuda"):
    W = cfg.window if cfg.window is not None else max_len
    W = min(W, max_len)
    shape = (batch, W, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, W), -1, dtype=torch.int32,
                              device=device)}


def paged_chunk_attn(p, cfg: AttnConfig, x, arena, table, starts, lens):
    """One paged-attention primitive for decode, one-shot and chunked
    prefill.  ``x`` (B, C, D): row b holds ``lens[b]`` valid tokens at
    absolute positions ``starts[b] ..``.  ``arena`` is this layer's paged
    cache ``{"k","v": (N, bs, Kh, hd), "pos": (N, bs)}`` (page 0 = the null
    page) and ``table`` the (B, nb) int32 page tables.

    The chunk's rope-rotated K/V are written into ``arena`` IN PLACE (the
    JAX version returns a new arena; torch updates the engine's one arena
    and saves the copy), then every query attends its row's whole gathered
    ``(nb * bs)`` context, position p at index p.  Returns (B, C, D).
    """
    B, C, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    N, bs = arena["pos"].shape
    nb = table.shape[1]
    q = (x @ p["wq"]).reshape(B, C, H, hd)
    k = (x @ p["wk"]).reshape(B, C, K, hd)
    v = (x @ p["wv"]).reshape(B, C, K, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(H, hd)
        k = k + p["bk"].reshape(K, hd)
        v = v + p["bv"].reshape(K, hd)
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
