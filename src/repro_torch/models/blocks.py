"""Blocks, one per layer kind (counterpart of ``repro/models/blocks.py``):
the ``dense`` and ``moe`` kinds (and their ``_full`` variants), the
cross-attention kinds ``cross`` (llama-3.2-vision's gated
cross-attention layer), ``xdec`` (whisper's decoder layer: self-attention,
cross attention, FFN) and ``encoder`` (whisper's encoder layer: the dense
block, causal as in JAX, whose ``attn_config`` keys the mask on
``arch_type``), and the recurrent kinds ``hymba`` (attention beside a
Mamba head), ``mlstm`` and ``slstm`` (``models/ssm.py``); init, the
partition specs ``block_specs``, the training forward ``apply_block``,
the serving engine's paged forward and the KV-cache serve path's
``init_block_cache``, ``prefill_block`` and ``decode_block``.

The recurrent and cross-attention kinds run through ``apply_block``,
``init_block_cache`` and ``decode_block``; ``prefill_block`` and
``paged_block`` refuse them, as JAX's do.  The recurrent kinds run on a
mesh too, Megatron-split over MP on JAX's specs (``_recurrent``): hymba's
attention by head or in the gathered-heads layout
(``attention.attn_layout``) beside its Mamba cell on its channels, the
mLSTM cell on its heads or gathered heads, the sLSTM cell whole on every
rank.  The cross-attention kinds run on a mesh too (``_cross``): each
attention (whisper's encoder's, an ``xdec`` layer's self-attention, the
``xattn`` of both) by head or in the gathered-heads layout
(:func:`layout`), the FFN on its columns, the ``cross`` gates on the
MP-summed outputs, as in JAX's ``apply_block``."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import apply_moe, init_moe_params, moe_param_specs
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import AttnConfig
from repro_torch.models.layers import (apply_ffn, apply_norm, ffn_specs,
                                       init_ffn, init_norm, norm_specs)
from repro_torch.parallel.sharding import P
from repro_torch.parallel.tensor import copy_to_mp

#: Block kinds the port runs.
KINDS = ("dense", "moe", "cross", "xdec", "hymba", "mlstm", "slstm",
         "encoder")
#: the kinds with a recurrent state
RECURRENT = ("hymba", "mlstm", "slstm")
#: the cross-attention and encoder-decoder kinds
CROSS = ("cross", "xdec", "encoder")
#: the kinds JAX's cache-filling prefill, paged step and engine take
ATTENTION_ONLY = ("dense", "moe")


def base_kind(kind: str) -> str:
    return kind[:-5] if kind.endswith("_full") else kind


def attn_config(cfg: ModelConfig, kind: str,
                cross: bool = False) -> AttnConfig:
    """JAX's: ``cross`` is a cross-attention layer's (no rope, no mask, no
    bias).  The causal mask follows ``arch_type``, so whisper's encoder
    (an ``audio`` arch) is causal, as in JAX."""
    full = kind.endswith("_full")
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope and not full and not cross,
        causal=not cross and cfg.arch_type != "encoder",
        window=None if (full or cross) else cfg.attn_window,
        chunk=None if (full or cross) else cfg.attn_chunk,
        qkv_bias=cfg.qkv_bias and not cross)


def _check_kind(kind: str) -> None:
    if base_kind(kind) not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} comes with a later slice of the port "
            f"(the port runs {KINDS})")


def layout(cfg: ModelConfig, kind: str, n_mp: int) -> str:
    """How a layer of ``kind``'s attention runs over ``n_mp`` MP ranks:
    hymba's and the cross-attention kinds' by ``attention.attn_layout``
    (``"whole"``, ``"heads"`` or ``"gathered"``), the dense kinds' by head
    (``"heads"``: ``attention.mp_heads`` refuses a head split across
    ranks).  A layer's self- and cross attention have the same heads, so
    one layout serves both."""
    if base_kind(kind) in ("hymba",) + CROSS:
        return attn_mod.attn_layout(attn_config(cfg, kind), n_mp)
    return "heads"


def _split_region(tp, how: str, h, fn):
    """``fn(h, tp, gathered)``, an attention in the layout ``how``, summed
    over MP: on this rank's shard between ``tp.enter`` and ``tp.leave``,
    or whole on every rank (``tp.to_replicated`` / ``from_replicated``)
    where ``how`` is ``"whole"``."""
    if how == "whole":
        return tp.from_replicated(fn(tp.to_replicated(h), None, False))
    return tp.leave(fn(tp.enter(h), tp, how == "gathered"))


def state_shards(cfg: ModelConfig, kind: str, n_mp: int) -> dict:
    """The MP shards of a recurrent layer's decode state over ``n_mp``
    ranks, by cell (1: whole on every rank): Mamba's ``d_inner`` where its
    cell is split, mLSTM's heads where they divide; sLSTM's never
    (``train.loop.cache_specs``' rule)."""
    base = base_kind(kind)
    out = {}
    if base == "hymba":
        out["mamba"] = n_mp if ssm_mod.mamba_split(_mamba_cfg(cfg), n_mp) \
            else 1
    if base == "mlstm":
        out["mlstm"] = n_mp if ssm_mod.mlstm_heads_split(_mlstm_cfg(cfg),
                                                         n_mp) else 1
    if base == "slstm":
        out["slstm"] = 1
    return out


def _has_attn(base: str) -> bool:
    return base in ("dense", "moe", "cross", "xdec", "hymba", "encoder")


def _has_ffn(base: str) -> bool:
    return base != "mlstm"


def _ffn_width(cfg: ModelConfig, base: str) -> int:
    if base == "slstm" and not cfg.d_ff:
        return int(cfg.d_model * 4 / 3)
    return cfg.d_ff


def _mamba_cfg(cfg: ModelConfig) -> ssm_mod.MambaConfig:
    return ssm_mod.MambaConfig(
        d_model=cfg.d_model, d_inner=int(cfg.d_model * cfg.ssm_expand),
        d_state=cfg.ssm_state, d_conv=cfg.ssm_conv)


def _mlstm_cfg(cfg: ModelConfig) -> ssm_mod.MLSTMConfig:
    return ssm_mod.MLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_kv_heads)


def _slstm_cfg(cfg: ModelConfig) -> ssm_mod.SLSTMConfig:
    return ssm_mod.SLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_kv_heads)


def init_block(generator, cfg: ModelConfig, kind: str, dtype) -> dict:
    """One layer's parameters, in JAX's key order: ``norm1``, ``attn``,
    ``xattn``, ``norm_x``, ``gate_attn``, ``gate_ffn``, ``mamba``,
    ``norm_a``, ``norm_s``, ``mlstm``, ``slstm``, then ``moe`` or ``ffn``,
    and ``norm2``.  A ``cross`` layer carries an ``attn`` and a ``norm2``
    its forward never reads, and its gates start at 0 (the identity), as
    in JAX."""
    _check_kind(kind)
    dev = generator.device
    base = base_kind(kind)
    p = {"norm1": init_norm(cfg.d_model, cfg.norm_type, dev)}
    if _has_attn(base):
        p["attn"] = attn_mod.init_attn(generator, attn_config(cfg, kind),
                                       dtype)
    if base in ("cross", "xdec"):
        p["xattn"] = attn_mod.init_attn(
            generator, attn_config(cfg, kind, cross=True), dtype)
        p["norm_x"] = init_norm(cfg.d_model, cfg.norm_type, dev)
        if base == "cross":
            for name in ("gate_attn", "gate_ffn"):
                p[name] = torch.zeros((), dtype=torch.float32, device=dev)
    if base == "hymba":
        p["mamba"] = ssm_mod.init_mamba(generator, _mamba_cfg(cfg), dtype)
        p["norm_a"] = init_norm(cfg.d_model, cfg.norm_type, dev)
        p["norm_s"] = init_norm(cfg.d_model, cfg.norm_type, dev)
    if base == "mlstm":
        p["mlstm"] = ssm_mod.init_mlstm(generator, _mlstm_cfg(cfg), dtype)
    if base == "slstm":
        p["slstm"] = ssm_mod.init_slstm(generator, _slstm_cfg(cfg), dtype)
    if base == "moe":
        p["moe"] = init_moe_params(generator, cfg.moe, dtype)
        p["norm2"] = init_norm(cfg.d_model, cfg.norm_type, dev)
    elif _has_ffn(base) and cfg.d_ff:
        p["ffn"] = init_ffn(generator, cfg.d_model, _ffn_width(cfg, base),
                            glu=cfg.glu, bias=cfg.ffn_bias, dtype=dtype)
        if not cfg.parallel_block:
            p["norm2"] = init_norm(cfg.d_model, cfg.norm_type, dev)
    return p


def block_specs(cfg: ModelConfig, kind: str, mesh, dims) -> dict:
    """The JAX function for the kinds the port runs."""
    _check_kind(kind)
    mp = dims.mp
    base = base_kind(kind)
    s = {"norm1": norm_specs(cfg.norm_type)}
    if _has_attn(base):
        s["attn"] = attn_mod.attn_specs(mesh, mp, attn_config(cfg, kind))
    if base in ("cross", "xdec"):
        s["xattn"] = attn_mod.attn_specs(
            mesh, mp, attn_config(cfg, kind, cross=True))
        s["norm_x"] = norm_specs(cfg.norm_type)
        if base == "cross":
            s["gate_attn"] = s["gate_ffn"] = P()
    if base == "hymba":
        s["mamba"] = ssm_mod.mamba_specs(mesh, mp, _mamba_cfg(cfg))
        s["norm_a"] = norm_specs(cfg.norm_type)
        s["norm_s"] = norm_specs(cfg.norm_type)
    if base == "mlstm":
        s["mlstm"] = ssm_mod.mlstm_specs(mesh, mp, _mlstm_cfg(cfg))
    if base == "slstm":
        s["slstm"] = ssm_mod.slstm_specs(mesh, mp, _slstm_cfg(cfg))
    if base == "moe":
        s["moe"] = moe_param_specs(cfg.moe, mesh, dims)
        s["norm2"] = norm_specs(cfg.norm_type)
    elif _has_ffn(base) and cfg.d_ff:
        s["ffn"] = ffn_specs(mesh, mp, _ffn_width(cfg, base), glu=cfg.glu,
                             bias=cfg.ffn_bias)
        if not cfg.parallel_block:
            s["norm2"] = norm_specs(cfg.norm_type)
    return s


def _ffn(p, cfg: ModelConfig, h, tp):
    """The dense FFN on the residual stream ``h``: column / row parallel
    with ``tp``, or whole on every rank where ``d_ff`` does not divide
    over MP (``ffn_specs`` replicates it)."""
    if tp is None or cfg.d_ff % tp.n == 0:
        return apply_ffn(p, h, cfg.ffn_act, tp)
    return tp.from_replicated(apply_ffn(p, tp.to_replicated(h), cfg.ffn_act))


def apply_block(p, cfg: ModelConfig, kind: str, x, *, ctx=None,
                positions=None, schedule=None, mesh=None, dims=None,
                tp=None):
    """Full-sequence forward.  Returns ``(x, aux)``: ``aux["loss"]`` the
    scalar router-loss contribution (aux + z loss) and
    ``aux["expert_load"]`` the (E,) routed rows, (0,) for dense blocks.
    On a mesh (``mesh``, ``dims``) ``x`` is this rank's rows, the MoE layer
    runs over the mesh, and with ``tp`` (its MP group has more than one
    rank, ``parallel.tensor``) the attention and the dense FFN are
    Megatron-parallel: ``tp.enter`` at each sharded region's entry (so the
    input's cotangent is summed over MP), ``tp.leave`` after its
    row-parallel product; the attention by head or, for the kinds that
    take it (whisper's ``encoder``), in the gathered-heads layout
    (:func:`layout`).  Under Megatron-SP (``tp.seq``) ``x`` is this
    rank's L / n_mp rows of the stream, the norms run on them, and the MoE
    layer takes the whole sequence (``tp.to_replicated``).  ``ctx`` is the
    context a ``cross`` or ``xdec`` layer attends (B, Lctx, D): None
    attends the stream itself, unmasked, as JAX's layers do when its
    ``Trainer`` feeds no ``ctx_embeds``."""
    _check_kind(kind)
    acfg = attn_config(cfg, kind)
    eps = cfg.norm_eps
    aux = {"loss": torch.zeros((), dtype=torch.float32, device=x.device),
           "expert_load": torch.zeros((0,), dtype=torch.float32,
                                      device=x.device)}
    base = base_kind(kind)
    if base in RECURRENT:
        return _recurrent(p, cfg, kind, x, positions=positions, tp=tp), aux
    if base in ("cross", "xdec"):
        return _cross(p, cfg, kind, x, ctx=ctx, positions=positions,
                      tp=tp), aux
    h = apply_norm(p["norm1"], x, eps, cfg.kernel)
    if tp is None:
        a = attn_mod.apply_attn(p["attn"], acfg, h, positions=positions,
                                kernel=cfg.kernel)
    else:
        a = _split_region(tp, layout(cfg, kind, tp.n), h,
                          lambda h, tp, g: attn_mod.apply_attn(
                              p["attn"], acfg, h, positions=positions,
                              kernel=cfg.kernel, tp=tp, gathered=g))
    if cfg.parallel_block:
        return x + (a + _ffn(p["ffn"], cfg, h, tp)), aux
    x = x + a
    h2 = apply_norm(p["norm2"], x, eps, cfg.kernel)
    if base_kind(kind) == "moe":
        if tp is not None:
            h2 = tp.to_replicated(h2)
        y, maux = apply_moe(h2, p["moe"], cfg=cfg.moe, schedule=schedule,
                            mesh=mesh, dims=dims)
        if tp is not None:
            y = tp.from_replicated(y)
        aux = {"loss": aux["loss"] + maux["aux_loss"] + maux["z_loss"],
               "expert_load": maux["expert_load"]}
    else:
        y = _ffn(p["ffn"], cfg, h2, tp)
    return x + y, aux


def _recurrent(p, cfg: ModelConfig, kind: str, x, cache=None, step=None, *,
               positions=None, tp=None, wgrp=None):
    """A recurrent block (JAX's ``apply_block`` / ``decode_block`` for
    ``hymba``, ``mlstm`` and ``slstm``).  With ``cache`` it is one decode
    token: the attention's K/V and the recurrent state are written into
    ``cache`` in place.  Returns the block's output.

    With ``tp`` each sub-layer whose weights are split over MP runs on its
    shard between ``tp.enter`` and ``tp.leave`` (entered once for hymba's
    two heads), one that JAX's specs replicate runs whole on every rank
    (``tp.to_replicated`` / ``tp.from_replicated``): hymba's attention by
    ``attention.attn_layout``, its Mamba cell and the mLSTM cell where
    ``d_inner`` divides, the sLSTM cell always whole.  hymba normalises
    ``a`` and ``s`` apart (``norm_a``, ``norm_s``), so each is summed over
    MP whole before its norm.  ``wgrp``: the attention cache's W split,
    as ``decode_attn`` takes it."""
    base = base_kind(kind)
    eps = cfg.norm_eps
    n_mp = 1 if tp is None else tp.n

    def norm(pn, h):
        return apply_norm(pn, h, eps, cfg.kernel)

    entered = []

    def region(h, split, fn):
        """``fn(h, tp)`` on this rank's shard (``split``) and summed over
        MP, or ``fn(h, None)`` whole on every rank."""
        if tp is None:
            return fn(h, None)
        if not split:
            return tp.from_replicated(fn(tp.to_replicated(h), None))
        if not entered:
            entered.append(tp.enter(h))
        return tp.leave(fn(entered[0], tp))

    def cell(name, fn, ssm_cfg, split, h):
        def run(h, tp):
            kw = {} if tp is None else {"tp": tp}
            if cache is None:
                return fn(p[name], ssm_cfg, h, **kw)
            y, st = fn(p[name], ssm_cfg, h, state=cache[name], **kw)
            for dst, src in zip(cache[name], st):
                dst.copy_(src)
            return y
        return region(h, split, run)

    h = norm(p["norm1"], x)
    if base == "hymba":
        acfg = attn_config(cfg, kind)
        layout = attn_mod.attn_layout(acfg, n_mp)

        def attend(h, tp):
            gathered = layout == "gathered"
            if cache is None:
                return attn_mod.apply_attn(p["attn"], acfg, h,
                                           positions=positions,
                                           kernel=cfg.kernel, tp=tp,
                                           gathered=gathered)
            return attn_mod.decode_attn(p["attn"], acfg, h, cache["attn"],
                                        step, tp=tp, wgrp=wgrp,
                                        gathered=gathered)

        a = region(h, layout != "whole", attend)
        mcfg = _mamba_cfg(cfg)
        s = cell("mamba", ssm_mod.apply_mamba, mcfg,
                 ssm_mod.mamba_split(mcfg, n_mp), h)
        x = x + 0.5 * (norm(p["norm_a"], a) + norm(p["norm_s"], s))
        return x + _ffn(p["ffn"], cfg, norm(p["norm2"], x), tp)
    if base == "mlstm":
        lcfg = _mlstm_cfg(cfg)
        return x + cell("mlstm", ssm_mod.apply_mlstm, lcfg,
                        ssm_mod.mlstm_split(lcfg, n_mp), h)
    x = x + cell("slstm", ssm_mod.apply_slstm, _slstm_cfg(cfg), False, h)
    if "ffn" in p:
        x = x + _ffn(p["ffn"], cfg, norm(p["norm2"], x), tp)
    return x


def _cross(p, cfg: ModelConfig, kind: str, x, *, ctx=None, cache=None,
           step=None, ctx_kv=None, positions=None, tp=None, wgrp=None):
    """A ``cross`` or ``xdec`` block (JAX's ``apply_block`` /
    ``decode_block`` for them).  Without ``cache`` the full sequence,
    attending ``ctx``; with ``cache`` one decode token, attending
    ``ctx_kv`` (this layer's ``{"k", "v"}`` from ``Model.ctx_kv``), an
    ``xdec`` layer's self-attention K/V written into ``cache`` in place.
    ``cross`` (llama-3.2-vision): ``x + tanh(gate_attn) * xattn(norm1(x))``,
    then ``+ tanh(gate_ffn) * ffn(norm_x(x))``; ``xdec`` (whisper):
    self-attention, cross attention and the FFN, each behind its norm.
    Returns the block's output.

    With ``tp`` each sub-layer runs Megatron-split and summed over MP
    (:func:`_split_region` in :func:`layout`'s layout; the FFN through
    :func:`_ffn`), so the gates multiply the summed outputs, as in JAX.
    ``ctx`` is whole on every MP rank and each rank's K/V read only part
    of it: it enters the cross attention through ``copy_to_mp``, so its
    cotangent (whisper's encoder's) is summed over MP.  ``ctx_kv`` holds
    this rank's kv heads (``Model.ctx_kv``); ``wgrp``: the self-attention
    cache's W split, as ``decode_attn`` takes it."""
    base = base_kind(kind)
    how = "whole" if tp is None else layout(cfg, kind, tp.n)
    xcfg = attn_config(cfg, kind, cross=True)

    def norm(pn, h):
        return apply_norm(pn, h, cfg.norm_eps, cfg.kernel)

    def region(h, fn):
        return fn(h, None, False) if tp is None else \
            _split_region(tp, how, h, fn)

    def cross_attn(h, tp, gathered):
        if cache is None:
            kv_x = ctx
            if ctx is not None and tp is not None:
                kv_x = copy_to_mp(ctx, tp.grp)
            return attn_mod.apply_attn(p["xattn"], xcfg, h, kv_x=kv_x, tp=tp,
                                       gathered=gathered)
        if ctx_kv is None:
            raise ValueError(f"{cfg.name}: decoding a {base} layer needs "
                             "its context's K/V (ctx_kv=, Model.ctx_kv)")
        return attn_mod.decode_attn(p["xattn"], xcfg, h, None, step,
                                    kv_cache_static=ctx_kv, tp=tp,
                                    gathered=gathered)

    if base == "cross":
        gate = torch.tanh(p["gate_attn"]).to(x.dtype)
        x = x + gate * region(norm(p["norm1"], x), cross_attn)
        f = _ffn(p["ffn"], cfg, norm(p["norm_x"], x), tp)
        return x + torch.tanh(p["gate_ffn"]).to(x.dtype) * f
    acfg = attn_config(cfg, kind)

    def self_attn(h, tp, gathered):
        if cache is None:
            return attn_mod.apply_attn(p["attn"], acfg, h,
                                       positions=positions,
                                       kernel=cfg.kernel, tp=tp,
                                       gathered=gathered)
        return attn_mod.decode_attn(p["attn"], acfg, h, cache["attn"], step,
                                    tp=tp, wgrp=wgrp, gathered=gathered)

    x = x + region(norm(p["norm1"], x), self_attn)
    x = x + region(norm(p["norm_x"], x), cross_attn)
    return x + _ffn(p["ffn"], cfg, norm(p["norm2"], x), tp)


def _cached_block(p, cfg: ModelConfig, kind: str, x, attend, *, schedule,
                  infer, mesh, dims, tp, replicated):
    """The serving forward of one block around ``attend(p_attn, acfg, h,
    tp)``, the attention over its cache: norm, attention (this rank's
    part, summed over MP with ``tp``), residual, then the dense FFN or the
    MoE layer (``infer`` its shape class, ``replicated`` whether ``x`` is
    the whole pool on every rank of the mesh).  Returns ``(output,
    expert_load)``: the MoE layer's (E,) routed rows, (0,) for a dense
    block."""
    _check_kind(kind)
    acfg = attn_config(cfg, kind)
    eps = cfg.norm_eps
    h = apply_norm(p["norm1"], x, eps, cfg.kernel)
    if tp is None:
        a = attend(p["attn"], acfg, h, None)
    else:
        a = tp.leave(attend(p["attn"], acfg, tp.enter(h), tp))
    no_load = torch.zeros((0,), dtype=torch.float32, device=x.device)
    if cfg.parallel_block:
        return x + (a + _ffn(p["ffn"], cfg, h, tp)), no_load
    x = x + a
    h2 = apply_norm(p["norm2"], x, eps, cfg.kernel)
    if base_kind(kind) == "moe":
        y, maux = apply_moe(h2, p["moe"], cfg=cfg.moe, schedule=schedule,
                            infer=infer, mesh=mesh, dims=dims,
                            replicated=replicated)
        return x + y, maux["expert_load"]
    return x + _ffn(p["ffn"], cfg, h2, tp), no_load


def paged_block(p, cfg: ModelConfig, kind: str, x, cache, table, starts,
                lens, *, schedule=None, infer=False, mesh=None, dims=None,
                tp=None, with_aux=False):
    """Block forward over a paged KV arena: decode (C=1, ``infer=True``),
    one-shot and chunked prefill (``infer=False``) all run this one path.
    ``cache`` is this layer's ``{"attn": arena}``, updated in place.
    Returns the block's output, or with ``with_aux`` ``(output,
    expert_load)``: the MoE layer's (E,) routed rows ((0,) for a dense
    block), the serving engine's load-EMA feed.

    On a mesh ``x`` is the engine's whole pool on every rank: with ``tp``
    the attention runs this rank's heads over its kv heads' arena and the
    dense FFN its columns, each summed over MP (``tp.leave``) as in
    ``apply_block``; the MoE layer takes the pool replicated
    (``apply_moe(replicated=True)``), runs this rank's tokens and returns
    the pool's output on every rank."""
    if base_kind(kind) not in ATTENTION_ONLY:
        raise NotImplementedError(
            f"paged_block: kind {kind!r} has no paged-cache path "
            "(serving engine supports dense/moe decoder stacks)")
    out, load = _cached_block(
        p, cfg, kind, x,
        lambda pa, acfg, h, tp: attn_mod.paged_chunk_attn(
            pa, acfg, h, cache["attn"], table, starts, lens, tp=tp),
        schedule=schedule, infer=infer, mesh=mesh, dims=dims, tp=tp,
        replicated=mesh is not None)
    return (out, load) if with_aux else out


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, state_shards=None, **shard) -> dict:
    """This layer's decode cache: ``{"attn": {"k", "v", "pos"}}``
    (``attention.init_cache``; ``shard``: its ``kv_heads`` and
    ``w_shards``) where it self-attends, and JAX's recurrent state tuples
    beside or instead of it: ``"mamba"`` ``(conv_buf, h)``, ``"mlstm"``
    ``(C, n, m)``, ``"slstm"`` ``(c, n, h, m)``, each cut to this rank's
    ``1 / state_shards[cell]`` of its channels or heads
    (:func:`state_shards`; default whole); a ``cross`` layer, whose
    context K/V come per request (``Model.ctx_kv``), JAX's 0-d
    ``"dummy"``."""
    _check_kind(kind)
    base = base_kind(kind)
    c = {}
    if base == "cross":
        c["dummy"] = torch.zeros((), dtype=dtype, device=device)
    elif _has_attn(base):
        c["attn"] = attn_mod.init_cache(attn_config(cfg, kind), batch,
                                        max_len, dtype, device, **shard)
    n = state_shards or {}
    if base == "hymba":
        c["mamba"] = ssm_mod.init_mamba_state(
            _mamba_cfg(cfg), batch, dtype, device, shards=n.get("mamba", 1))
    if base == "mlstm":
        lcfg = _mlstm_cfg(cfg)
        c["mlstm"] = ssm_mod.init_mlstm_state(
            lcfg, batch, device, heads=lcfg.n_heads // n.get("mlstm", 1))
    if base == "slstm":
        c["slstm"] = ssm_mod.init_slstm_state(_slstm_cfg(cfg), batch, device)
    return c


def prefill_block(p, cfg: ModelConfig, kind: str, x, cache, lengths, *,
                  schedule=None, mesh=None, dims=None, tp=None, wgrp=None,
                  replicated=False):
    """Whole-prompt block forward that also fills this layer's decode
    cache in place (``attention.prefill_attn``).  The MoE layer takes the
    prefill shape class (``infer=False``: training capacity).  On a mesh
    ``x`` is this rank's rows of the batch (the whole batch on every rank
    with ``replicated``), ``tp`` and ``wgrp`` as ``prefill_attn`` takes
    them.  Returns the block's output."""
    if base_kind(kind) not in ATTENTION_ONLY:
        raise NotImplementedError(
            f"prefill_block: kind {kind!r} has no cache-filling prefill "
            "(serving engine supports dense/moe decoder stacks)")
    return _cached_block(
        p, cfg, kind, x,
        lambda pa, acfg, h, tp: attn_mod.prefill_attn(
            pa, acfg, h, cache["attn"], lengths, kernel=cfg.kernel, tp=tp,
            wgrp=wgrp),
        schedule=schedule, infer=False, mesh=mesh, dims=dims, tp=tp,
        replicated=replicated)[0]


def decode_block(p, cfg: ModelConfig, kind: str, x, cache, step, *,
                 ctx_kv=None, schedule=None, mesh=None, dims=None, tp=None,
                 wgrp=None, replicated=False):
    """One-token decode through this layer's cache, written in place
    (``attention.decode_attn``).  The MoE layer takes the decode shape
    class (``infer=True``: its own decision, drop-free capacity; a pool
    smaller than its MP group falls back to ``dense_decode``).  Mesh
    arguments as :func:`prefill_block`.  A recurrent kind also carries
    its state one token on, in place (on a mesh its shard of it,
    ``_recurrent``), and a ``cross`` or ``xdec`` layer attends its
    context's precomputed ``ctx_kv`` (on a mesh this rank's kv heads of
    it, ``_cross``).  Returns the block's output."""
    base = base_kind(kind)
    if base in RECURRENT:
        return _recurrent(p, cfg, kind, x, cache, step, tp=tp, wgrp=wgrp)
    if base in ("cross", "xdec"):
        return _cross(p, cfg, kind, x, cache=cache, step=step,
                      ctx_kv=ctx_kv, tp=tp, wgrp=wgrp)
    return _cached_block(
        p, cfg, kind, x,
        lambda pa, acfg, h, tp: attn_mod.decode_attn(
            pa, acfg, h, cache["attn"], step, tp=tp, wgrp=wgrp),
        schedule=schedule, infer=True, mesh=mesh, dims=dims, tp=tp,
        replicated=replicated)[0]
