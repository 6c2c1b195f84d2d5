"""Model assembly (counterpart of ``repro/models/model.py``): embedding ->
blocks -> final norm -> LM head, for training (``forward``, ``loss``),
for the serving engine's steps over a paged KV arena (``paged_step``) and
for the KV-cache serve path over per-row caches (``init_cache``,
``prefill_step``, ``decode_step``; on a mesh in the layout
``train.loop.cache_specs`` gives).  The recurrent stacks (hymba, xlstm)
and the cross-attention ones (llama-3.2-vision's gated cross layers,
whisper's encoder and decoder) train and decode on one rank and on a mesh
(``blocks._recurrent``, ``blocks._cross``).  ``prefill_step`` and
``paged_step`` refuse both, as JAX's do.

A cross-attention model reads its context from ``batch["ctx_embeds"]``
(B, Lctx, D), the modality frontends' output, which the port, as JAX,
takes precomputed (``_encode_ctx``): llama-3.2-vision's image embeddings
as they are, whisper's frames through its encoder (``encoder``,
``enc_norm``; on a mesh Megatron-split over MP, the frames whole on every
MP rank).  Serving computes each ``cross`` / ``xdec`` layer's context K/V
once (``ctx_kv``; on a mesh this rank's rows and kv heads) and hands them
to every ``decode_step``.

Parameters keep the JAX package's pytree layout: ``embed``,
``final_norm``, ``lm_head`` and one ``run{r}`` dict per run of same-kind
layers, whose tensors carry a leading layer dimension.  Layer ``i`` of a
run is a view of those tensors (``layer_view``; ``layer_views`` for all
layers at once), so the JAX parameters load unchanged
(``repro_torch.convert``), nothing is copied per step, and a layer's
gradients land in the stacked tensors.

On a mesh (``mesh=``, ``dims=``, ``repro_torch.parallel``) the batch is
this rank's rows and the parameters its shards (``param_specs``, JAX's
``Model.specs``): the MoE layers' experts over EP and ESP, and, where the
MP group has more than one rank, the dense layers Megatron-style over MP
(``parallel.tensor``): attention by head, the dense FFN column / row,
the embedding and the LM head by vocabulary row (where the vocabulary
divides over MP; gpt2-moe's 50257 does not, and JAX replicates it too),
with a vocab-parallel CE.  The MoE layer sees its input replicated over
MP, after the attention's row-parallel sum: the merged setting whose
redundancy Parm's S1 and S2 remove.  Under ``cfg.seq_parallel`` (where L
divides over MP) the residual stream between the sharded regions is
sharded along L (Megatron-SP), as JAX's sharding constraint has it.  The
loss is the global batch's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models.attention import mp_heads
from repro_torch.models.layers import (apply_norm, embed, embedding_specs,
                                       init_embedding, init_norm, norm_specs,
                                       sinusoidal_positions, unembed)
from repro_torch.models.ssm import mlstm_split
from repro_torch.parallel import comm
from repro_torch.parallel.mesh import axis_size
from repro_torch.parallel.sharding import P, mentioned
from repro_torch.parallel.tensor import reduce_from_mp, tensor_parallel


#: at most this many f32 logits (batch x chunk x vocab) per CE chunk, as
#: in JAX's ``Model.loss``
CE_CHUNK_ELEMENTS = 1 << 28


def layer_view(tree, i: int):
    """Layer ``i`` of a run's stacked parameter (or cache) tree: views.
    A cache's recurrent state is a tuple of stacked tensors (JAX's)."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(layer_view(v, i) for v in tree)
    return tree[i]


def layer_views(tree: dict, n: int) -> list:
    """All ``n`` layers of a run's stacked parameter dict, as views
    (``torch.unbind`` of every leaf).  In a backward, unbind's gradient
    stacks the layers' gradients once, where indexing ``t[i]`` layer by
    layer would fill and add a full-size gradient for every layer."""
    cols = {k: layer_views(v, n) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]


def _stack(make, n: int) -> dict:
    """``n`` results of ``make()`` stacked on a new leading dimension,
    filled one layer at a time (peak memory: the stack plus one layer)."""
    def alloc(t):
        return {k: alloc(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.new_empty((n, *t.shape))

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    first = make()
    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make(), i)
    return out


def _batch_spec(run):
    """The batch axes of a run's cache specs (every leaf's dim 1 is the
    batch's, sharded alike), or None: a ``cross`` run's ``dummy`` has no
    batch dim (its spec is ``P(None)``)."""
    spec = _first_spec(run)
    return spec[1] if len(spec) > 1 else None


#: a recurrent state's leaf 0 dim that its MP shard cuts, by cell
#: (``train.loop.cache_specs``): Mamba's ``conv_buf`` (n, B, C, Di) and
#: mLSTM's ``C`` (n, B, H, hd, hd)
STATE_DIM = {"mamba": 3, "mlstm": 2, "slstm": 2}


def _cache_kinds(kind: str) -> tuple:
    """The cache entries of a layer of ``kind`` (``init_block_cache``'s
    keys)."""
    base = blk.base_kind(kind)
    out = ("attn",) if blk._has_attn(base) and base != "cross" else ()
    return out + tuple(c for c, b in (("mamba", "hymba"), ("mlstm", "mlstm"),
                                      ("slstm", "slstm")) if base == b)


def _first_spec(tree):
    """The first spec of a run's cache specs (every leaf's dim 1 is the
    batch's, sharded alike)."""
    if isinstance(tree, dict):
        return _first_spec(next(iter(tree.values())))
    return tree if isinstance(tree, P) else tree[0]


def _in_order_of(tree: dict, like: dict) -> dict:
    """``tree`` with ``like``'s keys in ``like``'s order (the same keys)."""
    if set(tree) != set(like):
        raise ValueError(f"parameter tree has {sorted(like)}, the config "
                         f"needs {sorted(tree)}")
    return {k: _in_order_of(tree[k], like[k]) if isinstance(tree[k], dict)
            else tree[k] for k in like}


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.runs = cfg.runs()
        self.has_cross = any(blk.base_kind(k) in ("cross", "xdec")
                             for k, _ in self.runs)
        self.has_encoder = cfg.arch_type == "audio" and cfg.encoder_layers > 0
        bad = [k for k, _ in self.runs if blk.base_kind(k) not in blk.KINDS]
        if bad:
            raise NotImplementedError(
                f"{cfg.name}: block kinds {bad} come with a later slice of "
                f"the port (it runs {blk.KINDS} stacks)")

    def _refuse_kinds(self, what: str, tail: str):
        """JAX's refusal of a non-dense/moe stack in ``prefill_step`` and
        ``paged_step``."""
        bad = [k for k, _ in self.runs
               if blk.base_kind(k) not in blk.ATTENTION_ONLY]
        if bad:
            raise NotImplementedError(
                f"{what}: unsupported block kinds {bad} ({tail})")

    # --- params -----------------------------------------------------------
    def init(self, generator) -> dict:
        """Random parameters from ``generator`` (on the model's device); an
        audio arch's ``encoder`` layers (stacked) and ``enc_norm`` last, as
        in JAX."""
        cfg = self.cfg
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        dtype = getattr(torch, cfg.dtype)
        params = {"embed": init_embedding(generator, cfg.vocab_size,
                                          cfg.d_model, dtype),
                  "final_norm": init_norm(cfg.d_model, cfg.norm_type,
                                          self.device)}
        if not cfg.tie_embeddings:
            w = torch.randn((cfg.d_model, cfg.vocab_size),
                            generator=generator, device=self.device,
                            dtype=torch.float32)
            params["lm_head"] = {
                "w": w.div_(math.sqrt(cfg.d_model)).to(dtype)}
        for r, (kind, n) in enumerate(self.runs):
            params[f"run{r}"] = _stack(
                lambda kind=kind: blk.init_block(generator, cfg, kind, dtype),
                n)
        if self.has_encoder:
            params["encoder"] = _stack(lambda: blk.init_block(
                generator, cfg, "encoder", dtype), cfg.encoder_layers)
            params["enc_norm"] = init_norm(cfg.d_model, cfg.norm_type,
                                           self.device)
        return params

    def init_cache(self, batch: int, max_len: int, dtype=None, *,
                   mesh=None, dims=None, specs=None) -> dict:
        """A KV cache of ``batch`` rows and ``max_len`` positions: per run
        ``{"attn": {"k","v": (n, batch, W, Kh, hd), "pos": (n, batch,
        W)}}`` (``pos`` -1 = empty; W is ``max_len`` or a sliding window's
        ring), and beside or instead of it a recurrent run's state tuple
        or a ``cross`` run's ``dummy`` (``blocks.init_block_cache``), each
        leaf with the run's layer dimension in front, as JAX's tree.  The
        paged arena takes it as (pages, block size).

        On a mesh (``mesh``, ``dims``) it is this rank's shard: ``Kh`` this
        rank's kv heads (``attention.mp_heads``) where its MP group has
        more than one rank; with ``specs`` (``train.loop.cache_specs``)
        the layout they give, this rank's rows where the batch is sharded
        and its slice of W with every kv head where W is (``pos`` stays
        whole along W, as the specs leave it).  A recurrent state holds
        this rank's shard (``blocks.state_shards``; with ``specs``, the
        MP axes of its leaves): Mamba's channels, mLSTM's heads."""
        cfg = self.cfg
        dtype = dtype or getattr(torch, cfg.dtype)
        n_mp = axis_size(mesh, dims.mp) if mesh is not None else 1

        def stack(t, n):
            if isinstance(t, dict):
                return {k: stack(v, n) for k, v in t.items()}
            if isinstance(t, tuple):
                return tuple(stack(v, n) for v in t)
            return t[None].repeat(n, *([1] * t.dim()))

        cache = {}
        for r, (kind, n) in enumerate(self.runs):
            rows, shard = batch, {}
            states = blk.state_shards(cfg, kind, n_mp)
            if "attn" in _cache_kinds(kind):
                shard["kv_heads"] = self._kv_heads(kind, n_mp)
            if specs is not None:
                run = specs[f"run{r}"]
                rows //= axis_size(mesh, _batch_spec(run) or ())
                if "attn" in run and run["attn"]["k"][2]:
                    shard = {"w_shards": axis_size(mesh,
                                                   run["attn"]["k"][2])}
                states = {c: axis_size(mesh, sp[0][STATE_DIM[c]] or ())
                          for c, sp in run.items() if c in STATE_DIM}
            cache[f"run{r}"] = stack(blk.init_block_cache(
                cfg, kind, rows, max_len, dtype, self.device,
                state_shards=states, **shard), n)
        return cache

    def _kv_heads(self, kind, n_mp: int) -> int:
        """The kv heads a rank's attention cache (or a cross layer's
        ``ctx_kv``) holds over ``n_mp`` MP ranks: ``mp_heads``', or every
        one in the gathered-heads and whole layouts (``blocks.layout``)."""
        acfg = blk.attn_config(self.cfg, kind)
        if blk.layout(self.cfg, kind, n_mp) != "heads":
            return acfg.n_kv_heads
        return mp_heads(acfg, n_mp)[1]

    # --- forward ------------------------------------------------------------
    def _head(self, params, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = unembed(params["embed"], x)
        else:
            logits = x @ params["lm_head"]["w"]
        return logits * cfg.logit_scale

    def param_specs(self, params, mesh, dims) -> dict:
        """Each leaf's ``PartitionSpec`` on ``mesh``: JAX's ``Model.specs``
        (``block_specs`` behind the layer dimension), in ``params``'s tree
        and key order (a JAX tree comes with sorted keys), so that the
        leaves of the two line up.  Raises, naming the config and the
        mesh, where the attention heads do not split over MP as the port
        runs them (``attention.mp_heads``; hymba's and the cross-attention
        kinds' attention takes the gathered-heads layout where they do
        not, ``blocks.layout``)."""
        cfg = self.cfg
        n_mp = axis_size(mesh, dims.mp)
        kinds = [k for k, _ in self.runs] + (
            ["encoder"] if self.has_encoder else [])
        try:
            for kind in kinds:
                if blk._has_attn(blk.base_kind(kind)) \
                        and blk.layout(cfg, kind, n_mp) == "heads":
                    mp_heads(blk.attn_config(cfg, kind), n_mp)
        except ValueError as e:
            raise ValueError(f"{cfg.name} on mesh {dict(mesh.shape)} (MP "
                             f"axes {dims.mp}): {e}") from None
        specs = {"embed": embedding_specs(mesh, dims.mp, cfg.vocab_size),
                 "final_norm": norm_specs(cfg.norm_type)}
        if not cfg.tie_embeddings:
            specs["lm_head"] = {"w": P(None, specs["embed"]["table"][0])}

        def add_layer_dim(tree):
            return {k: add_layer_dim(v) for k, v in tree.items()} \
                if isinstance(tree, dict) else P(None, *tree)

        for r, (kind, _) in enumerate(self.runs):
            specs[f"run{r}"] = add_layer_dim(
                blk.block_specs(cfg, kind, mesh, dims))
        if self.has_encoder:
            specs["encoder"] = add_layer_dim(
                blk.block_specs(cfg, "encoder", mesh, dims))
            specs["enc_norm"] = norm_specs(cfg.norm_type)
        return _in_order_of(specs, params)

    def mp_partial(self, params, mesh, dims, seq_len: int) -> dict:
        """Per leaf (``param_specs``'s tree), whether each MP rank's
        gradient of it is only its part of the whole: a kv projection
        (``attn``'s or ``xattn``'s) replicated over MP where the attention
        runs split (each rank reads the kv head its query heads use, or,
        in the gathered-heads layout, feeds only its columns of the
        output), a split mLSTM cell's replicated gates (``w_if``, ``b_i``,
        ``b_f``: each rank's heads or output columns) and, under
        Megatron-SP, the norms, the ``cross`` gates and a row-parallel
        FFN's ``b_out`` (they see this rank's L / n_mp rows; whisper's
        encoder runs on whole frames, so not its leaves).
        ``train.loop.sync_grads`` sums those over MP.  Every other leaf
        replicated over MP (a sub-layer that runs whole on every rank:
        sLSTM, a cell JAX does not split) gets its whole gradient on every
        MP rank."""
        specs = self.param_specs(params, mesh, dims)
        tp = tensor_parallel(mesh, dims, seq_len, self.cfg.seq_parallel)
        mp = set(dims.mp)
        kinds = {f"run{r}": kind for r, (kind, _) in enumerate(self.runs)}
        norms = ("norm1", "norm2", "norm_x", "final_norm", "norm_a",
                 "norm_s")

        def split(path):
            """Whether the sub-layer ``path`` ends in runs split over MP."""
            kind = kinds.get(path[0], "encoder")
            if path[-2] in ("attn", "xattn"):
                return blk.layout(self.cfg, kind, tp.n) != "whole"
            if path[-2] == "mlstm":
                return path[-1] in ("w_if", "b_i", "b_f") and \
                    mlstm_split(blk._mlstm_cfg(self.cfg), tp.n)
            return False

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            if tp is None or mp & set(mentioned(tree)):
                return False          # no MP, or sharded over it
            if split(path):
                return True
            if not tp.seq or path[0] in ("encoder", "enc_norm"):
                return False          # the encoder's frames are whole
            if path[-1] in ("gate_attn", "gate_ffn"):
                return True
            if path[-2:] == ("ffn", "b_out"):
                return self.cfg.d_ff % tp.n == 0      # ffn_specs' rule
            return path[-2] in norms

        return walk(specs, ())

    def _layer(self, p, kind, x, schedule, mesh=None, dims=None, tp=None,
               ctx=None):
        y, aux = blk.apply_block(p, self.cfg, kind, x, ctx=ctx,
                                 schedule=schedule, mesh=mesh, dims=dims,
                                 tp=tp)
        return y, aux["loss"], aux["expert_load"]

    def _encode_ctx(self, params, batch, mesh=None, dims=None):
        """The context the ``cross`` / ``xdec`` layers attend (JAX's
        ``_encode_ctx``): None without ``batch["ctx_embeds"]``; an audio
        arch's frames plus sinusoidal positions through the encoder layers
        (without remat, as JAX's scan runs them) and ``enc_norm``; any
        other arch's ``ctx_embeds`` as they are (the image frontend's
        patch embeddings).  On a mesh the encoder runs Megatron-split over
        MP on its own ``TensorParallel``, the frames whole on every MP
        rank (never Megatron-SP: JAX constrains only the decoder stream's
        sharding); the context comes out whole on every MP rank."""
        cfg = self.cfg
        ctx = batch.get("ctx_embeds")
        if ctx is None or cfg.arch_type != "audio":
            return ctx
        tp = tensor_parallel(mesh, dims, ctx.shape[1])
        x = ctx + sinusoidal_positions(ctx.shape[1], cfg.d_model,
                                       ctx.device).to(ctx.dtype)
        for p in layer_views(params["encoder"], cfg.encoder_layers):
            x, _ = blk.apply_block(p, cfg, "encoder", x, mesh=mesh,
                                   dims=dims, tp=tp)
        return apply_norm(params["enc_norm"], x, cfg.norm_eps, cfg.kernel)

    def _vocab_sharded(self, tp) -> bool:
        """Whether the embedding and LM head are vocab-parallel over
        ``tp``'s MP group (``embedding_specs``' rule)."""
        return tp is not None and self.cfg.vocab_size % tp.n == 0

    def _head_input(self, x, tp):
        """The final hidden state, in the residual stream's layout, as the
        LM head takes it: entering a vocab-parallel head, or whole for a
        replicated one."""
        if tp is None:
            return x
        return tp.enter(x) if self._vocab_sharded(tp) else \
            tp.to_replicated(x)

    def _backbone(self, params, batch, *, schedule=None, mesh=None,
                  dims=None):
        """Embedding -> blocks -> final norm (no LM head).  A config
        without rope adds sinusoidal positions, unless it is an ``ssm``
        arch (JAX's rule).  With ``cfg.remat`` each block runs under
        activation checkpointing, so its forward (kernels included) runs
        again in the backward; the context (``_encode_ctx``) goes to each
        block as an argument of the checkpoint, so a whisper encoder's
        gradient comes back through every ``xdec`` layer's K/V.
        Returns ``(x, aux, tp)``: ``x`` in the residual stream's layout
        (this rank's L-slice under Megatron-SP) and ``tp`` this rank's
        ``TensorParallel`` (None off a mesh or on one MP rank)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, L = tokens.shape
        tp = tensor_parallel(mesh, dims, L, cfg.seq_parallel)
        if tp is None:
            x = embed(params["embed"], tokens)
        elif self._vocab_sharded(tp):
            x = embed(params["embed"], tokens, tp)
        else:
            x = tp.from_replicated(embed(params["embed"], tokens))
        if not cfg.use_rope and cfg.arch_type != "ssm":
            pe = sinusoidal_positions(L, cfg.d_model, x.device)
            x = x + (pe if tp is None else tp.rows(pe)).to(x.dtype)
        ctx = self._encode_ctx(params, batch, mesh, dims)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        expert_load = torch.zeros((0,), dtype=torch.float32, device=x.device)
        for r, (kind, n) in enumerate(self.runs):
            for p in layer_views(params[f"run{r}"], n):
                if cfg.remat:
                    x, loss, load = checkpoint(self._layer, p, kind, x,
                                               schedule, mesh, dims, tp, ctx,
                                               use_reentrant=False)
                else:
                    x, loss, load = self._layer(p, kind, x, schedule, mesh,
                                                dims, tp, ctx)
                aux_total = aux_total + loss
                if load.shape[-1]:
                    expert_load = load if not expert_load.shape[-1] \
                        else expert_load + load
        x = apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.kernel)
        return x, {"aux_loss": aux_total, "expert_load": expert_load}, tp

    def forward(self, params, batch, *, schedule=None, mesh=None,
                dims=None):
        """Full-sequence forward (train / prefill).  Returns (logits,
        aux); on a mesh with a vocab-parallel head, this rank's block of
        the vocabulary."""
        x, aux, tp = self._backbone(params, batch, schedule=schedule,
                                    mesh=mesh, dims=dims)
        return self._head(params, self._head_input(x, tp)), aux

    def _ce_sums(self, params, x, labels, tp=None):
        """(sum of -log p(label), count of labels >= 0) over one chunk.
        With ``tp`` the head is vocab-parallel: the log-sum-exp shifts by
        the max over MP (detached, ``comm.pmax``), sums its exps over MP,
        and takes the label's logit from the rank that holds it."""
        logits = self._head(params, x).float()
        m = (labels >= 0).float()
        if tp is None:
            logp = F.log_softmax(logits, dim=-1)
            ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None].long())
            return torch.sum(-ll[..., 0] * m), torch.sum(m)
        v = logits.shape[-1]
        top = comm.pmax(logits.detach().amax(dim=-1), tp.grp)
        se = reduce_from_mp(torch.exp(logits - top[..., None]).sum(dim=-1),
                            tp.grp)
        local = labels.long() - tp.index * v
        own = (local >= 0) & (local < v)
        hit = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])
        tgt = reduce_from_mp(torch.where(own, hit[..., 0],
                                         torch.zeros_like(top)), tp.grp)
        ll = tgt - (top + torch.log(se))
        return torch.sum(-ll * m), torch.sum(m)

    def loss(self, params, batch, *, schedule=None, mesh=None, dims=None):
        """Mean next-token CE over ``batch["labels"]`` (< 0 = ignored) plus
        the router losses.  Returns ``(total, metrics)`` with ``ce``,
        ``aux``, ``ppl_proxy`` and ``expert_load`` (routed rows per expert,
        summed over layers; (0,) for dense models).

        CE runs in sequence chunks, halved while ``B * chunk * V`` exceeds
        ``CE_CHUNK_ELEMENTS``, each chunk checkpointed, so the (B, L, V) f32
        logits are never materialized whole.

        On a mesh ``batch`` is this rank's rows: the CE sums and label
        counts are ``psum``-ed over the batch axes for the value (the
        global mean, JAX's), while the gradient is that of this rank's
        sum over the global count, so the batch axes' gradient sum
        (``train.loop.sync_grads``) gives the global gradient.  The chunk
        length follows this rank's rows, as JAX's follows ``b_local``, and
        the whole vocabulary, a vocab-parallel head's too.  Every MP rank
        computes the same loss, and its gradient is that of one copy."""
        cfg = self.cfg
        labels = batch["labels"]
        B, L = labels.shape
        hidden, aux, tp = self._backbone(params, batch, schedule=schedule,
                                         mesh=mesh, dims=dims)
        hidden = self._head_input(hidden, tp)
        vp = tp if self._vocab_sharded(tp) else None
        chunk = L
        while B * chunk * cfg.vocab_size > CE_CHUNK_ELEMENTS \
                and chunk % 2 == 0:
            chunk //= 2
        n_chunks = L // chunk if L % chunk == 0 else 1
        if n_chunks <= 1:
            tot, n = self._ce_sums(params, hidden, labels, vp)
        else:
            tot = n = 0.0
            for c in range(n_chunks):
                sl = slice(c * chunk, (c + 1) * chunk)
                s, m = checkpoint(self._ce_sums, params, hidden[:, sl],
                                  labels[:, sl], vp, use_reentrant=False)
                tot, n = tot + s, n + m
        if mesh is None:
            ce = tot / torch.clamp(n, min=1.0)
        else:
            grp = mesh.group(dims.batch_axes)
            n_all = torch.clamp(comm.psum(n.detach(), grp), min=1.0)
            part = tot / n_all
            ce = comm.psum(tot.detach(), grp) / n_all \
                + (part - part.detach())
        total = ce + aux["aux_loss"]
        return total, {"ce": ce, "aux": aux["aux_loss"],
                       "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0)),
                       "expert_load": aux["expert_load"]}

    def paged_step(self, params, cache, batch, *, schedule=None,
                   infer: bool = False, mesh=None, dims=None,
                   with_aux: bool = False):
        """One step over the paged KV arena (the serving engine's one path).

        ``batch`` holds ``tokens`` (B, C), ``starts`` (B,) absolute position
        of each row's first token, ``lens`` (B,) valid counts and
        ``tables`` (B, max_blocks) int32 page tables, all tensors on the
        model's device.  ``C = 1``/``infer=True`` is a decode round; larger
        C a prefill chunk (``infer=False``: prefill capacity).  The arena
        ``cache`` is updated in place.  Returns ``(last_logits, cache)``,
        ``last_logits[b]`` at row b's last valid position.

        On a mesh (``mesh``, ``dims``) the batch is the whole pool on every
        rank, the parameters and the arena this rank's shards
        (``param_specs``, ``init_cache(mesh=)``): the dense layers run
        Megatron-parallel over MP, the MoE layers under Parm's schedules
        on this rank's tokens (``paged_block``).  A vocab-parallel head's
        blocks of logits are all-gathered over MP, so every rank returns
        the whole rows, the same bits on each: sampling draws from whole
        rows, with the sampler's own tie rule, and a (B, V) gather of the
        last positions costs one collective a step.

        ``with_aux=True`` returns ``(last_logits, cache, aux)`` with
        ``aux["expert_load"]`` the (E,) routed rows summed over the layers
        ((0,) for a dense stack): the serving engine's load-EMA feed.
        """
        cfg = self.cfg
        self._refuse_kinds("paged_step", "paged serving covers dense/moe "
                               "decoder stacks")
        tokens = batch["tokens"]
        starts, lens, tables = batch["starts"], batch["lens"], batch["tables"]
        B, C = tokens.shape
        tp = tensor_parallel(mesh, dims, C)
        vp = self._vocab_sharded(tp)
        x = embed(params["embed"], tokens, tp if vp else None)
        if not cfg.use_rope:
            pe = sinusoidal_positions(2048, cfg.d_model, x.device)
            qpos = torch.clamp(starts[:, None] + torch.arange(
                C, device=x.device), max=2047)
            x = x + pe[qpos].to(x.dtype)
        load = None
        for r, (kind, n) in enumerate(self.runs):
            run_p, run_c = params[f"run{r}"], cache[f"run{r}"]
            for i in range(n):
                out = blk.paged_block(
                    layer_view(run_p, i), cfg, kind, x, layer_view(run_c, i),
                    tables, starts, lens, schedule=schedule, infer=infer,
                    mesh=mesh, dims=dims, tp=tp, with_aux=with_aux)
                if not with_aux:
                    x = out
                    continue
                x, lay = out
                if lay.shape[-1]:
                    load = lay if load is None else load + lay
        x = apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.kernel)
        idx = torch.clamp(lens.long() - 1, 0, C - 1)
        h_last = x[torch.arange(B, device=x.device), idx]   # (B, D)
        logits = self._serve_head(params, h_last[:, None, :], tp)[:, 0]
        if with_aux:
            if load is None:
                load = torch.zeros((0,), dtype=torch.float32,
                                   device=x.device)
            return logits, cache, {"expert_load": load}
        return logits, cache

    # --- the KV-cache serve path --------------------------------------------
    def ctx_kv(self, params, batch, *, mesh=None, dims=None):
        """Each ``cross`` / ``xdec`` run's static context K/V, made once per
        request batch for its decode steps (JAX's ``ctx_kv``): ``{"run{r}":
        {"k", "v": (n, B, Lctx, K, hd)}}`` from the context of
        ``batch["ctx_embeds"]`` (``_encode_ctx``: whisper's encoder runs
        here).  None without ``ctx_embeds``.

        On a mesh ``batch`` is this rank's rows and ``K`` this rank's kv
        heads (``_kv_heads``: its block where the kv projection is
        sharded over MP, the one its query heads share where it is not,
        every head in the gathered-heads and whole layouts), as the
        self-attention cache keeps them: ``decode_step`` reads them where
        they are, and no K or V crosses ranks.  JAX's batch-sharded
        ``ctx_kv`` holds every kv head."""
        ctx = self._encode_ctx(params, batch, mesh, dims)
        if ctx is None:
            return None
        tp = tensor_parallel(mesh, dims, ctx.shape[1])
        out = {}
        for r, (kind, n) in enumerate(self.runs):
            if blk.base_kind(kind) not in ("cross", "xdec"):
                continue
            acfg = blk.attn_config(self.cfg, kind, cross=True)
            heads = tp if tp is not None and \
                blk.layout(self.cfg, kind, tp.n) == "heads" else None
            kv = [attn_mod.context_kv(p["xattn"], acfg, ctx, heads)
                  for p in layer_views(params[f"run{r}"], n)]
            out[f"run{r}"] = {"k": torch.stack([k for k, _ in kv]),
                              "v": torch.stack([v for _, v in kv])}
        return out

    def _cache_layout(self, r, mesh, specs):
        """``(wgrp, replicated)`` of run ``r``'s cache, read from the specs
        ``train.loop.cache_specs`` gave it (the one place the layout is
        decided): the group the attention cache's W is split over (None:
        whole, or no attention), and whether the batch is whole on every
        rank (not sharded over the batch axes)."""
        if mesh is None:
            return None, False
        if specs is None:
            raise ValueError("on a mesh the KV cache's layout comes from "
                             "specs= (train.loop.cache_specs)")
        run = specs[f"run{r}"]
        w = run["attn"]["k"][2] if "attn" in run else None
        return (mesh.group(w) if w else None), _batch_spec(run) is None

    def _serve_head(self, params, x, tp):
        """Logits of the (B, C, D) final hidden states: every rank the whole
        vocabulary (a vocab-parallel head's blocks all-gathered over MP, as
        ``paged_step`` does)."""
        logits = self._head(params, self._head_input(x, tp))
        if self._vocab_sharded(tp):
            logits = comm.all_gather(logits.contiguous(), tp.grp, -1)
        return logits

    def prefill_step(self, params, cache, batch, *, lengths, schedule=None,
                     mesh=None, dims=None, specs=None):
        """Batched one-shot prefill of the KV cache: ONE forward over the
        right-padded prompts ``batch["tokens"]`` (B, L), ``lengths`` (B,)
        valid tokens each, that fills every layer's cache in place.
        Returns ``(last_logits, cache)``, ``last_logits[b]`` (V,) at row
        b's own last prompt position.

        On a mesh ``params`` are this rank's shards (``param_specs``),
        ``cache`` its shard of the layout ``specs`` gives
        (``init_cache(specs=)``) and the batch its rows of it (the whole
        batch where the specs leave it unsharded): the dense layers run
        Megatron-parallel over MP, and each rank returns whole rows of
        logits."""
        cfg = self.cfg
        self._refuse_kinds("prefill_step", "cache-filling prefill covers "
                               "dense/moe decoder stacks")
        tokens = batch["tokens"]
        B, L = tokens.shape
        tp = tensor_parallel(mesh, dims, L)
        x = embed(params["embed"], tokens,
                  tp if self._vocab_sharded(tp) else None)
        if not cfg.use_rope:
            x = x + sinusoidal_positions(L, cfg.d_model, x.device).to(x.dtype)
        for r, (kind, n) in enumerate(self.runs):
            wgrp, replicated = self._cache_layout(r, mesh, specs)
            run_p, run_c = params[f"run{r}"], cache[f"run{r}"]
            for i in range(n):
                x = blk.prefill_block(
                    layer_view(run_p, i), cfg, kind, x, layer_view(run_c, i),
                    lengths, schedule=schedule, mesh=mesh, dims=dims, tp=tp,
                    wgrp=wgrp, replicated=replicated)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.kernel)
        idx = torch.clamp(lengths.long() - 1, 0, L - 1)
        h_last = x[torch.arange(B, device=x.device), idx]   # (B, D)
        return self._serve_head(params, h_last[:, None, :], tp)[:, 0], cache

    def decode_step(self, params, cache, batch, *, schedule=None, mesh=None,
                    dims=None, specs=None, ctx_kv=None):
        """One serve step through the KV cache, written in place: (B, 1)
        ``batch["tokens"]`` at absolute position ``batch["step"]`` (a
        scalar, or a (B,) tensor with each row at its own) -> ``(logits
        (B, 1, V), cache)``.  A config without rope adds the sinusoidal
        position, clamped at 2047 as in JAX (an ``ssm`` arch adds none, as
        its training forward adds none).  A recurrent run carries its
        state one token on, in place; a ``cross`` / ``xdec`` run attends
        its layers' ``ctx_kv`` (:meth:`ctx_kv`).  Mesh arguments as
        :meth:`prefill_step`; a recurrent run carries this rank's shard of
        its state, and a cross run reads this rank's kv heads of
        ``ctx_kv`` (made with the same mesh): neither crosses ranks."""
        cfg = self.cfg
        tokens = batch["tokens"]
        step = batch["step"]
        tp = tensor_parallel(mesh, dims, 1)
        x = embed(params["embed"], tokens,
                  tp if self._vocab_sharded(tp) else None)
        if not cfg.use_rope and cfg.arch_type != "ssm":
            pe = sinusoidal_positions(2048, cfg.d_model, x.device)
            idx = torch.clamp(torch.as_tensor(step, device=x.device).long(),
                              max=2047)
            # (1 or B, D): an index_select, which a 0-d step on the meta
            # device (the dry run) takes where ``pe[idx]`` asks its value
            row = pe.index_select(0, idx.reshape(-1))
            x = x + row[:, None].to(x.dtype)
        for r, (kind, n) in enumerate(self.runs):
            wgrp, replicated = self._cache_layout(r, mesh, specs)
            run_p, run_c = params[f"run{r}"], cache[f"run{r}"]
            run_kv = (ctx_kv or {}).get(f"run{r}")
            for i in range(n):
                x = blk.decode_block(
                    layer_view(run_p, i), cfg, kind, x, layer_view(run_c, i),
                    step, ctx_kv=None if run_kv is None else layer_view(
                        run_kv, i), schedule=schedule, mesh=mesh, dims=dims,
                    tp=tp, wgrp=wgrp, replicated=replicated)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.kernel)
        return self._serve_head(params, x, tp), cache
