"""Model assembly (counterpart of ``repro/models/model.py``): embedding ->
blocks -> final norm -> LM head, for training (``forward``, ``loss``) and
for the serving engine's steps over a paged KV arena (``paged_step``).

Parameters keep the JAX package's pytree layout: ``embed``,
``final_norm``, ``lm_head`` and one ``run{r}`` dict per run of same-kind
layers, whose tensors carry a leading layer dimension.  Layer ``i`` of a
run is a view of those tensors (``layer_view``; ``layer_views`` for all
layers at once), so the JAX parameters load unchanged
(``repro_torch.convert``), nothing is copied per step, and a layer's
gradients land in the stacked tensors.

On a mesh (``mesh=``, ``dims=``, ``repro_torch.parallel``) the batch is
this rank's rows and the parameters its shards (``param_specs``): the
dense layers (attention, norms, embeddings, LM head) stay whole on every
rank, replicated over MP, and only the MoE layers' experts are sharded
(EP over experts, ESP over the hidden dim), so the MoE layer sees
activations replicated over MP: the merged setting whose redundancy
Parm's S1 and S2 remove.  Megatron sharding of the dense layers is not
ported yet (ROADMAP item 5.1).  The loss is the global batch's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as blk
from repro_torch.models.attention import init_cache as init_attn_cache
from repro_torch.models.layers import (apply_norm, embed, init_embedding,
                                       init_norm, sinusoidal_positions,
                                       unembed)


#: at most this many f32 logits (batch x chunk x vocab) per CE chunk, as
#: in JAX's ``Model.loss``
CE_CHUNK_ELEMENTS = 1 << 28


def layer_view(tree: dict, i: int) -> dict:
    """Layer ``i`` of a run's stacked parameter (or cache) dict: views."""
    return {k: layer_view(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


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


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.runs = cfg.runs()
        bad = [k for k, _ in self.runs if blk.base_kind(k) not in blk.KINDS]
        if bad:
            raise NotImplementedError(
                f"{cfg.name}: block kinds {bad} come with a later slice of "
                f"the port (this slice runs {blk.KINDS} decoder stacks)")

    # --- params -----------------------------------------------------------
    def init(self, generator) -> dict:
        """Random parameters from ``generator`` (on the model's device)."""
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
        return params

    def init_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        """KV arena: per run ``{"attn": {"k","v": (n, batch, max_len, Kh,
        hd), "pos": (n, batch, max_len)}}`` (``pos`` -1 = empty)."""
        cfg = self.cfg
        dtype = dtype or getattr(torch, cfg.dtype)
        cache = {}
        for r, (kind, n) in enumerate(self.runs):
            one = init_attn_cache(blk.attn_config(cfg, kind), batch, max_len,
                                  dtype, self.device)
            cache[f"run{r}"] = {"attn": {
                k: v[None].repeat(n, *([1] * v.dim()))
                for k, v in one.items()}}
        return cache

    # --- forward ------------------------------------------------------------
    def _head(self, params, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = unembed(params["embed"], x)
        else:
            logits = x @ params["lm_head"]["w"]
        return logits * cfg.logit_scale

    def param_specs(self, params, mesh, dims) -> dict:
        """Each leaf's ``PartitionSpec`` on ``mesh``, in ``params``'s tree:
        the MoE blocks' expert weights ``moe_param_specs`` behind the layer
        dimension, everything else replicated (``P()``)."""
        from repro_torch.core.moe import moe_param_specs
        from repro_torch.parallel.sharding import P

        def rep(tree):
            return {k: rep(v) for k, v in tree.items()} \
                if isinstance(tree, dict) else P()

        out = rep(params)
        for r, (kind, _) in enumerate(self.runs):
            if blk.base_kind(kind) == "moe":
                moe = moe_param_specs(self.cfg.moe, mesh, dims)
                out[f"run{r}"]["moe"] = {
                    k: P(None, *moe[k]) for k in params[f"run{r}"]["moe"]}
        return out

    def _layer(self, p, kind, x, schedule, mesh=None, dims=None):
        y, aux = blk.apply_block(p, self.cfg, kind, x, schedule=schedule,
                                 mesh=mesh, dims=dims)
        return y, aux["loss"], aux["expert_load"]

    def _backbone(self, params, batch, *, schedule=None, mesh=None,
                  dims=None):
        """Embedding -> blocks -> final norm (no LM head).  With
        ``cfg.remat`` each block runs under activation checkpointing, so
        its forward (kernels included) runs again in the backward."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, L = tokens.shape
        x = embed(params["embed"], tokens)
        if not cfg.use_rope:
            x = x + sinusoidal_positions(L, cfg.d_model, x.device).to(x.dtype)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        expert_load = torch.zeros((0,), dtype=torch.float32, device=x.device)
        for r, (kind, n) in enumerate(self.runs):
            for p in layer_views(params[f"run{r}"], n):
                if cfg.remat:
                    x, loss, load = checkpoint(self._layer, p, kind, x,
                                               schedule, mesh, dims,
                                               use_reentrant=False)
                else:
                    x, loss, load = self._layer(p, kind, x, schedule, mesh,
                                                dims)
                aux_total = aux_total + loss
                if load.shape[-1]:
                    expert_load = load if not expert_load.shape[-1] \
                        else expert_load + load
        x = apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.kernel)
        return x, {"aux_loss": aux_total, "expert_load": expert_load}

    def forward(self, params, batch, *, schedule=None, mesh=None,
                dims=None):
        """Full-sequence forward (train / prefill).  Returns (logits,
        aux)."""
        x, aux = self._backbone(params, batch, schedule=schedule, mesh=mesh,
                                dims=dims)
        return self._head(params, x), aux

    def _ce_sums(self, params, x, labels):
        """(sum of -log p(label), count of labels >= 0) over one chunk."""
        logp = F.log_softmax(self._head(params, x).float(), dim=-1)
        ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None].long())
        m = (labels >= 0).float()
        return torch.sum(-ll[..., 0] * m), torch.sum(m)

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
        length follows this rank's rows, as JAX's follows ``b_local``."""
        cfg = self.cfg
        labels = batch["labels"]
        B, L = labels.shape
        hidden, aux = self._backbone(params, batch, schedule=schedule,
                                     mesh=mesh, dims=dims)
        chunk = L
        while B * chunk * cfg.vocab_size > CE_CHUNK_ELEMENTS \
                and chunk % 2 == 0:
            chunk //= 2
        n_chunks = L // chunk if L % chunk == 0 else 1
        if n_chunks <= 1:
            tot, n = self._ce_sums(params, hidden, labels)
        else:
            tot = n = 0.0
            for c in range(n_chunks):
                sl = slice(c * chunk, (c + 1) * chunk)
                s, m = checkpoint(self._ce_sums, params, hidden[:, sl],
                                  labels[:, sl], use_reentrant=False)
                tot, n = tot + s, n + m
        if mesh is None:
            ce = tot / torch.clamp(n, min=1.0)
        else:
            from repro_torch.parallel import comm
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
                   infer: bool = False):
        """One step over the paged KV arena (the serving engine's one path).

        ``batch`` holds ``tokens`` (B, C), ``starts`` (B,) absolute position
        of each row's first token, ``lens`` (B,) valid counts and
        ``tables`` (B, max_blocks) int32 page tables, all tensors on the
        model's device.  ``C = 1``/``infer=True`` is a decode round; larger
        C a prefill chunk (``infer=False``: prefill capacity).  The arena
        ``cache`` is updated in place.  Returns ``(last_logits, cache)``,
        ``last_logits[b]`` at row b's last valid position.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        starts, lens, tables = batch["starts"], batch["lens"], batch["tables"]
        B, C = tokens.shape
        x = embed(params["embed"], tokens)
        if not cfg.use_rope:
            pe = sinusoidal_positions(2048, cfg.d_model, x.device)
            qpos = torch.clamp(starts[:, None] + torch.arange(
                C, device=x.device), max=2047)
            x = x + pe[qpos].to(x.dtype)
        for r, (kind, n) in enumerate(self.runs):
            run_p, run_c = params[f"run{r}"], cache[f"run{r}"]
            for i in range(n):
                x = blk.paged_block(
                    layer_view(run_p, i), cfg, kind, x, layer_view(run_c, i),
                    tables, starts, lens, schedule=schedule, infer=infer)
        x = apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.kernel)
        idx = torch.clamp(lens.long() - 1, 0, C - 1)
        h_last = x[torch.arange(B, device=x.device), idx]   # (B, D)
        logits = self._head(params, h_last[:, None, :])[:, 0]
        return logits, cache
