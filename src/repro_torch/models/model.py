"""Model assembly for the serving path (counterpart of
``repro/models/model.py``): embedding -> blocks over a paged KV arena ->
final norm -> LM head.

Parameters keep the JAX package's pytree layout: ``embed``,
``final_norm``, ``lm_head`` and one ``run{r}`` dict per run of same-kind
layers, whose tensors carry a leading layer dimension.  Layer ``i`` of a
run is a view ``t[i]`` of those tensors, so the JAX parameters load
unchanged (``repro_torch.convert``) and nothing is copied per step.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as blk
from repro_torch.models.attention import init_cache as init_attn_cache
from repro_torch.models.layers import (apply_norm, embed, init_embedding,
                                       init_norm, sinusoidal_positions,
                                       unembed)


def layer_view(tree: dict, i: int) -> dict:
    """Layer ``i`` of a run's stacked parameter (or cache) dict: views."""
    return {k: layer_view(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


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
