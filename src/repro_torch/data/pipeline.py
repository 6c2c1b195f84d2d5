"""Synthetic LM data (counterpart of ``repro/data/pipeline.py``; the numpy
body is a copy): a Zipf unigram mixture with induced bigram structure, so
cross-entropy has real signal while staying offline and reproducible.
Batch ``step`` is the same array in both packages; ``sharded_batch`` is
one rank's rows of it."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_heavy: int = 64          # heavy bigram successors
    heavy_prob: float = 0.7    # P(next token follows bigram table)


class SyntheticLM:
    """Deterministic synthetic corpus with learnable bigram structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipf unigram distribution
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # each token's preferred successor set
        self.bigram = rng.integers(0, v, size=(v, cfg.n_heavy))

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, L = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, L + 1), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=B, p=self.unigram)
        follow = rng.random((B, L)) < cfg.heavy_prob
        succ_idx = rng.integers(0, cfg.n_heavy, size=(B, L))
        rand_tok = rng.choice(cfg.vocab_size, size=(B, L), p=self.unigram)
        for t in range(L):
            nxt = np.where(follow[:, t],
                           self.bigram[toks[:, t], succ_idx[:, t]],
                           rand_tok[:, t])
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def tensors(self, step: int, device) -> dict:
        """Batch ``step`` as int64 tensors on ``device``."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).long().to(device)
                for k, v in self.batch(step).items()}

    def sharded_batch(self, step: int, mesh, batch_axes, device) -> dict:
        """This rank's rows of batch ``step`` over ``batch_axes`` (the JAX
        ``sharded_batch``'s block for this rank): every rank makes the same
        global batch from the seed and keeps its slice, as int64 tensors
        on ``device``."""
        from repro_torch.parallel.sharding import P, local_shard
        spec = P(tuple(batch_axes) or None, None)
        return {k: torch.from_numpy(np.ascontiguousarray(
                    local_shard(v, spec, mesh))).long().to(device)
                for k, v in self.batch(step).items()}
