"""Token sampling for the serving engine (counterpart of
``repro/serve/sampler.py``): greedy / temperature / top-k behind one
batched interface with per-row parameters.

Greedy rows are the same argmax as the JAX package (first index on ties).
Sampled rows add Gumbel noise drawn from a ``torch.Generator`` seeded per
row by ``(seed, position)``, the key data the engine packs, so a request's
stream depends only on its own seed and position.  The draws differ from
``jax.random``'s; the distribution is the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: Bound for per-row top-k truncation (the JAX package's TOPK_MAX).
TOPK_MAX = 64


@dataclass(frozen=True)
class SamplerConfig:
    """Per-request sampling parameters.  ``temperature <= 0`` is greedy;
    ``top_k == 0`` samples the full softmax, ``1 <= top_k <= TOPK_MAX``
    truncates to the k largest logits first."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.top_k < 0 or self.top_k > TOPK_MAX:
            raise ValueError(f"top_k must be in [0, {TOPK_MAX}], "
                             f"got {self.top_k}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def _gumbel(key, V, device):
    g = torch.Generator(device=device)
    g.manual_seed((int(key[0]) << 32) | int(key[1]))
    u = torch.rand((V,), generator=g, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def sample(logits, keys, temperature, top_k):
    """Draw one token per row.  ``logits`` (B, V); ``keys`` (B, 2) uint32
    ``(seed, position)`` numpy array; ``temperature`` (B,) and ``top_k``
    (B,) numpy arrays.  Returns (B,) int32 token ids on logits' device."""
    lg = logits.float()
    B, V = lg.shape
    out = torch.argmax(lg, dim=-1).to(torch.int32)
    rows = [b for b in range(B) if float(temperature[b]) > 0.0]
    if not rows:
        return out
    dev = lg.device
    kmax = min(TOPK_MAX, V)
    topv = torch.topk(lg, kmax, dim=-1).values                 # (B, kmax)
    tk = torch.as_tensor(top_k, dtype=torch.long, device=dev)
    kth = topv.gather(1, torch.clamp(tk - 1, 0, kmax - 1)[:, None])
    truncated = (tk > 0)[:, None] & (lg < kth)
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    scaled = torch.where(truncated, -torch.inf,
                         lg / torch.clamp(temp, min=1e-6)[:, None])
    for b in rows:
        out[b] = torch.argmax(scaled[b] + _gumbel(keys[b], V, dev))
    return out
