"""Top-k gating with expert capacity, GShard-style, plus the scatter
dispatch / gather combine that move tokens in and out of the per-expert
capacity buffer (counterpart of ``repro/core/gating.py``).  ``dispatch``
and ``combine`` compute the flat slot indices here and run the scatter and
gather through the kernel seam (``moe_dispatch``, ``moe_combine``).

Routing must match the JAX package exactly (expert ids, slots, drop masks,
routed counts), so the two places where the frameworks differ are pinned:

  * ``lax.top_k`` breaks ties toward the lower index and ``torch.topk``
    does not: the top-k here is a *stable* descending sort;
  * the sort-based slot assignment uses ``jnp.argsort(stable=True)``: here
    ``torch.sort(stable=True)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.registry import KernelConfig, get_op


@dataclass(frozen=True)
class GateConfig:
    n_experts: int
    top_k: int = 1
    capacity_factor: float = 1.25
    normalize_topk: bool = False   # qwen3 norm_topk_prob
    aux_loss_weight: float = 1e-2
    z_loss_weight: float = 1e-3
    gate_dtype: torch.dtype = torch.float32
    # slot assignment: "sort" (stable sort, O(S*k log S*k)) or "cumsum"
    # (the GShard one-hot reference).  Identical outputs.
    impl: str = "sort"


def capacity(tokens: int, cfg: GateConfig, align: int = 8) -> int:
    """Per-expert capacity T for a pool of ``tokens`` tokens (the JAX
    package's float ceiling, verbatim)."""
    c = int(-(-cfg.top_k * cfg.capacity_factor * tokens // cfg.n_experts))
    return max(align, -(-c // align) * align)


class GateResult:
    """One token pool's routing decision; memoizes :func:`flat_slots` per
    ``(cap, n_experts)`` (and the executor's placed flat indices under
    ``("placed", cap)``)."""

    __slots__ = ("expert_idx", "slot_idx", "weights", "aux", "_flat")

    def __init__(self, expert_idx, slot_idx, weights, aux):
        self.expert_idx = expert_idx
        self.slot_idx = slot_idx
        self.weights = weights
        self.aux = aux
        self._flat = {}

    def flat(self, cap: int, n_experts: int, placed=None):
        """Cached :func:`flat_slots` for this routing decision (under
        ``("placed", cap)`` with a placement's ``placed`` tables)."""
        key = (cap, n_experts) if placed is None else ("placed", cap)
        if key not in self._flat:
            self._flat[key] = flat_slots(self.expert_idx, self.slot_idx,
                                         cap, n_experts, placed)
        return self._flat[key]


def _bincount(ids, n: int):
    """``torch.bincount(ids, minlength=n)`` for ids below ``n``.  Its
    shape follows the data, so it has no meta kernel; on the meta device
    (the dry run) the shape is known: (n,)."""
    if ids.is_meta:
        return ids.new_empty((n,))
    return torch.bincount(ids, minlength=n)


def topk_gate(x, wg, cfg: GateConfig, cap) -> GateResult:
    """Route tokens to experts.

    x: (S, M) tokens; wg: (M, E) gate weights; cap: per-expert capacity of
    this pool, a python int, or an (E,) int tensor of per-expert
    *effective* capacities (an expert replicated r times under an
    ``ExpertPlacement`` keeps ``r * placed_cap`` slots; the int path is
    bitwise unchanged).

    Returns a :class:`GateResult`: expert_idx (S, k) int32, slot_idx (S, k)
    int32 (at or past the expert's capacity means dropped), weights (S, k)
    f32 (0 for dropped) and aux (load-balance loss, z-loss, per-expert load
    and routed rows).
    """
    S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = x.device
    logits = x.to(cfg.gate_dtype) @ wg.to(cfg.gate_dtype)
    probs = torch.softmax(logits, dim=-1)                        # (S, E)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w = srt.values[:, :k]
    expert_idx = srt.indices[:, :k].to(torch.int32).contiguous()  # (S, k)
    if cfg.normalize_topk:
        gate_w = gate_w / torch.sum(gate_w, dim=-1, keepdim=True)

    # Capacity assignment with choice-major priority (all 1st choices win
    # slots before any 2nd choice), GShard semantics.
    flat_e = expert_idx.T.reshape(-1).long()                     # (k*S,)
    if cfg.impl == "sort":
        order = torch.sort(flat_e, stable=True).indices
        sorted_e = flat_e[order]
        first = torch.searchsorted(sorted_e,
                                   torch.arange(E, device=dev), side="left")
        slot_sorted = torch.arange(k * S, device=dev) - first[sorted_e]
        slot_flat = torch.empty_like(slot_sorted)
        slot_flat[order] = slot_sorted
        load = _bincount(flat_e, E).float()
    elif cfg.impl == "cumsum":
        onehot = F.one_hot(flat_e, E)                            # (k*S, E)
        pos = torch.cumsum(onehot, dim=0) - 1
        slot_flat = pos.gather(1, flat_e[:, None])[:, 0]
        load = onehot.sum(dim=0).float()
    else:
        raise ValueError(f"unknown gate impl {cfg.impl!r}")
    slot_idx = slot_flat.reshape(k, S).T.to(torch.int32).contiguous()
    if isinstance(cap, int):
        kept = slot_idx < cap
    else:                       # (E,) per-expert effective capacities
        cap_e = torch.as_tensor(cap, dtype=torch.int32, device=dev)
        kept = slot_idx < cap_e[expert_idx.long()]
    weights = torch.where(kept, gate_w,
                          torch.zeros((), device=dev)).float().contiguous()

    # Aux losses (Switch/GShard load balancing + router z-loss).
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_idx[:, 0].long(), E).float().mean(dim=0)
    aux_loss = cfg.aux_loss_weight * E * torch.sum(me * ce)
    z_loss = cfg.z_loss_weight * torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)))
    aux = {"aux_loss": aux_loss, "z_loss": z_loss, "load": load,
           "routed": (torch.clamp(load, max=float(cap))
                      if isinstance(cap, int)
                      else torch.minimum(load, cap_e.float())),
           "drop_frac": 1.0 - kept.float().mean()}
    return GateResult(expert_idx, slot_idx, weights, aux)


def flat_slots(expert_idx, slot_idx, cap: int, n_experts: int,
               placed=None):
    """Flat capacity-buffer index per (token, choice); ``n_experts * cap``
    marks a dropped choice (the kernels' drop sentinel).

    With ``placed`` (an ``ExpertPlacement``'s lookup tables on the
    tokens' device: ``n_phys``, ``rep_count`` (E,), ``rep_table`` (E,
    max_r)) the index is into the physical buffer: logical slot ``s`` of
    expert ``e`` maps round-robin to replica ``s % r_e`` at physical slot
    ``s // r_e`` (the replica-fractional dispatch split), and ``n_phys *
    cap`` is the drop sentinel (the JAX executor's ``_placed_flat``)."""
    if placed is not None:
        e = expert_idx.long()
        r = placed.rep_count[e]                                  # (S, k)
        phys = placed.rep_table[e, (slot_idx % r).long()]
        pslot = slot_idx // r
        return torch.where(pslot < cap, phys * cap + pslot,
                           placed.n_phys * cap).to(torch.int32)
    return torch.where(slot_idx < cap, expert_idx * cap + slot_idx,
                       n_experts * cap).to(torch.int32)


def dispatch(x, expert_idx, slot_idx, cap: int, n_experts: int,
             kernel: Optional[KernelConfig] = None, *, flat=None):
    """Scatter tokens into the (E, cap, M) capacity buffer; dropped
    choices (slot >= cap) are discarded.  ``flat`` reuses a precomputed
    :func:`flat_slots` (see :meth:`GateResult.flat`)."""
    M = x.shape[-1]
    if flat is None:
        flat = flat_slots(expert_idx, slot_idx, cap, n_experts)
    op = get_op("moe_dispatch", cfg=kernel, n_slots=n_experts * cap)
    return op(x.contiguous(), flat).reshape(n_experts, cap, M)


def combine(buf, expert_idx, slot_idx, weights, cap: int,
            kernel: Optional[KernelConfig] = None, *, flat=None):
    """Gather expert outputs back to token order and mix them with the
    gate weights (dropped choices contribute zero)."""
    E = buf.shape[0]
    M = buf.shape[-1]
    if flat is None:
        flat = flat_slots(expert_idx, slot_idx, cap, E)
    op = get_op("moe_combine", cfg=kernel)
    return op(buf.reshape(E * cap, M).contiguous(), flat, weights)
