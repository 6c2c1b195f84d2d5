"""Load-adaptive expert placement: replicate hot experts across EP ranks
(a copy of ``repro/core/placement.py``, numpy only).

Parm's schedules assume uniform expert load, but real traffic is skewed:
one hot expert overflows its capacity slots (drops, or an inflated
capacity factor padding every cold expert too) while cold EP ranks idle.
The plan IR answers it as a graph transform (``plan.apply_placement``)
instead of a rewrite.

An :class:`ExpertPlacement` maps *physical* expert slots to *logical*
experts.  A logical expert may own several physical slots ("replicas")
living on different EP ranks; the gate splits its traffic across the
replicas round-robin by capacity slot (replica-fractional dispatch), and
the combine gathers each token from the one replica that computed it —
replica outputs never need a cross-replica reduction because every
(token, choice) is routed to exactly one physical slot.  Weight
gradients *are* summed across replicas, by the backward of the placed
weights' exchange in ``apply_moe`` (``core/moe.py``), which sends every
replica's gradient home to the rank that holds the logical expert.

Because replication spreads a hot expert over r ranks, per-slot demand
drops by r and the per-slot capacity can shrink (``cap_frac``): the
dispatch/combine A2A payloads and the pooled FFN all scale with
``n_phys * cap_frac / n_experts`` instead of the inflated uniform
capacity factor a hot expert would otherwise force.

Everything here is static python/numpy: a placement is a host-side
constant; only the tiny per-expert lookup tables reach the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


@dataclass(frozen=True)
class ExpertPlacement:
    """An expert -> physical-slot map with optional replication.

    ``assignments[p]`` is the logical expert living in physical slot
    ``p``; with ``R = len(assignments)`` slots and ``n_ep`` EP ranks,
    slot ``p`` lives on rank ``p // (R / n_ep)`` — the same EP-major
    layout ``dump_em``/the dispatch A2A already use for experts, so the
    executor's collectives work on placed buffers unchanged.

    ``cap_frac`` scales the per-physical-slot capacity relative to the
    uniform per-expert capacity (replication lets it shrink);
    ``epoch`` is the rebalance generation stamped into autosched
    decision-cache lines.
    """

    n_experts: int
    n_ep: int
    assignments: tuple
    cap_frac: float = 1.0
    epoch: int = 0

    def __post_init__(self):
        R, E = len(self.assignments), self.n_experts
        if R % self.n_ep:
            raise ValueError(
                f"placement: {R} physical slots not divisible by "
                f"n_ep={self.n_ep}")
        seen = set(self.assignments)
        if seen != set(range(E)):
            missing = sorted(set(range(E)) - seen)
            raise ValueError(
                f"placement: logical experts {missing} have no replica "
                f"(assignments must cover 0..{E - 1})")
        if not (0.0 < self.cap_frac <= 1.0):
            raise ValueError(
                f"placement: cap_frac {self.cap_frac} outside (0, 1]")

    # -- derived tables (python/numpy; host-side constants) -----------

    @property
    def n_phys(self) -> int:
        """Number of physical expert slots (R >= n_experts)."""
        return len(self.assignments)

    @property
    def is_identity(self) -> bool:
        """True iff this is the uniform no-op placement."""
        return (self.cap_frac == 1.0
                and self.assignments == tuple(range(self.n_experts)))

    @property
    def rep_count(self) -> np.ndarray:
        """(E,) int32 — replica count per logical expert."""
        return np.bincount(np.asarray(self.assignments),
                           minlength=self.n_experts).astype(np.int32)

    @property
    def rep_table(self) -> np.ndarray:
        """(E, max_r) int32 — physical slot ids per logical expert,
        padded with the first replica (padding is never indexed: the
        round-robin replica index is always ``slot % rep_count``)."""
        rc = self.rep_count
        table = np.zeros((self.n_experts, int(rc.max())), np.int32)
        fill = np.zeros(self.n_experts, np.int64)
        for p, e in enumerate(self.assignments):
            table[e, fill[e]] = p
            fill[e] += 1
        for e in range(self.n_experts):            # pad with replica 0
            table[e, fill[e]:] = table[e, 0]
        return table

    @property
    def replica_index(self) -> np.ndarray:
        """(R,) int32 — each physical slot's index among its logical
        expert's replicas (the round-robin phase it serves)."""
        out = np.zeros(self.n_phys, np.int32)
        fill: dict = {}
        for p, e in enumerate(self.assignments):
            out[p] = fill.get(e, 0)
            fill[e] = out[p] + 1
        return out

    def scaled_cap(self, cap: int, align: int = 8) -> int:
        """Per-physical-slot capacity from the uniform per-expert
        capacity ``cap``, shrunk by ``cap_frac`` and aligned up."""
        c = max(1, int(math.ceil(cap * self.cap_frac)))
        return max(align, -(-c // align) * align)

    def pool_scale(self, cap: int, align: int = 8) -> float:
        """Placed capacity-pool size relative to the uniform pool
        (prices FFN flops and etm-sized A2A payloads in ``t_plan``)."""
        if cap <= 0:
            return self.n_phys * self.cap_frac / max(1, self.n_experts)
        return (self.n_phys * self.scaled_cap(cap, align)
                / float(self.n_experts * cap))

    def rank_loads(self, loads: Sequence[float]) -> np.ndarray:
        """(n_ep,) expected load fraction per EP rank under this
        placement: each replica serves ``load_e / rep_count_e``."""
        w = np.asarray(loads, np.float64)
        tot = float(w.sum())
        w = w / tot if tot > 0 else np.full(len(w), 1.0 / max(1, len(w)))
        per_slot = w[np.asarray(self.assignments)] / \
            self.rep_count[np.asarray(self.assignments)]
        return per_slot.reshape(self.n_ep, -1).sum(axis=1)

    def imbalance(self, loads: Sequence[float]) -> float:
        """max-rank load / mean-rank load (1.0 = perfectly balanced);
        the factor by which the most-loaded rank paces every
        load-bound stage."""
        r = self.rank_loads(loads)
        m = float(r.mean())
        return float(r.max()) / m if m > 0 else 1.0

    def summary(self) -> dict:
        """JSON-ready description (dryrun/serve artifacts, logs)."""
        rc = self.rep_count
        return {"n_experts": self.n_experts, "n_ep": self.n_ep,
                "n_phys": self.n_phys, "cap_frac": round(self.cap_frac, 4),
                "epoch": self.epoch,
                "replicated": {int(e): int(r) for e, r in enumerate(rc)
                               if r > 1},
                "assignments": [int(a) for a in self.assignments]}


def identity_placement(n_experts: int, n_ep: int) -> ExpertPlacement:
    """The uniform placement: expert e in slot e, full capacity."""
    return ExpertPlacement(n_experts=n_experts, n_ep=n_ep,
                           assignments=tuple(range(n_experts)))


def placement_from_loads(loads: Sequence[float], n_ep: int, *,
                         n_experts: Optional[int] = None,
                         capacity_factor: float = 1.0,
                         top_k: int = 1,
                         max_replicas: Optional[int] = None,
                         hot_threshold: float = 1.5,
                         slack: float = 1.25,
                         min_cap_frac: float = 0.05,
                         epoch: int = 0) -> ExpertPlacement:
    """Build a replication placement from a (possibly EMA'd) per-expert
    load vector.

    Experts whose load share exceeds ``hot_threshold`` x uniform get
    replicas roughly proportional to their share (capped at
    ``max_replicas``, default ``n_ep``); replica slots are packed onto
    EP ranks greedily by per-replica load (LPT), spreading replicas of
    the same expert across distinct ranks.  ``cap_frac`` is then sized
    so the hottest per-replica demand fits with ``slack`` headroom:
    ``cap_frac = slack * E * max_e(w_e / r_e) / (capacity_factor)``.

    Degenerate inputs (all-zero loads, ``n_ep == 1``) return the
    identity placement.
    """
    w = np.asarray(loads, np.float64)
    E = int(n_experts if n_experts is not None else len(w))
    if len(w) != E:
        raise ValueError(f"loads length {len(w)} != n_experts {E}")
    tot = float(w.sum())
    if n_ep <= 1 or tot <= 0 or E < n_ep:
        # identity slots = E, which must divide into n_ep ranks; when it
        # can't (E < n_ep), report the EP-free identity instead
        return identity_placement(
            E, n_ep if n_ep >= 1 and E % n_ep == 0 else 1)
    w = w / tot
    rmax = int(max_replicas) if max_replicas else n_ep
    # replicas ~ load share in units of the uniform share 1/E
    share = w * E
    reps = np.ones(E, np.int64)
    hot = share >= hot_threshold
    reps[hot] = np.clip(np.rint(share[hot]).astype(np.int64), 2, rmax)
    # pad R up to a multiple of n_ep by replicating whichever expert has
    # the highest remaining per-replica load (also improves balance)
    R = int(reps.sum())
    R_target = -(-R // n_ep) * n_ep
    while R < R_target:
        per = np.where(reps < rmax, w / reps, -1.0)
        e = int(per.argmax())
        if per[e] <= 0:                      # everything at rmax: pad coldest
            e = int((w / reps).argmin())
        reps[e] += 1
        R += 1
    # LPT pack replica units onto ranks (R/n_ep slots each), preferring
    # ranks that do not already hold a replica of the same expert
    slots_per_rank = R // n_ep
    units = sorted(((float(w[e] / reps[e]), e, j)
                    for e in range(E) for j in range(int(reps[e]))),
                   key=lambda u: (-u[0], u[1], u[2]))
    rank_load = np.zeros(n_ep, np.float64)
    rank_fill: list = [[] for _ in range(n_ep)]
    for load, e, _ in units:
        cands = [r for r in range(n_ep) if len(rank_fill[r]) < slots_per_rank]
        fresh = [r for r in cands if e not in rank_fill[r]]
        pool = fresh or cands
        r = min(pool, key=lambda r: (rank_load[r], r))
        rank_fill[r].append(e)
        rank_load[r] += load
    assignments = tuple(e for r in range(n_ep) for e in sorted(rank_fill[r]))
    # capacity fraction: hottest per-replica demand, relative to the
    # uniform per-expert capacity (which holds capacity_factor/E of the
    # pool's token-choices), with slack headroom
    peak = float((w / reps).max())
    cap_frac = slack * E * peak / max(capacity_factor, 1e-6)
    cap_frac = float(np.clip(cap_frac, min_cap_frac, 1.0))
    if R == E and cap_frac >= 1.0:
        # no replication and no capacity shrink: a bare permutation of
        # experts over ranks moves no work, so report uniform — this is
        # what lets maybe_rebalance fall back once loads even out
        return identity_placement(E, n_ep)
    p = ExpertPlacement(n_experts=E, n_ep=n_ep, assignments=assignments,
                        cap_frac=cap_frac, epoch=epoch)
    return identity_placement(E, n_ep) if p.is_identity else p


class LoadEMA:
    """Running exponential moving average of the per-expert load vector
    (the ``expert_load`` gate aux), collected each train step / decode
    round.  Pure numpy on the host — feeds ``placement_from_loads`` and the
    ``load_imbalance`` history scalar."""

    def __init__(self, decay: float = 0.9):
        self.decay = float(decay)
        self.steps = 0
        self._v: Optional[np.ndarray] = None

    def update(self, loads) -> None:
        v = np.asarray(loads, np.float64).reshape(-1)
        if v.size == 0 or not np.all(np.isfinite(v)):
            return
        if self._v is None or self._v.shape != v.shape:
            self._v = v.copy()
        else:
            self._v = self.decay * self._v + (1.0 - self.decay) * v
        self.steps += 1

    @property
    def ready(self) -> bool:
        return self._v is not None and self.steps > 0

    def value(self) -> np.ndarray:
        """Current EMA vector ((0,) before any update)."""
        return np.zeros((0,)) if self._v is None else self._v.copy()

    def imbalance(self) -> float:
        """max / mean of the EMA (expert-level skew; 1.0 = uniform)."""
        if self._v is None or self._v.size == 0:
            return 1.0
        m = float(self._v.mean())
        return float(self._v.max()) / m if m > 0 else 1.0
