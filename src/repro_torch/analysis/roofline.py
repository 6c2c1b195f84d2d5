"""Roofline terms of a dry-run record (counterpart of
``repro/analysis/roofline.py``), priced at an NVIDIA H100 SXM's
data-sheet figures (``core/perfmodel.py``).  None of them is a
measurement, and neither is any time computed here: each is the least
time the figure allows.

  compute    = FLOPs / (chips * peak FLOP/s of the step's dtype)
  memory     = bytes / (chips * HBM bandwidth)
  collective = collective bytes a rank receives / link bandwidth

The FLOPs and bytes are whole-program (one rank's, from
``analysis.layerwise``, times the chips); the collective bytes are one
rank's already.  The link is NVLink for a group inside one node of
:data:`CARDS_PER_NODE` cards and InfiniBand for one that spans nodes,
ranks filling nodes in the mesh's rank order (:func:`link_bw`); a step
whose collectives use both links is priced group by group
(``effective_link_bw``).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.perfmodel import (HBM_BW, IB_BW, NVLINK_BW,
                                        PEAK_FLOPS_F32)

#: dense bf16 tensor-core peak of an H100 SXM (data sheet, no sparsity)
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS = {"float32": PEAK_FLOPS_F32, "bfloat16": PEAK_FLOPS_BF16}
#: cards of one NVLink node (an HGX H100 board)
CARDS_PER_NODE = 8


@dataclass
class RooflineTerms:
    flops: float               # whole-program FLOPs
    hbm_bytes: float           # whole-program bytes accessed
    collective_bytes: float    # per-chip collective traffic
    chips: int
    model_flops: float = 0.0   # 6*N*D (dense) or 6*N_active*D (MoE)
    peak_flops: float = PEAK_FLOPS_F32
    link_bw: float = NVLINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        # collective_bytes is per-chip already
        return self.collective_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_flops": self.flops,
            "hlo_bytes": self.hbm_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "chips": self.chips,
        }


def link_bw(mesh, axes) -> float:
    """The bandwidth of this rank's group over ``axes``: NVLink when its
    members share a node (``rank // CARDS_PER_NODE``), else InfiniBand."""
    nodes = {r // CARDS_PER_NODE for r in mesh.members(axes)}
    return NVLINK_BW if len(nodes) == 1 else IB_BW


def effective_link_bw(by_group: dict, mesh) -> float:
    """One bandwidth for bytes spread over groups (``{axes: bytes}``):
    the total over the sum of each group's time at its own link."""
    total = sum(by_group.values())
    t = sum(b / link_bw(mesh, axes) for axes, b in by_group.items())
    return total / t if t else NVLINK_BW


def roofline_terms(cost_analysis: dict, collective_bytes: float, chips: int,
                   model_flops: float = 0.0, *, dtype: str = "float32",
                   link: float = NVLINK_BW) -> RooflineTerms:
    """JAX's ``roofline_terms``: ``cost_analysis`` holds ``flops`` and
    ``bytes accessed`` (whole-program); ``dtype`` picks the peak and
    ``link`` the collective bandwidth."""
    ca = cost_analysis or {}
    return RooflineTerms(
        flops=float(ca.get("flops", 0.0)),
        hbm_bytes=float(ca.get("bytes accessed", 0.0)),
        collective_bytes=float(collective_bytes),
        chips=chips,
        model_flops=model_flops,
        peak_flops=PEAK_FLOPS[dtype],
        link_bw=link,
    )
