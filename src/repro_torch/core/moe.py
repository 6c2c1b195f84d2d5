"""The MoE layer on one rank (counterpart of ``repro/core/moe.py``).

On one device the JAX package's autoscheduler picks ``s1g`` for every
serving and training shape (``tests/test_torch_moe.py`` and
``tests/test_torch_train.py`` pin that), and on a rank that is
its whole combined group ``s1g`` lowers to ``plan.fuse_grouped(local=True)``:
``topk_gate`` followed by one fused ``expert_ffn_grouped`` call.  That is
what ``apply_moe`` runs here for ``schedule`` ``"auto"`` or ``"s1g"``.  The
multi-rank schedules (baseline, s1, s2, s2h, s1d, ``*_pipe``) need NCCL
collectives and come with a later slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.gating import GateConfig, capacity, topk_gate
from repro_torch.kernels.registry import KernelConfig, get_op

#: Schedules this slice runs (one rank: gate -> fused grouped kernel).
LOCAL_SCHEDULES = ("auto", "s1g")


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                     # per-expert hidden size
    n_experts: int
    top_k: int = 1
    capacity_factor: float = 1.25
    n_shared_experts: int = 0     # llama4-style shared expert(s)
    glu: bool = True              # SwiGLU experts
    normalize_topk: bool = False
    aux_loss_weight: float = 1e-2
    z_loss_weight: float = 1e-3
    schedule: str = "auto"        # "auto" | "s1g" in this slice
    act: str = "silu"             # expert activation ("silu" | "gelu")
    kernel: KernelConfig = KernelConfig()
    # the JAX package's ``comm.wire_dtype``: "f32" or "bf16" round trip at
    # the fused kernel's pool boundaries (fp8 and "auto" come with the
    # collectives slice)
    wire: str = "f32"

    def gate_config(self) -> GateConfig:
        return GateConfig(
            n_experts=self.n_experts, top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            normalize_topk=self.normalize_topk,
            aux_loss_weight=self.aux_loss_weight,
            z_loss_weight=self.z_loss_weight)


def init_moe_params(generator, cfg: MoEConfig, dtype=torch.float32) -> dict:
    """Parameters in the JAX package's layout: wg (M, E) f32, w1/w3
    (E, M, F), w2 (E, F, M), shared_* for shared experts; made on
    ``generator``'s device from its stream."""
    M, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = generator.device

    def normal(shape, scale, dt=dtype):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return t.mul_(scale).to(dt)

    scale_in, scale_out = 1.0 / math.sqrt(M), 1.0 / math.sqrt(F)
    p = {"wg": normal((M, E), scale_in, torch.float32),
         "w1": normal((E, M, F), scale_in),
         "w2": normal((E, F, M), scale_out)}
    if cfg.glu:
        p["w3"] = normal((E, M, F), scale_in)
    if cfg.n_shared_experts:
        Fs = F * cfg.n_shared_experts
        p["shared_w1"] = normal((M, Fs), scale_in)
        p["shared_w3"] = normal((M, Fs), scale_in)
        p["shared_w2"] = normal((Fs, M), 1.0 / math.sqrt(Fs))
    return p


def shard_pool_capacity(tokens_global: int, n_token_shard: int, n_mp: int,
                        gate_cfg: GateConfig, infer: bool = False):
    """(s_local, cap) for one device's token pool — the JAX package's
    capacity formula, verbatim.  ``infer=True`` (decode pools) raises cap
    to cover the whole pool, so no token is dropped and a row's output is
    independent of its batch mates."""
    s_local = tokens_global // max(n_token_shard, 1)
    align = max(8, n_mp)
    cap = max(align, -(-capacity(max(s_local, 1), gate_cfg)
                       // align) * align)
    if infer:
        cap = max(cap, -(-max(s_local, 1) // align) * align)
    return s_local, cap


def apply_moe(x, params: dict, *, cfg: MoEConfig, schedule=None,
              infer: bool = False):
    """One MoE layer on one rank.  x: (B, L, M).  Returns ``(y, aux)``
    with aux ``aux_loss``, ``z_loss``, ``drop_frac`` and ``expert_load``
    (the (E,) routed rows), as the JAX ``apply_moe`` returns them.

    ``infer=True`` marks a decode pool (drop-free capacity); prefill
    pools (``infer=False``) take the training capacity, so padding rows of
    a prefill bucket compete for slots exactly as in the JAX engine.
    """
    sched = schedule or cfg.schedule
    if sched not in LOCAL_SCHEDULES:
        raise NotImplementedError(
            f"schedule {sched!r} runs across ranks and comes with the "
            f"multi-rank slice of the port; this slice runs "
            f"{LOCAL_SCHEDULES} on one rank (gate -> expert_ffn_grouped)")
    B, L, M = x.shape
    E = cfg.n_experts
    gate_cfg = cfg.gate_config()
    _, cap = shard_pool_capacity(B * L, 1, 1, gate_cfg, infer=infer)
    xt = x.reshape(B * L, M)
    g = topk_gate(xt, params["wg"], gate_cfg, cap)
    op = get_op("expert_ffn_grouped", cfg=cfg.kernel, act=cfg.act, cap=cap,
                wire=cfg.wire)
    y = op(xt, g.flat(cap, E), g.weights, params["w1"],
           params.get("w3") if cfg.glu else None, params["w2"])
    y = y.reshape(B, L, M).to(x.dtype)
    if cfg.n_shared_experts:
        h = torch.einsum("blm,mf->blf", x, params["shared_w1"])
        h = torch.nn.functional.silu(h) * torch.einsum(
            "blm,mf->blf", x, params["shared_w3"])
        y = y + torch.einsum("blf,fm->blm", h, params["shared_w2"])
    aux = {k: g.aux[k] for k in ("aux_loss", "z_loss", "drop_frac")}
    aux["expert_load"] = g.aux["routed"]
    return y, aux
