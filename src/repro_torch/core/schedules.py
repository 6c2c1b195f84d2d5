"""The Parm MP+EP+ESP communication schedules, as declarative plans
(counterpart of ``repro/core/schedules.py``).

Each schedule is a plan builder (see ``repro_torch.core.plan``) returning a
stage graph that ``repro_torch.core.executor`` lowers; the builders are the
JAX package's, line for line.  All schedules compute the same function;
they differ only in where communication happens and how much of it there
is:

  baseline (Fig. 3a):  ESP-AllGather -> Gate -> EP-AlltoAll -> Experts
                       -> ESP-AllReduce -> EP-AlltoAll -> ESP-Split
  S1       (Fig. 3b):  MP-Split -> Gate -> EP&ESP-AlltoAll -> Experts
                       -> EP&ESP-AlltoAll(+Combine) -> MP-AllGather(BLM)
  S2       (Fig. 3c):  Gate -> MP-Split -> EP&ESP-AlltoAll -> Experts
                       -> SAA{EP&ESP-AlltoAll + MP-AllGather(ETM)}
                       -> Un-dispatch
  S2H      S2 with each fused AlltoAll as an intra-group and an
           inter-group hop, alternating per capacity chunk
  S1D      (decode-dedicated): S1 without PauseMP
  S1G      S1 with the dropless grouped FFN (``plan.fuse_grouped``)

plus ``s1_seqpar`` (S1 under a sequence-parallel activation contract).
The collectives run over this rank's process groups in the mesh
``apply_moe`` binds; on one rank every collective is the identity plus the
wire codec, so every schedule computes gate -> dispatch -> (wire) ->
expert FFN -> (wire) -> combine, and ``s1g`` runs the fused grouped op
instead.  The chunk-pipelined ``*_pipe`` family is generated by
``plan.split_capacity`` (``repro_torch.core.pipeline``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.collectives import CommConfig
from repro_torch.core.executor import execute
from repro_torch.core.gating import GateConfig
from repro_torch.core.plan import (Plan, build_plan, fuse_grouped,
                                   register_plan, stage)
from repro_torch.kernels.registry import KernelConfig

SCHEDULES = ("baseline", "s1", "s2", "s1_seqpar", "s2h", "s1d", "s1g",
             "baseline_pipe", "s1_pipe", "s2_pipe", "s1_seqpar_pipe",
             "s2h_pipe", "s1g_pipe", "auto")


@dataclass(frozen=True)
class MoEShardInfo:
    """Static description of the MoE parallel layout (the JAX package's
    shard_map-side record).  The axis names resolve to process groups in
    the mesh ``apply_moe`` binds (``collectives.bound``)."""
    ep_axes: tuple
    esp_axes: tuple
    mp_axes: tuple
    n_ep: int
    n_esp: int
    n_mp: int
    tokens: int          # S: tokens per rank at the MoE boundary
    cap: int             # T: per-expert capacity for an S-token pool
    gate: GateConfig
    act: str = "silu"    # expert activation (kernel op static)
    glu: bool = True     # SwiGLU experts (w1 gate + w3 up) vs 2-layer
    saa_chunks: int = 4  # SAA pipeline depth (1 = no overlap, AAS)
    pipeline_chunks: int = 1  # micro-chunk count for the *_pipe bodies
    kernel: KernelConfig = KernelConfig()
    comm: CommConfig = CommConfig()  # wire dtype for the collectives
    placement: object = None  # ExpertPlacement (build_plan applies it)

    @property
    def combined_group(self):
        return self.n_ep * self.n_esp


# --- plan builders -----------------------------------------------------------

@register_plan("baseline", analytic=False)   # measured-only: §IV-B
def plan_baseline(info) -> Plan:
    """DeepSpeed-MoE's schedule. In the merged (MP==ESP) production mapping
    the ESP-AllGather materializes N_MP identical token copies, and every
    expert shard then computes them all — the redundancy Parm removes.
    The pre-gate AllGather and the in-network AllReduce are wire-exempt
    (routing bit-invariance / no decode point)."""
    return Plan("baseline", base="baseline", stages=(
        stage("ag_in", "ag_mp", deps=("x",), axes=("esp",), axis=0,
              size="blm*esp"),
        stage("gate", "gate", deps=("ag_in",), cap="esp_pool"),
        stage("disp", "dispatch", deps=("ag_in", "gate")),
        stage("a2a_d", "dispatch_a2a", deps=("disp",), axes=("ep",),
              wire=True, size="etm*esp", chunk=True),
        stage("ffn", "expert_ffn", deps=("a2a_d",), chunk=True),
        stage("ar", "allreduce", deps=("ffn",), axes=("esp",),
              size="etm*esp", chunk=True),
        stage("a2a_c", "combine_a2a", deps=("ar",), axes=("ep",),
              wire=True, size="etm*esp", chunk=True),
        stage("comb", "combine", deps=("a2a_c", "gate")),
        stage("out", "rs_mp", deps=("comb",), axes=("esp",), axis=0),
    ), output="out", chunk_input="disp", chunk_output="a2a_c",
        chunk_axis=1, chunk_size=info.cap * info.n_esp)


def _plan_s1(info, *, seqpar: bool) -> Plan:
    name = "s1_seqpar" if seqpar else "s1"
    src = "x" if seqpar else "split"
    pre = () if seqpar else (
        stage("split", "mp_split", deps=("x",), axes=("mp",), axis=0),)
    post = () if seqpar else (
        stage("ag_out", "ag_mp", deps=("comb",), axes=("mp",), axis=0,
              wire=True, size="blm"),)
    return Plan(name, base=name, stages=pre + (
        stage("gate", "gate", deps=(src,),
              cap="pool" if seqpar else "mp_shard"),
        stage("disp", "dispatch", deps=(src, "gate")),
        stage("a2a_d", "dispatch_a2a", deps=("disp",), axes=("ep", "esp"),
              wire=True, size="etm*esp/mp", chunk=True, fused=True),
        stage("ffn", "expert_ffn", deps=("a2a_d",), chunk=True),
        stage("a2a_c", "combine_a2a", deps=("ffn",), axes=("ep", "esp"),
              wire=True, size="etm*esp/mp", chunk=True, fused=True),
        stage("comb", "combine", deps=("a2a_c", "gate")),
    ) + post, output="comb" if seqpar else "ag_out",
        chunk_input="disp", chunk_output="a2a_c", chunk_axis=1,
        chunk_size=info.cap if seqpar else info.cap // max(info.n_mp, 1))


@register_plan("s1")
def plan_s1(info) -> Plan:
    """PauseMP before the gate; restore with MP-AllGather(BLM) after the
    combine.  Both AlltoAlls are fused over the combined EP x ESP group."""
    return _plan_s1(info, seqpar=False)


@register_plan("s1_seqpar", analytic=False, measured=False)  # forced-only
def plan_s1_seqpar(info) -> Plan:
    """S1 under a sequence-parallel activation contract: the boundary is
    already MP-split, so the entry split and exit gather vanish."""
    return _plan_s1(info, seqpar=True)


@register_plan("s1g")
def plan_s1g(info) -> Plan:
    """S1 with the dropless ragged grouped-GEMM megakernel: the same
    stage graph as ``s1``, transformed by ``plan.fuse_grouped`` — the
    expert FFN becomes an ``expert_ffn_grouped`` stage whose compute is
    proportional to *routed* tokens (capacity padding tiles never reach
    the FMA units), with the dispatch gather / combine scatter and the wire
    codec of the adjacent AlltoAlls fused into the kernel boundaries.
    On a single-member combined group with ``n_mp == 1`` the whole
    dispatch -> A2A -> FFN -> A2A -> combine chain collapses into one
    fused megakernel stage.  ``base="s1"`` keeps the cost model's
    compute term shared; ``t_plan`` adds the ragged occupancy factor."""
    local = info.combined_group == 1 and info.n_mp == 1
    p = fuse_grouped(_plan_s1(info, seqpar=False), local=local)
    return dataclasses.replace(p, name="s1g", base="s1")


def _plan_s2_like(info, name: str, a2a_extra: dict,
                  combine_extra: dict) -> Plan:
    return Plan(name, base=name, stages=(
        stage("gate", "gate", deps=("x",), cap="pool"),
        stage("disp", "dispatch", deps=("x", "gate")),
        stage("split", "mp_split", deps=("disp",), axes=("mp",), axis=1),
        stage("a2a_d", "dispatch_a2a", deps=("split",),
              axes=("ep", "esp"), wire=True, size="etm*esp/mp",
              chunk=True, fused=True, **a2a_extra),
        stage("ffn", "expert_ffn", deps=("a2a_d",), chunk=True),
        stage("a2a_c", "combine_a2a", deps=("ffn",),
              axes=("ep", "esp", "mp"), wire=True, size="etm*esp/mp",
              chunk=True, fused=True, **combine_extra),
        stage("comb", "combine", deps=("a2a_c", "gate")),
    ), output="comb", chunk_input="split", chunk_output="a2a_c",
        chunk_axis=1, chunk_size=info.cap // max(info.n_mp, 1),
        merge="stack_mp")


@register_plan("s2")
def plan_s2(info) -> Plan:
    """Gate on the full input, PauseMP on the capacity dim, and overlap
    the combine EP&ESP-AlltoAll with the MP-AllGather(ETM) via SAA.
    Under ``split_capacity`` the SAA stage collapses to depth 1 per
    chunk — the chunk itself becomes the SAA unit (the legacy
    ``s2_pipe`` decomposition)."""
    return _plan_s2_like(info, "s2", {},
                         {"saa": True, "saa_chunks": info.saa_chunks})


@register_plan("s2h")
def plan_s2h(info) -> Plan:
    """Hierarchical S2: each fused EP&ESP-AlltoAll decomposes into an
    intra-group hop over ESP (fast, intra-node links) and an inter-group
    hop over EP (slow, inter-node links) — bitwise the same data
    movement as the fused collective.  ``alt`` makes ``split_capacity``
    alternate the hop order per capacity chunk, so chunk i's intra-node
    A2A overlaps chunk i+1's inter-node A2A (MegaScale-MoE's
    bidirectional hierarchical AlltoAll; run with ``pipeline_chunks >= 2``
    to engage the overlap).  Expressible only in the IR: no legacy body
    ever carried an intra/inter decomposition."""
    hier = {"hier": "esp_first", "alt": ("esp_first", "ep_first")}
    return _plan_s2_like(info, "s2h", dict(hier),
                         dict(hier, stack_ag=True))


@register_plan("s1d", decode_only=True)
def plan_s1d(info) -> Plan:
    """Decode-dedicated schedule (serving engine): S1 with PauseMP *not*
    engaged.  A decode pool is a handful of tokens, so every MP rank
    gates the full (replicated) pool, dispatches the full capacity
    buffer through one fused EP&ESP-AlltoAll, and redundantly computes
    the expert FFN — no entry split, no exit MP-AllGather.  At training
    sizes the ``n_mp``x comm/compute blow-up makes this strictly worse
    than S1/S2 (hence ``decode_only``); at decode sizes every collective
    is alpha-dominated and dropping the AllGather wins outright — the
    regime-dependent-schedule point of the paper, cashed in for serving.
    No stage touches the MP axes, so MP ranks stay bitwise replicated;
    with ``n_mp == 1`` the graph is exactly S1's.  No chunk region:
    decode pools are too small for capacity pipelining to pay for its
    per-chunk startup (``split_capacity`` is a no-op on this plan)."""
    return Plan("s1d", base="s1d", stages=(
        stage("gate", "gate", deps=("x",), cap="pool"),
        stage("disp", "dispatch", deps=("x", "gate")),
        stage("a2a_d", "dispatch_a2a", deps=("disp",), axes=("ep", "esp"),
              wire=True, size="etm*esp", fused=True),
        stage("ffn", "expert_ffn", deps=("a2a_d",)),
        stage("a2a_c", "combine_a2a", deps=("ffn",), axes=("ep", "esp"),
              wire=True, size="etm*esp", fused=True),
        stage("comb", "combine", deps=("a2a_c", "gate")),
    ), output="comb")


# --- thin body aliases (the public schedule API) -----------------------------
# External callers keep seeing the classic ``*_body(x, wg, w1, w3, w2,
# info)`` functions and the BODY registry; each is now a plan build +
# execute.  The unchunked aliases pin n_chunks=1 (the pipelined family in
# ``repro_torch.core.pipeline`` reads ``info.pipeline_chunks``), matching the
# legacy bodies they replaced.

def _plan_body(name, n_chunks):
    def body(x, wg, w1, w3, w2, info: MoEShardInfo):
        return execute(build_plan(name, info, n_chunks=n_chunks),
                       x, wg, w1, w3, w2, info)
    body.__name__ = f"{name}_body"
    body.__qualname__ = body.__name__
    body.__doc__ = (f"Plan-built ``{name}`` schedule body "
                    f"(see ``plan_{name}``).")
    return body


baseline_body = _plan_body("baseline", 1)
s1_body = _plan_body("s1", 1)
s2_body = _plan_body("s2", 1)
s1_seqpar_body = _plan_body("s1_seqpar", 1)
s2h_body = _plan_body("s2h", 1)
s1d_body = _plan_body("s1d", 1)
s1g_body = _plan_body("s1g", 1)

BODY = {
    "baseline": baseline_body,
    "s1": s1_body,
    "s2": s2_body,
    "s1_seqpar": s1_seqpar_body,
    "s2h": s2h_body,
    "s1d": s1d_body,
    "s1g": s1g_body,
}

# Register the chunk-pipelined variants (*_pipe) into BODY.  The import
# sits at the bottom to break the schedules <-> pipeline cycle: pipeline
# needs MoEShardInfo from this module.
from repro_torch.core import pipeline as _pipeline  # noqa: E402,F401
