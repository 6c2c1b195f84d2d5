"""The alpha-beta collective performance model and Algorithm 1 (paper §V)
(a copy of ``repro/core/perfmodel.py``, with the card's model in place of
the reference's fabric model).

Every collective is modelled as ``t = alpha + beta * x`` (startup plus
per-element time), with ``(alpha, beta)`` either fitted by least squares
from measured latencies (paper §VI-B / Fig. 6, :func:`fit_alpha_beta`) or
derived analytically from fabric constants (:func:`h100_model`).

The closed forms reproduce the paper's Eq. (1), (13), (14); the schedule
selector :meth:`PerfModel.algorithm1` reproduces Algorithm 1
line-by-line; and :meth:`PerfModel.t_pipelined` extends the model to the
chunk-pipelined bodies of ``repro_torch.core.pipeline`` (fill/drain
pipeline over per-chunk communication and expert-FFN compute).  The
``schedule="auto"`` runtime (``repro_torch.core.autosched``) consults
these methods — or a live measurement — per MoE layer shape.  Every
method keeps the reference's arithmetic in the reference's order, so a
model built from the same fields returns the same floats
(``tests/test_torch_perfmodel.py`` compares them with ``==``).

Run the examples with
``python -m doctest src/repro_torch/core/perfmodel.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

# --- fabric constants (analytic H100 SXM model) ------------------------------
# Bandwidths and the f32 rate from NVIDIA's H100 SXM data sheet; the
# per-collective startup from a measurement on the card.

NVLINK_BW = 450e9         # bytes/s a direction per GPU (NVLink 4: 900 GB/s
#                           both directions), within a node
IB_BW = 50e9              # bytes/s per GPU across nodes (NDR InfiniBand,
#                           400 Gb/s)
HBM_BW = 3.35e12          # bytes/s (HBM3)
PEAK_FLOPS_F32 = 67e12    # f32 outside the tensor cores: the port's expert
#                           kernels run in f32
#: per-collective startup, seconds: the intercept of the one-rank wire
#: stage's time against its size (``collectives.wire_roundtrip`` on the
#: bf16 wire, 2^12..2^20 elements), 9.454 us with R^2 0.991, fitted by
#: ``python -m repro_torch.launch.fit_perfmodel`` (``chip_smoke.py``
#: phase 11 (a)) on an NVIDIA H100 80GB HBM3 at a 700 W power limit
ALPHA_COLL = 9.454e-6

# --- wire formats (repro_torch.core.collectives.CommConfig) ------------------
# Bytes per element each wire dtype puts on the fabric.  The schedules can
# compress the payload of every *bit-moving* collective (AlltoAlls,
# output AllGathers) to one of these; the per-chunk fp8 scale piggyback
# adds 4 bytes per M-row, negligible for production M and ignored here.

WIRE_DTYPES = ("f32", "bf16", "fp8_e4m3")
WIRE_BYTES = {"f32": 4.0, "bf16": 2.0, "fp8_e4m3": 1.0}

#: Schedules whose expert FFN is NOT MP-split: every MP rank computes the
#: full expert batch (the baseline's redundancy — and, deliberately, the
#: decode-dedicated ``s1d``, where the pool is tiny and the redundant
#: compute is cheaper than the extra collective).
REDUNDANT_COMPUTE = ("baseline", "s1d")


@dataclass(frozen=True)
class AlphaBeta:
    """One collective's latency model: ``t(x) = alpha + beta * x``.

    ``alpha`` is the startup cost in seconds, ``beta`` the marginal
    seconds per element.  Calling the instance evaluates it:

    >>> AlphaBeta(alpha=1.0, beta=0.5)(4)
    3.0
    >>> AlphaBeta(alpha=1.0, beta=0.5)(-8)   # sizes clamp at zero
    1.0
    """

    alpha: float  # startup seconds
    beta: float   # seconds per element

    def __call__(self, n_elements: float) -> float:
        """Predicted seconds for a collective over ``n_elements``."""
        return self.alpha + self.beta * max(n_elements, 0.0)


@dataclass(frozen=True)
class MoELayerShape:
    """One MoE layer's shape in the notation of the paper's Table I.

    All quantities are *per rank*: ``B`` samples of ``L`` tokens with
    embedding size ``M``, ``E`` total experts of hidden size ``H``,
    top-``k`` routing with capacity factor ``f``, on an
    ``n_mp`` x ``n_esp`` x ``n_ep`` parallel layout.

    >>> s = MoELayerShape(B=4, L=256, M=8, H=32, E=8, k=2, f=1.0)
    >>> s.T          # per-expert capacity: k * f * B * L / E
    256.0
    >>> s.blm        # tokens x embedding elements per rank
    8192
    >>> s.etm == s.E * s.T * s.M
    True
    """

    B: int           # samples per rank
    L: int           # tokens per sample
    M: int           # embedding size
    H: int           # expert hidden size
    E: int           # total experts
    k: int = 1
    f: float = 1.2
    n_mp: int = 1
    n_esp: int = 1
    n_ep: int = 1
    # Shape *class*, not a size: True for decode-time (inference) pools.
    # It is part of the autosched cache key, so a decode decision can
    # never evict a training/prefill decision for a coinciding size, and
    # it widens the schedule grid to the decode-dedicated plans (s1d).
    infer: bool = False

    @property
    def T(self) -> float:
        """Per-expert capacity ``k * f * B * L / E`` (Table I)."""
        return self.k * self.f * self.B * self.L / self.E

    @property
    def blm(self) -> float:
        """``B * L * M``: input-activation elements per rank."""
        return self.B * self.L * self.M

    @property
    def etm(self) -> float:
        """``E * T * M``: dispatch-buffer elements per rank."""
        return self.E * self.T * self.M


@dataclass(frozen=True)
class PerfModel:
    """Alpha-beta models for every collective the schedules issue.

    The six fields cover the baseline's collectives (plain EP-AlltoAll,
    ESP-AllGather/AllReduce), the fused EP&ESP-AlltoAll of S1/S2, the
    MP-AllGather, and the SAA overlapped phase of S2.  ``flops_per_s``
    adds a coarse compute term so the pipelined variants (which overlap
    communication with the expert FFN) can be scored too.
    """

    a2a_ep_esp: AlphaBeta        # fused EP&ESP-AlltoAll
    a2a_ep: AlphaBeta            # plain EP-AlltoAll (baseline)
    ag_esp: AlphaBeta            # ESP-AllGather (baseline)
    ar_esp: AlphaBeta            # ESP-AllReduce (baseline)
    ag_mp: AlphaBeta             # MP-AllGather
    overlap: AlphaBeta           # overlapped EP&ESP-A2A + MP-AG (SAA phase)
    flops_per_s: float = PEAK_FLOPS_F32  # per-card dense compute rate
    wire_bytes_ref: float = 2.0  # bytes/element the betas were fitted at
    # hierarchical (s2h) A2A hops; None falls back to the fused model so
    # pre-existing PerfModel constructions keep scoring every schedule
    a2a_intra: "AlphaBeta | None" = None  # intra-group hop (ESP links)
    a2a_inter: "AlphaBeta | None" = None  # inter-group hop (EP links)

    @property
    def hier_intra(self) -> AlphaBeta:
        return self.a2a_intra or self.a2a_ep_esp

    @property
    def hier_inter(self) -> AlphaBeta:
        return self.a2a_inter or self.a2a_ep_esp

    # --- wire-precision extension ------------------------------------------
    def wire_factor(self, wire_dtype=None) -> float:
        """Element-count multiplier for a wire dtype.

        The betas are seconds per element *at* ``wire_bytes_ref`` bytes;
        shipping a collective at a different width scales only the
        bandwidth term (``alpha`` is payload-independent), which the
        closed forms below apply by scaling the element count:

        >>> ab = AlphaBeta(0.0, 1.0)
        >>> m = PerfModel(ab, ab, ab, ab, ab, ab, wire_bytes_ref=2.0)
        >>> m.wire_factor("bf16"), m.wire_factor("f32"), m.wire_factor()
        (1.0, 2.0, 1.0)
        """
        if wire_dtype is None:
            return 1.0
        return WIRE_BYTES[wire_dtype] / self.wire_bytes_ref

    # --- closed forms ------------------------------------------------------
    def t_baseline(self, s: MoELayerShape, wire_dtype=None) -> float:
        """Eq. (1): ESP-AllGather + ESP-AllReduce + 2 EP-AlltoAlls.

        Only the AlltoAlls compress: the ESP-AllGather precedes the gate
        (wire-rounding it would change routing) and the AllReduce does
        its arithmetic in-network at compute width.
        """
        wf = self.wire_factor(wire_dtype)
        return (self.ag_esp(s.blm * s.n_esp)
                + self.ar_esp(s.etm * s.n_esp)
                + 2 * self.a2a_ep(s.etm * s.n_esp * wf))

    def t_s1(self, s: MoELayerShape, wire_dtype=None) -> float:
        """Eq. (11)/(13): two fused AlltoAlls + MP-AllGather(BLM).
        All three move post-gate payload, so all three compress."""
        wf = self.wire_factor(wire_dtype)
        return (2 * self.a2a_ep_esp(s.etm * s.n_esp / s.n_mp * wf)
                + self.ag_mp(s.blm * wf))

    def t_s2(self, s: MoELayerShape, wire_dtype=None) -> float:
        """Eq. (14): fused AlltoAll + SAA phase + MP-AllGather(ETM)."""
        wf = self.wire_factor(wire_dtype)
        return (self.a2a_ep_esp(s.etm * s.n_esp / s.n_mp * wf)
                + self.overlap(s.etm * s.n_esp / s.n_mp * wf)
                + self.ag_mp(s.etm * wf))

    # --- compute + pipeline extension (repro_torch.core.pipeline) ----------
    def t_ffn(self, s: MoELayerShape, schedule: str = "s1") -> float:
        """Per-device expert-FFN seconds (coarse dense-roofline estimate).

        A GLU expert runs three ``M x H`` matmuls per token slot, i.e.
        ``6 * M * H`` FLOPs with multiply-adds counted as two.  S1/S2
        process ``E * T * n_esp / n_mp`` slots per device; the baseline
        skips the MP split and redundantly computes all ``n_mp`` copies
        — the very redundancy Parm removes (paper Fig. 3a).
        """
        slots = s.E * s.T * s.n_esp
        if schedule not in REDUNDANT_COMPUTE:
            slots /= s.n_mp
        return 6.0 * slots * s.M * s.H / s.n_esp / self.flops_per_s

    def _chain(self, s: MoELayerShape, schedule: str, wire_dtype=None):
        """(fixed, chain_alpha, chain_beta_time) for one schedule body.

        ``fixed`` is the serial time outside the chunkable AlltoAll/FFN
        chain; the chain's startup (``alpha``, charged once per chunk)
        and bandwidth time (split across chunks) are returned separately.
        ``wire_dtype`` scales the bandwidth terms of the compressible
        collectives (AlltoAlls + output AllGathers; the baseline's
        pre-gate AllGather and in-network AllReduce stay at full width —
        see :meth:`t_baseline`).
        """
        wf = self.wire_factor(wire_dtype)
        y = s.etm * s.n_esp
        if schedule == "baseline":
            return (self.ag_esp(s.blm * s.n_esp),
                    2 * self.a2a_ep.alpha + self.ar_esp.alpha,
                    2 * self.a2a_ep.beta * y * wf + self.ar_esp.beta * y)
        y /= s.n_mp
        if schedule in ("s1", "s1_seqpar"):
            fixed = 0.0 if schedule == "s1_seqpar" \
                else self.ag_mp(s.blm * wf)
            return (fixed, 2 * self.a2a_ep_esp.alpha,
                    2 * self.a2a_ep_esp.beta * y * wf)
        if schedule == "s2":
            return (0.0,
                    (self.a2a_ep_esp.alpha + self.overlap.alpha
                     + self.ag_mp.alpha),
                    (self.a2a_ep_esp.beta * y * wf
                     + self.overlap.beta * y * wf
                     + self.ag_mp.beta * s.etm * wf))
        raise ValueError(f"unknown schedule {schedule!r}")

    def t_pipelined(self, s: MoELayerShape, schedule: str = "s1",
                    n_chunks: int = 1, wire_dtype=None) -> float:
        """Fill/drain pipeline time for a chunked schedule body.

        With ``n`` chunks, each chunk's communication costs
        ``tc = chain_beta / n + chain_alpha`` and its FFN
        ``tf = t_ffn / n``; chunk ``i+1``'s communication overlaps chunk
        ``i``'s compute, so the chain totals
        ``tc + (n - 1) * max(tc, tf) + tf`` plus the un-chunkable fixed
        part.  ``n_chunks=1`` degenerates to the serial closed form plus
        the compute term, so pipelining only wins when overlap beats the
        extra per-chunk startup:

        >>> ab = AlphaBeta(1e-6, 1e-9)
        >>> m = PerfModel(ab, ab, ab, ab, ab, ab, flops_per_s=1e12)
        >>> s = MoELayerShape(B=8, L=1024, M=1024, H=4096, E=8, k=2,
        ...                   f=1.0, n_mp=2, n_esp=2, n_ep=2)
        >>> m.t_pipelined(s, "s1", 4) < m.t_pipelined(s, "s1", 1)
        True

        A narrower wire dtype shrinks the chain's bandwidth term (never
        the alphas or the FFN), so it can only help:

        >>> m.t_pipelined(s, "s1", 4, "bf16") <= m.t_pipelined(s, "s1", 4)
        True
        """
        n = max(1, n_chunks)
        fixed, c_alpha, c_beta = self._chain(s, schedule, wire_dtype)
        tc = c_beta / n + c_alpha
        tf = self.t_ffn(s, schedule) / n
        return fixed + tc + (n - 1) * max(tc, tf) + tf

    def pick_chunks(self, s: MoELayerShape, schedule: str = "s1",
                    candidates=(1, 2, 4, 8), wire_dtype=None) -> int:
        """Chunk count minimizing :meth:`t_pipelined` for one schedule."""
        return min(candidates, key=lambda n: self.t_pipelined(
            s, schedule, n, wire_dtype))

    # --- plan-IR cost model (repro_torch.core.plan) ------------------------
    def _t_stage_comm(self, st, s: MoELayerShape, wf: float, n: int,
                      overlap_hier: bool, etm_scale: float = 1.0) -> float:
        """Seconds one plan stage spends on the fabric (1/n of its
        payload for a chunk clone; local stages cost zero).
        ``etm_scale`` multiplies every capacity-pool (etm-sized) payload
        — placement pool shrink and/or max-rank load skew."""
        etm = s.etm * etm_scale
        size = {"blm": s.blm, "etm": etm,
                "blm*esp": s.blm * s.n_esp,
                "etm*esp": etm * s.n_esp,
                "etm*esp/mp": etm * s.n_esp / s.n_mp}.get(st.size, 0.0)
        f = (wf if st.wire else 1.0) / n
        if st.kind == "ag_mp":
            ab = self.ag_esp if st.axes and st.axes[0] == "esp" \
                else self.ag_mp
            return ab(size * f)
        if st.kind == "allreduce":
            return self.ar_esp(size / n)   # in-network: never wire-scaled
        if st.kind in ("dispatch_a2a", "combine_a2a"):
            if st.p("hier"):
                ti = self.hier_intra(size * f)
                tx = self.hier_inter(size * f)
                # alternating chunk orders run one chunk's intra-group
                # hop in the shadow of another's inter-group hop
                t = max(ti, tx) if overlap_hier else ti + tx
            elif st.p("saa"):
                t = self.overlap(size * f)
            elif st.p("fused"):
                t = self.a2a_ep_esp(size * f)
            else:
                t = self.a2a_ep(size * f)
            if st.p("saa") or st.p("stack_ag"):
                t += self.ag_mp(etm * (wf if st.wire else 1.0) / n)
            return t
        return 0.0   # gate/dispatch/combine/splits/slice/merge: local

    def t_plan(self, plan, s: MoELayerShape, wire_dtype=None,
               loads=None) -> float:
        """Predicted layer seconds for a schedule plan — the graph the
        executor runs is the graph this walks (one cost-model source of
        truth; the ``autosched`` grids score registry plans through it).

        Non-chunk stages are serial (``fixed``); each chunk's comm
        stages sum to its ``tc`` and overlap the other chunks' FFN
        slices exactly as in :meth:`t_pipelined`'s fill/drain model, so
        for the four paper schedules ``t_plan`` reproduces
        ``t_pipelined`` (asserted by the reference's
        ``tests/test_plan_executor.py``).
        ``wire_dtype=None`` keeps the pre-wire scoring (factor 1.0).

        Skew-aware pricing: with a per-expert ``loads`` vector, every
        capacity-pool term (the etm-sized A2As and the expert FFN) is
        charged at the *most-loaded EP rank's* share — a synchronized
        stage runs at the pace of its slowest rank, so a hot expert
        multiplies the uniform plan's time by max-rank/mean-rank load.
        A plan carrying an ``ExpertPlacement`` is charged its own rank
        imbalance (replication spreads the hot expert) times its
        ``pool_scale`` (the shrunk ``cap_frac`` capacity pool) — this is
        how ``autosched.decide_placement`` scores placements against the
        uniform plan.
        """
        wf = self.wire_factor(wire_dtype)
        pl = getattr(plan, "placement", None)
        etm_scale = 1.0
        if pl is not None:
            etm_scale *= pl.pool_scale(max(int(s.T), 1))
        if loads is not None and len(loads):
            etm_scale *= _rank_imbalance(loads, s.n_ep, pl)
        n = max(getattr(plan, "n_chunks", 1), 1)
        overlap_hier = n >= 2
        fixed, per_chunk = 0.0, {}
        for st in plan.stages:
            t = self._t_stage_comm(st, s, wf, n if st.chunk else 1,
                                   overlap_hier, etm_scale)
            if t == 0.0:
                continue
            if st.chunk:
                ci = st.p("chunk_index", 0)
                per_chunk[ci] = per_chunk.get(ci, 0.0) + t
            else:
                fixed += t
        tc = max(per_chunk.values(), default=0.0)
        tf = self.t_ffn(s, plan.base or plan.name) / n * etm_scale
        if any(st.kind == "expert_ffn_grouped" for st in plan.stages):
            # ragged grouped-GEMM: compute scales with *routed* tokens
            # (k*B*L rows), not capacity (k*f*B*L slots) — the expected
            # MXU occupancy of the predicated kernel is 1/f for f >= 1
            tf *= min(1.0, 1.0 / max(s.f, 1e-9))
        return fixed + tc + (n - 1) * max(tc, tf) + tf

    def t_plan_stages(self, plan, s: MoELayerShape, wire_dtype=None,
                      loads=None) -> dict:
        """Per-stage predicted seconds for ``plan`` — the same pricing
        as :meth:`t_plan` (same wire factor, chunk scaling, etm skew),
        itemized instead of folded through the fill/drain closed form.

        Returns ``{stage_name: seconds}`` covering *every* stage of the
        plan: comm stages get their :meth:`_t_stage_comm` term, the
        expert-FFN stages split the compute term ``tf`` evenly, and
        local bookkeeping stages (gate/dispatch/combine/splits) are an
        explicit ``0.0`` — the model claims they are free, and the
        audit (``repro_torch.obs.audit``) holds it to that by reporting
        their measured times without a relative error.

        Itemized serial times deliberately do NOT sum to
        :meth:`t_plan`: the closed form credits chunk overlap
        (``max(tc, tf)``), the per-stage view does not.  The audit
        reports both totals side by side.
        """
        wf = self.wire_factor(wire_dtype)
        pl = getattr(plan, "placement", None)
        etm_scale = 1.0
        if pl is not None:
            etm_scale *= pl.pool_scale(max(int(s.T), 1))
        if loads is not None and len(loads):
            etm_scale *= _rank_imbalance(loads, s.n_ep, pl)
        n = max(getattr(plan, "n_chunks", 1), 1)
        overlap_hier = n >= 2
        ffn = [st for st in plan.stages
               if st.kind in ("expert_ffn", "expert_ffn_grouped")]
        tf = self.t_ffn(s, plan.base or plan.name) * etm_scale
        if any(st.kind == "expert_ffn_grouped" for st in plan.stages):
            tf *= min(1.0, 1.0 / max(s.f, 1e-9))
        out = {}
        for st in plan.stages:
            if st.kind in ("expert_ffn", "expert_ffn_grouped"):
                out[st.name] = tf / len(ffn)
            else:
                out[st.name] = self._t_stage_comm(
                    st, s, wf, n if st.chunk else 1, overlap_hier,
                    etm_scale)
        return out

    # --- decode latency model (repro_torch.serve) ---------------------------
    def t_decode(self, s: MoELayerShape, wire_dtype=None,
                 kv_bytes: float = 0.0) -> float:
        """Predicted seconds for one MoE layer at *decode* time: the best
        candidate of the decode grid (``plan.analytic_schedules(infer=
        True)``, which adds the decode-dedicated plans, e.g. ``s1d``) at
        ``n_chunks=1`` — decode pools are a handful of tokens, far too
        small for capacity chunking to pay for its alphas.

        ``kv_bytes`` adds the paged-KV attention read for the step: the
        decode batch streams every live page of K/V once per token, an
        HBM-bandwidth-bound term (``kv_bytes / HBM_BW``) that grows with
        context length while the MoE terms stay fixed.

        The serving engine uses this for batch-bucket sizing
        (``repro_torch.serve.engine.suggest_max_batch``): decode steps are
        alpha-dominated, so per-token latency falls with batch until the
        bandwidth terms take over — and with paged KV the block budget,
        not the row count, caps the batch.
        """
        # lazy: module cycle; importing the schedules fills the registry
        from repro_torch.core import plan as planlib, schedules  # noqa: F401
        return max(kv_bytes, 0.0) / HBM_BW + min(
            self.t_plan(planlib.plan_for_shape(name, s, 1), s,
                        wire_dtype=wire_dtype)
            for name in planlib.analytic_schedules(infer=True))

    # --- Algorithm 1 --------------------------------------------------------
    def algorithm1(self, s: MoELayerShape) -> str:
        """Faithful transcription of Algorithm 1 (lines 1-9).

        Compares the S1 cost ``t_D1`` (line 4) against the S2 cost
        ``t_D2`` (line 5) for the layer shape and returns the winner:

        >>> ab = AlphaBeta(1e-5, 1e-9)
        >>> m = PerfModel(ab, ab, ab, ab, ab, ab)
        >>> big = MoELayerShape(B=64, L=4096, M=1024, H=1, E=4, k=4,
        ...                     f=8.0, n_mp=4, n_esp=1, n_ep=4)
        >>> m.algorithm1(big)      # T -> inf favours S1 (paper §IV-B)
        's1'
        """
        x = s.B * s.L * s.M                                  # line 1
        T = s.k * s.f * s.B * s.L / s.E                      # line 2 (T)
        y = s.E * T * s.M * s.n_esp                          # line 3
        t_d1 = (2 * (self.a2a_ep_esp.alpha
                     + self.a2a_ep_esp.beta * y / s.n_mp)
                + self.ag_mp.alpha + self.ag_mp.beta * x)    # line 4
        t_d2 = (self.a2a_ep_esp.alpha
                + self.a2a_ep_esp.beta * y / s.n_mp
                + self.overlap.alpha + self.overlap.beta * y / s.n_mp
                + self.ag_mp.alpha + self.ag_mp.beta * T * s.E * s.M)  # line 5 + AG_MP(ETM) of Eq. 14
        return "s1" if t_d1 <= t_d2 else "s2"                # lines 6-9

    def pick(self, s: MoELayerShape) -> str:
        """Algorithm-1 schedule choice (no pipelining considered)."""
        return self.algorithm1(s)


def _rank_imbalance(loads, n_ep: int, placement=None) -> float:
    """max-rank / mean-rank load for a per-expert load vector.

    With a placement, its replication spreads each expert's load across
    its replicas' ranks (``ExpertPlacement.imbalance``); without one,
    the canonical block mapping (expert e on rank ``e // (E / n_ep)``)
    applies.  Degenerate inputs price as balanced (1.0).

    >>> _rank_imbalance([4.0, 1.0, 1.0, 1.0], 4)
    2.2857142857142856
    >>> _rank_imbalance([1.0, 1.0, 1.0, 1.0], 2)
    1.0
    """
    if placement is not None:
        return placement.imbalance(loads)
    E = len(loads)
    if n_ep <= 1 or E % n_ep:
        return 1.0
    tot = float(sum(loads))
    if tot <= 0:
        return 1.0
    per = E // n_ep
    ranks = [sum(loads[r * per:(r + 1) * per]) for r in range(n_ep)]
    return max(ranks) / (tot / n_ep)


def fit_alpha_beta(sizes, times) -> AlphaBeta:
    """Least-squares fit of ``t = alpha + beta * x`` (paper §V-A).

    Degenerate inputs (all sizes equal) fall back to ``beta = 0`` with
    ``alpha`` the mean time; negative fitted parameters clamp at zero.

    >>> fit_alpha_beta([1, 2, 3], [3.0, 5.0, 7.0])
    AlphaBeta(alpha=1.0, beta=2.0)
    >>> fit_alpha_beta([4, 4], [2.0, 4.0])
    AlphaBeta(alpha=3.0, beta=0.0)
    """
    n = len(sizes)
    sx = sum(sizes)
    sy = sum(times)
    sxx = sum(x * x for x in sizes)
    sxy = sum(x * y for x, y in zip(sizes, times))
    denom = n * sxx - sx * sx
    if denom == 0:
        return AlphaBeta(alpha=sy / max(n, 1), beta=0.0)
    beta = (n * sxy - sx * sy) / denom
    alpha = (sy - beta * sx) / n
    return AlphaBeta(alpha=max(alpha, 0.0), beta=max(beta, 0.0))


# --- analytic H100 fabric model --------------------------------------------

def h100_model(n_ep: int, n_esp: int, n_mp: int, bytes_per_el: int = 4,
               inter_node: bool = False) -> PerfModel:
    """Analytic alpha-beta constants for H100 SXM cards.

    MP/ESP map to the innermost group (within a node, all-NVLink); EP
    spans the outer group (and InfiniBand when ``inter_node``).
    Ring/bidirectional collectives move ``(g - 1) / g`` of the payload
    through a card's ~``NVLINK_BW`` a direction.  Single-member groups
    cost nothing per element:

    >>> m = h100_model(n_ep=4, n_esp=1, n_mp=1)
    >>> m.ag_esp.beta == 0.0 and m.a2a_ep.beta > 0.0
    True
    >>> m.wire_factor("f32"), m.wire_factor("bf16")
    (1.0, 0.5)
    """
    def coll(bw, g):
        frac = (g - 1) / g if g > 1 else 0.0
        return AlphaBeta(ALPHA_COLL * max(g, 1), bytes_per_el * frac / bw)

    bw_outer = IB_BW if inter_node else NVLINK_BW
    a2a_combined = coll(min(NVLINK_BW, bw_outer), n_ep * n_esp)
    return PerfModel(
        a2a_ep_esp=a2a_combined,
        a2a_ep=coll(bw_outer, n_ep),
        ag_esp=coll(NVLINK_BW, n_esp),
        ar_esp=AlphaBeta(2 * ALPHA_COLL * n_esp,
                         2 * bytes_per_el * (n_esp - 1) / max(n_esp, 1)
                         / NVLINK_BW),
        ag_mp=coll(NVLINK_BW, n_mp),
        # SAA hides the faster of the two transfers; model the overlapped
        # phase as the a2a beta alone (AllGather rides in its shadow).
        overlap=a2a_combined,
        flops_per_s=PEAK_FLOPS_F32,
        # betas above bake in bytes_per_el, so wire factors are relative
        wire_bytes_ref=float(bytes_per_el),
        # hierarchical (s2h) hops: the intra hop stays on the NVLink ESP
        # group; the inter hop crosses the outer fabric.  The fused
        # collective above pays min(NVLink, outer) bandwidth on its whole
        # payload, so across nodes the decomposition — which overlaps the
        # two hops across alternating chunks — wins.
        a2a_intra=coll(NVLINK_BW, n_esp),
        a2a_inter=coll(bw_outer, n_ep),
    )


def speedup_table(shape: MoELayerShape, model: PerfModel) -> dict:
    """Analytic reproduction row: baseline vs S1 vs S2 vs Parm (auto).

    Returns the three closed-form times, the Algorithm-1 pick, and the
    baseline-relative speedups (``speedup_parm`` uses the picked
    schedule's time).
    """
    tb = model.t_baseline(shape)
    t1 = model.t_s1(shape)
    t2 = model.t_s2(shape)
    pick = model.algorithm1(shape)
    tp = t1 if pick == "s1" else t2
    return {"t_baseline": tb, "t_s1": t1, "t_s2": t2, "pick": pick,
            "speedup_s1": tb / t1, "speedup_s2": tb / t2,
            "speedup_parm": tb / tp}
