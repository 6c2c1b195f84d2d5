"""Each Parm schedule's collective bytes on the port's own transport, held
to the paper's closed forms across 8 gloo ranks on the CPU, as the JAX
package's ``tests/helpers/run_comm_volume.py`` holds its compiled HLO.

Mesh (data=4, model=2): N_EP = 4, N_ESP = N_MP = 2 (merged).  JAX's helper
case: B 32, L 64, M 64, ``d_ff`` 128, E 8, top-2, capacity factor 2.0,
``saa_chunks`` 4, f32; S = B L / N_EP tokens a data rank, T = JAX's
``gating.capacity(S)`` aligned to 8 as the helper aligns it.  One forward
of each schedule with ``comm.timing`` on; the collectives read by kind
(``schedule_comparison.volumes``, XLA's names: ``comm.psum``'s
reduce-scatter and AllGather pair is the one ``all-reduce`` of the whole
array that XLA counts) and group.  Each kind's count and result bytes
equal Eq. 1 (baseline), Eq. 11 (S1) and Eq. 14 (S2 with its SAA pieces)
exactly.  Two things the port's layer moves beside the plan are set
aside first, each pinned exactly (ROADMAP §3, settled differences): the
aux outputs' means over every axis (four all-reduces of 3 + E f32; JAX's
jit drops them where the caller discards the aux outputs, as the helper
does), and under ``s1_seqpar`` the AllGather of the output's S rows over
MP (the port's layer returns its batch block whole on every MP rank).
``s1_seqpar``'s plan issues no MP collective: every collective over MP
alone starts outside the plan's stages (``comm.set_hook``'s tags).

Also ``repro_torch.examples.schedule_comparison``'s seven rows at the
example's size, one timed call each: ``max|y - y_base|`` is 0 for every
row, as in JAX's run on 8 CPU devices (the port's psum sums in JAX's
source order), and its one-chunk baseline, s1, s2 and s1_seqpar rows
move the same closed forms at the example's size.
"""

import importlib.util

import pytest
import torch

pytestmark = [pytest.mark.multirank, pytest.mark.skipif(
    importlib.util.find_spec("jax") is None, reason="needs jax")]

B, L, M, F, E, K, FACTOR, SAA = 32, 64, 64, 128, 8, 2, 2.0, 4
NE, NS, NM = 4, 2, 2
EL = 4
EVERY, MP, FUSED = ("data", "model"), ("model",), ("data", "model")
SCHEDS = ("baseline", "s1", "s2", "s1_seqpar")


def _rank(rank):
    from repro_torch.core.moe import (MoEConfig, apply_moe, init_moe_params,
                                      moe_param_specs)
    from repro_torch.examples import schedule_comparison as sc
    from repro_torch.parallel import comm
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import P, local_shard
    mesh = make_mesh(sc.SHAPE, sc.NAMES)
    dims = sc.DIMS
    cfg = MoEConfig(d_model=M, d_ff=F, n_experts=E, top_k=K,
                    capacity_factor=FACTOR, saa_chunks=SAA)
    params = init_moe_params(torch.Generator().manual_seed(0), cfg)
    specs = moe_param_specs(cfg, mesh, dims)
    p = {k: local_shard(v, specs[k], mesh) for k, v in params.items()}
    x = local_shard(torch.zeros((B, L, M)), P(dims.batch_axes, None, None),
                    mesh)
    vols, starts = {}, {}
    with torch.no_grad():
        for sched in SCHEDS:
            seen = []
            comm.set_hook(lambda ev, axes, kind, tag: seen.append(
                (axes, kind, tag)) if ev == "start" else None)
            comm.timing(True)
            try:
                apply_moe(x, p, cfg=cfg, mesh=mesh, dims=dims,
                          schedule=sched)
                vols[sched] = sc.volumes()
            finally:
                comm.timing(False)
                comm.set_hook(None)
            starts[sched] = seen
    rows = sc.compare(mesh, dims, torch.device("cpu"), iters=1)
    return {"vols": vols, "starts": starts, "rows": rows}


@pytest.fixture(scope="module")
def ranks():
    from repro_torch.launch.mesh import spawn
    return spawn(_rank, NE * NS, backend="gloo", device="cpu", threads=1,
                 timeout=600)


def _capacity(b=B, l=L, m=M, f=F, factor=FACTOR):
    """(S, T) as JAX's helper derives them."""
    from repro.core.gating import capacity
    from repro.core.moe import MoEConfig as JMoEConfig
    cfg = JMoEConfig(d_model=m, d_ff=f, n_experts=E, top_k=K,
                     capacity_factor=factor)
    S = b * l // NE
    return S, max(capacity(S, cfg.gate_config()), 8)


def _closed_form(sched, S, T, m=M, saa=SAA):
    """kind -> (count, result bytes) of the plan: Eq. (1) (baseline),
    Eq. (11) (S1), Eq. (14) (S2, the combine AlltoAll and the AllGather in
    ``saa`` pieces each) and s1_seqpar's AlltoAlls alone."""
    a2a = 2 * E * T * m * NS // NM * EL
    return {
        "baseline": {"all-gather": (1, S * m * NS * EL),
                     "all-to-all": (2, 2 * E * (T * NS) * m * EL),
                     "all-reduce": (1, E * (T * NS) * m * EL)},
        "s1": {"all-to-all": (2, a2a), "all-gather": (1, S * m * EL)},
        "s2": {"all-to-all": (1 + saa, a2a),
               "all-gather": (saa, E * T * m * EL)},
        "s1_seqpar": {"all-to-all": (2, a2a)},
    }[sched]


def _set_aside(sched, vols, S=None, m=M):
    """``vols`` by kind {axes: (count, bytes)}, less the two settled
    collectives outside the plan, each held to its exact size first;
    returns kind -> (count, bytes) of the rest, by kind as the HLO is
    read."""
    S = _capacity()[0] if S is None else S
    vols = {k: dict(g) for k, g in vols.items()}
    assert vols["all-reduce"].pop(EVERY) == (4, (3 + E) * EL)
    if sched == "s1_seqpar":
        assert vols["all-gather"].pop(MP) == (1, S * m * EL)
    out = {}
    for kind, groups in vols.items():
        if groups:
            out[kind] = (sum(c for c, _ in groups.values()),
                         sum(b for _, b in groups.values()))
    return out


@pytest.mark.parametrize("sched", SCHEDS)
def test_volumes_are_the_papers_closed_forms(ranks, sched):
    S, T = _capacity()
    for r in ranks:
        assert _set_aside(sched, r["vols"][sched]) == _closed_form(
            sched, S, T)
        if sched == "baseline":
            # the psum is over ESP, the AlltoAlls over EP
            assert set(r["vols"][sched]["all-reduce"]) == {MP, EVERY}
            assert set(r["vols"][sched]["all-to-all"]) == {("data",)}
        elif sched == "s1_seqpar":    # beyond the paper: no MP collective
            assert set(r["vols"][sched]["all-to-all"]) == {FUSED}


def test_s1_seqpar_plan_starts_no_mp_collective(ranks):
    """Every collective over MP alone under s1_seqpar starts outside the
    plan's stages (no stage tag): the output's gather at the layer's
    boundary, and the psum pair's AllGather never (it is over every
    axis); under s1 the plan's own MP AllGather carries its stage's."""
    for r in ranks:
        mp_tags = [tag for axes, _, tag in r["starts"]["s1_seqpar"]
                   if axes == MP]
        assert mp_tags == [None], mp_tags
        assert any(axes == MP and tag is not None
                   for axes, _, tag in r["starts"]["s1"])


def test_s1_and_s1_seqpar_move_less_than_baseline(ranks):
    from repro_torch.examples.schedule_comparison import totals
    for r in ranks:
        tot = {s: totals(r["vols"][s])[0] for s in SCHEDS}
        assert tot["s1_seqpar"] <= tot["s1"] < tot["baseline"], tot
        assert tot["s2"] < tot["baseline"], tot


@pytest.mark.parametrize("row", range(7), ids=[
    "baseline", "s1", "s2", "s1_seqpar", "s1x4", "s2x4", "auto"])
def test_schedule_comparison_rows(ranks, row):
    from repro.core.moe import MoEConfig as JMoEConfig
    from repro_torch.examples import schedule_comparison as sc
    cfg = sc.layer_config()
    S, T = _capacity(8, 512, cfg.d_model, cfg.d_ff, cfg.capacity_factor)
    saa = JMoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=E,
                     top_k=K).saa_chunks
    for r in ranks:
        got = r["rows"][row]
        assert got["label"] == sc.ROWS[row][0]
        assert got["err"] == 0.0, got
        if got["schedule"] in SCHEDS and got["chunks"] == 1:
            assert _set_aside(got["schedule"], got["volumes"], S,
                              cfg.d_model) == _closed_form(
                got["schedule"], S, T, cfg.d_model, saa), got
