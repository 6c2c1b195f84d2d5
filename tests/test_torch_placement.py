"""The port's expert placement (``repro_torch.core.placement``, a copy, and
the placement parts of ``autosched``, ``plan``, ``perfmodel`` and
``gating``) against the JAX package's on the CPU, in one process.

``test_placement.py``'s unit cases run here as parametrised cases, each
once on either package with the reference's own assertions, their
results compared (tables, placements, priced floats, autoscheduler
outcomes, all ``==``).  Then, from seeded numpy inputs:
``placement_from_loads`` (assignments and ``cap_frac``), the placement
tables (``rep_table``, ``replica_index``, ``scaled_cap``, ``pool_scale``,
``rank_loads``, ``imbalance``), ``LoadEMA``, ``plan.apply_placement`` on
every registered schedule (the same graph), ``PerfModel.t_plan(...,
loads=)`` (``==`` floats), ``decide_placement`` and ``maybe_rebalance``
from the same cache state, and the placed ``topk_gate`` and flat slot
indices at an int and a vector capacity (routing exact, weights and aux
to the f32 gate's 1e-6).

The cost models are made equal: JAX's ``tpu_v5e_model`` copied field by
field into the port's ``PerfModel`` and patched in as the port's default
(its ``h100_model`` in ``autosched``) for every case here.
"""

import dataclasses
import types

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import autosched as j_auto  # noqa: E402
from repro.core import perfmodel as j_perf  # noqa: E402
from repro.core import placement as j_place  # noqa: E402
from repro.core import plan as j_plan  # noqa: E402
from repro_torch.core import autosched as t_auto  # noqa: E402
from repro_torch.core import perfmodel as t_perf  # noqa: E402
from repro_torch.core import placement as t_place  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402

HOT = [4.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]   # one ~4x-hot expert
EVEN = [1.0] * 8


def _to_port(jm):
    """A JAX ``PerfModel`` copied field by field into the port's."""
    def conv(v):
        if isinstance(v, j_perf.AlphaBeta):
            return t_perf.AlphaBeta(alpha=v.alpha, beta=v.beta)
        return v
    return t_perf.PerfModel(**{f.name: conv(getattr(jm, f.name))
                               for f in dataclasses.fields(jm)})


def _port_default(n_ep, n_esp, n_mp):
    return _to_port(j_perf.tpu_v5e_model(n_ep, n_esp, n_mp))


PKGS = {
    "jax": types.SimpleNamespace(
        auto=j_auto, perf=j_perf, place=j_place, plan=j_plan,
        model=j_perf.tpu_v5e_model),
    "port": types.SimpleNamespace(
        auto=t_auto, perf=t_perf, place=t_place, plan=t_plan,
        model=_port_default),
}


@pytest.fixture(autouse=True)
def _same_model_and_clean_registry(monkeypatch):
    """Both packages price with ``tpu_v5e_model``; the placement registry
    and decision cache are process-global, so each case starts clean."""
    monkeypatch.setattr(t_auto, "h100_model", _port_default)
    j_auto.clear_cache()
    t_auto.clear_cache()
    yield
    j_auto.clear_cache()
    t_auto.clear_cache()


def _pl(p):
    """A placement (or None) as a comparable tuple."""
    if p is None:
        return None
    return (p.n_experts, p.n_ep, tuple(int(a) for a in p.assignments),
            p.cap_frac, p.epoch)


def shape8(ns, **kw):
    d = dict(B=8, L=128, M=512, H=2048, E=8, k=2, f=1.2,
             n_mp=2, n_esp=2, n_ep=4)
    d.update(kw)
    return ns.perf.MoELayerShape(**d)


# --- test_placement.py's unit cases, on either package --------------------

def c_identity(ns):
    pl = ns.place.identity_placement(8, 4)
    assert pl.is_identity and pl.n_phys == 8
    assert list(pl.rep_count) == [1] * 8
    assert pl.imbalance(EVEN) == pytest.approx(1.0)
    assert pl.scaled_cap(64) == 64
    assert pl.pool_scale(64) == pytest.approx(1.0)
    return (_pl(pl), pl.imbalance(EVEN), pl.pool_scale(64))


def c_replica_tables(ns):
    pl = ns.place.ExpertPlacement(n_experts=4, n_ep=2,
                                  assignments=(0, 1, 0, 2, 0, 3),
                                  cap_frac=0.5)
    assert pl.n_phys == 6 and not pl.is_identity
    assert list(pl.rep_count) == [3, 1, 1, 1]
    table = pl.rep_table
    assert table.shape == (4, 3)
    assert list(table[0]) == [0, 2, 4]
    assert list(table[1]) == [1, 1, 1]
    assert list(pl.replica_index) == [0, 0, 1, 0, 2, 0]
    return (table.tolist(), pl.replica_index.tolist())


def c_scaled_cap_alignment(ns):
    pl = ns.place.ExpertPlacement(n_experts=4, n_ep=2,
                                  assignments=(0, 1, 0, 2, 0, 3),
                                  cap_frac=0.25)
    got = (pl.scaled_cap(64), pl.scaled_cap(10), pl.scaled_cap(64, align=24))
    assert got == (16, 8, 24)
    return got


def c_replication_reduces_imbalance(ns):
    loads = [4.0, 1.0, 1.0, 1.0]
    uni = ns.place.identity_placement(4, 2)
    assert uni.imbalance(loads) == pytest.approx((5 / 7) / 0.5)
    rep = ns.place.ExpertPlacement(n_experts=4, n_ep=2,
                                   assignments=(0, 1, 2, 0, 0, 3),
                                   cap_frac=0.5)
    assert rep.imbalance(loads) < uni.imbalance(loads)
    return (uni.imbalance(loads), rep.imbalance(loads))


def c_validation(ns):
    msgs = []
    for kw, match in ((dict(assignments=(0, 1, 2, 3, 0)), "not divisible"),
                      (dict(assignments=(0, 1, 2, 2)), "no replica"),
                      (dict(assignments=(0, 1, 2, 3), cap_frac=0.0),
                       "cap_frac"),
                      (dict(assignments=(0, 1, 2, 3), cap_frac=1.5),
                       "cap_frac")):
        with pytest.raises(ValueError, match=match) as exc:
            ns.place.ExpertPlacement(n_experts=4, n_ep=2, **kw)
        msgs.append(str(exc.value))
    return msgs


def c_summary_roundtrip(ns):
    pl = ns.place.ExpertPlacement(n_experts=4, n_ep=2,
                                  assignments=(0, 1, 0, 2, 0, 3),
                                  cap_frac=0.5, epoch=3)
    s = pl.summary()
    assert s["epoch"] == 3 and s["n_phys"] == 6
    assert s["replicated"] == {0: 3}
    assert ns.place.ExpertPlacement(
        n_experts=s["n_experts"], n_ep=s["n_ep"],
        assignments=tuple(s["assignments"]), cap_frac=s["cap_frac"],
        epoch=s["epoch"]) == pl
    return s


def c_hot_expert_replicated(ns):
    pl = ns.place.placement_from_loads(HOT, 4, capacity_factor=1.2, top_k=2)
    assert not pl.is_identity
    assert pl.rep_count[0] > 1
    assert pl.n_phys % 4 == 0
    assert set(pl.assignments) == set(range(8))
    assert 0.0 < pl.cap_frac <= 1.0
    per_rank = np.asarray(pl.assignments).reshape(4, -1)
    assert max(int((per_rank == 0).sum(axis=1).max()), 1) == 1
    return _pl(pl)


def c_uniform_is_identity(ns):
    pl = ns.place.placement_from_loads(EVEN, 4)
    assert pl.is_identity
    return _pl(pl)


def c_degenerate_inputs(ns):
    out = [ns.place.placement_from_loads([0.0] * 8, 4),
           ns.place.placement_from_loads(HOT, 1),
           ns.place.placement_from_loads([1.0, 9.0], 4)]
    assert all(p.is_identity for p in out)
    return [_pl(p) for p in out]


def c_max_replicas(ns):
    pl = ns.place.placement_from_loads([100.0, 1, 1, 1, 1, 1, 1, 1], 4,
                                       max_replicas=2)
    assert int(pl.rep_count.max()) <= 2
    return _pl(pl)


def c_epoch_stamped(ns):
    pl = ns.place.placement_from_loads(HOT, 4, epoch=7)
    assert pl.epoch == 7
    return _pl(pl)


def c_ema_lifecycle(ns):
    ema = ns.place.LoadEMA(decay=0.5)
    assert not ema.ready and ema.value().size == 0
    assert ema.imbalance() == 1.0
    ema.update(HOT)
    assert ema.ready
    ema.update(EVEN)
    np.testing.assert_allclose(
        ema.value(), 0.5 * np.asarray(HOT) + 0.5 * np.asarray(EVEN))
    assert ema.imbalance() > 1.0
    return (ema.value().tolist(), ema.imbalance(), ema.steps)


def c_ema_rejects_bad_updates(ns):
    ema = ns.place.LoadEMA()
    ema.update([])
    ema.update([np.nan, 1.0])
    assert not ema.ready
    ema.update([1.0, 2.0])
    ema.update([1.0, 2.0, 3.0])
    assert ema.value().shape == (3,)
    return ema.value().tolist()


def c_stamps_plan(ns):
    pl = ns.place.placement_from_loads(HOT, 4, capacity_factor=5.0, top_k=2)
    assert pl.cap_frac < 1.0
    s = shape8(ns, f=5.0)
    p = ns.plan.plan_for_shape("s1", s, 1, placement=pl)
    assert p.placement is pl
    gate = next(st for st in p.stages if st.kind == "gate")
    placed_cap = gate.p("placed_cap")
    assert placed_cap and placed_cap % 8 == 0
    p_uni = ns.plan.plan_for_shape(
        "s1", s, 1, placement=ns.place.identity_placement(8, 4))
    uni_cap = next(st for st in p_uni.stages
                   if st.kind == "gate").p("placed_cap")
    assert placed_cap < uni_cap
    stamped = [st for st in p.stages
               if st.kind in ("dispatch", "combine", "dispatch_a2a",
                              "combine_a2a", "expert_ffn_grouped")]
    assert stamped and all(st.p("placed") is True for st in stamped)
    return (placed_cap, uni_cap, ns.plan.format_plan(p))


def c_identity_is_noop_graph(ns):
    s = shape8(ns)
    base = ns.plan.plan_for_shape("s1", s, 1)
    placed = ns.plan.plan_for_shape(
        "s1", s, 1, placement=ns.place.identity_placement(8, 4))
    assert placed.stage_names() == base.stage_names()
    assert base.placement is None
    return placed.stage_names()


def c_pool_split_chunk_alignment(ns):
    pl = ns.place.placement_from_loads(HOT, 4, capacity_factor=5.0, top_k=2)
    s = shape8(ns, n_mp=2, f=5.0)
    p = ns.plan.plan_for_shape("s2", s, 2, placement=pl)
    gate = next(st for st in p.stages if st.kind == "gate")
    assert gate.p("placed_cap") % (2 * s.n_mp) == 0
    if p.chunk_size:
        assert p.chunk_size == gate.p("placed_cap") // s.n_mp
    return (gate.p("placed_cap"), p.chunk_size)


def c_none_placement_unchanged(ns):
    p = ns.plan.plan_for_shape("s1", shape8(ns), 1)
    assert ns.plan.apply_placement(p, None) is p
    return p.stage_names()


def c_rejects_planless_gate(ns):
    bad = ns.plan.Plan(
        "t", (ns.plan.stage("d", "dispatch", deps=()),), output="d")
    with pytest.raises(ns.plan.PlanError, match="needs a") as exc:
        ns.plan.apply_placement(bad, ns.place.identity_placement(8, 4))
    return str(exc.value)


def c_rank_imbalance(ns):
    ri = ns.perf._rank_imbalance
    assert ri(EVEN, 4) == pytest.approx(1.0)
    assert ri(HOT, 4) > 1.4
    pl = ns.place.placement_from_loads(HOT, 4, capacity_factor=5.0, top_k=2)
    assert ri(HOT, 4, pl) < ri(HOT, 4)
    return (ri(EVEN, 4), ri(HOT, 4), ri(HOT, 4, pl))


def c_t_plan_prices_skew(ns):
    s = shape8(ns)
    pm = ns.model(s.n_ep, s.n_esp, s.n_mp)
    p = ns.plan.plan_for_shape("s1", s, 1)
    t_even, t_hot = pm.t_plan(p, s, loads=EVEN), pm.t_plan(p, s, loads=HOT)
    assert t_hot > t_even
    return (t_even, t_hot)


def c_placed_plan_wins_under_skew(ns):
    s = shape8(ns)
    pm = ns.model(s.n_ep, s.n_esp, s.n_mp)
    pl = ns.place.placement_from_loads(HOT, 4, capacity_factor=5.0, top_k=2)
    t_uni = pm.t_plan(ns.plan.plan_for_shape("s1", s, 1), s, loads=HOT)
    t_pl = pm.t_plan(ns.plan.plan_for_shape("s1", s, 1, placement=pl), s,
                     loads=HOT)
    assert t_pl < t_uni
    return (t_uni, t_pl)


def c_epoch_and_registry(ns):
    a = ns.auto
    assert a.current_placement() is None and a.placement_epoch() == 0
    pl = ns.place.placement_from_loads(HOT, 4, capacity_factor=1.2, top_k=2)
    e1 = a.set_placement(pl)
    assert e1 == 1 and a.current_placement() is pl
    e2 = a.set_placement(None)
    assert e2 == 2 and a.current_placement() is None
    a.clear_cache()
    assert a.placement_epoch() == 0
    return (e1, e2)


def c_decisions_keyed_by_epoch(ns):
    a = ns.auto
    s = shape8(ns)
    d0 = a.decide(s)
    assert d0.placement_epoch == 0 and len(a.cache_info()) == 1
    a.set_placement(ns.place.placement_from_loads(HOT, 4,
                                                  capacity_factor=1.2,
                                                  top_k=2))
    assert len(a.cache_info()) == 1
    d1 = a.decide(s)
    assert d1.placement_epoch == 1 and len(a.cache_info()) == 2
    summary = a.cache_summary()
    assert "placement-epoch=1" in summary and "STALE" in summary
    return (d0.schedule, d0.n_chunks, d1.schedule, summary)


def c_invalidate_by_shape(ns):
    a = ns.auto
    sa, sb = shape8(ns), shape8(ns, B=16)
    a.decide(sa)
    a.decide(sb)
    assert len(a.cache_info()) == 2
    assert a.invalidate("test", shape=sa) == 1
    assert len(a.cache_info()) == 1
    assert a.invalidate("test") == 1
    assert len(a.cache_info()) == 0
    return True


def c_decide_placement(ns):
    s = shape8(ns)
    pl, t_pl, t_uni = ns.auto.decide_placement(
        s, HOT, schedule="s1", capacity_factor=1.2, top_k=2)
    assert pl is not None and t_pl < t_uni
    none, t1, t2 = ns.auto.decide_placement(
        s, EVEN, schedule="s1", capacity_factor=1.2, top_k=2)
    assert none is None and t1 == t2
    return (_pl(pl), t_pl, t_uni, t1)


def c_rebalance_lifecycle(ns):
    a = ns.auto
    s = shape8(ns)
    assert a.maybe_rebalance(HOT) is None
    a.decide(s)
    assert a.maybe_rebalance(HOT, capacity_factor=1.2, top_k=2) == 1
    installed = a.current_placement()
    assert installed is not None and not installed.is_identity
    assert a.maybe_rebalance(HOT, capacity_factor=1.2, top_k=2) is None
    assert a.maybe_rebalance(EVEN, capacity_factor=1.2, top_k=2) == 2
    assert a.current_placement() is None
    assert a.maybe_rebalance(EVEN, capacity_factor=1.2, top_k=2) is None
    return _pl(installed)


def c_rebalance_infer_keeps_full_capacity(ns):
    a = ns.auto
    a.decide(shape8(ns, infer=True))
    epoch = a.maybe_rebalance(HOT, capacity_factor=1.2, top_k=2, infer=True)
    pl = a.current_placement()
    if epoch is not None and pl is not None:
        assert pl.cap_frac == 1.0
    return (epoch, _pl(pl))


def c_rebalance_ignores_foreign_shapes(ns):
    ns.auto.decide(shape8(ns, E=16, k=2))
    assert ns.auto.maybe_rebalance(HOT, capacity_factor=1.2,
                                   top_k=2) is None
    return True


UNIT_CASES = {f.__name__[2:]: f for f in (
    c_identity, c_replica_tables, c_scaled_cap_alignment,
    c_replication_reduces_imbalance, c_validation, c_summary_roundtrip,
    c_hot_expert_replicated, c_uniform_is_identity, c_degenerate_inputs,
    c_max_replicas, c_epoch_stamped, c_ema_lifecycle,
    c_ema_rejects_bad_updates, c_stamps_plan, c_identity_is_noop_graph,
    c_pool_split_chunk_alignment, c_none_placement_unchanged,
    c_rejects_planless_gate, c_rank_imbalance, c_t_plan_prices_skew,
    c_placed_plan_wins_under_skew, c_epoch_and_registry,
    c_decisions_keyed_by_epoch, c_invalidate_by_shape, c_decide_placement,
    c_rebalance_lifecycle, c_rebalance_infer_keeps_full_capacity,
    c_rebalance_ignores_foreign_shapes)}


def _plain(v):
    """Numpy scalars and arrays as plain python values, for ``==``."""
    if isinstance(v, dict):
        return {_plain(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_unit_case_as_jax(case):
    """One of ``test_placement.py``'s cases on either package: the
    reference's assertions hold on both, and the results are equal."""
    j_auto.clear_cache()
    want = UNIT_CASES[case](PKGS["jax"])
    got = UNIT_CASES[case](PKGS["port"])
    assert _plain(got) == _plain(want)


# --- seeded inputs -----------------------------------------------------------

LOAD_CASES = [  # (seed, n_ep, E, capacity_factor, top_k, max_replicas)
    (0, 2, 8, 1.25, 2, None), (1, 4, 8, 1.2, 2, None),
    (2, 2, 128, 1.25, 8, None), (3, 4, 64, 2.0, 1, 2),
    (4, 8, 16, 1.0, 2, None), (5, 2, 4, 4.0, 2, 3)]


def _loads(seed, E):
    """A skewed load vector: a few hot experts over a noisy floor."""
    rng = np.random.RandomState(seed)
    w = rng.gamma(0.7, size=E) + 0.05
    w[rng.randint(E)] *= 3.0 + 5.0 * rng.rand()
    return (w * 1000).round(3)


@pytest.mark.parametrize("case", LOAD_CASES, ids=[str(c[0])
                                                  for c in LOAD_CASES])
def test_placement_from_loads_and_tables(case):
    """``placement_from_loads`` from seeded loads gives the same
    assignments and ``cap_frac``; its tables, capacities, pool scale,
    rank loads and imbalance are equal."""
    seed, n_ep, E, f, k, rmax = case
    loads = _loads(seed, E)
    out = []
    for mod in (j_place, t_place):
        pl = mod.placement_from_loads(loads, n_ep, n_experts=E,
                                      capacity_factor=f, top_k=k,
                                      max_replicas=rmax, epoch=seed)
        out.append((_pl(pl), pl.rep_count.tolist(), pl.rep_table.tolist(),
                    pl.replica_index.tolist(),
                    [pl.scaled_cap(c, a) for c in (1, 17, 64, 130)
                     for a in (8, 16)],
                    [pl.pool_scale(c) for c in (0, 32, 100)],
                    pl.rank_loads(loads).tolist(), pl.imbalance(loads),
                    pl.is_identity, pl.summary()))
    assert _plain(out[1]) == _plain(out[0])


def test_load_ema_on_seeded_sequences():
    """``LoadEMA`` over seeded updates (a shape change, a non-finite and
    an empty update among them) holds the same values at every step."""
    rng = np.random.RandomState(3)
    ups = [rng.rand(8) * 10 for _ in range(6)] + [np.array([np.inf] * 8),
                                                  np.zeros(0)]
    ups += [rng.rand(4) for _ in range(3)]
    for decay in (0.5, 0.9, 0.99):
        a, b = j_place.LoadEMA(decay), t_place.LoadEMA(decay)
        for u in ups:
            a.update(u)
            b.update(u)
            assert (b.ready, b.steps, b.imbalance()) == \
                (a.ready, a.steps, a.imbalance())
            assert b.value().tolist() == a.value().tolist()


@pytest.mark.parametrize("layout", [(2, 2, 2), (4, 1, 2), (2, 1, 1)])
def test_apply_placement_stamps_the_same_graph(layout):
    """``plan.apply_placement`` through ``build_plan`` on every registered
    schedule, unchunked and in 2 chunks: the same stages (kind, deps,
    params: ``placed_cap``, ``placed``), chunk size, summary and text."""
    from repro.core.collectives import CommConfig as JComm
    from repro.core.gating import GateConfig as JGate
    from repro.core.schedules import MoEShardInfo as JInfo
    from repro_torch.core.collectives import CommConfig as TComm
    from repro_torch.core.gating import GateConfig as TGate
    from repro_torch.core.schedules import MoEShardInfo as TInfo
    n_ep, n_esp, n_mp = layout
    loads = _loads(7, 8)
    jpl = j_place.placement_from_loads(loads, n_ep, capacity_factor=1.25,
                                       top_k=2)
    tpl = t_place.placement_from_loads(loads, n_ep, capacity_factor=1.25,
                                       top_k=2)
    assert _pl(tpl) == _pl(jpl) and not tpl.is_identity
    kw = dict(ep_axes=("data",), esp_axes=("model",), mp_axes=("model",),
              n_ep=n_ep, n_esp=n_esp, n_mp=n_mp, tokens=128, cap=48)
    jinfo = JInfo(gate=JGate(n_experts=8, top_k=2), comm=JComm(),
                  placement=jpl, **kw)
    tinfo = TInfo(gate=TGate(n_experts=8, top_k=2), comm=TComm(),
                  placement=tpl, **kw)
    for name in sorted(j_plan.PLANS):
        for n_chunks in (1, 2):
            try:
                jp = j_plan.build_plan(name, jinfo, n_chunks=n_chunks)
            except j_plan.PlanError as e:
                with pytest.raises(t_plan.PlanError) as exc:
                    t_plan.build_plan(name, tinfo, n_chunks=n_chunks)
                assert str(exc.value) == str(e)
                continue
            tp = t_plan.build_plan(name, tinfo, n_chunks=n_chunks)
            assert [dataclasses.astuple(s) for s in tp.stages] == \
                [dataclasses.astuple(s) for s in jp.stages], name
            assert tp.chunk_size == jp.chunk_size, name
            assert _plain(t_plan.plan_summary(tp)) == \
                _plain(j_plan.plan_summary(jp)), name
            assert t_plan.format_plan(tp) == j_plan.format_plan(jp), name


def _shapes(seed, n=6):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        E = int(rng.choice([8, 16, 64]))
        kw = dict(B=int(rng.choice([1, 4, 8])),
                  L=int(rng.choice([1, 128, 1024])),
                  M=int(rng.choice([256, 768])),
                  H=int(rng.choice([768, 3072])), E=E,
                  k=int(rng.choice([1, 2])),
                  f=float(rng.choice([1.0, 1.25, 4.0])),
                  n_mp=int(rng.choice([1, 2])),
                  n_esp=int(rng.choice([1, 2])),
                  n_ep=int(rng.choice([2, 4])),
                  infer=bool(rng.rand() < 0.3))
        out.append(kw)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_t_plan_with_loads_is_the_same_float(seed):
    """``PerfModel.t_plan(..., loads=)`` and ``t_plan_stages`` on the
    uniform and the placed plan of every analytic schedule: ``==``."""
    for kw in _shapes(seed):
        js, ts = j_perf.MoELayerShape(**kw), t_perf.MoELayerShape(**kw)
        jm = j_perf.tpu_v5e_model(js.n_ep, js.n_esp, js.n_mp)
        tm = _to_port(jm)
        loads = _loads(seed + kw["E"], kw["E"])
        jpl = j_place.placement_from_loads(loads, js.n_ep,
                                           capacity_factor=js.f, top_k=js.k)
        tpl = t_place.placement_from_loads(loads, ts.n_ep,
                                           capacity_factor=ts.f, top_k=ts.k)
        for name in j_plan.analytic_schedules(infer=js.infer):
            for jp_, tp_ in ((None, None), (jpl, tpl)):
                jp = j_plan.plan_for_shape(name, js, 1, placement=jp_)
                tp = t_plan.plan_for_shape(name, ts, 1, placement=tp_)
                for ld in (None, loads):
                    assert tm.t_plan(tp, ts, loads=ld) == \
                        jm.t_plan(jp, js, loads=ld), (name, kw)
                assert _plain(tm.t_plan_stages(tp, ts, loads=loads)) == \
                    _plain(jm.t_plan_stages(jp, js, loads=loads))


def _hot(seed):
    """Loads with one expert ~5x the others."""
    rng = np.random.RandomState(seed)
    w = rng.rand(8) + 0.5
    w[rng.randint(8)] *= 5
    return w.round(3)


@pytest.mark.parametrize("infer", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_decide_and_maybe_rebalance_from_the_same_cache(seed, infer):
    """From the same decided shapes, ``decide_placement`` and a sequence
    of ``maybe_rebalance`` calls (a hot expert: installed; the same
    loads: kept; another hot expert: swapped; even loads: back to
    uniform) give the same placements, modeled times and epochs on both
    packages; decode keeps full capacity."""
    outs = []
    for ns in (PKGS["jax"], PKGS["port"]):
        ns.auto.clear_cache()
        for B in (8, 16):
            ns.auto.decide(shape8(ns, B=B, infer=infer))
        pl, t_pl, t_uni = ns.auto.decide_placement(
            shape8(ns, infer=infer), _hot(seed), schedule="s1",
            capacity_factor=1.2, top_k=2)
        out = [(_pl(pl), t_pl, t_uni)]
        for loads in (_hot(seed), _hot(seed), _hot(seed + 5), np.ones(8)):
            e = ns.auto.maybe_rebalance(loads, capacity_factor=1.2,
                                        top_k=2, infer=infer)
            out.append((e, _pl(ns.auto.current_placement()),
                        ns.auto.placement_epoch()))
        assert [o[0] for o in out[1:]] == [1, None, 2, 3]
        if infer:
            assert all(o[1] is None or o[1][3] == 1.0 for o in out[1:])
        outs.append(out)
    assert outs[1] == outs[0]


@pytest.mark.parametrize("capacity", ["int", "vector"])
def test_placed_gate_and_flat_slots_match_jax(capacity):
    """The port's ``topk_gate`` at an int and at an (E,) capacity vector
    against JAX's on the same seeded tokens (expert ids, slots, routed
    rows and drop fraction exact; weights and losses 1e-6), and the placed
    flat slots (``gating.flat_slots(placed=)``) equal to the JAX
    executor's ``_placed_flat``."""
    import jax.numpy as jnp
    import torch

    from repro.core import executor as j_exec
    from repro.core import gating as j_gate
    from repro_torch.core import executor as t_exec
    from repro_torch.core import gating as t_gate
    rng = np.random.RandomState(5)
    S, M, E, k = 96, 16, 8, 2
    x = rng.randn(S, M).astype(np.float32)
    wg = (rng.randn(M, E) * 0.3).astype(np.float32)
    wg[:, 0] += 0.8                      # expert 0 hot
    x[:, 0] = np.abs(x[:, 0]) + 1.0
    pl_args = dict(n_experts=E, n_ep=2,
                   assignments=(0, 1, 2, 3, 0, 0, 4, 5, 0, 6, 7, 1),
                   cap_frac=0.5)
    jpl, tpl = j_place.ExpertPlacement(**pl_args), \
        t_place.ExpertPlacement(**pl_args)
    cap = 8
    if capacity == "int":
        jc, tc = cap, cap
    else:
        vec = (tpl.rep_count * cap).astype(np.int32)
        jc, tc = jnp.asarray(vec), torch.from_numpy(vec)
    for cfgkw in (dict(), dict(normalize_topk=True), dict(impl="cumsum")):
        jg = j_gate.topk_gate(jnp.asarray(x), jnp.asarray(wg),
                              j_gate.GateConfig(n_experts=E, top_k=k,
                                                **cfgkw), jc)
        tg = t_gate.topk_gate(torch.from_numpy(x), torch.from_numpy(wg),
                              t_gate.GateConfig(n_experts=E, top_k=k,
                                                **cfgkw), tc)
        np.testing.assert_array_equal(tg.expert_idx.numpy(),
                                      np.asarray(jg.expert_idx))
        np.testing.assert_array_equal(tg.slot_idx.numpy(),
                                      np.asarray(jg.slot_idx))
        np.testing.assert_allclose(tg.weights.numpy(),
                                   np.asarray(jg.weights), rtol=1e-6,
                                   atol=1e-7)
        for key in ("load", "routed", "drop_frac"):
            np.testing.assert_array_equal(tg.aux[key].numpy(),
                                          np.asarray(jg.aux[key]), key)
        for key in ("aux_loss", "z_loss"):
            np.testing.assert_allclose(float(tg.aux[key]),
                                       float(jg.aux[key]), rtol=1e-6)
        assert float(jg.aux["drop_frac"]) > 0
        # the placed flat indices, with the per-physical-slot capacity
        tctx = types.SimpleNamespace(placed=t_exec._PlacedTables(tpl, "cpu"))
        jctx = types.SimpleNamespace(placed=j_exec._PlacedTables(jpl))
        want = np.asarray(j_exec._placed_flat(jctx, jg, cap))
        got = tg.flat(cap, E, tctx.placed)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got is tg.flat(cap, E, tctx.placed)    # memoized
        assert int(want.max()) == tpl.n_phys * cap    # drops: the sentinel
