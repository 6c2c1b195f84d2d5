"""The port's cost model (``repro_torch.core.perfmodel``, a copy) against
the JAX package's on the CPU: every ``PerfModel`` method,
``_rank_imbalance``, ``fit_alpha_beta`` and ``speedup_table`` over a
seeded grid of one- and multi-rank shapes, under the JAX package's
``tpu_v5e_model`` copied field by field into the port's ``PerfModel``.
The port keeps the reference's arithmetic in the reference's order, so
every float must be equal (``==``, no tolerance).  Also: the port
module's doctests, and ``h100_model``'s single-member groups free per
element.
"""

import dataclasses
import doctest

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import perfmodel as jperf  # noqa: E402
from repro.core import plan as j_plan  # noqa: E402
from repro_torch.core import perfmodel as tperf  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402

LAYOUTS = (1, 2, 4, 8)
SCHEDS = ("baseline", "s1", "s1_seqpar", "s2")
WIRES = (None, "f32", "bf16", "fp8_e4m3")


def to_port(jm):
    """The JAX ``PerfModel`` ``jm`` copied field by field."""
    def conv(v):
        if isinstance(v, jperf.AlphaBeta):
            return tperf.AlphaBeta(alpha=v.alpha, beta=v.beta)
        return v
    return tperf.PerfModel(**{f.name: conv(getattr(jm, f.name))
                              for f in dataclasses.fields(jm)})


def shapes(seed, n=10):
    """(JAX shape, port shape) pairs: n_ep, n_esp, n_mp in {1, 2, 4, 8},
    k, f, infer and sizes drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        kw = dict(B=int(rng.choice([1, 2, 8, 32])),
                  L=int(rng.choice([1, 64, 1024, 2048])),
                  M=int(rng.choice([256, 768, 2048])),
                  H=int(rng.choice([192, 768, 3072])),
                  E=int(rng.choice([8, 64, 128])),
                  k=int(rng.choice([1, 2, 8])),
                  f=float(rng.choice([0.5, 1.0, 1.2, 1.25, 2.0])),
                  n_mp=int(rng.choice(LAYOUTS)),
                  n_esp=int(rng.choice(LAYOUTS)),
                  n_ep=int(rng.choice(LAYOUTS)),
                  infer=bool(rng.rand() < 0.3))
        out.append((jperf.MoELayerShape(**kw), tperf.MoELayerShape(**kw)))
    return out


def models(seed):
    """(JAX model, port copy) pairs: the analytic model on every layout,
    both widths and both outer fabrics, plus one with hierarchical hops
    left unset (the fused fallback)."""
    rng = np.random.RandomState(seed + 100)
    out = []
    for _ in range(3):
        jm = jperf.tpu_v5e_model(int(rng.choice(LAYOUTS)),
                                 int(rng.choice(LAYOUTS)),
                                 int(rng.choice(LAYOUTS)),
                                 bytes_per_el=int(rng.choice([2, 4])),
                                 inter_pod=bool(rng.rand() < 0.5))
        out.append((jm, to_port(jm)))
    jm = dataclasses.replace(out[0][0], a2a_intra=None, a2a_inter=None)
    out.append((jm, to_port(jm)))
    return out


def test_constants_are_the_references():
    assert tperf.WIRE_DTYPES == jperf.WIRE_DTYPES
    assert tperf.WIRE_BYTES == jperf.WIRE_BYTES
    assert tperf.REDUNDANT_COMPUTE == jperf.REDUNDANT_COMPUTE


@pytest.mark.parametrize("seed", range(6))
def test_every_method_equals_jaxs(seed, monkeypatch):
    # t_decode's KV term divides by the module's HBM rate: the card's in
    # the port; the reference's here, so the two are the same function
    monkeypatch.setattr(tperf, "HBM_BW", jperf.HBM_BW)
    for jm, tm in models(seed):
        assert tm.hier_intra == tperf.AlphaBeta(*dataclasses.astuple(
            jm.hier_intra))
        for js, ts in shapes(seed):
            assert (ts.T, ts.blm, ts.etm) == (js.T, js.blm, js.etm)
            for w in WIRES:
                assert tm.wire_factor(w) == jm.wire_factor(w)
                assert tm.t_baseline(ts, w) == jm.t_baseline(js, w)
                assert tm.t_s1(ts, w) == jm.t_s1(js, w)
                assert tm.t_s2(ts, w) == jm.t_s2(js, w)
                for sch in SCHEDS:
                    assert tm._chain(ts, sch, w) == jm._chain(js, sch, w)
                    for n in (1, 2, 4, 8):
                        assert tm.t_pipelined(ts, sch, n, w) == \
                            jm.t_pipelined(js, sch, n, w)
                    assert tm.pick_chunks(ts, sch, wire_dtype=w) == \
                        jm.pick_chunks(js, sch, wire_dtype=w)
                assert tm.t_decode(ts, w, kv_bytes=3e6 * ts.B) == \
                    jm.t_decode(js, w, kv_bytes=3e6 * js.B)
            for sch in SCHEDS + ("s1d",):
                assert tm.t_ffn(ts, sch) == jm.t_ffn(js, sch)
            assert tm.algorithm1(ts) == jm.algorithm1(js)
            assert tm.pick(ts) == jm.pick(js)
            with pytest.raises(ValueError, match="unknown schedule"):
                tm._chain(ts, "s9")


@pytest.mark.parametrize("seed", range(4))
def test_plan_pricing_equals_jaxs(seed):
    """``t_plan`` and ``t_plan_stages`` (hence ``_t_stage_comm``) on the
    plans of every registered schedule, chunked and unchunked, on every
    wire, with and without a per-expert load vector."""
    rng = np.random.RandomState(seed + 7)
    names = sorted(set(j_plan.PLANS) & set(t_plan.PLANS))
    assert {"baseline", "s1", "s1g", "s2", "s2h", "s1d"} <= set(names)
    for jm, tm in models(seed)[:2]:
        for js, ts in shapes(seed, n=5):
            loads = list(rng.rand(js.E) * 10)
            for name in names:
                for n in (1, 2, 4):
                    jp = j_plan.plan_for_shape(name, js, n)
                    tp = t_plan.plan_for_shape(name, ts, n)
                    for w in WIRES:
                        for ld in (None, loads):
                            assert tm.t_plan(tp, ts, w, ld) == \
                                jm.t_plan(jp, js, w, ld), (name, n, w)
                            assert tm.t_plan_stages(tp, ts, w, ld) == \
                                jm.t_plan_stages(jp, js, w, ld)


def test_rank_imbalance_equals_jaxs():
    rng = np.random.RandomState(3)
    for _ in range(50):
        E = int(rng.choice([4, 8, 16, 6]))
        loads = list(rng.rand(E) * rng.choice([0.0, 1.0, 100.0]))
        for n_ep in (1, 2, 4, 8):
            assert tperf._rank_imbalance(loads, n_ep) == \
                jperf._rank_imbalance(loads, n_ep)


def test_fit_alpha_beta_and_speedup_table_equal_jaxs():
    rng = np.random.RandomState(5)
    for n in (1, 2, 5, 9):
        sizes = [float(x) for x in rng.rand(n) * 1e6]
        times = [float(t) for t in rng.rand(n) * 1e-3]
        assert tperf.fit_alpha_beta(sizes, times) == tperf.AlphaBeta(
            *dataclasses.astuple(jperf.fit_alpha_beta(sizes, times)))
    assert tperf.fit_alpha_beta([4, 4], [2.0, 4.0]).beta == 0.0
    for seed in range(3):
        for (jm, tm), (js, ts) in zip(models(seed), shapes(seed)):
            assert tperf.speedup_table(ts, tm) == \
                jperf.speedup_table(js, jm)


def test_doctests():
    res = doctest.testmod(tperf)
    assert res.attempted >= 10 and res.failed == 0, res


@pytest.mark.parametrize("inter_node", [False, True])
def test_h100_single_member_groups_are_free_per_element(inter_node):
    for n_ep in LAYOUTS:
        for n_esp in LAYOUTS:
            for n_mp in LAYOUTS:
                m = tperf.h100_model(n_ep, n_esp, n_mp,
                                     inter_node=inter_node)
                groups = {"a2a_ep_esp": n_ep * n_esp, "a2a_ep": n_ep,
                          "ag_esp": n_esp, "ar_esp": n_esp, "ag_mp": n_mp,
                          "overlap": n_ep * n_esp, "a2a_intra": n_esp,
                          "a2a_inter": n_ep}
                for field, g in groups.items():
                    ab = getattr(m, field)
                    assert (ab.beta == 0.0) == (g == 1), (field, g, ab)
                    assert ab.alpha > 0.0
                assert m.wire_bytes_ref == 4.0
                assert m.flops_per_s == tperf.PEAK_FLOPS_F32
    # across nodes only the EP hops slow down
    a, b = tperf.h100_model(4, 2, 2), tperf.h100_model(4, 2, 2,
                                                        inter_node=True)
    assert b.a2a_ep.beta > a.a2a_ep.beta and b.ag_mp == a.ag_mp


def test_card_fit_builds_the_model_and_needs_a_card():
    """``fit_perfmodel`` on made-up samples: the rate is 1/beta of the
    compute fit, every collective's alpha is the fitted startup times its
    data-sheet multiple, the link betas are the data sheet's; on the CPU
    the measurement refuses to run."""
    from repro_torch.launch import fit_perfmodel as fp
    flops = [6.0 * 128 * t * 2048 * 768 for t in fp.CAPACITIES]
    fits = {"flops": fp._fit(flops, [f / 4e13 + 1e-4 for f in flops]),
            "alpha": fp._fit(fp.SIZES, [7e-6 + 2e-12 * n for n in fp.SIZES])}
    assert fits["flops"]["r2"] == pytest.approx(1.0)
    assert fits["alpha"]["fit"].alpha == pytest.approx(7e-6)
    m, sheet = fp.model_from_fits(fits, 4, 2, 2), tperf.h100_model(4, 2, 2)
    assert m.flops_per_s == pytest.approx(4e13)
    for f in dataclasses.fields(sheet):
        ab = getattr(sheet, f.name)
        if isinstance(ab, tperf.AlphaBeta):
            got = getattr(m, f.name)
            assert got.beta == ab.beta
            assert got.alpha == pytest.approx(
                ab.alpha * 7e-6 / tperf.ALPHA_COLL)
    with pytest.raises(RuntimeError, match="measures the card"):
        fp.measure_card("cpu")
