"""The port's copy of the plan IR (``repro_torch.core.plan``) against the
JAX package's (``repro.core.plan``): every registered schedule, unchunked
and split into 2 and 4 capacity chunks, under each wire format, gives the
same ``plan_summary`` and ``format_plan``; the registries hold the same
schedules with the same flags; and ``fuse_grouped``'s local form (``s1g``
on one rank) is the same single stage."""

import pytest

jax = pytest.importorskip("jax")

from repro.core import plan as jplan  # noqa: E402
from repro.core.collectives import CommConfig as JComm  # noqa: E402
from repro.core.gating import GateConfig as JGate  # noqa: E402
from repro.core.schedules import MoEShardInfo as JInfo  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.collectives import CommConfig as TComm  # noqa: E402
from repro_torch.core.gating import GateConfig as TGate  # noqa: E402
from repro_torch.core.schedules import MoEShardInfo as TInfo  # noqa: E402


def _infos(n_ep, n_esp, n_mp, wire):
    kw = dict(ep_axes=("data",), esp_axes=("model",), mp_axes=("model",),
              n_ep=n_ep, n_esp=n_esp, n_mp=n_mp, tokens=64, cap=32)
    return (JInfo(gate=JGate(n_experts=8, top_k=2),
                  comm=JComm(wire_dtype=wire), **kw),
            TInfo(gate=TGate(n_experts=8, top_k=2),
                  comm=TComm(wire_dtype=wire), **kw))


def test_same_registry():
    assert sorted(tplan.PLANS) == sorted(jplan.PLANS)
    for name, entry in jplan.PLANS.items():
        t = tplan.PLANS[name]
        assert (t.analytic, t.measured, t.decode_only) == \
            (entry.analytic, entry.measured, entry.decode_only), name
    for infer in (False, True):
        assert tplan.analytic_schedules(infer) == \
            jplan.analytic_schedules(infer)
        assert tplan.measured_schedules(infer) == \
            jplan.measured_schedules(infer)


@pytest.mark.parametrize("wire", ["f32", "bf16", "fp8_e4m3"])
@pytest.mark.parametrize("n_chunks", [1, 2, 4])
@pytest.mark.parametrize("layout", [(1, 1, 1), (2, 2, 2)])
def test_plan_summary_and_format_match_jax(layout, n_chunks, wire):
    jinfo, tinfo = _infos(*layout, wire)
    for name in sorted(jplan.PLANS):
        jp = jplan.build_plan(name, jinfo, n_chunks=n_chunks)
        tp = tplan.build_plan(name, tinfo, n_chunks=n_chunks)
        assert tplan.plan_summary(tp) == jplan.plan_summary(jp), name
        assert tplan.format_plan(tp) == jplan.format_plan(jp), name
        assert [s.name for s in tplan.validate(tp)] == \
            [s.name for s in jplan.validate(jp)], name


def test_s1g_is_one_fused_stage_on_one_rank():
    _, tinfo = _infos(1, 1, 1, "f32")
    p = tplan.build_plan("s1g", tinfo, n_chunks=4)
    kinds = [s.kind for s in p.stages]
    assert kinds == ["mp_split", "gate", "expert_ffn_grouped", "ag_mp"]
    assert p.n_chunks == 1
