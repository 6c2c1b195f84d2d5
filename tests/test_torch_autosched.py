"""The port's autoscheduler (``repro_torch.core.autosched``), the audit's
pricing and ``suggest_max_batch`` against the JAX package's on the CPU.

``decide`` must return JAX's decision — schedule, chunk count, wire,
source, and every scored candidate's time bitwise (floats ``==``) — under
the same perf model (the JAX package's own, copied field by field), over
analytic pairs, joint wire triples, forced schedules, the decode class, a
registered schedule and a late registration; the cache's identity,
invalidation counts, events and summary text are JAX's.  Measured mode
runs an injected ``measure`` in both packages, and the port's own
``measure_candidates`` on the CPU at a reduced layer, which must leave the
global RNG, the step's ``moe_call`` ordinals and the fp8 monitor as it
found them.  A measured ``apply_moe`` inside ``torch.utils.checkpoint``
must equal, forward and backward bitwise, the same layer forced to its
pick, and calibrate once.
"""

import dataclasses
import math
import os
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

jax = pytest.importorskip("jax")

from repro import obs as jobs  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import autosched as j_as  # noqa: E402
from repro.core import perfmodel as jperf  # noqa: E402
from repro.core import plan as j_plan  # noqa: E402
from repro.obs import audit as j_audit  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro.serve import suggest_max_batch as j_suggest  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import autosched as t_as  # noqa: E402
from repro_torch.core import collectives as t_coll  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.core import perfmodel as tperf  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core.collectives import CommConfig  # noqa: E402
from repro_torch.obs import audit as t_audit  # noqa: E402
from repro_torch.obs.sink import read_events  # noqa: E402
from repro_torch.serve import suggest_max_batch as t_suggest  # noqa: E402
from test_torch_perfmodel import to_port  # noqa: E402

DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))


@pytest.fixture(autouse=True)
def fresh():
    for m in (j_as, t_as):
        m.clear_cache()
    yield
    for m in (j_as, t_as):
        m.clear_cache()
    for o in (obs, jobs):
        o.close()
    trt.disable_fp8_monitor()
    trt.reset_fp8_counter()


def toy(beta=1e-9, alpha=1e-5, flops=1e12):
    """The JAX package's toy model (its own autosched tests') and the
    port's field-by-field copy."""
    ab = jperf.AlphaBeta(alpha, beta)
    jm = jperf.PerfModel(a2a_ep_esp=ab, a2a_ep=ab, ag_esp=ab, ar_esp=ab,
                         ag_mp=jperf.AlphaBeta(alpha, beta / 4), overlap=ab,
                         flops_per_s=flops)
    return jm, to_port(jm)


def shape(**kw):
    base = dict(B=4, L=1024, M=1024, H=4096, E=8, k=2, f=1.2, n_mp=2,
                n_esp=2, n_ep=2)
    base.update(kw)
    return jperf.MoELayerShape(**base), tperf.MoELayerShape(**base)


def same(td, jd):
    assert (td.schedule, td.n_chunks, td.wire_dtype, td.source,
            td.placement_epoch, td.body_name) == \
        (jd.schedule, jd.n_chunks, jd.wire_dtype, jd.source,
         jd.placement_epoch, jd.body_name)
    assert td.times == jd.times        # candidates and floats bitwise


def both(js, ts, models, **kw):
    jm, tm = models
    jd = j_as.decide(js, perf_model=jm, **kw)
    td = t_as.decide(ts, perf_model=tm, **kw)
    same(td, jd)
    return td, jd


# (shape overrides, decide kwargs)
CASES = [
    ({}, {}),
    ({"L": 64}, {}),
    ({"n_ep": 8, "n_esp": 1, "n_mp": 1}, {}),
    ({"n_ep": 1, "n_esp": 1, "n_mp": 1, "B": 8, "L": 1024}, {}),
    ({"B": 64, "L": 4096, "f": 8.0, "k": 4, "E": 4}, {}),
    ({}, {"wire_candidates": ("f32", "bf16")}),
    ({"n_ep": 4, "n_mp": 4}, {"wire_candidates": ("f32", "bf16",
                                                  "fp8_e4m3")}),
    ({}, {"schedules": ("s1",), "chunk_candidates": (2,),
          "wire_candidates": ("f32", "bf16")}),
    ({}, {"schedules": ("s2h",), "chunk_candidates": (1, 4)}),
    ({"B": 8, "L": 1, "infer": True}, {"chunk_candidates": (1,)}),
    ({"B": 8, "L": 1, "infer": True, "n_mp": 1}, {
        "chunk_candidates": (1,), "wire_candidates": ("f32", "bf16")}),
    ({"L": 512}, {"chunk_candidates": (1, 2, 3, 5)}),
]


@pytest.mark.parametrize("kw_shape,kw", CASES)
@pytest.mark.parametrize("model", ["toy", "compute", "analytic"])
def test_analytic_decision_is_jaxs(kw_shape, kw, model):
    js, ts = shape(**kw_shape)
    models = {"toy": lambda: toy(),
              "compute": lambda: toy(beta=1e-12, alpha=1e-7, flops=1e11),
              "analytic": lambda: (jperf.tpu_v5e_model(
                  js.n_ep, js.n_esp, js.n_mp), to_port(
                  jperf.tpu_v5e_model(js.n_ep, js.n_esp, js.n_mp)))}[model]()
    td, jd = both(js, ts, models, **kw)
    assert td.source == "analytic" and len(td.times) == len(jd.times)
    if ts.infer and "schedules" not in kw:
        assert any(c[0] == "s1d" for c, _ in td.times)


def test_registered_and_late_schedules_join_the_grid():
    models = toy()
    js, ts = shape()
    d1, _ = both(js, ts, models)
    assert not any(c[0] == "s1_late" for c, _ in d1.times)
    for pl in (j_plan, t_plan):
        pl.register_plan("s1_late", lambda i, pl=pl: pl.PLANS["s1"].builder(
            i), analytic=True, measured=True)
    try:
        d2, _ = both(js, ts, models)
        assert any(c[0] == "s1_late" for c, _ in d2.times) and d2 is not d1
        js2, ts2 = shape(L=512)
        d3, _ = both(js2, ts2, models, mode="measured",
                     measure=lambda cands: {c: 1.0 for c in cands})
        assert any(c[0] == "s1_late" for c, _ in d3.times)
    finally:
        for pl in (j_plan, t_plan):
            pl.PLANS.pop("s1_late", None)


def _times(cands):
    """A deterministic stand-in calibration: distinct seconds per
    candidate, the same in both packages."""
    return {c: 1e-3 * (1 + (sum(map(ord, repr(c))) % 97) / 97) for c in cands}


@pytest.mark.parametrize("kw_shape,kw", [
    ({}, {}), ({}, {"wire_candidates": ("f32", "bf16")}),
    ({"B": 8, "L": 1, "infer": True}, {"chunk_candidates": (1,)}),
    ({}, {"schedules": ("s2",), "chunk_candidates": (2,),
          "wire_candidates": ("f32", "bf16", "fp8_e4m3")})])
def test_measured_decision_is_jaxs_and_cached(kw_shape, kw):
    js, ts = shape(**kw_shape)
    calls = []

    def measure(cands):
        calls.append(list(cands))
        return _times(cands)
    td, jd = both(js, ts, toy(), mode="measured", measure=measure, **kw)
    assert td.source == "measured" and len(calls) == 2
    assert calls[0] == calls[1]       # the same candidate grid, in order
    assert t_as.decide(ts, perf_model=toy()[1], mode="measured",
                       measure=measure, **kw) is td
    assert len(calls) == 2
    with pytest.raises(ValueError, match="measure"):
        t_as.decide(*shape(L=7)[1:], mode="measured")
    with pytest.raises(ValueError, match="unknown autosched mode"):
        t_as.decide(ts, mode="sometimes")


def test_measured_entries_are_kept_per_device():
    _, ts = shape()

    def on(dev, t):
        def m(cands):
            return {c: t for c in cands}
        m.device = dev
        return m
    a = t_as.decide(ts, mode="measured", measure=on("cpu", 1.0))
    b = t_as.decide(ts, mode="measured", measure=on("cuda:0", 2.0))
    assert a is not b and len(t_as.cache_info()) == 2
    assert t_as.decide(ts, mode="measured", measure=on("cpu", 3.0)) is a


def test_cache_invalidate_hooks_events_and_summary_are_jaxs(tmp_path):
    models = toy()
    shapes = [shape(), shape(L=512), shape(B=8, L=1, infer=True)]
    seen = {"jax": [], "port": []}
    hooks = {"jax": lambda r, n: seen["jax"].append((r, n)),
             "port": lambda r, n: seen["port"].append((r, n))}
    j_as.add_invalidation_hook(hooks["jax"])
    t_as.add_invalidation_hook(hooks["port"])
    try:
        for o, name in ((jobs, "jax"), (obs, "port")):
            o.configure(os.path.join(tmp_path, name), meta={"k": name})
        for js, ts in shapes:
            both(js, ts, models)
            both(js, ts, models, wire_candidates=("f32", "bf16"))
        d = t_as.decide(shapes[0][1], perf_model=models[1])
        assert d is t_as.decide(shapes[0][1], perf_model=models[1])
        assert t_as.cache_summary() == j_as.cache_summary()
        keys = set(t_as.cache_info())
        assert t_as.cache_summary(exclude=keys) == ""
        # a new placement epoch marks every line stale, in both
        assert t_as.set_placement(None) == j_as.set_placement(None) == 1
        assert t_as.placement_epoch() == 1 and t_as.current_placement() \
            is None
        assert "STALE" in t_as.cache_summary()
        assert t_as.cache_summary() == j_as.cache_summary()
        n = (t_as.invalidate("one shape", shape=shapes[1][1]),
             j_as.invalidate("one shape", shape=shapes[1][0]))
        assert n == (2, 2)
        assert t_as.invalidate("all") == j_as.invalidate("all") == 4
        assert t_as.invalidate("again") == j_as.invalidate("again") == 0
        assert seen["port"] == seen["jax"] == [
            ("one shape", 2), ("all", 4), ("again", 0)]
        paths = {}
        for o, name in ((jobs, "jax"), (obs, "port")):
            paths[name] = o.get_sink().paths
            o.close()
        evs = {name: [{k: v for k, v in e.items() if k not in ("t", "seq")}
                      for e in read_events(p) if e["event"] != "meta"]
               for name, p in paths.items()}
        assert evs["port"] == evs["jax"]
        names = [e["event"] for e in evs["port"]]
        assert names.count("autosched_decision") == 6
        assert names.count("autosched_invalidate") == 3
        assert names.count("placement_epoch") == 1
    finally:
        j_as.remove_invalidation_hook(hooks["jax"])
        t_as.remove_invalidation_hook(hooks["port"])
    t_as.decide(shapes[0][1])
    t_as.clear_cache()
    assert t_as.cache_info() == {} and t_as.placement_epoch() == 0
    assert t_as.WIRE_BYTES == jperf.WIRE_BYTES
    assert (t_as.DEFAULT_CHUNKS, t_as.DEFAULT_WIRE, t_as.AUTO_WIRE) == \
        (j_as.DEFAULT_CHUNKS, j_as.DEFAULT_WIRE, j_as.AUTO_WIRE)


def _reduced_layer(wire="f32"):
    cfg = get_config("qwen3-moe-30b-a3b").reduced().moe
    return replace(cfg, comm=CommConfig(wire_dtype=wire))


@pytest.mark.parametrize("wire", [("f32", "bf16"), ("fp8_e4m3",)])
def test_measure_candidates_leaves_the_callers_state(wire):
    """Every candidate finite; the global RNG, the step's ``moe_call``
    ordinals and the fp8 monitor (its callable and its counts) as they
    were, with an fp8 wire candidate too."""
    cfg = _reduced_layer()
    trt.enable_fp8_monitor()
    monitor = t_coll._FP8_MONITOR
    obs.set_context(step=3)
    tmoe._CALLS.update(step=3, n=5)
    rng = torch.get_rng_state()
    measure = t_as.measure_candidates(cfg, tokens=32, d_model=cfg.d_model,
                                      device="cpu")
    cands = [(s, n, w) for s in ("s1", "s1g", "s2", "baseline")
             for n in (1, 2) for w in wire]
    try:
        out = measure(cands)
    finally:
        obs.set_context(step=None)
    assert set(out) == set(cands)
    assert all(math.isfinite(t) and t > 0 for t in out.values()), out
    assert torch.equal(torch.get_rng_state(), rng)
    assert tmoe._CALLS == {"step": 3, "n": 5}
    assert t_coll._FP8_MONITOR is monitor
    assert trt.fp8_sat_counts() == (0, 0)
    assert measure.device == "cpu"


def test_measured_apply_moe_under_checkpoint_is_its_forced_pick():
    """``apply_moe(autosched="measured")`` inside an activation-
    checkpointed function: one calibration (the recompute hits the
    cache), forward and gradients bitwise those of the same layer forced
    to the decision's (schedule, chunks, wire), and the same ``moe_call``
    ordinals."""
    base = _reduced_layer("auto")
    measured = replace(base, autosched="measured")
    g = torch.Generator().manual_seed(0)
    params = tmoe.init_moe_params(g, base)
    x0 = torch.randn((2, 16, base.d_model), generator=g)
    runs = []
    real = t_as.measure_candidates

    def counting(*a, **k):
        run = real(*a, **k)

        def wrapped(cands):
            runs.append(len(cands))
            return run(cands)
        wrapped.device = run.device
        return wrapped

    def run(cfg):
        tmoe._CALLS.update(step=None, n=0)
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        x = x0.clone().requires_grad_(True)

        def layer(x, *leaves):
            y, aux = tmoe.apply_moe(x, dict(zip(p, leaves)), cfg=cfg)
            return y, aux["aux_loss"]
        rng = torch.get_rng_state()
        y, aux = checkpoint(layer, x, *p.values(), use_reentrant=False)
        loss = (y * y).sum() + aux
        grads = torch.autograd.grad(loss, [x, *p.values()])
        assert torch.equal(torch.get_rng_state(), rng)
        return y.detach(), grads, dict(tmoe._CALLS)

    mp = pytest.MonkeyPatch()
    mp.setattr(t_as, "measure_candidates", counting)
    try:
        obs.set_context(step=0)
        got = run(measured)
        assert len(runs) == 1 and runs[0] > 1
        (key, d), = t_as.cache_info().items()
        assert key[1] == "measured" and key[-1] == "cpu"
        forced = replace(base, schedule=d.schedule,
                         pipeline_chunks=d.n_chunks,
                         comm=CommConfig(wire_dtype=d.wire_dtype))
        want = run(forced)
        assert len(runs) == 1
    finally:
        mp.undo()
        obs.set_context(step=None)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    # moe_call 0 (the forward) and 1 (the recompute), the calibration's
    # own calls not counted
    assert got[2] == want[2] == {"step": 0, "n": 2}


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "gpt2-moe",
                                  "qwen3-moe-30b-a3b-reduced", "dense"])
def test_suggest_max_batch_is_jaxs(arch, monkeypatch):
    monkeypatch.setattr(tperf, "HBM_BW", jperf.HBM_BW)
    name = arch.removesuffix("-reduced").replace("dense",
                                                 "qwen3-moe-30b-a3b")
    jcfg, tcfg = j_get_config(name), get_config(name)
    if arch.endswith("-reduced"):
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    if arch == "dense":
        jcfg, tcfg = replace(jcfg, moe=None), replace(tcfg, moe=None)
    picks = set()
    for n_ep, n_esp, n_mp in ((1, 1, 1), (4, 2, 1), (8, 1, 2)):
        jm = jperf.tpu_v5e_model(n_ep, n_esp, n_mp)
        for cands in ((1, 2, 4, 8, 16, 32), (3, 5, 64), (8,)):
            for n_blocks in (None, 4, 64, 1024):
                for mean_len in (None, 40.0, 300):
                    kw = dict(n_ep=n_ep, n_esp=n_esp, n_mp=n_mp,
                              candidates=cands, n_blocks=n_blocks,
                              block_size=16, mean_len=mean_len)
                    want = j_suggest(jcfg, perf_model=jm, **kw)
                    assert t_suggest(tcfg, perf_model=to_port(jm),
                                     **kw) == want, kw
                    picks.add(want)
    assert len(picks) > 1


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_audit_prices_jaxs_plans(wire):
    """``run_schedule_audit``'s predicted column and total are JAX's
    ``t_plan_stages`` and ``t_plan`` of the same plan (the measured column
    is the CPU's clock here: only its schema is checked)."""
    jcfg = j_get_config("qwen3-moe-30b-a3b").reduced().moe
    jcfg = replace(jcfg, comm=replace(jcfg.comm, wire_dtype=wire))
    tcfg = _reduced_layer(wire)
    tokens = 64
    jm = jperf.tpu_v5e_model(1, 1, 1)
    reports = t_audit.run_schedule_audit(tcfg, tokens, perf_model=to_port(jm),
                                         iters=1, warmup=0, device="cpu")
    h = j_audit._LayerHarness(make_mesh((1, 1), ("data", "model")), DIMS,
                              jcfg, tokens)
    assert dataclasses.asdict(h.shape) == dataclasses.asdict(
        t_audit._LayerHarness(tcfg, tokens).shape)
    assert [r["schedule"] for r in reports] == list(
        j_audit.DEFAULT_AUDIT_SCHEDULES) == list(
        t_audit.DEFAULT_AUDIT_SCHEDULES)
    for rep in reports:
        jplan = j_plan.build_plan(rep["schedule"], h.info(1), n_chunks=1)
        pred = jm.t_plan_stages(jplan, h.shape, wire_dtype=h.wire)
        assert {s["name"]: s["predicted_s"] for s in rep["stages"]} == pred
        assert rep["total_predicted_s"] == jm.t_plan(jplan, h.shape,
                                                     wire_dtype=h.wire)
        assert rep["calibration"]["time_scale"] == \
            rep["total_measured_s"] / rep["total_predicted_s"]
        for s in rep["stages"]:
            assert (s["rel_err"] is None) == (s["predicted_s"] == 0.0)
        assert set(rep["worst"]) == {s["name"] for s in rep["stages"]
                                     if s["rel_err"] is not None}


def test_select_schedule_matches_decide():
    cfg = _reduced_layer()
    _, ts = shape(n_ep=1, n_esp=1, n_mp=1)
    assert tmoe.select_schedule(cfg, ts) == t_as.decide(ts).schedule
    assert tmoe.select_schedule(replace(cfg, schedule="s2"), ts) == "s2"


def test_wire_auto_resolves_through_decide_and_the_ceiling():
    """``wire_dtype="auto"`` takes the decision's wire; a forced schedule
    with an ``"auto"`` wire decides the wire alone; the ceiling clamps
    after both (an fp8 config under a bf16 ceiling runs bf16)."""
    cfg = _reduced_layer("auto")
    assert tmoe.resolve_schedule(cfg, B=2, L=16) == ("s1g", 1, "f32")
    assert tmoe.resolve_schedule(cfg, "s1", B=2, L=16) == ("s1", 1, "f32")
    (key, d), = [kv for kv in t_as.cache_info().items()
                 if kv[0][5] == ("s1",)]
    assert key[4] == t_as.AUTO_WIRE and d.times[0][0][2] == "f32"
    t_as.set_wire_ceiling("bf16")
    try:
        assert tmoe.resolve_schedule(_reduced_layer("fp8_e4m3"), B=2,
                                     L=16) == ("s1g", 1, "bf16")
    finally:
        t_as.set_wire_ceiling(None)
    with pytest.raises(ValueError, match="unknown autosched mode"):
        tmoe.resolve_schedule(replace(cfg, autosched="guess"), B=2, L=16)
    assert np.isfinite(d.times[0][1])
