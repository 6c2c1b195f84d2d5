"""The port's telemetry on the CPU against the JAX package: the JSONL sink
(a copy) and the ``obs`` facade; the event streams a served run and a
faulted training run write, beside JAX's; the fp8 saturation events per
step; ``execute_prefix``'s probe at every stage count; the Chrome-trace
export and the audit join of one ``StageTrace``; and that timing a plan's
stages leaves the layer's output bitwise as it was.

Tolerances: ``execute_prefix``'s probe 1e-5 relative to JAX's (sums of
f32 stage outputs computed by the two frameworks); a guard event's
saturation rate 1e-2 (as ``test_torch_runtime.py``).  Event names, order,
request ids, statuses, reasons, token counts and every counter must be
equal; the timing fields (``t`` and each ``*_s``) are not compared.
"""

import dataclasses
import json
import math
import os
from collections import Counter

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import autosched as j_autosched  # noqa: E402
from repro.core import collectives as j_coll  # noqa: E402
from repro.core import executor as j_executor  # noqa: E402
from repro.core import plan as j_plan  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.obs import audit as j_audit  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import autosched as t_autosched  # noqa: E402
from repro_torch.core import collectives as t_coll  # noqa: E402
from repro_torch.core import executor  # noqa: E402
from repro_torch.core import plan as planlib  # noqa: E402
from repro_torch.core.moe import apply_moe, layer_info  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import audit, trace  # noqa: E402
from repro_torch.obs.sink import JsonlSink, read_events  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.runtime import FaultPlan  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from test_torch_runtime import FAULTED, _trainers  # noqa: E402

DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
CHAOS = ("req_timeout@rid=1,ticks=3;req_delay@rid=2,rounds=999;"
         "alloc_starve@tick=1,hold=9999,rounds=4")
ENGINE_EVENTS = ("req_queued", "req_admitted", "req_prefilled", "req_shed",
                 "req_cancelled", "decode_round", "req_finished",
                 "serve_rollup")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: its tensors here are small,
    and beside other test processes a thread pool per process only
    contends for the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean():
    """No sink, no context and no fp8 monitor, injection or ceiling in
    either package around every test."""
    def reset():
        for o in (obs, jobs):
            o.close()
        for coll, sched, rt in ((j_coll, j_autosched, jrt),
                                (t_coll, t_autosched, trt)):
            coll.set_fp8_sat_injection(0.0)
            sched.set_wire_ceiling(None)
            rt.disable_fp8_monitor()
            rt.reset_fp8_counter()
            sched.clear_cache()
    reset()
    yield
    reset()


# --- the sink (a copy) and the facade -----------------------------------------

class TestJsonlSink:
    def test_round_trip_with_meta_header(self, tmp_path):
        with JsonlSink(tmp_path, meta={"arch": "x", "mesh": [4, 2]}) as s:
            s.emit("a", v=1)
            s.emit("b", v=2.5, tag="t")
        evs = read_events(s.paths)
        assert [e["event"] for e in evs] == ["meta", "a", "b"]
        assert evs[0]["arch"] == "x" and evs[0]["mesh"] == [4, 2]
        assert evs[1]["v"] == 1 and evs[2]["tag"] == "t"
        assert [e["seq"] for e in evs] == [0, 1, 2]
        assert all(e["t"] >= 0.0 for e in evs)

    def test_rotation_recarries_header_and_global_seq(self, tmp_path):
        s = JsonlSink(tmp_path, meta={"run": "r"}, rotate_bytes=256,
                      buffer_events=1)
        for i in range(20):
            s.emit("tick", i=i)
        s.close()
        assert len(s.paths) > 1
        for p in s.paths:
            first = json.loads(open(p).readline())
            assert first["event"] == "meta" and first["run"] == "r"
        evs = read_events(s.paths)
        seqs = [e["seq"] for e in evs]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
        assert [e["i"] for e in evs if e["event"] == "tick"] == \
            list(range(20))

    def test_reserved_keys_win_on_collision(self, tmp_path):
        with JsonlSink(tmp_path, meta={"seq": 999, "kind": "k"}) as s:
            s.emit("e", seq=888, t=-1.0, ok=1)
        evs = read_events(s.paths)
        assert evs[0]["seq"] == 0 and evs[0]["kind"] == "k"
        assert evs[1]["event"] == "e" and evs[1]["seq"] == 1
        assert evs[1]["t"] >= 0.0 and evs[1]["ok"] == 1

    def test_numpy_and_cpu_torch_scalars_coerced(self, tmp_path):
        with JsonlSink(tmp_path) as s:
            s.emit("e", a=np.float32(1.5), b=np.int64(3),
                   c=np.array([1, 2]), d=torch.tensor(2.5),
                   f=torch.tensor([4, 5]), g={"k": torch.tensor(7)})
        e = read_events(s.paths)[1]
        assert (e["a"], e["b"], e["c"]) == (1.5, 3, [1, 2])
        assert (e["d"], e["f"], e["g"]) == (2.5, [4, 5], {"k": 7})

    def test_a_tensor_on_the_card_is_refused(self, tmp_path):
        class OnCard:
            is_cuda = True

            def item(self):
                raise AssertionError("read a card tensor")

        with JsonlSink(tmp_path) as s:
            with pytest.raises(TypeError, match="on the card"):
                s.emit("e", x=OnCard())

    def test_emit_after_close_is_noop(self, tmp_path):
        s = JsonlSink(tmp_path)
        s.close()
        s.emit("late")
        assert len(read_events(s.paths)) == 1


class _Bomb:
    """A field the sink would have to read: any read fails the test."""

    def __float__(self):
        raise AssertionError("a field was read with no sink installed")

    item = tolist = __int__ = __float__


class TestFacade:
    def test_unconfigured_touches_no_field(self):
        assert not obs.enabled()
        obs.emit("anything", x=_Bomb(), y=[_Bomb()])
        obs.flush()

    def test_configure_emit_close(self, tmp_path):
        obs.configure(tmp_path, meta={"kind": "t"})
        assert obs.enabled()
        obs.emit("e", v=1)
        paths = obs.get_sink().paths
        obs.close()
        assert not obs.enabled()
        assert [e["event"] for e in read_events(paths)] == ["meta", "e"]

    def test_runtime_context_merged_and_cleared(self, tmp_path):
        obs.configure(tmp_path)
        obs.set_context(step=3, run="r")
        obs.emit("a")
        obs.set_context(run=None)          # None removes the key
        obs.emit("b", step=9)              # explicit field wins
        paths = obs.get_sink().paths
        obs.close()
        a, b = [e for e in read_events(paths) if e["event"] in "ab"]
        assert a["step"] == 3 and a["run"] == "r"
        assert b["step"] == 9 and "run" not in b

    def test_close_clears_context(self, tmp_path):
        obs.configure(tmp_path)
        obs.set_context(step=1)
        obs.close()
        obs.configure(tmp_path)
        obs.emit("e")
        paths = obs.get_sink().paths
        obs.close()
        assert "step" not in read_events(paths)[-1]

    def test_trace_tag_nests_and_restores(self):
        assert obs.trace_context() == {}
        with obs.trace_tag(moe_call=1, schedule="s1"):
            assert obs.trace_context() == {"moe_call": 1, "schedule": "s1"}
            with obs.trace_tag(schedule="s2"):
                assert obs.trace_context()["schedule"] == "s2"
                assert obs.trace_context()["moe_call"] == 1
            assert obs.trace_context()["schedule"] == "s1"
        assert obs.trace_context() == {}

    def test_event_context_merges_both_planes(self):
        obs.set_context(step=4, schedule="rt")
        with obs.trace_tag(schedule="s1g", moe_call=0):
            assert obs.event_context() == {"step": 4, "schedule": "s1g",
                                           "moe_call": 0}
        assert obs.event_context() == {"step": 4, "schedule": "rt"}


# --- the event streams beside JAX's -------------------------------------------

def _plain_fields(monkeypatch):
    """Make the sink refuse any field that is not a plain host value: what
    the engine and the loops emit must cost no read of a tensor."""
    plain = (type(None), bool, int, float, str)
    emit = JsonlSink.emit

    def checked(self, event, **fields):
        def ok(v):
            if isinstance(v, (list, tuple)):
                return all(ok(x) for x in v)
            if isinstance(v, dict):
                return all(ok(x) for x in v.values())
            return isinstance(v, plain)
        bad = {k: type(v) for k, v in fields.items() if not ok(v)}
        assert not bad, (event, bad)
        return emit(self, event, **fields)

    monkeypatch.setattr(JsonlSink, "emit", checked)


def _untimed(events, names=None):
    """The events without the meta header and without their timing
    fields."""
    out = []
    for e in events:
        if e["event"] == "meta" or (names and e["event"] not in names):
            continue
        out.append({k: v for k, v in e.items()
                    if k not in ("t", "seq") and not k.endswith("_s")
                    and not k.startswith(("latency_s.", "ttft_s."))})
    return out


def _recorded(o, tmp_path, name, fn):
    o.configure(os.path.join(tmp_path, name), meta={"kind": name})
    try:
        out = fn()
        paths = o.get_sink().paths
    finally:
        o.close()
    return out, read_events(paths)


def test_served_event_stream_is_jaxs(tmp_path, monkeypatch):
    """The chaos plan served with a sink in both packages: the same events
    in the same order with the same request ids, statuses, reasons, token
    counts, decode-round rows and rollup counters."""
    _plain_fields(monkeypatch)
    jcfg = j_get_config("qwen3-moe-30b-a3b").reduced()
    tcfg = get_config("qwen3-moe-30b-a3b").reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, tcfg.vocab_size, 6) for _ in range(4)]
    kw = dict(max_batch=4, max_len=64, prefix_cache=False,
              watchdog_rounds=5)

    def serve(engine, params):
        for p in prompts:
            engine.submit(p, 6)
        return engine, engine.run(params)

    mesh = make_mesh((1, 1), ("data", "model"))
    (jeng, jdone), jevs = _recorded(jobs, tmp_path, "jax", lambda: serve(
        JEngine(jmodel, mesh, DIMS, faults=jrt.FaultPlan.parse(CHAOS), **kw),
        jparams))
    (eng, done), evs = _recorded(obs, tmp_path, "port", lambda: serve(
        Engine(Model(tcfg, device="cpu"), faults=FaultPlan.parse(CHAOS),
               **kw), tparams))
    assert [c.status for c in done] == [c.status for c in jdone]
    # the same events, and the autoscheduler's decisions field for field
    # (JAX makes them while tracing, the port on first use: order aside)
    assert {e["event"] for e in evs} == {e["event"] for e in jevs}
    decisions = [sorted(json.dumps(e, sort_keys=True)
                        for e in _untimed(es, ("autosched_decision",)))
                 for es in (evs, jevs)]
    assert decisions[0] == decisions[1] and decisions[0]
    assert _untimed(evs, ENGINE_EVENTS) == _untimed(jevs, ENGINE_EVENTS)
    names = Counter(e["event"] for e in evs)
    assert names["decode_round"] == eng.stats["decode_calls"]
    assert names["req_cancelled"] == 2 and names["serve_rollup"] == 1
    per_rid = {}
    for e in evs:
        if e["event"].startswith("req_"):
            per_rid.setdefault(e["rid"], []).append(e["event"])
    for rid in (0, 3):
        assert per_rid[rid] == ["req_queued", "req_admitted",
                                "req_prefilled", "req_finished"]
    roll = [e for e in evs if e["event"] == "serve_rollup"][0]
    lats = sorted(e["latency_s"] for e in evs
                  if e["event"] == "req_finished")
    assert roll["latency_s.p50"] == obs.quantile(lats, 50)
    assert roll["latency_s.count"] == 2


def _guard_events(events):
    out = []
    for e in events:
        if e["event"] in ("guard_skip", "guard_rollback", "fp8_fallback"):
            out.append({k: v for k, v in e.items()
                        if k not in ("t", "seq", "invalidated")})
    return out


@pytest.mark.parametrize("plan", list(FAULTED))
def test_guard_events_are_jaxs(tmp_path, monkeypatch, plan):
    """``tests/test_torch_runtime.py``'s faulted gpt2-moe runs with a sink
    in both packages: the same guard events (each with its step, streak,
    LR scale, restored step and rollback loss; the fallback's saturation
    rate within 1e-2), and one ``train_step`` event per history row."""
    _plain_fields(monkeypatch)
    spec, steps, every, wire, _, _, _ = FAULTED[plan]
    (jtr, jp, jo, jdata), (tr, tp, to, tdata) = _trainers(
        "gpt2-moe", tmp_path, spec, steps, moe_kw={"wire_dtype": wire},
        schedule="s1g", ckpt_retain=2)
    _, jevs = _recorded(jobs, tmp_path, "jax", lambda: jtr.run(
        jp, jo, jdata, steps, log_every=1, ckpt_every=every))
    _, evs = _recorded(obs, tmp_path, "port", lambda: tr.run(
        tp, to, tdata, steps, log_every=1, ckpt_every=every))
    got, want = _guard_events(evs), _guard_events(jevs)
    assert [e["event"] for e in got] == [e["event"] for e in want]
    assert Counter(e["event"] for e in got)["guard_rollback"] == 1
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            if k == "sat_rate":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-2)
            elif k == "loss" and math.isnan(b[k]):
                assert math.isnan(a[k])
            else:
                assert a[k] == b[k], (a, b)
    steps_of = [[e["step"] for e in es if e["event"] == "train_step"]
                for es in (evs, jevs)]
    assert steps_of[0] == steps_of[1] == list(range(steps))
    # the saturated encodes up to the fallback's step (JAX's own fallback
    # never takes effect, so its later steps go on encoding fp8), above
    # the ~1e-4 of elements the port counts where a row's amax element
    # lands one ulp over 448 (ROADMAP: settled against jitted JAX).  The
    # port's backward encodes carry their forward's call tags; JAX's are
    # traced outside ``apply_moe``'s tag and carry none.
    last = min([e["step"] for e in got if e["event"] == "fp8_fallback"],
               default=steps)
    sat = [sorted((e["step"], e["sat"], e["total"]) for e in es
                  if e["event"] == "fp8_sat" and e["step"] <= last
                  and e["sat"] > 1e-3 * e["total"])
           for es in (evs, jevs)]
    assert sat[0] == sat[1]
    assert bool(sat[0]) == (wire == "fp8_e4m3")
    assert all(e["moe_call"] == 0 and e["schedule"] == "s1g"
               and e["wire"] == wire for e in evs
               if e["event"] == "fp8_sat")


def test_fp8_sat_events_per_step_are_jaxs(tmp_path, monkeypatch):
    """Plain training (no guards) of reduced qwen3 under ``s1g`` on the
    fp8 wire with every encode's scale shrunk 64x: each step's
    ``fp8_sat`` events, equal in number to JAX's, each with the element
    count of its encode, tagged with the step, the MoE call, the schedule
    and the wire."""
    _plain_fields(monkeypatch)
    steps = 3
    jcfg = j_get_config("qwen3-moe-30b-a3b").reduced()
    tcfg = get_config("qwen3-moe-30b-a3b").reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, comm=j_coll.CommConfig(wire_dtype="fp8_e4m3")))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, comm=t_coll.CommConfig(wire_dtype="fp8_e4m3")))
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=steps)
    data = dict(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=4)
    jtr = JTrainer(build_model(jcfg), make_mesh((1, 1), ("data", "model")),
                   DIMS, j_adamw.AdamWConfig(**opt), schedule="s1g")
    tr = Trainer(Model(tcfg, device="cpu"), t_adamw.AdamWConfig(**opt),
                 schedule="s1g")
    j_coll.set_fp8_sat_injection(64.0)
    t_coll.set_fp8_sat_injection(64.0)

    jp, jo = jtr.setup(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")

    def jrun():
        jtr.run(jp, jo, JSyntheticLM(JDataConfig(**data)), steps,
                log_every=1)
        jax.effects_barrier()

    _, jevs = _recorded(jobs, tmp_path, "jax", jrun)
    _, evs = _recorded(obs, tmp_path, "port", lambda: tr.run(
        tp, t_adamw.adamw_init(tp), SyntheticLM(DataConfig(**data)), steps,
        log_every=1))
    sat = [e for e in evs if e["event"] == "fp8_sat"]
    jsat = [e for e in jevs if e["event"] == "fp8_sat"]
    assert sat
    assert Counter(e["step"] for e in sat) == \
        Counter(e["step"] for e in jsat)
    assert sorted((e["step"], e["total"]) for e in sat) == \
        sorted((e["step"], e["total"]) for e in jsat)
    assert all(e["wire"] == "fp8_e4m3" and e["schedule"] == "s1g"
               and e["moe_call"] in (0, 1) and e["sat"] > 0 for e in sat)
    # the plain loop read every pending count on its logged rows and took
    # its monitor down again
    assert not trt.guards._SAT_EVENTS and t_coll._FP8_MONITOR is None


# --- stage traces ---------------------------------------------------------------

@pytest.mark.parametrize("sched", ["s1", "s1g"])
def test_execute_prefix_is_jaxs(sched):
    """At every stage count k the port's probe is within 1e-5 of JAX's, on
    the same operands, and the stages are JAX's in its validated order."""
    jcfg = j_get_config("qwen3-moe-30b-a3b").reduced().moe
    tcfg = get_config("qwen3-moe-30b-a3b").reduced().moe
    tokens = 64
    mesh = make_mesh((1, 1), ("data", "model"))
    h = j_audit._LayerHarness(mesh, DIMS, jcfg, tokens)
    jinfo = h.info(1)
    jplan = j_plan.build_plan(sched, jinfo, n_chunks=1)
    info = layer_info(tcfg, tokens)
    plan = planlib.build_plan(sched, info, n_chunks=1)
    order = planlib.validate(plan)
    assert [(s.name, s.kind) for s in order] == \
        [(s.name, s.kind) for s in j_plan.validate(jplan)]
    assert info.cap == jinfo.cap
    targs = [torch.from_numpy(np.array(a)) for a in h.args]
    for k in range(len(order) + 1):
        def body(xt, wg, w1, w3_, w2, k=k):
            return j_executor.execute_prefix(jplan, xt, wg, w1, w3_, w2,
                                             jinfo, k)
        want = float(jax.jit(compat.shard_map(
            body, mesh=mesh, in_specs=h.in_specs, out_specs=P(),
            check_vma=False))(*h.args))
        with torch.no_grad():
            got = executor.execute_prefix(plan, *targs, info, k)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-5,
                                   err_msg=f"k={k}")


def _stage_traces():
    stages = (("gate", "gate", 1e-4), ("a2a_d", "dispatch_a2a", 3e-3),
              ("ffn", "expert_ffn", 2e-3), ("a2a_c", "combine_a2a", 1.9e-3))
    return (trace.StageTrace(plan="s1", schedule="s1", total_s=7e-3,
                             overhead_s=1e-4,
                             stages=[trace.StageTime(*s) for s in stages]),
            j_trace.StageTrace(plan="s1", schedule="s1", total_s=7e-3,
                               overhead_s=1e-4,
                               stages=[j_trace.StageTime(*s)
                                       for s in stages]))


def test_chrome_trace_and_audit_join_are_jaxs(tmp_path):
    t, j = _stage_traces()
    assert trace.chrome_trace_events(t) == j_trace.chrome_trace_events(j)
    path = trace.save_chrome_trace(t, os.path.join(tmp_path, "t.json"))
    doc = json.load(open(path))
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] == \
        ["gate", "a2a_d", "ffn", "a2a_c"]
    for predicted, total in (({"a2a_d": 1e-3, "ffn": 2e-3, "a2a_c": 1e-3},
                              4e-3), ({}, 0.0)):
        assert audit.audit_report(t, predicted, total) == \
            j_audit.audit_report(j, predicted, total)


@pytest.mark.parametrize("sched", ["s1", "s1g"])
def test_timing_stages_leaves_the_output_bitwise(tmp_path, sched):
    """``apply_moe`` before the stage timer, the full plan on the traced
    harness after it, and ``apply_moe`` again with a sink installed:
    ``torch.equal``.  The trace lists the plan's stages in validated
    order with non-negative times."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced().moe,
                              schedule=sched)
    h = audit._LayerHarness(cfg, 64, seed=3)
    with torch.no_grad():
        before, _ = apply_moe(h.x[None], h.params, cfg=cfg)
        st = h.trace(sched, iters=2, warmup=1)
        full, _ = executor.execute(planlib.build_plan(sched, h.info()),
                                   *h.args, h.info())
        obs.configure(tmp_path)
        after, _ = apply_moe(h.x[None], h.params, cfg=cfg)
        obs.close()
    assert torch.equal(before[0], full) and torch.equal(before, after)
    order = planlib.validate(planlib.build_plan(sched, h.info()))
    assert [s.name for s in st.stages] == [s.name for s in order]
    assert st.plan == sched and st.total_s > 0
    assert all(s.measured_s >= 0 for s in st.stages)


# --- the launchers' telemetry ---------------------------------------------------

def test_train_launcher_writes_jaxs_record(tmp_path, capsys):
    from repro_torch.launch.train import main
    mdir, log = os.path.join(tmp_path, "m"), os.path.join(tmp_path, "l.json")
    main(["--arch", "gpt2-moe", "--reduced", "--device", "cpu", "--steps",
          "3", "--seq", "32", "--batch", "2", "--guards", "--metrics-dir",
          mdir, "--trace", "--log-json", log])
    assert "stage trace (s1, " in capsys.readouterr().out
    rec = json.load(open(log))
    assert set(rec) == {"history", "obs", "guards", "guard_events",
                        "lr_scale"}
    assert [h["step"] for h in rec["history"]] == [0, 2]
    assert rec["guards"]["steps"] == 3 and rec["guard_events"] == []
    assert rec["obs"]["trace_file"].endswith("trace_s1.json")
    evs = read_events(rec["obs"]["metrics_files"])
    assert [e["event"] for e in evs] == ["meta", "autosched_decision",
                                         "train_step", "expert_load",
                                         "train_step", "expert_load",
                                         "stage_trace"]
    doc = json.load(open(rec["obs"]["trace_file"]))
    assert any(e["ph"] == "X" for e in doc["traceEvents"])


def test_serve_launcher_writes_jaxs_record(tmp_path, capsys):
    from repro_torch.launch.serve import main
    mdir, log = os.path.join(tmp_path, "m"), os.path.join(tmp_path, "l.json")
    main(["--arch", "qwen3-moe-30b-a3b", "--reduced", "--device", "cpu",
          "--smoke", "--requests", "3", "--deadline", "60",
          "--queue-slo", "60", "--watchdog-rounds", "6", "--metrics-dir",
          mdir, "--trace", "--log-json", log])
    out = capsys.readouterr().out
    assert "robustness: 0 shed (0 blocks, 0 queue SLO), 0 expired, " \
        "0 evicted" in out and "SERVE SMOKE OK" in out
    rec = json.load(open(log))
    assert rec["statuses"] == {"0": "ok", "1": "ok", "2": "ok"}
    assert rec["obs"]["trace_file"].endswith("trace_s1d.json")
    names = [e["event"] for e in read_events(rec["obs"]["metrics_files"])]
    assert names.count("req_finished") == 3 and names[-2:] == [
        "serve_rollup", "stage_trace"]


def test_trace_needs_a_metrics_dir():
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    for main, arch in ((train_main, "gpt2-moe"),
                       (serve_main, "qwen3-moe-30b-a3b")):
        with pytest.raises(SystemExit) as exc:
            main(["--arch", arch, "--reduced", "--device", "cpu", "--trace"])
        assert exc.value.code == 2
