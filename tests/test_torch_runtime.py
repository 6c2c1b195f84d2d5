"""The port's guarded training on the CPU against the JAX package: the
fault grammar (a copy), ``GuardState`` (a copy) fed the same observation
sequences, ``adamw_update``'s ``finite`` skip and ``lr_scale``, the
guarded step, the fp8 saturation monitor and injection, the wire
ceiling, a faulted ``Trainer`` run beside JAX's (events, counters and the
checkpoints retained on disk), the fp8 overflow fallback in both packages,
and the train launcher's chaos contract.

Tolerances: what the port's own plain path computes (a clean guarded
step, a skipped step, a whole clean guarded run) must be bitwise; losses
against JAX as in ``test_torch_train.py``: one step 1e-5 relative, a run
1e-4 (f32), and under the fp8 wire step 0 1e-4, later steps 2e-3 (the
frameworks' last-bit differences move a few wire values across an e4m3
rounding boundary); AdamW with ``lr_scale`` against JAX 1e-6 (the same
elementwise arithmetic).  Event lists, counters, saturation counts and
retained steps must be equal.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from hypothesis_compat import given, settings, st  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import autosched as j_autosched  # noqa: E402
from repro.core import collectives as j_coll  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train.loop import make_guarded_train_step as j_guarded  # noqa
from repro_torch import runtime as trt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, to_numpy  # noqa: E402
from repro_torch.core import autosched as t_autosched  # noqa: E402
from repro_torch.core import collectives as t_coll  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.runtime import guards as t_guards  # noqa: E402
from repro_torch.train import (Trainer, make_guarded_train_step,  # noqa
                               make_train_step)

DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=12)


@pytest.fixture(autouse=True)
def fp8_clean():
    """Reset both packages' process-wide fp8 monitor, injection, counter
    and wire ceiling (and both decision caches) around every test."""
    def reset():
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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _state(params, opt_state):
    return [t.detach().clone() for t in
            leaves(params) + leaves(opt_state["mu"])
            + leaves(opt_state["nu"]) + [opt_state["step"]]]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# --- the fault grammar and the guard policy (copies) ------------------------

SPECS = ["nan_grad@step=5-8;fp8_sat@factor=64;ckpt_bitflip@save=2;"
         "req_delay@rid=1,rounds=6;req_timeout@rid=2,ticks=4;"
         "alloc_starve@tick=1,hold=8,rounds=5",
         "nan_grad@step=3,value=inf", "", "fp8_sat@factor=3;nan_grad@step=0"]


@pytest.mark.parametrize("spec", SPECS, ids=["all", "inf", "empty", "two"])
def test_fault_plan_matches_jax(spec, tmp_path):
    jp, tp = jrt.FaultPlan.parse(spec, seed=7), trt.FaultPlan.parse(spec,
                                                                    seed=7)
    assert [(s.kind, s.args) for s in tp.specs] == \
        [(s.kind, s.args) for s in jp.specs]
    assert tp.summary() == jp.summary() and tp.seed == jp.seed
    assert bool(tp) == bool(jp)
    for step in range(12):
        a, b = tp.grad_fault(step), jp.grad_fault(step)
        assert a == b or (math.isnan(a) and math.isnan(b))
    assert tp.fp8_sat_factor() == jp.fp8_sat_factor()
    assert [tp.ckpt_corrupts(i) for i in range(4)] == \
        [jp.ckpt_corrupts(i) for i in range(4)]
    assert tp.alloc_starve() == jp.alloc_starve()
    assert [tp.req_delay_rounds(r) for r in range(3)] == \
        [jp.req_delay_rounds(r) for r in range(3)]
    # the same byte and bit of the same file, for several sizes
    for size in (700, 4096, 100_003):
        data = np.random.RandomState(size).bytes(size)
        flipped = []
        for plan in (tp, jp):
            path = os.path.join(tmp_path, "blob.bin")
            with open(path, "wb") as f:
                f.write(data)
            off = plan.flip_bit(path)
            with open(path, "rb") as f:
                flipped.append((off, f.read()))
        assert flipped[0] == flipped[1] and flipped[0][1] != data


@settings(max_examples=30, deadline=None)
@given(obs=st.lists(st.tuples(
           st.one_of(st.floats(0.5, 8.0), st.just(float("nan")),
                     st.just(float("inf")), st.just(80.0)),
           st.booleans()), min_size=1, max_size=40),
       max_skips=st.integers(1, 4), spike_min=st.integers(2, 8),
       rollback_to=st.integers(0, 3))
def test_guard_state_matches_jax(obs, max_skips, spike_min, rollback_to):
    """The same (loss, nonfinite) sequence through both packages'
    ``GuardState``: identical actions, counters, events and lr_scale."""
    states = [rt.GuardState(cfg=rt.GuardConfig(max_skips=max_skips,
                                               spike_min=spike_min))
              for rt in (trt, jrt)]
    for step, (loss, nonfinite) in enumerate(obs):
        acts = [s.observe(step, loss, nonfinite) for s in states]
        assert acts[0] == acts[1]
        if acts[0] == trt.ROLLBACK:
            restored = None if step % 4 == 3 else rollback_to
            for s in states:
                s.record_rollback(step, restored)
    t, j = states
    assert (t.counters, t.lr_scale, t.streak, t.summary()) == \
        (j.counters, j.lr_scale, j.streak, j.summary())
    assert repr(t.events) == repr(j.events)     # NaN-safe equality


def test_guard_config_validation():
    for kw in ({"max_skips": 0}, {"lr_backoff": 0.0}, {"lr_backoff": 1.5}):
        with pytest.raises(ValueError):
            trt.GuardConfig(**kw)


# --- adamw_update: finite skip and lr_scale ----------------------------------

def _adamw_inputs(seed):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(4, 6).astype(np.float32),
              "b": {"s": rng.randn(6).astype(np.float32)}}
    grads = {"w": (0.3 * rng.randn(4, 6)).astype(np.float32),
             "b": {"s": (0.3 * rng.randn(6)).astype(np.float32)}}
    return params, grads


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(v.copy()) for k, v in tree.items()}


def test_adamw_finite_true_is_bitwise_the_plain_update():
    params, grads = _adamw_inputs(0)
    cfg = t_adamw.AdamWConfig(**OPT)
    out = []
    for kw in ({}, {"finite": True}, {"finite": torch.tensor(True)}):
        tp = _torch_tree(params)
        st_ = t_adamw.adamw_init(tp)
        for _ in range(3):
            om = t_adamw.adamw_update(tp, leaves(_torch_tree(grads)), st_,
                                      cfg, **kw)
        assert bool(om.get("finite", True))
        out.append((_state(tp, st_), om["grad_norm"], om["lr"]))
    for o in out[1:]:
        assert _same(o[0], out[0][0])
        assert torch.equal(o[1], out[0][1]) and torch.equal(o[2], out[0][2])


@pytest.mark.parametrize("bad", ["nan_grad", "inf_grad", "flag"])
def test_adamw_nonfinite_leaves_everything_untouched(bad):
    params, grads = _adamw_inputs(1)
    cfg = t_adamw.AdamWConfig(**OPT)
    tp = _torch_tree(params)
    st_ = t_adamw.adamw_init(tp)
    t_adamw.adamw_update(tp, leaves(_torch_tree(grads)), st_, cfg)
    before = _state(tp, st_)
    g = _torch_tree(grads)
    finite = True
    if bad == "flag":
        finite = torch.tensor(False)
    else:
        g["w"][1, 2] = float("nan") if bad == "nan_grad" else float("inf")
    om = t_adamw.adamw_update(tp, leaves(g), st_, cfg, finite=finite)
    assert not bool(om["finite"])
    assert _same(_state(tp, st_), before) and int(st_["step"]) == 1
    # JAX keeps the same things (its select)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_adamw.adamw_init(jp)
    jp, js, _ = j_adamw.adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                     js, j_adamw.AdamWConfig(**OPT))
    jg = jax.tree.map(jnp.asarray, {"w": g["w"].numpy(),
                                    "b": {"s": g["b"]["s"].numpy()}})
    _, js2, jom = j_adamw.adamw_update(jp, jg, js, j_adamw.AdamWConfig(**OPT),
                                       finite=jnp.bool_(bad != "flag"))
    assert not bool(jom["finite"]) and int(js2["step"]) == 1
    np.testing.assert_allclose(float(om["lr"]), float(jom["lr"]), rtol=1e-6)


@pytest.mark.parametrize("lr_scale", [0.5, 0.375])
def test_adamw_lr_scale_matches_jax(lr_scale):
    params, grads = _adamw_inputs(2)
    tp = _torch_tree(params)
    st_ = t_adamw.adamw_init(tp)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_adamw.adamw_init(jp)
    for _ in range(2):
        tom = t_adamw.adamw_update(tp, leaves(_torch_tree(grads)), st_,
                                   t_adamw.AdamWConfig(**OPT),
                                   lr_scale=lr_scale, finite=True)
        jp, js, jom = j_adamw.adamw_update(
            jp, jax.tree.map(jnp.asarray, grads), js,
            j_adamw.AdamWConfig(**OPT), lr_scale=jnp.float32(lr_scale),
            finite=jnp.bool_(True))
    np.testing.assert_allclose(float(tom["lr"]), float(jom["lr"]), rtol=1e-6)
    got, want = to_numpy(tp), _np_tree(jp)
    for key in ("w", "b"):
        np.testing.assert_allclose(*(jax.tree.leaves(t[key])[0]
                                     for t in (got, want)), rtol=0, atol=1e-6)
    assert int(st_["step"]) == int(js["step"]) == 2


# --- the guarded step --------------------------------------------------------

@pytest.fixture(scope="module")
def gpt2_step_inputs():
    """Reduced gpt2-moe: the JAX parameters, AdamW state and batch 0."""
    jcfg = j_get_config("gpt2-moe").reduced()
    tcfg = get_config("gpt2-moe").reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = SyntheticLM(DataConfig(vocab_size=tcfg.vocab_size, seq_len=32,
                                   global_batch=2)).batch(0)
    jstep = jax.jit(j_guarded(jmodel, make_mesh((1, 1), ("data", "model")),
                              DIMS, j_adamw.AdamWConfig(**OPT)))
    return jstep, tcfg, _np_tree(jparams), batch


def _port_state(tcfg, np_params):
    tp = params_from_jax(np_params, tcfg, device="cpu")
    return tp, t_adamw.adamw_init(tp)


@pytest.mark.parametrize("fault", [0.0, float("nan"), float("inf")])
def test_guarded_step_matches_plain_and_jax(gpt2_step_inputs, fault):
    """Clean: bitwise the plain step (parameters, moments, step counter,
    loss, grad norm).  NaN / inf fault: the flag is up and the state is
    bitwise what it was.  The loss within 1e-5 of JAX's guarded step."""
    jstep, tcfg, np_params, batch = gpt2_step_inputs
    cfg = t_adamw.AdamWConfig(**OPT)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    model = Model(tcfg, device="cpu")
    tp, to = _port_state(tcfg, np_params)
    before = _state(tp, to)
    tp, to, tm = make_guarded_train_step(model, cfg)(tp, to, tbatch, 1.0,
                                                     fault)
    if fault == 0.0:
        pp, po = _port_state(tcfg, np_params)
        pp, po, pm = make_train_step(model, cfg)(pp, po, tbatch)
        assert not bool(tm["nonfinite"])
        assert _same(_state(tp, to), _state(pp, po))
        for key in ("loss", "grad_norm", "lr", "ce"):
            assert torch.equal(tm[key], pm[key]), key
    else:
        assert bool(tm["nonfinite"])
        assert _same(_state(tp, to), before) and int(to["step"]) == 0
    jparams = jax.tree.map(jnp.asarray, np_params)
    _, jo, jm = jstep(jparams, j_adamw.adamw_init(jparams),
                      {k: jnp.asarray(v) for k, v in batch.items()},
                      jnp.float32(1.0), jnp.float32(fault))
    assert bool(jm["nonfinite"]) == bool(tm["nonfinite"])
    assert int(jo["step"]) == int(to["step"])
    if fault == 0.0:
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    else:
        assert not math.isfinite(float(tm["loss"]))
        assert not math.isfinite(float(jm["loss"]))


def test_clean_guarded_run_is_bitwise_the_plain_run():
    """Guards on, no fault: a whole ``Trainer`` run (parameters, moments,
    step counter and every logged loss) is bitwise the unguarded run."""
    cfg = get_config("gpt2-moe").reduced()
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2))
    runs = []
    for guards in (None, trt.GuardConfig()):
        tr = Trainer(Model(cfg, device="cpu"), t_adamw.AdamWConfig(**OPT),
                     guards=guards)
        p, o = tr.setup(torch.Generator().manual_seed(0))
        p, o, hist = tr.run(p, o, data, 4, log_every=1)
        runs.append((_state(p, o), [h["loss"] for h in hist]))
    assert _same(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]


# --- fp8: the saturation monitor, injection and the wire ceiling -------------

def _fp8_counts(rt, coll, x, factor, scaling):
    rt.reset_fp8_counter()
    rt.enable_fp8_monitor()
    coll.set_fp8_sat_injection(factor)
    comm = coll.CommConfig(wire_dtype="fp8_e4m3", scaling=scaling)
    if rt is jrt:
        jax.block_until_ready(coll.wire_encode(jnp.asarray(x), comm))
    else:
        coll.wire_encode(torch.from_numpy(x), comm)
    counts = rt.fp8_sat_counts()
    coll.set_fp8_sat_injection(0.0)
    return counts


@pytest.mark.parametrize("factor", [0.0, 64.0, 3.0])
@pytest.mark.parametrize("scaling", ["per_chunk", "none"])
def test_fp8_saturation_counts_are_jaxs(factor, scaling):
    """``(sat, total)`` and the payload bytes of one encode equal JAX's
    op-by-op ``wire_encode`` (eager, as ``test_torch_kernels.py`` holds
    the codec's bytes).  Under ``jit`` XLA turns JAX's ``amax / 448`` into
    ``amax * fl(1/448)``, which can move a row's amax element one ulp
    either side of 448: row 0 below counts one element more here than in
    a jitted encode."""
    x = np.random.RandomState(0).randn(16, 64).astype(np.float32)
    x[2] *= 1e3
    x[5, 7] = np.inf
    got = _fp8_counts(trt, t_coll, x, factor, scaling)
    want = _fp8_counts(jrt, j_coll, x, factor, scaling)
    assert got == want and got[1] == x.size
    if factor and scaling == "per_chunk":
        assert got[0] > x.size // 4
    # the payload bytes too (the injection divides by a tensor)
    comm = t_coll.CommConfig(wire_dtype="fp8_e4m3", scaling=scaling)
    t_coll.set_fp8_sat_injection(factor)
    j_coll.set_fp8_sat_injection(factor)
    tb = t_coll.wire_encode(torch.from_numpy(x), comm).view(torch.uint8)
    jb = np.asarray(j_coll.wire_encode(jnp.asarray(x), j_coll.CommConfig(
        wire_dtype="fp8_e4m3", scaling=scaling))).view(np.uint8)
    np.testing.assert_array_equal(tb.numpy(), jb)


def test_monitor_off_counts_nothing_and_backward_counts():
    """No monitor: nothing accumulates.  With one, the fp8 round trip
    counts its forward encode and its backward's re-encode."""
    comm = t_coll.CommConfig(wire_dtype="fp8_e4m3")
    x = torch.randn(8, 32, requires_grad=True)
    t_coll.wire_roundtrip(x, comm).sum().backward()
    assert trt.fp8_sat_counts() == (0, 0)
    trt.enable_fp8_monitor()
    with torch.no_grad():
        t_coll.wire_encode(x, comm)
        t_coll.wire_encode(torch.ones_like(x), comm)   # sum's cotangent
    want = trt.fp8_sat_counts()
    trt.reset_fp8_counter()
    t_coll.wire_roundtrip(x, comm).sum().backward()
    assert trt.fp8_sat_counts() == want and want[1] == 2 * x.numel()


def test_check_fp8_fires_once_and_the_ceiling_clamps():
    st_ = trt.GuardState(cfg=trt.GuardConfig(fp8_sat_threshold=1e-3))
    assert not st_.check_fp8()
    t_guards._SAT["sat"], t_guards._SAT["total"] = 500, 1000
    assert st_.check_fp8() and not st_.check_fp8()
    assert st_.counters["fp8_fallbacks"] == 1
    assert st_.events == [{"kind": "fp8_fallback", "sat_rate": 0.5,
                           "wire": "bf16"}]
    for wire in ("fp8_e4m3", "bf16", "f32", "unknown"):
        assert t_autosched.clamp_wire(wire) == j_autosched.clamp_wire(wire)
    for ceiling in ("bf16", "f32", "fp8_e4m3"):
        t_autosched.set_wire_ceiling(ceiling)
        j_autosched.set_wire_ceiling(ceiling)
        assert t_autosched.wire_ceiling() == ceiling
        for wire in ("fp8_e4m3", "bf16", "f32"):
            assert t_autosched.clamp_wire(wire) == \
                j_autosched.clamp_wire(wire)
    with pytest.raises(ValueError):
        t_autosched.set_wire_ceiling("int4")
    assert t_autosched.invalidate("test") == 0


# --- Trainer runs beside JAX's -----------------------------------------------

def _trainers(arch, tmp_path, spec, steps, moe_kw=None, **kw):
    """The JAX Trainer (set up) and the port's on its parameters."""
    jcfg = j_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, comm=j_coll.CommConfig(**moe_kw)))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, comm=t_coll.CommConfig(**moe_kw)))
    opt = dict(OPT, total_steps=steps)
    jtr = JTrainer(build_model(jcfg), make_mesh((1, 1), ("data", "model")),
                   DIMS, j_adamw.AdamWConfig(**opt),
                   ckpt_path=os.path.join(tmp_path, "jax", "run.npz"),
                   guards=jrt.GuardConfig(max_skips=2),
                   faults=jrt.FaultPlan.parse(spec), **kw)
    jparams, jopt = jtr.setup(jax.random.PRNGKey(0))
    tr = Trainer(Model(tcfg, device="cpu"), t_adamw.AdamWConfig(**opt),
                 ckpt_path=os.path.join(tmp_path, "port", "run.npz"),
                 guards=trt.GuardConfig(max_skips=2),
                 faults=trt.FaultPlan.parse(spec), **kw)
    tparams = params_from_jax(_np_tree(jparams), tcfg, device="cpu")
    data = dict(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=4)
    return (jtr, jparams, jopt, JSyntheticLM(JDataConfig(**data))), \
        (tr, tparams, t_adamw.adamw_init(tparams),
         SyntheticLM(DataConfig(**data)))


#: (fault spec, steps, snapshot period, wire, events as (kind, step,
#: streak, restored step), retained steps, loss tolerance).  "phase9" is
#: chip_smoke.py phase 9 (a)'s plan: the NaN cotangents saturate the fp8
#: backward encodes, so the fp8 fallback fires at step 3 too.
FAULTED = {
    "nan-f32": ("nan_grad@step=5-7", 12, 3, "f32",
                [("skip", 5, 1, None), ("skip", 6, 2, None),
                 ("rollback", 6, None, 3), ("skip", 7, 1, None)],
                [3, 9], 1e-4),
    "phase9": ("nan_grad@step=3-5;ckpt_bitflip@save=2", 10, 2, "fp8_e4m3",
               [("skip", 3, 1, None), ("fp8_fallback", None, None, None),
                ("skip", 4, 2, None), ("rollback", 4, None, 0),
                ("skip", 5, 1, None)], [6, 8], 2e-3)}


def _event(e):
    return (e["kind"], e.get("step"), e.get("streak"), e.get("restored_step"))


@pytest.mark.parametrize("plan", list(FAULTED))
def test_faulted_run_matches_jax(tmp_path, plan):
    """gpt2-moe under ``s1g`` with max_skips 2 and 2 retained snapshots.
    "nan-f32": skips at 5 and 6, a rollback at 6 to step 3, a skip at 7.
    "phase9": skips at 3 and 4, a rollback at 4 past the corrupt step-2
    file to step 0, a skip at 5.  The same events (their fp8 saturation
    rates within 1e-2) and counters as JAX's, the same retained steps on
    disk, and the losses within the stated tolerance of JAX's (NaN where
    JAX's is)."""
    spec, steps, every, wire, events, retained, rtol = FAULTED[plan]
    (jtr, jp, jo, jdata), (tr, tp, to, tdata) = _trainers(
        "gpt2-moe", tmp_path, spec, steps, moe_kw={"wire_dtype": wire},
        schedule="s1g", ckpt_retain=2)
    jp, jo, jhist = jtr.run(jp, jo, jdata, steps, log_every=1,
                            ckpt_every=every)
    tp, to, thist = tr.run(tp, to, tdata, steps, log_every=1,
                           ckpt_every=every)
    js, ts = jtr.guard_state, tr.guard_state
    assert ts.counters == js.counters
    assert [_event(e) for e in ts.events] == \
        [_event(e) for e in js.events] == events
    for a, b in zip(ts.events, js.events):
        if "sat_rate" in a:
            np.testing.assert_allclose(a["sat_rate"], b["sat_rate"],
                                       rtol=1e-2)
        else:
            assert a == b
    assert ts.lr_scale == js.lr_scale
    on_disk = [sorted(os.listdir(os.path.join(tmp_path, pkg)))
               for pkg in ("jax", "port")]
    assert on_disk[0] == on_disk[1] == [f"run.step{s:08d}.npz"
                                        for s in retained]
    assert int(to["step"]) == int(jo["step"])
    for key in ("loss", "ce", "grad_norm", "lr", "lr_scale"):
        want = [h[key] for h in jhist]
        got = [h[key] for h in thist]
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=key)


def test_fp8_fallback_fires_at_jaxs_step(tmp_path):
    """qwen3 ``s1g`` with the fp8 wire and ``fp8_sat@factor=64``: both
    packages fall back to the bf16 wire after step 0 (the saturation rate
    is read once per step), and from step 1 on the port encodes no fp8.

    The JAX Trainer's fallback does not take effect: its re-jit wraps the
    same step function, so JAX's trace cache hands back the fp8 trace and
    the injected encodes go on (pinned below).  The losses are therefore
    held to what the fallback means: JAX's step 0, then JAX steps freshly
    traced under the bf16 ceiling; step 0 within 1e-4, later steps 2e-3
    (the fp8 tolerances)."""
    steps = 4
    (jtr, jp, jo, jdata), (tr, tp, to, tdata) = _trainers(
        "qwen3-moe-30b-a3b", tmp_path, "fp8_sat@factor=64", steps,
        moe_kw={"wire_dtype": "fp8_e4m3"}, schedule="s1g")
    jp, jo, jhist = jtr.run(jp, jo, jdata, 1, log_every=1)
    jevents = list(jtr.guard_state.events)
    assert j_autosched.wire_ceiling() == "bf16"
    n_fp8 = jrt.fp8_sat_counts()[1]
    batch = jdata.sharded_batch(1, jtr.mesh, tuple(DIMS.batch_axes))
    jtr._step(jax.tree.map(jnp.copy, jp), jax.tree.map(jnp.copy, jo), batch,
              1.0, 0.0)
    jax.effects_barrier()
    assert jrt.fp8_sat_counts()[1] == 2 * n_fp8      # the cached fp8 trace
    jstep = jax.jit(j_guarded(jtr.model, jtr.mesh, DIMS, jtr.opt_cfg, "s1g"))
    jlosses = [jhist[0]["loss"]]
    for step in range(1, steps):
        batch = {k: jnp.asarray(v) for k, v in jdata.batch(step).items()}
        jp, jo, m = jstep(jp, jo, batch, 1.0, 0.0)
        jlosses.append(float(m["loss"]))
    jax.effects_barrier()
    assert jrt.fp8_sat_counts()[1] == 2 * n_fp8      # bf16: no fp8 encode

    tp, to, thist = tr.run(tp, to, tdata, steps, log_every=1)
    ts = tr.guard_state
    assert [e["kind"] for e in ts.events] == [e["kind"] for e in jevents] \
        == ["fp8_fallback"]
    assert ts.events[0]["wire"] == "bf16" and ts.events[0]["sat_rate"] > 0.5
    assert ts.counters["fp8_fallbacks"] == 1
    assert trt.fp8_sat_counts()[1] == n_fp8          # step 0's encodes only
    losses = [h["loss"] for h in thist]
    assert all(math.isfinite(x) for x in losses)
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-4)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-3)


# --- the launcher ------------------------------------------------------------

def test_launcher_chaos_run_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    ck = os.path.join(tmp_path, "ck")
    main(["--arch", "gpt2-moe", "--reduced", "--device", "cpu", "--steps",
          "6", "--seq", "32", "--batch", "2", "--faults",
          "nan_grad@step=2-3", "--ckpt", ck, "--max-skips", "2"])
    out = capsys.readouterr().out
    assert "CHAOS TRAIN OK" in out and "(2 skipped, 1 rollbacks)" in out
    assert "ROLLBACK -> re-anchored to checkpoint step 0" in out
    assert os.listdir(ck) == ["ckpt.step00000000.npz"]
    with pytest.raises(SystemExit) as exc:
        main(["--arch", "gpt2-moe", "--reduced", "--device", "cpu",
              "--guards", "--placement", "auto"])
    assert exc.value.code == 2
