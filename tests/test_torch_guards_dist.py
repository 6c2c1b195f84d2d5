"""Guarded training, checkpoints, faults and telemetry across ranks: the
port's ``Trainer(mesh=, dims=, guards=, faults=, ckpt_path=)`` on four
gloo ranks of the merged ``(data=2, model=2)`` mesh against the JAX
``Trainer`` on a 4-device (2, 2) host mesh, from the same JAX parameters
and batches; then the launcher's faulted multi-rank run.

The reference run (both packages): reduced gpt2-moe under ``s1g`` on an
f32 wire (the JAX Trainer's fp8 fallback never takes effect, ROADMAP
§3), faults ``nan_grad@step=3-5;ckpt_bitflip@save=2``, ``max_skips`` 2,
a snapshot every 2 steps with 2 retained, 7 steps, a sink (rank 0's in
the port).  Cases:

  (a) guard events, counters, the rollback manager's history, restored
      path and retained steps equal JAX's; NaN losses at steps 3-5 in
      both, the finite ones within 1e-4 relative; the parameters after
      step 6 within 2e-5 absolute, with ``test_torch_train_dist.py``'s
      clause (0.01% of a leaf's elements, and the attention key bias,
      within twice the largest learning rate of the run);
  (b) the port's step-6 file has JAX's keys, shapes and ``__dtypes__``
      and values within (a)'s tolerance; every rank restoring JAX's file
      holds ``local_shard`` of its arrays bitwise; the port's file
      restored on a (1, 4) mesh, and loaded on one rank, is
      ``gather_full`` of the (2, 2) shards bitwise;
  (c) rank 0's stream follows JAX's event by event (kinds and guard
      fields exact, ``train_step`` losses within 1e-4), and the sink's
      directory holds that one stream;
  (d) an fp8 wire with ``fp8_sat@factor=64``, 2 steps: the fallback at
      step 0 on every rank, the world's ``(sat, total)`` the sum of the
      ranks' own counts, its rate within 1e-3 relative of JAX's step-0
      global rate (the settled amax-ulp difference), and rank 0's
      ``fp8_sat`` events summing to the world's;
  (e) the stage-trace harness on the mesh under s1 and s2: JAX's stages,
      every ``execute_prefix`` probe within 1e-5 relative of JAX's, the
      audit's priced stages ``==`` JAX's ``t_plan_stages``;
  (f) one rank's ``observe`` patched to another action: every rank
      raises (none waits in a later collective);
  (g) with no fault the guarded 4-rank step is ``torch.equal`` to the
      plain one on every rank.

One JAX subprocess and one 4-rank spawn serve the whole module; they run
side by side (the ranks start once JAX has written the initial
parameters, and read JAX's step-6 file once it exists).
"""

import importlib.util
import math
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import subprocess_env

pytestmark = [pytest.mark.multirank, pytest.mark.skipif(
    importlib.util.find_spec("jax") is None, reason="needs jax")]

STEPS = 7
SPEC = "nan_grad@step=3-5;ckpt_bitflip@save=2"
DATA = dict(seq_len=32, global_batch=8)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TOKENS = 64                     # (e)'s layer: 32 tokens a data rank
SCHEDS = ("s1", "s2")
ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_STEP6 = os.path.join("jax", "run.step00000006.npz")
PORT_STEP6 = os.path.join("port", "run.step00000006.npz")

JAX_SCRIPT = r'''
import os, pickle, sys
from dataclasses import replace
import jax
import numpy as np
from repro import compat, obs
from repro import runtime as jrt
import repro.runtime.rollback as jrb
from repro.configs import get_config
from repro.core import executor, perfmodel, plan as planlib
from repro.core.collectives import CommConfig
from repro.data import DataConfig, SyntheticLM
from repro.models import build_model
from repro.obs import audit
from repro.optim import AdamWConfig
from repro.parallel.mesh import ParallelDims, make_mesh
from repro.train import Trainer

tmp = sys.argv[1]
steps, spec, data_kw, opt_kw, tokens, scheds = eval(sys.argv[2])
cfg = get_config("gpt2-moe").reduced()
mesh = make_mesh((2, 2), ("data", "model"))
dims = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
managers = []


class Recorded(jrb.RollbackManager):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        managers.append(self)


jrb.RollbackManager = Recorded


def host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def dump(obj, name):
    with open(os.path.join(tmp, name + ".tmp"), "wb") as f:
        pickle.dump(obj, f)
    os.replace(os.path.join(tmp, name + ".tmp"), os.path.join(tmp, name))


def trainer(c, **kw):
    tr = Trainer(build_model(c), mesh, dims, AdamWConfig(**opt_kw),
                 schedule="s1g", **kw)
    return (tr, *tr.setup(jax.random.PRNGKey(0)))


harness = audit._LayerHarness(mesh, dims, cfg.moe, tokens)
obs.configure(os.path.join(tmp, "jax_metrics"), meta={"kind": "train"})
tr, params, opt = trainer(
    cfg, ckpt_path=os.path.join(tmp, "jax", "run.npz"),
    guards=jrt.GuardConfig(max_skips=2), faults=jrt.FaultPlan.parse(spec),
    ckpt_retain=2)
dump({"init": host(params),
      "layer_args": [np.asarray(a) for a in harness.args]}, "init.pkl")
data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **data_kw))
params, opt, hist = tr.run(params, opt, data, steps, log_every=1,
                           ckpt_every=2)
out = {"metrics": list(obs.get_sink().paths), "hist": hist,
       "events": tr.guard_state.events,
       "counters": dict(tr.guard_state.counters),
       "lr_scale": tr.guard_state.lr_scale, "mgr": managers[0].events,
       "retained": managers[0].store.steps(), "final": host(params)}
obs.close()
jrt.reset_fp8_counter()
fcfg = replace(cfg, moe=replace(cfg.moe,
                                comm=CommConfig(wire_dtype="fp8_e4m3")))
tr, params, opt = trainer(fcfg, guards=jrt.GuardConfig(),
                          faults=jrt.FaultPlan.parse("fp8_sat@factor=64"))
tr.run(params, opt, data, 1, log_every=1)
jax.effects_barrier()
out["fp8"] = {"counts": jrt.fp8_sat_counts(), "events": tr.guard_state.events}
model = perfmodel.tpu_v5e_model(2, 2, 2)
out["layer"] = {}
info = harness.info(1)
for sched in scheds:
    plan = planlib.build_plan(sched, info, n_chunks=1)
    order = planlib.validate(plan)
    probe = []
    for k in range(len(order) + 1):
        def body(xt, wg, w1, w3_, w2, k=k):
            return executor.execute_prefix(plan, xt, wg, w1, w3_, w2, info,
                                           k)
        probe.append(float(jax.jit(compat.shard_map(
            body, mesh=mesh, in_specs=harness.in_specs,
            out_specs=jax.sharding.PartitionSpec(),
            check_vma=False))(*harness.args)))
    out["layer"][sched] = {
        "stages": [s.name for s in order], "probe": probe,
        "priced": model.t_plan_stages(plan, harness.shape,
                                      wire_dtype=harness.wire)}
dump(out, "jax.pkl")
'''


def _wait_for(path, deadline):
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


def _np(tree):
    """A copy of a nested dict of tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _reset_fp8():
    from repro_torch.core import autosched, collectives
    from repro_torch.runtime import disable_fp8_monitor, reset_fp8_counter
    autosched.set_wire_ceiling(None)
    collectives.set_fp8_sat_injection(0.0)
    disable_fp8_monitor()
    reset_fp8_counter()


def _rank(rank, tmp, pm):
    """Every case but the launcher on one rank of the (2, 2) mesh (see the
    module docstring); returns what the parent compares."""
    from dataclasses import replace

    import torch
    from repro_torch import obs
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core import collectives, executor
    from repro_torch.core import plan as planlib
    from repro_torch.core.collectives import CommConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.obs import audit
    from repro_torch.optim import AdamWConfig, adamw_init, leaves
    from repro_torch.optim.adamw import opt_state_specs
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import gather_full, local_shard
    from repro_torch.runtime import FaultPlan, GuardConfig, fp8_sat_counts
    from repro_torch.runtime import guards
    from repro_torch.train import Trainer
    deadline = time.monotonic() + 240
    _wait_for(os.path.join(tmp, "init.pkl"), deadline)
    with open(os.path.join(tmp, "init.pkl"), "rb") as f:
        ref = pickle.load(f)
    cfg = get_config("gpt2-moe").reduced()
    mesh = make_mesh((2, 2), ("data", "model"))
    dims = dims_for(cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **DATA))
    out = {}

    def trainer(c=cfg, mesh=mesh, **kw):
        tr = Trainer(Model(c, device="cpu"), AdamWConfig(**OPT),
                     schedule="s1g", mesh=mesh, dims=dims, **kw)
        p = params_from_jax(ref["init"], c, device="cpu", mesh=mesh,
                            dims=dims)
        return tr, p, adamw_init(p)

    def state(p, o):
        return leaves(p) + leaves(o["mu"]) + leaves(o["nu"]) + [o["step"]]

    # (g) a clean guarded step against the plain step, from one state
    tr, p, o = trainer(guards=GuardConfig())
    p2, o2 = _clone(p), _clone(o)
    batch = tr.batch(data, 0)
    p, o, m = tr.guarded_step(p, o, batch, 1.0, 0.0)
    p2, o2, m2 = tr.train_step(p2, o2, batch)
    out["clean"] = (not bool(m["nonfinite"])) and torch.equal(
        m["loss"], m2["loss"]) and all(
        torch.equal(a, b) for a, b in zip(state(p, o), state(p2, o2)))
    _reset_fp8()

    # the plain loop's checkpoint (its last step) with rank 0's sink
    if rank == 0:
        obs.configure(os.path.join(tmp, "plain_metrics"))
    tr, p, o = trainer(ckpt_path=os.path.join(tmp, "plain", "run.npz"))
    p, o, hist = tr.run(p, o, data, 3, log_every=2, ckpt_every=2)
    if rank == 0:
        out["plain_metrics"] = list(obs.get_sink().paths)
        obs.close()
    live = {"params": p, "opt": o}
    whole = [gather_full(t, sp, mesh) for t, sp in
             zip(_flat(live), _flat(tr.state_specs(p, "opt")))]
    out["plain"] = {"steps": [h["step"] for h in hist],
                    "whole": {k: w.detach().numpy().copy() for k, w in
                              zip(_paths(live), whole)} if rank == 0
                    else None}
    del whole

    # (e) the stage-trace harness on the mesh, on JAX's operands
    out["layer"] = {}
    for sched in SCHEDS:
        h = audit._LayerHarness(cfg.moe, TOKENS, mesh=mesh, dims=dims)
        info = h.info(1)
        plan = planlib.build_plan(sched, info, n_chunks=1)
        args = [None if sp is None else local_shard(torch.from_numpy(a), sp,
                                                    mesh)
                for a, sp in zip(ref["layer_args"], h.in_specs)]
        with torch.no_grad(), collectives.bound(mesh):
            probe = [float(executor.execute_prefix(plan, *args, info, k))
                     for k in range(len(planlib.validate(plan)) + 1)]
        rep, = audit.run_schedule_audit(
            cfg.moe, TOKENS, (sched,), perf_model=pm, iters=1, warmup=0,
            device="cpu", mesh=mesh, dims=dims)
        out["layer"][sched] = {
            "stages": [s["name"] for s in rep["stages"]], "probe": probe,
            "priced": {s["name"]: s["predicted_s"] for s in rep["stages"]}}

    # (a) the faulted run, (c) with rank 0's sink
    if rank == 0:
        obs.configure(os.path.join(tmp, "port_metrics"), meta={
            "kind": "train", "n_devices": mesh.size})
    tr, p, o = trainer(
        guards=GuardConfig(max_skips=2), faults=FaultPlan.parse(SPEC),
        ckpt_path=os.path.join(tmp, "port", "run.npz"), ckpt_retain=2)
    p, o, hist = tr.run(p, o, data, STEPS, log_every=1, ckpt_every=2)
    if rank == 0:
        out["metrics"] = list(obs.get_sink().paths)
        obs.close()
    mgr = tr.rollback_mgr
    out.update(hist=hist, events=tr.guard_state.events,
               counters=dict(tr.guard_state.counters),
               lr_scale=tr.guard_state.lr_scale, mgr=mgr.events,
               retained=mgr.store.steps(), final=_np(p))

    # (b) the port's file on a (1, 4) mesh, against the (2, 2) shards
    specs = tr.state_specs(p)
    live = {"params": p, "opt_state": o}
    paths = _paths(live)
    whole = [gather_full(t, s, mesh) for t, s in
             zip(_flat(live), _flat(specs))]
    mesh14 = make_mesh((1, 4), ("data", "model"))
    tr14, p14, o14 = trainer(mesh=mesh14)
    into = {"params": p14, "opt_state": o14}
    specs14 = tr14.state_specs(p14)
    load_checkpoint(os.path.join(tmp, PORT_STEP6), into=into, specs=specs14,
                    mesh=mesh14)
    out["reshard"] = [k for k, t, s, w in zip(
        paths, _flat(into), _flat(specs14), whole)
        if not torch.equal(gather_full(t, s, mesh14), w)]
    if rank == 0:
        out["whole"] = {k: w.detach().numpy().copy()
                        for k, w in zip(paths, whole)}
    del tr14, p14, o14, into, whole
    # every rank restores JAX's step-6 file into fresh shards
    _wait_for(os.path.join(tmp, JAX_STEP6), deadline)
    _, pj, oj = trainer()
    into = {"params": pj, "opt_state": oj}
    _, step = load_checkpoint(os.path.join(tmp, JAX_STEP6), into=into,
                              specs=specs, mesh=mesh)
    out["from_jax"] = (step, dict(zip(paths, (t.detach().numpy().copy()
                                              for t in _flat(into)))))
    assert specs == {"params": specs["params"],
                     "opt_state": opt_state_specs(specs["params"])}

    # (d) the fp8 wire, saturation injected: the world's counts
    _reset_fp8()
    local, fold = [], guards._fold_world

    def spy(grp, device):
        local.append((sum(int(s) for s, _, _ in guards._SAT_EVENTS),
                      sum(t for _, t, _ in guards._SAT_EVENTS)))
        return fold(grp, device)

    guards._fold_world = spy
    if rank == 0:
        obs.configure(os.path.join(tmp, "port_fp8_metrics"))
    fcfg = replace(cfg, moe=replace(cfg.moe,
                                    comm=CommConfig(wire_dtype="fp8_e4m3")))
    tr, p, o = trainer(fcfg, guards=GuardConfig(),
                       faults=FaultPlan.parse("fp8_sat@factor=64"))
    tr.run(p, o, data, 2, log_every=1)
    if rank == 0:
        out["fp8_metrics"] = list(obs.get_sink().paths)
        obs.close()
    guards._fold_world = fold
    out["fp8"] = {"local": local, "world": fp8_sat_counts(),
                  "events": tr.guard_state.events}
    _reset_fp8()

    # (f) one rank decides otherwise: every rank raises
    tr, p, o = trainer(guards=GuardConfig())
    if rank == 1:
        observe = tr.guard_state.observe
        tr.guard_state.observe = lambda *a: ("skip" if observe(*a) == "ok"
                                             else "ok")
    try:
        tr.run(p, o, data, 1, log_every=1)
        out["disagree"] = "no error"
    except RuntimeError as e:
        out["disagree"] = str(e)
    return out


def _port_model():
    """JAX's ``tpu_v5e_model(2, 2, 2)`` as the port's ``PerfModel``, field
    by field (``test_torch_perfmodel.py``'s conversion)."""
    import dataclasses

    from repro.core import perfmodel as jperf
    from repro_torch.core import perfmodel as tperf
    jm = jperf.tpu_v5e_model(2, 2, 2)

    def conv(v):
        if isinstance(v, jperf.AlphaBeta):
            return tperf.AlphaBeta(alpha=v.alpha, beta=v.beta)
        return v
    return tperf.PerfModel(**{f.name: conv(getattr(jm, f.name))
                              for f in dataclasses.fields(jm)})


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _flat(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    return [tree]


def _paths(tree, pre=""):
    """The checkpoint keys of a nested dict's leaves, in ``_flat`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, pre + k + "/")]
    return [pre[:-1]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    tmp = str(tmp_path_factory.mktemp("guards_dist"))
    with open(os.path.join(tmp, "jax.err"), "w") as err:
        jax_run = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, tmp,
             repr((STEPS, SPEC, DATA, OPT, TOKENS, SCHEDS))],
            env=subprocess_env(4), stdout=subprocess.DEVNULL, stderr=err)
        try:
            _wait_for(os.path.join(tmp, "init.pkl"), time.monotonic() + 300)
            ranks = spawn(_rank, 4, tmp, _port_model(), backend="gloo",
                          device="cpu", threads=1, timeout=300)
            jax_run.wait(timeout=300)
        finally:
            if jax_run.poll() is None:
                jax_run.kill()
    assert jax_run.returncode == 0, open(os.path.join(tmp, "jax.err")).read(
        )[-3000:]
    with open(os.path.join(tmp, "jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    return tmp, ref, ranks


def _event(e):
    return (e["kind"], e.get("step"), e.get("streak"), e.get("restored_step"))


def _close(got, want, rtol, what):
    """NaN exactly where ``want`` is NaN, the rest within ``rtol``."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert np.array_equal(np.isnan(got), np.isnan(want)), (what, got, want)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, err_msg=what)


def _walk(a, b, lr, path):
    """``test_torch_train_dist.py``'s parameter clause: within 2e-5, but
    0.01% of a leaf's elements (at least one) within twice ``lr``."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _walk(a[k], b[k], lr, f"{path}.{k}")
        return
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    off = int((d > 2e-5).sum())
    assert off <= max(1, d.size // 10000), (path, off, d.max())
    assert d.max() <= 2 * lr, (path, d.max())


def test_guarded_run_matches_the_jax_trainer(runs):
    """(a): events, counters, LR scale, the rollback manager's history and
    retained steps exactly JAX's on every rank; the losses NaN at steps
    3-5 in both and within 1e-4 elsewhere; the parameters after step 6
    within the stated tolerance of JAX's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.sharding import local_tree
    tmp, ref, ranks = runs
    want_events = [("skip", 3, 1, None), ("skip", 4, 2, None),
                   ("rollback", 4, None, 0), ("skip", 5, 1, None)]
    assert [_event(e) for e in ref["events"]] == want_events
    cfg = get_config("gpt2-moe").reduced()
    lr = max(h["lr"] for h in ref["hist"])
    for rank, got in enumerate(ranks):
        assert got["events"] == ref["events"], rank
        assert got["counters"] == ref["counters"] == {
            "steps": 7, "skipped": 3, "rollbacks": 1, "loss_spikes": 0,
            "fp8_fallbacks": 0, "rollback_unavailable": 0}
        assert got["lr_scale"] == ref["lr_scale"]
        assert [(e["kind"], e["step"]) for e in got["mgr"]] == \
            [(e["kind"], e["step"]) for e in ref["mgr"]] == [
            ("snapshot", 0), ("snapshot", 2), ("rollback", 4),
            ("snapshot", 6)]
        for a, b in zip(got["mgr"], ref["mgr"]):
            assert a.get("restored_step") == b.get("restored_step")
            if "path" in a:
                assert os.path.basename(a["path"]) == \
                    os.path.basename(b["path"]) == "run.step00000000.npz"
        assert got["retained"] == ref["retained"] == [2, 6]
        for key in ("loss", "ce", "grad_norm", "lr", "lr_scale"):
            _close([h[key] for h in got["hist"]],
                   [h[key] for h in ref["hist"]], 1e-4, f"{rank} {key}")
        assert [i for i, h in enumerate(got["hist"])
                if math.isnan(h["loss"])] == [3, 4, 5]
        mesh = Mesh((2, 2), ("data", "model"), rank, groups=False)
        full = ref["final"]
        want = local_tree(full, Model(cfg, device="cpu").param_specs(
            full, mesh, dims_for(cfg)), mesh)
        _walk(got["final"], want, lr, f"rank {rank}")
    assert sorted(os.listdir(os.path.join(tmp, "port"))) == \
        sorted(os.listdir(os.path.join(tmp, "jax"))) == [
        "run.step00000002.npz", "run.step00000006.npz"]


def test_checkpoint_files_cross_layouts(runs):
    """(b): the port's step-6 file against JAX's (keys, shapes, dtype
    table; values within (a)'s tolerance); JAX's file restored by each
    rank is ``local_shard`` of its arrays, bitwise; the port's file
    restored on (1, 4) and loaded on one rank is the (2, 2) shards'
    ``gather_full``, bitwise."""
    import json

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.checkpoint.ckpt import _spec_table
    from repro_torch.optim import opt_state_specs
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.sharding import local_shard
    tmp, ref, ranks = runs
    jz = np.load(os.path.join(tmp, JAX_STEP6))
    pz = np.load(os.path.join(tmp, PORT_STEP6))
    assert set(jz.files) == set(pz.files)
    for k in set(jz.files) - {"__manifest__"}:
        assert jz[k].shape == pz[k].shape and jz[k].dtype == pz[k].dtype, k
    assert set(json.loads(bytes(jz["__manifest__"]))) == \
        set(json.loads(bytes(pz["__manifest__"])))
    assert json.loads(bytes(jz["__dtypes__"])) == \
        json.loads(bytes(pz["__dtypes__"])) == {}
    assert int(pz["__step__"]) == int(jz["__step__"]) == 6
    lr = max(h["lr"] for h in ref["hist"])
    for k in jz.files:
        if k.startswith("params/") and "/attn/bk" not in k:
            _walk(pz[k], jz[k], lr, k)
    whole = ranks[0]["whole"]
    tree, step = load_checkpoint(os.path.join(tmp, PORT_STEP6))
    flat = {}

    def walk(node, pre):
        for key, v in node.items():
            if isinstance(v, dict):
                walk(v, pre + key + "/")
            else:
                flat[pre + key] = v.numpy()
    walk(tree, "")
    assert step == 6 and set(flat) == set(whole)
    for k in whole:
        assert np.array_equal(flat[k], whole[k]), k
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    cfg = get_config("gpt2-moe").reduced()
    model = Model(cfg, device="cpu")
    for rank, got in enumerate(ranks):
        assert got["reshard"] == [], (rank, got["reshard"])
        step, restored = got["from_jax"]
        assert step == 6 and set(restored) == set(whole)
        mesh = Mesh((2, 2), ("data", "model"), rank, groups=False)
        pspecs = model.param_specs(ref["final"], mesh, dims_for(cfg))
        table = _spec_table({"params": pspecs,
                             "opt_state": opt_state_specs(pspecs)})
        for k, a in restored.items():
            assert np.array_equal(a, local_shard(jz[k], table[k], mesh)), \
                (rank, k)


def test_rank0_stream_follows_jaxs(runs):
    """(c): rank 0's stream, event by event against JAX's (train_step,
    guard_skip, guard_rollback): kinds and guard fields exact, losses
    within 1e-4; its directory holds that one stream."""
    from repro_torch.obs.sink import read_events
    tmp, ref, ranks = runs
    kinds = ("train_step", "guard_skip", "guard_rollback", "fp8_fallback")
    got = [e for e in read_events(ranks[0]["metrics"])
           if e["event"] in kinds]
    want = [e for e in read_events(ref["metrics"]) if e["event"] in kinds]
    assert [e["event"] for e in got] == [e["event"] for e in want]
    assert [e["event"] for e in got].count("guard_rollback") == 1
    for a, b in zip(got, want):
        assert a["step"] == b["step"], (a, b)
        if a["event"] == "train_step":
            _close([a["loss"]], [b["loss"]], 1e-4, a["step"])
        else:
            fields = set(b) - {"t", "seq", "loss"}
            assert {k: a[k] for k in fields} == {k: b[k] for k in fields}
    assert all(r.get("metrics") is None for r in ranks[1:])
    assert os.listdir(os.path.join(tmp, "port_metrics")) == \
        ["metrics-000.jsonl"]


def test_fp8_saturation_is_counted_over_the_world(runs):
    """(d): the fallback at step 0 on every rank; the world's counts the
    sum of the ranks' own; the rate within 1e-3 of JAX's step-0 global
    rate; rank 0's ``fp8_sat`` events, one per rank and encode, sum to
    the world's."""
    from repro_torch.obs.sink import read_events
    tmp, ref, ranks = runs
    world = ranks[0]["fp8"]["world"]
    steps = [r["fp8"]["local"] for r in ranks]
    assert all(len(s) == len(steps[0]) for s in steps)
    assert tuple(map(sum, zip(*[s[0] for s in steps]))) == tuple(world)
    # the fallback after step 0: no fp8 encode from step 1 on
    assert all(s[1:] == [(0, 0)] * (len(s) - 1) for s in steps)
    for r in ranks:
        assert r["fp8"]["world"] == world
        assert [e["kind"] for e in r["fp8"]["events"]] == ["fp8_fallback"]
        assert r["fp8"]["events"] == ranks[0]["fp8"]["events"]
    jsat, jtotal = ref["fp8"]["counts"]
    assert world[1] == jtotal
    np.testing.assert_allclose(world[0] / world[1], jsat / jtotal,
                               rtol=1e-3)
    np.testing.assert_allclose(ranks[0]["fp8"]["events"][0]["sat_rate"],
                               ref["fp8"]["events"][0]["sat_rate"],
                               rtol=1e-3)
    sat = [e for e in read_events(ranks[0]["fp8_metrics"])
           if e["event"] == "fp8_sat"]
    assert sum(e["sat"] for e in sat) == world[0]
    assert {e["rank"] for e in sat} == {0, 1, 2, 3}
    assert all(e["step"] == 0 for e in sat)


@pytest.mark.parametrize("sched", SCHEDS)
def test_layer_harness_on_the_mesh(runs, sched):
    """(e): the mesh harness's plan has JAX's stages, each prefix's probe
    within 1e-5 of JAX's, and the audit prices them as JAX's model."""
    _, ref, ranks = runs
    want = ref["layer"][sched]
    for rank, got in enumerate(ranks):
        g = got["layer"][sched]
        assert g["stages"] == want["stages"], rank
        np.testing.assert_allclose(g["probe"], want["probe"], rtol=1e-5,
                                   err_msg=f"rank {rank}")
        assert g["priced"] == want["priced"], rank


def test_a_rank_that_decides_otherwise_makes_every_rank_raise(runs):
    """(f): rank 1 skips where the others apply: all four raise in the
    agreement all-gather, naming every rank's decision."""
    _, _, ranks = runs
    for rank, got in enumerate(ranks):
        assert "ranks disagree on the guard's decision at step 0" in \
            got["disagree"], (rank, got["disagree"])


def test_plain_loop_checkpoints_across_ranks(runs):
    """The unguarded loop on the mesh: its ``ckpt_every`` file (taken at
    the last step) is the ranks' state gathered whole, bitwise, and rank
    0's sink holds its logged steps."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.obs.sink import read_events
    tmp, _, ranks = runs
    assert [r["plain"]["steps"] for r in ranks] == [[0, 2]] * 4
    tree, step = load_checkpoint(os.path.join(tmp, "plain", "run.npz"))
    whole = ranks[0]["plain"]["whole"]
    flat = dict(zip(_paths(tree), _flat(tree)))
    assert step == 2 and set(flat) == set(whole)
    for k, w in whole.items():
        assert np.array_equal(flat[k].numpy(), w), k
    assert [e["step"] for e in read_events(ranks[0]["plain_metrics"])
            if e["event"] == "train_step"] == [0, 2]


def test_clean_guarded_step_is_the_plain_step(runs):
    """(g): no fault, lr_scale 1: parameters, moments, step counter and
    loss ``torch.equal`` to the plain 4-rank step on every rank."""
    _, _, ranks = runs
    assert [r["clean"] for r in ranks] == [True] * 4


def test_the_launcher_runs_a_faulted_run_on_four_ranks(tmp_path):
    """The launcher across ranks with faults, checkpoints, a sink, the
    stage trace and a record: one rollback to step 0, the chaos contract,
    rank 0's one stream (meta: 4 devices, the mesh) and trace file."""
    import json
    mdir, log = str(tmp_path / "m"), str(tmp_path / "m" / "log.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gpt2-moe", "--reduced", "--device", "cpu", "--nproc", "4",
         "--mesh", "data=2,model=2", "--dist-backend", "gloo", "--steps",
         "8", "--seq", "32", "--faults", SPEC, "--ckpt",
         str(tmp_path / "ck"), "--max-skips", "2", "--metrics-dir", mdir,
         "--trace", "--log-json", log], env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count(
        "ROLLBACK -> re-anchored to checkpoint step 0") == 1, r.stdout
    assert r.stdout.count("CHAOS TRAIN OK") == 1
    assert sorted(os.listdir(mdir)) == ["log.json", "metrics-000.jsonl",
                                        "trace_s1.json"]
    rec = json.load(open(log))
    assert [_event(e) for e in rec["guard_events"]] == [
        ("skip", 3, 1, None), ("skip", 4, 2, None), ("rollback", 4, None, 0),
        ("skip", 5, 1, None)]
    meta = json.loads(open(os.path.join(mdir, "metrics-000.jsonl"))
                      .readline())
    assert meta["n_devices"] == 4 and meta["mesh"] == {"data": 2,
                                                       "model": 2}
