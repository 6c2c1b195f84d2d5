"""Expert placement across ranks: the port's placed MoE layer, its
``Trainer`` and its mesh ``Engine`` with ``placement="auto"`` on gloo
ranks against the JAX package's on host meshes of CPU devices.

(a) The layer (``apply_moe`` with ``MoEConfig(placement=...)``) on the
    merged ``(data=2, model=2)`` mesh (4 ranks) and the distinct ``(ep=2,
    esp=2, mp=2)`` mesh (8 ranks), EP over two ranks: s1, s2 and s1g
    (the pool form: the placed counts AlltoAll and ``expert_ffn_ragged``)
    at f32, s1 on the bf16 wire, s2 in 2 chunks and, on the merged mesh,
    s1g in 2 chunks (the chunked placed counts: the cost model's pick on
    the card is s1g in 4), each under three
    placements of ``tests/helpers/run_placement_parity.py``: identity
    (the whole placement path, bitwise equal to the port's own unplaced
    run: output, aux and every gradient), rep2 (every expert twice on
    distinct ranks at half capacity, with real drops) and hot (expert 0
    on every spare slot, full capacity, drop-free), each against JAX's
    ``apply_moe`` with the same placement: ``expert_load``, ``drop_frac``
    and the drop mask (the rows the layer zeroes) exact; the aux and z
    losses 1e-6 relative; y rtol 2e-4 / atol 2e-5 and every gradient 1e-4
    of its largest entry at f32 (``test_torch_moe_dist.py``'s rules; on
    the bf16 wire its rule of one wire step for at most 1% of the
    elements).  The gradients of the placed weights cross the EP group
    home (``moe._SlotExchange``).
(b) gpt2-moe (reduced, capacity factor 2.0, the gate skewed toward expert
    0 through the sinusoidal positions' features: ``wg[1::2, 0] += 0.3``)
    trained 4 steps under ``schedule="auto"``, ``placement="auto"`` and
    ``rebalance_every=1`` by the port's ``Trainer`` on the (2, 2) mesh and
    the JAX ``Trainer`` on a (2, 2) host mesh, both priced by JAX's
    ``tpu_v5e_model`` (copied into the port's ``PerfModel``): the same
    ``train_rebalance`` events (step, epoch, placement) on every rank,
    losses 1e-4.  The JAX loops' re-jit after a rebalance hits jax's
    trace cache and would keep the placement first traced (as their fp8
    fallback does, ``test_torch_runtime.py``), so the JAX script clears
    that cache as each placement is installed: the port's steps are held
    to freshly traced JAX steps under the placement installed.
(c) reduced qwen3-moe-30b-a3b with top-2 routing served by the port's
    mesh ``Engine`` and the JAX ``Engine`` with ``placement="auto"``,
    ``rebalance_every=2`` and ``rebalance_margin=0.5`` (the cost model
    prices replication at decode sizes within a few percent of uniform:
    this margin lets the loop install a placement and clear it again):
    the same ``serve_rebalance`` events on every rank and equal streams.
(d) A rank that would install another placement than the others makes
    ``maybe_rebalance`` raise on every rank.

Three JAX subprocesses (8 host devices each: (b) and (c), and (a) on
either mesh) serve the module beside one spawn per mesh; the merged
spawn's (b) and (c) start once JAX has written their parameters.
"""

import dataclasses
import importlib.util
import json
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

M, F, E, K = 32, 64, 8, 2
MESHES = {
    "merged": ((2, 2), ("data", "model"),
               dict(ep=("data",), esp=("model",), mp=("model",))),
    "distinct": ((2, 2, 2), ("ep", "esp", "mp"),
                 dict(ep=("ep",), esp=("esp",), mp=("mp",))),
}
# (name, schedule, pipeline_chunks, wire)
SCHEDS = [("s1", "s1", 1, "f32"), ("s2", "s2", 1, "f32"),
          ("s1g", "s1g", 1, "f32"), ("s1-bf16", "s1", 1, "bf16"),
          ("s2_pipe2", "s2", 2, "f32"), ("s1g_pipe2", "s1g", 2, "f32")]
#: the cases each mesh runs: the chunked s1g (the card's pick) on the
#: merged mesh, the launchers' and the card's
CASES_OF = {"merged": [c[0] for c in SCHEDS],
            "distinct": [c[0] for c in SCHEDS if c[0] != "s1g_pipe2"]}
PLACEMENTS = ("identity", "rep2", "hot")
#: capacity factor per placement: drops under identity / rep2, none hot
FACTOR = {"identity": 0.5, "rep2": 0.5, "hot": 6.0}
GRADS = ("x", "wg", "w1", "w2", "w3")
STEPS = 4
TRAIN_DATA = dict(seq_len=32, global_batch=8)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)
SERVE_KW = dict(max_batch=4, max_len=32, block_size=8, placement="auto",
                rebalance_every=2, rebalance_margin=0.5)
GEN = 8


def placement_args(name, n_ep=2):
    """``run_placement_parity.py``'s placements as constructor kwargs."""
    if name == "identity":
        return dict(n_experts=E, n_ep=n_ep, assignments=tuple(range(E)))
    if name == "rep2":
        per = 2 * E // n_ep
        return dict(n_experts=E, n_ep=n_ep, cap_frac=0.5, assignments=tuple(
            (r * (E // n_ep) + i) % E for r in range(n_ep)
            for i in range(per)))
    R = -(-(E + n_ep - 1) // n_ep) * n_ep + n_ep
    return dict(n_experts=E, n_ep=n_ep, cap_frac=1.0, assignments=tuple(
        sorted([0] * (R - E + 1) + list(range(1, E)))))


def _prompts(vocab=512):
    rng = np.random.RandomState(0)
    return [[int(t) for t in rng.randint(0, vocab, n)] for n in (5, 8, 6, 7)]


JAX_SCRIPT = r'''
import os, pickle, sys
from dataclasses import replace
import jax
import jax.numpy as jnp
import numpy as np
from repro import obs
from repro.configs import get_config
from repro.core import autosched
from repro.core.collectives import CommConfig
from repro.core.moe import MoEConfig, apply_moe
from repro.core.placement import ExpertPlacement
from repro.data import DataConfig, SyntheticLM
from repro.models import build_model
from repro.obs.sink import read_events
from repro.optim import AdamWConfig
from repro.parallel.mesh import ParallelDims, make_mesh
from repro.serve import Engine
from repro.train import Trainer

tmp, part = sys.argv[1], sys.argv[3]
(layer_cases, cases_of, meshes, pls, factor, steps, data_kw, opt_kw,
 prompts, gen, serve_kw) = eval(sys.argv[2])


def dump(obj, name):
    with open(os.path.join(tmp, name + ".tmp"), "wb") as f:
        pickle.dump(obj, f)
    os.replace(os.path.join(tmp, name + ".tmp"), os.path.join(tmp, name))


def host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def loops():
    # the Trainer's and the Engine's re-jit after a rebalance hits jax's
    # trace cache (the step function is the same object), so the JAX loops
    # would keep running the placement they first traced; a fresh trace
    # per installed placement makes them run what they installed, as the
    # port does
    set_placement = autosched.set_placement

    def fresh_trace(pl):
        jax.clear_caches()
        return set_placement(pl)

    autosched.set_placement = fresh_trace
    mesh4 = make_mesh((2, 2), ("data", "model"))
    dims4 = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
    # (b) and (c)'s parameters first: the ranks wait for them
    tcfg = get_config("gpt2-moe").reduced()
    tcfg = replace(tcfg, moe=replace(tcfg.moe, capacity_factor=2.0,
                                     placement="auto"))
    tr = Trainer(build_model(tcfg), mesh4, dims4, AdamWConfig(**opt_kw),
                 placement="auto", rebalance_every=1)
    tparams, topt = tr.setup(jax.random.PRNGKey(0))

    def skew(path, a):
        if path[-1].key == "wg":
            return jax.device_put(a.at[..., 1::2, 0].add(0.3), a.sharding)
        return a

    tparams = jax.tree_util.tree_map_with_path(skew, tparams)
    scfg = get_config("qwen3-moe-30b-a3b").reduced()
    scfg = replace(scfg, moe=replace(scfg.moe, top_k=2, placement="auto"))
    smodel = build_model(scfg)
    sparams = smodel.init(jax.random.PRNGKey(0))
    dump({"train": host(tparams), "serve": host(sparams)}, "init.pkl")
    out = {}
    # (b) training with the rebalance loop
    autosched.clear_cache()
    obs.configure(os.path.join(tmp, "jax_train"), meta={"kind": "train"})
    data = SyntheticLM(DataConfig(vocab_size=tcfg.vocab_size, **data_kw))
    _, _, hist = tr.run(tparams, topt, data, steps, log_every=1)
    paths = list(obs.get_sink().paths)
    obs.close()
    out["train"] = {"hist": hist, "events": [
        e for e in read_events(paths) if e["event"] == "train_rebalance"]}
    # (c) serving with the rebalance loop
    autosched.clear_cache()
    obs.configure(os.path.join(tmp, "jax_serve"), meta={"kind": "serve"})
    eng = Engine(smodel, mesh4, dims4, **serve_kw)
    for p in prompts:
        eng.submit(p, gen)
    done = eng.run(sparams)
    paths = list(obs.get_sink().paths)
    obs.close()
    out["serve"] = {"tokens": [c.tokens for c in done], "events": [
        e for e in read_events(paths) if e["event"] == "serve_rebalance"]}
    return out


def layers(mk):
    # (a) the layer under each placement on mesh ``mk``
    out = {}
    inp = dict(np.load(os.path.join(tmp, "layer_in.npz")))
    shape, names, dkw = meshes[mk]
    mesh = make_mesh(tuple(shape), tuple(names))
    dims = ParallelDims(**dkw)
    for name, sched, chunks, wire in layer_cases:
        if name not in cases_of[mk]:
            continue
        for pl in pls:
            f = factor[pl]
            cfg = MoEConfig(d_model=%(M)d, d_ff=%(F)d, n_experts=%(E)d,
                            top_k=%(K)d, capacity_factor=f, glu=True,
                            schedule=sched, pipeline_chunks=chunks,
                            comm=CommConfig(wire_dtype=wire),
                            placement=ExpertPlacement(**pls[pl]))
            tag = f"{f}:"
            x = jnp.asarray(inp[tag + "x"])
            r = jnp.asarray(inp[tag + "r"])
            p = {k: jnp.asarray(inp[tag + k])
                 for k in ("wg", "w1", "w2", "w3")}

            def loss(x, p):
                y, aux = apply_moe(x, p, mesh=mesh, dims=dims, cfg=cfg)
                return jnp.sum(y * r) + aux["aux_loss"] + aux["z_loss"], \
                    (y, aux)

            (_, (y, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(x, p)
            key = f"{mk}:{name}:{pl}:"
            out[key + "y"] = np.asarray(y)
            for k, v in aux.items():
                out[key + "aux:" + k] = np.asarray(v)
            out[key + "g:x"] = np.asarray(gx)
            for k, v in gp.items():
                out[key + "g:" + k] = np.asarray(v)
    return out


dump(loops() if part == "loops" else layers(part), "jax_" + part + ".pkl")
''' % dict(M=M, F=F, E=E, K=K)


def _layer_inputs():
    """Per capacity factor: router skewed toward experts 0 and 1 through
    feature 0, pinned to 1 (``run_placement_parity.py``'s inputs), 1024
    tokens (256 a token shard on either mesh: rep2's half capacity stays
    a multiple of 8, so its effective capacities are the unplaced ones)."""
    rng = np.random.RandomState(13)
    out = {}
    for f in sorted(set(FACTOR.values())):
        wg = rng.randn(M, E) / np.sqrt(M) * 0.05
        wg[0] += np.array([8.0, 4.0] + [0.0] * (E - 2))
        x = rng.randn(64, 16, M)
        x[..., 0] = 1.0
        out.update({f"{f}:wg": wg, f"{f}:x": x,
                    f"{f}:r": rng.randn(64, 16, M),
                    f"{f}:w1": rng.randn(E, M, F) / np.sqrt(M),
                    f"{f}:w2": rng.randn(E, F, M) / np.sqrt(F),
                    f"{f}:w3": rng.randn(E, M, F) / np.sqrt(M)})
    return {k: v.astype(np.float32) for k, v in out.items()}


def _wait_for(path, deadline):
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


def _layer(mesh, dims, inp, name_sched, pl, placed=True):
    """One case through the port: y, aux and the gradient blocks."""
    import torch
    from repro_torch.core.collectives import CommConfig
    from repro_torch.core.moe import MoEConfig, apply_moe, moe_param_specs
    from repro_torch.core.placement import ExpertPlacement
    from repro_torch.parallel.sharding import P, local_shard
    from repro_torch.train.loop import sync_grads
    _, sched, chunks, wire = name_sched
    f = FACTOR[pl]
    cfg = MoEConfig(d_model=M, d_ff=F, n_experts=E, top_k=K,
                    capacity_factor=f, glu=True, schedule=sched,
                    pipeline_chunks=chunks, comm=CommConfig(wire_dtype=wire),
                    placement=ExpertPlacement(**placement_args(pl))
                    if placed else None)
    specs = moe_param_specs(cfg, mesh, dims)
    xs = P(dims.batch_axes, None, None)

    def block(k, spec):
        return torch.from_numpy(np.ascontiguousarray(
            local_shard(inp[f"{f}:{k}"], spec, mesh)))
    x = block("x", xs).requires_grad_()
    r = block("r", xs)
    p = {k: block(k, specs[k]).requires_grad_() for k in GRADS[1:]}
    y, aux = apply_moe(x, p, cfg=cfg, mesh=mesh, dims=dims)
    loss = (y * r).sum() + aux["aux_loss"] + aux["z_loss"]
    grads = torch.autograd.grad(loss, [x, *p.values()])
    grads = [grads[0]] + sync_grads(list(grads[1:]),
                                    [specs[k] for k in GRADS[1:]], mesh,
                                    dims)
    return {"y": y.detach().numpy(),
            "aux": {k: v.detach().numpy() for k, v in aux.items()},
            "g": {k: g.numpy() for k, g in zip(GRADS, grads)}}


def _rank(rank, mesh_kind, inp, tmp, model):
    """One rank: (a) on ``mesh_kind``; on the merged mesh also (d), (b)
    and (c), priced by ``model`` (JAX's ``tpu_v5e_model(2, 2, 2)`` as the
    port's ``PerfModel``)."""
    from repro_torch.core import autosched
    from repro_torch.parallel.mesh import ParallelDims, make_mesh
    autosched.h100_model = lambda n_ep, n_esp, n_mp: model
    shape, names, dkw = MESHES[mesh_kind]
    mesh = make_mesh(shape, names)
    dims = ParallelDims(**dkw)
    out = {}
    for case in [c for c in SCHEDS if c[0] in CASES_OF[mesh_kind]]:
        out[f"{case[0]}:none"] = _layer(mesh, dims, inp, case, "identity",
                                        placed=False)
        for pl in PLACEMENTS:
            out[f"{case[0]}:{pl}"] = _layer(mesh, dims, inp, case, pl)
    if mesh_kind != "merged":
        return out
    out.update(_disagree(rank, mesh))
    _wait_for(os.path.join(tmp, "init.pkl"), time.monotonic() + 240)
    with open(os.path.join(tmp, "init.pkl"), "rb") as f:
        init = pickle.load(f)
    out["train"] = _train(rank, mesh, init["train"], tmp)
    out["serve"] = _serve(rank, mesh, init["serve"], tmp)
    return out


def _disagree(rank, mesh):
    """(d): rank 0 sees a hot expert, the others even loads."""
    from repro_torch.core import autosched
    from repro_torch.core.perfmodel import MoELayerShape
    autosched.clear_cache()
    autosched.decide(MoELayerShape(B=8, L=128, M=512, H=2048, E=8, k=2,
                                   f=1.2, n_mp=2, n_esp=2, n_ep=2))
    loads = [8.0] + [1.0] * 7 if rank == 0 else [1.0] * 8
    try:
        autosched.maybe_rebalance(loads, capacity_factor=1.2, top_k=2,
                                  mesh=mesh)
        msg = "no error"
    except RuntimeError as e:
        msg = str(e)
    installed = autosched.current_placement()
    autosched.clear_cache()
    return {"disagree": msg, "installed": installed is not None}


def _events(path, kind):
    from repro_torch.obs.sink import read_events
    return [e for e in read_events(path) if e["event"] == kind]


def _train(rank, mesh, init, tmp):
    """(b) on this rank: the port's Trainer from JAX's skewed parameters,
    its events in a sink of its own."""
    from dataclasses import replace

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core import autosched
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import Trainer
    cfg = get_config("gpt2-moe").reduced()
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=2.0,
                                   placement="auto"))
    dims = dims_for(cfg)
    autosched.clear_cache()
    tr = Trainer(Model(cfg, device="cpu"), AdamWConfig(**OPT), mesh=mesh,
                 dims=dims, placement="auto", rebalance_every=1)
    params = params_from_jax(init, cfg, device="cpu", mesh=mesh, dims=dims)
    obs.configure(os.path.join(tmp, f"port_train_{rank}"),
                  meta={"kind": "train"})
    try:
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      **TRAIN_DATA))
        _, _, hist = tr.run(params, adamw_init(params), data, STEPS,
                            log_every=1)
        paths = list(obs.get_sink().paths)
    finally:
        obs.close()
    pl = autosched.current_placement()
    autosched.clear_cache()
    return {"hist": hist, "events": _events(paths, "train_rebalance"),
            "load_events": len(_events(paths, "expert_load")),
            "installed": None if pl is None else pl.summary()}


def _serve(rank, mesh, init, tmp):
    """(c) on this rank: the port's mesh Engine, its events in a sink of
    its own (only rank 0 writes telemetry: the others' sinks stay empty)."""
    from dataclasses import replace

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core import autosched
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.serve import Engine
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    cfg = replace(cfg, moe=replace(cfg.moe, top_k=2, placement="auto"))
    dims = dims_for(cfg)
    autosched.clear_cache()
    params = params_from_jax(init, cfg, device="cpu", mesh=mesh, dims=dims)
    obs.configure(os.path.join(tmp, f"port_serve_{rank}"),
                  meta={"kind": "serve"})
    rebalanced = []
    set_placement = autosched.set_placement

    def recording(pl):
        rebalanced.append(None if pl is None else pl.summary())
        return set_placement(pl)

    autosched.set_placement = recording
    try:
        eng = Engine(Model(cfg, device="cpu"), mesh, dims, **SERVE_KW)
        for p in _prompts(cfg.vocab_size):
            eng.submit(p, GEN)
        done = eng.run(params)
        paths = list(obs.get_sink().paths)
    finally:
        autosched.set_placement = set_placement
        obs.close()
    autosched.clear_cache()
    return {"tokens": [c.tokens for c in done],
            "events": _events(paths, "serve_rebalance"),
            "installed": rebalanced, "load": eng.stats.get("per_expert_load")}


def _port_model():
    """JAX's ``tpu_v5e_model(2, 2, 2)`` as the port's ``PerfModel``."""
    from repro.core import perfmodel as jperf
    from repro_torch.core import perfmodel as tperf
    jm = jperf.tpu_v5e_model(2, 2, 2)

    def conv(v):
        if isinstance(v, jperf.AlphaBeta):
            return tperf.AlphaBeta(alpha=v.alpha, beta=v.beta)
        return v
    return tperf.PerfModel(**{f.name: conv(getattr(jm, f.name))
                              for f in dataclasses.fields(jm)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    tmp = str(tmp_path_factory.mktemp("placement_dist"))
    inp = _layer_inputs()
    np.savez(os.path.join(tmp, "layer_in.npz"), **inp)
    args = (SCHEDS, CASES_OF, {k: (list(v[0]), list(v[1]), v[2])
                     for k, v in MESHES.items()},
            {p: placement_args(p) for p in PLACEMENTS}, FACTOR, STEPS,
            TRAIN_DATA, OPT, _prompts(), GEN, SERVE_KW)
    model = _port_model()
    parts = ["loops", *MESHES]          # one JAX process each, side by side
    jax_runs = {}
    try:
        for part in parts:
            with open(os.path.join(tmp, f"jax_{part}.err"), "w") as err:
                jax_runs[part] = subprocess.Popen(
                    [sys.executable, "-c", JAX_SCRIPT, tmp, repr(args),
                     part], env=subprocess_env(8),
                    stdout=subprocess.DEVNULL, stderr=err)
        ranks = {mk: spawn(_rank, int(np.prod(MESHES[mk][0])), mk, inp,
                           tmp, model, backend="gloo", device="cpu",
                           threads=1, timeout=300)
                 for mk in MESHES}
        for run in jax_runs.values():
            run.wait(timeout=300)
    finally:
        for run in jax_runs.values():
            if run.poll() is None:
                run.kill()
    want = {}
    for part, run in jax_runs.items():
        assert run.returncode == 0, open(os.path.join(
            tmp, f"jax_{part}.err")).read()[-3000:]
        with open(os.path.join(tmp, f"jax_{part}.pkl"), "rb") as f:
            want.update(pickle.load(f))
    return ranks, want


#: one rounding step of the wire format, relative to the largest entry
WIRE_STEP = {"bf16": 2.0 ** -8}


def _close(got, want, wire, what):
    """1e-4 of the largest entry; on a bf16 wire up to 1% of the elements
    may be off by one wire rounding step (``test_torch_moe_dist.py``)."""
    scale = max(1.0, float(np.abs(want).max()))
    if wire == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=what)
        return
    diff = np.abs(np.asarray(got, np.float64) - want)
    off = int((diff > 1e-4 * scale).sum())
    assert off <= max(1, diff.size // 100), (what, off, diff.size)
    assert diff.max() <= WIRE_STEP[wire] * scale, (what, diff.max())


LAYER_CASES = [(mk, c, pl) for mk in MESHES for c in SCHEDS
               if c[0] in CASES_OF[mk] for pl in PLACEMENTS]


@pytest.mark.parametrize("mk,case,pl", LAYER_CASES,
                         ids=[f"{m}-{c[0]}-{p}" for m, c, p in LAYER_CASES])
def test_placed_layer_matches_jax(runs, mk, case, pl):
    from repro_torch.core.moe import MoEConfig, moe_param_specs
    from repro_torch.parallel.mesh import Mesh, ParallelDims
    from repro_torch.parallel.sharding import P, local_shard
    ranks, want = runs
    name, _, _, wire = case
    shape, names, dkw = MESHES[mk]
    dims = ParallelDims(**dkw)
    cfg = MoEConfig(d_model=M, d_ff=F, n_experts=E, top_k=K)
    key = f"{mk}:{name}:{pl}:"
    for rank, got in enumerate(ranks[mk]):
        mine, unplaced = got[f"{name}:{pl}"], got[f"{name}:none"]
        tag = f"{key} rank {rank}"
        if pl == "identity":
            # the whole placement path, bitwise the unplaced layer
            np.testing.assert_array_equal(mine["y"], unplaced["y"], tag)
            for k in mine["aux"]:
                np.testing.assert_array_equal(mine["aux"][k],
                                              unplaced["aux"][k], tag + k)
            for k in GRADS:
                np.testing.assert_array_equal(mine["g"][k],
                                              unplaced["g"][k], tag + k)
        mesh = Mesh(shape, names, rank, groups=False)
        specs = moe_param_specs(cfg, mesh, dims)
        specs["x"] = P(dims.batch_axes, None, None)
        y_want = local_shard(want[key + "y"], specs["x"], mesh)
        np.testing.assert_array_equal((mine["y"] == 0).all(-1),
                                      (y_want == 0).all(-1), tag + " mask")
        if wire == "f32":
            np.testing.assert_allclose(mine["y"], y_want, rtol=2e-4,
                                       atol=2e-5, err_msg=tag + " y")
        else:
            _close(mine["y"], y_want, wire, tag + " y")
        for k in ("expert_load", "drop_frac"):
            np.testing.assert_array_equal(mine["aux"][k],
                                          want[key + "aux:" + k], tag + k)
        for k in ("aux_loss", "z_loss"):
            np.testing.assert_allclose(mine["aux"][k], want[key + "aux:" + k],
                                       rtol=1e-6, err_msg=tag + k)
        for k in GRADS:
            _close(mine["g"][k], local_shard(want[key + "g:" + k], specs[k],
                                             mesh), wire, f"{tag} grad {k}")
        drops = float(want[key + "aux:drop_frac"])
        assert (drops > 0) == (pl != "hot"), (tag, drops)


def test_trainer_rebalances_as_the_jax_trainer(runs):
    """(b): the same ``train_rebalance`` events (step, epoch, placement)
    on every rank as JAX's, a placement installed, losses 1e-4."""
    ranks, want = runs
    ref = want["train"]
    assert ref["events"], "the JAX trainer never rebalanced"
    strip = [{k: e[k] for k in ("step", "epoch", "placement")}
             for e in ref["events"]]
    for rank, r in enumerate(ranks["merged"]):
        got = r["train"]
        assert [{k: e[k] for k in ("step", "epoch", "placement")}
                for e in got["events"]] == strip, rank
        # the placement installed at the end, as the events wrote it
        assert json.loads(json.dumps(got["installed"])) == \
            strip[-1]["placement"], rank
        assert got["load_events"] == STEPS
        np.testing.assert_allclose([h["loss"] for h in got["hist"]],
                                   [h["loss"] for h in ref["hist"]],
                                   rtol=1e-4, err_msg=f"rank {rank}")
        assert [round(h["load_imbalance"], 6) for h in got["hist"]] == \
            [round(h["load_imbalance"], 6) for h in ref["hist"]]


def test_engine_rebalances_as_the_jax_engine(runs):
    """(c): rank 0's ``serve_rebalance`` events (epoch, placement, tick)
    JAX's, every rank installing the same placements, and every rank's
    streams JAX's."""
    ranks, want = runs
    ref = want["serve"]
    assert ref["events"], "the JAX engine never rebalanced"
    fields = ("epoch", "placement", "tick")
    r0 = ranks["merged"][0]["serve"]
    assert [{k: e[k] for k in fields} for e in r0["events"]] == \
        [{k: e[k] for k in fields} for e in ref["events"]]
    for rank, r in enumerate(ranks["merged"]):
        got = r["serve"]
        assert got["installed"] == r0["installed"], rank
        assert len(got["installed"]) == len(ref["events"]), rank
        assert got["tokens"] == ref["tokens"], rank
        assert rank == 0 or got["events"] == []


def test_a_rank_that_would_install_another_placement_raises(runs):
    """(d): every rank raises; none installs."""
    for r in runs[0]["merged"]:
        assert "ranks disagree on the expert placement" in r["disagree"], \
            r["disagree"]
        assert not r["installed"]

