"""The KV-cache serve path across ranks: ``prefill_step`` and
``decode_step`` on four gloo ranks of the ``(data=2, model=2)`` mesh
(attention heads, the FFN and the vocabulary Megatron-sharded over model),
against JAX's one-device ``prefill_step`` / ``decode_step`` from the same
JAX parameters (``params_from_jax``: each rank's shards).  JAX's results
do not depend on the cache's layout (``tests/helpers/run_cache_seqshard.py``
asserts it), so its one device is the reference for every layout.

Reduced mistral-nemo-12b (4 query and 4 kv heads of 64, vocabulary 512).
Cases, each with ``seq_shard`` False and True (``train.cache_specs``):

  (a) B=4, W=32: the batch over data, W over model; per-row steps;
  (b) B=1, W=64: the batch idle, W over data x model (16 slots a rank,
      so early in the decode two ranks hold only empty slots);
  (c) B=4, W=24: W fails JAX's rule (``W >= 16 * nw``) and stays whole;
  (d) (b) with one kv head, fewer than the MP ranks: its projection is
      replicated (``mp_heads``), so each rank computes the kv head itself
      where W is split, and keeps it where W is whole.

What must hold on every rank: the prompts' last logits and each decode
step's (fed JAX's greedy tokens) within rtol 2e-4 / atol 2e-5, phase 12's
output tolerance; the greedy token of every step JAX's; every cache leaf
``local_shard`` of JAX's cache under ``cache_specs``, within 1e-5, ``pos``
exact, after the prefill and after the decode; and one decode step's
collective bytes per kind the same with the cache at W and at 2W: no K or
V crosses ranks.

One JAX subprocess and one 4-rank spawn serve the module, side by side.
"""

import importlib.util
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

TOL = dict(rtol=2e-4, atol=2e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
GEN = 8
#: name -> (batch, prompt lengths, W, per-row steps, kv heads)
CASES = {"a": (4, (12, 9, 12, 7), 32, True, 4),
         "b": (1, (20,), 64, False, 4),
         "c": (4, (12, 10, 8, 12), 24, False, 4),
         "d": (1, (20,), 64, False, 1)}


def _cfg(get_config, n_kv):
    """Reduced mistral-nemo-12b (either package's) with ``n_kv`` kv heads."""
    import dataclasses
    return dataclasses.replace(get_config("mistral-nemo-12b").reduced(),
                               n_kv_heads=n_kv)


def _tokens(case, vocab=512):
    B, lens = CASES[case][:2]
    rng = np.random.RandomState(ord(case))
    return rng.randint(0, vocab, (B, max(lens))).astype(np.int32)


def _steps(case, t):
    _, lens, _, vector, _ = CASES[case]
    lens = np.asarray(lens, np.int32)
    return lens + t if vector else np.int32(max(lens) + t)


JAX_SCRIPT = r'''
import os, pickle, sys
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.models import build_model
from repro.parallel.mesh import ParallelDims, make_mesh

tmp = sys.argv[1]
cases, gen = eval(sys.argv[2])
sys.path.insert(0, sys.argv[3])
from test_torch_decode_dist import _cfg, _steps, _tokens


def dump(obj, name):
    with open(os.path.join(tmp, name + ".tmp"), "wb") as f:
        pickle.dump(obj, f)
    os.replace(os.path.join(tmp, name + ".tmp"), os.path.join(tmp, name))


def host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


models = {n: build_model(_cfg(get_config, n))
          for n in sorted({c[4] for c in cases.values()})}
params = {n: m.init(jax.random.PRNGKey(0)) for n, m in models.items()}
dump(host(params), "init.pkl")
mesh = make_mesh((1, 1), ("data", "model"))
dims = ParallelDims(dp=("data",), mp=("model",))
steps_of = {n: (jax.jit(lambda p, c, b, l, m=m: m.prefill_step(
                    p, c, b, lengths=l, mesh=mesh, dims=dims)),
                jax.jit(lambda p, c, b, m=m: m.decode_step(
                    p, c, b, mesh=mesh, dims=dims)))
            for n, m in models.items()}
out = {}
for name, (B, lens, W, _, n_kv) in cases.items():
    model, prefill, decode = models[n_kv], *steps_of[n_kv]
    params_n = params[n_kv]
    logits, cache = prefill(params_n, model.init_cache(B, W),
                            {"tokens": jnp.asarray(_tokens(name))},
                            jnp.asarray(np.asarray(lens, np.int32)))
    rec = {"prefill": np.asarray(logits), "cache0": host(cache)}
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
    toks, steps = [tok], []
    for t in range(gen):
        lg, cache = decode(params_n, cache, {"tokens": jnp.asarray(tok),
                                           "step": jnp.asarray(_steps(name, t))})
        steps.append(np.asarray(lg))
        tok = np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)[:, None]
        toks.append(tok)
    rec.update(steps=steps, tokens=toks, cache=host(cache))
    out[name] = rec
dump(out, "jax.pkl")
'''


def _rows(specs):
    """The spec of a (B, ...) array laid out as the cache's batch dim."""
    from repro_torch.parallel.sharding import P
    return P(specs["run0"]["attn"]["pos"][1])


def _wait_for(path, deadline):
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy().copy()


def _rank(rank, tmp):
    """Every case and layout on one rank of the (2, 2) mesh."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.parallel import comm
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import local_shard
    from repro_torch.train import cache_specs
    _wait_for(os.path.join(tmp, "init.pkl"), time.monotonic() + 240)
    with open(os.path.join(tmp, "init.pkl"), "rb") as f:
        init = pickle.load(f)
    _wait_for(os.path.join(tmp, "jax.pkl"), time.monotonic() + 240)
    with open(os.path.join(tmp, "jax.pkl"), "rb") as f:
        want = pickle.load(f)
    mesh = make_mesh((2, 2), ("data", "model"))
    models = {}
    for n_kv, tree in init.items():
        cfg = _cfg(get_config, n_kv)
        models[n_kv] = (Model(cfg, device="cpu"), params_from_jax(
            tree, cfg, device="cpu", mesh=mesh, dims=dims_for(cfg)))
    dims = dims_for(cfg)

    def start(case, W, seq_shard):
        B, lens = CASES[case][:2]
        model, params = models[CASES[case][4]]
        specs = cache_specs(model, mesh, dims, B, W, seq_shard=seq_shard)
        rows = _rows(specs)
        cache = model.init_cache(B, W, mesh=mesh, dims=dims, specs=specs)
        with torch.no_grad():
            logits, cache = model.prefill_step(
                params, cache,
                {"tokens": torch.from_numpy(local_shard(_tokens(case), rows,
                                                        mesh))},
                lengths=torch.from_numpy(local_shard(
                    np.asarray(lens, np.int32), rows, mesh)),
                mesh=mesh, dims=dims, specs=specs)
        return specs, rows, cache, logits

    def step_bytes(case, W, seq_shard, tok, t, rows):
        specs, _, cache, _ = start(case, W, seq_shard)
        model, params = models[CASES[case][4]]
        comm.timing(True)
        with torch.no_grad():
            model.decode_step(params, cache, {
                "tokens": tok, "step": torch.from_numpy(np.asarray(
                    local_shard(np.atleast_1d(_steps(case, t)), rows, mesh)
                    if CASES[case][3] else _steps(case, t)))},
                mesh=mesh, dims=dims, specs=specs)
        got = {k: (v[0], v[1]) for k, v in comm.times().items()
               if k != "in_flight"}
        comm.timing(False)
        return got

    out = {}
    for case, (B, lens, W, vector, n_kv) in CASES.items():
        model, params = models[n_kv]
        for seq_shard in (False, True):
            specs, rows, cache, logits = start(case, W, seq_shard)
            rec = {"specs": specs, "prefill": logits.numpy().copy(),
                   "cache0": _numpy(cache), "steps": [], "tokens": []}
            for t in range(GEN):
                tok = torch.from_numpy(local_shard(want[case]["tokens"][t],
                                                   rows, mesh))
                step = _steps(case, t)
                if vector:
                    step = local_shard(step, rows, mesh)
                with torch.no_grad():
                    lg, cache = model.decode_step(
                        params, cache, {"tokens": tok,
                                        "step": torch.from_numpy(
                                            np.asarray(step))},
                        mesh=mesh, dims=dims, specs=specs)
                rec["steps"].append(lg.numpy().copy())
                rec["tokens"].append(lg[:, -1].argmax(-1).numpy().copy())
            rec["cache"] = _numpy(cache)
            if case != "c":
                rec["bytes"] = [step_bytes(case, w, seq_shard, tok, GEN - 1,
                                           rows) for w in (W, 2 * W)]
            out[(case, seq_shard)] = rec
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    tmp = str(tmp_path_factory.mktemp("decode_dist"))
    with open(os.path.join(tmp, "jax.err"), "w") as err:
        jax_run = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, tmp, repr((CASES, GEN)),
             os.path.dirname(__file__)],
            env=subprocess_env(1), stdout=subprocess.DEVNULL, stderr=err)
        try:
            _wait_for(os.path.join(tmp, "init.pkl"), time.monotonic() + 240)
            ranks = spawn(_rank, 4, tmp, backend="gloo", device="cpu",
                          threads=1, timeout=240)
            jax_run.wait(timeout=240)
        finally:
            if jax_run.poll() is None:
                jax_run.kill()
    assert jax_run.returncode == 0, open(os.path.join(tmp, "jax.err")).read(
        )[-3000:]
    with open(os.path.join(tmp, "jax.pkl"), "rb") as f:
        want = pickle.load(f)
    return ranks, want


def _layout(rank):
    from repro_torch.parallel.mesh import Mesh
    return Mesh((2, 2), ("data", "model"), rank)


def _shard_tree(tree, specs, mesh):
    from repro_torch.parallel.sharding import local_shard
    if isinstance(tree, dict):
        return {k: _shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return local_shard(np.asarray(tree), specs, mesh)


def _check_cache(got, want, specs, mesh):
    if isinstance(got, dict):
        for k in got:
            _check_cache(got[k], want[k], specs[k], mesh)
        return
    from repro_torch.parallel.sharding import local_shard
    w = local_shard(np.asarray(want), specs, mesh)
    if got.dtype == np.int32:
        np.testing.assert_array_equal(got, w)
    else:
        np.testing.assert_allclose(got, w, **CACHE_TOL)


CASE_IDS = [(c, s) for c in CASES for s in (False, True)]


@pytest.mark.parametrize("case,seq_shard", CASE_IDS)
def test_tokens_and_logits_match_jax(runs, case, seq_shard):
    ranks, want = runs
    for rk, r in enumerate(ranks):
        got = r[(case, seq_shard)]
        rows = _rows(got["specs"])
        mesh = _layout(rk)
        from repro_torch.parallel.sharding import local_shard
        np.testing.assert_allclose(
            got["prefill"], local_shard(want[case]["prefill"], rows, mesh),
            **TOL)
        for t in range(GEN):
            np.testing.assert_allclose(
                got["steps"][t], local_shard(want[case]["steps"][t], rows,
                                             mesh), err_msg=f"step {t}",
                **TOL)
            assert got["tokens"][t].tolist() == local_shard(
                want[case]["tokens"][t + 1], rows, mesh)[:, 0].tolist(), t


@pytest.mark.parametrize("case,seq_shard", CASE_IDS)
def test_each_ranks_cache_is_its_shard_of_jaxs(runs, case, seq_shard):
    ranks, want = runs
    W = CASES[case][2]
    for rk, r in enumerate(ranks):
        got = r[(case, seq_shard)]
        spec = got["specs"]["run0"]["attn"]["k"]
        sharded = seq_shard and case != "c"
        assert (spec[2] is not None) == sharded, spec
        if sharded:
            assert spec[3] is None and got["cache"]["run0"]["attn"][
                "k"].shape[2] == W // (2 if case == "a" else 4)
        for when in ("cache0", "cache"):
            _check_cache(got[when], want[case][when], got["specs"],
                         _layout(rk))


@pytest.mark.parametrize("case", ["a", "b", "d"])
def test_a_decode_steps_bytes_do_not_grow_with_w(runs, case):
    """The same collectives and bytes with the cache at W and at 2W: the
    query-sized gathers and sums, never the cache."""
    for r in runs[0]:
        for seq_shard in (False, True):
            at_w, at_2w = r[(case, seq_shard)]["bytes"]
            assert at_w == at_2w, (seq_shard, at_w, at_2w)
            if seq_shard:
                assert "pmax" in at_w, at_w
