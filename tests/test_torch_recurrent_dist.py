"""The recurrent kinds across ranks: hymba (attention beside a Mamba head)
and xlstm (mLSTM runs with sLSTM between them) on four gloo ranks of the
``(data=2, model=2)`` mesh, Megatron-split over ``model`` on JAX's specs
(``blocks._recurrent``), against JAX's one-device results from the same
JAX parameters (``params_from_jax``: each rank's shards).

Configs, the same on both sides (``_cfg``):

  * ``hymba``: reduced hymba-1.5b (4 query and 4 kv heads: two heads a
    rank), its Mamba cell on half of ``d_inner`` a rank;
  * ``hymba_sp``: the same under ``seq_parallel`` (Megatron-SP), trained;
  * ``hymba_g``: 5 query heads and 1 kv head of 32: ``H * hd`` divides
    over MP and ``H`` does not, so JAX splits a head across ranks and
    the port takes the gathered-heads layout;
  * ``xlstm``: reduced xlstm-350m cut to 4 layers (mLSTM, sLSTM, mLSTM,
    sLSTM), 4 mLSTM heads: two a rank;
  * ``xlstm_1``: one head, which does not divide: the gathered-heads
    mLSTM, its state whole on every rank.

What must hold on every rank.  Training (one batch of 4 x 32): the loss
within 1e-4; each gradient leaf's shard within 2e-4 of the JAX leaf's
largest entry, and a leaf replicated over ``model`` bitwise the same on
both MP ranks; the parameters after one AdamW step within phase 12's
tolerances (2e-5, 0.01% of a leaf within twice the learning rate) and
bitwise equal across MP.  Decode (``hymba``, ``hymba_g`` with
``seq_shard`` False and True, W split over ``model`` where True;
``xlstm``, ``xlstm_1``): 24 teacher-forced ``decode_step`` logits within
rtol 2e-4 / atol 2e-5, then 8 greedy ``make_serve_step`` tokens equal to
JAX's; every cache leaf ``local_shard`` of JAX's under the port's
``cache_specs`` within 1e-5, ``pos`` exact, after both; and one decode
step's collective bytes per kind the same with the cache at two lengths:
no state crosses ranks.

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

TRAIN = ("hymba", "hymba_sp", "hymba_g", "xlstm", "xlstm_1")
#: decode cases: (config, seq_shard)
DECODE = (("hymba", False), ("hymba", True), ("hymba_g", False),
          ("hymba_g", True), ("xlstm", False), ("xlstm_1", False))
B, SEQ = 4, 32
PROMPT, GEN, MAX_LEN = 24, 8, 40
TOL = dict(rtol=2e-4, atol=2e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = dict(dp=("data",), mp=("model",))


def _cfg(get_config, name):
    """The config ``name`` from a package's ``get_config``."""
    import dataclasses
    if name.startswith("hymba"):
        c = get_config("hymba-1.5b").reduced()
        if name == "hymba_sp":
            c = dataclasses.replace(c, seq_parallel=True)
        if name == "hymba_g":
            c = dataclasses.replace(c, n_heads=5, n_kv_heads=1, head_dim=32)
        return c
    c = get_config("xlstm-350m").reduced(n_layers=4)
    if name == "xlstm_1":
        c = dataclasses.replace(c, n_heads=1, n_kv_heads=1)
    return c


def _batch(vocab):
    from repro_torch.data import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(vocab_size=vocab, seq_len=SEQ,
                                  global_batch=B, seed=3)).batch(0)


def _prompt(vocab):
    return np.random.RandomState(2).randint(0, vocab, (B, PROMPT)).astype(
        np.int32)


JAX_SCRIPT = r'''
import os, pickle, sys
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.models import build_model
from repro.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro.parallel.mesh import ParallelDims, make_mesh

tmp = sys.argv[1]
sys.path.insert(0, sys.argv[2])
from test_torch_recurrent_dist import (DECODE, DIMS, GEN, MAX_LEN, PROMPT,
                                       TRAIN, _batch, _cfg, _prompt)


def dump(obj, name):
    with open(os.path.join(tmp, name + ".tmp"), "wb") as f:
        pickle.dump(obj, f)
    os.replace(os.path.join(tmp, name + ".tmp"), os.path.join(tmp, name))


def host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


# one device: seq_parallel's sharding constraint changes nothing there,
# so hymba_sp's reference is hymba's
SAME = {"hymba_sp": "hymba"}
models = {n: build_model(_cfg(get_config, n)) for n in TRAIN
          if n not in SAME}
params = {n: host(jax.jit(m.init)(jax.random.PRNGKey(0)))
          for n, m in models.items()}
dump({n: params[SAME.get(n, n)] for n in TRAIN}, "init.pkl")
mesh = make_mesh((1, 1), ("data", "model"))
dims = ParallelDims(**DIMS)
out = {}
for name, model in models.items():
    p = params[name]
    batch = {k: jnp.asarray(v) for k, v in
             _batch(model.cfg.vocab_size).items()}

    # make_train_step's loss, gradients and AdamW update, the gradients
    # returned too: one compilation
    def step(q, model=model, batch=batch):
        (loss, _), grads = jax.value_and_grad(
            lambda r: model.loss(r, batch, mesh=mesh, dims=dims),
            has_aux=True)(q)
        q1, _, om = adamw_update(q, grads, adamw_init(q), AdamWConfig())
        return loss, grads, q1, om["lr"]
    loss, grads, p1, lr = jax.jit(step)(p)
    out[name] = {"loss": float(loss), "grads": host(grads),
                 "step1": host(p1), "lr": float(lr)}
for name in SAME:
    out[name] = out[SAME[name]]
for name in {n for n, _ in DECODE}:
    model, p = models[name], params[name]
    decode = jax.jit(lambda q, c, b, m=model: m.decode_step(
        q, c, b, mesh=mesh, dims=dims))
    cache = model.init_cache(len(_prompt(1)), MAX_LEN)
    toks = _prompt(model.cfg.vocab_size)
    logits = []
    for t in range(PROMPT):
        lg, cache = decode(p, cache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                      "step": jnp.int32(t)})
        logits.append(np.asarray(lg))
    rec = {"logits": logits, "cache0": host(cache)}
    # greedy: make_serve_step's argmax of the last position, on the
    # decode step compiled above
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    tokens = [np.asarray(tok)]
    for t in range(PROMPT, PROMPT + GEN):
        lg, cache = decode(p, cache, {"tokens": tok, "step": jnp.int32(t)})
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        tokens.append(np.asarray(tok))
    rec.update(tokens=tokens, cache=host(cache))
    out[(name, False)] = rec
dump(out, "jax.pkl")
'''


def _wait_for(path, deadline):
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_numpy(v) for v in tree)
    return tree.detach().numpy().copy()


def _like(tree, fn):
    """``tree``'s dicts with ``fn`` of each leaf, in its key order."""
    if isinstance(tree, dict):
        return {k: _like(v, fn) for k, v in tree.items()}
    return fn(tree)


def _rank(rank, tmp):
    """Every training and decode case on one rank of the (2, 2) mesh."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import comm
    from repro_torch.parallel.mesh import ParallelDims, make_mesh
    from repro_torch.parallel.sharding import P, local_shard
    from repro_torch.train import cache_specs, make_serve_step
    from repro_torch.train.loop import _loss_and_grads, make_train_step
    _wait_for(os.path.join(tmp, "init.pkl"), time.monotonic() + 240)
    with open(os.path.join(tmp, "init.pkl"), "rb") as f:
        init = pickle.load(f)
    mesh = make_mesh((2, 2), ("data", "model"))
    dims = ParallelDims(**DIMS)
    rows = P(("data",), None)
    out = {}
    for name in TRAIN:
        cfg = _cfg(get_config, name)
        model = Model(cfg, device="cpu")
        params = params_from_jax(init[name], cfg, device="cpu", mesh=mesh,
                                 dims=dims)
        batch = {k: torch.from_numpy(np.ascontiguousarray(
            local_shard(v, rows, mesh))).long()
            for k, v in _batch(cfg.vocab_size).items()}
        loss, _, grads, _ = _loss_and_grads(model, params, batch, None,
                                            mesh, dims)
        params, _, m = make_train_step(model, AdamWConfig(), None, mesh,
                                       dims)(params, adamw_init(params),
                                             batch)
        it = iter(grads)
        out[name] = {"loss": float(loss), "lr": float(m["lr"]),
                     "grads": _like(params, lambda _: next(it).numpy()),
                     "step1": _numpy(params)}

    def decode_run(name, seq_shard, max_len, gen, bytes_only=False):
        cfg = _cfg(get_config, name)
        model = Model(cfg, device="cpu")
        params = params_from_jax(init[name], cfg, device="cpu", mesh=mesh,
                                 dims=dims)
        specs = cache_specs(model, mesh, dims, B, max_len,
                            seq_shard=seq_shard)
        cache = model.init_cache(B, max_len, mesh=mesh, dims=dims,
                                 specs=specs)
        toks = local_shard(_prompt(cfg.vocab_size), rows, mesh)
        rec = {"specs": specs, "logits": []}
        with torch.no_grad():
            for t in range(PROMPT):
                if bytes_only and t == PROMPT - 1:
                    comm.timing(True)
                lg, cache = model.decode_step(
                    params, cache, {"tokens": torch.from_numpy(
                        np.ascontiguousarray(toks[:, t:t + 1])).long(),
                        "step": t}, mesh=mesh, dims=dims, specs=specs)
                rec["logits"].append(lg.numpy().copy())
        if bytes_only:
            got = {k: v[:2] for k, v in comm.times().items()
                   if k != "in_flight"}
            comm.timing(False)
            return got
        rec["cache0"] = _numpy(cache)
        serve = make_serve_step(model, mesh, dims, specs=specs)
        tok = torch.from_numpy(lg[:, -1].argmax(-1).numpy()).to(
            torch.int32)[:, None]
        rec["tokens"] = [tok.numpy().copy()]
        for t in range(PROMPT, PROMPT + gen):
            tok, cache = serve(params, cache, {"tokens": tok, "step": t})
            rec["tokens"].append(tok.numpy().copy())
        rec["cache"] = _numpy(cache)
        return rec

    for name, seq_shard in DECODE:
        rec = decode_run(name, seq_shard, MAX_LEN, GEN)
        rec["bytes"] = [decode_run(name, seq_shard, n, 0, bytes_only=True)
                        for n in (MAX_LEN, 2 * MAX_LEN)]
        out[(name, seq_shard)] = rec
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    tmp = str(tmp_path_factory.mktemp("recurrent_dist"))
    with open(os.path.join(tmp, "jax.err"), "w") as err:
        jax_run = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, tmp, os.path.dirname(__file__)],
            env=subprocess_env(1), stdout=subprocess.DEVNULL, stderr=err)
        try:
            _wait_for(os.path.join(tmp, "init.pkl"), time.monotonic() + 240)
            ranks = spawn(_rank, 4, tmp, backend="gloo", device="cpu",
                          threads=1, timeout=300)
            jax_run.wait(timeout=300)
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
    return Mesh((2, 2), ("data", "model"), rank, groups=False)


def _mp_peer(rank):
    """The rank of the other MP member of ``rank``'s group (data-major)."""
    return rank ^ 1


def _walk(mine, full, specs, path=""):
    """``(path, mine, full, spec)`` for every leaf, by key."""
    if isinstance(mine, dict):
        assert set(mine) == set(full), path
        for k in mine:
            yield from _walk(mine[k], full[k], specs[k], f"{path}.{k}")
        return
    yield path, mine, np.asarray(full, np.float32), specs


def _specs(name, tree, rank):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.parallel.mesh import ParallelDims
    model = Model(_cfg(get_config, name), device="cpu")
    return model.param_specs(tree, _layout(rank), ParallelDims(**DIMS))


def _peer_leaf(tree, path):
    for k in path.split(".")[1:]:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", TRAIN)
def test_loss_and_each_gradient_shard_match_jax(runs, name):
    from repro_torch.parallel.sharding import local_shard, mentioned
    ranks, want = runs
    w = want[name]
    for rank, got in enumerate(ranks):
        g = got[name]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        specs = _specs(name, g["grads"], rank)
        peer = ranks[_mp_peer(rank)][name]["grads"]
        n = 0
        for path, mine, full, spec in _walk(g["grads"], w["grads"], specs):
            np.testing.assert_allclose(
                mine, local_shard(full, spec, _layout(rank)), rtol=0,
                atol=2e-4 * float(np.abs(full).max(initial=0.0)),
                err_msg=f"{name} rank {rank} {path} {spec}")
            if "model" not in mentioned(spec):
                assert np.array_equal(mine, _peer_leaf(peer, path)), \
                    (name, rank, path, spec)
            n += 1
        assert n > 10


@pytest.mark.parametrize("name", TRAIN)
def test_one_adamw_step_matches_jax_and_replicas_agree(runs, name):
    from repro_torch.parallel.sharding import local_shard, mentioned
    ranks, want = runs
    w = want[name]
    lr0 = w["lr"]
    for rank, got in enumerate(ranks):
        mine = got[name]["step1"]
        peer = ranks[_mp_peer(rank)][name]["step1"]
        specs = _specs(name, mine, rank)
        for path, a, f, spec in _walk(mine, w["step1"], specs):
            d = np.abs(a - local_shard(f, spec, _layout(rank)))
            off = int((d > 2e-5).sum())
            assert off <= max(1, d.size // 10000), (name, rank, path, off)
            assert d.max(initial=0.0) <= 2 * lr0, (name, rank, path)
            if "model" not in mentioned(spec):
                assert np.array_equal(a, _peer_leaf(peer, path)), \
                    (name, rank, path, spec)


def _cache_leaves(tree, specs, pre=""):
    if isinstance(tree, dict):
        return {k2: v for k in tree for k2, v in _cache_leaves(
            tree[k], specs[k], f"{pre}/{k}").items()}
    if isinstance(tree, tuple):
        return {k2: v for i in range(len(tree)) for k2, v in _cache_leaves(
            tree[i], specs[i], f"{pre}/{i}").items()}
    return {pre: (tree, specs)}


def _check_cache(got, want, specs, rank, what):
    from repro_torch.parallel.sharding import local_shard
    mine, full = _cache_leaves(got, specs), _cache_leaves(want, specs)
    assert set(mine) == set(full), what
    for k, (a, spec) in mine.items():
        b = local_shard(np.asarray(full[k][0]), spec, _layout(rank))
        assert a.shape == b.shape, (what, k, spec)
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a, b.astype(np.float32),
                                       err_msg=f"{what} {k}", **CACHE_TOL)


@pytest.mark.parametrize("name,seq_shard", DECODE)
def test_decode_and_serve_match_jax(runs, name, seq_shard):
    from repro_torch.parallel.sharding import P, local_shard
    ranks, want = runs
    w = want[(name, False)]
    for rank, r in enumerate(ranks):
        got, mesh = r[(name, seq_shard)], _layout(rank)
        for t in range(PROMPT):
            np.testing.assert_allclose(
                got["logits"][t], local_shard(w["logits"][t], P(
                    ("data",), None, None), mesh), err_msg=f"step {t}",
                **TOL)
        for t, tok in enumerate(got["tokens"]):
            assert tok.tolist() == local_shard(
                w["tokens"][t], P(("data",), None), mesh).tolist(), t
        _check_cache(got["cache0"], w["cache0"], got["specs"], rank,
                     f"{name} rank {rank} after the prompt")
        _check_cache(got["cache"], w["cache"], got["specs"], rank,
                     f"{name} rank {rank} after the greedy steps")


@pytest.mark.parametrize("name,seq_shard", DECODE)
def test_the_state_sits_where_the_split_reads_it(runs, name, seq_shard):
    """``cache_specs``: Mamba's Di and mLSTM's heads over ``model`` where
    the cell splits (hymba: always; xlstm: 4 heads, not 1), the sLSTM
    state whole, hymba's K/V whole over MP in the gathered-heads layout
    and by kv head otherwise (W over ``model`` under ``seq_shard``); a
    decode step moves the same bytes per kind at W and 2W."""
    ranks, _ = runs
    got = ranks[0][(name, seq_shard)]
    for r, run in got["specs"].items():
        if "mamba" in run:
            assert run["mamba"][0][3] == ("model",)
            assert run["mamba"][1][2] == ("model",)
            kv = run["attn"]["k"]
            assert kv[2] == (("model",) if seq_shard else None), kv
            heads = None if name == "hymba_g" or seq_shard else ("model",)
            assert kv[3] == heads, kv
        if "mlstm" in run:
            want = None if name == "xlstm_1" else ("model",)
            assert [s[2] for s in run["mlstm"]] == [want] * 3
        if "slstm" in run:
            assert all(s[2] is None for s in run["slstm"])
    for r in ranks:
        at_w, at_2w = r[(name, seq_shard)]["bytes"]
        assert at_w == at_2w, (name, seq_shard, at_w, at_2w)
        assert "permute_rows" in at_w, at_w
