"""The cross-attention kinds across ranks: llama-3.2-vision's gated
``cross`` layers and whisper's encoder and ``xdec`` decoder on four gloo
ranks of the ``(data=2, model=2)`` mesh, Megatron-split over ``model`` on
JAX's specs (``blocks._cross``, the encoder through ``apply_block``),
against JAX's one-device results from the same JAX parameters
(``params_from_jax``: each rank's shards).

Configs, the same on both sides (``_cfg``):

  * ``vision``: reduced llama-3.2-vision, ``[dense, cross]`` over 16
    context embeddings, 4 query and 2 kv heads: two query heads and one
    kv head a rank;
  * ``vision_sp``: the same under ``seq_parallel`` (Megatron-SP), trained;
  * ``whisper``: reduced whisper, a 2-layer encoder over 32 frames and 2
    ``xdec`` layers, 4 heads: two a rank;
  * ``whisper_g``: 3 query and 3 kv heads of 32: ``H * hd`` divides over
    MP and ``H`` does not, so JAX splits a head across ranks and the port
    takes the gathered-heads layout (encoder, self- and cross attention).

Both sides get the parameters with the cross gates at 0.5 and -0.3 (JAX
starts them at 0, where a cross layer gets no gradient) and small random
biases (``set_gates_and_biases``, as ``test_torch_zoo_cross.py``).

What must hold on every rank.  Training (one batch of 4 x 32 with
``ctx_embeds``, each data rank its rows; whisper once more without a
context, JAX's ``Trainer``'s batch): the loss within 1e-4; each gradient
leaf's shard within 2e-4 of the JAX leaf's largest entry (whisper's key
biases, whose exact gradient is zero without rope, of their ``wk``'s), and
a leaf replicated over ``model`` bitwise the same on both MP ranks; the
parameters after one AdamW step within phase 12's tolerances (2e-5, 0.01%
of a leaf within twice the learning rate) and bitwise equal across MP.
Decode (``vision`` and ``whisper`` with ``seq_shard`` False and True,
``whisper_g`` False): ``Model.ctx_kv`` ``local_shard`` of JAX's under the
port's layout (this rank's rows and kv heads, every head in the gathered
layout) within 1e-5; 24 teacher-forced ``decode_step`` logits within rtol
2e-4 / atol 2e-5, then 8 greedy ``make_serve_step`` tokens equal to
JAX's; every cache leaf (the cross run's ``dummy`` too) ``local_shard`` of
JAX's under ``cache_specs`` within 1e-5, ``pos`` exact, after both; and
one decode step's collective bytes per kind the same with the cache at
two lengths: no K or V crosses ranks.

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

#: (name, config, with ctx_embeds)
TRAIN = (("vision", "vision", True), ("vision_sp", "vision_sp", True),
         ("whisper", "whisper", True), ("whisper_noctx", "whisper", False),
         ("whisper_g", "whisper_g", True))
#: decode cases: (config, seq_shard)
DECODE = (("vision", False), ("vision", True), ("whisper", False),
          ("whisper", True), ("whisper_g", False))
B, SEQ = 4, 32
PROMPT, GEN, MAX_LEN = 24, 8, 40
TOL = dict(rtol=2e-4, atol=2e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = dict(dp=("data",), mp=("model",))
GATES = {"gate_attn": 0.5, "gate_ffn": -0.3}


def _cfg(get_config, name):
    """The config ``name`` from a package's ``get_config``."""
    import dataclasses
    if name.startswith("vision"):
        c = dataclasses.replace(
            get_config("llama-3.2-vision-11b").reduced(), n_kv_heads=2)
        if name == "vision_sp":
            c = dataclasses.replace(c, seq_parallel=True)
        return c
    c = get_config("whisper-tiny").reduced()
    if name == "whisper_g":
        c = dataclasses.replace(c, n_heads=3, n_kv_heads=3, head_dim=32)
    return c


def set_gates_and_biases(tree, seed=5):
    """``tree`` (numpy) with ``GATES`` in every cross layer and small
    random values in every bias (zeros at init)."""
    rng = np.random.RandomState(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in GATES:
                out[k] = np.full_like(v, GATES[k])
            elif k.startswith("b") or k == "bias":
                out[k] = (v + 0.1 * rng.randn(*v.shape)).astype(v.dtype)
            else:
                out[k] = v
        return out
    return walk(tree)


def _ctx(cfg, seed=4):
    n = cfg.n_ctx_tokens if cfg.arch_type == "vlm" else cfg.encoder_seq
    return np.random.RandomState(seed).randn(B, n, cfg.d_model).astype(
        np.float32)


def _batch(cfg, with_ctx):
    from repro_torch.data import DataConfig, SyntheticLM
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                   global_batch=B, seed=3)).batch(0)
    return {**batch, "ctx_embeds": _ctx(cfg)} if with_ctx else batch


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
from test_torch_cross_dist import (DECODE, DIMS, GEN, MAX_LEN, PROMPT,
                                   TRAIN, _batch, _cfg, _ctx, _prompt,
                                   set_gates_and_biases)


def dump(obj, name):
    with open(os.path.join(tmp, name + ".tmp"), "wb") as f:
        pickle.dump(obj, f)
    os.replace(os.path.join(tmp, name + ".tmp"), os.path.join(tmp, name))


def host(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


# one device: seq_parallel's sharding constraint changes nothing there,
# so vision_sp's reference is vision's
SAME = {"vision_sp": "vision"}
names = sorted({c for _, c, _ in TRAIN} - set(SAME))
models = {n: build_model(_cfg(get_config, n)) for n in names}
params = {n: set_gates_and_biases(host(jax.jit(m.init)(
    jax.random.PRNGKey(0)))) for n, m in models.items()}
dump({n: params[SAME.get(n, n)] for n in names + list(SAME)}, "init.pkl")
params = {n: jax.tree.map(jnp.asarray, p) for n, p in params.items()}
mesh = make_mesh((1, 1), ("data", "model"))
dims = ParallelDims(**DIMS)
out = {}
for key, name, with_ctx in TRAIN:
    if name in SAME:
        continue
    model, p = models[name], params[name]
    batch = {k: jnp.asarray(v) for k, v in
             _batch(model.cfg, with_ctx).items()}

    # make_train_step's loss, gradients and AdamW update, the gradients
    # returned too: one compilation
    def step(q, model=model, batch=batch):
        (loss, _), grads = jax.value_and_grad(
            lambda r: model.loss(r, batch, mesh=mesh, dims=dims),
            has_aux=True)(q)
        q1, _, om = adamw_update(q, grads, adamw_init(q), AdamWConfig())
        return loss, grads, q1, om["lr"]
    loss, grads, p1, lr = jax.jit(step)(p)
    out[key] = {"loss": float(loss), "grads": host(grads),
                "step1": host(p1), "lr": float(lr)}
for key, name, _ in TRAIN:
    if name in SAME:
        out[key] = out[SAME[name]]
for name in {n for n, _ in DECODE}:
    model, p = models[name], params[name]
    kv = jax.jit(lambda q, c, m=model: m.ctx_kv(
        q, {"ctx_embeds": c}, mesh=mesh, dims=dims))(
        p, jnp.asarray(_ctx(model.cfg)))
    decode = jax.jit(lambda q, c, b, kv, m=model: m.decode_step(
        q, c, b, mesh=mesh, dims=dims, ctx_kv=kv))
    cache = model.init_cache(len(_prompt(1)), MAX_LEN)
    toks = _prompt(model.cfg.vocab_size)
    logits = []
    for t in range(PROMPT):
        lg, cache = decode(p, cache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                      "step": jnp.int32(t)}, kv)
        logits.append(np.asarray(lg))
    rec = {"ctx_kv": host(kv), "logits": logits, "cache0": host(cache)}
    # greedy: make_serve_step's argmax of the last position, on the
    # decode step compiled above
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    tokens = [np.asarray(tok)]
    for t in range(PROMPT, PROMPT + GEN):
        lg, cache = decode(p, cache, {"tokens": tok, "step": jnp.int32(t)},
                           kv)
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

    def rows(v):
        spec = P(("data",), *([None] * (v.ndim - 1)))
        t = torch.from_numpy(np.ascontiguousarray(local_shard(v, spec,
                                                              mesh)))
        return t.long() if v.dtype.kind == "i" else t

    out = {}
    for key, name, with_ctx in TRAIN:
        cfg = _cfg(get_config, name)
        model = Model(cfg, device="cpu")
        params = params_from_jax(init[name], cfg, device="cpu", mesh=mesh,
                                 dims=dims)
        batch = {k: rows(v) for k, v in _batch(cfg, with_ctx).items()}
        loss, _, grads, _ = _loss_and_grads(model, params, batch, None,
                                            mesh, dims)
        params, _, m = make_train_step(model, AdamWConfig(), None, mesh,
                                       dims)(params, adamw_init(params),
                                             batch)
        it = iter(grads)
        out[key] = {"loss": float(loss), "lr": float(m["lr"]),
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
        toks = rows(_prompt(cfg.vocab_size))
        with torch.no_grad():
            kv = model.ctx_kv(params, {"ctx_embeds": rows(_ctx(cfg))},
                              mesh=mesh, dims=dims)
        rec = {"specs": specs, "ctx_kv": _numpy(kv), "logits": []}
        with torch.no_grad():
            for t in range(PROMPT):
                if bytes_only and t == PROMPT - 1:
                    comm.timing(True)
                lg, cache = model.decode_step(
                    params, cache, {"tokens": toks[:, t:t + 1], "step": t},
                    mesh=mesh, dims=dims, specs=specs, ctx_kv=kv)
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
            tok, cache = serve(params, cache, {"tokens": tok, "step": t}, kv)
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
    tmp = str(tmp_path_factory.mktemp("cross_dist"))
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
    """``(path, mine, full, spec, scale)`` for every leaf, by key: the
    scale its tolerance reads (whisper's key biases, whose exact
    gradient is zero without rope, take their ``wk``'s)."""
    if isinstance(mine, dict):
        assert set(mine) == set(full), path
        for k in mine:
            for leaf in _walk(mine[k], full[k], specs[k], f"{path}.{k}"):
                if k == "bk" and "wk" in full:
                    leaf = leaf[:4] + (float(np.abs(full["wk"]).max()),)
                yield leaf
        return
    full = np.asarray(full, np.float32)
    yield path, mine, full, specs, float(np.abs(full).max(initial=0.0))


def _model(name):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    return Model(_cfg(get_config, name), device="cpu")


def _specs(name, tree, rank):
    from repro_torch.parallel.mesh import ParallelDims
    return _model(name).param_specs(tree, _layout(rank), ParallelDims(**DIMS))


def _peer_leaf(tree, path):
    for k in path.split(".")[1:]:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("key,name,with_ctx", TRAIN, ids=[t[0] for t in TRAIN])
def test_loss_and_each_gradient_shard_match_jax(runs, key, name, with_ctx):
    from repro_torch.parallel.sharding import local_shard, mentioned
    ranks, want = runs
    w = want[key]
    for rank, got in enumerate(ranks):
        g = got[key]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        specs = _specs(name, g["grads"], rank)
        peer = ranks[_mp_peer(rank)][key]["grads"]
        n = 0
        for path, mine, full, spec, scale in _walk(g["grads"], w["grads"],
                                                    specs):
            np.testing.assert_allclose(
                mine, local_shard(full, spec, _layout(rank)), rtol=0,
                atol=2e-4 * scale, err_msg=f"{key} rank {rank} {path} {spec}")
            if "model" not in mentioned(spec):
                assert np.array_equal(mine, _peer_leaf(peer, path)), \
                    (key, rank, path, spec)
            n += 1
        assert n > 10
        if name.startswith("vision"):
            for gate in GATES:
                assert abs(float(g["grads"]["run1"][gate][0])) > 0, gate
        elif with_ctx:
            assert float(np.abs(g["grads"]["encoder"]["attn"]["wo"]).max()) \
                > 0
        else:
            assert not np.any(g["grads"]["encoder"]["attn"]["wo"])


@pytest.mark.parametrize("key,name,with_ctx", TRAIN, ids=[t[0] for t in TRAIN])
def test_one_adamw_step_matches_jax_and_replicas_agree(runs, key, name,
                                                       with_ctx):
    from repro_torch.parallel.sharding import local_shard, mentioned
    ranks, want = runs
    w = want[key]
    lr0 = w["lr"]
    for rank, got in enumerate(ranks):
        mine = got[key]["step1"]
        peer = ranks[_mp_peer(rank)][key]["step1"]
        specs = _specs(name, mine, rank)
        for path, a, f, spec, _ in _walk(mine, w["step1"], specs):
            d = np.abs(a - local_shard(f, spec, _layout(rank)))
            off = int((d > 2e-5).sum())
            assert off <= max(1, d.size // 10000), (key, rank, path, off)
            assert d.max(initial=0.0) <= 2 * lr0, (key, rank, path)
            if "model" not in mentioned(spec):
                assert np.array_equal(a, _peer_leaf(peer, path)), \
                    (key, rank, path, spec)


def _cache_leaves(tree, specs, pre=""):
    if isinstance(tree, dict):
        return {k2: v for k in tree for k2, v in _cache_leaves(
            tree[k], specs[k], f"{pre}/{k}").items()}
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


def _ctx_kv_spec(name):
    """The port's layout of ``ctx_kv`` (n, B, Lctx, K, hd): rows over
    ``data``; the kv heads over ``model`` where they are split, whole in
    the gathered-heads layout (``whisper_g``)."""
    from repro_torch.parallel.sharding import P
    heads = None if name == "whisper_g" else ("model",)
    return P(None, ("data",), None, heads, None)


@pytest.mark.parametrize("name,seq_shard", DECODE)
def test_decode_and_serve_match_jax(runs, name, seq_shard):
    from repro_torch.parallel.sharding import P, local_shard
    ranks, want = runs
    w = want[(name, False)]
    for rank, r in enumerate(ranks):
        got, mesh = r[(name, seq_shard)], _layout(rank)
        assert set(got["ctx_kv"]) == set(w["ctx_kv"])
        for run, kv in w["ctx_kv"].items():
            for n in ("k", "v"):
                np.testing.assert_allclose(
                    got["ctx_kv"][run][n],
                    local_shard(np.asarray(kv[n]), _ctx_kv_spec(name), mesh),
                    err_msg=f"{name} rank {rank} ctx_kv {run}.{n}",
                    **CACHE_TOL)
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
def test_no_kv_crosses_ranks(runs, name, seq_shard):
    """``cache_specs``: a ``cross`` run's ``dummy`` is ``P(None)``, the
    self-attention K/V by kv head over ``model`` (whole in the
    gathered-heads layout, W over ``model`` under ``seq_shard``); a
    decode step moves the same bytes per kind at W and 2W, and its
    collectives carry no context K/V (each of them, on average per kind,
    under one layer's ``ctx_kv`` shard)."""
    ranks, _ = runs
    got = ranks[0][(name, seq_shard)]
    for r, run in got["specs"].items():
        if "dummy" in run:
            assert tuple(run["dummy"]) == (None,) and len(run) == 1
        if "attn" in run:
            kv = run["attn"]["k"]
            assert kv[2] == (("model",) if seq_shard else None), kv
            heads = None if name == "whisper_g" or seq_shard else ("model",)
            assert kv[3] == heads, kv
    one_layer = min(v["k"][0].nbytes for v in got["ctx_kv"].values())
    for r in ranks:
        at_w, at_2w = r[(name, seq_shard)]["bytes"]
        assert at_w == at_2w, (name, seq_shard, at_w, at_2w)
        assert "psum" in at_w, at_w
        assert all(nb < calls * one_layer for calls, nb in at_w.values()), \
            (at_w, one_layer)
