"""Megatron tensor parallelism of the dense layers across ranks: the port's
``Model.param_specs`` against the JAX package's ``Model.specs``, and the
port's ``Trainer(mesh=, dims=)`` on four gloo ranks against the JAX
``Trainer`` on a 4-device host mesh (GSPMD shards the same leaves), from
the same JAX parameters and batches.

Configs (``_config``, the same on both sides): reduced qwen3-moe-30b-a3b
with 2 kv heads and one shared expert (GQA: the kv heads shard on
``model=2`` and are replicated on ``model=4``, each rank reading the one
its query heads share; a vocab-parallel embedding, LM head and CE; the
shared expert column / row parallel), and reduced gpt2-moe with
``seq_parallel=True`` (Megatron-SP; layernorm, the qkv and FFN biases, a
tied vocab-parallel embedding), and reduced command-r-35b with 2 kv
heads (dense: the parallel block, whose row-parallel attention and
row-parallel FFN sum into one residual; layernorm; the tied
vocab-parallel head times ``logit_scale``).  Cases: qwen3 and gpt2sp on
the merged ``(data=2, model=2)`` and on ``(data=1, model=4)`` meshes, one
under ``s1`` and one under ``s2`` each; command-r on ``(2, 2)``.

Tolerances (``test_torch_train_dist.py``'s): per step, loss within 1e-4
and gradient norm within 1e-3 relative; the parameters after the first
step within 2e-5 absolute, except 0.01% of a leaf's elements (at least
one) within twice the learning rate (Adam's first step on a gradient at
its rounding noise), and the attention key bias (exact gradient zero)
within twice the learning rate.  The shared-expert layer
(``apply_moe`` on the (2, 2) mesh): y rtol 2e-4 / atol 2e-5, gradients
1e-4 of their largest entry (``test_torch_moe_dist.py``'s).  Layouts,
``gather_full`` of every shard and ``global_norm`` over the new specs:
exact, and 1e-6 relative.

One JAX subprocess and one 4-rank spawn serve the whole module.
"""

import importlib.util
import inspect
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from conftest import subprocess_env

pytestmark = [pytest.mark.multirank, pytest.mark.skipif(
    importlib.util.find_spec("jax") is None, reason="needs jax")]


def _config(get_config, key):
    """``key``'s config from a package's ``get_config`` (both packages)."""
    from dataclasses import replace
    if key == "qwen3":
        c = get_config("qwen3-moe-30b-a3b").reduced()
        return replace(c, n_kv_heads=2,
                       moe=replace(c.moe, n_shared_experts=1))
    if key == "gpt2sp":
        return replace(get_config("gpt2-moe").reduced(), seq_parallel=True)
    if key == "qwen3shared":
        c = get_config("qwen3-moe-30b-a3b").reduced()
        return replace(c, moe=replace(c.moe, n_shared_experts=1))
    if key == "gpt2":
        return get_config("gpt2-moe").reduced()
    if key == "commandr":
        return replace(get_config("command-r-35b").reduced(), n_kv_heads=2)
    return get_config("bert-moe").reduced()


#: (name, config, mesh shape over ("data", "model"), schedule)
CASES = [("qwen3-2x2-s1", "qwen3", (2, 2), "s1"),
         ("qwen3-1x4-s2", "qwen3", (1, 4), "s2"),
         ("gpt2sp-2x2-s2", "gpt2sp", (2, 2), "s2"),
         ("gpt2sp-1x4-s1", "gpt2sp", (1, 4), "s1"),
         ("commandr-2x2", "commandr", (2, 2), None)]
STEPS = 2
DATA = dict(seq_len=32, global_batch=8)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)
DIMS = dict(ep=("data",), esp=("model",), mp=("model",))
#: the shared-expert layer: (B, L, M), d_ff, experts, top-k
SHARED = dict(B=4, L=8, M=32, F=64, E=8, K=2)

JAX_SCRIPT = inspect.getsource(_config) + r'''
import pickle, sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.core.moe import MoEConfig, apply_moe
from repro.data import DataConfig, SyntheticLM
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.parallel.mesh import ParallelDims, make_mesh
from repro.train import Trainer

cases, steps, data_kw, opt_kw, dims_kw, sh = eval(sys.argv[3])
with open(sys.argv[2], "rb") as f:
    inp = pickle.load(f)
dims = ParallelDims(**dims_kw)
out = {}
for name, key, shape, sched in cases:
    cfg = _config(get_config, key)
    mesh = make_mesh(shape, ("data", "model"))
    tr = Trainer(build_model(cfg), mesh, dims, AdamWConfig(**opt_kw),
                 schedule=sched)
    params, opt = tr.setup(jax.random.PRNGKey(0))
    out[key + ":init"] = jax.tree.map(np.asarray, params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **data_kw))
    rows = []
    for step in range(steps):
        batch = data.sharded_batch(step, mesh, dims.batch_axes)
        params, opt, m = tr._step(params, opt, batch)
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        if step == 0:
            out[name + ":step1"] = jax.tree.map(np.asarray, params)
    out[name] = rows

mesh = make_mesh((2, 2), ("data", "model"))
cfg = MoEConfig(d_model=sh["M"], d_ff=sh["F"], n_experts=sh["E"],
                top_k=sh["K"], n_shared_experts=1, schedule="s1")
x, r = jnp.asarray(inp["x"]), jnp.asarray(inp["r"])
p = {k: jnp.asarray(v) for k, v in inp["p"].items()}

def loss(x, p):
    y, aux = apply_moe(x, p, mesh=mesh, dims=dims, cfg=cfg)
    return jnp.sum(y * r) + aux["aux_loss"] + aux["z_loss"], y

(_, y), (gx, gp) = jax.jit(jax.value_and_grad(
    loss, argnums=(0, 1), has_aux=True))(x, p)
out["shared"] = {"y": np.asarray(y), "g": {"x": np.asarray(gx),
                 **{k: np.asarray(v) for k, v in gp.items()}}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


def _shared_inputs():
    s = SHARED
    rng = np.random.RandomState(21)
    M, F, E = s["M"], s["F"], s["E"]
    p = {"wg": rng.randn(M, E) / np.sqrt(M),
         "w1": rng.randn(E, M, F) / np.sqrt(M),
         "w2": rng.randn(E, F, M) / np.sqrt(F),
         "w3": rng.randn(E, M, F) / np.sqrt(M),
         "shared_w1": rng.randn(M, F) / np.sqrt(M),
         "shared_w3": rng.randn(M, F) / np.sqrt(M),
         "shared_w2": rng.randn(F, M) / np.sqrt(F)}
    return {"p": {k: v.astype(np.float32) for k, v in p.items()},
            "x": rng.randn(s["B"], s["L"], M).astype(np.float32),
            "r": rng.randn(s["B"], s["L"], M).astype(np.float32)}


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def _rank(rank, ref, inp):
    """One rank: every case's training steps, then the shared-expert layer,
    the layouts gathered back and the global norm over the new specs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax, to_numpy
    from repro_torch.core.moe import MoEConfig, apply_moe, moe_param_specs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import global_norm, leaves
    from repro_torch.parallel.mesh import ParallelDims, make_mesh
    from repro_torch.parallel.sharding import P, gather_full, local_shard
    from repro_torch.train import Trainer
    from repro_torch.train.loop import sync_grads
    dims = ParallelDims(**DIMS)
    meshes = {shape: make_mesh(shape, ("data", "model"))
              for shape in ((2, 2), (1, 4))}
    out = {}
    for name, key, shape, sched in CASES:
        cfg = _config(get_config, key)
        mesh = meshes[shape]
        tr = Trainer(Model(cfg, device="cpu"), AdamWConfig(**OPT),
                     schedule=sched, mesh=mesh, dims=dims)
        params = params_from_jax(ref[key + ":init"], cfg, device="cpu",
                                 mesh=mesh, dims=dims)
        if key == "qwen3":
            # every shard gathered back is JAX's array; the global norm of
            # the shards is the norm of the whole tree
            specs = leaves(tr.model.param_specs(params, mesh, dims))
            full = leaves(ref[key + ":init"])
            local = leaves(params)
            out[name + ":gathered"] = all(
                np.array_equal(gather_full(t, s, mesh).numpy(), f)
                for t, s, f in zip(local, specs, full))
            out[name + ":norm"] = (
                float(global_norm(local, specs, mesh)),
                float(np.sqrt(sum(np.sum(np.square(f.astype(np.float64)))
                                  for f in full))))
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **DATA))
        opt = adamw_init(params)
        rows = []
        for step in range(STEPS):
            params, opt, m = tr.train_step(params, opt, tr.batch(data, step))
            rows.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                  "lr")})
            if step == 0:     # a copy: to_numpy shares the CPU storage
                out[name + ":step1"] = _copy(to_numpy(params))
        out[name] = rows
    s, mesh = SHARED, meshes[(2, 2)]
    cfg = MoEConfig(d_model=s["M"], d_ff=s["F"], n_experts=s["E"],
                    top_k=s["K"], n_shared_experts=1, schedule="s1")
    specs = moe_param_specs(cfg, mesh, dims)
    xs = P(dims.batch_axes, None, None)
    x = torch.from_numpy(local_shard(inp["x"], xs, mesh)).requires_grad_()
    r = torch.from_numpy(local_shard(inp["r"], xs, mesh))
    p = {k: torch.from_numpy(np.ascontiguousarray(
        local_shard(v, specs[k], mesh))).requires_grad_()
        for k, v in inp["p"].items()}
    y, aux = apply_moe(x, p, cfg=cfg, mesh=mesh, dims=dims)
    g = torch.autograd.grad((y * r).sum() + aux["aux_loss"] + aux["z_loss"],
                            [x, *p.values()])
    g = [g[0]] + sync_grads(list(g[1:]), [specs[k] for k in p], mesh, dims)
    out["shared"] = {"y": y.detach().numpy(),
                     "g": dict(zip(["x", *p], (t.numpy() for t in g)))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    path, src = str(tmp / "jax.pkl"), str(tmp / "shared.pkl")
    inp = _shared_inputs()
    with open(src, "wb") as f:
        pickle.dump(inp, f)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, path, src,
         repr((CASES, STEPS, DATA, OPT, DIMS, SHARED))],
        env=subprocess_env(4), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    _, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, err[-3000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)
    ranks = spawn(_rank, 4, ref, inp, backend="gloo", device="cpu",
                  threads=1, timeout=300)
    return ref, ranks


def _mesh(shape, rank):
    from repro_torch.parallel.mesh import Mesh
    return Mesh(shape, ("data", "model"), rank, groups=False)


def _canon(spec):
    """A spec's entries as tuples of axis names (JAX's PartitionSpec
    writes a one-axis entry as the bare name)."""
    return tuple(None if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)) for e in spec)


def _canon_tree(tree):
    if isinstance(tree, dict):
        return {k: _canon_tree(v) for k, v in tree.items()}
    return _canon(tree)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 2)],
                         ids=["2x2", "1x4", "4x2"])
@pytest.mark.parametrize("key", ["gpt2", "qwen3", "qwen3shared", "bert",
                                 "commandr"])
def test_param_specs_are_jaxs(key, shape):
    """``Model.param_specs`` is JAX's ``Model.specs`` leaf by leaf (the
    JAX function reads only ``mesh.shape``, so both take the port's
    layout-only ``Mesh``); every attention, FFN, embedding and LM-head
    leaf is sharded over ``model`` where JAX shards it, and qwen3's 2 kv
    heads are replicated on ``model=4``."""
    from repro.configs import get_config as jget
    from repro.models import build_model
    from repro.parallel.mesh import ParallelDims as JDims
    from repro_torch.configs import get_config as tget
    from repro_torch.models import Model
    from repro_torch.parallel.mesh import ParallelDims
    mesh = _mesh(shape, 0)
    want = build_model(_config(jget, key)).specs(mesh, JDims(**DIMS))
    got = Model(_config(tget, key), device="cpu").param_specs(
        want, mesh, ParallelDims(**DIMS))
    assert _canon_tree(got) == _canon_tree(want)
    attn = got["run0"]["attn"]
    assert attn["wq"] == (None, None, ("model",))
    assert attn["wo"] == (None, ("model",), None)
    kv_sharded = not (key in ("qwen3", "commandr") and shape[1] == 4)
    assert attn["wk"] == (None, None, ("model",) if kv_sharded else None)


def test_heads_split_across_ranks_are_refused():
    """Where ``H % n_mp != 0`` but ``H * hd % n_mp == 0`` JAX splits a head
    across ranks; the port raises, naming the config and the mesh.  No
    config of the port's registry does so on a model axis of up to 4."""
    from dataclasses import replace

    from repro.configs import get_config as jget
    from repro.models import build_model
    from repro.parallel.mesh import ParallelDims as JDims
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import _MODULES
    from repro_torch.models import Model
    from repro_torch.parallel.mesh import ParallelDims
    dims = ParallelDims(**DIMS)
    split = dict(n_heads=6, n_kv_heads=6, head_dim=64)
    mesh = _mesh((1, 4), 0)
    tree = build_model(replace(jget("gpt2-moe").reduced(), **split)).specs(
        mesh, JDims(**DIMS))
    assert tree["run0"]["attn"]["wq"][-1] is not None   # JAX splits a head
    model = Model(replace(get_config("gpt2-moe").reduced(), **split),
                  device="cpu")
    with pytest.raises(ValueError, match=r"gpt2-moe-smoke on mesh .*"
                       r"'model': 4.*6 query heads"):
        model.param_specs(tree, mesh, dims)
    for name in _MODULES:
        for shape in ((4, 1), (2, 2), (1, 4)):
            mesh = _mesh(shape, 0)
            tree = build_model(jget(name)).specs(mesh, JDims(**DIMS))
            Model(get_config(name), device="cpu").param_specs(tree, mesh,
                                                              dims)


def _params_close(mine, want, lr0, where):
    for r in [k for k in mine if k.startswith("run")]:
        if "bk" in mine[r]["attn"]:       # exact gradient zero
            np.testing.assert_allclose(mine[r]["attn"].pop("bk"),
                                       want[r]["attn"].pop("bk"), rtol=0,
                                       atol=2 * lr0)

    def walk(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
            return
        d = np.abs(a - np.asarray(b, np.float32))
        off = int((d > 2e-5).sum())
        assert off <= max(1, d.size // 10000), (where, path, off, d.max())
        assert d.max() <= 2 * lr0, (where, path, d.max())
    walk(mine, want, where)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tensor_parallel_training_matches_jax(runs, case):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.parallel.mesh import ParallelDims
    from repro_torch.parallel.sharding import local_tree
    ref, ranks = runs
    name, key, shape, _ = case
    model = Model(_config(get_config, key), device="cpu")
    want_rows = ref[name]
    lr0 = want_rows[0]["lr"]
    for rank, got in enumerate(ranks):
        for step, (g, w) in enumerate(zip(got[name], want_rows)):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                       err_msg=f"rank {rank} step {step}")
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-3,
                                       err_msg=f"rank {rank} step {step}")
            np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        mesh = _mesh(shape, rank)
        want = local_tree(ref[name + ":step1"], model.param_specs(
            ref[name + ":step1"], mesh, ParallelDims(**DIMS)), mesh)
        _params_close(_copy(got[name + ":step1"]), want, lr0,
                      f"{name} rank {rank}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_replicas_stay_bitwise_equal(runs, case):
    """After a step, the ranks that hold the same block of a leaf (its MP
    replicas where it is replicated over ``model``, its data replicas
    where it is sharded) hold the same bits, and each rank holds a block
    of the sharded leaf's size (a quarter of qwen3's ``wq`` on
    ``model=4``, half on ``model=2``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel.mesh import ParallelDims
    from repro_torch.parallel.sharding import mentioned
    ref, ranks = runs
    name, key, shape, _ = case
    model = Model(_config(get_config, key), device="cpu")
    dims = ParallelDims(**DIMS)
    specs = leaves(model.param_specs(ranks[0][name + ":step1"],
                                     _mesh(shape, 0), dims))
    mine = [leaves(r[name + ":step1"]) for r in ranks]
    full = leaves(ref[name + ":step1"])
    n_rep = 0
    for i, spec in enumerate(specs):
        used = set(mentioned(spec))
        blocks = {}
        for rank in range(4):
            coords = _mesh(shape, rank).coords
            blocks.setdefault(tuple(coords[a] for a in ("data", "model")
                                    if a in used), []).append(rank)
        for members in blocks.values():
            n_rep += len(members) > 1
            for rank in members[1:]:
                assert np.array_equal(mine[rank][i], mine[members[0]][i]), \
                    (name, i, spec, members)
        n = 1
        for a in used:
            n *= dict(zip(("data", "model"), shape))[a]
        assert mine[0][i].size * n == full[i].size, (name, i, spec)
    assert n_rep > 0
    wq = ranks[0][name + ":step1"]["run0"]["attn"]["wq"]
    assert wq.shape[-1] * shape[1] \
        == ref[name + ":step1"]["run0"]["attn"]["wq"].shape[-1]


def test_shards_gather_back_and_the_norm_counts_each_once(runs):
    """``gather_full`` of every rank's shards is JAX's array (head-, vocab-
    and expert-sharded leaves included), and ``global_norm`` over the new
    specs is the norm of the whole tree, on both meshes."""
    _, ranks = runs
    for name in ("qwen3-2x2-s1", "qwen3-1x4-s2"):
        for got in ranks:
            assert got[name + ":gathered"] is True
            norm, want = got[name + ":norm"]
            np.testing.assert_allclose(norm, want, rtol=1e-6)


def test_shared_experts_on_a_mesh_match_jax(runs):
    """``apply_moe`` with a shared expert on the (2, 2) mesh (JAX shards it
    column / row over ``model``): each rank's output and gradient blocks
    (of ``sum(y * r)`` plus the router losses) are its blocks of JAX's."""
    from repro_torch.core.moe import MoEConfig, moe_param_specs
    from repro_torch.parallel.mesh import ParallelDims
    from repro_torch.parallel.sharding import P, local_shard
    ref, ranks = runs
    s = SHARED
    cfg = MoEConfig(d_model=s["M"], d_ff=s["F"], n_experts=s["E"],
                    top_k=s["K"], n_shared_experts=1)
    dims = ParallelDims(**DIMS)
    for rank, got in enumerate(ranks):
        mesh = _mesh((2, 2), rank)
        specs = moe_param_specs(cfg, mesh, dims)
        assert specs["shared_w1"] == P(None, ("model",))
        specs["x"] = P(dims.batch_axes, None, None)
        np.testing.assert_allclose(
            got["shared"]["y"], local_shard(ref["shared"]["y"], specs["x"],
                                            mesh), rtol=2e-4, atol=2e-5)
        for k, g in got["shared"]["g"].items():
            want = local_shard(ref["shared"]["g"][k], specs[k], mesh)
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"rank {rank} grad {k}")
