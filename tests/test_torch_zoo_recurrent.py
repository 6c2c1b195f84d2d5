"""The two recurrent configs, hymba-1.5b (attention beside a Mamba head in
every layer) and xlstm-350m (mLSTM runs with an sLSTM every 8th layer),
against the JAX package on the CPU: each config's fields, ``Model.loss``
and every parameter's gradient from the JAX parameters
(``params_from_jax``), teacher-forced ``decode_step`` logits and every
cache leaf (the attention's ring and the recurrent states) at each step
against JAX's ``decode_step``, then ``make_serve_step``'s greedy tokens
against JAX's, ``param_specs`` against JAX's ``Model.specs`` and
``cache_specs`` against JAX's (on the (2, 2), 4 x 2 and 16 x 16 meshes),
the refusals (the ``Engine``, ``prefill_step``, ``paged_step``), every
mesh path running on the meta device, and the train launcher's events.

Each config is reduced the same way on both sides, keeping its trait:
hymba to 2 layers with a 64-token window under an 80-token sequence and
GQA 4 / 2 (``reduced()`` makes them 4 / 4); its decode runs 60 prompt
tokens and 12 generated ones, past the window, so the 64-slot ring wraps
while the Mamba state carries on.  xlstm to 4 layers, so that two sLSTM
runs stand between the mLSTM runs (``slstm_every`` 2), without rope,
sinusoidal positions or FFN.

Tolerances: loss and CE 1e-5 relative, a gradient leaf within 1e-4 of
its largest entry (``test_torch_zoo_train.py``'s); decode logits and
each cache leaf within 1e-5 of the leaf's largest entry (an sLSTM's
stabilizer ``m`` sums log gates over the steps: ~250 after 60), ``pos``
exact, greedy tokens equal; decode against the port's own
``Model.forward`` within 1e-3 (JAX's
``test_decode_matches_prefill_dense``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro.train import make_serve_step as j_make_serve_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.train import make_serve_step  # noqa: E402

DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
ARCHS = ("hymba-1.5b", "xlstm-350m")
SEQ = 80
B = 2
#: decode: teacher-forced prompt tokens, then greedy ones (hymba: 72 > 64)
PROMPT, GEN = 60, 12
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: its tensors here are small,
    and beside other test processes a thread pool per process only
    contends for the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduce(cfg):
    """``cfg`` (either package's) cut to test size, keeping its trait."""
    if cfg.name.startswith("hymba"):
        return dataclasses.replace(cfg.reduced(), n_kv_heads=2)
    return cfg.reduced(n_layers=4)


@functools.cache
def _params(arch):
    jmodel = build_model(reduce(j_get_config(arch)))
    jparams = jax.tree.map(np.asarray,
                           jax.jit(jmodel.init)(jax.random.PRNGKey(1)))
    return jparams, params_from_jax(jparams, reduce(get_config(arch)),
                                    device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_jaxs(arch):
    j, t = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.runs() == j.runs()
    assert reduce(t).runs() == reduce(j).runs()


def test_reductions_keep_each_trait():
    hy, xl = (reduce(get_config(a)) for a in ARCHS)
    assert hy.runs() == [("hymba", 2)]
    assert hy.attn_window == 64 < min(SEQ, PROMPT + GEN)
    assert (hy.n_heads, hy.n_kv_heads) == (4, 2)
    assert xl.runs() == [("mlstm", 1), ("slstm", 1), ("mlstm", 1),
                         ("slstm", 1)]
    assert not xl.use_rope and xl.arch_type == "ssm" and xl.d_ff == 0
    assert xl.tie_embeddings


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jcfg, tcfg = reduce(j_get_config(arch)), reduce(get_config(arch))
    jmodel = build_model(jcfg)
    jparams, tparams = _params(arch)
    batch = SyntheticLM(DataConfig(vocab_size=tcfg.vocab_size, seq_len=SEQ,
                                   global_batch=B, seed=3)).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = make_mesh((1, 1), ("data", "model"))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, mesh=mesh, dims=DIMS),
        has_aux=True))(jparams)

    tparams = params_from_jax(jparams, tcfg, device="cpu")
    flat = leaves(tparams)
    for t in flat:
        t.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tloss, tm = Model(tcfg, device="cpu").loss(tparams, tbatch)
    grads = iter(torch.autograd.grad(tloss, flat))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for key in ("ce", "aux", "ppl_proxy"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   rtol=1e-5, atol=1e-7)
    assert tm["expert_load"].shape == (0,)

    def walk(tree, jtree, path):
        if isinstance(tree, dict):
            assert set(tree) == set(jtree), path
            for k in tree:
                walk(tree[k], jtree[k], f"{path}.{k}")
            return
        w = np.asarray(jtree, np.float32)
        atol = 1e-4 * float(np.abs(w).max(initial=0.0))
        np.testing.assert_allclose(next(grads).numpy(), w, rtol=0,
                                   atol=atol, err_msg=path)

    walk(tparams, jax.tree.map(np.asarray, jgrads), arch)


def _leaves(tree, pre=""):
    """A cache tree's leaves by path; a recurrent state's tuple by index."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {pre: np.asarray(tree)}
    return {k2: v2 for k, v in items
            for k2, v2 in _leaves(v, f"{pre}/{k}").items()}


def close(got, want, what):
    """max |got - want| <= ``REL`` * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= REL * scale, f"{what}: max|d| {err:.3e}, max {scale:.3e}"


def _check_cache(tcache, jcache, what):
    got, want = _leaves(tcache), _leaves(jcache)
    assert set(got) == set(want), what
    for k, w in want.items():
        if k.endswith("pos"):
            np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")
        else:
            close(got[k], w, f"{what} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_and_serve_match_jax(arch):
    jcfg, tcfg = reduce(j_get_config(arch)), reduce(get_config(arch))
    jmodel, tmodel = build_model(jcfg), Model(tcfg, device="cpu")
    jparams, tparams = _params(arch)
    mesh = make_mesh((1, 1), ("data", "model"))
    max_len = PROMPT + GEN + 4
    toks = np.random.RandomState(2).randint(
        0, tcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jdecode = jax.jit(lambda p, c, b: jmodel.decode_step(
        p, c, b, mesh=mesh, dims=DIMS))
    jserve = jax.jit(j_make_serve_step(jmodel, mesh, DIMS))
    serve = make_serve_step(tmodel)
    jcache, tcache = jmodel.init_cache(B, max_len), \
        tmodel.init_cache(B, max_len)
    _check_cache(tcache, jcache, "init")
    if arch.startswith("hymba"):
        assert tcache["run0"]["attn"]["k"].shape[2] == 64     # the ring
    with torch.no_grad():
        want, _ = tmodel.forward(tparams, {
            "tokens": torch.from_numpy(toks).long()})
    for t in range(PROMPT):
        tok = toks[:, t:t + 1]
        jl, jcache = jdecode(jparams, jcache, {"tokens": jnp.asarray(tok),
                                               "step": jnp.int32(t)})
        with torch.no_grad():
            tl, tcache = tmodel.decode_step(
                tparams, tcache, {"tokens": torch.from_numpy(tok),
                                  "step": t})
        close(tl, jl, f"logits, step {t}")
        _check_cache(tcache, jcache, f"step {t}")
        assert float((tl[:, 0] - want[:, t]).abs().max()) < 1e-3, t
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
    for t in range(PROMPT, PROMPT + GEN):
        jtok, jcache = jserve(jparams, jcache, {"tokens": jtok,
                                                "step": jnp.int32(t)})
        ttok, tcache = serve(tparams, tcache, {"tokens": ttok, "step": t})
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist(), t
    _check_cache(tcache, jcache, "after the greedy steps")
    if arch.startswith("hymba"):      # the ring wrapped past slot 63
        pos = tcache["run0"]["attn"]["pos"]
        assert int(pos.max()) == PROMPT + GEN - 1 and int(pos[0, 0, 0]) == 64


def _canon(tree):
    if isinstance(tree, dict):
        return {k: _canon(v) for k, v in tree.items()}
    return tuple(None if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)) for e in tree)


#: (mesh shape, full size): the (2, 2) test mesh reduced and at full size,
#: JAX's 4 x 2 test mesh and the 16 x 16 production mesh at full size
SPEC_MESHES = [((2, 2), False), ((2, 2), True), ((4, 2), True),
               ((16, 16), True)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,full", SPEC_MESHES,
                         ids=[f"{a}x{b}-{'full' if f else 'reduced'}"
                              for (a, b), f in SPEC_MESHES])
def test_param_specs_are_jaxs(arch, shape, full):
    """``Model.param_specs`` is JAX's ``Model.specs``, checked: hymba's 25
    query heads do not divide over 2 or 16 (the gathered-heads layout,
    ``attention.attn_layout``), xlstm's 4 mLSTM heads not over 16 (its
    gathered-heads cell)."""
    from repro.parallel.mesh import ParallelDims as JDims
    from repro_torch.models.attention import attn_layout
    from repro_torch.models.blocks import attn_config
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.mesh import ParallelDims as TDims
    mesh = Mesh(shape, ("data", "model"), 0, groups=False)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    if not full:
        jcfg, tcfg = reduce(jcfg), reduce(tcfg)
    dims = dict(dp=("data",), mp=("model",))
    want = build_model(jcfg).specs(mesh, JDims(**dims))
    got = Model(tcfg, device="meta").param_specs(want, mesh, TDims(**dims))
    assert _canon(got) == _canon(want)
    if arch.startswith("hymba") and full:
        assert attn_layout(attn_config(tcfg, "hymba"), shape[1]) \
            == "gathered"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,full", SPEC_MESHES,
                         ids=[f"{a}x{b}-{'full' if f else 'reduced'}"
                              for (a, b), f in SPEC_MESHES])
@pytest.mark.parametrize("seq_shard", [False, True], ids=["w", "wshard"])
def test_cache_specs_are_jaxs_but_for_the_state_dims(arch, shape, full,
                                                     seq_shard):
    """``train.cache_specs`` leaf by leaf against JAX's, at a batch that
    divides over ``data`` and at B=1: every entry JAX's but the settled
    ones, the kv heads over MP (dim 3 of K/V, where W stays whole and
    they divide), Mamba's Di (dim 3 of ``conv_buf``, dim 2 of ``h``)
    where its cell splits, mLSTM's H (dim 2 of ``C``, ``n``, ``m``) where
    its heads divide; JAX's rule for W would read mLSTM's 5-d ``C`` as
    K/V, the port's keys it by name (no case here meets JAX's bound)."""
    from repro.parallel.mesh import ParallelDims as JDims
    from repro.train import cache_specs as j_cache_specs
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.mesh import ParallelDims as TDims
    from repro_torch.train import cache_specs
    mesh = Mesh(shape, ("data", "model"), 0, groups=False)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    if not full:
        jcfg, tcfg = reduce(jcfg), reduce(tcfg)
    dims = dict(dp=("data",), mp=("model",))
    n_mp = shape[1]
    d_inner = 2 * tcfg.d_model
    for batch, max_len in ((2 * shape[0], 2048), (1, 4096)):
        got = _spec_leaves(cache_specs(Model(tcfg, device="meta"), mesh,
                                       TDims(**dims), batch, max_len,
                                       seq_shard=seq_shard))
        want = _spec_leaves(j_cache_specs(
            build_model(jcfg), mesh, JDims(**dims), batch, max_len,
            seq_shard=seq_shard))
        assert set(got) == set(want)
        settled = {("attn/k", 3), ("attn/v", 3), ("mamba/0", 3),
                   ("mamba/1", 2), ("mlstm/0", 2), ("mlstm/1", 2),
                   ("mlstm/2", 2)}
        for path, g in got.items():
            cell = path.split("/", 1)[1]
            for d, (a, b) in enumerate(zip(g, want[path])):
                if a != b:
                    assert (cell, d) in settled and a == ("model",) \
                        and b is None, (path, d, g, want[path])
            split = {"mamba/0": (3, d_inner % n_mp == 0),
                     "mlstm/0": (2, tcfg.n_kv_heads % n_mp == 0)}
            if cell in split:
                dim, yes = split[cell]
                assert (g[dim] == ("model",)) == yes, (path, g)


def _spec_leaves(tree, pre=""):
    """A cache specs tree's specs by path (a state tuple's by index),
    each as :func:`_canon` writes it."""
    if isinstance(tree, dict):
        return {k2: v for k in tree
                for k2, v in _spec_leaves(tree[k], f"{pre}/{k}").items()}
    if type(tree) is tuple:
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _spec_leaves(t, f"{pre}/{i}").items()}
    return {pre.lstrip("/"): _canon(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_refusals(arch):
    """The ``Engine``, ``prefill_step`` and ``paged_step`` refuse with
    JAX's errors.  On a mesh nothing refuses: ``loss``, ``init_cache``,
    ``decode_step`` and ``cache_specs`` run as rank 0 of (2, 2), and the
    dry run traces the arch (its Mamba / mLSTM column exchange counted as
    a collective-permute)."""
    from repro.serve.engine import Engine as JEngine
    from repro_torch.launch import dryrun
    from repro_torch.parallel.mesh import ParallelDims as TDims
    from repro_torch.serve import Engine
    from repro_torch.train import cache_specs
    jcfg, tcfg = reduce(j_get_config(arch)), reduce(get_config(arch))
    jmodel, tmodel = build_model(jcfg), Model(tcfg, device="cpu")
    jparams, tparams = _params(arch)
    mesh = make_mesh((1, 1), ("data", "model"))

    def message(fn):
        with pytest.raises(NotImplementedError) as e:
            fn()
        return str(e.value)

    assert message(lambda: Engine(tmodel)) == message(
        lambda: JEngine(jmodel, mesh, DIMS))
    toks = np.zeros((B, 8), np.int32)
    lengths = np.full((B,), 8, np.int32)
    assert message(lambda: tmodel.prefill_step(
        tparams, tmodel.init_cache(B, 16), {"tokens": torch.from_numpy(toks)},
        lengths=torch.from_numpy(lengths))) == message(
        lambda: jmodel.prefill_step(
            jparams, jmodel.init_cache(B, 16), {"tokens": jnp.asarray(toks)},
            lengths=jnp.asarray(lengths), mesh=mesh, dims=DIMS))
    paged = {"tokens": toks[:, :1], "starts": np.zeros((B,), np.int32),
             "lens": np.ones((B,), np.int32),
             "tables": np.ones((B, 1), np.int32)}
    assert message(lambda: tmodel.paged_step(
        tparams, {}, {k: torch.from_numpy(v) for k, v in paged.items()})) \
        == message(lambda: jmodel.paged_step(
            jparams, {}, {k: jnp.asarray(v) for k, v in paged.items()},
            mesh=mesh, dims=DIMS))

    # on a mesh every path runs: rank 0 of (2, 2) on the meta device under
    # the fake torch.distributed backend, as the dry run traces it
    import torch.distributed as dist

    from repro_torch.analysis.layerwise import full_param_shapes
    from repro_torch.launch.mesh import fake_world
    from repro_torch.parallel.mesh import make_mesh as t_make_mesh
    from repro_torch.parallel.sharding import local_shape
    tdims = TDims(dp=("data",), mp=("model",))
    meta = Model(tcfg, device="meta")
    fake_world(4, 0)
    try:
        tmesh = t_make_mesh((2, 2), ("data", "model"))
        full = full_param_shapes(tcfg)
        specs = meta.param_specs(full, tmesh, tdims)

        def shard(t, s):
            if isinstance(t, dict):
                return {k: shard(t[k], s[k]) for k in t}
            return torch.empty(local_shape(t.shape, s, tmesh),
                               dtype=t.dtype, device="meta")
        mparams = shard(full, specs)
        rows = {"tokens": torch.zeros((B // 2, 8), dtype=torch.long,
                                      device="meta")}
        loss, _ = meta.loss(mparams, {**rows, "labels": rows["tokens"]},
                            mesh=tmesh, dims=tdims)
        assert loss.shape == ()
        cspecs = cache_specs(meta, tmesh, tdims, B, 16)
        cache = meta.init_cache(B, 16, mesh=tmesh, dims=tdims, specs=cspecs)
        logits, _ = meta.decode_step(
            mparams, cache, {"tokens": rows["tokens"][:, :1], "step": 0},
            mesh=tmesh, dims=tdims, specs=cspecs)
        assert logits.shape == (B // 2, 1, tcfg.vocab_size)
    finally:
        dist.destroy_process_group()
    rec = dryrun.dry_one(arch, "train_4k", False, reduced=True, seq=64,
                         batch_size=8, test_mesh=True)
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert "collective-permute" in rec["collectives"]["counts"]


def test_train_launcher_writes_jaxs_events(tmp_path, capsys):
    """``launch.train --arch xlstm-350m --reduced --device cpu`` writes the
    events JAX's launcher writes with the same flags (a dense arch's: no
    plan stages to trace, no load to stream)."""
    import json
    import os

    from repro_torch.launch.train import main
    from repro_torch.obs.sink import read_events
    mdir, log = os.path.join(tmp_path, "m"), os.path.join(tmp_path, "l.json")
    main(["--arch", "xlstm-350m", "--device", "cpu", "--reduced", "--steps",
          "3", "--seq", "32", "--batch", "2", "--metrics-dir", mdir,
          "--trace", "--log-json", log])
    cap = capsys.readouterr()
    assert "final loss" in cap.out
    rec = json.load(open(log))
    assert [e["event"] for e in read_events(rec["obs"]["metrics_files"])] \
        == ["meta", "train_step", "train_step"]
    assert "--trace: dense arch" in cap.out + cap.err
