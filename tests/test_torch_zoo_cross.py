"""The two cross-attention configs, llama-3.2-vision-11b (a gated
``cross`` layer every 5th layer over precomputed image embeddings) and
whisper-tiny (``xdec`` decoder layers over an encoder of precomputed audio
frames), against the JAX package on the CPU: each config's fields, the
init tree's keys, order and shapes, ``Model.loss`` and every parameter's
gradient (the encoder's, the gates', the cross layer's unread ``attn`` and
``norm2`` among them) from the JAX parameters, ``Model.ctx_kv``,
teacher-forced ``decode_step`` logits and every cache leaf at each step,
then ``make_serve_step``'s greedy tokens, ``param_specs`` against JAX's
``Model.specs``, the refusals (the ``Engine``, ``prefill_step`` and
``paged_step``; the mesh paths run), JAX's ``Trainer`` without ``ctx_embeds``
and the train launcher's events, and the cross attention itself on both
of its paths.

Each config is reduced the same way on both sides (``reduced()``):
llama-3.2-vision to ``[dense, cross]`` over 16 context embeddings, with 2
kv heads to keep its GQA (``reduced()`` makes them 4 / 4); whisper to 2
``xdec`` layers and a 2-layer encoder over 32 frames.  JAX starts the
gates ``gate_attn`` / ``gate_ffn`` at 0, where a cross layer is the
identity and its ``xattn`` and ``ffn`` get zero gradients, so both sides
get the parameters with the gates set to 0.5 and -0.3 (``GATES``); the
qkv, FFN and layernorm biases, zeros at init, get small random values
too, so that they are read.

Tolerances: loss and CE 1e-5 relative, a gradient leaf within 1e-4 of its
largest entry (``test_torch_zoo_train.py``'s; whisper's key biases, whose
exact gradient is zero without rope, within 1e-4 of their ``wk``'s), the
unread leaves exactly zero on both sides; ``ctx_kv``, decode logits and each cache leaf within
1e-5 of the leaf's largest entry, ``pos`` exact, greedy tokens equal;
decode against the port's own ``Model.forward`` within 1e-3 (JAX's
``test_decode_matches_prefill_dense``); the ``Trainer`` as
``test_torch_train.py``'s (losses, CE, gradient norms and learning rates
1e-4 relative, parameters within 5e-5 (its SwiGLU qwen3's), moments 2e-3
of their largest entry, the key bias, whose exact gradient is zero, to the steps' learning
rates).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import blocks as j_blocks  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import make_serve_step as j_make_serve_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (opt_state_from_jax,  # noqa: E402
                                 params_from_jax, to_numpy)
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import blocks as t_blocks  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.train import Trainer, make_serve_step  # noqa: E402
from repro_torch.train.loop import grads_of  # noqa: E402

DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
ARCHS = ("llama-3.2-vision-11b", "whisper-tiny")
SEQ, B = 24, 2
#: decode: teacher-forced prompt tokens, then greedy ones
PROMPT, GEN = 10, 6
REL = 1e-5
#: the cross layers' gates, nonzero on both sides (JAX starts them at 0)
GATES = {"gate_attn": 0.5, "gate_ffn": -0.3}
#: the leaves a ``cross`` layer carries and never reads
UNREAD = ("attn", "norm2")


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
    if cfg.arch_type == "vlm":
        return dataclasses.replace(cfg.reduced(), n_kv_heads=2)
    return cfg.reduced()


def _mesh():
    return make_mesh((1, 1), ("data", "model"))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def set_gates_and_biases(tree, seed=5):
    """``tree`` (a JAX parameter tree, as numpy) with ``GATES`` in every
    cross layer and small random values in every bias (zeros at init)."""
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


@functools.cache
def _jparams(arch):
    """JAX's reduced parameters, with ``set_gates_and_biases``, as numpy."""
    jmodel = build_model(reduce(j_get_config(arch)))
    return set_gates_and_biases(_np_tree(
        jax.jit(jmodel.init)(jax.random.PRNGKey(1))))


def _ctx(cfg, seed=4):
    n = cfg.n_ctx_tokens if cfg.arch_type == "vlm" else cfg.encoder_seq
    return np.random.RandomState(seed).randn(B, n, cfg.d_model).astype(
        np.float32)


def _batch(cfg):
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                   global_batch=B, seed=3)).batch(0)
    return {**batch, "ctx_embeds": _ctx(cfg)}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def close(got, want, what, rel=REL):
    """max |got - want| <= ``rel`` * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"{what}: max|d| {err:.3e}, max {scale:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_jaxs(arch):
    j, t = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.runs() == j.runs()
    assert reduce(t).runs() == reduce(j).runs()


def test_reductions_keep_each_trait():
    vis, wh = (reduce(get_config(a)) for a in ARCHS)
    assert vis.runs() == [("dense", 1), ("cross", 1)]
    assert (vis.n_heads, vis.n_kv_heads, vis.n_ctx_tokens) == (4, 2, 16)
    assert vis.use_rope and not vis.qkv_bias and not vis.tie_embeddings
    assert wh.runs() == [("xdec", 2)]
    assert (wh.encoder_layers, wh.encoder_seq) == (2, 32)
    assert not wh.use_rope and wh.qkv_bias and wh.ffn_bias
    assert wh.norm_type == "layernorm" and wh.tie_embeddings
    full = get_config(ARCHS[0])
    assert [k for k in full.layer_kinds() if k == "cross"] == ["cross"] * 8


def _keys_and_shapes(tree):
    if isinstance(tree, dict):
        return [(k, _keys_and_shapes(v)) for k, v in tree.items()]
    return tuple(np.shape(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_is_jaxs(arch):
    """The port's ``Model.init`` has JAX's top-level keys in the order
    JAX's ``Model.init`` builds them (``embed``, ``final_norm``,
    ``lm_head``, the runs, then ``encoder`` and ``enc_norm``), every leaf
    JAX's shape (``jax.eval_shape``), and each kind's ``init_block`` JAX's
    keys in JAX's order (JAX's stacked runs come out of ``vmap`` with
    sorted keys, so a layer is held to JAX's unstacked ``init_block``)."""
    jcfg, tcfg = reduce(j_get_config(arch)), reduce(get_config(arch))
    jtree = jax.eval_shape(build_model(jcfg).init, jax.random.PRNGKey(0))
    ttree = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    runs = [f"run{r}" for r in range(len(tcfg.runs()))]
    assert list(ttree) == (
        ["embed", "final_norm"] + ([] if tcfg.tie_embeddings else ["lm_head"])
        + runs + (["encoder", "enc_norm"] if tcfg.encoder_layers else []))

    def sorted_tree(t):
        return {k: sorted_tree(t[k]) for k in sorted(t)} \
            if isinstance(t, dict) else t
    assert _keys_and_shapes(sorted_tree(ttree)) == \
        _keys_and_shapes(sorted_tree(jtree))
    kinds = [k for k, _ in tcfg.runs()] + (
        ["encoder"] if tcfg.encoder_layers else [])
    for kind in kinds:
        jb = j_blocks.init_block(jax.random.PRNGKey(0), jcfg, kind)
        tb = t_blocks.init_block(torch.Generator().manual_seed(0), tcfg,
                                 kind, torch.float32)
        assert _keys_and_shapes(tb) == _keys_and_shapes(jb), kind
    if tcfg.cross_every:
        for gate in GATES:
            assert float(ttree["run1"][gate].abs().max()) == 0.0


def _grads_tree(tparams, grads):
    it = iter(grads)

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else next(it).numpy()
    return walk(tparams)


@functools.cache
def _jax_loss_and_grads(arch):
    """JAX's loss, metrics and gradients (as numpy) on ``_batch``."""
    jmodel = build_model(reduce(j_get_config(arch)))
    jbatch = {k: jnp.asarray(v)
              for k, v in _batch(reduce(get_config(arch))).items()}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, mesh=_mesh(), dims=DIMS),
        has_aux=True))(_jparams(arch))
    return float(jloss), {k: float(v) for k, v in jm.items()
                          if np.ndim(v) == 0}, _np_tree(jgrads)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, remat):
    """With ``ctx_embeds``: the loss and every gradient leaf, whisper's
    encoder and ``enc_norm`` (reached only through the ``xdec`` layers'
    K/V), the gates, and the cross layer's unread ``attn`` / ``norm2``
    exactly zero on both sides; under remat (the port's only: JAX's
    values do not depend on it) the context goes into each block's
    checkpoint."""
    tcfg = dataclasses.replace(reduce(get_config(arch)), remat=remat)
    jloss, jm, want = _jax_loss_and_grads(arch)
    jparams, batch = _jparams(arch), _batch(tcfg)
    tparams = params_from_jax(jparams, tcfg, device="cpu")
    flat = leaves(tparams)
    for t in flat:
        t.requires_grad_(True)
    tloss, tm = Model(tcfg, device="cpu").loss(tparams, _torch(batch))
    got = _grads_tree(tparams, grads_of(tloss, flat))
    np.testing.assert_allclose(tloss.item(), jloss, rtol=1e-5)
    for key in ("ce", "aux", "ppl_proxy"):
        np.testing.assert_allclose(tm[key].item(), jm[key], rtol=1e-5,
                                   atol=1e-7)

    def walk(g, w, path, scale=None):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                # whisper's key bias (no rope) shifts every score of a
                # query by one constant: its exact gradient is zero, both
                # sides round to ~1e-10, held to its ``wk``'s scale
                walk(g[k], w[k], f"{path}.{k}", np.abs(w["wk"]).max()
                     if k == "bk" and not tcfg.use_rope else None)
            return
        w = np.asarray(w, np.float32)
        atol = 1e-4 * float(np.abs(w).max(initial=0.0) if scale is None
                            else scale)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=path)

    walk(got, want, arch)
    if tcfg.cross_every:
        for name in UNREAD:
            for tree in (got["run1"][name], want["run1"][name]):
                assert all(not np.any(v) for v in leaves(tree)), name
        for gate in GATES:
            assert abs(float(got["run1"][gate][0])) > 0
    else:
        assert float(np.abs(got["encoder"]["attn"]["wq"]).max()) > 0
        assert float(np.abs(got["enc_norm"]["scale"]).max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_ctx_kv_matches_jax(arch):
    jcfg, tcfg = reduce(j_get_config(arch)), reduce(get_config(arch))
    jmodel, tmodel = build_model(jcfg), Model(tcfg, device="cpu")
    jparams = _jparams(arch)
    tparams = params_from_jax(jparams, tcfg, device="cpu")
    ctx = _ctx(tcfg)
    want = jax.jit(lambda p, c: jmodel.ctx_kv(
        p, {"ctx_embeds": c}, mesh=_mesh(), dims=DIMS))(jparams, ctx)
    with torch.no_grad():
        got = tmodel.ctx_kv(tparams, {"ctx_embeds": torch.from_numpy(ctx)})
    assert set(got) == set(want)
    for r in want:
        for name in ("k", "v"):
            close(got[r][name], want[r][name], f"{r}.{name}")
    assert tmodel.ctx_kv(tparams, {}) is None


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{pre}/{k}").items()}
    return {pre: np.asarray(tree)}


def _check_cache(tcache, jcache, what):
    got, want = _leaves(tcache), _leaves(jcache)
    assert set(got) == set(want), what
    for k, w in want.items():
        if k.endswith("pos") or k.endswith("dummy"):
            np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")
        else:
            close(got[k], w, f"{what} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_and_serve_match_jax(arch):
    """``decode_step`` over ``ctx_kv`` teacher-forced through ``PROMPT``
    tokens (logits and every cache leaf, the cross run's ``dummy``
    untouched), against the port's ``Model.forward`` with the same
    ``ctx_embeds``, then ``GEN`` greedy steps of each package's four-
    argument ``make_serve_step``."""
    jcfg, tcfg = reduce(j_get_config(arch)), reduce(get_config(arch))
    jmodel, tmodel = build_model(jcfg), Model(tcfg, device="cpu")
    jparams = _jparams(arch)
    tparams = params_from_jax(jparams, tcfg, device="cpu")
    mesh = _mesh()
    max_len = PROMPT + GEN + 2
    ctx = _ctx(tcfg)
    toks = np.random.RandomState(2).randint(
        0, tcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jkv = jmodel.ctx_kv(jparams, {"ctx_embeds": jnp.asarray(ctx)},
                        mesh=mesh, dims=DIMS)
    jdecode = jax.jit(lambda p, c, b, kv: jmodel.decode_step(
        p, c, b, mesh=mesh, dims=DIMS, ctx_kv=kv))
    jserve = jax.jit(j_make_serve_step(jmodel, mesh, DIMS))
    serve = make_serve_step(tmodel)
    jcache, tcache = jmodel.init_cache(B, max_len), \
        tmodel.init_cache(B, max_len)
    _check_cache(tcache, jcache, "init")
    with torch.no_grad():
        tkv = tmodel.ctx_kv(tparams, {"ctx_embeds": torch.from_numpy(ctx)})
        want, _ = tmodel.forward(tparams, {
            "tokens": torch.from_numpy(toks).long(),
            "ctx_embeds": torch.from_numpy(ctx)})
    for t in range(PROMPT):
        tok = toks[:, t:t + 1]
        jl, jcache = jdecode(jparams, jcache, {"tokens": jnp.asarray(tok),
                                               "step": jnp.int32(t)}, jkv)
        with torch.no_grad():
            tl, tcache = tmodel.decode_step(
                tparams, tcache, {"tokens": torch.from_numpy(tok),
                                  "step": t}, ctx_kv=tkv)
        close(tl, jl, f"logits, step {t}")
        _check_cache(tcache, jcache, f"step {t}")
        assert float((tl[:, 0] - want[:, t]).abs().max()) < 1e-3, t
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
    for t in range(PROMPT, PROMPT + GEN):
        jtok, jcache = jserve(jparams, jcache, {"tokens": jtok,
                                                "step": jnp.int32(t)}, jkv)
        ttok, tcache = serve(tparams, tcache, {"tokens": ttok, "step": t},
                             tkv)
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist(), t
    _check_cache(tcache, jcache, "after the greedy steps")
    with pytest.raises(ValueError, match="ctx_kv"):
        tmodel.decode_step(tparams, tcache, {"tokens": ttok, "step": 0})


def _canon(tree):
    if isinstance(tree, dict):
        return {k: _canon(v) for k, v in tree.items()}
    return tuple(None if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)) for e in tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_param_specs_are_jaxs(arch, full):
    """``Model.param_specs`` is JAX's ``Model.specs`` on (2, 2), reduced
    and at full size (the gates replicated, ``xattn`` as ``attn``, the
    encoder behind its layer dimension)."""
    from repro.parallel.mesh import ParallelDims as JDims
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.mesh import ParallelDims as TDims
    mesh = Mesh((2, 2), ("data", "model"), 0, groups=False)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    if not full:
        jcfg, tcfg = reduce(jcfg), reduce(tcfg)
    dims = dict(dp=("data",), mp=("model",))
    want = build_model(jcfg).specs(mesh, JDims(**dims))
    got = Model(tcfg, device="meta").param_specs(want, mesh, TDims(**dims))
    assert _canon(got) == _canon(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_refusals(arch, capsys, monkeypatch):
    """The ``Engine``, ``prefill_step`` and ``paged_step`` refuse with
    JAX's errors.  The mesh paths, which the port refused before, run:
    ``loss``, ``ctx_kv`` and ``decode_step`` on a one-rank mesh give the
    one-rank results; ``cache_specs`` and ``init_cache(mesh=, specs=)``
    on rank 0 of (2, 2) lay out this rank's rows and kv heads, a ``cross``
    run's ``dummy`` under JAX's ``P(None)``; the dry run gives a record
    and its CLI's full-size ``decode_32k`` exits 0 (the four ranks'
    numbers: ``test_torch_cross_dist.py``)."""
    from repro.serve.engine import Engine as JEngine
    from repro_torch.launch import dryrun
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.mesh import ParallelDims as TDims
    from repro_torch.parallel.sharding import P
    from repro_torch.serve import Engine
    from repro_torch.train import cache_specs
    jcfg, tcfg = reduce(j_get_config(arch)), reduce(get_config(arch))
    jmodel, tmodel = build_model(jcfg), Model(tcfg, device="cpu")
    jparams = _jparams(arch)
    tparams = params_from_jax(jparams, tcfg, device="cpu")
    mesh = _mesh()

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

    one = Mesh((1, 1), ("data", "model"))
    tdims = TDims(dp=("data",), mp=("model",))
    batch = {"tokens": torch.zeros((B, 8), dtype=torch.long),
             "labels": torch.zeros((B, 8), dtype=torch.long),
             "ctx_embeds": torch.from_numpy(_ctx(tcfg))}
    step = {"tokens": batch["tokens"][:, :1], "step": 0}
    with torch.no_grad():
        for kw in ({}, {"mesh": one, "dims": tdims}):
            loss, _ = tmodel.loss(tparams, batch, **kw)
            kv = tmodel.ctx_kv(tparams, batch, **kw)
            specs = cache_specs(tmodel, one, tdims, B, 16) if kw else None
            logits, _ = tmodel.decode_step(
                tparams, tmodel.init_cache(B, 16, specs=specs, **kw), step,
                ctx_kv=kv, specs=specs, **kw)
            if not kw:
                want = (loss, kv, logits)
    assert torch.equal(loss, want[0]) and torch.equal(logits, want[2])
    assert all(torch.equal(kv[r][n], want[1][r][n]) for r in kv
               for n in ("k", "v"))

    two = Mesh((2, 2), ("data", "model"), 0, groups=False)
    specs = cache_specs(tmodel, two, tdims, B, 16)
    cache = tmodel.init_cache(B, 16, mesh=two, dims=tdims, specs=specs)
    for r, (kind, n) in enumerate(tcfg.runs()):
        run, c = specs[f"run{r}"], cache[f"run{r}"]
        if kind == "cross":
            assert run == {"dummy": P(None)}
            assert tuple(c["dummy"].shape) == (n,)
        else:
            assert run["attn"]["k"] == P(None, ("data",), None, ("model",),
                                         None)
            assert tuple(c["attn"]["k"].shape) == (
                n, B // 2, 16, tcfg.n_kv_heads // 2, tcfg.hd)
    rec = dryrun.dry_one(arch, "decode_32k", False, reduced=True, seq=64,
                         batch_size=8, test_mesh=True)
    assert rec["chips"] == 8 and rec["memory_analysis"]["ctx_kv_bytes"] > 0
    monkeypatch.setattr(dryrun, "save", lambda rec, sfx="": "")
    dryrun.main(["--arch", arch, "--shape", "decode_32k"])
    assert f"[ok]   {arch} x decode_32k x single" in capsys.readouterr().out


def _close_tree(got, want, rel, floor=0.0):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        atol = max(rel * float(np.abs(w).max(initial=0.0)), floor)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_without_ctx_matches_jax(arch):
    """JAX's ``Trainer`` feeds ``SyntheticLM`` batches, no ``ctx_embeds``:
    each cross / xdec layer's ``xattn`` attends the text itself,
    unmasked, and whisper's encoder gets zero gradients while AdamW still
    decays its matrices.  The port's ``Trainer`` from the same parameters:
    3 steps' losses, CE, gradient norms and learning rates, then every
    parameter (the encoder's too) and both moments."""
    steps = 3
    jcfg, tcfg = reduce(j_get_config(arch)), reduce(get_config(arch))
    data_cfg = dict(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=B)
    opt_cfg = dict(lr=1e-3, warmup_steps=2, total_steps=steps)
    jtr = JTrainer(build_model(jcfg), _mesh(), DIMS,
                   j_adamw.AdamWConfig(**opt_cfg))
    jparams, jopt = jtr.setup(jax.random.PRNGKey(0))
    start = set_gates_and_biases(_np_tree(jparams))
    jparams = jax.tree.map(jnp.asarray, start)
    tparams = params_from_jax(start, tcfg, device="cpu")
    tr = Trainer(Model(tcfg, device="cpu"), t_adamw.AdamWConfig(**opt_cfg))
    tparams, topt, thist = tr.run(tparams, t_adamw.adamw_init(tparams),
                                  SyntheticLM(DataConfig(**data_cfg)), steps,
                                  log_every=1)
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticLM as JSyntheticLM
    jparams, jopt, jhist = jtr.run(jparams, jopt,
                                   JSyntheticLM(JDataConfig(**data_cfg)),
                                   steps, log_every=1)
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in thist],
                                   [h[key] for h in jhist], rtol=1e-4)
    lr_sum = sum(h["lr"] for h in jhist)

    def pop_key_biases(tree):
        """The key biases (exact gradient zero: Adam steps them by
        normalized rounding noise), each run's and the encoder's."""
        return [sub["attn"].pop("bk") for k, sub in tree.items()
                if k.startswith("run") or k == "encoder"
                if "bk" in sub.get("attn", {})]

    got, want = to_numpy(tparams), _np_tree(jparams)
    for g, w in zip(pop_key_biases(got), pop_key_biases(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr_sum)
    _close_tree(got, want, 0.0, 5e-5)
    jmom = opt_state_from_jax(_np_tree(jopt), tcfg, device="cpu")
    assert int(topt["step"]) == int(jmom["step"]) == steps
    for key in ("mu", "nu"):
        got, ref = to_numpy(topt[key]), to_numpy(jmom[key])
        pop_key_biases(got), pop_key_biases(ref)
        _close_tree(got, ref, 2e-3, 1e-9)
    if "encoder" in got:   # never reached by a gradient, decayed by AdamW
        mom = to_numpy(topt["mu"])["encoder"]["attn"]["wq"]
        assert float(np.abs(mom).max()) == 0.0
        assert not np.array_equal(to_numpy(tparams)["encoder"]["attn"]["wq"],
                                  start["encoder"]["attn"]["wq"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_writes_jaxs_events(arch, tmp_path, capsys):
    """``launch.train --arch <arch> --reduced --device cpu`` trains on the
    data pipeline's batches, no ``ctx_embeds``, as JAX's launcher does,
    and writes the events JAX's writes with the same flags (a dense
    arch's: no plan stages to trace, no load to stream)."""
    import json
    import os

    from repro_torch.launch.train import main
    from repro_torch.obs.sink import read_events
    mdir, log = os.path.join(tmp_path, "m"), os.path.join(tmp_path, "l.json")
    main(["--arch", arch, "--device", "cpu", "--reduced", "--steps", "3",
          "--seq", "32", "--batch", "2", "--metrics-dir", mdir, "--trace",
          "--log-json", log])
    cap = capsys.readouterr()
    assert "final loss" in cap.out
    rec = json.load(open(log))
    assert [e["event"] for e in read_events(rec["obs"]["metrics_files"])] \
        == ["meta", "train_step", "train_step"]
    assert all(np.isfinite(h["loss"]) for h in rec["history"])
    assert "--trace: dense arch" in cap.out + cap.err


@pytest.mark.parametrize("Lk", [40, 2560], ids=["sdpa", "flash-scan"])
def test_cross_attention_matches_jax(Lk):
    """``apply_attn(kv_x=)`` at a cross layer's config (no rope, no mask,
    no bias), 8 queries over ``Lk`` keys: the full ``sdpa_full`` path
    and, past 2048, the KV-block scan with its recompute backward; the
    output and the gradients of the queries' and the context's inputs
    and of every projection.  Then ``decode_attn``'s static branch over
    the same context's K/V against JAX's."""
    cfg = dataclasses.replace(reduce(j_get_config(ARCHS[0])), d_model=64,
                              head_dim=16)
    jacfg = j_blocks.attn_config(cfg, "cross", cross=True)
    tacfg = t_blocks.attn_config(reduce(get_config(ARCHS[0])), "cross",
                                 cross=True)
    tacfg = dataclasses.replace(tacfg, d_model=64, head_dim=16)
    assert dataclasses.asdict(tacfg) == {
        k: v for k, v in dataclasses.asdict(jacfg).items()
        if k not in ("masked_cache_update", "context_parallel")}
    assert not (tacfg.use_rope or tacfg.causal or tacfg.qkv_bias)
    p = _np_tree(j_attn.init_attn(jax.random.PRNGKey(3), jacfg))
    rng = np.random.RandomState(Lk)
    x = rng.randn(B, 8, 64).astype(np.float32)
    kv_x = rng.randn(B, Lk, 64).astype(np.float32)
    r = rng.randn(B, 8, 64).astype(np.float32)

    def jloss(p, x, kv_x):
        out = j_attn.apply_attn(p, jacfg, x, kv_x=kv_x)
        return jnp.sum(out * r), out
    jgrads, jout = jax.jit(jax.grad(jloss, argnums=(0, 1, 2),
                                    has_aux=True))(p, x, kv_x)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx, tkv = (torch.tensor(a, requires_grad=True) for a in (x, kv_x))
    tout = t_attn.apply_attn(tp, tacfg, tx, kv_x=tkv)
    close(tout.detach(), jout, "output")
    got = torch.autograd.grad((tout * torch.from_numpy(r)).sum(),
                              [*tp.values(), tx, tkv])
    for g, w, name in zip(got, [*jgrads[0].values(), *jgrads[1:]],
                          [*tp, "x", "kv_x"]):
        close(g, w, f"d{name}", rel=1e-4)

    K, hd = tacfg.n_kv_heads, tacfg.head_dim
    static = {n: kv_x @ p[w] for n, w in (("k", "wk"), ("v", "wv"))}
    static = {n: v.reshape(B, Lk, K, hd) for n, v in static.items()}
    jdec, _ = jax.jit(lambda p, x, kv: j_attn.decode_attn(
        p, jacfg, x, None, 0, kv_cache_static=kv))(p, x[:, :1], static)
    with torch.no_grad():
        tdec = t_attn.decode_attn(
            {k: v.detach() for k, v in tp.items()}, tacfg,
            torch.from_numpy(x[:, :1]), None, 0,
            kv_cache_static={n: torch.from_numpy(v)
                             for n, v in static.items()})
    close(tdec, jdec, "decode over the static K/V")
    close(tdec, jout[:, :1], "decode vs the full cross attention", rel=1e-4)
