"""The two recurrent configs, hymba-1.5b (attention beside a Mamba head in
every layer) and xlstm-350m (mLSTM runs with an sLSTM every 8th layer),
against the JAX package on the CPU: each config's fields, ``Model.loss``
and every parameter's gradient from the JAX parameters
(``params_from_jax``), teacher-forced ``decode_step`` logits and every
cache leaf (the attention's ring and the recurrent states) at each step
against JAX's ``decode_step``, then ``make_serve_step``'s greedy tokens
against JAX's, ``param_specs`` against JAX's ``Model.specs``, the
refusals (the ``Engine``, ``prefill_step``, ``paged_step`` and any mesh),
and the train launcher's events.

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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_param_specs_are_jaxs(arch, full):
    """``Model.param_specs`` is JAX's ``Model.specs`` on (2, 2), reduced
    and at full size (hymba's 25 query heads do not divide over 2: the
    port runs no recurrent stack on a mesh, so it gives JAX's specs
    unchecked)."""
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
def test_refusals(arch, capsys):
    """The ``Engine``, ``prefill_step`` and ``paged_step`` refuse with
    JAX's errors; on a mesh every path refuses, naming ROADMAP 7d-mesh,
    and the dry run counts the arch as a failure."""
    from repro.serve.engine import Engine as JEngine
    from repro_torch.launch import dryrun
    from repro_torch.parallel.mesh import Mesh
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

    tmesh = Mesh((2, 2), ("data", "model"), 0, groups=False)
    tdims = TDims(dp=("data",), mp=("model",))
    batch = {"tokens": torch.zeros((B, 8), dtype=torch.long),
             "labels": torch.zeros((B, 8), dtype=torch.long)}
    for fn in (lambda: tmodel.loss(tparams, batch, mesh=tmesh, dims=tdims),
               lambda: tmodel.init_cache(B, 16, mesh=tmesh, dims=tdims),
               lambda: tmodel.decode_step(
                   tparams, tmodel.init_cache(B, 16),
                   {"tokens": batch["tokens"][:, :1], "step": 0},
                   mesh=tmesh, dims=tdims),
               lambda: cache_specs(tmodel, tmesh, tdims, B, 16)):
        assert "ROADMAP 7d-mesh" in message(fn)
    with pytest.raises(NotImplementedError, match="7d-mesh"):
        dryrun.dry_one(arch, "train_4k", False)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", arch, "--shape", "decode_32k"])
    assert "1 dry-run failures" in str(e.value.code)
    assert "7d-mesh" in capsys.readouterr().out


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
