"""The KV-cache serve path on one rank against the JAX package on the CPU:
``Model.prefill_step``, ``Model.decode_step`` and ``train.make_serve_step``
from the JAX parameters (``params_from_jax``), against JAX's functions of
the same names.

Cases, each reduced as ``test_torch_zoo_train.py`` reduces its config:
mistral-nemo with a head_dim of 96 (``n_heads * head_dim`` != d_model),
qwen3-moe (MoE decode: ``infer=True``), qwen1.5 (qkv bias, set to random
values: JAX initialises it to zeros), gpt2-moe (no rope: the sinusoidal
position), llama4 at 4 layers (its 64-token chunk mask, crossed by the
decode, and the NoPE ``moe_full`` fourth layer), mistral-nemo with
``attn_window=16`` (a 12-token prompt decoded past slot 16, so the ring
buffer wraps) and mistral-nemo decoded with a (B,) step vector (each row
at its own position, as the prompts' lengths leave them).

What must hold: ``prefill_step``'s last logits within 1e-5 of JAX's, every
cache leaf within 1e-5 and ``pos`` exact; teacher-forced ``decode_step``
logits within 1e-5 at every step (fed JAX's greedy tokens) and the caches
after them; ``make_serve_step``'s greedy tokens equal JAX's over 11 steps.
``make_prefill_fn`` gives JAX's forward logits.  Then, on the port
alone: JAX's ``test_decode_matches_prefill_dense``
contract (decode logits within 1e-3 of ``Model.forward``'s), the greedy
KV-cache streams equal to its paged ``Engine``'s on one trace (the
contract of JAX's ``run_paged_parity.py``), ``W < L`` raising, and
``cache_specs`` against JAX's: equal but for the kv-head dim, which the
port shards over MP where W stays whole (a settled difference).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import autosched  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro.train import cache_specs as j_cache_specs  # noqa: E402
from repro.train import make_prefill_fn as j_make_prefill_fn  # noqa: E402
from repro.train import make_serve_step as j_make_serve_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import autosched as t_autosched  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel.mesh import Mesh  # noqa: E402
from repro_torch.train import (cache_specs, make_prefill_fn,  # noqa: E402
                               make_serve_step)

from test_torch_zoo_train import reduce  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
GEN = 11
B = 2

#: case -> (arch, config edits, prompt length, per-row step vector)
CASES = {
    "mistral-nemo": ("mistral-nemo-12b", {}, 20, False),
    "qwen3-moe": ("qwen3-moe-30b-a3b", {}, 20, False),
    "qwen1.5": ("qwen1.5-0.5b", {}, 20, False),
    "gpt2-moe": ("gpt2-moe", {}, 20, False),
    "llama4": ("llama4-scout-17b-a16e", {}, 56, False),
    "window16": ("mistral-nemo-12b", {"attn_window": 16}, 12, False),
    "step-vector": ("mistral-nemo-12b", {}, 20, True),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: its tensors here are small,
    and beside other test processes a thread pool per process only
    contends for the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_sched_cache():
    autosched.clear_cache()
    t_autosched.clear_cache()
    yield
    autosched.clear_cache()
    t_autosched.clear_cache()


def _cfgs(case):
    arch, edits, _, _ = CASES[case]
    return (dataclasses.replace(reduce(j_get_config(arch)), **edits),
            dataclasses.replace(reduce(get_config(arch)), **edits))


@functools.cache
def _params(arch):
    """The JAX parameters of reduced ``arch`` (a window or a step vector
    changes no parameter: the mistral-nemo cases share them)."""
    jmodel = build_model(reduce(j_get_config(arch)))
    jparams = jax.tree.map(np.asarray,
                           jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    if jmodel.cfg.qkv_bias:       # JAX makes them zeros: give them values
        rng = np.random.RandomState(7)
        for r in range(len(jmodel.runs)):
            attn = jparams[f"run{r}"]["attn"]
            for b in ("bq", "bk", "bv"):
                attn[b] = rng.normal(0, 0.5, attn[b].shape).astype(
                    np.float32)
    return jparams, params_from_jax(jparams, reduce(get_config(arch)),
                                    device="cpu")


def _models(case):
    """The JAX model and parameters of ``case`` and the port's on them."""
    jcfg, tcfg = _cfgs(case)
    jparams, tparams = _params(CASES[case][0])
    return build_model(jcfg), jparams, Model(tcfg, device="cpu"), tparams


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{pre}/{k}").items()}
    return {pre: np.asarray(tree)}


def _check_cache(tcache, jcache):
    got, want = _leaves(tcache), _leaves(jcache)
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("pos"):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, err_msg=k, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_decode_and_serve_match_jax(case):
    jmodel, jparams, tmodel, tparams = _models(case)
    _, _, L, vector = CASES[case]
    mesh = make_mesh((1, 1), ("data", "model"))
    vocab = tmodel.cfg.vocab_size
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, vocab, (B, L)).astype(np.int32)
    lengths = np.array([L, L - 3], np.int32)
    max_len = L + GEN + 1

    jprefill = jax.jit(lambda p, c, b, n: jmodel.prefill_step(
        p, c, b, lengths=n, mesh=mesh, dims=DIMS))
    jdecode = jax.jit(lambda p, c, b: jmodel.decode_step(
        p, c, b, mesh=mesh, dims=DIMS))
    jlogits, jcache = jprefill(jparams, jmodel.init_cache(B, max_len),
                               {"tokens": jnp.asarray(tokens)},
                               jnp.asarray(lengths))
    caches = []
    with torch.no_grad():
        for _ in range(2):        # teacher-forced, and greedy
            c = tmodel.init_cache(B, max_len)
            tlogits, c = tmodel.prefill_step(
                tparams, c, {"tokens": torch.from_numpy(tokens)},
                lengths=torch.from_numpy(lengths))
            caches.append(c)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    _check_cache(caches[0], jcache)

    serve = make_serve_step(tmodel)
    tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)[:, None]
    ttok = tlogits.argmax(-1).to(torch.int32)[:, None]
    for t in range(GEN):
        step = lengths + t if vector else np.int32(L + t)
        jl, jcache = jdecode(jparams, jcache, {"tokens": jnp.asarray(tok),
                                               "step": jnp.asarray(step)})
        tstep = torch.from_numpy(np.asarray(step))
        with torch.no_grad():
            tl, _ = tmodel.decode_step(tparams, caches[0], {
                "tokens": torch.from_numpy(tok), "step": tstep})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {t}", **TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        ttok, _ = serve(tparams, caches[1], {"tokens": ttok, "step": tstep})
        assert ttok.numpy().tolist() == tok.tolist(), t
    _check_cache(caches[0], jcache)
    _check_cache(caches[1], jcache)


def test_serve_step_matches_jaxs_on_a_lockstep_batch():
    """``make_serve_step`` fed from an empty cache, token by token (JAX's
    ``TestServeLoop`` contract), equals JAX's ``make_serve_step``."""
    jmodel, jparams, tmodel, tparams = _models("qwen3-moe")
    mesh = make_mesh((1, 1), ("data", "model"))
    jserve = jax.jit(j_make_serve_step(jmodel, mesh, DIMS))
    serve = make_serve_step(tmodel)
    jcache, tcache = jmodel.init_cache(B, 12), tmodel.init_cache(B, 12)
    jtok = jnp.zeros((B, 1), jnp.int32)
    ttok = torch.zeros((B, 1), dtype=torch.int32)
    for t in range(11):
        jtok, jcache = jserve(jparams, jcache, {"tokens": jtok,
                                                "step": jnp.int32(t)})
        ttok, tcache = serve(tparams, tcache, {"tokens": ttok, "step": t})
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist(), t
    _check_cache(tcache, jcache)


def test_prefill_fn_is_jaxs():
    """``make_prefill_fn``: the full-sequence forward's logits, JAX's."""
    jmodel, jparams, tmodel, tparams = _models("qwen1.5")
    mesh = make_mesh((1, 1), ("data", "model"))
    toks = np.random.RandomState(4).randint(
        0, tmodel.cfg.vocab_size, (B, 24)).astype(np.int32)
    want = jax.jit(j_make_prefill_fn(jmodel, mesh, DIMS))(
        jparams, {"tokens": jnp.asarray(toks)})
    got = make_prefill_fn(tmodel)(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_matches_forward_dense():
    """Decode over a teacher-forced prompt gives ``Model.forward``'s
    logits (JAX's ``test_decode_matches_prefill_dense``, on the port)."""
    _, _, tmodel, tparams = _models("mistral-nemo")
    Lf = 16
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, tmodel.cfg.vocab_size, (B, Lf)).astype(np.int64))
    cache = tmodel.init_cache(B, Lf)
    with torch.no_grad():
        want, _ = tmodel.forward(tparams, {"tokens": toks})
        errs = []
        for t in range(Lf):
            lg, cache = tmodel.decode_step(
                tparams, cache, {"tokens": toks[:, t:t + 1], "step": t})
            errs.append(float((lg[:, 0] - want[:, t]).abs().max()))
    assert max(errs) < 1e-3, errs


def test_kv_cache_streams_equal_the_paged_engines():
    """Prompts of different lengths prefilled in one batch, then decoded
    with a (B,) step vector: each row's greedy stream equals the paged
    ``Engine``'s for the same request."""
    from repro_torch.serve import Engine
    _, _, tmodel, tparams = _models("mistral-nemo")
    rng = np.random.RandomState(3)
    lens = [9, 17, 5, 12]
    gen = 6
    prompts = [list(rng.randint(0, tmodel.cfg.vocab_size, n)) for n in lens]
    eng = Engine(tmodel, max_batch=4, max_len=32, block_size=8)
    for p in prompts:
        eng.submit(p, gen)
    want = [c.tokens for c in eng.run(tparams)]
    L = max(lens)
    tokens = np.zeros((len(lens), L), np.int64)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    lengths = torch.tensor(lens)
    cache = tmodel.init_cache(len(lens), 32)
    serve = make_serve_step(tmodel)
    with torch.no_grad():
        logits, cache = tmodel.prefill_step(
            tparams, cache, {"tokens": torch.from_numpy(tokens)},
            lengths=lengths)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    got = [tok]
    for t in range(gen - 1):
        tok, cache = serve(tparams, cache, {"tokens": tok,
                                            "step": lengths + t})
        got.append(tok)
    assert torch.cat(got, 1).tolist() == want


def test_prefill_longer_than_the_cache_raises():
    _, _, tmodel, tparams = _models("window16")
    cache = tmodel.init_cache(1, 64)          # W = the 16-token window
    with pytest.raises(ValueError, match="W=16 >= prompt L=20"):
        tmodel.prefill_step(tparams, cache,
                            {"tokens": torch.zeros((1, 20), dtype=torch.long)},
                            lengths=torch.tensor([20]))


@pytest.mark.parametrize("batch,max_len,seq_shard", [
    (4, 32, False), (4, 32, True), (1, 64, True), (1, 64, False),
    (4, 24, True)])
def test_cache_specs_are_jaxs_but_for_the_kv_heads(batch, max_len,
                                                   seq_shard):
    """Settled difference: where W stays whole the port's K/V are sharded
    by kv head over MP (its Megatron layout); JAX's spec leaves that dim
    replicated.  Every other entry is JAX's."""
    jmodel, _, tmodel, _ = _models("mistral-nemo")
    mesh = Mesh((2, 2), ("data", "model"))
    dims = ParallelDims(dp=("data",), mp=("model",))
    want = j_cache_specs(jmodel, mesh, dims, batch, max_len,
                         seq_shard=seq_shard)
    got = cache_specs(tmodel, mesh, dims, batch, max_len,
                      seq_shard=seq_shard)
    def entries(spec, n):       # JAX writes a one-axis entry as its name
        spec = tuple((e,) if isinstance(e, str) else e for e in spec)
        return spec + (None,) * (n - len(spec))

    for r in range(len(tmodel.runs)):
        for leaf in ("k", "v", "pos"):
            g = tuple(got[f"run{r}"]["attn"][leaf])
            w = entries(want[f"run{r}"]["attn"][leaf], len(g))
            if leaf != "pos" and g[2] is None:
                assert g[3] == ("model",) and w[3] is None
                g = g[:3] + (None,) + g[4:]
            assert g == w, (leaf, g, w)
