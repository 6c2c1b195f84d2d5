"""The port's serving path on reduced qwen3-moe-30b-a3b with the JAX
package's parameters (``repro_torch.convert.params_from_jax``): paged-step
logits against the JAX ``Model.paged_step``, greedy token streams against
the JAX ``Engine`` (also chunked at a capacity factor whose prefill pools
drop rows), and the port's own chunked-vs-one-shot and prefix-hit-vs-cold
streams.

Tolerance for logits: 1e-4 (f32; two layers of the same math in two
frameworks differ by ~1e-6, far below it).  Token streams must be equal:
over every greedy step of these prompts the smallest top-2 logit gap is
4e-3 (seed 0) and 9e-3 (seed 3), 40x and more the logit tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import autosched  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import engine as j_engine_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.serve.engine import prefill_bucket  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GEN = 4


@pytest.fixture(scope="module")
def setup():
    autosched.clear_cache()
    jcfg = j_get_config("qwen3-moe-30b-a3b").reduced()
    tcfg = get_config("qwen3-moe-30b-a3b").reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    mesh = make_mesh((1, 1), ("data", "model"))
    dims = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
    yield jmodel, jparams, Model(tcfg, device="cpu"), tparams, mesh, dims
    autosched.clear_cache()


def _prompts(vocab, seed=0):
    """Four prompts; the second shares the first's leading 16 tokens (two
    full 8-token blocks) so it hits the prefix cache."""
    rng = np.random.RandomState(seed)
    a = list(rng.randint(0, vocab, 20))
    return [a, a[:16] + list(rng.randint(0, vocab, 5)),
            list(rng.randint(0, vocab, 12)), list(rng.randint(0, vocab, 6))]


def test_configs_agree(setup):
    jmodel, _, tmodel, _, _, _ = setup
    j, t = dataclasses.asdict(jmodel.cfg), dataclasses.asdict(tmodel.cfg)
    for key in ("moe", "kernel"):
        j.pop(key), t.pop(key)
    assert j == t
    assert jmodel.cfg.runs() == tmodel.cfg.runs()


def test_paged_step_logits_match_jax(setup):
    jmodel, jparams, tmodel, tparams, mesh, dims = setup
    bs, n_pages = 8, 9
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, tmodel.cfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    steps = [
        # one prefill chunk (padded row 1), then one decode round
        (tokens, np.zeros(2, np.int32), lens, False),
        (tokens[:, :1] + 1, lens.copy(), np.ones(2, np.int32), True),
    ]
    jcache = jmodel.init_cache(n_pages, bs)
    tcache = tmodel.init_cache(n_pages, bs)
    for toks, starts, ls, infer in steps:
        batch = {"tokens": toks, "starts": starts, "lens": ls,
                 "tables": tables}
        jlogits, jcache = jax.jit(lambda p, c, b, infer=infer:
                                  jmodel.paged_step(p, c, b, mesh=mesh,
                                                    dims=dims, infer=infer))(
            jparams, jcache, {k: jnp.asarray(v) for k, v in batch.items()})
        tlogits, tcache = tmodel.paged_step(
            tparams, tcache, {k: torch.from_numpy(v) for k, v in
                              batch.items()}, infer=infer)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)
    np.testing.assert_array_equal(tcache["run0"]["attn"]["pos"].numpy(),
                                  np.asarray(jcache["run0"]["attn"]["pos"]))


def _serve(engine, params, prompts):
    for p in prompts:
        engine.submit(p, GEN)
    return [c.tokens for c in engine.run(params)]


def test_greedy_streams_match_jax_engine(setup):
    jmodel, jparams, tmodel, tparams, mesh, dims = setup
    prompts = _prompts(tmodel.cfg.vocab_size)
    kw = dict(max_batch=4, max_len=64, block_size=8, prefill_chunk=8)
    want = _serve(JEngine(jmodel, mesh, dims, **kw), jparams, prompts)
    eng = Engine(tmodel, **kw)
    got = _serve(eng, tparams, prompts)
    assert got == want
    assert eng.stats["prefix_hits"] == 1


def test_chunked_streams_with_capacity_drops_match_jax_engine(
        setup, monkeypatch):
    """At capacity_factor 0.5 a 16-token prefill pool keeps 8 of each
    expert's 16 rows, and which rows drop depends on the chunking.  The
    JAX engine makes the same drops: chunked greedy streams equal the JAX
    engine's, drops and all."""
    from repro_torch.core import executor
    jmodel, jparams, tmodel, tparams, mesh, dims = setup
    jcfg = dataclasses.replace(jmodel.cfg, moe=dataclasses.replace(
        jmodel.cfg.moe, capacity_factor=0.5))
    tcfg = dataclasses.replace(tmodel.cfg, moe=dataclasses.replace(
        tmodel.cfg.moe, capacity_factor=0.5))
    drops = []
    gate = executor.topk_gate

    def counting_gate(*args):
        r = gate(*args)
        drops.append(float(r.aux["drop_frac"]))
        return r

    monkeypatch.setattr(executor, "topk_gate", counting_gate)
    prompts = _prompts(tmodel.cfg.vocab_size, seed=5)
    kw = dict(max_batch=4, max_len=64, block_size=8, prefill_chunk=16)
    want = _serve(JEngine(build_model(jcfg), mesh, dims, **kw), jparams,
                  prompts)
    got = _serve(Engine(Model(tcfg, device="cpu"), **kw), tparams, prompts)
    assert max(drops) > 0, "the prefill pools must drop rows"
    assert got == want


def test_chunked_and_prefix_hit_streams_match_one_shot_cold(setup):
    _, _, tmodel, tparams, _, _ = setup
    prompts = _prompts(tmodel.cfg.vocab_size, seed=3)
    base = dict(max_batch=4, max_len=64, block_size=8)
    cold = _serve(Engine(tmodel, prefix_cache=False, **base), tparams,
                  prompts)
    hit = Engine(tmodel, **base)
    assert _serve(hit, tparams, prompts) == cold
    assert hit.stats["prefix_hits"] == 1
    chunked = Engine(tmodel, prefill_chunk=8, **base)
    assert _serve(chunked, tparams, prompts) == cold
    assert chunked.stats["prefill_calls"] > hit.stats["prefill_calls"]


def test_prefill_buckets_are_the_jax_engines():
    # prefill pools take the training capacity, so the padded length (and
    # with it which rows compete for expert slots) must be the same
    for n in range(1, 300):
        for max_len in (64, 256):
            want = min(max(j_engine_mod._pow2(n), 8), max_len)
            assert prefill_bucket([n], max_len) == want


def test_convert_checks_the_layer_dimension(setup):
    jmodel, jparams, tmodel, _, _, _ = setup
    tree = jax.tree.map(np.asarray, jparams)
    tree["run0"]["norm1"]["scale"] = tree["run0"]["norm1"]["scale"][:1]
    with pytest.raises(ValueError, match="leading layer dimension"):
        params_from_jax(tree, tmodel.cfg, device="cpu")
    with pytest.raises(ValueError, match="needs"):
        params_from_jax({"embed": {}}, tmodel.cfg, device="cpu")


class TestSampler:
    """Greedy is the JAX package's argmax; sampled rows draw from their own
    (seed, position) stream (not ``jax.random``'s numbers, so only the
    contract is compared)."""

    def test_greedy_matches_jax(self):
        from repro.serve.sampler import sample as j_sample
        from repro_torch.serve.sampler import sample
        rng = np.random.RandomState(0)
        logits = rng.randn(5, 40).astype(np.float32)
        logits[2, [3, 7]] = 9.0                 # a tie: first index wins
        keys = np.zeros((5, 2), np.uint32)
        temps, topks = np.zeros(5, np.float32), np.zeros(5, np.int32)
        want = np.asarray(j_sample(jnp.asarray(logits), keys, temps, topks))
        got = sample(torch.from_numpy(logits), keys, temps, topks)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[2] == 3

    def test_top_k_and_same_key_same_draw(self):
        from repro_torch.serve.sampler import sample
        rng = np.random.RandomState(1)
        logits = torch.from_numpy(rng.randn(8, 64).astype(np.float32))
        top4 = torch.topk(logits, 4).indices
        temps = np.full(8, 0.8, np.float32)
        topks = np.full(8, 4, np.int32)
        draws = []
        for trial in range(3):
            keys = rng.randint(0, 2 ** 31, (8, 2)).astype(np.uint32)
            out = sample(logits, keys, temps, topks)
            assert all(out[b] in top4[b] for b in range(8))
            assert torch.equal(out, sample(logits, keys, temps, topks))
            draws.append(out)
        assert not all(torch.equal(draws[0], d) for d in draws[1:])
