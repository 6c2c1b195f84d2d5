"""The serving path of the five configs whose block kinds the port runs
(yi-9b, mistral-nemo-12b, qwen1.5-0.5b, command-r-35b,
llama4-scout-17b-a16e) against the JAX package on the CPU, with the JAX
parameters (``params_from_jax``): ``paged_step`` logits against the JAX
``Model.paged_step`` over two prefill chunks and a decode round, greedy
streams against the JAX ``Engine`` with 8-token prefill chunks and a
prefix hit, the serve launcher's ``--reduced --device cpu --smoke``, and
``suggest_max_batch`` at full size against the JAX engine's.

The configs are reduced as in ``test_torch_zoo_train.py`` (llama4 to 4
layers with its NoPE ``moe_full`` fourth and a 64-token chunk, command-r
and llama4 to 2 kv heads of 4, mistral-nemo to a head_dim of 96).  The
prefill chunks run positions 0-39 and 40-79, and llama4's streams add a
70-token prompt and a 60-token one decoding past position 64: both cross
its chunk boundary, so its paged chunk mask decides those logits.

Tolerance for logits: 1e-4 (f32, as ``test_torch_serve.py``).  Streams
must be equal.
"""

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
from repro.serve import Engine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import autosched as t_autosched  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

from test_torch_zoo_train import ARCHS, reduce  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
GEN = 6


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


@functools.cache
def _models(arch):
    """The JAX model and parameters of reduced ``arch`` and the port's
    model on them (made once a module: no test changes them)."""
    jmodel = build_model(reduce(j_get_config(arch)))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = reduce(get_config(arch))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jmodel, jparams, Model(tcfg, device="cpu"), tparams


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_step_logits_match_jax(arch):
    jmodel, jparams, tmodel, tparams = _models(arch)
    mesh = make_mesh((1, 1), ("data", "model"))
    bs, C = 8, 40
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, tmodel.cfg.vocab_size, (2, 2 * C)).astype(
        np.int32)
    lens = np.array([C, 33], np.int32)
    # row 0 takes pages 1-11, row 1 pages 12-22 (81 positions each)
    tables = np.arange(1, 23, dtype=np.int32).reshape(2, 11)
    steps = [(tokens[:, :C], np.zeros(2, np.int32), np.full(2, C, np.int32),
              False),
             (tokens[:, C:], np.full(2, C, np.int32), lens, False),
             (tokens[:, :1], C + lens, np.ones(2, np.int32), True)]
    jstep = jax.jit(lambda p, c, b, infer: jmodel.paged_step(
        p, c, b, mesh=mesh, dims=DIMS, infer=infer),
        static_argnames="infer")
    jcache = jmodel.init_cache(23, bs)
    tcache = tmodel.init_cache(23, bs)
    for toks, starts, ls, infer in steps:
        batch = {"tokens": toks, "starts": starts, "lens": ls,
                 "tables": tables}
        jlogits, jcache = jstep(jparams, jcache, {
            k: jnp.asarray(v) for k, v in batch.items()}, infer=infer)
        tlogits, tcache = tmodel.paged_step(
            tparams, tcache, {k: torch.from_numpy(v) for k, v in
                              batch.items()}, infer=infer)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)
    for r in range(len(tmodel.runs)):
        np.testing.assert_array_equal(
            tcache[f"run{r}"]["attn"]["pos"].numpy(),
            np.asarray(jcache[f"run{r}"]["attn"]["pos"]))


def _serve(engine, params, prompts):
    for p in prompts:
        engine.submit(p, GEN)
    return [c.tokens for c in engine.run(params)]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_jax_engine(arch):
    jmodel, jparams, tmodel, tparams = _models(arch)
    rng = np.random.RandomState(2)
    vocab = tmodel.cfg.vocab_size
    a = list(rng.randint(0, vocab, 20))
    prompts = [a, a[:16] + list(rng.randint(0, vocab, 5))]
    chunk = tmodel.cfg.attn_chunk
    if chunk:       # prefill and decode both cross the chunk boundary
        prompts += [list(rng.randint(0, vocab, chunk + 6)),
                    list(rng.randint(0, vocab, chunk - 4))]
        assert len(prompts[3]) < chunk < len(prompts[3]) + GEN
    kw = dict(max_batch=4, max_len=128, block_size=8, prefill_chunk=8)
    mesh = make_mesh((1, 1), ("data", "model"))
    want = _serve(JEngine(jmodel, mesh, DIMS, **kw), jparams, prompts)
    eng = Engine(tmodel, **kw)
    assert _serve(eng, tparams, prompts) == want
    assert eng.stats["prefix_hits"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_smoke(arch, capsys):
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--reduced", "--device", "cpu", "--smoke",
          "--requests", "2", "--gen", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "SERVE SMOKE OK" in out
    if get_config(arch).moe is None:
        assert "autosched[" not in out


@pytest.mark.parametrize("arch", ARCHS)
def test_suggest_max_batch_is_jaxs(arch, monkeypatch):
    """The decode batch from the cost model at full size, as
    ``test_torch_autosched.py`` holds it (JAX's perf model copied into the
    port's): a dense arch takes the largest block-feasible candidate,
    llama4 its ``t_decode`` pick."""
    from repro.core import perfmodel as jperf
    from repro.serve import suggest_max_batch as j_suggest
    from repro_torch.core import perfmodel as tperf
    from repro_torch.serve import suggest_max_batch
    from test_torch_perfmodel import to_port
    monkeypatch.setattr(tperf, "HBM_BW", jperf.HBM_BW)
    jm = jperf.tpu_v5e_model(1, 1, 1)
    for n_blocks, mean_len in ((None, None), (4, 40.0), (1024, 300)):
        kw = dict(n_blocks=n_blocks, block_size=16, mean_len=mean_len)
        assert suggest_max_batch(get_config(arch), perf_model=to_port(jm),
                                 **kw) \
            == j_suggest(j_get_config(arch), perf_model=jm, **kw), kw
