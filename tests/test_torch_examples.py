"""The port's examples (``repro_torch.examples``) against the JAX package's
``examples/*.py`` on the CPU.

* ``quickstart``: Algorithm 1's pick equals JAX's ``select_schedule`` under
  the same cost-model parameters (JAX's ``tpu_v5e_model`` copied field by
  field, and the port's ``h100_model`` copied into JAX's ``PerfModel``) on
  the (1, 1) and (4, 2) meshes; ``main`` on the CPU prints the pick and
  finite losses.
* ``train_100m``: ``config_100m()`` equals JAX's field by field, and its
  parameter count is JAX's (``jax.eval_shape`` of JAX's ``init``).
* ``serve_batched``: given JAX's weights (``convert.params_from_jax``),
  the greedy tokens of each of the four reduced archs equal JAX's
  ``make_serve_step`` tokens for 8 steps.  A step whose top-2 logit margin
  in JAX's ``decode_step`` is under ``TIE`` may pick the other token (a
  tie within float noise): the test names such a step and compares no
  further steps of that arch.
* bert-moe's attention is causal in both packages, as JAX's
  ``attn_config`` keys the mask (``arch_type != "encoder"``; bert-moe's
  arch type is ``"moe"``): changing the last token changes no earlier
  position's logits, while changing the first changes later ones.  At the
  drop-free capacity factor, so that no row's routing depends on another
  row's.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import perfmodel as jperf  # noqa: E402
from repro.core.moe import select_schedule as j_select  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro.train import make_serve_step as j_make_serve_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import autosched as t_autosched  # noqa: E402
from repro_torch.core import perfmodel as tperf  # noqa: E402
from repro_torch.examples import quickstart, serve_batched, train_100m  # noqa
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from test_torch_perfmodel import to_port  # noqa: E402

#: a JAX top-2 logit margin under this may flip between the packages
TIE = 1e-4
GEN = 8


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
    from repro.core import autosched
    autosched.clear_cache()
    t_autosched.clear_cache()
    yield
    autosched.clear_cache()
    t_autosched.clear_cache()


def _to_jax(m):
    """The port's ``PerfModel`` ``m`` copied into JAX's, field by field."""
    def conv(v):
        if isinstance(v, tperf.AlphaBeta):
            return jperf.AlphaBeta(alpha=v.alpha, beta=v.beta)
        return v
    return jperf.PerfModel(**{f.name: conv(getattr(m, f.name))
                              for f in dataclasses.fields(m)})


@pytest.mark.parametrize("mesh", [(1, 1), (4, 2)], ids=["1x1", "4x2"])
@pytest.mark.parametrize("model", ["tpu_v5e", "h100"])
def test_quickstart_pick_is_jaxs(mesh, model):
    d, m = mesh
    sizes = {"ep": d, "esp": m, "mp": m}
    jcfg = j_get_config("qwen3-moe-30b-a3b").reduced()
    tcfg = get_config("qwen3-moe-30b-a3b").reduced()
    if model == "tpu_v5e":
        jm = jperf.tpu_v5e_model(d, m, m)
        tm = to_port(jm)
    else:
        tm = tperf.h100_model(d, m, m)
        jm = _to_jax(tm)
    shape = jperf.MoELayerShape(
        B=quickstart.BATCH, L=quickstart.SEQ, M=jcfg.d_model,
        H=jcfg.moe.d_ff, E=jcfg.moe.n_experts, k=jcfg.moe.top_k,
        f=jcfg.moe.capacity_factor, n_mp=m, n_esp=m, n_ep=d)
    want = j_select(jcfg.moe, shape, perf_model=jm)
    assert quickstart.pick(tcfg, sizes, perf_model=tm) == want
    if model == "h100":        # the pick the example prints
        assert quickstart.pick(tcfg, sizes) == want


def test_quickstart_main_on_the_cpu(capsys):
    hist = quickstart.main(["--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert "mesh {'data': 1, 'model': 1} -> Algorithm 1 picks: s1g" in out
    assert "h100_model" in out and "done: loss" in out
    losses = [h["loss"] for h in hist]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)


def _jax_100m():
    from repro.core.moe import MoEConfig as JMoEConfig
    base = j_get_config("gpt2-moe")
    moe = JMoEConfig(d_model=512, d_ff=2048, n_experts=8, top_k=2,
                     capacity_factor=1.5, glu=False, schedule="auto")
    return dataclasses.replace(
        base, name="gpt2-moe-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=8, d_ff=2048, vocab_size=50257, moe=moe, remat=False)


def test_train_100m_config_and_parameter_count_are_jaxs():
    jcfg, tcfg = _jax_100m(), train_100m.config_100m()
    want, got = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == v, k
    shapes = jax.eval_shape(build_model(jcfg).init, jax.random.PRNGKey(0))
    want = sum(math.prod(s.shape) for s in jax.tree.leaves(shapes))
    params = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = sum(t.numel() for t in leaves(params))
    del params
    assert got == want and 90e6 < got < 120e6, (got, want)


def _jax_tokens(name, jparams):
    """JAX's example on ``name``: ``GEN`` greedy steps of 4 rows from a
    zero token, and a function giving the JAX logits at step ``t``."""
    cfg = j_get_config(name).reduced()
    mesh = make_mesh((1, 1), ("data", "model"))
    dims = (ParallelDims(ep=("data",), esp=("model",), mp=("model",))
            if cfg.moe is not None
            else ParallelDims(dp=("data",), mp=("model",)))
    model = build_model(cfg)
    step = jax.jit(j_make_serve_step(model, mesh, dims))
    cache = model.init_cache(4, GEN + 1)
    tok, toks, fed = jnp.zeros((4, 1), jnp.int32), [], []
    for t in range(GEN):
        fed.append(tok)
        tok, cache = step(jparams, cache, {"tokens": tok,
                                           "step": jnp.int32(t)})
        toks.append(np.asarray(tok)[:, 0].tolist())

    def logits_at(t):
        c = model.init_cache(4, GEN + 1)
        for s in range(t + 1):
            lg, c = model.decode_step(jparams, c, {"tokens": fed[s],
                                                   "step": jnp.int32(s)},
                                      mesh=mesh, dims=dims)
        return np.asarray(lg)[:, -1]
    return toks, logits_at


@pytest.mark.parametrize("name", serve_batched.ARCHS)
def test_serve_batched_tokens_are_jaxs(name, capsys):
    jmodel = build_model(j_get_config(name).reduced())
    jparams = jax.tree.map(np.asarray,
                           jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    want, logits_at = _jax_tokens(name, jparams)
    tparams = params_from_jax(jparams, get_config(name).reduced(),
                              device="cpu")
    got = serve_batched.serve(name, torch.device("cpu"), gen=GEN,
                              params=tparams)
    assert f"{name}" in capsys.readouterr().out
    for t in range(GEN):
        if got[t] == want[t]:
            continue
        top2 = np.sort(logits_at(t), axis=-1)[:, -2:]
        margin = float((top2[:, 1] - top2[:, 0]).min())
        assert margin < TIE, (t, got[t], want[t], margin)
        print(f"{name}: step {t} differs within a top-2 tie (JAX's margin "
              f"{margin:.2e} < {TIE:g}); later steps not compared")
        break


def _drop_free(cfg):
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def test_bert_moe_attention_is_causal_in_both_packages():
    jcfg = _drop_free(j_get_config("bert-moe").reduced())
    tcfg = _drop_free(get_config("bert-moe").reduced())
    assert jcfg.arch_type == tcfg.arch_type == "moe"
    jmodel = build_model(jcfg)
    jparams = jax.tree.map(np.asarray,
                           jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    tmodel = Model(tcfg, device="cpu")
    tparams = params_from_jax(jparams, tcfg, device="cpu")
    mesh = make_mesh((1, 1), ("data", "model"))
    dims = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
    rng = np.random.RandomState(3)
    toks = rng.randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    last, first = toks.copy(), toks.copy()
    last[:, -1] = (last[:, -1] + 1) % jcfg.vocab_size
    first[:, 0] = (first[:, 0] + 1) % jcfg.vocab_size
    jfwd = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t}, mesh=mesh,
                                               dims=dims)[0])

    def tfwd(t):
        with torch.no_grad():
            return tmodel.forward(tparams, {"tokens": torch.from_numpy(
                t).long()})[0].numpy()
    for fwd in (lambda t: np.asarray(jfwd(jparams, t)), tfwd):
        base, lg_last, lg_first = fwd(toks), fwd(last), fwd(first)
        np.testing.assert_array_equal(lg_last[:, :-1], base[:, :-1])
        assert np.abs(lg_last[:, -1] - base[:, -1]).max() > 1e-3
        assert np.abs(lg_first[:, 1:] - base[:, 1:]).max() > 1e-3
