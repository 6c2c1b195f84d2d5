"""Serving across ranks: the port's ``Engine(model, mesh, dims)`` on four
gloo ranks of the merged ``(data=2, model=2)`` mesh (EP over data, ESP ==
MP over model; attention heads, the FFN and the vocabulary sharded over
model) against the JAX ``Engine`` on a 4-device (2, 2) host mesh and the
port's one-rank engine, from the same JAX parameters
(``params_from_jax``: each rank's shards).

Reduced qwen3-moe-30b-a3b: 4 query and 4 kv heads, 4 experts of d_ff 48,
vocabulary 512, all of which split over (2, 2).  Four requests whose
prompts of 5-8 tokens fall in one prefill bucket (8), ``GEN`` tokens each.

  (a) ``max_batch`` 4: a decode pool of 4 rows is 2 a data rank, as many
      as MP ranks, so decode runs the real decode path (``auto``'s
      decode pick, ``s1d``); prefill pools of 8 tokens run ``auto``'s
      prefill pick.  Greedy streams equal JAX's and the one-rank port
      engine's on every rank; the stats hold as in JAX's
      ``tests/helpers/run_serve_multidev.py`` (a prefill call per
      request, more than one row decoding at once, every page back, a
      ``decode`` decision); the plan agreed once every tick;
  (b) ``max_batch`` 2: a decode pool of one row a data rank, fewer than
      its MP ranks, falls back to ``dense_decode``: the same streams;
  (c) the MoE layer under forced ``s1d`` matches forced ``s2`` within
      1e-5 on the mesh (that helper's check), on the engine's replicated
      pool;
  (d) rank 1's ``time.perf_counter`` 100 s ahead, and 1000x fast, under
      a deadline of 60 s, one of 1e-6 s, a queue SLO of 60 s and an arena
      of 3 pages (so requests wait for blocks, and the fourth can never
      fit): every rank gives ok, expired, ok, shed (blocks) and the same
      tokens;
  (e) rank 2 admitting two requests a prefill where the others admit one:
      every rank raises, none waits;

then the launcher's multi-rank run.  Token streams must be equal: greedy
top-2 logit gaps at this size are ~1e-3 and more (``test_torch_serve.py``),
far above the ranks' last-bit differences.

One JAX subprocess and one 4-rank spawn serve the module, side by side
(the ranks start once JAX has written the parameters).
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

ROOT = os.path.join(os.path.dirname(__file__), "..")
GEN = 4
CASES = (("main", dict(max_batch=4, max_len=32, block_size=8)),
         ("fallback", dict(max_batch=2, max_len=32, block_size=8)))


#: (d)'s clocks of rank 1: 100 s ahead; and 1000x fast (a rank deciding
#: on its own clock would see 60 s pass within the run)
SKEWS = {"skew": lambda t: t + 100.0, "fast": lambda t: 1000.0 * t}


def _prompts(vocab=512):
    rng = np.random.RandomState(0)
    return [[int(t) for t in rng.randint(0, vocab, n)] for n in (5, 8, 6, 7)]


JAX_SCRIPT = r'''
import os, pickle, sys
import jax
import numpy as np
from repro.configs import get_config
from repro.core import autosched
from repro.models import build_model
from repro.parallel.mesh import ParallelDims, make_mesh
from repro.serve import Engine

tmp = sys.argv[1]
prompts, gen, cases = eval(sys.argv[2])


def dump(obj, name):
    with open(os.path.join(tmp, name + ".tmp"), "wb") as f:
        pickle.dump(obj, f)
    os.replace(os.path.join(tmp, name + ".tmp"), os.path.join(tmp, name))


model = build_model(get_config("qwen3-moe-30b-a3b").reduced())
params = model.init(jax.random.PRNGKey(0))
dump(jax.tree.map(lambda a: np.array(a, copy=True), params), "init.pkl")
mesh = make_mesh((2, 2), ("data", "model"))
dims = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
out = {}
for name, kw in cases:
    eng = Engine(model, mesh, dims, **kw)
    for p in prompts:
        eng.submit(p, gen)
    out[name] = [c.tokens for c in eng.run(params)]
dump(out, "jax.pkl")
'''


def _wait_for(path, deadline):
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


def _serve(eng, params, prompts, **kw):
    for p in prompts:
        eng.submit(p, GEN, **kw)
    return eng.run(params)


def _rank(rank, tmp):
    """(a)-(e) on one rank of the (2, 2) mesh."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core import autosched
    from repro_torch.core.moe import (MoEConfig, apply_moe, init_moe_params,
                                      moe_param_specs)
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.parallel import comm
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import local_tree
    from repro_torch.serve import Engine
    _wait_for(os.path.join(tmp, "init.pkl"), time.monotonic() + 240)
    with open(os.path.join(tmp, "init.pkl"), "rb") as f:
        ref = pickle.load(f)
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    model = Model(cfg, device="cpu")
    mesh = make_mesh((2, 2), ("data", "model"))
    dims = dims_for(cfg)
    params = params_from_jax(ref, cfg, device="cpu", mesh=mesh, dims=dims)
    prompts = _prompts(cfg.vocab_size)
    agreed = []
    agree = comm.agree

    def counting(values, grp, what, device="cpu"):
        if what.startswith("the serving plan"):
            agreed.append(values[0])
        return agree(values, grp, what, device)

    comm.agree = counting
    out = {}
    for name, kw in CASES:
        autosched.clear_cache()
        agreed.clear()
        eng = Engine(model, mesh, dims, **kw)
        done = _serve(eng, params, prompts)
        out[name] = {"tokens": [c.tokens for c in done],
                     "stats": dict(eng.stats), "live": eng.pool.n_live,
                     "summary": autosched.cache_summary(),
                     "agreed": list(agreed), "ticks": eng._tick}

    # (c) s1d against s2 on the mesh, the engine's replicated pool
    mcfg = MoEConfig(d_model=32, d_ff=64, n_experts=8, top_k=2,
                     capacity_factor=2.0, schedule="s2")
    g = torch.Generator().manual_seed(0)
    mp = local_tree(init_moe_params(g, mcfg),
                    moe_param_specs(mcfg, mesh, dims), mesh)
    x = torch.randn((8, 4, 32), generator=g)
    with torch.no_grad():
        y2, _ = apply_moe(x, mp, cfg=mcfg, mesh=mesh, dims=dims,
                          replicated=True)
        yd, _ = apply_moe(x, mp, cfg=mcfg, mesh=mesh, dims=dims,
                          schedule="s1d", replicated=True)
    out["s1d_vs_s2"] = float((y2 - yd).abs().max())

    # (d) skewed clocks under a deadline and a queue SLO
    real = time.perf_counter
    for name, clock in SKEWS.items():
        if rank == 1:
            time.perf_counter = lambda clock=clock: clock(real())
        try:
            eng = Engine(model, mesh, dims, max_batch=4, max_len=32,
                         block_size=8, n_blocks=3, prefix_cache=False,
                         queue_slo=60.0)
            for p, deadline in zip(prompts[:3], (60.0, 1e-6, 60.0)):
                eng.submit(p, GEN, deadline=deadline)
            eng.submit(list(range(28)), GEN, deadline=60.0)
            done = eng.run(params)
        finally:
            time.perf_counter = real
        out[name] = [(c.status, c.reason.split(":")[0], c.tokens)
                     for c in done]

    # (e) one rank admits otherwise
    eng = Engine(model, mesh, dims, max_batch=4, max_len=32, block_size=8)
    if rank == 2:
        eng.prefill_batch = 2
    try:
        _serve(eng, params, prompts)
        out["diverge"] = "no error"
    except RuntimeError as e:
        out["diverge"] = str(e)
    comm.agree = agree
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    tmp = str(tmp_path_factory.mktemp("serve_dist"))
    with open(os.path.join(tmp, "jax.err"), "w") as err:
        jax_run = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, tmp,
             repr((_prompts(), GEN, CASES))],
            env=subprocess_env(4), stdout=subprocess.DEVNULL, stderr=err)
        try:
            _wait_for(os.path.join(tmp, "init.pkl"), time.monotonic() + 240)
            ranks = spawn(_rank, 4, tmp, backend="gloo", device="cpu",
                          threads=1, timeout=240)
            jax_run.wait(timeout=240)
        finally:
            if jax_run.poll() is None:
                jax_run.kill()
    assert jax_run.returncode == 0, open(os.path.join(tmp, "jax.err")).read(
        )[-3000:]
    with open(os.path.join(tmp, "jax.pkl"), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(tmp, "init.pkl"), "rb") as f:
        init = pickle.load(f)
    return ranks, want, init


def _one_rank(init, kw):
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import Model
    from repro_torch.serve import Engine
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    eng = Engine(Model(cfg, device="cpu"), **kw)
    done = _serve(eng, params_from_jax(init, cfg, device="cpu"), _prompts())
    return [c.tokens for c in done]


@pytest.mark.parametrize("case", [c for c, _ in CASES])
def test_streams_match_jax_and_one_rank(runs, case):
    ranks, want, init = runs
    kw = dict(CASES)[case]
    one = _one_rank(init, kw)
    for rk, r in enumerate(ranks):
        got = r[case]["tokens"]
        assert all(len(t) == GEN for t in got)
        assert got == want[case], (rk, got, want[case])
        assert got == one, (rk, got, one)


@pytest.mark.parametrize("case", [c for c, _ in CASES])
def test_engine_stats_and_one_plan_a_tick(runs, case):
    ranks, _, _ = runs
    for r in ranks:
        got = r[case]
        assert got["stats"]["prefill_calls"] == len(_prompts())
        assert got["stats"]["max_active"] > 1
        assert got["live"] == 0
        assert got["stats"] == ranks[0][case]["stats"]
        assert got["agreed"] == list(range(1, got["ticks"] + 1))
        if case == "main":
            assert "decode" in got["summary"], got["summary"]
            assert "s1d" in got["summary"], got["summary"]
        else:      # every decode pool fell back: no decode decision
            assert "decode" not in got["summary"], got["summary"]


def test_s1d_matches_s2_on_the_mesh(runs):
    for r in runs[0]:
        assert r["s1d_vs_s2"] < 1e-5, r["s1d_vs_s2"]


@pytest.mark.parametrize("clock", list(SKEWS))
def test_skewed_clocks_give_every_rank_the_same_statuses(runs, clock):
    ranks = runs[0]
    statuses = [[s[:2] for s in r[clock]] for r in ranks]
    assert statuses[0] == [("ok", ""), ("expired", "deadline 0.000s "
                                        "exceeded"),
                           ("ok", ""), ("shed", "blocks")], statuses[0]
    assert all(s == statuses[0] for s in statuses)
    assert all(r[clock] == ranks[0][clock] for r in ranks)


def test_a_rank_that_admits_otherwise_makes_every_rank_raise(runs):
    for r in runs[0]:
        assert "ranks disagree on the serving plan of tick 1" in \
            r["diverge"], r["diverge"]


def test_the_launcher_serves_on_four_ranks(tmp_path):
    """``launch/serve.py --nproc 4`` on the (2, 2) mesh: rank 0 alone
    prints and writes the record; ``--max-batch 0`` sizes from the mesh."""
    import json
    log = str(tmp_path / "log.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-moe-30b-a3b", "--reduced", "--device", "cpu", "--nproc",
         "4", "--mesh", "data=2,model=2", "--dist-backend", "gloo",
         "--smoke", "--max-batch", "0", "--log-json", log],
        env=env, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "ranks: 4 on mesh {'data': 2, 'model': 2} over gloo" in out
    assert out.count("SERVE SMOKE OK") == 1, out
    assert "auto max-batch (t_decode, block budget):" in out
    assert "autosched[analytic decode]" in out and "ep/esp/mp=2/2/2" in out
    with open(log) as f:
        rec = json.load(f)
    assert set(rec["statuses"].values()) == {"ok"}
