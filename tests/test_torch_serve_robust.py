"""The port's serving robustness on the CPU against the JAX engine, on
reduced qwen3-moe-30b-a3b with the JAX package's parameters
(``repro_torch.convert.params_from_jax``): the chaos plan of
``tests/test_serve.py::TestServeRobustness`` (a request force-expired
after 3 ticks, one stalled into the watchdog, the arena starved for 4
ticks), the infeasible and queue-SLO sheds, the wall-clock deadline at
its extreme, starvation recovering, ``latency_stats`` and the launcher's
chaos smoke.

Token streams, statuses, reasons and ``stats`` counters must be equal to
the JAX engine's (greedy streams: the logit margins of
``tests/test_torch_serve.py`` hold here too, these are its prompts'
shapes); a request a fault does not touch must be bitwise the port's own
fault-free stream.  Wall-clock limits are asserted only at their
extremes (a 1e-6 s deadline or queue SLO expires or sheds every request
that waits; nothing here is timed).  Every run ends with the allocator's
ledger balanced and no page live.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import autosched  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro.runtime import FaultPlan as JFaultPlan  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve.engine import Completion as JCompletion  # noqa: E402
from repro.serve.engine import latency_stats as j_latency_stats  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.runtime import FaultPlan  # noqa: E402
from repro_torch.serve import Completion, Engine, latency_stats  # noqa

CHAOS = ("req_timeout@rid=1,ticks=3;req_delay@rid=2,rounds=999;"
         "alloc_starve@tick=1,hold=9999,rounds=4")
BASE = dict(max_batch=4, max_len=64, prefix_cache=False)


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

    def jax_run(requests, faults=None, **kw):
        eng = JEngine(jmodel, mesh, dims, faults=faults, **kw)
        for prompt, gen in requests:
            eng.submit(prompt, gen)
        return eng, {c.rid: c for c in eng.run(jparams)}

    yield Model(tcfg, device="cpu"), tparams, jax_run
    autosched.clear_cache()


def _requests(vocab, n, plen, gen, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, plen), gen) for _ in range(n)]


def _serve(model, params, requests, faults=None, **kw):
    eng = Engine(model, faults=faults, **kw)
    for prompt, gen in requests:
        eng.submit(prompt, gen)
    done = {c.rid: c for c in eng.run(params)}
    eng.pool.alloc_blocks.check()
    assert eng.pool.n_live == 0
    return eng, done


def _same_as_jax(done, jdone):
    assert sorted(done) == sorted(jdone)
    for rid, c in done.items():
        j = jdone[rid]
        assert (c.status, c.reason, c.tokens) == (j.status, j.reason,
                                                  j.tokens), rid


def test_chaos_plan_matches_jax_engine(setup):
    """rid 1 expired after 3 ticks, rid 2 evicted by the watchdog: the same
    statuses, reasons, counters and every stream (the partial ones too) as
    the JAX engine; rids 0 and 3 bitwise the fault-free run."""
    model, params, jax_run = setup
    reqs = _requests(model.cfg.vocab_size, 4, 6, 6, seed=11)
    kw = dict(BASE, watchdog_rounds=5)
    jeng, jdone = jax_run(reqs, JFaultPlan.parse(CHAOS), **kw)
    eng, done = _serve(model, params, reqs, FaultPlan.parse(CHAOS), **kw)
    _same_as_jax(done, jdone)
    assert eng.stats == jeng.stats
    assert done[1].status == "expired" and "tick" in done[1].reason
    assert done[2].status == "evicted" and "watchdog" in done[2].reason
    assert eng.stats["expired"] == eng.stats["evicted"] == 1
    _, clean = _serve(model, params, reqs, **kw)
    for rid in (0, 3):
        assert done[rid].status == "ok"
        assert done[rid].tokens == clean[rid].tokens
    # the cut streams are prefixes of the fault-free ones
    for rid in (1, 2):
        n = len(done[rid].tokens)
        assert 0 < n < 6 and done[rid].tokens == clean[rid].tokens[:n]


def test_deadline_at_its_extreme_expires_everything(setup):
    model, params, _ = setup
    eng = Engine(model, **BASE)
    for prompt, gen in _requests(model.cfg.vocab_size, 3, 6, 8, seed=2):
        eng.submit(prompt, gen, deadline=1e-6)
    done = eng.run(params)
    assert len(done) == 3
    assert all(c.status == "expired" and c.reason.startswith("deadline")
               for c in done)
    assert eng.stats["expired"] == 3
    eng.pool.alloc_blocks.check()
    assert eng.pool.n_live == 0


def test_infeasible_request_is_shed_within_bounded_steps(setup):
    """A request whose worst case needs more pages than the whole arena is
    shed at admission with JAX's reason, and the one queued behind it
    finishes: both within 50 ``step()`` calls (the engine used to refuse
    it forever and spin), and equal to the JAX engine's run."""
    model, params, jax_run = setup
    reqs = [(list(range(1, 7)), 40), (list(range(1, 7)), 4)]
    kw = dict(max_batch=2, max_len=64, n_blocks=2, block_size=16)
    eng = Engine(model, **kw)
    for prompt, gen in reqs:
        eng.submit(prompt, gen)
    done = {}
    for _ in range(50):
        done.update({c.rid: c for c in eng.step(params)})
        if len(done) == 2:
            break
    assert sorted(done) == [0, 1], "the infeasible request was never shed"
    assert done[0].status == "shed" and done[0].reason == (
        "blocks: worst-case prompt+budget exceeds the whole arena")
    assert done[1].status == "ok" and done[1].tokens
    assert eng.stats["shed"] == eng.stats["shed_blocks"] == 1
    eng.pool.alloc_blocks.check()
    assert eng.pool.n_live == 0
    jeng, jdone = jax_run(reqs, **kw)
    _same_as_jax(done, jdone)
    assert eng.stats == jeng.stats


def test_queue_slo_sheds_the_waiting_request(setup):
    """One row, a 1e-6 s queue SLO: the request that waits for blocks is
    shed, as in the JAX engine."""
    model, params, jax_run = setup
    reqs = _requests(model.cfg.vocab_size, 2, 6, 8, seed=4)
    kw = dict(max_batch=1, max_len=64, prefix_cache=False, queue_slo=1e-6)
    eng, done = _serve(model, params, reqs, **kw)
    jeng, jdone = jax_run(reqs, **kw)
    _same_as_jax(done, jdone)
    assert eng.stats == jeng.stats
    assert [done[r].status for r in (0, 1)] == ["ok", "shed"]
    assert done[1].reason.startswith("queue")
    assert eng.stats["shed_queue"] == 1


def test_starvation_recovers_bitwise(setup):
    """Blocks held hostage for 3 ticks delay admission and lose nothing:
    every request finishes with its fault-free stream."""
    model, params, _ = setup
    reqs = _requests(model.cfg.vocab_size, 3, 6, 6, seed=11)
    eng, done = _serve(model, params, reqs, FaultPlan.parse(
        "alloc_starve@tick=1,hold=9999,rounds=3"), **BASE)
    _, clean = _serve(model, params, reqs, **BASE)
    assert [c.status for c in done.values()] == ["ok"] * 3
    assert {r: c.tokens for r, c in done.items()} == \
        {r: c.tokens for r, c in clean.items()}
    assert eng.stats["prefill_calls"] == 3


def _completions(cls, kinds):
    out = []
    for i, kind in enumerate(kinds):
        if kind == "shed":
            out.append(cls(rid=i, prompt=(), tokens=[], text="",
                           timing={"queued": 0.1}, status="shed",
                           reason="blocks"))
        elif kind == "evicted":
            out.append(cls(rid=i, prompt=(1,), tokens=[7], text="",
                           timing={"latency": 0.3, "queued": 0.0},
                           status="evicted", reason="watchdog"))
        else:
            lat = 0.05 * (i + 1)
            out.append(cls(rid=i, prompt=(1,), tokens=[5] * (i + 1),
                           text="", timing={"latency": lat,
                                            "ttft": lat / 4,
                                            "queued": 0.0}))
    return out


@pytest.mark.parametrize("kinds", [
    (), ("ok",), ("shed",), ("ok", "shed", "evicted"),
    ("ok", "ok", "evicted", "ok", "shed", "ok", "ok")])
def test_latency_stats_is_jaxs(kinds):
    assert latency_stats(_completions(Completion, kinds)) == \
        j_latency_stats(_completions(JCompletion, kinds))


def test_engine_has_no_quantile_of_its_own():
    from repro_torch.obs import registry
    from repro_torch.serve import engine
    assert not hasattr(engine, "quantile") or \
        engine.quantile is registry.quantile


def test_launcher_chaos_smoke_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "qwen3-moe-30b-a3b", "--reduced", "--device", "cpu",
          "--smoke", "--faults", "req_timeout@rid=1,ticks=4;req_delay@"
          "rid=2,rounds=999;alloc_starve@tick=1,hold=9999,rounds=8",
          "--watchdog-rounds", "6"])
    out = capsys.readouterr().out
    assert "robustness: 0 shed (0 blocks, 0 queue SLO), 1 expired, " \
        "1 evicted" in out
    assert "SERVE CHAOS OK" in out and "SERVE SMOKE OK" in out
