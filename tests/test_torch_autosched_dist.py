"""The measured autoscheduler across ranks: ``autosched="measured"`` on four
gloo ranks of the merged ``(data=2, model=2)`` mesh (EP over data, ESP ==
MP over model), and the train launcher's multi-rank run under it.

Cases, one spawn (each rank returns what the parent compares):

  (a) ``apply_moe`` under ``schedule="auto"`` calibrates the default
      measured grid on the live mesh: every rank holds the same times
      (the slowest rank's median of each candidate) and the same pick,
      the cache key names the mesh, and the layer's output is
      ``torch.equal`` to the same schedule forced;
  (b) a fixed timer (candidate k takes 1 + k/10 s) whose rank 1 reports
      the first candidate 10x slower: every rank scores it 10 s and picks
      the second; without the slow rank every rank picks the first;
  (c) a candidate that fails to resolve on rank 2 only scores ``inf`` on
      every rank, and no rank waits for it;
  (d) a cache hit on three ranks and a miss on the fourth (its cache
      cleared) raises on every rank.

JAX's ``measure_candidates`` times the candidates on the live mesh too,
each time that of the slowest device; the times here are gloo's host
path, so the test holds the ranks' agreement and the pick's output, not
which pick is right (ROADMAP item 5.4).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.multirank

ROOT = os.path.join(os.path.dirname(__file__), "..")
M, F, E, K = 32, 64, 8, 2
TOKENS = (8, 8)                   # the global pool: 32 tokens a data rank
GRID = (("s1", 1), ("s2", 1), ("s1g", 1), ("baseline", 1))


def _cfg(**kw):
    from repro_torch.core.moe import MoEConfig
    return MoEConfig(d_model=M, d_ff=F, n_experts=E, top_k=K,
                     capacity_factor=2.0, **kw)


def _rank(rank):
    """(a)-(d) on one rank of the (2, 2) mesh."""
    import torch
    from repro_torch.core import autosched, moe
    from repro_torch.core.moe import apply_moe, init_moe_params
    from repro_torch.core.perfmodel import MoELayerShape
    from repro_torch.obs import trace
    from repro_torch.parallel.mesh import ParallelDims, make_mesh
    from repro_torch.parallel.sharding import P, local_shard, local_tree
    mesh = make_mesh((2, 2), ("data", "model"))
    dims = ParallelDims(ep=("data",), esp=("model",), mp=("model",))
    out = {}

    # (a) the default measured grid, through apply_moe
    cfg = _cfg(schedule="auto", autosched="measured")
    g = torch.Generator().manual_seed(3)
    full = init_moe_params(g, cfg)
    x = torch.randn((*TOKENS, M), generator=g)
    params = local_tree(full, moe.moe_param_specs(cfg, mesh, dims), mesh)
    xb = local_shard(x, P(dims.batch_axes, None, None), mesh)
    with torch.no_grad():
        y, _ = apply_moe(xb, params, cfg=cfg, mesh=mesh, dims=dims)
        (key, d), = [(k, v) for k, v in autosched.cache_info().items()
                     if k[1] == "measured"]
        forced = _cfg(schedule=d.schedule, pipeline_chunks=d.n_chunks)
        yf, _ = apply_moe(xb, params, cfg=forced, mesh=mesh, dims=dims)
    out["a"] = {"times": d.times, "pick": (d.schedule, d.n_chunks,
                                           d.wire_dtype),
                "device": key[-1], "equal": torch.equal(y, yf)}

    # (b)-(d): decide over GRID on the layer's shape
    shape = MoELayerShape(B=1, L=TOKENS[0] * TOKENS[1] // 2, M=M, H=F, E=E,
                          k=K, f=2.0, n_mp=2, n_esp=2, n_ep=2)

    def decide():
        measure = autosched.measure_candidates(
            _cfg(), tokens=TOKENS[0] * TOKENS[1], d_model=M, device="cpu",
            mesh=mesh, dims=dims, iters=1)
        d = autosched.decide(shape, mode="measured", chunk_candidates=(1,),
                             schedules=tuple(s for s, _ in GRID),
                             measure=measure)
        return {"times": d.times, "pick": d.schedule}

    real = trace._median_time
    for label, slow in (("b", True), ("b-even", False)):
        autosched.clear_cache()
        order = []

        def fixed(fn, iters, warmup, device, slow=slow, order=order):
            fn()                       # every rank runs the candidate
            t = 1.0 + 0.1 * len(order)
            if slow and rank == 1 and not order:
                t *= 10.0
            order.append(t)
            return t

        trace._median_time = fixed
        try:
            out[label] = decide()
        finally:
            trace._median_time = real

    autosched.clear_cache()
    resolve = moe._mesh_call

    def flaky(x, params, cfg, *a, **kw):
        if rank == 2 and cfg.schedule == "s1g":
            raise RuntimeError("s1g does not resolve on rank 2")
        return resolve(x, params, cfg, *a, **kw)

    moe._mesh_call = flaky
    try:
        out["c"] = decide()
    finally:
        moe._mesh_call = resolve

    if rank == 3:
        autosched.clear_cache()
    try:
        decide()
        out["d"] = "no error"
    except RuntimeError as e:
        out["d"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    from repro_torch.launch.mesh import spawn
    return spawn(_rank, 4, backend="gloo", device="cpu", threads=1,
                 timeout=240)


def test_measured_pick_is_one_across_ranks(ranks):
    a = [r["a"] for r in ranks]
    assert all(r["times"] == a[0]["times"] for r in a), \
        [r["times"][:3] for r in a]
    assert all(r["pick"] == a[0]["pick"] for r in a)
    assert len(a[0]["times"]) > len(GRID)
    assert all(t > 0 and np.isfinite(t) for _, t in a[0]["times"])
    assert a[0]["device"] == "cpu|data=2,model=2"
    assert all(r["equal"] for r in a)


def test_the_slowest_rank_sets_each_time(ranks):
    for r in ranks:
        assert r["b-even"]["pick"] == "s1", r["b-even"]
        assert r["b"]["pick"] == "s2", r["b"]
        assert dict(r["b"]["times"])[("s1", 1)] == pytest.approx(10.0)
        assert r["b"]["times"] == ranks[0]["b"]["times"]


def test_a_candidate_failing_on_one_rank_scores_inf_everywhere(ranks):
    for r in ranks:
        times = dict(r["c"]["times"])
        assert times[("s1g", 1)] == float("inf"), times
        assert all(np.isfinite(t) for c, t in times.items()
                   if c != ("s1g", 1))
        assert r["c"]["pick"] == ranks[0]["c"]["pick"] != "s1g"


def test_a_cache_hit_and_a_miss_raise_on_every_rank(ranks):
    for r in ranks:
        assert "ranks disagree on the measured autoscheduler" in r["d"], \
            r["d"]


def test_train_launcher_measured_across_ranks():
    """``launch/train.py --nproc 2 --autosched measured`` trains 2 steps:
    rank 0 alone prints, one measured decision per layer shape."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gpt2-moe", "--reduced", "--device", "cpu", "--nproc", "2",
         "--dist-backend", "gloo", "--steps", "2", "--seq", "32",
         "--autosched", "measured"],
        env=env, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ranks: 2 on mesh {'data': 2, 'model': 1} over gloo" in r.stdout
    assert "autosched[measured]" in r.stdout, r.stdout
    assert "data=2,model=1" in r.stderr
    assert r.stdout.count("final loss") == 1, r.stdout
