"""The port's one-rank MoE layer (``repro_torch.core.moe.apply_moe``)
against the JAX ``apply_moe`` on a 1-device mesh under ``s1g``, on the same
numpy inputs; and the autoscheduler decisions that license the port's
``"auto"`` -> ``s1g`` mapping.

Tolerances: y within 1e-5 (f32; the same FFN and combine sums taken in a
different order) and 2e-2 with the bf16 wire (one bf16 rounding may land
on the other neighbour); the routed-row counts exactly; aux and z losses
within 1e-6 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import autosched  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core.collectives import CommConfig  # noqa: E402
from repro.core.perfmodel import MoELayerShape  # noqa: E402
from repro.core.pipeline import clamp_chunks  # noqa: E402
from repro.parallel.mesh import ParallelDims, make_mesh  # noqa: E402
from repro_torch.core import autosched as t_autosched  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.core.collectives import CommConfig as TCommConfig  # noqa
from repro_torch.core.perfmodel import MoELayerShape as TShape  # noqa

MESH_DIMS = ParallelDims(ep=("data",), esp=("model",), mp=("model",))


@pytest.fixture(autouse=True)
def fresh_sched_cache():
    autosched.clear_cache()
    t_autosched.clear_cache()
    yield
    autosched.clear_cache()
    t_autosched.clear_cache()


def _cfgs(*, M=32, F=48, E=8, k=2, cf=1.25, glu=True, act="silu",
          wire="f32", normalize=True):
    kw = dict(d_model=M, d_ff=F, n_experts=E, top_k=k, capacity_factor=cf,
              glu=glu, act=act, normalize_topk=normalize, schedule="s1g")
    return (jmoe.MoEConfig(comm=CommConfig(wire_dtype=wire), **kw),
            tmoe.MoEConfig(comm=TCommConfig(wire_dtype=wire), **kw))


def _params(cfg, seed):
    rng = np.random.RandomState(seed)
    M, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"wg": rng.randn(M, E) / np.sqrt(M),
         "w1": rng.randn(E, M, F) / np.sqrt(M),
         "w2": rng.randn(E, F, M) / np.sqrt(F)}
    if cfg.glu:
        p["w3"] = rng.randn(E, M, F) / np.sqrt(M)
    return {key: v.astype(np.float32) for key, v in p.items()}


def _run_both(jcfg, tcfg, B, L, infer, seed=0):
    p = _params(tcfg, seed)
    x = np.random.RandomState(seed + 1).randn(B, L, tcfg.d_model).astype(
        np.float32)
    mesh = make_mesh((1, 1), ("data", "model"))
    jy, jaux = jax.jit(lambda x, p: jmoe.apply_moe(
        x, p, mesh=mesh, dims=MESH_DIMS, cfg=jcfg, infer=infer))(
            jnp.asarray(x), {key: jnp.asarray(v) for key, v in p.items()})
    ty, taux = tmoe.apply_moe(
        torch.from_numpy(x), {key: torch.from_numpy(v) for key, v in p.items()},
        cfg=tcfg, infer=infer)
    return np.asarray(jy), jaux, ty.numpy(), taux


@pytest.mark.parametrize("infer", [False, True])
@pytest.mark.parametrize("variant", ["silu-glu", "gelu-2layer", "wire-bf16",
                                     "drops"])
def test_apply_moe_matches_jax_s1g(infer, variant):
    kw = {"silu-glu": {}, "gelu-2layer": dict(glu=False, act="gelu"),
          "wire-bf16": dict(wire="bf16"),
          "drops": dict(cf=0.5, E=4)}[variant]
    jcfg, tcfg = _cfgs(**kw)
    jy, jaux, ty, taux = _run_both(jcfg, tcfg, B=3, L=16, infer=infer)
    tol = 2e-2 if variant == "wire-bf16" else 1e-5
    np.testing.assert_allclose(ty, jy, rtol=tol, atol=tol)
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))
    for key in ("aux_loss", "z_loss", "drop_frac"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-6, atol=1e-6)
    if variant == "drops":
        # a prefill pool drops; a decode pool (infer) never does
        assert (float(taux["drop_frac"]) > 0) == (not infer)


def test_other_schedules_wait_for_a_later_slice():
    """Every schedule runs on one rank now, and so do the cost model's
    wire pick and the measured calibration (each deciding once); a
    collective over a group of more than one rank with no mesh bound
    raises (``apply_moe(..., mesh=, dims=)`` binds one), and a plan that
    carries an expert placement runs now (ROADMAP item 6) where it raised
    before: the identity placement through the whole placed path gives
    the unplaced plan's output and aux bitwise."""
    from repro_torch.core import collectives, executor, plan, schedules
    _, tcfg = _cfgs()
    x = torch.zeros((1, 4, tcfg.d_model))
    p = {key: torch.from_numpy(v) for key, v in _params(tcfg, 0).items()}
    for sched in ("s1", "s2", "baseline", "s1d"):
        y, _ = tmoe.apply_moe(x, p, cfg=tcfg, schedule=sched)
        assert y.shape == x.shape
    for kw in (dict(comm=TCommConfig(wire_dtype="auto")),
               dict(autosched="measured", schedule="auto")):
        t_autosched.clear_cache()
        y, _ = tmoe.apply_moe(x, p, cfg=dataclasses.replace(tcfg, **kw))
        assert y.shape == x.shape
        (key, d), = t_autosched.cache_info().items()
        assert key[1] == ("measured" if "autosched" in kw else "analytic")
    with pytest.raises(RuntimeError, match="multi-rank"):
        collectives.ep_esp_all_to_all(x, ("ep",), ("esp",), 2)
    info = schedules.MoEShardInfo(
        ep_axes=("ep",), esp_axes=("esp",), mp_axes=("mp",), n_ep=1,
        n_esp=1, n_mp=1, tokens=4, cap=8, gate=tcfg.gate_config())
    from repro_torch.core.placement import identity_placement
    x = torch.from_numpy(np.random.RandomState(3).randn(
        4, tcfg.d_model).astype(np.float32))
    unplaced = plan.build_plan("s1", info)
    placed = plan.apply_placement(unplaced, identity_placement(
        tcfg.n_experts, 1), info=info)
    got, want = (executor.execute(pl, x, p["wg"], p["w1"], p["w3"],
                                  p["w2"], info) for pl in (placed, unplaced))
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])


def test_shard_pool_capacity_matches_jax():
    for E, k, cf in ((128, 8, 1.25), (4, 4, 1.25), (8, 2, 0.5)):
        jg = jmoe.MoEConfig(d_model=8, d_ff=8, n_experts=E, top_k=k,
                            capacity_factor=cf).gate_config()
        tg = dataclasses.replace(_cfgs()[1], n_experts=E, top_k=k,
                                 capacity_factor=cf).gate_config()
        for tokens in (1, 8, 33, 64, 128, 512):
            for infer in (False, True):
                assert tmoe.shard_pool_capacity(tokens, 1, 1, tg, infer) == \
                    jmoe.shard_pool_capacity(tokens, 1, 1, jg, infer)


# (B, L, infer, M, H, E, k): the slice's full-width decode (8 rows) and
# one-request prefill buckets, and the reduced config's shapes
SHAPES = [(8, 1, True, 2048, 768, 128, 8), (1, 64, False, 2048, 768, 128, 8),
          (1, 128, False, 2048, 768, 128, 8),
          (1, 512, False, 2048, 768, 128, 8), (4, 1, True, 256, 48, 4, 4),
          (1, 8, False, 256, 48, 4, 4), (1, 64, False, 256, 48, 4, 4)]


@pytest.mark.parametrize("B,L,infer,M,H,E,k", SHAPES)
def test_autosched_picks_s1g_at_one_rank(B, L, infer, M, H, E, k):
    """``apply_moe`` asks ``autosched.decide`` exactly so at one rank
    (n_ep = n_esp = n_mp = 1); the answer must stay ``s1g``, whose local
    form is the port's gate -> expert_ffn_grouped.  The port's own
    ``decide`` (the card's model) and ``resolve_schedule`` give it too."""
    gate = jmoe.MoEConfig(d_model=M, d_ff=H, n_experts=E, top_k=k,
                          capacity_factor=1.25).gate_config()
    s_local, cap = jmoe.shard_pool_capacity(B * L, 1, 1, gate, infer=infer)
    shape = MoELayerShape(B=max(s_local // max(L, 1), 1), L=min(L, s_local),
                          M=M, H=H, E=E, k=k, f=1.25, n_mp=1, n_esp=1,
                          n_ep=1, infer=infer)
    cands = ((1,) if infer else tuple(sorted(
        {clamp_chunks(cap, n) for n in autosched.DEFAULT_CHUNKS})))
    d = autosched.decide(shape, chunk_candidates=cands)
    assert d.schedule == "s1g", d
    assert d.wire_dtype == "f32"
    td = t_autosched.decide(TShape(**dataclasses.asdict(shape)),
                            chunk_candidates=cands)
    assert (td.schedule, td.n_chunks, td.wire_dtype) == \
        (d.schedule, d.n_chunks, d.wire_dtype) == ("s1g", 1, "f32"), td
    tcfg = tmoe.MoEConfig(d_model=M, d_ff=H, n_experts=E, top_k=k,
                          capacity_factor=1.25)
    assert tmoe.resolve_schedule(tcfg, B=B, L=L, infer=infer) == \
        ("s1g", 1, "f32")
