"""The port's MoE layer across ranks (``apply_moe(..., mesh=, dims=)`` on
gloo processes) against the JAX package's ``apply_moe`` on a host mesh of
CPU devices, on the same numpy inputs.

Meshes: the merged ``("data", "model")`` (2, 2) mesh of the launcher
(EP over data, ESP == MP over model; 4 ranks) and the distinct
``("ep", "esp", "mp")`` (2, 2, 2) mesh (8 ranks).  Each schedule JAX's
``tests/helpers/run_schedule_equiv.py`` runs there, plus ``s1g`` (the pool
form: counts AlltoAll and ``expert_ffn_ragged``), ``s2h`` and the
``*_pipe`` bodies with 2 chunks (their collectives in flight together:
``executor.execute``'s overlapped issue), at the config's own capacity factor
(1.25: pools drop rows, so the routing is held exactly), the bf16 and fp8
wires under ``s1`` and ``s1g``, and the ``dense_decode`` fallback (4
decode tokens on the distinct mesh: one a rank, fewer than its MP ranks).
Each rank's output is held to its block of JAX's; every input's gradient
(of ``sum(y * r) + aux_loss + z_loss``, r a seeded cotangent), after the
trainer's sum over the batch axes (``train.loop.sync_grads``), to its
block of ``jax.grad``'s.

Tolerances: y rtol 2e-4, atol 2e-5 at f32 (``run_schedule_equiv.py``'s);
gradients 1e-4 of the largest entry (sums over tokens and experts in other
orders).  With a bf16 or fp8 wire both packages round at the same points,
but a value the two compute one f32 ulp apart (the expert FFN's backward
sums in another order than XLA's) can sit on a rounding boundary and cross
the wire as the neighbouring bf16 / e4m3 value: there y and every
gradient are held to 1e-4 of the largest entry except for at most 1% of
the elements (seen: 1 of 1024), which may differ by one wire rounding step
at the largest entry (2^-8 for bf16, 2^-3 for e4m3) and no more.
``expert_load`` and ``drop_frac`` exactly; the aux and z losses 1e-6
relative.

The JAX side runs in a subprocess on 8 host devices
(``conftest.subprocess_env``), its script below; the ranks run one spawn
per mesh, every case inside it, one thread each.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import subprocess_env

pytestmark = [pytest.mark.multirank, pytest.mark.skipif(
    importlib.util.find_spec("jax") is None, reason="needs jax")]

M, F, E, K = 32, 64, 8, 2
MESHES = {
    "merged": ((2, 2), ("data", "model"),
               dict(ep=("data",), esp=("model",), mp=("model",))),
    "distinct": ((2, 2, 2), ("ep", "esp", "mp"),
                 dict(ep=("ep",), esp=("esp",), mp=("mp",))),
}
# (name, mesh, schedule, pipeline_chunks, wire, infer, B, L)
CASES = [
    ("m-baseline", "merged", "baseline", 1, "f32", False, 8, 8),
    ("m-s1", "merged", "s1", 1, "f32", False, 8, 8),
    ("m-s2", "merged", "s2", 1, "f32", False, 8, 8),
    ("m-s1_seqpar", "merged", "s1_seqpar", 1, "f32", False, 8, 8),
    ("m-s2h", "merged", "s2h", 1, "f32", False, 8, 8),
    ("m-s1g", "merged", "s1g", 1, "f32", False, 8, 8),
    ("m-s1_pipe", "merged", "s1", 2, "f32", False, 8, 8),
    ("m-s2_pipe", "merged", "s2", 2, "f32", False, 8, 8),
    ("m-s2h_pipe", "merged", "s2h", 2, "f32", False, 8, 8),
    ("m-s1g_pipe", "merged", "s1g", 2, "f32", False, 8, 8),
    ("m-s1-bf16", "merged", "s1", 1, "bf16", False, 8, 8),
    ("m-s1g-bf16", "merged", "s1g", 1, "bf16", False, 8, 8),
    ("m-s1-fp8", "merged", "s1", 1, "fp8_e4m3", False, 8, 8),
    ("m-s1g-fp8", "merged", "s1g", 1, "fp8_e4m3", False, 8, 8),
    ("d-baseline", "distinct", "baseline", 1, "f32", False, 8, 8),
    ("d-s1", "distinct", "s1", 1, "f32", False, 8, 8),
    ("d-s2", "distinct", "s2", 1, "f32", False, 8, 8),
    ("d-s1g", "distinct", "s1g", 1, "f32", False, 8, 8),
    ("d-s2h_pipe", "distinct", "s2h", 2, "f32", False, 8, 8),
    ("d-decode", "distinct", "s1", 1, "f32", True, 4, 1),
]
GRADS = ("x", "wg", "w1", "w2", "w3")

JAX_SCRIPT = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.core.collectives import CommConfig
from repro.core.moe import MoEConfig, apply_moe
from repro.parallel.mesh import ParallelDims, make_mesh

src, dst = sys.argv[1], sys.argv[2]
inp = dict(np.load(src, allow_pickle=True))
cases = inp.pop("cases").tolist()
meshes = inp.pop("meshes").tolist()
out = {}
for name, mk, sched, chunks, wire, infer, B, L in cases:
    shape, names, dkw = meshes[mk]
    mesh = make_mesh(tuple(shape), tuple(names))
    dims = ParallelDims(**dkw)
    cfg = MoEConfig(d_model=%(M)d, d_ff=%(F)d, n_experts=%(E)d,
                    top_k=%(K)d, capacity_factor=1.25, glu=True,
                    schedule=sched, pipeline_chunks=chunks,
                    comm=CommConfig(wire_dtype=wire))
    x = jnp.asarray(inp[name + ":x"])
    r = jnp.asarray(inp[name + ":r"])
    p = {k: jnp.asarray(inp["p:" + k]) for k in ("wg", "w1", "w2", "w3")}

    def loss(x, p):
        y, aux = apply_moe(x, p, mesh=mesh, dims=dims, cfg=cfg, infer=infer)
        return jnp.sum(y * r) + aux["aux_loss"] + aux["z_loss"], (y, aux)

    (_, (y, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(x, p)
    out[name + ":y"] = np.asarray(y)
    for k, v in aux.items():
        out[name + ":aux:" + k] = np.asarray(v)
    out[name + ":g:x"] = np.asarray(gx)
    for k, v in gp.items():
        out[name + ":g:" + k] = np.asarray(v)
np.savez(dst, **out)
''' % dict(M=M, F=F, E=E, K=K)


def _inputs():
    rng = np.random.RandomState(11)
    inp = {"p:wg": rng.randn(M, E) / np.sqrt(M),
           "p:w1": rng.randn(E, M, F) / np.sqrt(M),
           "p:w2": rng.randn(E, F, M) / np.sqrt(F),
           "p:w3": rng.randn(E, M, F) / np.sqrt(M)}
    for name, *_, B, L in CASES:
        inp[name + ":x"] = rng.randn(B, L, M)
        inp[name + ":r"] = rng.randn(B, L, M)
    return {k: v.astype(np.float32) for k, v in inp.items()}


def _moe_rank(rank, mesh_kind, cases, inp):
    """One rank: every case of ``mesh_kind`` through the port, returning
    its y block, aux and gradient blocks (numpy)."""
    from repro_torch.core.collectives import CommConfig
    from repro_torch.core.moe import MoEConfig, apply_moe, moe_param_specs
    from repro_torch.parallel.mesh import ParallelDims, make_mesh
    from repro_torch.parallel.sharding import P, local_shard
    from repro_torch.train.loop import sync_grads
    shape, names, dkw = MESHES[mesh_kind]
    mesh = make_mesh(shape, names)
    dims = ParallelDims(**dkw)
    out = {}
    for name, mk, sched, chunks, wire, infer, B, L in cases:
        if mk != mesh_kind:
            continue
        cfg = MoEConfig(d_model=M, d_ff=F, n_experts=E, top_k=K,
                        capacity_factor=1.25, glu=True, schedule=sched,
                        pipeline_chunks=chunks,
                        comm=CommConfig(wire_dtype=wire))
        specs = moe_param_specs(cfg, mesh, dims)
        xs = P(dims.batch_axes, None, None)
        x = torch.from_numpy(local_shard(inp[name + ":x"], xs, mesh))
        r = torch.from_numpy(local_shard(inp[name + ":r"], xs, mesh))
        p = {k: torch.from_numpy(np.ascontiguousarray(
            local_shard(inp["p:" + k], specs[k], mesh)))
            for k in ("wg", "w1", "w2", "w3")}
        leaves = [x.requires_grad_()] + [p[k].requires_grad_()
                                         for k in GRADS[1:]]
        y, aux = apply_moe(x, p, cfg=cfg, mesh=mesh, dims=dims, infer=infer)
        loss = (y * r).sum() + aux["aux_loss"] + aux["z_loss"]
        grads = torch.autograd.grad(loss, leaves)
        grads = [grads[0]] + sync_grads(list(grads[1:]),
                                        [specs[k] for k in GRADS[1:]],
                                        mesh, dims)
        out[name + ":y"] = y.detach().numpy()
        for k, v in aux.items():
            out[name + ":aux:" + k] = v.detach().numpy()
        for k, g in zip(GRADS, grads):
            out[name + ":g:" + k] = g.numpy()
    if mesh_kind == "merged":
        # a pick already agreed under another layer's inputs must not let
        # a rank skip the next check while the others wait in it
        from repro_torch.core.moe import _check_agreed
        _check_agreed(mesh, ("first",), "s1", 1, "f32", "cpu")
        try:
            _check_agreed(mesh, ("second",), "s1" if rank % 2 else "s2", 1,
                          "f32", "cpu")
            out["disagree"] = np.array("no error")
        except RuntimeError as e:
            out["disagree"] = np.array(str(e))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    tmp = tmp_path_factory.mktemp("moe_dist")
    inp = _inputs()
    src, dst = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(src, cases=np.array(CASES, dtype=object),
             meshes=np.array(MESHES, dtype=object), **inp)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, src, dst],
        env=subprocess_env(8), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ranks = {mk: spawn(_moe_rank, int(np.prod(MESHES[mk][0])), mk, CASES,
                       inp, backend="gloo", device="cpu", threads=1,
                       timeout=300)
             for mk in MESHES}
    _, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, err[-3000:]
    return inp, dict(np.load(dst)), ranks


#: one rounding step of the wire format, relative to the largest entry
WIRE_STEP = {"bf16": 2.0 ** -8, "fp8_e4m3": 2.0 ** -3}


def _close(got, want, wire, what):
    """1e-4 of the largest entry; on a bf16 / fp8 wire up to 1% of the
    elements may be off by one wire rounding step (module docstring)."""
    scale = max(1.0, float(np.abs(want).max()))
    diff = np.abs(np.asarray(got, np.float64) - want)
    if wire == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=what)
        return
    off = int((diff > 1e-4 * scale).sum())
    assert off <= max(1, diff.size // 100), (what, off, diff.size)
    assert diff.max() <= WIRE_STEP[wire] * scale, (what, diff.max())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_apply_moe_across_ranks_matches_jax(runs, case):
    from repro_torch.core.moe import MoEConfig, moe_param_specs
    from repro_torch.parallel.mesh import Mesh, ParallelDims
    from repro_torch.parallel.sharding import P, local_shard
    inp, ref, ranks = runs
    name, mk, sched, chunks, wire, infer, B, L = case
    shape, names, dkw = MESHES[mk]
    dims = ParallelDims(**dkw)
    cfg = MoEConfig(d_model=M, d_ff=F, n_experts=E, top_k=K)
    for rank, got in enumerate(ranks[mk]):
        mesh = Mesh(shape, names, rank, groups=False)
        specs = moe_param_specs(cfg, mesh, dims)
        specs["x"] = P(dims.batch_axes, None, None)
        y_want = local_shard(ref[name + ":y"], specs["x"], mesh)
        if wire == "f32":
            np.testing.assert_allclose(got[name + ":y"], y_want, rtol=2e-4,
                                       atol=2e-5, err_msg=f"{name} y")
        else:
            _close(got[name + ":y"], y_want, wire, f"{name} y")
        for k in ("expert_load", "drop_frac"):
            np.testing.assert_array_equal(got[name + ":aux:" + k],
                                          ref[name + ":aux:" + k],
                                          err_msg=f"{name} {k}")
        for k in ("aux_loss", "z_loss"):
            np.testing.assert_allclose(got[name + ":aux:" + k],
                                       ref[name + ":aux:" + k], rtol=1e-6,
                                       err_msg=f"{name} {k}")
        for k in GRADS:
            want = local_shard(ref[name + ":g:" + k], specs[k], mesh)
            _close(got[name + ":g:" + k], want, wire,
                   f"{name} rank {rank} grad {k}")
    if infer:   # the pool went through the dense_decode fallback
        assert float(ref[name + ":aux:drop_frac"]) == 0.0


def test_ranks_that_disagree_on_the_schedule_raise(runs):
    """Ranks that resolve one layer to different picks all raise, also
    when some of them picked a decision already checked for another
    layer."""
    for got in runs[2]["merged"]:
        assert "ranks disagree" in str(got["disagree"]), got["disagree"]


def test_a_one_rank_mesh_is_the_one_rank_layer():
    """``apply_moe`` on a one-rank mesh gives ``torch.equal`` outputs and
    gradients to ``mesh=None``: the mesh path degenerates to today's
    layer."""
    from repro_torch.core.moe import MoEConfig, apply_moe
    from repro_torch.parallel.mesh import ParallelDims, make_mesh
    inp = _inputs()
    mesh = make_mesh((1, 1), ("data", "model"))
    dims = ParallelDims(**MESHES["merged"][2])
    for sched in ("s1", "s2", "baseline", "s1g"):
        cfg = MoEConfig(d_model=M, d_ff=F, n_experts=E, top_k=K,
                        schedule=sched)
        outs = []
        for kw in ({}, {"mesh": mesh, "dims": dims}):
            x = torch.from_numpy(inp["m-s1:x"]).requires_grad_()
            p = {k: torch.from_numpy(inp["p:" + k]).requires_grad_()
                 for k in ("wg", "w1", "w2", "w3")}
            y, aux = apply_moe(x, p, cfg=cfg, **kw)
            loss = y.square().sum() + aux["aux_loss"] + aux["z_loss"]
            g = torch.autograd.grad(loss, [x, *p.values()])
            outs.append((y.detach(), *[aux[k] for k in sorted(aux)], *g))
        for a, b in zip(*outs):
            assert torch.equal(a, b), sched
