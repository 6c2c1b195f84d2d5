"""The port's mesh bookkeeping against the JAX package's, with no
processes: ``ParallelDims`` (``merged``, ``batch_axes``, ``sizes``,
``validate``), ``production_dims``, ``ShardingRules`` and
``moe_param_specs`` give JAX's specs on the same mesh shapes (the JAX
functions read only ``mesh.shape``, so both take the port's layout-only
``Mesh``); ``local_shard`` cuts every rank's block so that the blocks
tile the array; ``shard_pool_capacity`` is ``==`` JAX's at several
``(n_token_shard, n_mp)``; the rank order of a group whose axis tuple is
not in mesh order; the launcher's layout and the backend rule."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import moe as jmoe  # noqa: E402
from repro.launch import mesh as jlaunch  # noqa: E402
from repro.parallel import mesh as jmesh  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.launch import mesh as tlaunch  # noqa: E402
from repro_torch.parallel import mesh as tmesh  # noqa: E402
from repro_torch.parallel import sharding as tsharding  # noqa: E402

MESHES = [((4, 2), ("data", "model")), ((2, 2, 2), ("ep", "esp", "mp")),
          ((2, 4), ("data", "model")), ((1, 1), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
DIMS = [dict(ep=("data",), esp=("model",), mp=("model",)),
        dict(ep=("ep",), esp=("esp",), mp=("mp",)),
        dict(dp=("pod",), ep=("data",), esp=("model",), mp=("model",)),
        dict(dp=("data",), mp=("model",)),
        dict(ep=("data", "model"))]


def _cases():
    for (shape, names), dkw in itertools.product(MESHES, DIMS):
        if all(a in names for v in dkw.values() for a in v):
            yield shape, names, dkw


CASES = list(_cases())


def _canon(spec):
    """A spec's entries as tuples of axis names (JAX's PartitionSpec
    writes a one-axis entry as the bare name)."""
    return tuple(None if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)) for e in spec)


def _ids():
    return ["x".join(map(str, s)) + "-" + "-".join(
        f"{k}={v}" for k, v in d.items()) for s, _, d in CASES]


@pytest.mark.parametrize("shape,names,dkw", CASES, ids=_ids())
def test_parallel_dims_are_jaxs(shape, names, dkw):
    mesh = tmesh.Mesh(shape, names, groups=False)
    td, jd = tmesh.ParallelDims(**dkw), jmesh.ParallelDims(**dkw)
    assert (td.dp, td.ep, td.esp, td.mp) == (jd.dp, jd.ep, jd.esp, jd.mp)
    assert td.merged == jd.merged
    assert td.batch_axes == jd.batch_axes
    assert td.sizes(mesh) == jd.sizes(mesh)
    for axes in [(), names[:1], names, names[::-1]]:
        assert tmesh.axis_size(mesh, axes) == jmesh.axis_size(mesh, axes)
    for E in (8, 3):
        errs = []
        for d in (td, jd):
            try:
                d.validate(mesh, E)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]
    rules = (tsharding.ShardingRules(mesh, td),
             jsharding.ShardingRules(mesh, jd))
    assert _canon(rules[0].act_tokens()) == _canon(rules[1].act_tokens())
    for n_kv in (1, 2, 4):
        assert _canon(rules[0].act_kv_cache(n_kv)) \
            == _canon(rules[1].act_kv_cache(n_kv))
    for shp, mp_dim in (((64, 96), 1), ((96, 64), 0), ((3, 5), 1),
                        ((8, 8), None)):
        assert _canon(rules[0].dense(shp, mp_dim)) \
            == _canon(rules[1].dense(shp, mp_dim))
    for shp, esp_dim in (((8, 32, 64), 2), ((8, 64, 32), 1),
                         ((3, 32, 5), 2)):
        assert _canon(rules[0].expert(shp, esp_dim)) \
            == _canon(rules[1].expert(shp, esp_dim))
    for E, F, glu, shared in ((8, 64, True, 0), (4, 48, False, 0),
                              (6, 30, True, 1), (8, 64, True, 2)):
        kw = dict(d_model=32, d_ff=F, n_experts=E, glu=glu,
                  n_shared_experts=shared)
        got = tmoe.moe_param_specs(tmoe.MoEConfig(**kw), mesh, td)
        want = jmoe.moe_param_specs(jmoe.MoEConfig(**kw), mesh, jd)
        assert {k: _canon(v) for k, v in got.items()} \
            == {k: _canon(v) for k, v in want.items()}


def test_production_dims_and_the_launchers_mesh_are_jaxs():
    for mp in (False, True):
        for moe in (False, True):
            t = tmesh.production_dims(multi_pod=mp, moe=moe)
            j = jmesh.production_dims(multi_pod=mp, moe=moe)
            assert (t.dp, t.ep, t.esp, t.mp) == (j.dp, j.ep, j.esp, j.mp)
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    for arch in ("gpt2-moe", "qwen3-moe-30b-a3b"):
        assert tlaunch.dims_for(tget(arch)) == tmesh.ParallelDims(
            **dataclasses.asdict(jlaunch.dims_for(jget(arch))))
    assert tlaunch.parse_mesh("data=2,model=2", 4) \
        == ((2, 2), ("data", "model"))
    with pytest.raises(ValueError):
        tlaunch.parse_mesh("data=2,model=2", 8)
    with pytest.raises(ValueError):
        tlaunch.parse_mesh("data=2,model", 2)


@pytest.mark.parametrize("shape,names", MESHES[:3])
def test_local_shard_blocks_tile_the_array(shape, names):
    """Every rank's block, put back at its offsets, rebuilds the array
    exactly once per replica; numpy and tensors cut the same blocks."""
    rng = np.random.RandomState(0)
    full = rng.randn(8, 6, 4).astype(np.float32)
    specs = [tsharding.P(names[0], None, names[-1]),
             tsharding.P(tuple(names[:2]), None, None),
             tsharding.P(tuple(names[::-1][:2]), None, None),
             tsharding.P(None, None, None), tsharding.P()]
    n = int(np.prod(shape))
    for spec in specs:
        cover = np.zeros(full.shape, np.int64)
        for rank in range(n):
            mesh = tmesh.Mesh(shape, names, rank, groups=False)
            blk = tsharding.local_shard(full, spec, mesh)
            tblk = tsharding.local_shard(torch.from_numpy(full), spec, mesh)
            assert np.array_equal(blk, tblk.numpy())
            sl = []
            for d, e in enumerate(spec):
                if e is None:
                    sl.append(slice(None))
                    continue
                axes = (e,) if isinstance(e, str) else e
                k = full.shape[d] // tmesh.axis_size(mesh, axes)
                i = mesh.group(axes).index
                sl.append(slice(i * k, (i + 1) * k))
            sl += [slice(None)] * (full.ndim - len(sl))
            assert np.array_equal(full[tuple(sl)], blk), (spec, rank)
            cover[tuple(sl)] += 1
        reps = n // int(np.prod([tmesh.axis_size(mesh, (
            (e,) if isinstance(e, str) else e)) for e in spec
            if e is not None] or [1]))
        assert (cover == reps).all(), spec
        assert tsharding.replicated_axes(spec, mesh) == tuple(
            a for a in names if a not in tsharding.mentioned(spec))


def test_shard_pool_capacity_is_jaxs_at_every_split():
    for E, k, cf in ((8, 2, 1.25), (8, 2, 4.0), (128, 8, 1.25)):
        kw = dict(d_model=8, d_ff=8, n_experts=E, top_k=k,
                  capacity_factor=cf)
        tg = tmoe.MoEConfig(**kw).gate_config()
        jg = jmoe.MoEConfig(**kw).gate_config()
        for tokens, nts, nmp, infer in itertools.product(
                (4, 64, 8192), (1, 2, 4, 8), (1, 2, 4), (False, True)):
            assert tmoe.shard_pool_capacity(tokens, nts, nmp, tg, infer) \
                == jmoe.shard_pool_capacity(tokens, nts, nmp, jg, infer)


def test_a_tuple_out_of_mesh_order_keeps_jaxs_order():
    """On a mesh laid out (esp, ep), the tuple (ep, esp) indexes ranks
    ep-major, as ``lax.axis_index(("ep", "esp"))`` does, while the process
    group's positions run in global-rank (esp-major) order: the group
    carries the permutation (its ``order``), which the collectives apply
    (``tests/test_torch_collectives_dist.py`` moves data through it)."""
    for rank in range(4):
        mesh = tmesh.Mesh((2, 2), ("esp", "ep"), rank, groups=False)
        esp, ep = rank // 2, rank % 2
        g = mesh.group(("ep", "esp"))
        assert g.index == ep * 2 + esp
        assert g.order == (0, 2, 1, 3)       # ranks 0..3 -> ep-major index
        assert not g.identity_order
        assert mesh.group(("esp", "ep")).order == (0, 1, 2, 3)
        assert mesh.group(("esp", "ep")).index == rank
        assert mesh.axis_index("ep") == ep
    three = tmesh.Mesh((2, 2, 2), ("ep", "esp", "mp"), 5, groups=False)
    assert three.coords == {"ep": 1, "esp": 0, "mp": 1}
    assert three.group(("ep", "esp")).index == 2
    assert three.group(("mp", "ep")).index == 3
    assert three.group(("mp", "ep")).order == (0, 2, 1, 3)


def test_make_mesh_without_processes_is_one_rank_only():
    assert tmesh.make_mesh((1, 1), ("data", "model")).size == 1
    with pytest.raises(RuntimeError, match="initialised"):
        tmesh.make_mesh((2, 1), ("data", "model"))
