"""Every collective of ``repro_torch.core.collectives`` on gloo ranks
against the JAX function under ``shard_map`` on the same mesh of host
devices, forward and backward (``jax.vjp`` with a seeded cotangent; the
port's ``torch.autograd.grad`` on each rank's block), and the backend
rule.

Meshes: the distinct ``("ep", "esp", "mp")`` (2, 2, 2) mesh (8 ranks) and
a ``("esp", "ep")`` (2, 2) mesh whose collectives run over the tuple
``("ep", "esp")``: out of mesh order, so the group's rank order (global,
esp-major) differs from JAX's (ep-major) and the chunks must be permuted.
Each rank's block is its row block of the global arrays (``shard_map``
with every axis on dim 0).

Moves are held **bitwise**: an AlltoAll, an AllGather, a split and the
f32 and bf16 wires around them move bits, forward and backward (the
transposes of the AlltoAlls and splits are moves too).  What sums
(``psum``, an AllGather's transpose, the fp8 gather's backward sum after
the decode) is held to 1e-6 of the largest entry: a sum of 2 to 8 terms
in JAX's source order, as the port's ``ordered_sum`` takes it.  So is
the fp8 wire: its encoded bytes are eager JAX's bit for bit
(``test_fp8_wire_bytes_are_eager_jaxs``), but inside ``jit`` XLA fuses
the encode and decode arithmetic and lands a few f32 ulps away (measured
2.4e-4 on entries of ~2e3).
"""

import importlib.util
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import subprocess_env

pytestmark = [pytest.mark.multirank, pytest.mark.skipif(
    importlib.util.find_spec("jax") is None, reason="needs jax")]

MESHES = {"d3": ((2, 2, 2), ("ep", "esp", "mp")),
          "ro": ((2, 2), ("esp", "ep"))}
# (name, mesh, op, wire, block shape, bitwise forward, bitwise backward)
CASES = [
    ("ep_a2a", "d3", "ep_a2a", None, (2, 4, 3, 8), True, True),
    ("epesp_a2a", "d3", "epesp_a2a", None, (2, 4, 3, 8), True, True),
    ("epesp_a2a_split1_concat2", "d3", "epesp_a2a_12", None, (2, 4, 4, 8),
     True, True),
    ("hier_esp_first", "d3", "hier_esp_first", None, (2, 4, 3, 8), True,
     True),
    ("hier_ep_first", "d3", "hier_ep_first", None, (2, 4, 3, 8), True,
     True),
    ("mp_split", "d3", "mp_split", None, (2, 4, 3, 8), True, True),
    ("mp_all_gather", "d3", "mp_ag", None, (2, 4, 3, 8), True, False),
    ("psum_esp", "d3", "psum_esp", None, (2, 4, 3, 8), False, False),
    ("psum_all", "d3", "psum_all", None, (2, 4, 3, 8), False, False),
    ("wire_epesp_a2a_bf16", "d3", "w_epesp", "bf16", (2, 4, 3, 8), True,
     True),
    ("wire_epesp_a2a_fp8", "d3", "w_epesp", "fp8_e4m3", (2, 4, 3, 8), False,
     False),
    ("wire_ep_a2a_fp8", "d3", "w_ep", "fp8_e4m3", (2, 4, 3, 8), False, False),
    ("wire_hier_fp8", "d3", "w_hier", "fp8_e4m3", (2, 4, 3, 8), False, False),
    ("wire_mp_all_gather_bf16", "d3", "w_mpag", "bf16", (2, 4, 3, 8), True,
     False),
    ("wire_mp_all_gather_fp8", "d3", "w_mpag", "fp8_e4m3", (2, 4, 3, 8),
     False, False),
    ("wire_stacked_bf16", "d3", "w_stack", "bf16", (2, 4, 3, 8), True,
     False),
    ("wire_stacked_fp8", "d3", "w_stack", "fp8_e4m3", (2, 4, 3, 8), False,
     False),
    ("saa_fp8", "d3", "saa", "fp8_e4m3", (2, 4, 4, 8), False, False),
    ("rank_order_epesp_a2a", "ro", "epesp_a2a", None, (2, 4, 3, 8), True,
     True),
    ("rank_order_all_gather", "ro", "ag_tuple", None, (2, 4, 3, 8), True,
     False),
    ("rank_order_psum", "ro", "psum_tuple", None, (2, 4, 3, 8), False,
     False),
]

EP, ESP, MP = ("ep",), ("esp",), ("mp",)

# ``ops(coll, lax, CommConfig, n)`` -> {op: fn(x)}: the same table for both
# packages; ``n`` maps an axis tuple to its size (the port's functions
# take sizes, the JAX ones read them from the mesh)
OPS_SRC = r'''
def ops(coll, lax, CommConfig, n, torch_side):
    EP, ESP, MP = ("ep",), ("esp",), ("mp",)
    G = n(EP + ESP)

    def a2a(x, axes, s, c):
        if torch_side:
            return coll.ep_esp_all_to_all(x, axes, (), n(axes),
                                          split_axis=s, concat_axis=c)
        return lax.all_to_all(x, axes, s, c, tiled=True)

    def wire(w):
        return CommConfig(wire_dtype=w)

    return {
        "ep_a2a": lambda x, w: (coll.ep_all_to_all(x, EP, n(EP),
                                split_axis=1, concat_axis=1) if torch_side
                                else coll.ep_all_to_all(x, EP, split_axis=1,
                                                        concat_axis=1)),
        "epesp_a2a": lambda x, w: (coll.ep_esp_all_to_all(
            x, EP, ESP, G, split_axis=1, concat_axis=1) if torch_side else
            coll.ep_esp_all_to_all(x, EP, ESP, split_axis=1, concat_axis=1)),
        "epesp_a2a_12": lambda x, w: a2a(x, EP + ESP, 1, 2),
        "hier_esp_first": lambda x, w: coll.hier_ep_esp_all_to_all(
            x, EP, ESP, n(EP), n(ESP), axis=1, order="esp_first"),
        "hier_ep_first": lambda x, w: coll.hier_ep_esp_all_to_all(
            x, EP, ESP, n(EP), n(ESP), axis=1, order="ep_first"),
        "mp_split": lambda x, w: coll.mp_split(x, MP, n(MP), axis=1),
        "mp_ag": lambda x, w: coll.mp_all_gather(x, MP, n(MP), axis=1),
        "psum_esp": lambda x, w: (coll.psum(x, ESP, n(ESP)) if torch_side
                                  else lax.psum(x, ESP)),
        "psum_all": lambda x, w: (coll.psum(x, EP + ESP + MP, n(EP + ESP + MP))
                                  if torch_side
                                  else lax.psum(x, EP + ESP + MP)),
        "w_epesp": lambda x, w: (coll.wire_ep_esp_all_to_all(
            x, EP, ESP, G, wire(w), split_axis=1, concat_axis=1)
            if torch_side else coll.wire_ep_esp_all_to_all(
            x, EP, ESP, wire(w), split_axis=1, concat_axis=1)),
        "w_ep": lambda x, w: (coll.wire_ep_all_to_all(
            x, EP, n(EP), wire(w), split_axis=1, concat_axis=1)
            if torch_side else coll.wire_ep_all_to_all(
            x, EP, wire(w), split_axis=1, concat_axis=1)),
        "w_hier": lambda x, w: coll.wire_hier_ep_esp_all_to_all(
            x, EP, ESP, n(EP), n(ESP), wire(w), axis=1, order="ep_first"),
        "w_mpag": lambda x, w: coll.wire_mp_all_gather(
            x, MP, n(MP), wire(w), axis=1),
        "w_stack": lambda x, w: coll.wire_all_gather_stacked(
            x, MP, n(MP), wire(w), axis=1),
        "saa": lambda x, w: coll.saa_combine_allgather(
            x, EP, ESP, MP, n_ep=n(EP), n_esp=n(ESP), n_mp=n(MP),
            n_chunks=2, comm=wire(w)),
        "ag_tuple": lambda x, w: coll.mp_all_gather(
            x, EP + ESP, n(EP + ESP), axis=1),
        "psum_tuple": lambda x, w: (coll.psum(x, EP + ESP, n(EP + ESP))
                                    if torch_side
                                    else lax.psum(x, EP + ESP)),
    }
'''

JAX_SCRIPT = OPS_SRC + r'''
import sys
import numpy as np
import jax
from jax import lax
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import collectives as coll
from repro.core.collectives import CommConfig
from repro.parallel.mesh import make_mesh

src, dst = sys.argv[1], sys.argv[2]
inp = dict(np.load(src, allow_pickle=True))
cases = inp.pop("cases").tolist()
meshes = inp.pop("meshes").tolist()
out = {}
for name, mk, op, w, *_ in cases:
    shape, names = meshes[mk]
    mesh = make_mesh(tuple(shape), tuple(names))
    n = lambda axes: int(np.prod([mesh.shape[a] for a in axes]))
    fn = ops(coll, lax, CommConfig, n, False)[op]
    spec = P(tuple(names))
    f = compat.shard_map(lambda x: fn(x, w), mesh=mesh, in_specs=(spec,),
                         out_specs=spec, check_vma=False)
    y, vjp = jax.vjp(jax.jit(f), inp[name + ":x"])
    out[name + ":y"] = np.asarray(y)
    out[name + ":g"] = np.asarray(vjp(inp[name + ":ct"].astype(y.dtype))[0])
np.savez(dst, **out)
'''


def _ops(torch_side, n):
    ns = {}
    exec(OPS_SRC, ns)
    from repro_torch.core import collectives as coll
    from repro_torch.core.collectives import CommConfig
    return ns["ops"](coll, None, CommConfig, n, torch_side)


def _out_rows(op, block, n_ranks):
    """Rows of each rank's output block (the cotangent's shape)."""
    shp = list(block)
    if op in ("mp_split",):
        shp[1] //= 2
    elif op in ("mp_ag", "w_mpag"):
        shp[1] *= 2
    elif op == "ag_tuple":
        shp[1] *= 4
    elif op == "w_stack":
        shp.insert(1, 2)
    elif op == "saa":       # (El, G, c, M) -> (E = 2 El, c * N_MP, M)
        shp = [2 * shp[0], shp[2] * 2, shp[3]]
    elif op == "epesp_a2a_12":
        shp[1] //= 4
        shp[2] *= 4
    return [shp[0] * n_ranks] + shp[1:]


def _inputs():
    rng = np.random.RandomState(3)
    inp = {}
    for name, mk, op, w, block, *_ in CASES:
        n_ranks = int(np.prod(MESHES[mk][0]))
        x = rng.randn(block[0] * n_ranks, *block[1:]).astype(np.float32)
        x[0] *= 1e3          # rows with other absmax scales (fp8)
        inp[name + ":x"] = x
        inp[name + ":ct"] = rng.randn(*_out_rows(op, block, n_ranks)) \
            .astype(np.float32)
    return inp


def _coll_rank(rank, mk, inp):
    from repro_torch.core import collectives as coll
    from repro_torch.parallel.mesh import make_mesh
    shape, names = MESHES[mk]
    mesh = make_mesh(shape, names)

    def n(axes):
        return int(np.prod([mesh.shape[a] for a in axes]))
    table = _ops(True, n)
    out = {}
    for name, m, op, w, block, *_ in CASES:
        if m != mk:
            continue
        a = block[0]
        x = torch.from_numpy(inp[name + ":x"][rank * a:(rank + 1) * a])
        x.requires_grad_()
        with coll.bound(mesh):
            y = table[op](x, w)
        b = inp[name + ":ct"].shape[0] // mesh.size
        ct = torch.from_numpy(inp[name + ":ct"][rank * b:(rank + 1) * b])
        g, = torch.autograd.grad(y, x, ct.to(y.dtype))
        out[name + ":y"] = y.detach().float().numpy()
        out[name + ":g"] = g.float().numpy()
    # gather_full inverts local_shard: every rank rebuilds the full array
    from repro_torch.parallel.sharding import P, gather_full, local_shard
    full = torch.from_numpy(inp[CASES[0][0] + ":x"])
    for spec in (P(names[0], None, None, names[-1]),
                 P(tuple(names[::-1]))):
        out[f"gather_full:{spec}"] = bool(torch.equal(
            gather_full(local_shard(full, spec, mesh), spec, mesh), full))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    tmp = tmp_path_factory.mktemp("coll_dist")
    inp = _inputs()
    src, dst = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(src, cases=np.array([c[:4] for c in CASES], dtype=object),
             meshes=np.array(MESHES, dtype=object), **inp)
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, src, dst],
                               env=subprocess_env(8), stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    ranks = {mk: spawn(_coll_rank, int(np.prod(MESHES[mk][0])), mk, inp,
                       backend="gloo", device="cpu", threads=1, timeout=300)
             for mk in MESHES}
    _, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, err[-3000:]
    return dict(np.load(dst)), ranks


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_collective_forward_and_backward_match_jax(runs, case):
    ref, ranks = runs
    name, mk, op, w, block, exact_y, exact_g = case
    n_ranks = len(ranks[mk])
    for key, exact in ((":y", exact_y), (":g", exact_g)):
        want = ref[name + key].astype(np.float32)
        rows = want.shape[0] // n_ranks
        for rank, got in enumerate(ranks[mk]):
            mine = got[name + key]
            blk = want[rank * rows:(rank + 1) * rows]
            if exact:
                np.testing.assert_array_equal(mine, blk,
                                              err_msg=f"{name}{key} {rank}")
            else:
                scale = max(1.0, float(np.abs(blk).max()))
                np.testing.assert_allclose(mine, blk, rtol=0,
                                           atol=1e-6 * scale,
                                           err_msg=f"{name}{key} {rank}")


def test_gather_full_inverts_local_shard(runs):
    _, ranks = runs
    for mk, per_rank in ranks.items():
        for rank, got in enumerate(per_rank):
            keys = [k for k in got if k.startswith("gather_full:")]
            assert len(keys) == 2 and all(got[k] for k in keys), (mk, rank)


def test_nccl_with_more_ranks_than_cards_raises():
    """NCCL needs a card a rank: asking for more ranks than cards (here
    none) raises before any process group starts, and the CPU never runs
    NCCL; gloo is the caller's explicit choice."""
    from repro_torch.launch import mesh as tlaunch
    n_cards = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="Duplicate GPU"):
        tlaunch.check_backend("nccl", n_cards + 1, "cuda")
    with pytest.raises(ValueError, match="gloo"):
        tlaunch.check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError):
        tlaunch.check_backend("mpi", 2, "cpu")
    tlaunch.check_backend("gloo", 8, "cpu")
    with pytest.raises(RuntimeError, match="Duplicate GPU"):
        tlaunch.init_distributed("nccl", n_cards + 1, 0, store_dir="/tmp")


def test_a_collective_without_a_mesh_raises():
    from repro_torch.core import collectives as coll
    x = torch.zeros((4, 4))
    assert coll.ep_esp_all_to_all(x, EP, ESP, 1) is x
    with pytest.raises(RuntimeError, match="multi-rank mesh"):
        coll.ep_esp_all_to_all(x, EP, ESP, 2)
    with pytest.raises(RuntimeError, match="multi-rank mesh"):
        coll.psum(x, MP, 2)


def test_fp8_wire_bytes_are_eager_jaxs():
    """The fp8 encode's payload and scale-tail bytes, and the decode, are
    eager JAX's bit for bit on the collectives' inputs."""
    import jax.numpy as jnp
    from repro.core import collectives as jc
    from repro_torch.core import collectives as tc
    inp = _inputs()
    for name, _, _, w, *_ in CASES:
        if w != "fp8_e4m3":
            continue
        x = inp[name + ":x"]
        jcomm, tcomm = jc.CommConfig(wire_dtype=w), tc.CommConfig(
            wire_dtype=w)
        je = jc.wire_encode(jnp.asarray(x), jcomm)
        te = tc.wire_encode(torch.from_numpy(x), tcomm)
        assert np.array_equal(np.asarray(je).view(np.uint8),
                              te.view(torch.uint8).numpy()), name
        assert np.array_equal(np.asarray(jc.wire_decode(je, jcomm,
                                                        jnp.float32)),
                              tc.wire_decode(te, tcomm,
                                             torch.float32).numpy()), name
