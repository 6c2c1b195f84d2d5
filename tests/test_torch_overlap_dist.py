"""The overlapped issue of the MoE layer's collectives across ranks
(``executor.execute``'s list scheduler, the start/wait forms of
``core.collectives`` and ``parallel.comm``) on gloo ranks on the CPU.

Meshes: the merged ``("data", "model")`` (2, 2) mesh (EP over data,
ESP == MP over model; 4 ranks) and the distinct ``("ep", "esp", "mp")``
(2, 2, 2) mesh (8 ranks); the layer at M=32, F=64, E=8, top-2, 8 x 8
tokens.  Cases: ``s1``, ``s2``, ``s2h``, ``s1g`` and ``baseline`` with 2
chunks, ``s2`` unchunked (SAA at 4 chunks), ``s1`` with 2 chunks on the
bf16 and the fp8 wire on the merged mesh; on the distinct mesh those
whose groups differ there (``DISTINCT``).

Each case runs forward and backward twice on every rank: overlapped (the
default) and serial (``executor.serial_issue``: ``overlap=False``, every
collective waited on as soon as it is issued).  y, aux and the gradients
of x, wg, w1, w2 and w3 are held ``torch.equal``: overlap moves the same
bits in the same sums.  The hook of ``parallel.comm`` records every start
and wait as (event, group axes, kind, tag); from it:

  * the forward of every case has two or more collectives in flight at
    once (the serial forward never more than one);
  * ``s2h`` has an ESP hop and an EP hop in flight at once, in the
    dispatch and in the combine AlltoAll;
  * SAA has chunk i's stacked AllGather in flight beside chunk i+1's
    AlltoAll;
  * every collective started in the forward is waited on by the time
    ``apply_moe`` returns, and ``execute`` raises on a collective it
    left in flight;
  * the backward of every case has two or more in flight at once (the
    autograd engine runs the ready node of the highest sequence number
    first, so it meets the forward's waits, which start the transposes,
    in the reverse of the forward's issue order, before the starts,
    which wait on them), and the serial backward one at a time.

``comm.timing`` is held to report the in-flight wall seconds beside the
summed ones over two AlltoAlls in flight together, and
``launch.overlap_times`` to run both issue modes on the CPU.
"""

import contextlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.multirank

M, F, E, K = 32, 64, 8, 2
B, L = 8, 8
MESHES = {
    "merged": ((2, 2), ("data", "model"),
               dict(ep=("data",), esp=("model",), mp=("model",))),
    "distinct": ((2, 2, 2), ("ep", "esp", "mp"),
                 dict(ep=("ep",), esp=("esp",), mp=("mp",))),
}
# (name, schedule, pipeline_chunks, wire)
LAYER = [
    ("s1_pipe2", "s1", 2, "f32"),
    ("s2_pipe2", "s2", 2, "f32"),
    ("s2h_pipe2", "s2h", 2, "f32"),
    ("s1g_pipe2", "s1g", 2, "f32"),
    ("baseline_pipe2", "baseline", 2, "f32"),
    ("s2_saa4", "s2", 1, "f32"),
    ("s1_pipe2-bf16", "s1", 2, "bf16"),
    ("s1_pipe2-fp8", "s1", 2, "fp8_e4m3"),
]
#: the distinct mesh runs the cases whose groups differ there (s2h's ESP
#: and EP hops, SAA's MP gather, the pool form's counts, the fp8 wire);
#: the merged mesh runs them all
DISTINCT = ("s1_pipe2", "s2h_pipe2", "s1g_pipe2", "s2_saa4", "s1_pipe2-fp8")
CASES = [(f"{mk[0]}-{name}", mk, *rest) for mk in MESHES
         for name, *rest in LAYER if mk == "merged" or name in DISTINCT]
IDS = [c[0] for c in CASES]
GRADS = ("x", "wg", "w1", "w2", "w3")


def _inputs():
    rng = np.random.RandomState(25)
    inp = {"wg": rng.randn(M, E) / np.sqrt(M),
           "w1": rng.randn(E, M, F) / np.sqrt(M),
           "w2": rng.randn(E, F, M) / np.sqrt(F),
           "w3": rng.randn(E, M, F) / np.sqrt(M),
           "x": rng.randn(B, L, M), "r": rng.randn(B, L, M)}
    return {k: v.astype(np.float32) for k, v in inp.items()}


def _rank(rank, mesh_kind, inp):
    """One rank: every case on ``mesh_kind`` overlapped and serial (y,
    aux, gradients and the hook's forward and backward records), the
    unwaited-collective check and the timing of two AlltoAlls."""
    from repro_torch.core import executor
    from repro_torch.core.collectives import CommConfig
    from repro_torch.core.moe import MoEConfig, apply_moe, moe_param_specs
    from repro_torch.parallel import comm
    from repro_torch.parallel.mesh import ParallelDims, make_mesh
    from repro_torch.parallel.sharding import P, local_shard
    shape, names, dkw = MESHES[mesh_kind]
    mesh = make_mesh(shape, names)
    dims = ParallelDims(**dkw)
    events = []
    comm.set_hook(lambda *ev: events.append(ev))
    out = {}
    for name, mk, sched, chunks, wire in CASES:
        if mk != mesh_kind:
            continue
        cfg = MoEConfig(d_model=M, d_ff=F, n_experts=E, top_k=K,
                        capacity_factor=1.25, glu=True, schedule=sched,
                        pipeline_chunks=chunks, saa_chunks=4,
                        comm=CommConfig(wire_dtype=wire))
        specs = moe_param_specs(cfg, mesh, dims)
        xs = P(dims.batch_axes, None, None)
        runs = []
        for serial in (False, True):
            x = torch.from_numpy(local_shard(inp["x"], xs, mesh))
            r = torch.from_numpy(local_shard(inp["r"], xs, mesh))
            p = {k: torch.from_numpy(np.ascontiguousarray(
                local_shard(inp[k], specs[k], mesh))).requires_grad_()
                for k in GRADS[1:]}
            x.requires_grad_()
            del events[:]
            if serial:
                with executor.serial_issue():
                    y, aux = apply_moe(x, p, cfg=cfg, mesh=mesh, dims=dims)
            else:
                y, aux = apply_moe(x, p, cfg=cfg, mesh=mesh, dims=dims)
            fwd = list(events)
            del events[:]
            loss = (y * r).sum() + aux["aux_loss"] + aux["z_loss"]
            grads = torch.autograd.grad(loss, [x] + [p[k]
                                                     for k in GRADS[1:]])
            runs.append({"y": y.detach(), "aux": {k: v.detach() for k, v
                                                   in aux.items()},
                         "g": dict(zip(GRADS, grads)), "fwd": fwd,
                         "bwd": list(events)})
        out[name] = runs
    out["unwaited"] = _unwaited(mesh, dims, inp)
    comm.set_hook(None)
    out["timing"] = _two_in_flight(mesh, dims)
    if mesh_kind == "merged":
        from repro_torch.launch import overlap_times
        out["overlap_times"] = overlap_times._rank(rank, ["s2x1"], 2, 16,
                                                   "cpu")
    return out


def _unwaited(mesh, dims, inp):
    """Run ``s1``'s plan with an extra MP-AllGather that nothing consumes:
    ``execute`` must raise, naming it."""
    import dataclasses

    from repro_torch.core import executor, moe
    from repro_torch.core.plan import build_plan, stage
    from repro_torch.parallel.sharding import P, local_shard

    def body(x, wg, w1, w3, w2, info):
        plan = build_plan("s1", info, n_chunks=1)
        extra = stage("extra", "ag_mp", deps=("comb",), axes=("mp",),
                      axis=0, wire=True)
        return executor.execute(dataclasses.replace(
            plan, stages=plan.stages + (extra,)), x, wg, w1, w3, w2, info)

    cfg = moe.MoEConfig(d_model=M, d_ff=F, n_experts=E, top_k=K,
                        schedule="s1")
    specs = moe.moe_param_specs(cfg, mesh, dims)
    x = torch.from_numpy(local_shard(inp["x"], P(dims.batch_axes, None,
                                                 None), mesh))
    p = {k: torch.from_numpy(np.ascontiguousarray(
        local_shard(inp[k], specs[k], mesh))) for k in GRADS[1:]}
    plain, moe.BODY["s1"] = moe.BODY["s1"], body
    try:
        moe.apply_moe(x, p, cfg=cfg, mesh=mesh, dims=dims)
    except RuntimeError as e:
        return str(e)
    finally:
        moe.BODY["s1"] = plain
    return "no error"


def _two_in_flight(mesh, dims):
    """Time an EP AlltoAll and an ESP AlltoAll in flight together."""
    from repro_torch.parallel import comm
    v = torch.arange(64 * 1024, dtype=torch.float32).reshape(4, -1)
    comm.timing(True)
    a = comm.all_to_all_start(v, mesh.group(dims.ep), 0, 0)
    b = comm.all_to_all_start(v, mesh.group(dims.esp), 0, 0)
    a.wait()
    b.wait()
    t = comm.times()
    comm.timing(False)
    return t


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import spawn
    inp = _inputs()
    return {mk: spawn(_rank, int(np.prod(MESHES[mk][0])), mk, inp,
                      backend="gloo", device="cpu", threads=1, timeout=300)
            for mk in MESHES}


def _in_flight(events):
    """Each snapshot of the collectives in flight, after every start."""
    live = []
    for ev, axes, kind, tag in events:
        if ev == "start":
            live.append((axes, kind, tag))
            yield list(live)
        else:
            live.remove((axes, kind, tag))


def _most(events) -> int:
    return max((len(s) for s in _in_flight(events)), default=0)


def _case(runs, case):
    """Each rank's (overlapped, serial) runs of ``case``."""
    return [got[case[0]] for got in runs[case[1]]]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_overlapped_issue_is_bitwise_the_serial_one(runs, case):
    name = case[0]
    for rank, (ov, se) in enumerate(_case(runs, case)):
        assert torch.equal(ov["y"], se["y"]), (name, rank)
        for k in ov["aux"]:
            assert torch.equal(ov["aux"][k], se["aux"][k]), (name, rank, k)
        for k in GRADS:
            assert torch.equal(ov["g"][k], se["g"][k]), (name, rank, k)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_has_collectives_in_flight_together(runs, case):
    name = case[0]
    for rank, (ov, se) in enumerate(_case(runs, case)):
        assert _most(ov["fwd"]) >= 2, (name, rank, ov["fwd"])
        assert _most(se["fwd"]) == 1, (name, rank, se["fwd"])
        # every start of the forward is waited on before apply_moe returns
        for run in (ov, se):
            starts = [e[1:] for e in run["fwd"] if e[0] == "start"]
            waits = [e[1:] for e in run["fwd"] if e[0] == "wait"]
            assert sorted(map(repr, starts)) == sorted(map(repr, waits))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_has_collectives_in_flight_together(runs, case):
    for rank, (ov, se) in enumerate(_case(runs, case)):
        assert _most(ov["bwd"]) >= 2, (case[0], rank, ov["bwd"])
        assert _most(se["bwd"]) == 1, (case[0], rank, se["bwd"])


@pytest.mark.parametrize("part", ["a2a_d@", "a2a_c@"])
def test_s2h_has_an_esp_hop_and_an_ep_hop_in_flight(runs, part):
    for mk, dkw in (("distinct", MESHES["distinct"][2]),
                    ("merged", MESHES["merged"][2])):
        esp, ep = dkw["esp"], dkw["ep"]
        case = (f"{mk[0]}-s2h_pipe2", mk)
        for rank, (ov, _) in enumerate(_case(runs, case)):
            assert any(
                any(t and t.startswith(part) and a == esp for a, _, t in snap)
                and any(t and t.startswith(part) and a == ep
                        for a, _, t in snap)
                for snap in _in_flight(ov["fwd"])), (mk, rank, ov["fwd"])


@pytest.mark.parametrize("mk", list(MESHES))
def test_saa_gathers_chunk_i_beside_the_alltoall_of_chunk_i_plus_1(runs,
                                                                   mk):
    for rank, (ov, se) in enumerate(_case(runs, (f"{mk[0]}-s2_saa4", mk))):
        pairs = set()
        for snap in _in_flight(ov["fwd"]):
            for _, kind, tag in snap:
                if kind == "all_gather" and (tag or "").startswith("a2a_c#"):
                    i = int(tag.split("#")[1])
                    if any(k == "all_to_all" and t == f"a2a_c#{i + 1}"
                           for _, k, t in snap):
                        pairs.add(i)
        assert pairs == {0, 1, 2}, (mk, rank, pairs, ov["fwd"])
        tags = [e[3] for e in se["fwd"] if e[0] == "start"
                and (e[3] or "").startswith("a2a_c#")]
        assert tags == [f"a2a_c#{i}" for i in range(4) for _ in (0, 1)]


@pytest.mark.parametrize("mk", list(MESHES))
def test_execute_raises_on_a_collective_left_in_flight(runs, mk):
    for got in runs[mk]:
        msg = got["unwaited"]
        assert "collectives in flight" in msg and "'extra'" in msg, msg


@pytest.mark.parametrize("mk", list(MESHES))
def test_timing_reports_the_in_flight_seconds(runs, mk):
    for got in runs[mk]:
        t = got["timing"]
        calls, nbytes, summed = t["all_to_all"]
        spans, _, wall = t["in_flight"]
        assert calls == 2 and nbytes == 2 * 64 * 1024 * 4, t
        assert spans == 1 and 0 < wall <= summed, t


def test_issue_order_posts_the_next_chunk_before_the_ffn():
    """Without processes: the list scheduler's order on a 2-chunk plan of
    every chunked schedule puts chunk 1's dispatch AlltoAll before chunk
    0's expert FFN, and on one rank (every group of one member) the
    overlapped layer is ``torch.equal`` the serial one and posts
    nothing."""
    from repro_torch.core import executor
    from repro_torch.core.gating import GateConfig
    from repro_torch.core.moe import MoEConfig, apply_moe
    from repro_torch.core.plan import build_plan, validate
    from repro_torch.core.schedules import MoEShardInfo
    from repro_torch.parallel import comm
    info = MoEShardInfo(("ep",), ("esp",), ("mp",), 2, 2, 2, 64, 16,
                        GateConfig(n_experts=8, top_k=2), pipeline_chunks=2)
    for sched in ("s1", "s2", "s2h", "s1g", "baseline"):
        names = [s.name for s in executor.issue_order(
            validate(build_plan(sched, info)))]
        assert names.index("a2a_d@1") < names.index("ffn@0"), (sched, names)
        assert sorted(names) == sorted(
            s.name for s in build_plan(sched, info).stages)
    inp = _inputs()
    events = []
    comm.set_hook(lambda *ev: events.append(ev))
    try:
        for sched, chunks in (("s1", 2), ("s2", 1), ("s1g", 2)):
            cfg = MoEConfig(d_model=M, d_ff=F, n_experts=E, top_k=K,
                            schedule=sched, pipeline_chunks=chunks)
            outs = []
            for serial in (False, True):
                x = torch.from_numpy(inp["x"]).requires_grad_()
                p = {k: torch.from_numpy(inp[k]).requires_grad_()
                     for k in GRADS[1:]}
                with (executor.serial_issue() if serial
                      else contextlib.nullcontext()):
                    y, aux = apply_moe(x, p, cfg=cfg)
                g = torch.autograd.grad((y * torch.from_numpy(
                    inp["r"])).sum(), [x, *p.values()])
                outs.append((y.detach(), *[aux[k] for k in sorted(aux)],
                             *g))
            for a, b in zip(*outs):
                assert torch.equal(a, b), sched
    finally:
        comm.set_hook(None)
    assert events == []


def test_overlap_times_runs_on_the_cpu(runs):
    """``launch.overlap_times``' rank function on the merged mesh's
    ranks, on the CPU: both issue modes timed, the pairs as asked."""
    for got in runs["merged"]:
        ov, se = got["overlap_times"]["s2x1"]
        assert len(ov) == len(se) == 2 and min(ov + se) > 0
