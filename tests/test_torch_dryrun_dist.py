"""The dry run's real runs on the test mesh: 8 gloo ranks on the CPU, in
ONE spawn (``launch.mesh.spawn``), each running on the 4x2 mesh:

  * ``--run-step --guards --audit`` on reduced gpt2-moe (``train_4k`` at
    8 x 64, float32, the drop-free capacity factor: with drops each
    rank's pool would drop other tokens than one rank's whole pool does):
    ``dryrun.run_rank``'s guarded step, whose loss is
    within 1e-4 of one rank's ``make_train_step`` on the same parameters
    (``Model.init`` at seed 0) and batch (zeros), ``nonfinite`` 0, and
    one audit report per ``DEFAULT_AUDIT_SCHEDULES`` schedule;
  * ZeRO-1 on reduced qwen1.5-0.5b (moments over ``data``): the
    parameters after the step ``torch.equal`` to the step with whole
    moments on every rank, and each rank's moment bytes the meta
    record's (``memory_analysis["moments_bytes"]``).

``dry_one``'s record of the first is then built from those ranks'
results (``run_on_ranks`` returns them): ``[step]`` printed,
``step_metrics``, ``robustness`` and ``audit`` filled.  No JAX: the
reference is one rank of the port (JAX's own ``--run-step`` is
``tests/test_pipeline.py::TestAutoTrainsEndToEnd``).
"""

import os
from dataclasses import replace

import pytest
import torch

pytestmark = pytest.mark.multirank

GPT2 = ("gpt2-moe", "train_4k")
QWEN = ("qwen1.5-0.5b", "train_4k")


def _combo(arch, shape_name):
    """The combo's config (reduced, float32, 8 x 64 tokens); a MoE arch
    at the drop-free capacity factor E / k, so that each rank's pool keeps
    every token and the ranks compute what one rank does."""
    from repro_torch.launch.dryrun import build_config
    cfg, shape, _ = build_config(arch, shape_name, dtype="float32",
                                 reduced=True, seq=64, batch_size=8)
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg, shape


def _rank(rank, jobs):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dims_for, make_test_mesh
    from repro_torch.optim.adamw import AdamWConfig, leaves
    from repro_torch.train.loop import make_train_step
    out = {"gpt2": dryrun.run_rank(rank, jobs["gpt2"])}
    cfg, shape = _combo(*QWEN)
    mesh = make_test_mesh()
    dims = dims_for(cfg)
    stepped = {}
    for zero in ((), ("data",)):
        model, params, opt, batch = dryrun.rank_state(
            cfg, shape, mesh, dims, torch.device("cpu"), zero)
        make_train_step(model, AdamWConfig(), None, mesh, dims,
                        zero)(params, opt, batch)
        stepped[zero] = (leaves(params), opt)
    p_whole, p_zero = stepped[()][0], stepped[("data",)][0]
    out["zero_equal"] = all(torch.equal(a, b)
                            for a, b in zip(p_whole, p_zero))
    opt_z, opt_w = stepped[("data",)][1], stepped[()][1]
    out["moment_bytes"] = sum(t.numel() * t.element_size() for t in
                              leaves(opt_z["mu"]) + leaves(opt_z["nu"]))
    out["whole_moment_bytes"] = sum(
        t.numel() * t.element_size() for t in
        leaves(opt_w["mu"]) + leaves(opt_w["nu"]))
    return out


@pytest.fixture(scope="module")
def ranks():
    from repro_torch.launch.dryrun import TEST_RANKS, zero_axes_for
    from repro_torch.launch.mesh import dims_for, spawn
    cfg, shape = _combo(*GPT2)
    job = {"cfg": cfg, "shape": shape, "multi_pod": False, "schedule": None,
           "zero_axes": zero_axes_for(cfg, dims_for(cfg), False),
           "guards": True, "run_step": True, "audit": True, "device": "cpu"}
    threads = max(1, (os.cpu_count() or 1) // TEST_RANKS)
    return spawn(_rank, TEST_RANKS, {"gpt2": job}, backend="gloo",
                 device="cpu", threads=threads, timeout=600)


def test_run_step_loss_is_one_ranks(ranks):
    """The 8-rank guarded step's loss within 1e-4 of one rank's plain step
    on the same parameters and batch (the clean guarded step is the plain
    one), nothing non-finite."""
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.loop import make_train_step
    cfg, shape = _combo(*GPT2)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.zeros((shape.global_batch, shape.seq_len),
                            dtype=torch.int32) for k in ("tokens", "labels")}
    _, _, m = make_train_step(model, AdamWConfig())(
        params, adamw_init(params), batch)
    want = float(m["loss"])
    for r in ranks:
        got = r["gpt2"]["step_metrics"]
        assert abs(got["loss"] - want) <= 1e-4, (got["loss"], want)
        assert got["nonfinite"] == 0.0
        assert got["loss"] == ranks[0]["gpt2"]["step_metrics"]["loss"]


def test_audit_reports_every_schedule(ranks):
    from repro_torch.obs.audit import DEFAULT_AUDIT_SCHEDULES
    reps = ranks[0]["gpt2"]["audit"]
    assert [r["schedule"] for r in reps] == list(DEFAULT_AUDIT_SCHEDULES)
    for rep in reps:
        assert rep["total_measured_s"] > 0 and rep["total_predicted_s"] > 0
        assert rep["stages"]


def test_zero1_step_is_the_whole_moment_step(ranks):
    """On every rank: the ZeRO-1 step's parameters ``torch.equal`` to the
    step with whole moments, its moments a quarter of theirs or less (the
    leaves split over data=4), and their bytes the meta record's."""
    from repro_torch.launch import dryrun
    rec = dryrun.dry_one(*QWEN, False, dtype="float32", reduced=True,
                         seq=64, batch_size=8, test_mesh=True)
    assert rec["zero1_axes"] == ["data"]
    for r in ranks:
        assert r["zero_equal"]
        assert r["moment_bytes"] == rec["memory_analysis"]["moments_bytes"]
        assert r["moment_bytes"] * 3 < r["whole_moment_bytes"]


def test_dry_one_records_the_ranks(ranks, monkeypatch, capsys):
    """``dry_one(run_step=True, guards=True, audit=True)`` records rank
    0's metrics, the guard outcome, the audit and every rank's moment
    bytes, and prints the ``[step]`` line (the ranks' results are the
    spawn's above, at the drop-free capacity: only the plumbing is
    checked here)."""
    from repro_torch.launch import dryrun
    calls = []
    monkeypatch.setattr(dryrun, "run_on_ranks", lambda job, device:
                        calls.append((job, device)) or
                        [r["gpt2"] for r in ranks])
    rec = dryrun.dry_one(*GPT2, False, dtype="float32", reduced=True,
                         seq=64, batch_size=8, run_step=True, guards=True,
                         audit=True, device="cpu", test_mesh=True)
    (job, device), = calls
    assert device == "cpu" and job["guards"] and job["run_step"]
    assert job["cfg"] == dryrun.build_config(
        *GPT2, dtype="float32", reduced=True, seq=64, batch_size=8)[0]
    assert rec["step_metrics"] == ranks[0]["gpt2"]["step_metrics"]
    assert rec["robustness"] == {"guards": True, "nonfinite": 0.0,
                                 "lr_scale": 1.0}
    assert rec["audit"] == ranks[0]["gpt2"]["audit"]
    assert rec["rank_moment_bytes"] == [r["gpt2"]["moment_bytes"]
                                        for r in ranks]
    out = capsys.readouterr().out
    assert f"[step] gpt2-moe x train_4k sched={rec['schedule']}" in out
    assert "loss=" in out and out.count("[audit]") == 3
