"""The port's dry run on the meta device (``repro_torch.launch.dryrun``,
``analysis/``, ZeRO-1's specs) against JAX's ``repro.launch.dryrun`` on
the 8-device test mesh.

JAX's dry run runs in ONE subprocess (its module sets ``XLA_FLAGS`` at
import: never in a pytest worker), this file run as a script, which
returns the records of ``COMBOS`` (``lower_one``, reduced, 8 x 64 or
8 x 256 tokens, ``--dump-plan``), JAX's ZeRO-1 ``opt_state_specs`` of
the two combos that have them, and JAX's ``variant_config`` and
``input_specs``.  JAX prices schedules at a TPU v5e's figures and the
port at an H100's (``core/perfmodel.py``), so the subprocess swaps JAX's
default cost model for the port's ``h100_model``, field by field: both
picks then answer the same question.  The port traces each combination
in this process (its fake ``torch.distributed`` world comes and goes per
call) while the subprocess runs.

Held equal: ``n_params``, ``n_active_params``, ``tokens_per_step``,
``schedule``, ``pipeline_chunks``, ``wire_dtype``, ``plan``, each
record's ``argument_size_in_bytes`` (this rank's parameters, AdamW state
under ZeRO-1 and batch), the ZeRO-1 specs leaf by leaf, and the
baseline / s1 ratio of AlltoAll bytes ("PauseMP divides dispatch volume
by N_MP").  Not compared: FLOPs, bytes, temporaries and collective
counts (XLA's fused program and the port's eager one differ there by
design).
"""

import json
import math
import os
import resource
import subprocess
import sys
from dataclasses import replace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (arch, shape, mesh, schedule, seq) at --reduced --batch 8
COMBOS = [("qwen1.5-0.5b", "train_4k", "single", None, 64),
          ("qwen3-moe-30b-a3b", "train_4k", "single", None, 64),
          ("qwen3-moe-30b-a3b", "train_4k", "multi", None, 64),
          ("qwen3-moe-30b-a3b", "prefill_32k", "single", "baseline", 256),
          ("qwen3-moe-30b-a3b", "prefill_32k", "single", "s1", 256),
          ("hymba-1.5b", "train_4k", "single", None, 64),
          ("xlstm-350m", "train_4k", "single", None, 64)]
#: the recurrent and encoder-decoder archs' full-size shapes whose JAX
#: records on the 8-device test mesh (``lower_one``, the records
#: ``repro.launch.dryrun`` saves as
#: ``artifacts/dryrun/<arch>__<shape>__single.json``) the port's are held
#: to
JAX_ARTIFACTS = {"hymba-1.5b": "long_500k", "xlstm-350m": "decode_32k",
                 "whisper-tiny": "decode_32k"}
#: the combinations JAX skips, whose records the port's equal
SKIPPED = (("whisper-tiny", "long_500k"),)
#: ZeRO-1 cases: (arch, multi_pod) -> JAX's rule's axes
ZERO = {("qwen1.5-0.5b", False): ("data",),
        ("qwen3-moe-30b-a3b", True): ("pod",)}
#: the archs whose inputs carry ``ctx_embeds`` (vlm, audio)
CTX_ARCHS = ("llama-3.2-vision-11b", "whisper-tiny")
INT_FIELDS = ("n_params", "n_active_params", "tokens_per_step", "schedule",
              "pipeline_chunks", "wire_dtype", "plan", "chips", "variant")


def _key(arch, shape, mesh, sched):
    return f"{arch}|{shape}|{mesh}|{sched}"


def _entries(spec, ndim):
    """A spec as JSON: one entry per dim, None or the list of its axes."""
    out = []
    for e in list(spec) + [None] * (ndim - len(spec)):
        out.append(None if e is None else [e] if isinstance(e, str)
                   else list(e))
    return out


# --- JAX's side, run as a script ----------------------------------------------

def _jax_main(path):
    os.environ["REPRO_DRYRUN_DEVICES"] = "8"
    import dataclasses

    import jax
    import repro.core.autosched as jas
    import repro.launch.dryrun as jdry
    from jax.sharding import PartitionSpec
    from repro.configs import get_config, input_specs
    from repro.configs.base import INPUT_SHAPES
    from repro.core import perfmodel as jperf
    from repro.launch.mesh import dims_for, make_test_mesh
    from repro.models import build_model
    from repro.optim.adamw import opt_state_specs
    from repro_torch.core.perfmodel import h100_model

    def h100_for_jax(n_ep, n_esp, n_mp, *a, **kw):
        m = h100_model(n_ep, n_esp, n_mp)

        def conv(v):
            if hasattr(v, "alpha"):
                return jperf.AlphaBeta(alpha=v.alpha, beta=v.beta)
            return v
        return jperf.PerfModel(**{f.name: conv(getattr(m, f.name))
                                  for f in dataclasses.fields(m)})
    jas.tpu_v5e_model = h100_for_jax

    out = {"records": {}, "zero": {}, "variant": {}, "inputs": {},
           "full": {}, "skipped": {}}
    for arch, shape in JAX_ARTIFACTS.items():
        rec = jdry.lower_one(arch, shape, False)
        out["full"][arch] = {k: rec[k] for k in (
            "chips", "n_params", "tokens_per_step", "memory_analysis",
            "collectives")}
    for arch, shape in SKIPPED:
        out["skipped"][f"{arch}|{shape}"] = jdry.lower_one(arch, shape,
                                                           False)
    for arch, shape, mesh, sched, seq in COMBOS:
        rec = jdry.lower_one(arch, shape, mesh == "multi", sched,
                             reduced=True, seq=seq, batch_size=8,
                             dump_plan=True)
        out["records"][_key(arch, shape, mesh, sched)] = {
            **{f: rec[f] for f in INT_FIELDS},
            "memory_analysis": rec["memory_analysis"],
            "collectives": rec["collectives"]}
    for (arch, multi), axes in ZERO.items():
        cfg = replace(get_config(arch).reduced(), dtype="bfloat16")
        mesh = make_test_mesh(multi_pod=multi)
        dims = dims_for(cfg, multi)
        model = build_model(cfg)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        mu = opt_state_specs(model.specs(mesh, dims), mesh=mesh,
                             dp_axes=axes, zero1=True,
                             params_shape=shapes)["mu"]
        flat, _ = jax.tree_util.tree_flatten_with_path(
            mu, is_leaf=lambda x: isinstance(x, PartitionSpec))
        shp = dict((tuple(k.key for k in p), s.ndim) for p, s in
                   jax.tree_util.tree_flatten_with_path(shapes)[0])
        out["zero"][f"{arch}|{multi}"] = {
            "/".join(k.key for k in p): _entries(s, shp[tuple(
                k.key for k in p)]) for p, s in flat}
    for arch in ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"):
        cfg, variant = jdry.variant_config(get_config(arch), "long_500k")
        out["variant"][arch] = [variant, cfg.attn_window]
    for arch in ("qwen3-moe-30b-a3b",) + CTX_ARCHS:
        for name, shape in INPUT_SHAPES.items():
            specs = input_specs(get_config(arch), shape)
            out["inputs"][f"{arch}|{name}"] = {
                k: [list(v.shape), str(v.dtype)] for k, v in specs.items()}
    with open(path, "w") as f:
        json.dump(out, f)


# --- the port's side ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's records, from the subprocess started here (it runs while the
    port's combinations are traced)."""
    from conftest import subprocess_env
    path = tmp_path_factory.mktemp("jax_dryrun") / "records.json"
    env = subprocess_env(8)
    env["REPRO_DRYRUN_DEVICES"] = "8"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(path)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def result():
        if not hasattr(result, "value"):
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, (out + err)[-4000:]
            with open(path) as f:
                result.value = json.load(f)
        return result.value
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port_records(jax_run):
    """The port's record of every combination (``dry_one``), traced on
    the 8-rank test mesh (``test_mesh=True``: JAX's
    ``REPRO_DRYRUN_DEVICES=8``)."""
    from repro_torch.launch import dryrun
    return {_key(arch, shape, mesh, sched): dryrun.dry_one(
        arch, shape, mesh == "multi", sched, reduced=True, seq=seq,
        batch_size=8, dump_plan=True, test_mesh=True)
        for arch, shape, mesh, sched, seq in COMBOS}


def test_full_size_trace_allocates_nothing(jax_run):
    """qwen3-moe-30b-a3b decode_32k at full size on the 16x16 production
    mesh, its cache's W split (phase 14 (b); (a)'s train_4k traces ~4x
    longer and runs on the card), traced as rank 0 on the meta device: a
    record with JAX's keys whose rank holds gigabytes of parameters and
    cache, while this process's peak resident memory grows by less than
    1 GB.  (Asks for ``jax_run`` only to start JAX's subprocess first.)"""
    from repro_torch.launch import dryrun
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = dryrun.dry_one("qwen3-moe-30b-a3b", "decode_32k", False,
                         cache_seq_shard=True)
    grew_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    mem = rec["memory_analysis"]
    assert rec["chips"] == 256 and rec["zero1_axes"] == []
    assert mem["argument_size_in_bytes"] > 2e9 and mem["cache_bytes"] > 1e9
    assert mem["argument_size_in_bytes"] == (
        mem["params_bytes"] + mem["cache_bytes"] + mem["batch_bytes"])
    assert mem["temp_size_in_bytes"] > 0 and rec["fits_80gb"]
    assert grew_kb < 1e6, grew_kb
    for key in ("arch", "shape", "mesh", "variant", "schedule",
                "pipeline_chunks", "wire_dtype", "placement", "plan",
                "audit", "step_metrics", "robustness", "chips", "dtype",
                "n_params", "n_active_params", "tokens_per_step",
                "memory_analysis", "cost_flops", "cost_bytes",
                "collectives", "roofline", "fits_80gb", "trace_s"):
        assert key in rec, key
    rl = rec["roofline"]
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert rl["t_compute_s"] > 0 and rl["t_memory_s"] > 0 \
        and rl["t_collective_s"] > 0
    assert rec["kernels"]["rmsnorm"][0] > 0
    assert rec["n_params"] > 3e10 and rec["tokens_per_step"] == 128


@pytest.mark.parametrize("combo", COMBOS,
                         ids=lambda c: f"{c[0]}-{c[2]}-{c[3] or 'auto'}")
def test_record_is_jaxs(combo, port_records, jax_run):
    """The integer and plan fields and the arguments' bytes equal JAX's."""
    key = _key(*combo[:4])
    got, want = port_records[key], jax_run()["records"][key]
    for f in INT_FIELDS:
        assert got[f] == want[f], (f, got[f], want[f])
    assert got["memory_analysis"]["argument_size_in_bytes"] \
        == want["memory_analysis"]["argument_size_in_bytes"]
    assert got["memory_analysis"]["temp_size_in_bytes"] > 0


def _state_saving(arch, shape_name):
    """The bytes of this rank's recurrent state that JAX's record holds
    and the port's does not: the half of each MP-split state leaf that
    the other MP rank holds (``train.cache_specs``), from the shapes at
    B / 4 rows (``data`` 4 of the 4 x 2 test mesh, where B divides)."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    B = shape.global_batch // 4 if shape.global_batch % 4 == 0 else \
        shape.global_batch
    layers = {k: 0 for k in ("hymba", "mlstm")}
    for kind, n in cfg.runs():
        if kind in layers:
            layers[kind] += n
    Di, N, C = int(cfg.d_model * cfg.ssm_expand), cfg.ssm_state, cfg.ssm_conv
    H, hd = cfg.n_kv_heads, 2 * cfg.d_model // cfg.n_kv_heads   # mLSTM
    bf16, f32 = 2, 4
    mamba = layers["hymba"] * B * (C * Di * bf16 + Di * N * f32)
    mlstm = layers["mlstm"] * B * H * (hd * hd + hd + 1) * f32
    return (mamba + mlstm) // 2


def _kv_saving(arch, shape_name):
    """whisper-tiny's: the half of the self-attention K/V and of
    ``ctx_kv`` whose kv heads the other MP rank holds (JAX's are
    replicated over MP), at B / 4 rows."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    rows, bf16 = shape.global_batch // 4, 2
    per_pos = 2 * cfg.n_layers * rows * cfg.n_kv_heads * cfg.hd * bf16
    return per_pos * shape.seq_len // 2, per_pos * cfg.encoder_seq // 2


def _unread_at_decode(arch, shape_name):
    """The bytes of this rank's arguments that a whisper decode step never
    reads, which JAX's jit drops and the port's record counts: the
    batch's ``ctx_embeds`` (``ctx_kv`` stands for them), the encoder's
    and ``enc_norm``'s parameters and the ``xattn`` kv projections, at
    their shards on rank 0 of the 4 x 2 test mesh."""
    from repro_torch.analysis.layerwise import full_param_shapes
    from repro_torch.launch.dryrun import build_config
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.sharding import local_shape
    cfg, shape, _ = build_config(arch, shape_name)      # bf16, as traced
    mesh = Mesh((4, 2), ("data", "model"), 0, groups=False)
    full = full_param_shapes(cfg)
    specs = Model(cfg, "meta").param_specs(full, mesh, dims_for(cfg))
    unread = [(full[k], specs[k]) for k in ("encoder", "enc_norm")]
    unread += [(full["run0"]["xattn"][k], specs["run0"]["xattn"][k])
               for k in ("wk", "wv")]
    n = sum(math.prod(local_shape(t.shape, s, mesh)) * t.element_size()
            for tree, stree in unread
            for t, s in zip(leaves(tree) if isinstance(tree, dict)
                            else [tree],
                            leaves(stree) if isinstance(stree, dict)
                            else [stree]))
    ctx = shape.global_batch // 4 * cfg.encoder_seq * cfg.d_model * 2
    return n + ctx


@pytest.mark.parametrize("arch", list(JAX_ARTIFACTS))
def test_full_size_decode_is_jaxs_less_the_split_states(arch, jax_run):
    """hymba-1.5b ``long_500k``, xlstm-350m and whisper-tiny
    ``decode_32k`` at full size on the 8-rank test mesh against JAX's
    records of them (made in the subprocess, as ``artifacts/dryrun`` keeps
    them): ``n_params`` and ``tokens_per_step`` equal; the arguments JAX's
    less the state bytes the port shards over MP (hymba: half of
    ``conv_buf`` and ``h``, 3,686,400 B; xlstm: half of mLSTM's ``C``,
    ``n``, ``m``, ~1.41 GB; whisper: half of the self-attention K/V,
    3,221,225,472 B, and of ``ctx_kv``, 147,456,000 B, the kv heads kept
    over MP), plus what JAX's jit drops as unread: the 4 bytes of the
    ``step`` scalar where no layer reads a position (xlstm), and at
    whisper's decode step the batch's ``ctx_embeds``, the encoder's
    parameters and the ``xattn`` kv projections (36,864,000 + 8,299,008
    B).  At xlstm ``decode_32k`` no collective carries a state leaf: all
    of them move less than one layer's ``C`` shard, and the AllGathers
    under 1% of JAX's 2.83 GB; at whisper's none carries K or V: the
    AllGathers under 1% of JAX's 12.9 GB.  whisper ``long_500k`` is
    JAX's skip record."""
    from repro_torch.launch import dryrun
    shape = JAX_ARTIFACTS[arch]
    got = dryrun.dry_one(arch, shape, False, test_mesh=True)
    want = jax_run()["full"][arch]
    assert got["chips"] == want["chips"] == 8
    for k in ("n_params", "tokens_per_step"):
        assert got[k] == want[k], k
    unused = 4 if arch == "xlstm-350m" else 0
    if arch == "hymba-1.5b":
        saving = _state_saving(arch, shape)
        assert saving == 3_686_400
    elif arch == "xlstm-350m":
        saving = _state_saving(arch, shape)
        assert 1.40e9 < saving < 1.42e9
    else:
        kv, ctx = _kv_saving(arch, shape)
        assert (kv, ctx) == (3_221_225_472, 147_456_000)
        saving = kv + ctx
        unused = _unread_at_decode(arch, shape)
        assert unused == 36_864_000 + 8_299_008
        assert want["memory_analysis"]["argument_size_in_bytes"] \
            == 6_802_283_908
        assert got["n_params"] == 36_472_704 \
            and got["tokens_per_step"] == 128
        assert got["collectives"]["bytes"].get("all-gather", 0) \
            < 0.01 * want["collectives"]["bytes"]["all-gather"]
        assert want["collectives"]["bytes"]["all-gather"] == 12_884_901_888
        for arch_, shape_ in SKIPPED:
            assert dryrun.dry_one(arch_, shape_, False, test_mesh=True) \
                == jax_run()["skipped"][f"{arch_}|{shape_}"]
    assert got["memory_analysis"]["argument_size_in_bytes"] == \
        want["memory_analysis"]["argument_size_in_bytes"] - saving \
        + unused
    if arch == "xlstm-350m":
        c_shard = 32 * 2 * 512 * 512 * 4
        assert got["collectives"]["total_bytes"] < c_shard
        assert got["collectives"]["bytes"]["all-gather"] \
            < 0.01 * want["collectives"]["bytes"]["all-gather"]
        assert want["collectives"]["bytes"]["all-gather"] == 2_825_661_440


def test_baseline_alltoall_over_s1_is_jaxs(port_records, jax_run):
    """baseline runs an ESP AllReduce; its AlltoAll bytes over s1's are
    JAX's ratio (S1 divides the dispatch volume by N_MP)."""
    def a2a(recs, sched):
        return recs[_key("qwen3-moe-30b-a3b", "prefill_32k", "single",
                         sched)]["collectives"]
    base, s1 = a2a(port_records, "baseline"), a2a(port_records, "s1")
    jb, js = a2a(jax_run()["records"], "baseline"), \
        a2a(jax_run()["records"], "s1")
    assert base["counts"].get("all-reduce", 0) > 0
    assert base["bytes"]["all-to-all"] / s1["bytes"]["all-to-all"] \
        == jb["bytes"]["all-to-all"] / js["bytes"]["all-to-all"] == 2.0
    assert s1["total_bytes"] < base["total_bytes"]


@pytest.mark.parametrize("arch,multi", list(ZERO),
                         ids=[f"{a}-{'multi' if m else 'single'}"
                              for a, m in ZERO])
def test_zero1_specs_are_jaxs(arch, multi, jax_run):
    """``opt_state_specs(..., zero1=True)`` leaf by leaf (JAX's tree comes
    with sorted keys: compared by path), over the axes the dry run picks
    for the combo."""
    from repro_torch.analysis.layerwise import full_param_shapes
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import zero_axes_for
    from repro_torch.launch.mesh import dims_for, make_test_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import opt_state_specs
    cfg = replace(get_config(arch).reduced(), dtype="bfloat16")
    mesh = make_test_mesh(multi_pod=multi)
    dims = dims_for(cfg, multi)
    axes = zero_axes_for(cfg, dims, multi)
    assert axes == ZERO[(arch, multi)]
    full = full_param_shapes(cfg)
    mu = opt_state_specs(Model(cfg, "meta").param_specs(full, mesh, dims),
                         mesh, axes, True, full)["mu"]

    def flat(tree, shapes, path=()):
        if isinstance(tree, dict):
            return {k: v for name in tree for k, v in
                    flat(tree[name], shapes[name], path + (name,)).items()}
        return {"/".join(path): _entries(tree, shapes.dim())}
    want = jax_run()["zero"][f"{arch}|{multi}"]
    got = flat(mu, full)
    assert got == want
    assert any(axes[0] in (e or []) for es in got.values() for e in es)


def test_zero1_axes_follow_jaxs_rule():
    """No ZeRO-1 for a MoE arch on the single-pod mesh, ``pod`` on the
    multi-pod one; ``data`` for a dense single-pod arch, ``pod`` + ``data``
    multi-pod."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import zero_axes_for
    from repro_torch.launch.mesh import dims_for
    moe, dense = get_config("qwen3-moe-30b-a3b"), get_config("qwen1.5-0.5b")
    assert zero_axes_for(moe, dims_for(moe, False), False) == ()
    assert zero_axes_for(moe, dims_for(moe, True), True) == ("pod",)
    assert zero_axes_for(dense, dims_for(dense, False), False) == ("data",)
    assert zero_axes_for(dense, dims_for(dense, True), True) \
        == ("pod", "data")


def test_variant_and_inputs_are_jaxs(jax_run):
    """``variant_config``: long_500k on a full-attention arch runs the
    8192-token window; llama4's chunked attention is sub-quadratic as it
    is.  ``input_specs``: JAX's keys, shapes and dtypes, on the meta
    device, the vlm and audio archs' ``ctx_embeds`` among them."""
    from repro_torch.configs import (INPUT_SHAPES, get_config, input_specs,
                                     variant_config)
    want = jax_run()
    for arch, (variant, window) in want["variant"].items():
        cfg, got = variant_config(get_config(arch), "long_500k")
        assert (got, cfg.attn_window) == (variant, window)
    for arch in ("qwen3-moe-30b-a3b",) + CTX_ARCHS:
        for name, shape in INPUT_SHAPES.items():
            specs = input_specs(get_config(arch), shape)
            assert all(t.is_meta for t in specs.values())
            assert {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                    for k, v in specs.items()} == \
                want["inputs"][f"{arch}|{name}"]
            assert ("ctx_embeds" in specs) == (arch in CTX_ARCHS)


def test_decode_long_500k_traces_the_swa_variant():
    """long_500k on qwen3 (reduced, 256 positions): the SWA variant's
    decode step through a W-split cache traces, its argument bytes the
    parameters, the cache and the one-token batch."""
    from repro_torch.launch import dryrun
    rec = dryrun.dry_one("qwen3-moe-30b-a3b", "long_500k", False,
                         reduced=True, seq=256, cache_seq_shard=True,
                         test_mesh=True)
    mem = rec["memory_analysis"]
    assert rec["variant"] == "swa+reduced" and rec["tokens_per_step"] == 1
    assert mem["cache_bytes"] > 0
    assert mem["argument_size_in_bytes"] == (
        mem["params_bytes"] + mem["cache_bytes"] + mem["batch_bytes"])


def test_assigned_is_jaxs_order_cut_to_the_port():
    """``ASSIGNED`` is JAX's, and the registry lists every JAX arch in
    JAX's order."""
    from repro.configs.registry import ASSIGNED as J_ASSIGNED
    from repro.configs.registry import _MODULES as J_MODULES
    from repro_torch.configs import ASSIGNED
    from repro_torch.configs.registry import _MODULES
    assert ASSIGNED == J_ASSIGNED
    assert list(_MODULES) == list(J_MODULES)
    assert len(ASSIGNED) == 10


def test_refusals(capsys, monkeypatch):
    """The cross-attention archs, which the port ran on one rank only
    before, trace on a mesh: ``dry_one`` gives a record
    (llama-3.2-vision-11b ``train_4k``, reduced, on the 4 x 2 test mesh:
    its 4 query heads do not divide over 16) and the CLI's ``--arch
    whisper-tiny --shape decode_32k`` (the 16x16 production mesh) exits 0
    with its ``[ok]`` line; an unknown arch fails with the registry's
    error; ``--save-hlo`` is refused."""
    from repro_torch.launch import dryrun
    rec = dryrun.dry_one("llama-3.2-vision-11b", "train_4k", False,
                         reduced=True, seq=64, batch_size=8, test_mesh=True)
    assert rec["chips"] == 8 and rec["variant"] == "reduced"
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    saved = []
    monkeypatch.setattr(dryrun, "save", lambda rec, sfx="": saved.append(
        rec) or "")
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k"])
    out = capsys.readouterr().out
    assert "[ok]   whisper-tiny x decode_32k x single" in out
    assert "dry-run complete" in out
    assert [r["arch"] for r in saved] == ["whisper-tiny"]
    assert saved[0]["memory_analysis"]["ctx_kv_bytes"] > 0
    with pytest.raises(KeyError, match="unknown arch 'llama-5'"):
        dryrun.dry_one("llama-5", "train_4k", False)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gpt2-moe", "--save-hlo"])
    assert e.value.code == 2
    assert "no HLO" in capsys.readouterr().err


def test_layerwise_costs_keeps_jaxs_signature():
    """``layerwise_costs`` on a one-rank mesh: JAX's four keys, the
    whole step counted (the backward's kernels beside the forward's)."""
    from repro_torch.analysis.layerwise import layerwise_costs
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models.model import Model
    from repro_torch.parallel.mesh import Mesh
    cfg = get_config("gpt2-moe").reduced()
    shape = replace(INPUT_SHAPES["train_4k"], seq_len=32, global_batch=2)
    costs = layerwise_costs(Model(cfg, "meta"), cfg,
                            Mesh((1, 1), ("data", "model")), dims_for(cfg),
                            shape, kind="train")
    assert costs["flops"] > 0 and costs["bytes"] > 0
    assert costs["coll"] == 0 and costs["coll_by_kind"] == {}
    assert costs["kernels"]["flash_attention.bwd"][0] > 0
    assert math.isfinite(costs["flops"])


def test_the_fake_backend_belongs_to_the_dry_run():
    """Only ``launch/mesh.py`` imports the fake backend and only
    ``launch/dryrun.py`` starts it; the launchers' backends stay nccl and
    gloo."""
    from repro_torch.launch.mesh import BACKENDS
    assert BACKENDS == ("nccl", "gloo")
    src = os.path.join(ROOT, "src", "repro_torch")
    imports, starts = [], []
    for d, _, files in os.walk(src):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    text = fh.read()
                rel = os.path.relpath(path, src)
                if "fake_pg" in text:
                    imports.append(rel)
                if "fake_world(" in text and not rel.endswith("mesh.py"):
                    starts.append(rel)
    assert imports == [os.path.join("launch", "mesh.py")]
    assert starts == [os.path.join("launch", "dryrun.py")]


if __name__ == "__main__":
    _jax_main(sys.argv[1])
