"""The train steps and the loop that runs them (counterpart of
``make_train_step``, ``make_guarded_train_step`` and ``Trainer`` in
``repro/train/loop.py``), on one device or on a mesh of ranks.

``Trainer(..., mesh=, dims=)`` trains across ranks as the JAX Trainer does
on its ``(data, model)`` mesh: every rank initialises the full parameters
from one seed and keeps its shards (``Model.param_specs``: the experts
over EP and ESP, the dense layers Megatron-style over MP), takes its rows
of every batch, and all-reduces the gradients of the leaves it shares
with ranks that hold other tokens, and those its MP ranks hold in part
(:func:`sync_grads`), before AdamW updates its shards in place.  The
guarded loop, its checkpoints, faults and telemetry run there too: the
non-finite flag comes from the global loss and norm, every rank's guard
decision is all-gathered and held equal (a rank that decides otherwise
makes every rank raise, never hang), snapshots are JAX's whole-array
files gathered from the shards, and the fp8 saturation counts and the
telemetry are the world's, written by rank 0.

``Trainer(guards=...)`` runs the fault-tolerant loop: the guarded step
(skip-step and LR backoff), retained-checkpoint rollback through
``ckpt_path``, the fp8 wire-overflow fallback and the ``faults``
injection hooks.  With a telemetry sink installed (``repro_torch.obs``)
both loops set the runtime context's ``step`` and emit one ``train_step``
event per history row, the guarded loop its ``guard_skip``,
``guard_rollback`` and ``fp8_fallback`` events, and both the fp8 encodes'
``fp8_sat`` events, as the JAX loop does; every field is a value the loop
already holds on the host.

Load-adaptive expert placement, as in JAX: each step's per-expert routed
rows (the ``expert_load`` metric) feed a load EMA (``load_imbalance`` in
the history; an ``expert_load`` event beside each ``train_step`` event
once it is live), and with ``placement="auto"`` and ``rebalance_every=N``
every N steps
``autosched.maybe_rebalance`` scores a placement derived from the EMA
against uniform; on a win it installs it (a ``train_rebalance`` event) and
the next step's MoE layers (``MoEConfig(placement="auto")``) run it.
Nothing is retraced; parameters and optimizer state stay logical, so
checkpoints are unchanged.  On a mesh every rank holds the same EMA (the
loads are the world's mean) and is held to the same placement.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.models.model import Model
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     leaves, opt_state_specs, zero1_dims)
from repro_torch.runtime import guards as guardlib

_ACTIONS = (guardlib.OK, guardlib.SKIP, guardlib.ROLLBACK)
#: at most this many bytes of gradients in one ``psum`` of
#: :func:`sync_grads` (a leaf above it goes alone)
SYNC_BUCKET_BYTES = 1 << 28


def sync_grads(grads, specs, mesh, dims, mp_partial=None):
    """Each leaf's gradient summed over the batch axes its spec does not
    mention (the ranks that hold other tokens and the same block), and
    over MP where ``mp_partial`` (aligned with ``grads``;
    ``Model.mp_partial``) says each MP rank holds only its part, one
    ``psum`` per distinct axis set over the leaves' flattened gradients,
    in buckets of at most ``SYNC_BUCKET_BYTES`` (a sum's bits do not
    depend on the bucket: each element adds the same sources in the same
    order), so a step holds one bucket's buffers beside the gradients;
    ``apply_moe``'s boundary and the Megatron operators
    (``parallel.tensor``) have already summed the other non-batch axes.
    So a replicated leaf ends with the global gradient on every rank, and
    a leaf sharded over EP, ESP or MP keeps its own block's.  Returns the
    list, aligned with ``grads``."""
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import mentioned
    batch = set(dims.batch_axes)
    buckets = {}
    for i, (g, spec) in enumerate(zip(grads, specs)):
        used = set(mentioned(spec))
        sum_over = batch | set(dims.mp) if mp_partial and mp_partial[i] \
            else batch
        axes = tuple(a for a in mesh.axis_names
                     if a in sum_over and a not in used)
        if axes and mesh.group(axes).size > 1:
            buckets.setdefault((axes, g.dtype), []).append(i)
    out = list(grads)
    split = []
    for (axes, _), idx in buckets.items():
        size = SYNC_BUCKET_BYTES
        for i in idx:
            nb = grads[i].numel() * grads[i].element_size()
            if size + nb > SYNC_BUCKET_BYTES:
                split.append((axes, []))
                size = 0
            split[-1][1].append(i)
            size += nb
    for axes, idx in split:
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        red = comm.psum(flat, mesh.group(axes))
        off = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = red[off:off + n].view_as(grads[i])
            off += n
    return out


def grads_of(loss, flat) -> list:
    """The gradient of ``loss`` for each tensor of ``flat``: zeros for one
    the loss does not reach, as ``jax.grad`` gives them (a ``cross``
    layer's ``attn`` and ``norm2``; the cross-attention layers' context
    side, whisper's encoder, without ``ctx_embeds``)."""
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, flat)]


def _loss_and_grads(model, params, batch, schedule, mesh, dims,
                    grad_fault=None):
    """``(loss, metrics, grads, specs)`` of one step: on a mesh the
    gradients through :func:`sync_grads` and ``specs`` the leaves' specs
    (None on one rank).  ``grad_fault`` seeds the loss as ``loss * (1 +
    grad_fault)``."""
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss, metrics = model.loss(params, batch, schedule=schedule, mesh=mesh,
                               dims=dims)
    if grad_fault is not None:
        loss = loss * (1.0 + grad_fault)
    grads = grads_of(loss, flat)
    specs = None
    if mesh is not None:
        specs = leaves(model.param_specs(params, mesh, dims))
        partial = leaves(model.mp_partial(params, mesh, dims,
                                          batch["tokens"].shape[1]))
        grads = sync_grads(grads, specs, mesh, dims, partial)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads, specs


def zero1_layout(model: Model, params, mesh, dims, zero_axes=()):
    """:func:`~repro_torch.optim.adamw.zero1_dims` of the ZeRO-1 moments
    over ``zero_axes`` (``opt_state_specs(..., zero1=True)``) for this
    rank's ``params``, aligned with their leaves; None without axes or
    mesh."""
    if not zero_axes or mesh is None:
        return None
    pspecs = model.param_specs(params, mesh, dims)
    mom = opt_state_specs(pspecs, mesh, tuple(zero_axes), True, params)
    return zero1_dims(leaves(pspecs), leaves(mom["mu"]))


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    schedule: Optional[str] = None, mesh=None, dims=None,
                    zero_axes=()):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: loss, gradients of every parameter, one AdamW update in
    place.  Metrics are the loss's (``ce``, ``aux``, ``ppl_proxy``,
    ``expert_load``) plus ``grad_norm``, ``lr`` and ``loss``, as tensors.

    On a mesh (``mesh``, ``dims``) ``params`` and ``opt_state`` are this
    rank's shards and ``batch`` its rows (``data.sharded_batch``): the loss
    is the global one, the gradients go through :func:`sync_grads`, and
    the clip norm is the global norm.  With ``zero_axes`` the moments are
    ZeRO-1's over those axes (:func:`zero1_layout`, ``adamw_init(zero=)``)
    and each rank updates its slice of every parameter, then all-gathers
    it: the same parameters as the unsharded-moment step."""
    def train_step(params, opt_state, batch):
        loss, metrics, grads, specs = _loss_and_grads(
            model, params, batch, schedule, mesh, dims)
        om = adamw_update(params, grads, opt_state, opt_cfg, specs=specs,
                          mesh=mesh, zero=zero1_layout(
                              model, params, mesh, dims, zero_axes))
        del grads
        return params, opt_state, {**metrics, **om, "loss": loss}
    return train_step


def make_guarded_train_step(model: Model, opt_cfg: AdamWConfig,
                            schedule: Optional[str] = None, mesh=None,
                            dims=None, zero_axes=()):
    """``make_train_step`` wrapped in guard rails: ``step(params,
    opt_state, batch, lr_scale, grad_fault)``.

    ``lr_scale`` (a float: the guard rails' LR backoff) multiplies the
    scheduled LR inside ``adamw_update``; ``grad_fault`` (a float: fault
    injection) seeds the loss as ``loss * (1 + grad_fault)``, so every
    gradient comes out scaled by ``1 + grad_fault`` through the chain
    rule; 0.0 is the exact identity and NaN / inf poisons every gradient.
    The reported loss is that product, as in JAX.  When the loss or the
    global grad norm is non-finite the update is skipped before it
    touches a leaf, so parameters, both moments and the step counter stay
    bitwise as they were; metrics gain a ``nonfinite`` flag that the
    host-side policy (``runtime.guards``) folds into its decision.  On
    the clean path (``lr_scale=1.0, grad_fault=0.0``) every extra op is
    an IEEE identity, so the step is bitwise the plain one.  On a mesh as
    ``make_train_step``: the loss and the norm are global, so the flag is
    the same bit on every rank; ``zero_axes`` as there."""
    def train_step(params, opt_state, batch, lr_scale, grad_fault):
        loss, metrics, grads, specs = _loss_and_grads(
            model, params, batch, schedule, mesh, dims, grad_fault)
        om = adamw_update(params, grads, opt_state, opt_cfg,
                          lr_scale=lr_scale, finite=torch.isfinite(loss),
                          specs=specs, mesh=mesh, zero=zero1_layout(
                              model, params, mesh, dims, zero_axes))
        del grads
        finite = om.pop("finite")
        return params, opt_state, {**metrics, **om, "loss": loss,
                                   "nonfinite": ~finite}
    return train_step


def cache_specs(model: Model, mesh, dims, batch: int, max_len: int, *,
                seq_shard: bool = False) -> dict:
    """The KV cache's layout on ``mesh`` (``Model.init_cache``'s tree):
    JAX's rule (``repro/train/loop.py::cache_specs``), the one place the
    layout is decided; ``init_cache(specs=)``, ``prefill_step`` and
    ``decode_step`` read it.

      * the batch dim over the batch axes where they divide ``batch``
        (and ``batch`` is at least their size), on every leaf;
      * with ``seq_shard`` the attention K/V caches' W over MP, or over
        the batch axes and MP where the batch axes are idle (JAX's
        context-parallel decode), where ``W % nw == 0`` and ``W >= 16 *
        nw``;
      * ``pos`` whole along W, as JAX leaves it.

    Two differences, settled.  Where W stays whole the port's K/V keep
    the Megatron layout, this rank's kv heads over MP (dim 3), as the
    paged arena does (``init_cache(mesh=)``), where JAX's spec leaves
    them replicated.  Where the kv heads do not divide over MP the spec
    leaves them whole and each rank keeps the one its query heads read
    (``attention.mp_heads``), or all of them (the gathered-heads layout
    of hymba and the cross-attention kinds, ``blocks.layout``).  And a
    recurrent state sits where the cell's Megatron split reads it
    (``blocks.state_shards``), where JAX's shards only its batch dim, so
    GSPMD gathers the whole state every decode step: Mamba's
    ``conv_buf`` (n, B, C, Di) and ``h`` (n, B, Di, N) shard Di over MP
    where the cell is split, mLSTM's ``C`` (n, B, H, hd, hd), ``n`` (n,
    B, H, hd) and ``m`` (n, B, H) shard H over MP where the heads divide,
    sLSTM's stay whole.  The state then never crosses ranks.  Each leaf
    is keyed by its name: JAX's rule for W reads any 5-d leaf as K/V,
    mLSTM's ``C`` too.  A ``cross`` run's ``dummy`` is JAX's ``P(None)``
    (its rule on the stacked ``(n,)`` leaf)."""
    from repro_torch.models.attention import cache_len
    from repro_torch.models.blocks import attn_config, base_kind, state_shards
    from repro_torch.models.model import _cache_kinds
    from repro_torch.parallel.mesh import axis_size
    from repro_torch.parallel.sharding import P
    axes = tuple(dims.batch_axes)
    n = axis_size(mesh, axes) if axes else 1
    mp = tuple(dims.mp)
    n_mp = axis_size(mesh, mp) if mp else 1
    rows = axes if axes and batch % n == 0 and batch >= n else None
    out = {}
    for r, (kind, _) in enumerate(model.runs):
        run = {}
        if "attn" in _cache_kinds(kind):
            acfg = attn_config(model.cfg, kind)
            W = cache_len(acfg, max_len)
            kv = [None, rows, None, None, None]
            if seq_shard and mp:
                waxes = mp if rows else axes + mp
                nw = axis_size(mesh, waxes)
                if W % nw == 0 and W >= 16 * nw:
                    kv[2] = waxes
            if kv[2] is None and n_mp > 1 and acfg.n_kv_heads % n_mp == 0:
                kv[3] = mp
            run["attn"] = {"k": P(*kv), "v": P(*kv),
                           "pos": P(None, rows, None)}
        if base_kind(kind) == "cross":
            run["dummy"] = P(None)      # the (n,) stack of 0-d leaves
        for cell, shards in state_shards(model.cfg, kind, n_mp).items():
            sp = mp if shards > 1 else None
            run[cell] = {
                "mamba": (P(None, rows, None, sp), P(None, rows, sp, None)),
                "mlstm": (P(None, rows, sp, None, None),
                          P(None, rows, sp, None), P(None, rows, sp)),
                "slstm": (P(None, rows, None),) * 4}[cell]
        out[f"run{r}"] = run
    return out


def make_prefill_fn(model: Model, mesh=None, dims=None,
                    schedule: Optional[str] = None):
    """``prefill(params, batch) -> logits``: the full-sequence forward
    (``Model.forward``), as JAX's ``make_prefill_fn``."""
    def prefill(params, batch):
        with torch.no_grad():
            logits, _ = model.forward(params, batch, schedule=schedule,
                                      mesh=mesh, dims=dims)
        return logits
    return prefill


def make_serve_step(model: Model, mesh=None, dims=None,
                    schedule: Optional[str] = None, specs=None):
    """``serve_step(params, cache, batch) -> (next_tokens (B, 1) int32,
    cache)``: one ``Model.decode_step`` through the KV cache (in place)
    and the greedy ``argmax`` of its last position, as JAX's
    ``make_serve_step``.  A cross-attention model's step takes the
    request batch's context K/V (``Model.ctx_kv``, made once) as a fourth
    argument, ``ctx_kv``, as JAX's does.  On a mesh ``specs`` is the
    cache's layout (:func:`cache_specs`)."""
    def serve_step(params, cache, batch, ctx_kv=None):
        with torch.no_grad():
            logits, cache = model.decode_step(
                params, cache, batch, schedule=schedule, mesh=mesh,
                dims=dims, specs=specs, ctx_kv=ctx_kv)
        return logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None], cache
    return serve_step


@dataclass
class Trainer:
    """End-to-end training loop (used by ``launch/train.py``).

    ``guards`` (a :class:`repro_torch.runtime.guards.GuardConfig`) opts
    into the fault-tolerant loop (``run`` -> ``_run_guarded``): the
    guarded step, retained-checkpoint rollback through ``ckpt_path``
    (kept to ``ckpt_retain`` files), the fp8 wire-overflow fallback, and
    the ``faults`` (a :class:`repro_torch.runtime.faults.FaultPlan`)
    injection hooks.  The guard state and the fp8 monitor are made here,
    not in ``setup``, so a caller that brings its own parameters gets
    them too.  With ``guards=None`` (default) the loop is the plain one.

    ``placement="auto"`` and ``rebalance_every=N`` turn on the rebalance
    loop (the module docstring); the model's MoE config must say
    ``placement="auto"`` for its layers to run what is installed, as
    ``launch/train.py --placement auto`` arranges.
    """
    model: Model
    opt_cfg: AdamWConfig
    schedule: Optional[str] = None
    ckpt_path: Optional[str] = None
    guards: Optional[guardlib.GuardConfig] = None
    faults: Optional[object] = None       # runtime.faults.FaultPlan
    ckpt_retain: int = 3
    mesh: Optional[object] = None         # parallel.mesh.Mesh
    dims: Optional[object] = None         # parallel.mesh.ParallelDims
    placement: Optional[str] = None       # None (uniform) | "auto"
    rebalance_every: int = 0              # steps between rebalance checks
    rebalance_margin: float = 1.05        # modeled win required to swap

    def __post_init__(self):
        from repro_torch.core.placement import LoadEMA
        if self.mesh is not None and self.dims is None:
            raise ValueError("Trainer(mesh=...) needs dims=")
        self.load_ema = LoadEMA()
        self.train_step = make_train_step(self.model, self.opt_cfg,
                                          self.schedule, self.mesh,
                                          self.dims)
        self.guard_state = None
        if self.guards is not None:
            self.guard_state = guardlib.GuardState(cfg=self.guards)
            guardlib.reset_fp8_counter()
            guardlib.enable_fp8_monitor(self.mesh, self.model.device)
            factor = self.faults.fp8_sat_factor() if self.faults else 0.0
            if factor:
                from repro_torch.core import collectives
                collectives.set_fp8_sat_injection(factor)
            self.guarded_step = make_guarded_train_step(
                self.model, self.opt_cfg, self.schedule, self.mesh,
                self.dims)

    def setup(self, generator):
        """Random parameters from ``generator`` and fresh AdamW state (on a
        mesh: the full parameters, the same on every rank, cut to this
        rank's shards).  Also notes the autoscheduler's decisions made
        before this run, so step 0 reports only this run's."""
        from repro_torch.core import autosched
        params = self.model.init(generator)
        if self.mesh is not None:
            params = self.shard(params)
        self._sched_keys = set(autosched.cache_info())
        return params, adamw_init(params)

    def shard(self, params):
        """This rank's shards of the full ``params`` (``param_specs``)."""
        from repro_torch.parallel.sharding import local_tree
        return local_tree(params, self.model.param_specs(
            params, self.mesh, self.dims), self.mesh)

    def state_specs(self, params, opt_key: str = "opt_state"):
        """The specs of ``{"params": params, opt_key: <AdamW state>}`` on
        the mesh (what a checkpoint of them gathers), None on one rank."""
        if self.mesh is None:
            return None
        pspecs = self.model.param_specs(params, self.mesh, self.dims)
        return {"params": pspecs, opt_key: opt_state_specs(pspecs)}

    def _agree(self, step: int, action: str, restored=None) -> None:
        """On a mesh, hold every rank to this step's guard decision: one
        all-gather of ``(step, action, streak, restored step or -1, fp8
        fallbacks)``; any difference raises on every rank alike."""
        if self.mesh is None:
            return
        from repro_torch.parallel import comm
        st = self.guard_state
        comm.agree([step, _ACTIONS.index(action), st.streak,
                    -1 if restored is None else restored,
                    st.counters["fp8_fallbacks"]],
                   self.mesh.group(self.mesh.axis_names),
                   f"the guard's decision at step {step} (step, action, "
                   f"streak, restored step, fp8 fallbacks)",
                   self.model.device)

    def _any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (one all-gather on a
        mesh)."""
        if self.mesh is None or self.mesh.size == 1:
            return flag
        from repro_torch.parallel import comm
        mine = torch.tensor([int(flag)], device=self.model.device)
        return bool(comm.all_gather(mine, self.mesh.group(
            self.mesh.axis_names), 0).any())

    def batch(self, data, step):
        """Batch ``step`` of ``data``: this rank's rows on a mesh."""
        dev = self.model.device
        if self.mesh is None:
            return data.tensors(step, dev)
        return data.sharded_batch(step, self.mesh, self.dims.batch_axes,
                                  dev)

    def _log_step0(self, metrics):
        # the first step ran the model: any schedule="auto" MoE layers
        # have made their (schedule, n_chunks, wire) decisions now
        from repro_torch.core import autosched
        summary = autosched.cache_summary(
            exclude=getattr(self, "_sched_keys", ()))
        if summary:
            print(summary, flush=True)
        el = metrics.get("expert_load")
        if el is not None and el.dim() == 1 and el.shape[-1]:
            vals = " ".join(f"{float(c):.0f}" for c in el.cpu())
            print(f"expert load (routed rows/expert, all layers): [{vals}]",
                  flush=True)

    def _track_load(self, metrics):
        """Fold this step's per-expert routed rows into the load EMA (a
        no-op for dense models and for an all-zero vector: no routing
        signal)."""
        el = metrics.get("expert_load")
        if el is not None and el.dim() == 1 and el.shape[-1]:
            el = el.cpu().numpy()
            if float(el.sum()) > 0:
                self.load_ema.update(el)

    def _emit_train_step(self, m):
        """One ``train_step`` event per history row (the streaming twin of
        ``history``), and beside it the per-expert load EMA once it is live
        (every MoE run, as in the JAX loop; a dense model never feeds it)."""
        if not obs.enabled():
            return
        obs.emit("train_step", **m)
        if self.load_ema.ready:
            obs.emit("expert_load", step=m.get("step"),
                     load=[round(float(v), 3)
                           for v in self.load_ema.value()])

    def _maybe_rebalance(self, step):
        """Every ``rebalance_every`` steps, ask the autoscheduler whether a
        placement derived from the load EMA beats uniform under the
        skew-aware cost model; on a win it is installed and the next
        step's MoE layers run it (on a mesh every rank is held to the same
        outcome)."""
        if self.placement != "auto" or not self.rebalance_every:
            return
        if step == 0 or step % self.rebalance_every or \
                not self.load_ema.ready:
            return
        from repro_torch.core import autosched
        mcfg = getattr(self.model.cfg, "moe", None)
        if mcfg is None:
            return
        epoch = autosched.maybe_rebalance(
            self.load_ema.value(), margin=self.rebalance_margin,
            capacity_factor=mcfg.capacity_factor, top_k=mcfg.top_k,
            mesh=self.mesh, device=self.model.device)
        if epoch is None:
            return
        pl = autosched.current_placement()
        desc = pl.summary() if pl is not None else "uniform"
        obs.emit("train_rebalance", step=step, epoch=epoch, placement=desc)
        print(f"step {step:5d}  REBALANCE -> placement epoch {epoch}: "
              f"{desc}", flush=True)

    def _log(self, m):
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"ce {m['ce']:.4f}  gnorm {m['grad_norm']:.3f}  "
              f"lr {m['lr']:.2e}", flush=True)

    def run(self, params, opt_state, data, n_steps: int, log_every: int = 10,
            ckpt_every: int = 0):
        """``n_steps`` steps on ``data.tensors(step, device)``.  Returns
        ``(params, opt_state, history)``; history holds the scalar metrics
        of every logged step (every ``log_every``-th and the last), with
        ``step`` and ``wall_s``.  With ``ckpt_path`` and ``ckpt_every``,
        every ``ckpt_every``-th step (but step 0) is saved there under
        ``{"params", "opt"}``, as the JAX loop saves it."""
        if self.guards is not None:
            return self._run_guarded(params, opt_state, data, n_steps,
                                     log_every, ckpt_every)
        history = []
        # with a sink, the fp8 encodes' saturation counts wait on the card
        # and are read on the logged rows, where the loop reads anyway (on
        # a mesh by every rank, if any rank has the sink: rank 0)
        sat_events = self._any_rank(obs.enabled())
        if sat_events:
            guardlib.enable_fp8_monitor(self.mesh, self.model.device)
        t0 = time.perf_counter()
        for step in range(n_steps):
            if obs.enabled() or self.mesh is not None:
                obs.set_context(step=step)
            batch = self.batch(data, step)
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            if step == 0:
                self._log_step0(metrics)
            self._track_load(metrics)
            self._maybe_rebalance(step)
            if step % log_every == 0 or step == n_steps - 1:
                m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                m["step"] = step
                m["wall_s"] = time.perf_counter() - t0
                if self.load_ema.ready:
                    m["load_imbalance"] = self.load_ema.imbalance()
                history.append(m)
                if sat_events:
                    guardlib.fold_fp8()
                self._emit_train_step(m)
                self._log(m)
            if ckpt_every and self.ckpt_path and step and \
                    step % ckpt_every == 0:
                from repro_torch.checkpoint import save_checkpoint
                save_checkpoint(self.ckpt_path,
                                {"params": params, "opt": opt_state}, step,
                                specs=self.state_specs(params, "opt"),
                                mesh=self.mesh)
        if sat_events:
            guardlib.disable_fp8_monitor()
        return params, opt_state, history

    def _run_guarded(self, params, opt_state, data, n_steps: int,
                     log_every: int = 10, ckpt_every: int = 0):
        """The fault-tolerant loop: guarded step -> observe -> (apply |
        skip | rollback), snapshots on clean steps, fp8 fallback swap.
        A rollback restores the retained checkpoint in place into
        ``params`` and ``opt_state``.  On a mesh each step's decision and
        each rollback's restored step are held equal on every rank
        (``_agree``)."""
        from repro_torch.checkpoint.ckpt import CheckpointStore
        from repro_torch.core import autosched
        from repro_torch.runtime.rollback import RollbackManager

        state = self.guard_state
        mgr = self.rollback_mgr = None
        if self.ckpt_path:
            mgr = self.rollback_mgr = RollbackManager(
                CheckpointStore(self.ckpt_path, retain=self.ckpt_retain,
                                faults=self.faults),
                specs=self.state_specs(params), mesh=self.mesh)
            # anchor before step 0: a streak in the first interval must
            # have somewhere to roll back to
            mgr.snapshot(params, opt_state, 0)

        history = []
        t0 = time.perf_counter()
        for step in range(n_steps):
            if obs.enabled() or self.mesh is not None:
                obs.set_context(step=step)
            batch = self.batch(data, step)
            gf = self.faults.grad_fault(step) if self.faults else 0.0
            # a skipped step returns params/opt_state untouched
            params, opt_state, metrics = self.guarded_step(
                params, opt_state, batch, state.lr_scale, gf)
            loss = float(metrics["loss"])
            # the step's fp8 counts (and events) while the loss read has
            # just waited for the device
            guardlib.fold_fp8()
            action = state.observe(step, loss, bool(metrics["nonfinite"]))
            self._agree(step, action)
            if step == 0:
                self._log_step0(metrics)
            self._track_load(metrics)
            self._maybe_rebalance(step)
            if action == guardlib.ROLLBACK:
                res = mgr.rollback(step, params, opt_state) \
                    if mgr is not None else None
                if res is None:
                    # nothing restorable: limp on with the backed-off LR
                    state.record_rollback(step, None)
                    self._agree(step, action)
                    obs.emit("guard_rollback", restored_step=None,
                             loss=loss)
                else:
                    params, opt_state, rstep = res
                    state.record_rollback(step, rstep)
                    self._agree(step, action, rstep)
                    obs.emit("guard_rollback", restored_step=rstep,
                             loss=loss)
                    print(f"step {step:5d}  ROLLBACK -> re-anchored to "
                          f"checkpoint step {rstep}", flush=True)
            elif action == guardlib.SKIP:
                obs.emit("guard_skip", streak=state.streak,
                         lr_scale=state.lr_scale)
                print(f"step {step:5d}  SKIPPED (non-finite, streak "
                      f"{state.streak}, lr_scale {state.lr_scale:.3g})",
                      flush=True)
            if state.check_fp8():
                # fp8 wire overflow: clamp every wire decision up to the
                # fallback dtype; the next step's MoE layers read the
                # ceiling (params/opt state untouched)
                autosched.set_wire_ceiling(state.cfg.fp8_fallback)
                n = autosched.invalidate("fp8 wire overflow fallback")
                obs.emit("fp8_fallback", sat_rate=guardlib.fp8_sat_rate(),
                         wire=state.cfg.fp8_fallback, invalidated=n)
                print(f"fp8 wire overflow (sat rate "
                      f"{guardlib.fp8_sat_rate():.2e}): falling back to "
                      f"{state.cfg.fp8_fallback} wire "
                      f"({n} cached decisions invalidated)", flush=True)
            if step % log_every == 0 or step == n_steps - 1:
                m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                m["step"] = step
                m["wall_s"] = time.perf_counter() - t0
                m["lr_scale"] = state.lr_scale
                if self.load_ema.ready:
                    m["load_imbalance"] = self.load_ema.imbalance()
                history.append(m)
                self._emit_train_step(m)
                self._log(m)
            if mgr is not None and ckpt_every and step and \
                    step % ckpt_every == 0 and action == guardlib.OK:
                mgr.snapshot(params, opt_state, step)
        print(state.summary(), flush=True)
        return params, opt_state, history
