"""The train step and the loop that runs it (counterpart of
``make_train_step`` and
``Trainer`` in ``repro/train/loop.py``), on one device.

Not here yet (later slices): the guarded step (skip, LR backoff,
rollback), fault injection, load-adaptive rebalancing, checkpoints and
telemetry sinks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models.model import Model
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     leaves)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    schedule: Optional[str] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: loss, gradients of every parameter, one AdamW update in
    place.  Metrics are the loss's (``ce``, ``aux``, ``ppl_proxy``,
    ``expert_load``) plus ``grad_norm``, ``lr`` and ``loss``, as tensors."""
    def train_step(params, opt_state, batch):
        flat = leaves(params)
        for t in flat:
            t.requires_grad_(True)
        loss, metrics = model.loss(params, batch, schedule=schedule)
        grads = torch.autograd.grad(loss, flat)
        om = adamw_update(params, grads, opt_state, opt_cfg)
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **om, "loss": loss.detach()}
    return train_step


@dataclass
class Trainer:
    """End-to-end training loop (used by ``launch/train.py``)."""
    model: Model
    opt_cfg: AdamWConfig
    schedule: Optional[str] = None

    def __post_init__(self):
        self.train_step = make_train_step(self.model, self.opt_cfg,
                                          self.schedule)

    def setup(self, generator):
        """Random parameters from ``generator`` and fresh AdamW state."""
        params = self.model.init(generator)
        return params, adamw_init(params)

    def _log_step0(self, metrics):
        el = metrics.get("expert_load")
        if el is not None and el.dim() == 1 and el.shape[-1]:
            vals = " ".join(f"{float(c):.0f}" for c in el.cpu())
            print(f"expert load (routed rows/expert, all layers): [{vals}]",
                  flush=True)

    def run(self, params, opt_state, data, n_steps: int, log_every: int = 10):
        """``n_steps`` steps on ``data.tensors(step, device)``.  Returns
        ``(params, opt_state, history)``; history holds the scalar metrics
        of every logged step (every ``log_every``-th and the last), with
        ``step`` and ``wall_s``."""
        history = []
        dev = self.model.device
        t0 = time.perf_counter()
        for step in range(n_steps):
            batch = data.tensors(step, dev)
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            if step == 0:
                self._log_step0(metrics)
            if step % log_every == 0 or step == n_steps - 1:
                m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                m["step"] = step
                m["wall_s"] = time.perf_counter() - t0
                history.append(m)
                print(f"step {step:5d}  loss {m['loss']:.4f}  "
                      f"ce {m['ce']:.4f}  gnorm {m['grad_norm']:.3f}  "
                      f"lr {m['lr']:.2e}", flush=True)
        return params, opt_state, history
