"""Rollback policy: re-anchor a poisoned training run to the last good
retained checkpoint (counterpart of ``repro/runtime/rollback.py``).

:class:`RollbackManager` is the thin policy layer between the guard
rails (``runtime.guards``, which decide *when* to roll back) and the
:class:`~repro_torch.checkpoint.ckpt.CheckpointStore` (which knows
*what* is restorable).  It snapshots on clean steps, and on rollback
restores the newest verified checkpoint — falling back across corrupt
files — into the live parameter and optimizer tensors, in place, and
reports which step the run re-anchored to.  The Trainer keeps its data
pipeline marching forward; only params/opt state are rewound.
"""

from __future__ import annotations

from repro_torch.checkpoint.ckpt import CheckpointStore


class RollbackManager:
    """Snapshot/restore policy over a :class:`CheckpointStore`.

    ``specs`` and ``mesh`` (the counterpart of JAX's ``shardings``: the
    parameters' and the AdamW state's ``PartitionSpec`` trees under
    ``{"params", "opt_state"}``, and the mesh) make every snapshot a
    whole-array file gathered from the ranks' shards and every restore
    take each rank's shards of it."""

    def __init__(self, store: CheckpointStore, specs=None, mesh=None):
        self.store = store
        self.specs, self.mesh = specs, mesh
        self.last_good_step = None
        self.events = []

    def snapshot(self, params, opt_state, step: int) -> str:
        """Persist a clean (guard-approved) step."""
        path = self.store.save({"params": params, "opt_state": opt_state},
                               step, specs=self.specs, mesh=self.mesh)
        self.last_good_step = step
        self.events.append({"kind": "snapshot", "step": step})
        return path

    def rollback(self, step: int, params, opt_state):
        """Restore the newest verified checkpoint in place into the live
        ``params`` and ``opt_state`` (a corrupt file never touches them).

        Returns ``(params, opt_state, restored_step)`` or ``None`` when
        nothing is restorable (the caller decides whether to limp on or
        abort)."""
        try:
            tree, restored_step, path = self.store.restore(
                {"params": params, "opt_state": opt_state},
                specs=self.specs, mesh=self.mesh)
        except FileNotFoundError:
            self.events.append({"kind": "rollback_failed", "step": step})
            return None
        self.events.append({"kind": "rollback", "step": step,
                            "restored_step": restored_step, "path": path})
        return tree["params"], tree["opt_state"], restored_step
