"""Chunk-pipelined schedule variants (counterpart of
``repro/core/pipeline.py``).

Each ``*_pipe`` name is the same registered plan as its base schedule with
the ``plan.split_capacity`` graph transform applied: after the full-pool
gate and dispatch, the capacity buffer is split into
``info.pipeline_chunks`` micro-chunks (clamped to the largest divisor of
the chunked capacity dim), and each chunk runs its own dispatch-AlltoAll
-> expert FFN -> combine-AlltoAll chain.  Chunking happens after gating,
so routing, capacity and drops are those of the unchunked schedule.
Where the JAX package leaves the overlap of the chunks to XLA's
async-collective scheduler, the port's ``executor.execute`` issues it:
chunk i+1's dispatch AlltoAll is posted (``async_op=True``) before chunk
i's expert FFN is enqueued, each chunk's combine as soon as its FFN is,
and every collective is waited on where its first consumer needs it;
under ``s2h`` one chunk's ESP hop and the other's EP hop are in flight
together.  The backward overlaps likewise (``core/collectives.py``).
"""

from __future__ import annotations

from repro_torch.core.executor import execute
from repro_torch.core.plan import build_plan
from repro_torch.core.plan import clamp_chunks  # noqa: F401 (re-export)
from repro_torch.core.schedules import BODY, MoEShardInfo

PIPELINE_OF = {"baseline": "baseline_pipe", "s1": "s1_pipe",
               "s2": "s2_pipe", "s1_seqpar": "s1_seqpar_pipe",
               "s2h": "s2h_pipe", "s1g": "s1g_pipe"}
UNCHUNKED_OF = {v: k for k, v in PIPELINE_OF.items()}


def _pipe_body(name):
    def body(x, wg, w1, w3, w2, info: MoEShardInfo):
        return execute(build_plan(name, info), x, wg, w1, w3, w2, info)
    body.__name__ = f"{name}_pipe_body"
    body.__qualname__ = body.__name__
    body.__doc__ = (f"``{name}`` with ``split_capacity`` applied at "
                    "``info.pipeline_chunks`` (1 degenerates to the "
                    "unchunked plan).")
    return body


baseline_pipe_body = _pipe_body("baseline")
s1_pipe_body = _pipe_body("s1")
s2_pipe_body = _pipe_body("s2")
s1_seqpar_pipe_body = _pipe_body("s1_seqpar")
s2h_pipe_body = _pipe_body("s2h")
s1g_pipe_body = _pipe_body("s1g")

PIPELINE_BODY = {
    "baseline_pipe": baseline_pipe_body,
    "s1_pipe": s1_pipe_body,
    "s2_pipe": s2_pipe_body,
    "s1_seqpar_pipe": s1_seqpar_pipe_body,
    "s2h_pipe": s2h_pipe_body,
    "s1g_pipe": s1g_pipe_body,
}
BODY.update(PIPELINE_BODY)
