"""PyTorch + CUDA port of the Parm reproduction in ``src/repro``.

The JAX package stays the reference; this package imports none of it.  It
serves an MoE decoder with continuous batching over a paged KV cache
(``repro_torch.launch.serve`` -> ``serve.engine.Engine`` ->
``models.model.Model.paged_step``) and trains it on one card
(``repro_torch.launch.train`` -> ``train.loop.Trainer`` ->
``models.model.Model.loss`` -> ``optim.adamw``), guarded by skip-steps,
LR backoff, checkpoint rollback and the fp8 overflow fallback
(``runtime``, ``checkpoint``), with every TPU kernel on those paths
rewritten in CUDA C++ for Hopper (``csrc/``).  Entry points run on
``cuda`` unless the caller asks for the CPU.
"""
