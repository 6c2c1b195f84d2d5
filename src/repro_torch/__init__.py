"""PyTorch + CUDA port of the Parm reproduction in ``src/repro``.

The JAX package stays the reference; this package imports none of it.  Its
first slice serves an MoE decoder with continuous batching over a paged KV
cache: ``repro_torch.launch.serve`` -> ``serve.engine.Engine`` ->
``models.model.Model.paged_step`` -> blocks, with the ``rmsnorm`` and
``expert_ffn_grouped`` TPU kernels rewritten in CUDA C++ for Hopper
(``csrc/``).  Entry points run on ``cuda`` unless the caller asks for the
CPU.
"""
