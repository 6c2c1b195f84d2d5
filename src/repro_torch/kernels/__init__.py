"""Hand-written CUDA kernels of the port, their plain PyTorch versions, and
the ``get_op`` seam.  Importing this package builds nothing: sources under
``csrc/`` compile on the first CUDA call (``_build``)."""
