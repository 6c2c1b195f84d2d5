"""The JAX package's four examples (``examples/*.py``) on the port, each
run as ``python -m repro_torch.examples.<name>``:

  quickstart           Algorithm 1's pick, then a reduced qwen3-moe trained
                       60 steps under ``schedule="auto"``;
  schedule_comparison  one MoE layer under each Parm schedule on the
                       (data=4, model=2) mesh of 8 gloo ranks: each
                       schedule's collectives (``comm``'s counts and bytes,
                       beside the paper's Eq. 1 / 11 / 14), ms a call and
                       ``max|y - y_base|``;
  serve_batched        greedy decode through the KV cache of four reduced
                       archs (``make_serve_step``);
  train_100m           a ~100M-parameter gpt2-moe trained on the synthetic
                       corpus.

Each runs on the card unless ``--device cpu`` is given, and refuses to run
without one otherwise.
"""
