"""Hymba-1.5B: parallel attention + mamba heads per layer, SWA
[arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", arch_type="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, head_dim=64, d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_expand=2.0, attn_window=1024,
    source="arXiv:2411.13676")
