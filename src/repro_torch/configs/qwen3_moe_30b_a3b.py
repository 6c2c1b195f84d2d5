"""Qwen3-30B-A3B: fine-grained MoE, 128 experts top-8, norm_topk_prob
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", arch_type="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768, vocab_size=151936,
    rope_theta=1e6,
    moe=MoEConfig(d_model=2048, d_ff=768, n_experts=128, top_k=8,
                  capacity_factor=1.25, normalize_topk=True,
                  schedule="auto"),
    moe_period=1, source="hf:Qwen/Qwen3-30B-A3B")
