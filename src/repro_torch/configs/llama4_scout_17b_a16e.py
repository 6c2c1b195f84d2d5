"""Llama-4-Scout-17B-16E: MoE top-1, 16 experts + 1 shared, chunked local
attention with NoPE full-attn every 4th layer (iRoPE)
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", arch_type="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=202048,
    rope_theta=5e5, attn_chunk=8192, chunk_every=4,
    moe=MoEConfig(d_model=5120, d_ff=8192, n_experts=16, top_k=1,
                  capacity_factor=1.25, n_shared_experts=1, schedule="auto"),
    moe_period=1, source="hf:meta-llama/Llama-4-Scout-17B-16E")
