"""GPT-2-MoE: the paper's §VI-D real-world model — GPT-2 (124M base) with
every other FFN replaced by an MoE layer (E=8) [paper Table V]."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import MoEConfig

CONFIG = ModelConfig(
    name="gpt2-moe", arch_type="moe", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=50257,
    use_rope=False, norm_type="layernorm", glu=False, ffn_act="gelu",
    ffn_bias=True, qkv_bias=True, tie_embeddings=True,
    moe=MoEConfig(d_model=768, d_ff=3072, n_experts=8, top_k=2,
                  capacity_factor=1.2, glu=False, schedule="auto"),
    moe_period=2, source="paper §VI-D / Radford et al. 2019")
