"""xLSTM-350M: mLSTM + sLSTM blocks (7:1), attention-free
[arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", arch_type="ssm", n_layers=24, d_model=1024,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
    use_rope=False, slstm_every=8, tie_embeddings=True,
    source="arXiv:2405.04517")
