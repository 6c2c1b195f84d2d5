"""Yi-9B: llama-arch dense GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", arch_type="dense", n_layers=48, d_model=4096,
    n_heads=32, n_kv_heads=4, d_ff=11008, vocab_size=64000,
    rope_theta=5e6, source="arXiv:2403.04652",
    # SWA variant (window 8192) enables the long_500k shape; flagged `swa`
    # in the roofline table.  Full attention is the faithful default.
    attn_window=None)
