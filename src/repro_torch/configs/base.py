"""Architecture config schema (counterpart of ``repro/configs/base.py``).

``ModelConfig`` keeps the JAX package's fields one for one, so a config
module carries over unchanged; ``layer_kinds``, ``runs`` and ``reduced``
are copies.  ``use_pallas`` has no effect in the port: the backend follows
the device.

``InputShape`` / ``INPUT_SHAPES`` are JAX's four dry-run shapes, values
as they are; ``input_specs`` gives each model input as an empty tensor on
the meta device (JAX: ``ShapeDtypeStruct``), same keys, shapes and
dtypes, and ``variant_config`` the sliding-window variant ``long_500k``
runs (JAX's ``launch/dryrun.py::variant_config``):

  train_4k     seq 4,096    global_batch 256   -> train_step
  prefill_32k  seq 32,768   global_batch 32    -> prefill (forward)
  decode_32k   seq 32,768   global_batch 128   -> serve_step (1 token + cache)
  long_500k    seq 524,288  global_batch 1     -> serve_step, sub-quadratic only
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch.core.moe import MoEConfig
from repro_torch.kernels.registry import KernelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 1e6
    use_rope: bool = True
    norm_type: str = "rmsnorm"
    norm_eps: float = 1e-5
    qkv_bias: bool = False
    ffn_bias: bool = False
    ffn_act: str = "silu"
    glu: bool = True
    tie_embeddings: bool = False
    parallel_block: bool = False      # command-r: attn || ffn
    logit_scale: float = 1.0
    # attention variants
    attn_window: Optional[int] = None     # sliding-window (SWA)
    attn_chunk: Optional[int] = None      # llama4 chunked local attention
    chunk_every: int = 0                  # every k-th layer full attn (iRoPE)
    # MoE (Parm's domain)
    moe: Optional[MoEConfig] = None
    moe_period: int = 1                   # every k-th layer is MoE
    # SSM / xLSTM / hybrid
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: float = 2.0
    slstm_every: int = 0                  # xLSTM: every k-th layer is sLSTM
    # VLM
    cross_every: int = 0                  # every k-th layer cross-attends
    n_ctx_tokens: int = 0                 # image/audio context length
    # audio enc-dec
    encoder_layers: int = 0
    encoder_seq: int = 0
    # execution
    dtype: str = "float32"
    remat: bool = True
    use_pallas: bool = False              # no effect in the port
    kernel: KernelConfig = KernelConfig()
    # no effect in the port: decode writes its cache slot in place, where
    # JAX's three writes (one-hot, masked, dynamic update) store the same
    cache_masked_update: bool = False
    seq_parallel: bool = False
    # no effect in the port: JAX's GSPMD hint; the port's decode combines
    # the softmax across ranks wherever ``train.loop.cache_specs`` splits
    # the cache's W (``seq_shard``)
    context_parallel_decode: bool = False
    source: str = ""                      # citation

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM/hybrid or windowed/chunked attention)."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.attn_window is not None or self.attn_chunk is not None

    def layer_kinds(self) -> list:
        """Per-layer block kind."""
        kinds = []
        for i in range(self.n_layers):
            if self.arch_type == "ssm":
                k = "slstm" if (self.slstm_every
                                and i % self.slstm_every == self.slstm_every - 1) \
                    else "mlstm"
            elif self.arch_type == "hybrid":
                k = "hymba"
            elif self.arch_type == "audio":
                k = "xdec"
            elif self.cross_every and i % self.cross_every == self.cross_every - 1:
                k = "cross"
            elif self.moe is not None and i % self.moe_period == 0:
                k = "moe"
            else:
                k = "dense"
            if (self.attn_chunk and self.chunk_every
                    and i % self.chunk_every == self.chunk_every - 1
                    and k in ("dense", "moe")):
                k += "_full"
            kinds.append(k)
        return kinds

    def runs(self) -> list:
        """Consecutive same-kind layer runs: [(kind, count), ...]."""
        out = []
        for k in self.layer_kinds():
            if out and out[-1][0] == k:
                out[-1][1] += 1
            else:
                out.append([k, 1])
        return [(k, n) for k, n in out]

    def reduced(self, n_layers=2, d_model=None, n_experts=None) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, d_model or 256)
        heads = max(1, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        hd = max(16, d // heads)
        moe = self.moe
        if moe is not None:
            e = min(moe.n_experts, n_experts or 4)
            moe = replace(moe, d_model=d, d_ff=max(32, moe.d_ff // 16),
                          n_experts=e, top_k=min(moe.top_k, e))
        return replace(
            self, name=self.name + "-smoke", n_layers=n_layers, d_model=d,
            n_heads=heads, n_kv_heads=kv, head_dim=hd,
            d_ff=max(64, min(self.d_ff, 4 * d)) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512), moe=moe,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            n_ctx_tokens=min(self.n_ctx_tokens, 16) if self.n_ctx_tokens else 0,
            attn_window=min(self.attn_window, 64) if self.attn_window else None,
            attn_chunk=min(self.attn_chunk, 64) if self.attn_chunk else None,
            cross_every=min(self.cross_every, 2) if self.cross_every else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            remat=False)


def input_specs(cfg: ModelConfig, shape: InputShape,
                device="meta") -> dict:
    """Every model input of ``shape`` as an empty tensor on ``device`` (the
    meta device: nothing allocated), as JAX's ``input_specs``: int32
    ``tokens`` and ``labels`` (B, L) to train, ``tokens`` (B, L) to
    prefill, ``tokens`` (B, 1) and a scalar ``step`` to decode.  The
    modality frontends are stubs: a ``vlm`` arch's image patches and an
    ``audio`` arch's frames arrive as ``ctx_embeds`` in the config's dtype,
    (B, ``n_ctx_tokens``, D) and (B, ``encoder_seq``, D)."""
    B, L = shape.global_batch, shape.seq_len

    def empty(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.kind == "train":
        specs = {"tokens": empty(B, L), "labels": empty(B, L)}
    elif shape.kind == "prefill":
        specs = {"tokens": empty(B, L)}
    else:
        specs = {"tokens": empty(B, 1), "step": empty()}
    n_ctx = {"vlm": cfg.n_ctx_tokens, "audio": cfg.encoder_seq}.get(
        cfg.arch_type)
    if n_ctx is not None:
        specs["ctx_embeds"] = empty(B, n_ctx, cfg.d_model,
                                    dtype=getattr(torch, cfg.dtype))
    return specs


def variant_config(cfg: ModelConfig, shape_name: str):
    """``(cfg, variant)`` for ``shape_name``: ``long_500k`` on a
    full-attention arch runs JAX's sliding-window variant (window 8192,
    ``"swa"``); every other pairing is the config as it is (``""``).  An
    audio arch gives ``(None, reason)``: JAX skips it."""
    shape = INPUT_SHAPES[shape_name]
    if shape.name != "long_500k" or cfg.sub_quadratic:
        return cfg, ""
    if cfg.arch_type == "audio":
        return None, "skip: enc-dec audio arch, 500k decode not meaningful"
    return replace(cfg, attn_window=8192), "swa"
