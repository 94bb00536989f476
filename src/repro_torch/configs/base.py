"""Model/config schema shared by all assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    dt_rank: Optional[int] = None

    # --- hybrid (recurrentgemma) ---
    pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    window: int = 0                 # local-attention window
    lru_width: Optional[int] = None

    # --- VLM (qwen2-vl) ---
    mrope_sections: Tuple[int, ...] = ()
    vision_dim: int = 0
    n_img_tokens: int = 0

    # --- audio enc-dec (whisper) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # --- training / numerics ---
    dtype: str = "bfloat16"
    remat: bool = True
    soi_block: int = 1024           # K-FAC block size (paper: <=1024)
    attn_chunk: int = 1024          # query-chunked attention threshold
    # gradient-accumulation microbatches per train step: activations,
    # attention scores, MoE dispatch buffers and scan states all shrink
    # by this factor while the assigned global batch is honored
    train_accum: int = 1

    # capability flags for the shape grid
    subquadratic: bool = False      # can run long_500k
    has_decoder: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(self.d_model // 16, 1)

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, h, kv = self.hd, self.n_heads, self.n_kv_heads
        n = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, ns, dr = self.d_inner, self.ssm_state, self.dt_rank_
            per = (d * 2 * di + di * self.ssm_conv + di * (dr + 2 * ns)
                   + dr * di + di * ns + di + di * d + 2 * d)
            return n + self.n_layers * per
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        mlp = 3 * d * f
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
        per = attn + mlp + 2 * d
        if self.family == "hybrid":
            # pattern mix of recurrent and attention blocks
            lw = self.lru_width_
            rec = (2 * d * lw + lw * self.ssm_conv + 2 * lw * lw // 8
                   + lw * d + 3 * d * f)
            n_attn = sum(1 for i in range(self.n_layers)
                         if self.pattern[i % len(self.pattern)] == "attn")
            n_rec = self.n_layers - n_attn
            return n + n_attn * per + n_rec * (rec + 2 * d)
        if self.family == "audio":
            enc = self.n_enc_layers * (attn + 2 * d * f + 2 * d)
            dec = self.n_dec_layers * (2 * attn + 2 * d * f + 3 * d)
            return n + enc + dec
        return n + self.n_layers * per

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        full = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * d * f
        moe_act = self.n_layers * self.top_k * 3 * d * f
        return full - moe_all + moe_act


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}
