"""qwen2-vl-7b — M-RoPE VLM backbone; vision tower stubbed
[arXiv:2409.12191]."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        head_dim=128, d_ff=18944, vocab=152064,
        qkv_bias=True, rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24), vision_dim=1280, n_img_tokens=256,
        train_accum=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, qkv_bias=True,
        mrope_sections=(2, 3, 3), vision_dim=32, n_img_tokens=8,
        soi_block=32, attn_chunk=64,
    )
