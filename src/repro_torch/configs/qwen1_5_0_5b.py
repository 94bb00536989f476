"""qwen1.5-0.5b — MHA with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b", family="dense",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        head_dim=64, d_ff=2816, vocab=151936,
        qkv_bias=True, tie_embeddings=True, rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, qkv_bias=True, tie_embeddings=True,
        soi_block=32, attn_chunk=64,
    )
