"""qwen2.5-32b — dense GQA with QKV bias [hf:Qwen/Qwen2.5 family]."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        head_dim=128, d_ff=27648, vocab=152064,
        qkv_bias=True, rope_theta=1_000_000.0,
        train_accum=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, qkv_bias=True,
        soi_block=32, attn_chunk=64,
    )
