"""llama3.2-1b — small llama3 [hf:meta-llama/Llama-3.2-1B]."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
        head_dim=64, d_ff=8192, vocab=128256,
        tie_embeddings=True, rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, tie_embeddings=True,
        soi_block=32, attn_chunk=64,
    )
