"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B]."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=1408, vocab=163840,
        n_experts=64, top_k=6, rope_theta=50_000.0,
        soi_block=256,       # MoE: smaller SOI blocks per expert
        train_accum=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab=256, n_experts=4, top_k=2,
        soi_block=32, attn_chunk=64,
    )
