"""recurrentgemma-9b — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427]. lru_width = d_model (see DESIGN.md assumptions)."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        head_dim=256, d_ff=12288, vocab=256_000,
        pattern=("rec", "rec", "local"), window=2048,
        lru_width=4096, ssm_conv=4, rope_theta=10_000.0,
        subquadratic=True,
        train_accum=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=96, vocab=256, pattern=("rec", "rec", "local"), window=32,
        lru_width=64, soi_block=32, attn_chunk=64, subquadratic=True,
    )
