"""falcon-mamba-7b — attention-free Mamba-1 [arXiv:2410.05355]."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=65024,
        ssm_state=16, ssm_expand=2, ssm_conv=4, dt_rank=256,
        subquadratic=True,
        train_accum=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=256, ssm_state=4, ssm_expand=2, ssm_conv=4,
        dt_rank=8, soi_block=32, subquadratic=True,
    )
