"""whisper-tiny — enc-dec audio backbone; conv frontend stubbed
[arXiv:2212.04356]. 4 encoder + 4 decoder layers."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, n_enc_layers=4, n_dec_layers=4,
        d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
        d_ff=1536, vocab=51865, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, n_enc_layers=2, n_dec_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, tie_embeddings=True,
        soi_block=32, attn_chunk=64,
    )
