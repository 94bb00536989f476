"""qwen2-0.5b — GQA kv=2 with QKV bias [arXiv:2407.10671]."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        head_dim=64, d_ff=4864, vocab=151936,
        qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
        # 14 heads don't shard on a 16-way model axis (clean_spec
        # degrades them to replicated), so per-device score tiles carry
        # all heads; 4-way grad accumulation shrinks them with no extra
        # KV re-read traffic (chunk shrinking cost 2.2x traffic —
        # EXPERIMENTS.md §Perf C.2/C.3)
        train_accum=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke", family="dense",
        n_layers=2, d_model=56, n_heads=4, n_kv_heads=2, head_dim=14,
        d_ff=128, vocab=256, qkv_bias=True, tie_embeddings=True,
        soi_block=32, attn_chunk=64,
    )
