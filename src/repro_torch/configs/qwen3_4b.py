"""qwen3-4b [dense] — GQA with per-head QK-RMSNorm.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936 [hf:Qwen/Qwen3-8B; hf]
Full attention => long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-4b",
        family="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=512,
    )
