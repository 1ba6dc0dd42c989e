"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6.

28L d_model=2048 16H (GQA kv=16 => MHA) d_ff_expert=1408 vocab=102400
[arXiv:2401.06066; hf]
"""

from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102_400,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        d_ff_expert=1408,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=512,
        n_experts=8,
        n_shared_experts=1,
        top_k=2,
        d_ff_expert=48,
    )
