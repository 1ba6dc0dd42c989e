"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared + 160 routed top-6.

60L d_model=5120 128H d_ff_expert=1536 vocab=102400 [arXiv:2405.04434; hf]
"""

from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=192,  # qk_nope(128) + qk_rope(64)
        d_ff=1536,
        vocab_size=102_400,
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        d_ff_expert=1536,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=24,
        d_ff=64,
        vocab_size=512,
        n_experts=8,
        n_shared_experts=1,
        top_k=2,
        d_ff_expert=48,
        q_lora_rank=32,
        kv_lora_rank=24,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
    )
