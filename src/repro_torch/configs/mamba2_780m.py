"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1536 ssm_state=128 vocab=50280 [arXiv:2405.21060; unverified]
Attention-free => long_500k runs; decode cache is the (H, P, N) SSM state.
"""

from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=1,  # unused (attn-free)
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50_280,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_chunk=128,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, vocab_size=512, ssm_state=16, ssm_headdim=16,
        ssm_chunk=16,
    )
