"""mistral-nemo-12b [dense] — 128k-context dense model (head_dim 128).

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Mistral-Nemo-Base-2407; hf].  Full attention => long_500k skip.
"""

from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="mistral-nemo-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,  # nemo decouples head_dim from d_model/n_heads
        d_ff=14_336,
        vocab_size=131_072,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=512,
    )
