"""deepseek-coder-33b [dense] — llama-arch code model.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256 [arXiv:2401.14196; hf]
Full attention => long_500k skipped (DESIGN.md §4).
"""

from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19_200,
        vocab_size=32_256,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512
    )
