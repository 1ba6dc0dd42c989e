"""chameleon-34b [vlm] — early-fusion mixed-modal; VQ image tokens.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
[arXiv:2405.09818; unverified].

Early fusion means image patches are VQ-quantized into ordinary vocabulary
ids by a frozen tokenizer — the modality frontend is a STUB per the
assignment: ``input_specs`` supplies precomputed (text + image) token ids,
so the backbone is a plain dense transformer with qk-norm (the chameleon
training-stability trick).  Full attention => long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22_016,
        vocab_size=65_536,
        qk_norm=True,
        frontend_stub=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512
    )
