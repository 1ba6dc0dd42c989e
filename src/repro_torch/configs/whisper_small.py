"""whisper-small [audio] — encoder-decoder, conv frontend stubbed.

12L d_model=768 12H (MHA kv=12) d_ff=3072 vocab=51865 [arXiv:2212.04356;
unverified].  ``input_specs`` provides precomputed frame embeddings
(B, T, d_model) in place of the log-mel conv stem (assignment: frontend is
a STUB).  Decode = decoder self-attn cache + precomputed cross K/V.
"""

from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-small",
        family="audio",
        n_layers=12,  # decoder layers
        n_enc_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=51_865,
        enc_dec=True,
        frontend_stub=True,
        tie_embeddings=True,
        max_source_len=32_768,  # covers decode_32k's decoder positions
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, max_source_len=64,
    )
