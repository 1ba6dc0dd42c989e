"""recurrentgemma-9b [hybrid] — Griffin: RG-LRU + local attention, 1:2.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000
[arXiv:2402.19427; unverified].  Pattern (rec, rec, attn) x12 + 2-rec tail;
sub-quadratic => long_500k runs.
"""

from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12_288,
        vocab_size=256_000,
        sliding_window=2048,
        hybrid_pattern=("rec", "rec", "attn"),
        lru_width=4096,
        attention_kind="swa",
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=4,  # one (rec, rec, attn) group + 1-layer tail
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sliding_window=16,
        lru_width=64,
    )
