"""Config dataclasses: model architecture, input shapes, ODL head (a copy of
``repro/configs/base.py``: every field and default is the JAX package's, so
``get_config`` answers alike in both packages)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ODLHeadConfig:
    """The paper's technique attached to a backbone (DESIGN.md §3)."""

    n_hidden: int = 128
    n_out: int = 6
    variant: str = "hash"  # 'hash' (ODLHash) | 'base' (ODLBase)
    seed: int = 0x2D2A
    ridge: float = 1e-2
    enabled: bool = True
    use_kernel: bool = False  # kept for parity; the port's device picks the kernels


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # SWA width (h2o-danube, local attn)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # --- MoE (deepseek fine-grained) ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # 'dense': scatter-dispatch; 'ep': explicit expert parallelism with
    # all-to-all dispatch (the reference's two MoE implementations; the
    # port has no MoE yet).
    moe_impl: str = "dense"

    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # --- hybrid (recurrentgemma: RG-LRU + local attn, pattern 1 attn : 2 rec)
    hybrid_pattern: Tuple[str, ...] = ()  # e.g. ('rec', 'rec', 'attn')
    lru_width: Optional[int] = None

    # --- encoder-decoder (whisper) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    max_source_len: int = 4096  # stubbed frame embeddings length

    # --- modality stub ---
    frontend_stub: bool = False  # vlm/audio: input_specs yields embeddings/tokens

    # --- the paper's ODL head ---
    odl: ODLHeadConfig = ODLHeadConfig()

    # --- attention policy ---
    attention_kind: str = "full"  # 'full' | 'swa' — long_500k requires != full
    # 'naive' materializes (Sq, Sk) scores; 'chunked' = flash-style online
    # softmax over KV chunks, O(S * chunk) memory (hillclimb variant).
    attention_impl: str = "naive"
    attention_chunk: int = 1024
    # Decode cache write: 'onehot' (each stream writes at its own position)
    # or 'dus' (every stream writes at pos[0]: requires synchronized stream
    # positions — the common serving case).  The port writes both in place.
    cache_update: str = "onehot"

    # The reference's dry-run switch (layer stacks as a Python loop); the
    # port always loops over the stacked layers and keeps it for parity.
    unroll_layers: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch lower long_500k (DESIGN.md §4)?"""
        if self.family == "ssm":
            return True
        if self.hybrid_pattern:
            return True
        return self.sliding_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


LM_SHAPES = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1  # gradient accumulation inside train_step
    remat: bool = True
    zero1: bool = True  # shard optimizer state over the data axis
    # 'float32' master params, or 'bfloat16' for models whose f32 state
    # exceeds pod HBM (deepseek-v2-236b: 12 B/param x 236e9 = 2.83 TB > the
    # 4 TB 256-chip pod; bf16 params + f32 moments = 2.36 TB fits).
    param_dtype: str = "float32"
