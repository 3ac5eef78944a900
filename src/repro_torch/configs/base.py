"""Architecture configuration schema (dense family of the reference).

Field names and defaults mirror the reference's ``ArchConfig`` so a
test can compare them one by one; ``cdtype``/``pdtype`` are torch dtypes.
The MoE / Mamba / media sub-configs are not ported yet (kept as fields
so the schema lines up; the model rejects a config that sets them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.nn.linear import TernaryPolicy


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One block in the repeating period."""

    mixer: str          # 'attn' | 'mamba' | 'cross_attn'
    ffn: Optional[str]  # 'mlp' | 'moe' | None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    layout: Tuple[BlockSpec, ...] = (BlockSpec("attn", "mlp"),)

    rope_variant: str = "standard"      # standard | half | none
    rope_theta: float = 500000.0
    mlp_kind: str = "swiglu"            # swiglu | gelu
    norm: str = "rms"                   # rms | layer
    encoder_only: bool = False
    tie_embeddings: bool = False
    vocab_round_to: int = 128

    moe: Optional[Any] = None
    mamba: Optional[Any] = None

    frontend_dim: Optional[int] = None
    n_media_tokens: int = 0
    media_dim: int = 0

    ternary: TernaryPolicy = TernaryPolicy()
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"
    attn_chunk_kv: int = 1024
    kv_cache_dtype: str = "bfloat16"     # bfloat16 | int8

    supports_decode: bool = True
    sub_quadratic: bool = False

    def __post_init__(self):
        if self.n_layers % len(self.layout):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not "
                             f"divisible by period {len(self.layout)}")

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.layout)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        r = self.vocab_round_to
        return ((self.vocab_size + r - 1) // r) * r

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
