"""Model configuration (the ``lm`` family fields of ``repro.models.config``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import factory

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

FAMILIES = ("lm", "moe", "encdec", "ssm", "vlm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str
    n_layers: int
    d_model: int
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: Optional[float] = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None
    attn_chunk: Optional[int] = None
    # route attention through the flash kernels when the kernel route is
    # active (kernels.ops.attn_route: on CUDA, or REPRO_KERNEL_ATTN=flash)
    flash_attn: bool = False
    # ff
    d_ff: int = 0
    act: str = "swiglu"
    mlp_bias: bool = False
    # norm / embeddings
    norm: str = "rmsnorm"                 # "rmsnorm" | "layernorm"
    pos_embed: str = "rope"               # "rope" | "learned" | "none"
    max_position: int = 1 << 20
    tie_embeddings: bool = False
    iota_embed: bool = False
    # the paper's knob
    linear: factory.LinearCfg = factory.DENSE
    # precision & memory
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False                   # recompute each block in backward
    # training-shape hint read by make_train_step
    grad_accum: int = 1

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def replace(self, **kw) -> "ModelCfg":
        return dataclasses.replace(self, **kw)
