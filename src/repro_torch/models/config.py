"""Model configuration (port of ``repro.models.config``: every family's
fields, ``lm``, ``moe``, ``encdec``, ``ssm``, ``vlm`` and ``hybrid``)."""
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
    # moe
    n_experts: int = 0
    n_experts_padded: int = 0
    top_k: int = 0
    n_shared: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_chunk: Optional[int] = None
    router_aux_coef: float = 0.01
    # ssm (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 256
    # encoder-decoder: the encoder's depth and the precomputed frames it
    # reads, (n_frames, frontend_dim) a sequence
    n_enc_layers: int = 0
    n_frames: int = 0
    frontend_dim: int = 0
    # vlm: the precomputed patches prepended to the text, (n_patches,
    # frontend_dim) an image
    n_patches: int = 0
    # the paper's knob
    linear: factory.LinearCfg = factory.DENSE
    # precision & memory
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False                   # recompute each block in backward
    # paged KV pools quantized per token row ("int8"), dequantized in the
    # paged decode kernel; None keeps fp pools
    kv_quant: Optional[str] = None
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

    @property
    def e_pad(self) -> int:
        return self.n_experts_padded or self.n_experts

    def replace(self, **kw) -> "ModelCfg":
        return dataclasses.replace(self, **kw)
