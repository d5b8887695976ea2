"""llama4-maverick-400b-a17b [moe] — 48L d5120 40H (GQA kv=8) expert
d_ff=8192 v=202048, 128 routed experts top-1 + 1 shared; early fusion.
[hf:meta-llama/Llama-4 family; unverified]

Published Maverick interleaves dense/MoE layers; we model the all-MoE stack
(homogeneous layers, as the reference models it)."""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, vocab_size=202048,
        n_heads=40, n_kv_heads=8, head_dim=128,
        n_experts=128, top_k=1,
        expert_d_ff=8192, n_shared=1,
        capacity_factor=1.25, moe_chunk=4096,
        act="swiglu", attn_chunk=2048,
        iota_embed=True,
        linear=DYAD_DEFAULT,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat=True, grad_accum=4,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="llama4-maverick-smoke", n_layers=2, d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=2, head_dim=16, n_experts=8, top_k=1,
        expert_d_ff=32, n_shared=1, moe_chunk=None, attn_chunk=None,
        param_dtype="float32", compute_dtype="float32", remat=False,
        grad_accum=1)
