"""qwen2-moe-a2.7b [moe] — 24L d2048 16H (GQA kv=16) expert d_ff=1408
v=151936, 60 routed experts top-4 + 4 shared (shared d_ff = 4*1408 = 5632).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Experts are padded 60 -> 64 so the expert axis divides the mesh ``model``
size; padded experts are router-masked."""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, vocab_size=151936,
        n_heads=16, n_kv_heads=16, head_dim=128,
        qkv_bias=True,
        n_experts=60, n_experts_padded=64, top_k=4,
        expert_d_ff=1408, n_shared=4,
        capacity_factor=1.25, moe_chunk=4096,
        act="swiglu", attn_chunk=2048,
        iota_embed=True,
        linear=DYAD_DEFAULT,
        compute_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="qwen2-moe-a2.7b-smoke", n_layers=2, d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=4, head_dim=16, n_experts=6, n_experts_padded=8,
        top_k=4, expert_d_ff=32, n_shared=2, moe_chunk=None, attn_chunk=None,
        compute_dtype="float32", remat=False)
