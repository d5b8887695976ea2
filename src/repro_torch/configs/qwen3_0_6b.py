"""Qwen3-0.6B [dense] — 28L d1024 16H (GQA kv=8) d_ff=3072 v=151936;
qk-norm, GQA, head_dim=128 explicit, SwiGLU, tied embeddings, bf16
compute with remat.  Its ff is bias-free, so with ``ffused`` the DYAD ff
runs the megakernel.  [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="qwen3-0.6b", family="lm",
        n_layers=28, d_model=1024, vocab_size=151936,
        n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, act="swiglu",
        qk_norm=True, rope_theta=1e6,
        tie_embeddings=True,
        attn_chunk=2048,
        flash_attn=True,
        iota_embed=True,
        linear=DYAD_DEFAULT,
        compute_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="qwen3-0.6b-smoke", n_layers=2, d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, attn_chunk=None,
        compute_dtype="float32", remat=False)
