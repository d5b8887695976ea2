"""phi3-medium-14b [dense] — 40L d5120 40H (GQA kv=10) d_ff=17920 v=100352;
RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="phi3-medium-14b", family="lm",
        n_layers=40, d_model=5120, vocab_size=100352,
        n_heads=40, n_kv_heads=10, head_dim=128,
        d_ff=17920, act="swiglu",
        attn_chunk=2048,
        iota_embed=True,
        linear=DYAD_DEFAULT,
        compute_dtype="bfloat16", remat=True, grad_accum=2,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="phi3-medium-14b-smoke", n_layers=2, d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, attn_chunk=None,
        compute_dtype="float32", remat=False, grad_accum=1)
