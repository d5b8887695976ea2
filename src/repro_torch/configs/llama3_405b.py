"""llama3-405b [dense] — 126L d16384 128H (GQA kv=8) d_ff=53248 v=128256;
GQA, 128k vocab.  [arXiv:2407.21783; unverified]

bf16 params and moments, sharded over data and model axes, remat and
grad_accum=8 in the reference's memory plan: at full size it waits for
tensor parallelism (its params alone are some 810 GB in fp32)."""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="llama3-405b", family="lm",
        n_layers=126, d_model=16384, vocab_size=128256,
        n_heads=128, n_kv_heads=8, head_dim=128,
        d_ff=53248, act="swiglu",
        rope_theta=5e5,
        attn_chunk=2048,
        iota_embed=True,
        linear=DYAD_DEFAULT,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        remat=True, grad_accum=8,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="llama3-405b-smoke", n_layers=2, d_model=128, vocab_size=256,
        n_heads=8, n_kv_heads=2, head_dim=16, d_ff=256, attn_chunk=None,
        param_dtype="float32", compute_dtype="float32", remat=False,
        grad_accum=1)
