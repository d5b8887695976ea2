"""qwen2.5-32b [dense] — 64L d5120 40H (GQA kv=8) d_ff=27648 v=152064;
GQA, QKV bias.  [hf:Qwen/Qwen2.5 family; hf]

Its fp32 params (about 77 GB) fill one 80 GB card: at full size it waits
for tensor parallelism."""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="qwen2.5-32b", family="lm",
        n_layers=64, d_model=5120, vocab_size=152064,
        n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=27648, act="swiglu",
        qkv_bias=True, rope_theta=1e6,
        attn_chunk=2048,
        iota_embed=True,
        linear=DYAD_DEFAULT,
        compute_dtype="bfloat16", remat=True, grad_accum=2,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="qwen2.5-32b-smoke", n_layers=2, d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, attn_chunk=None,
        compute_dtype="float32", remat=False, grad_accum=1)
