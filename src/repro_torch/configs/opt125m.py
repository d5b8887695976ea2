"""OPT-125m — the paper's primary experimental architecture (§3.2):
12L d768 12H d_ff=3072 v=50272, ReLU, LayerNorm, learned positions, tied
embeddings.  [arXiv:2205.01068]"""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="opt-125m", family="lm",
        n_layers=12, d_model=768, vocab_size=50272,
        n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, act="relu", mlp_bias=True,
        norm="layernorm", pos_embed="learned", max_position=2048,
        flash_attn=True,
        rope_theta=None, tie_embeddings=True,
        iota_embed=True,
        linear=DYAD_DEFAULT,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="opt-125m-smoke", n_layers=2, d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, max_position=128)
