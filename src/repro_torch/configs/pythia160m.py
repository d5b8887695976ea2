"""Pythia-160m — the paper's generalization arch (§3.4.2, Tables 3/4/5):
12L d768 12H d_ff=3072 v=50304, GELU, LayerNorm, RoPE, untied embeddings.
(Published Pythia computes attention+mlp in parallel; the reference uses the
sequential pre-norm form, and so does the port.)  [arXiv:2304.01373 family]"""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="pythia-160m", family="lm",
        n_layers=12, d_model=768, vocab_size=50304,
        n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, act="gelu", mlp_bias=True,
        norm="layernorm", pos_embed="rope", rope_theta=10000.0,
        iota_embed=True,
        linear=DYAD_DEFAULT,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="pythia-160m-smoke", n_layers=2, d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128)
