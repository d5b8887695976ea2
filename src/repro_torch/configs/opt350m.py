"""OPT-350m — the paper's larger-scale arch (§3.2, Tables 7/10):
24L d1024 16H d_ff=4096 v=50272.  (Published OPT-350m adds in/out projections
around a d=512 embedding; we use the uniform-width replica, matching how the
paper reports ff-module timings.)  [arXiv:2205.01068]"""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="opt-350m", family="lm",
        n_layers=24, d_model=1024, vocab_size=50272,
        n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, act="relu", mlp_bias=True,
        norm="layernorm", pos_embed="learned", max_position=2048,
        flash_attn=True,
        rope_theta=None, tie_embeddings=True,
        iota_embed=True,
        linear=DYAD_DEFAULT,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="opt-350m-smoke", n_layers=2, d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, max_position=128)
