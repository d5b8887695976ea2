"""whisper-medium [audio] — enc-dec, 24+24L d1024 16H (kv=16) d_ff=4096
v=51865; the conv frontend is a stub (precomputed frame embeddings, 1500
frames x 1024).  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="whisper-medium", family="encdec",
        n_layers=24, n_enc_layers=24,
        d_model=1024, vocab_size=51865,
        n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, act="gelu", mlp_bias=True,
        norm="layernorm", pos_embed="learned", max_position=1 << 16,
        rope_theta=None,
        n_frames=1500, frontend_dim=1024,
        attn_chunk=2048,
        iota_embed=True,
        linear=DYAD_DEFAULT,
        compute_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="whisper-medium-smoke", n_layers=2, n_enc_layers=2, d_model=64,
        vocab_size=256, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        n_frames=8, frontend_dim=16, max_position=128, attn_chunk=None,
        compute_dtype="float32", remat=False)
