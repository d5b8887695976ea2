"""phi-3-vision-4.2b [vlm] — 32L d3072 32H (kv=32) d_ff=8192 v=32064;
the phi3-mini backbone, the CLIP frontend a stub (precomputed patch
embeddings, 576 patches x 1024).  [hf:microsoft/Phi-3-vision; hf]"""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="phi3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, vocab_size=32064,
        n_heads=32, n_kv_heads=32, head_dim=96,
        d_ff=8192, act="swiglu",
        n_patches=576, frontend_dim=1024,
        attn_chunk=2048,
        iota_embed=True,
        linear=DYAD_DEFAULT,
        compute_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="phi3-vision-smoke", n_layers=2, d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, n_patches=6,
        frontend_dim=16, attn_chunk=None,
        compute_dtype="float32", remat=False)
