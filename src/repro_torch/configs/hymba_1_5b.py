"""hymba-1.5b [hybrid] — 32L d1600 25H (GQA kv=5) d_ff=5504 v=32001,
ssm_state=16; parallel attention + mamba heads per layer, sliding-window
attention (window=1024) => sub-quadratic, long_500k runnable.
[arXiv:2411.13676; hf]

Published Hymba keeps 3 global-attention layers + meta tokens; we model the
homogeneous SWA stack, as the reference does."""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, vocab_size=32001,
        n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, act="swiglu",
        window=1024, attn_chunk=1024,
        ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
        conv_width=4, ssd_chunk=256,
        iota_embed=True,
        linear=DYAD_DEFAULT.replace(scope="ff+ssm"),
        compute_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="hymba-1.5b-smoke", n_layers=2, d_model=64, vocab_size=256,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, window=8,
        attn_chunk=None, ssm_state=16, ssm_head_dim=16, ssd_chunk=8,
        compute_dtype="float32", remat=False)
