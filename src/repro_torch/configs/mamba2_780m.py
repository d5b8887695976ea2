"""mamba2-780m [ssm] — 48L d1536 (attention-free) v=50280, ssm_state=128;
SSD (state-space duality).  [arXiv:2405.21060; unverified]

DYAD applies to the in/out projections (the ff module does not exist in this
family)."""
from repro_torch.configs.base import DYAD_DEFAULT
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
        conv_width=4, ssd_chunk=256,
        pos_embed="none", rope_theta=None,
        tie_embeddings=True,
        iota_embed=True,
        linear=DYAD_DEFAULT.replace(scope="ff+ssm"),
        compute_dtype="bfloat16", remat=True,
    )


def smoke() -> ModelCfg:
    return full().replace(
        name="mamba2-780m-smoke", n_layers=2, d_model=64, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssd_chunk=8,
        compute_dtype="float32", remat=False)
