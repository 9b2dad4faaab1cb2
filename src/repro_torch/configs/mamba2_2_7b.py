"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060]

The numbers of ``repro/configs/mamba2_2_7b.py``: d_inner 5120, 80 heads of
head_dim 64, one B/C group, chunk 256, untied embeddings; 2,831,296,000
parameters.
"""
from repro_torch.models.config import ArchConfig, SSMConfig


def config(**kw) -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=50280, activation="silu",
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1,
                      chunk=256), **kw)


def smoke_config(**kw) -> ArchConfig:
    return ArchConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=137, activation="silu",
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, n_groups=1,
                      chunk=8), **kw)
