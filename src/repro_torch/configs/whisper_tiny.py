"""whisper-tiny [audio]: 4+4 layers, d_model=384, 6 heads (kv=6), d_ff=1536,
vocab=51865 — enc-dec, conv/mel frontend stubbed (the pipeline supplies 1500
frame embeddings).  [arXiv:2212.04356]

Adaptation, as in the JAX package: RoPE decoder positions instead of learned
embeddings, RMSNorm instead of LayerNorm.
"""
from repro_torch.models.config import ArchConfig


def config(**kw) -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
        vocab=51865, activation="gelu", rope_theta=1e4,
        encoder_layers=4, encoder_frames=1500, **kw)


def smoke_config(**kw) -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=139, activation="gelu", rope_theta=1e4,
        encoder_layers=2, encoder_frames=32, **kw)
